"""Failure classes — the part of triton_dist_tpu.faults.errors that the
port raises. The JAX package's WireIntegrityError and DeadlineExceeded
derive from its FaultError (the guard ladder's base class, not ported:
ROADMAP item 8); here they are RuntimeErrors, as FaultError is there."""

from __future__ import annotations

from typing import List, Optional


class WireIntegrityError(RuntimeError):
    """A wire image failed its checksum at the consume edge: the payload
    or scale stripe was corrupted in flight. Carries the failing row
    indices when known."""

    def __init__(self, message: str, rows: Optional[List[int]] = None):
        super().__init__(message)
        self.rows = list(rows or [])


class DeadlineExceeded(RuntimeError):
    """A bounded wait gave up: the resident loop found its injection ring
    abandoned (a head record published but never committed), or windows
    in a row made no progress with records pending
    (serve.worker.ResidentWorker). Carries the evidence as `trips` (the
    JAX class's guard rows; here dicts of the ring's cursor) and the
    window's drained output records (`out_records`), so a caller folds in
    the tokens the window emitted before it handles the trip."""

    def __init__(self, message: str, trips: Optional[List] = None):
        super().__init__(message)
        self.trips = list(trips or [])
        self.out_records: list = []

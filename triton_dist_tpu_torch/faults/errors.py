"""Failure classes — the part of triton_dist_tpu.faults.errors that the
port raises. The JAX package's WireIntegrityError derives from its
FaultError (the guard ladder's base class, not ported: ROADMAP item 8);
here it is a RuntimeError, as FaultError is there."""

from __future__ import annotations

from typing import List, Optional


class WireIntegrityError(RuntimeError):
    """A wire image failed its checksum at the consume edge: the payload
    or scale stripe was corrupted in flight. Carries the failing row
    indices when known."""

    def __init__(self, message: str, rows: Optional[List[int]] = None):
        super().__init__(message)
        self.rows = list(rows or [])

"""Workers — port of triton_dist_tpu.serve.worker.

The Scheduler decides what runs each step; a Worker is the one part that
touches the device.

`Worker` (the host loop): moves the step's arguments to the engine's
device, calls the engine's serve step over the pool (which samples on
the card) and advances the pool lengths. A `per_pos` worker (speculative
decoding) runs the per-position step instead (`step_spec`) and leaves
the lengths to the Scheduler, which advances them by what it accepts
(`advance_lengths`).

`ResidentWorker` (the resident form): the Scheduler's decisions travel as
injection-ring records (mega/ring.py) and the worker runs the engine's
resident loop (`Engine.make_resident_loop`): up to `window` steps a
call, decode self-fed on the device, completions drained from the
output ring after it. It is the ring's producer and the output ring's
consumer. A window reads the device once; an abandoned ring (a starved
window) or windows in a row with no progress raise DeadlineExceeded,
never hang. Not ported: the fault-plan hooks (ROADMAP item 8) and the
telemetry builds (item 9).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from triton_dist_tpu_torch.faults.errors import DeadlineExceeded
from triton_dist_tpu_torch.kernels.sample import fold_in, key_words, seed_key
from triton_dist_tpu_torch.mega import ring as mring
from triton_dist_tpu_torch.serve.kv_pool import KVPool


def sampling_key(seed: int, token_index: int) -> np.ndarray:
    """The sampling key of a request's output token `token_index`:
    fold_in(PRNGKey(seed), token_index), bitwise the JAX package's
    `sampling_key` ((2,) uint32). Derived from the request seed and the
    output token index only, so sampled tokens, like greedy ones, do not
    depend on scheduling or eviction; the host-loop Worker, the
    ResidentWorker and the resident loop's boundary all use it."""
    return key_words(fold_in(seed_key(seed), token_index))


class Worker:
    def __init__(self, engine, pool: KVPool, chunk: int,
                 per_pos: bool = False):
        self.engine = engine
        self.pool = pool
        self.chunk = chunk
        self.per_pos = per_pos
        self._fn = engine.make_serve_step(pool.slots, chunk, pool.page,
                                          pool.max_pages, per_pos=per_pos)
        self.n_steps = 0

    key_for = staticmethod(sampling_key)

    def step(self, tokens: np.ndarray, n_valid: np.ndarray,
             temps: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """One serve step. tokens (K, C), n_valid (K,), temps (K,) f32,
        keys (K, 2) uint32 host arrays. Advances the pool lengths by
        n_valid and returns the per-slot next token (K,); only slots whose
        chunk completed (prefill tail or decode) carry a meaningful
        token."""
        if self.per_pos:
            raise AssertionError(
                "a per-position (spec) worker runs step_spec + "
                "advance_lengths: the Scheduler owns the accepted-count "
                "advance")
        tok = self._run(tokens, n_valid, temps, keys)
        self.pool.lengths = self.pool.lengths + np.asarray(n_valid, np.int64)
        return tok

    def step_spec(self, tokens: np.ndarray, n_valid: np.ndarray,
                  temps: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """The per-position step: keys (K, C, 2) uint32, a key a column;
        returns the (K, C) per-position tokens. The pool lengths are not
        advanced: a verify row's advance is what the Scheduler accepts
        from the returned tokens (`advance_lengths`)."""
        if not self.per_pos:
            raise AssertionError("a worker built without per_pos runs step")
        return self._run(tokens, n_valid, temps, keys)

    def advance_lengths(self, advance: np.ndarray) -> None:
        """A step_spec's length advance a slot: n_valid on prefill rows,
        the emitted count (accepted + 1) on verify rows."""
        self.pool.lengths = self.pool.lengths + np.asarray(advance, np.int64)

    def _run(self, tokens, n_valid, temps, keys) -> np.ndarray:
        pool = self.pool
        tok, _last = self._fn(tokens, pool.k, pool.v, pool.table,
                              pool.lengths, n_valid,
                              np.asarray(temps, np.float32), keys)
        self.n_steps += 1
        return tok.cpu().numpy()


class ResidentWorker:
    """Ring producer and output consumer around the resident loop. The
    loop's state (slot state, the device's page table and lengths, the
    ring's consumed cursor) goes in and comes back each window, so
    windows chain without the host assembling a step.

    `run_window` folds a window's results into the host state before it
    raises: the device did run the window's steps."""

    def __init__(self, engine, pool: KVPool, chunk: int, window: int = 16,
                 ring_cap: Optional[int] = None, poll_budget: int = 8,
                 max_stuck_windows: int = 3, spec_k: int = 0):
        self.engine = engine
        self.pool = pool
        self.chunk = chunk
        self.window = window
        self.poll_budget = poll_budget
        self.max_stuck_windows = max_stuck_windows
        self.spec_k = spec_k
        cap = ring_cap if ring_cap is not None else max(4 * pool.slots, 16)
        self.ring = mring.InjectionRing(cap, pool.max_pages, pool.t_max,
                                        chunk)
        self._spec_pins: list = []  # verify rows the next window reads
        self._fn = engine.make_resident_loop(
            pool.slots, chunk, pool.page, pool.max_pages, window,
            ring_cap=cap, prompt_cap=pool.t_max, poll_budget=poll_budget,
            spec_k=spec_k)
        self.slot_state = np.zeros((pool.slots, mring.SS_WIDTH), np.int32)
        # the device's table and lengths, installed by record consumption:
        # kept apart from pool.table / pool.lengths (the allocator's view,
        # which may already hold rows of admissions not consumed yet)
        self._table = np.zeros((pool.slots, pool.max_pages), np.int32)
        self._lengths = np.zeros((pool.slots,), np.int32)
        self.n_steps = 0     # executed device steps (all windows)
        self.n_windows = 0   # window launches
        self.n_reads = 0     # device-to-host reads
        self.windows_by_steps: Dict[int, int] = {}  # window length -> runs
        self._stuck = 0      # consecutive windows with no progress
        self._ring_version = -1  # the ring version the device copy holds

    # -- ring producer (the scheduler's injection API) -------------------

    key_for = staticmethod(sampling_key)

    def admit(self, slot: int, prompt, max_new: int, temperature: float,
              seed: int, eos_id, req_id: int, at_step: int = 0,
              prefix: int = 0) -> None:
        """The admission record: the slot's whole page-table row (the
        request's lifetime of pages, allocated at admission; a prefix-cache
        hit's leading pages shared) and the prompt the device streams its
        prefill chunks from, from position `prefix` on."""
        self.ring.admit(slot, prompt, max_new, temperature, seed, eos_id,
                        req_id, self.pool.table[slot, :self.pool.max_pages],
                        at_step=at_step, prefix=prefix)

    def retire(self, slot: int, req_id: int, at_step: int = 0) -> None:
        self.ring.retire(slot, req_id, at_step=at_step)

    def inject_verify(self, slot: int, req_id: int, n_out: int, drafts,
                      at_step: int = 0) -> None:
        """A KIND_VERIFY record: `drafts` proposed at exactly `n_out`
        emitted tokens. Its row stays pinned until the window that carried
        it returns (the verify step reads the drafts from the row)."""
        if self.spec_k <= 0:
            raise AssertionError("the loop was built without spec_k")
        if not 1 <= len(drafts) <= self.spec_k:
            raise ValueError(f"{len(drafts)} drafts: the loop verifies 1 to "
                             f"{self.spec_k}")
        self._spec_pins.append(self.ring.verify(slot, req_id, n_out, drafts,
                                                at_step=at_step))

    def can_inject(self) -> bool:
        """Room in the ring for one more record (the backpressure probe)."""
        return self.ring.can_claim()

    def unpin(self, req_id: int) -> None:
        """Release a request's admission row (prefill done or retired)."""
        self.ring.unpin(req_id)

    def pending_records(self) -> int:
        return self.ring.pending()

    # -- the window ------------------------------------------------------

    def run_window(self, steps: Optional[int] = None
                   ) -> List[mring.OutRecord]:
        """Run one resident window of `steps` steps (default `window`, at
        most it); returns its output records in seq order. Raises
        DeadlineExceeded on a starved window, or after `max_stuck_windows`
        windows in a row with no step executed and no record consumed
        while records are pending."""
        steps = self.window if steps is None else steps
        pool = self.pool
        loop = self._fn
        consumed0 = self.ring.consumed
        # the ring goes to the device only when the producer changed it
        if self._ring_version != self.ring.version:
            loop.upload_ring(self.ring.buf)
            self._ring_version = self.ring.version
        res = loop(loop.ring, self.ring.published, consumed0, self.n_steps,
                   self.slot_state, self._table, self._lengths, pool.k,
                   pool.v, steps=steps)
        self.n_reads += 1
        # the window returned: the verify rows it carried are read no more
        for pin in self._spec_pins:
            self.ring.unpin(pin)
        self._spec_pins.clear()
        self.windows_by_steps[steps] = self.windows_by_steps.get(steps,
                                                                 0) + 1
        self.slot_state = res.slot_state.copy()
        self._table = res.table.copy()
        self._lengths = res.lengths.copy()
        # the device's lengths mirrored into the pool, so exports read the
        # device truth; an inactive slot reads 0
        pool.lengths = np.where(self.slot_state[:, mring.SS_ACTIVE] > 0,
                                self._lengths, 0).astype(np.int64)
        self.ring.ack(res.consumed)
        self.n_steps += res.executed
        self.n_windows += 1
        records = mring.decode_out_ring(res.out_ring, res.out_count)
        progressed = res.executed > 0 or res.consumed > consumed0
        self._stuck = 0 if progressed else self._stuck + 1
        if res.starved:
            self._trip(res.consumed, "abandoned ring: head record "
                       f"{res.consumed + 1} published but never committed",
                       records)
        if (not progressed and self.ring.pending() > 0
                and self._stuck >= self.max_stuck_windows):
            self._trip(res.consumed, f"{self._stuck} consecutive windows "
                       "with pending records and no progress", records)
        return records

    def _trip(self, consumed: int, detail: str, records) -> None:
        row = consumed % self.ring.cap
        trip = dict(site="inject", slot=row, progress=consumed,
                    expected=consumed + 1,
                    observed=int(self.ring.buf[row, mring.IR_SEQ]),
                    seq=self.n_windows)
        err = DeadlineExceeded(f"resident window watchdog: {detail} "
                               f"({trip})", trips=[trip])
        # the window's emissions ride the exception: a trip never eats
        # tokens
        err.out_records = list(records)
        raise err

    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.slot_state[:, mring.SS_ACTIVE])

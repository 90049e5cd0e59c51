"""Scheduler — port of triton_dist_tpu.serve.scheduler (host-loop core).

Continuous (in-flight) batching over the engine's fixed (slots, chunk)
serve step: each step carries new requests' prefill chunks beside
in-flight requests' decode tokens, so admission never waits for the
running batch to drain. Policies, as in the JAX version:

  admission  — priority order off the RequestQueue; a request needs a
               free slot and pages for its history (allocate-on-admit).
               A strictly higher-priority arrival may evict the most
               victimizable active request.
  eviction   — victim order (priority asc, least recently active,
               youngest admission). Page exhaustion mid-flight evicts
               only requests younger-or-lower than the one needing room;
               when every slot stalls, the most victimizable goes. An
               evicted request requeues with its arrival order and
               re-prefills its whole history.
  completion — eos_id or max_new_tokens; slot and pages free at once.

`chunk` and `page` are plain arguments (the JAX version prices the
chunk with its perf model). Every step runs in the engine's
`decode_mode`, as the JAX serve step does: in "dist" or "xla" the world
must divide slots * chunk (`Engine.make_serve_step` checks).

`resident=True` runs the resident form (JAX scheduler.py:210-257,
`_resident_pump`): a round injects admissions as ring records and runs
one window of up to `window` steps (default 16) on the device
(serve.worker.ResidentWorker), then drains the window's output records
into the requests. An admission takes a free slot and every page the
request can touch (prompt + max_new_tokens) at once, and a resident
batch never evicts. A window is as long as the live steps the host can
foresee (`_resident_steps`), so that a step after every slot has retired
is rare: on the card each step of a window runs its forward whether a
slot is live or not. `resident="auto"` (the perf model's pick) and the
window's auto-sizing wait for the planner (ROADMAP item 7).

Not ported: speculative decoding, the prefix cache, disaggregated roles
and migration, the retry/quarantine ladder (a failed step raises),
cancellation and the background serving thread, the obs registry, the
flight recorder and trace spans.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from triton_dist_tpu_torch.serve.kv_pool import KVPool, PoolExhausted, pages_for
from triton_dist_tpu_torch.serve.queue import QueueFull, RequestQueue
from triton_dist_tpu_torch.serve.request import (
    Request,
    RequestState,
    TokenStream,
    summarize,
)
from triton_dist_tpu_torch.faults.errors import DeadlineExceeded
from triton_dist_tpu_torch.mega import ring as mring
from triton_dist_tpu_torch.serve.worker import ResidentWorker, Worker

DEFAULT_CHUNK = 64


def _default_page(max_len: int) -> int:
    for p in (64, 32, 16, 8, 4, 2, 1):
        if max_len % p == 0:
            return p
    return 1


class Scheduler:
    def __init__(self, engine, slots: int = 2, chunk: Optional[int] = None,
                 page: Optional[int] = None,
                 total_pages: Optional[int] = None, resident=False,
                 window: Optional[int] = None,
                 ring_cap: Optional[int] = None):
        """total_pages: allocatable pool pages (default: every slot can
        hold a full-horizon sequence); a smaller pool evicts. resident:
        run windows of the resident loop (the module docstring); window
        and ring_cap configure it."""
        if resident == "auto":
            raise NotImplementedError(
                'resident="auto" needs the perf model\'s serve-mode pick '
                "(ROADMAP item 7): pass resident=True or False")
        if not resident and (window is not None or ring_cap is not None):
            raise ValueError("window / ring_cap configure the resident mode:"
                             " pass resident=True")
        page = page or _default_page(engine.max_len)
        self.pool = KVPool(engine, slots, page, total_pages=total_pages)
        self.chunk = max(1, min(chunk or DEFAULT_CHUNK, self.pool.t_max))
        self.resident = bool(resident)
        if self.resident:
            self.worker = ResidentWorker(engine, self.pool, self.chunk,
                                         window=window or 16,
                                         ring_cap=ring_cap)
        else:
            self.worker = Worker(engine, self.pool, self.chunk)
        self.queue = RequestQueue()
        self.active: dict = {}  # slot -> Request
        self.requests: List[Request] = []
        self._admit_seq = 0
        self.counters = dict(submitted=0, rejected=0, admitted=0,
                             evicted=0, preempted=0, steps=0, tokens_out=0)

    # -- client API -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, priority: int = 0,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None, on_token=None,
               stream: bool = False) -> Request:
        """Enqueue one request (admission control may raise QueueFull).
        Returns the live Request; read req.out_tokens after completion or
        consume req.stream as tokens arrive."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new_tokens
        if total > self.pool.t_max:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds the "
                             f"pool horizon {self.pool.t_max}")
        if pages_for(total, self.pool.page) > min(self.pool.max_pages,
                                                 self.pool.capacity):
            raise ValueError(f"request needs {pages_for(total, self.pool.page)}"
                             " pages, beyond what this pool can ever hold")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      priority=priority, temperature=temperature, seed=seed,
                      eos_id=eos_id, on_token=on_token,
                      stream=TokenStream() if stream else None)
        try:
            self.queue.submit(req)
        except QueueFull:
            self.counters["rejected"] += 1
            raise
        self.counters["submitted"] += 1
        self.requests.append(req)
        return req

    # -- the step -------------------------------------------------------

    def step(self) -> bool:
        """One scheduling round. Host loop: admit, assemble the (slots,
        chunk) block, run one device step, emit. Resident: inject
        admissions as ring records, run one window, drain its records.
        Returns False when there was nothing to do."""
        if self.resident:
            return self._resident_pump()
        self._admit()
        if not self.active:
            return False

        K, C = self.pool.slots, self.chunk
        tokens = np.zeros((K, C), np.int64)
        n_valid = np.zeros((K,), np.int64)
        temps = np.zeros((K,), np.float32)
        keys = np.zeros((K, 2), np.uint32)
        plans = []  # (slot, req, n, emits)

        for slot in sorted(self.active):
            req = self.active.get(slot)
            if req is None:  # evicted by an earlier slot's _room call
                continue
            hist = req.history()
            if req.state is RequestState.PREFILL:
                n = min(C, len(hist) - req.pos)
                if not self._room(slot, req, req.pos + n):
                    continue  # stalled this step
                tokens[slot, :n] = hist[req.pos:req.pos + n]
                emits = req.pos + n == len(hist)
            else:  # DECODE
                n = 1
                if not self._room(slot, req, len(hist) + 1):
                    continue
                tokens[slot, 0] = hist[-1]
                emits = True
            n_valid[slot] = n
            if emits:
                temps[slot] = req.temperature
                keys[slot] = self.worker.key_for(req.seed,
                                                 len(req.out_tokens))
            plans.append((slot, req, n, emits))

        # a later slot's page demand may have evicted an earlier,
        # already planned request (_room): scrub its row from the step
        plans = [p for p in plans if self.active.get(p[0]) is p[1]]
        live = {p[0] for p in plans}
        for slot in range(K):
            if slot not in live:
                n_valid[slot] = 0
                tokens[slot] = 0

        if not plans:
            # every slot stalled on pages: evict the most victimizable
            # to guarantee progress (its pages feed the others)
            self._evict(min(self.active.values(), key=self._victim_order),
                        site="progress")
            self.counters["steps"] += 1
            return True

        toks = self.worker.step(tokens, n_valid, temps, keys)
        for slot, req, n, emits in plans:
            req.last_active_step = self.worker.n_steps
            if req.state is RequestState.PREFILL:
                req.pos += n
                if emits:
                    req.state = RequestState.DECODE
                    self._emit(req, int(toks[slot]))
            else:
                self._emit(req, int(toks[slot]))
        self.counters["steps"] += 1
        return True

    def run(self, max_steps: int = 100_000) -> None:
        """Drive steps until the queue and the slots drain."""
        for _ in range(max_steps):
            if not self.step() and self.queue.peek() is None:
                return
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    def metrics(self) -> dict:
        """Latency and throughput summary over finished requests, the
        policy counters and the pool's pressure."""
        out = summarize(self.requests)
        out.update(self.counters)
        if self.resident:
            out["resident_windows"] = self.worker.n_windows
            out["resident_steps"] = self.worker.n_steps
            out["ring_depth"] = self.worker.pending_records()
        out["queue_depth"] = len(self.queue)
        out["active_slots"] = len(self.active)
        out["pool_free_pages"] = self.pool.free_pages()
        out["pool_used_pages"] = self.pool.used_pages()
        return out

    # -- resident mode (JAX scheduler.py:625-1000) -----------------------

    def _resident_pump(self) -> bool:
        """One resident round: inject admissions, run a window, drain its
        completions. The Scheduler never assembles a step: its decisions
        travel as ring records and the device feeds decode itself."""
        self._admit_resident()
        if not self.active and self.worker.pending_records() == 0:
            return False
        steps0 = self.worker.n_steps
        try:
            records = self.worker.run_window(self._resident_steps())
        except DeadlineExceeded as err:
            # the window ran before the watchdog fired: its emissions are
            # folded in before the trip propagates
            self._drain_records(err.out_records)
            raise
        self._drain_records(records)
        self.counters["steps"] += self.worker.n_steps - steps0
        return True

    def _resident_steps(self) -> int:
        """The next window's length: the live steps the host can foresee
        before it has work for the device again (to the earliest
        retirement while a request waits in the queue, else to the last
        active request's end, by each one's prefill chunks and token
        budget), rounded down to the worker's window or a halving of it
        (a graph each on the card), at least 1. A request that stops at
        its eos retires sooner, and the steps after the loop's exit run
        dead."""
        C = self.chunk
        ss = self.worker.slot_state
        left = []
        for slot, req in self.active.items():
            row = ss[slot]
            if (row[mring.SS_ACTIVE] > 0
                    and row[mring.SS_REQID] == req.request_id):
                n = int(row[mring.SS_MAX_NEW] - row[mring.SS_N_OUT])
                if row[mring.SS_PHASE] == 0:
                    n += -(-int(row[mring.SS_PROMPT_LEN]
                               - row[mring.SS_POS]) // C) - 1
            else:  # its admission record is not consumed yet
                n = -(-len(req.history()) // C) + req.max_new_tokens - 1
            left.append(n)
        w = self.worker.window
        if not left:
            return w
        need = min(left) if self.queue.peek() is not None else max(left)
        while w > 1 and w > need:
            w //= 2
        return w

    def _admit_resident(self) -> None:
        """Admission, resident form: a free slot and the request's whole
        lifetime of pages (prompt + max_new_tokens) up front, so a window
        never waits on pages; the admission travels as a ring record with
        the page-table row and the prompt. No preemption or eviction."""
        while len(self.active) < self.pool.slots:
            req = self.queue.peek()
            if req is None or not self.worker.can_inject():
                return
            slot = self.pool.free_slot()
            total = len(req.history()) + req.max_new_tokens
            need = pages_for(total, self.pool.page)
            if slot is None or self.pool.free_pages() < need:
                return
            self.queue.pop()
            self.pool.admit(slot, len(req.history()))
            if not self.pool.ensure(slot, total):
                raise AssertionError("free_pages said yes, ensure said no")
            req.slot = slot
            req.pos = 0
            req.state = RequestState.PREFILL
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.active[slot] = req
            self.counters["admitted"] += 1
            self.worker.admit(slot, req.history(), req.max_new_tokens,
                              req.temperature, req.seed, req.eos_id,
                              req.request_id)

    def _drain_records(self, records) -> None:
        """Fold a window's output records into the requests, in device
        seq order: emissions stream out as the host loop's do, and a
        retirement frees the slot and its pages. The device's eos and
        length decisions are held against the host's."""
        for rec in records:
            if rec.emitted or rec.retired:
                # prefill done or retired: the device no longer reads
                # the admission row
                self.worker.unpin(rec.req_id)
            req = self.active.get(rec.slot)
            if req is None or req.request_id != rec.req_id:
                continue  # a stale record of a slot already turned over
            if rec.emitted and not req.done:
                if req.state is RequestState.PREFILL:
                    req.state = RequestState.DECODE
                    req.pos = len(req.history())
                req.last_active_step = self.worker.n_steps
                req._emit(rec.token, None)
                self.counters["tokens_out"] += 1
                would_retire = (
                    (req.eos_id is not None and rec.token == req.eos_id)
                    or len(req.out_tokens) >= req.max_new_tokens)
                if would_retire != rec.retired:
                    raise AssertionError(
                        "device retirement decision diverged from the "
                        f"host's on request {req.request_id}: {rec}")
            if rec.retired:
                reason = {mring.REASON_EOS: "eos",
                          mring.REASON_LENGTH: "length"}.get(rec.reason)
                if reason is not None:
                    self._retire(req, reason, RequestState.FINISHED)
                else:  # REASON_HOST: an injected retirement came back
                    self._retire(req, "cancelled", RequestState.CANCELLED)

    # -- internals ------------------------------------------------------

    def _room(self, slot: int, req: Request, upto: int) -> bool:
        if self.pool.ensure(slot, upto):
            return True
        victim = self._pick_victim(req)
        while victim is not None:
            self._evict(victim, site="growth")
            if self.pool.ensure(slot, upto):
                return True
            victim = self._pick_victim(req)
        return False

    @staticmethod
    def _victim_order(a: Request):
        # most victimizable first: lowest priority, least recently
        # active, youngest admission
        return (a.priority, a.last_active_step, -a.admit_seq)

    def _pick_victim(self, requester: Request) -> Optional[Request]:
        """Strictly younger-or-lower victims relative to the requester: a
        total order (admit_seq is unique), so two slots never evict each
        other in turns."""
        cands = [a for a in self.active.values()
                 if a is not requester
                 and (a.priority < requester.priority
                      or (a.priority == requester.priority
                          and a.admit_seq > requester.admit_seq))]
        return min(cands, key=self._victim_order) if cands else None

    def _admit(self) -> None:
        while len(self.active) < self.pool.slots:
            req = self.queue.peek()
            if req is None:
                return
            slot = self.pool.free_slot()
            need = max(pages_for(len(req.history()), self.pool.page), 1)
            if slot is None or self.pool.free_pages() < need:
                # a strictly higher-priority arrival may preempt
                cands = [a for a in self.active.values()
                         if a.priority < req.priority]
                if not cands:
                    return
                self._evict(min(cands, key=self._victim_order),
                            site="preemption")
                continue
            self.queue.pop()
            try:
                self.pool.admit(slot, len(req.history()))
            except PoolExhausted:
                self.queue.requeue(req)
                return
            req.slot = slot
            req.pos = 0
            req.state = RequestState.PREFILL
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.active[slot] = req
            self.counters["admitted"] += 1

    def _evict(self, req: Request, site: str = "growth") -> None:
        self.pool.release(req.slot)
        del self.active[req.slot]
        req.slot = -1
        req.pos = 0
        req.n_evictions += 1
        self.counters["evicted"] += 1
        if site == "preemption":
            self.counters["preempted"] += 1
        self.queue.requeue(req)

    def _emit(self, req: Request, tok: int) -> None:
        req._emit(tok, None)
        self.counters["tokens_out"] += 1
        if (req.eos_id is not None and tok == req.eos_id) \
                or len(req.out_tokens) >= req.max_new_tokens:
            reason = ("eos" if req.eos_id is not None and tok == req.eos_id
                      else "length")
            self._retire(req, reason, RequestState.FINISHED)

    def _retire(self, req: Request, reason: str, state) -> None:
        self.pool.release(req.slot)
        del self.active[req.slot]
        req.slot = -1
        req._finish(reason, state)

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
chunk with its perf model). Not ported: the resident loop, speculative
decoding, the prefix cache, disaggregated roles and migration, the
retry/quarantine ladder (a failed step raises), cancellation and the
background serving thread, the obs registry, the flight recorder and
trace spans.
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
from triton_dist_tpu_torch.serve.worker import Worker, sampling_seed

DEFAULT_CHUNK = 64


def _default_page(max_len: int) -> int:
    for p in (64, 32, 16, 8, 4, 2, 1):
        if max_len % p == 0:
            return p
    return 1


class Scheduler:
    def __init__(self, engine, slots: int = 2, chunk: Optional[int] = None,
                 page: Optional[int] = None,
                 total_pages: Optional[int] = None):
        """total_pages: allocatable pool pages (default: every slot can
        hold a full-horizon sequence); a smaller pool evicts."""
        page = page or _default_page(engine.max_len)
        self.pool = KVPool(engine, slots, page, total_pages=total_pages)
        self.chunk = max(1, min(chunk or DEFAULT_CHUNK, self.pool.t_max))
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
        """One scheduling round: admit, assemble the (slots, chunk) block,
        run one device step, emit. Returns False when there was nothing
        to do."""
        self._admit()
        if not self.active:
            return False

        K, C = self.pool.slots, self.chunk
        tokens = np.zeros((K, C), np.int64)
        n_valid = np.zeros((K,), np.int64)
        temps = np.zeros((K,), np.float32)
        seeds = np.zeros((K,), np.int64)
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
                seeds[slot] = sampling_seed(req.seed, len(req.out_tokens))
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

        toks = self.worker.step(tokens, n_valid, temps, seeds)
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
        out["queue_depth"] = len(self.queue)
        out["active_slots"] = len(self.active)
        out["pool_free_pages"] = self.pool.free_pages()
        out["pool_used_pages"] = self.pool.used_pages()
        return out

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

"""Priority request queue with admission control — a copy of
triton_dist_tpu.serve.queue (copied, not imported: the port never
imports the JAX package).

The front door of the serving plane: requests wait here (bounded —
`QueueFull` is the backpressure signal a production frontend turns into
HTTP 429) until the scheduler admits them onto a KV-pool slot. Ordering
is (priority desc, arrival seq asc); an EVICTED request re-enters with
its ORIGINAL arrival seq, so it resumes ahead of later arrivals of the
same priority instead of losing its place.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional

from triton_dist_tpu_torch.serve.request import Request, RequestState


class QueueFull(RuntimeError):
    """Admission-control rejection: the pending queue is at capacity."""


class RequestQueue:
    """Thread-safe bounded priority queue of Requests."""

    def __init__(self, max_pending: int = 256):
        self.max_pending = max_pending
        self._heap: list = []  # (-priority, seq, Request)
        self._seq = itertools.count()
        self._ids = itertools.count()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for _, _, r in self._heap
                       if r.state == RequestState.QUEUED)

    def submit(self, req: Request) -> Request:
        """Admit `req` into the pending queue (raises QueueFull past
        capacity — the backpressure contract). Assigns request_id and
        the arrival seq; stamps t_submit."""
        with self._lock:
            if len(self._heap) >= self.max_pending and not self._gc():
                raise QueueFull(
                    f"{self.max_pending} requests already pending"
                )
            if req.request_id < 0:
                req.request_id = next(self._ids)
            req.seq = next(self._seq)
            req.state = RequestState.QUEUED
            req.t_submit = time.perf_counter_ns()
            heapq.heappush(self._heap, (-req.priority, req.seq, req))
        return req

    def requeue(self, req: Request) -> None:
        """Put an evicted request back, KEEPING its original arrival seq
        (it resumes ahead of later same-priority arrivals)."""
        with self._lock:
            req.state = RequestState.QUEUED
            heapq.heappush(self._heap, (-req.priority, req.seq, req))

    def cancel(self, req: Request) -> bool:
        """Cancel a QUEUED request (lazy removal: pop skips it). Active
        requests are cancelled through the Scheduler, which owns their
        slot."""
        if req.state is not RequestState.QUEUED:
            return False
        req._finish("cancelled", RequestState.CANCELLED)
        return True

    def peek(self) -> Optional[Request]:
        """Highest-priority pending request, skipping cancelled ones."""
        with self._lock:
            while self._heap:
                _, _, req = self._heap[0]
                if req.state is RequestState.QUEUED:
                    return req
                heapq.heappop(self._heap)  # cancelled: drop lazily
            return None

    def pop(self) -> Optional[Request]:
        with self._lock:
            while self._heap:
                _, _, req = heapq.heappop(self._heap)
                if req.state is RequestState.QUEUED:
                    return req
            return None

    def _gc(self) -> int:
        """Drop lazily-cancelled entries; returns how many were freed.
        Called under the lock."""
        live = [e for e in self._heap
                if e[2].state is RequestState.QUEUED]
        freed = len(self._heap) - len(live)
        if freed:
            self._heap = live
            heapq.heapify(self._heap)
        return freed

"""Request objects for the serving plane — a copy of
triton_dist_tpu.serve.request, cut to what the host loop uses.

A Request is a unit of scheduling: it moves through queued -> prefill ->
decode (back to queued when evicted) while the Scheduler interleaves it
with other requests, and its tokens stream out through a callback or an
iterator. The prefix, speculative-decoding, resident-loop and ledger
fields of the JAX version are left out with those planes. `summarize`
takes its quantiles with numpy where the JAX version reads the obs
registry's log-bucket histogram, which the port does not have.
"""

from __future__ import annotations

import dataclasses
import enum
import queue as _queue
import time
from typing import Callable, List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"        # waiting in the RequestQueue (or requeued)
    PREFILL = "prefill"      # chunked prompt (re)processing on a slot
    DECODE = "decode"        # one token per scheduler step
    FINISHED = "finished"    # eos / max_new_tokens reached
    CANCELLED = "cancelled"  # dropped by the client
    FAILED = "failed"        # retired by an error


_END = object()  # stream sentinel


class TokenStream:
    """Blocking iterator over a request's generated tokens. Yields
    (token_id, piece) pairs; `piece` is None (the port carries no
    detokenizer). Iteration ends at completion or cancellation."""

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()

    def _push(self, tok: int, piece: Optional[str]):
        self._q.put((tok, piece))

    def _close(self):
        self._q.put(_END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            yield item

    def get(self, timeout: Optional[float] = None):
        """One (token, piece) pair or None at end-of-stream."""
        item = self._q.get(timeout=timeout)
        return None if item is _END else item


@dataclasses.dataclass
class Request:
    """One generation request plus its scheduling state and metrics.

    `history()` is the token sequence a (re-)prefill processes: prompt +
    tokens generated so far. After an eviction the request re-enters
    PREFILL over its whole history; the serve step's fixed geometry makes
    the resumed generation the same as an uninterrupted one."""

    prompt: List[int]
    max_new_tokens: int
    priority: int = 0          # higher runs first
    temperature: float = 0.0   # <= 0: greedy
    seed: int = 0
    eos_id: Optional[int] = None
    on_token: Optional[Callable[["Request", int, Optional[str]], None]] \
        = None
    stream: Optional[TokenStream] = None

    # -- scheduler-owned state ------------------------------------------
    request_id: int = -1
    state: RequestState = RequestState.QUEUED
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0               # prefill cursor into history()
    slot: int = -1             # pool slot while active, else -1
    seq: int = -1              # queue arrival order (priority tie-break)
    admit_seq: int = -1        # admission order (eviction victim order)
    last_active_step: int = -1
    n_evictions: int = 0
    finish_reason: Optional[str] = None  # "eos" | "length" | "cancelled"

    # -- metrics (perf_counter_ns) --------------------------------------
    t_submit: int = 0
    t_first_token: int = 0
    t_finish: int = 0
    token_times: List[int] = dataclasses.field(default_factory=list)

    def history(self) -> List[int]:
        return self.prompt + self.out_tokens

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.out_tokens)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED,
                              RequestState.CANCELLED,
                              RequestState.FAILED)

    def ttft_us(self) -> Optional[float]:
        """Time to first token: submit -> first generated token."""
        if not self.token_times:
            return None
        return (self.token_times[0] - self.t_submit) / 1e3

    def tpot_us(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if len(self.token_times) < 2:
            return None
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1) / 1e3)

    def _emit(self, tok: int, piece: Optional[str]):
        self.out_tokens.append(tok)
        now = time.perf_counter_ns()
        if not self.token_times:
            self.t_first_token = now
        self.token_times.append(now)
        if self.on_token is not None:
            self.on_token(self, tok, piece)
        if self.stream is not None:
            self.stream._push(tok, piece)

    def _finish(self, reason: str, state: RequestState):
        self.state = state
        self.finish_reason = reason
        self.t_finish = time.perf_counter_ns()
        if self.stream is not None:
            self.stream._close()


def summarize(requests) -> dict:
    """Serving metrics over finished requests: output tokens/s over the
    span from the first submit to the last token, p50/p99 TTFT and TPOT
    in microseconds."""
    done = [r for r in requests if r.state == RequestState.FINISHED
            and r.token_times]
    if not done:
        return {"n": 0, "tokens_per_s": 0.0}
    t0 = min(r.t_submit for r in done)
    t1 = max(r.token_times[-1] for r in done)
    n_tok = sum(len(r.out_tokens) for r in done)
    ttft = [r.ttft_us() for r in done]
    tpot = [r.tpot_us() for r in done if r.tpot_us() is not None]

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else 0.0

    return {
        "n": len(done),
        "tokens_per_s": n_tok / max((t1 - t0) / 1e9, 1e-9),
        "ttft_p50_us": pct(ttft, 50),
        "ttft_p99_us": pct(ttft, 99),
        "tpot_p50_us": pct(tpot, 50),
        "tpot_p99_us": pct(tpot, 99),
    }

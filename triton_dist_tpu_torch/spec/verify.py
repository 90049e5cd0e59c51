"""Verify rows and the accept rule — a copy of triton_dist_tpu.spec.verify.

A decoding slot's verify row is [last_token, d_1, ..., d_k] (n_valid =
k + 1) through the per-position serve step. Column j samples under the
key of output index n_out + j, so its token o_j is bitwise what
sequential decode would emit after history + d_1..d_j. The rule accepts
while o_{j-1} == d_j and emits o_0..o_a (the accepted drafts, which are
the model's own tokens, then o_a), cut at the first eos and at the
request's remaining budget.

The step wrote K/V for all k + 1 fed positions; only the emitted count
is history, so the pool length advances by len(accept_tokens(...)) (the
rejected positions lie past the length, masked, and the next step
overwrites them). The Scheduler owns that advance (serve/worker.py
`step_spec` / `advance_lengths`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from triton_dist_tpu_torch.spec.draft import Draft, NgramDraft


@dataclasses.dataclass
class SpecConfig:
    """`serve.Scheduler(spec=...)`'s policy.

    k         draft tokens verified a step at most (0 turns it off); the
              verify row needs k + 1 <= chunk columns.
    draft     the proposer (prompt lookup by default).
    adaptive  the JAX package's live draft width from an average of the
              acceptance rate; it needs the perf model's choose_spec_k,
              which the port does not have (the Scheduler refuses it, and
              the average's weight, JAX's ewma_alpha, with it).
    """

    k: int = 4
    draft: Draft = dataclasses.field(default_factory=NgramDraft)
    adaptive: bool = False

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"spec k must be >= 0, got {self.k}")


def draft_cap(k: int, chunk: int, history_len: int, n_out: int,
              max_new: int, t_max: int) -> int:
    """Draft tokens a verify row may carry now: at most k, the row's
    chunk - 1 free columns, the output budget less the bonus token, and
    the pool horizon (the row's last K/V write lands at history_len - 1
    + k < t_max)."""
    return max(0, min(k, chunk - 1, max_new - n_out - 1,
                      t_max - history_len))


def verify_keys(key_for, seed: int, n_out: int, width: int,
                cols: int) -> np.ndarray:
    """A verify row's sampling keys, (cols, 2) uint32 with the first
    `width` columns set: column j emits output index n_out + j, so its
    key is key_for(seed, n_out + j), sequential decode's key for that
    index (serve.worker.sampling_key)."""
    keys = np.zeros((cols, 2), np.uint32)
    for j in range(width):
        keys[j] = key_for(seed, n_out + j)
    return keys


def accept_tokens(proposed: Sequence[int], row_tokens,
                  eos_id: Optional[int] = None,
                  max_emit: Optional[int] = None) -> List[int]:
    """The longest accepted prefix: `row_tokens` are o_0..o_k (columns
    0..len(proposed) of the slot's per-position tokens); returns o_0..o_a,
    a the longest prefix with o_{j-1} == proposed[j-1], cut after the
    first eos and at `max_emit` tokens, where sequential decode would
    have stopped."""
    row = [int(t) for t in row_tokens]
    a = 0
    while a < len(proposed) and row[a] == int(proposed[a]):
        a += 1
    out = row[:a + 1]
    if eos_id is not None and eos_id in out:
        out = out[:out.index(eos_id) + 1]
    if max_emit is not None:
        out = out[:max(max_emit, 0)]
    return out

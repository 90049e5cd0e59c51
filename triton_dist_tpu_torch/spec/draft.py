"""Draft proposers — a copy of triton_dist_tpu.spec.draft.

`Draft` is the proposal protocol: given a request's tokens so far,
return up to k candidate next tokens. A proposal is only a hint: the
verify step emits the model's own tokens, so a bad draft costs verify
columns, never a wrong token.

`NgramDraft` is prompt-lookup decoding: match the history's trailing
n-gram (n down to min_n) against its most recent earlier occurrence and
propose what followed it. No model, host ints only."""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Draft(Protocol):
    """`propose(history, k)` returns 0..k candidate next tokens for the
    sequence `history`. It must be deterministic in `history`: a verify
    row built again from the same history is the same row."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        ...


class NgramDraft:
    """For gram sizes n down to min_n: the history's trailing gram, its
    most recent earlier occurrence, and the tokens that followed it."""

    def __init__(self, n: int = 3, min_n: int = 1):
        if not n >= min_n >= 1:
            raise ValueError(f"NgramDraft needs n >= min_n >= 1, got n {n}, "
                             f"min_n {min_n}")
        self.n = n
        self.min_n = min_n

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        ln = len(hist)
        if k <= 0 or ln < self.min_n + 1:
            return []
        for g in range(min(self.n, ln - 1), self.min_n - 1, -1):
            suffix = hist[ln - g:]
            # the most recent earlier occurrence (i <= ln - g - 1, so at
            # least one token follows it)
            for i in range(ln - g - 1, -1, -1):
                if hist[i:i + g] == suffix:
                    return hist[i + g:i + g + k]
        return []

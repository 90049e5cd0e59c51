"""Pipeline-parallel communication layer — port of triton_dist_tpu.
layers.p2p (`PPCommOp`, `pp_schedule_fwd`).

The JAX layer runs inside shard_map over a `pp` mesh axis: every stage
executes the same program, `send_forward` moves every stage's
activation to its right neighbour in one ring step, and the schedule is
a `lax.scan` over ticks. Here the stages are the ranks of a virtual
world (runtime/symm_mem.py) and activations are rank-stacked: act (n,
...) holds stage r's activation at [r]. `send_forward` / `send_backward`
are one `ring_shift` launch each (shift +1 / -1; the kernel's
neighbour-barrier prologue), called through the kernels module so a
caller can wrap it.

`pp_schedule_fwd` is the GPipe forward of the JAX function, tick for
tick: n_microbatches + n - 1 ticks; on each, stage 0 takes microbatch t
(or microbatch 0 past the last), every other stage the activation that
just arrived; every stage's `stage_fn(stage, act)` runs, including on
ticks where its activation is still the zeros it started from (as in
JAX: the launch count is pinned); the last stage records microbatch t -
(n - 1); then one ring_shift. The JAX result is replicated by a `psum`
of the last stage's outputs, left to XLA; here the last rank's outputs
are broadcast to every rank by a torch expand.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from triton_dist_tpu_torch.kernels import p2p as _p2p


class PPCommOp(NamedTuple):
    """Static pipeline geometry: n stages, one a rank of the world."""

    n: int

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.n:
            raise ValueError(f"activations of {x.shape[0]} ranks in a "
                             f"pipeline of {self.n} stages")

    def send_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Stage i's activation to stage i + 1 (a ring shift by 1)."""
        self._check(x)
        return _p2p.ring_shift(x, shift=1)

    def send_backward(self, x: torch.Tensor) -> torch.Tensor:
        """Stage i's gradient to stage i - 1 (a ring shift by -1)."""
        self._check(x)
        return _p2p.ring_shift(x, shift=-1)


def pp_schedule_fwd(comm: PPCommOp,
                    stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
                    x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """GPipe forward over microbatches.

    x (n, n_microbatches, mb, ...) rank-stacked: stage 0's copy is the
    input, the other ranks' are ignored (an expand of one copy will do).
    stage_fn(stage, act): stage's function of one activation (mb, ...),
    the same shape and dtype. Returns (n, n_microbatches, mb, ...): every
    rank's copy of the last stage's outputs (an expanded view)."""
    n = comm.n
    comm._check(x)
    if x.shape[1] != n_microbatches:
        raise ValueError(f"x holds {x.shape[1]} microbatches, "
                         f"n_microbatches={n_microbatches}")
    mb_shape = x.shape[2:]
    inflight = torch.zeros((n, *mb_shape), dtype=x.dtype, device=x.device)
    outputs = torch.zeros((n_microbatches, *mb_shape), dtype=x.dtype,
                          device=x.device)
    for t in range(n_microbatches + n - 1):
        inject = t if t < n_microbatches else 0
        fed = [x[0, inject], *inflight[1:]]
        act = torch.stack([stage_fn(r, fed[r]) for r in range(n)])
        if t >= n - 1:
            outputs[t - (n - 1)] = act[n - 1]
        inflight = comm.send_forward(act)
    return outputs.expand(n, *outputs.shape)

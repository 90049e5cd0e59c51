"""GEMM + AllReduce — port of triton_dist_tpu.kernels.gemm_allreduce
(`gemm_ar`), the host composition of the `ar` mode's O and down
projections.

The JAX routing, copied exactly (gemm_allreduce.py:45-62):

  world 1                     the local product, no collective;
  M <= 256 rows, or M % n     the local product (f32 accumulation,
                              rounded to a.dtype), then
                              one_shot_all_reduce — every decode step and
                              every serve step of slots x chunk <= 256;
  otherwise                   gemm_rs (the product inside the kernel),
                              then ring_all_gather of the reduced chunks
                              — a large prefill.

The local product is a torch matmul, as the JAX package leaves it to
XLA outside any kernel; the collectives are the port's kernels, called
through their modules so a caller can wrap them.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import allgather as _ag
from triton_dist_tpu_torch.kernels import allreduce as _ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as _rs
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_LOW_LATENCY_MAX_ROWS = 256


def gemm_ar(a: torch.Tensor, b: torch.Tensor,
            world: VirtualWorld) -> torch.Tensor:
    """AllReduce(a @ b) over the world: a (n, M, K_loc), b (n, K_loc, N)
    rank-stacked -> (n, M, N), every rank's copy the sum."""
    n, m = a.shape[:2]
    if n != world.n:
        raise ValueError(f"a has {n} ranks, the world {world.n}")
    if n == 1:
        return _rs.local_product(a, b)
    if m <= _LOW_LATENCY_MAX_ROWS or m % n:
        return _ar.one_shot_all_reduce(_rs.local_product(a, b))
    return _ag.ring_all_gather(_rs.gemm_rs(a, b))

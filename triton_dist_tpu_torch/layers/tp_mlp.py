"""MLP block — port of triton_dist_tpu.layers.tp_mlp, the `ar` form
(`tp_mlp_ar_fwd`) over the virtual world.

Per rank: gate and up products kept in f32, silu(g) * u in f32, cast to
the activation dtype, then the down projection through `gemm_ar`, which
all-reduces the ranks' partial sums (a local product at world 1).

Weight layout (rank dim kept): w_gate / w_up (n, hidden, I/n), w_down
(n, I/n, hidden); activations x (n, M, hidden), one replica a rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar
from triton_dist_tpu_torch.layers.linear import dot_f32
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class TPMLPParams(NamedTuple):
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in f32, the JAX package's `_silu_mul_f32` formula."""
    g = g.float()
    return g * torch.sigmoid(g) * u.float()


def tp_mlp_fwd(x: torch.Tensor, params: TPMLPParams,
               world: VirtualWorld) -> torch.Tensor:
    """x (n, M, hidden) -> (n, M, hidden)."""
    g = dot_f32(x, params.w_gate)
    u = dot_f32(x, params.w_up)
    act = silu_mul(g, u).to(x.dtype)
    return gemm_ar(act, params.w_down, world)

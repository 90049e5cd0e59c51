"""MLP block — port of triton_dist_tpu.layers.tp_mlp at world 1.

Gate and up products kept in f32, silu(g) * u in f32, cast to the
activation dtype, down product cast to the activation dtype: the JAX
`ar` mode (tp_mlp.py:102-114) with the all-reduce gone.

Weight layout: w_gate / w_up (hidden, I), w_down (I, hidden).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_dist_tpu_torch.layers.linear import dot_f32


class TPMLPParams(NamedTuple):
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in f32, the JAX package's `_silu_mul_f32` formula."""
    g = g.float()
    return g * torch.sigmoid(g) * u.float()


def tp_mlp_fwd(x: torch.Tensor, params: TPMLPParams) -> torch.Tensor:
    """x (M, hidden) -> (M, hidden)."""
    g = dot_f32(x, params.w_gate)
    u = dot_f32(x, params.w_up)
    act = silu_mul(g, u).to(x.dtype)
    return act @ params.w_down

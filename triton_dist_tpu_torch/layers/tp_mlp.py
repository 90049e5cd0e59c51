"""MLP block — port of triton_dist_tpu.layers.tp_mlp over the virtual
world, in the JAX package's three modes (`MODES`, `tp_mlp_fwd(mode=)`):

  ar   — replicated input x (n, M, hidden), one replica a rank: gate and
         up products kept in f32, silu(g) * u in f32, cast to the
         activation dtype, then the down projection through `gemm_ar`,
         which all-reduces the ranks' partial sums (a local product at
         world 1);
  dist — sequence-sharded input x (n, M/n, hidden), rank r holding rows
         [r*M/n, (r+1)*M/n): ag_gemm gathers the rows and computes
         silu(x @ w_gate) * (x @ w_up) in its epilogue, C in ring-arrival
         order, and gemm_rs(a_order="arrival") reduce-scatters the down
         projection back to the shards;
  xla  — the same sharding with torch ops where the JAX package leaves
         the collectives and dots to XLA: all-gather, f32 dots, silu_mul,
         down dot, psum_scatter (the collectives are the plain versions
         of the ring all-gather and of gemm_rs's fold; the parity
         reference of `dist`).

The kernels are called through their modules, so a caller can wrap them.
Weight layout (rank dim kept): w_gate / w_up (n, hidden, I/n), w_down
(n, I/n, hidden).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels import allgather as _ring
from triton_dist_tpu_torch.kernels import allgather_gemm as _ag
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as _rs
from triton_dist_tpu_torch.kernels.allgather_gemm import silu_mul
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar
from triton_dist_tpu_torch.layers.linear import dot_f32
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

class TPMLPParams(NamedTuple):
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def tp_mlp_ar_fwd(x: torch.Tensor, params: TPMLPParams,
                  world: VirtualWorld) -> torch.Tensor:
    """x (n, M, hidden) replicated -> (n, M, hidden) replicated."""
    g = dot_f32(x, params.w_gate)
    u = dot_f32(x, params.w_up)
    act = silu_mul(g, u).to(x.dtype)
    return gemm_ar(act, params.w_down, world)


def tp_mlp_dist_fwd(x: torch.Tensor, params: TPMLPParams,
                    world: VirtualWorld) -> torch.Tensor:
    """x (n, M/n, hidden) sharded -> (n, M/n, hidden) sharded."""
    act = _ag.ag_gemm(x, (params.w_gate, params.w_up), epilogue="silu_pair",
                      c_order="arrival")
    return _rs.gemm_rs(act, params.w_down, a_order="arrival")


def tp_mlp_xla_fwd(x: torch.Tensor, params: TPMLPParams,
                   world: VirtualWorld) -> torch.Tensor:
    """x (n, M/n, hidden) sharded -> (n, M/n, hidden) sharded."""
    x_full = _ring.ring_all_gather_plain(x)
    act = silu_mul(dot_f32(x_full, params.w_gate),
                   dot_f32(x_full, params.w_up)).to(x.dtype)
    return _rs.reduce_scatter_plain(dot_f32(act, params.w_down).to(x.dtype))


MODES = {"xla": tp_mlp_xla_fwd, "dist": tp_mlp_dist_fwd, "ar": tp_mlp_ar_fwd}


def tp_mlp_fwd(x: torch.Tensor, params: TPMLPParams, world: VirtualWorld,
               mode: str = "dist") -> torch.Tensor:
    """The block in `mode` (the JAX default "dist"): x sharded (n, M/n,
    hidden) in "dist" and "xla", replicated (n, M, hidden) in "ar"."""
    return MODES[mode](x, params, world)

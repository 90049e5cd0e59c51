"""TP-MoE block — port of triton_dist_tpu.layers.tp_moe over the virtual
world, in the JAX package's four lowerings (`MODES`,
`tp_moe_fwd(mode=)`). Every rank holds its slice of every expert's FFN
dim: w_gate_up (n, E, H, 2*I/n) as [gate_r | up_r], w_down (n, E, I/n,
H); the router w_router (H, E) is replicated. The router runs in f32 on
the token rows (tp_moe.py:55-63), softmax then top-k, renormalised.

  xla   — sequence-sharded x (n, M/n, H): a torch all-gather, the
          grouped products, the combine, the rank-order f32 fold that
          stands for `psum_scatter` (the parity reference);
  dist  — sequence-sharded: the ring AllGather kernel once a layer
          (router and gate|up share it), grouped gate|up, silu_mul in
          f32, grouped down with an f32 result, the top-k combine, cast,
          then the ring ReduceScatter kernel (`moe_reduce_rs`);
  ar    — replicated x (n, M, H): routing and the grouped products on
          every rank's copy, the combine, then the sum over ranks (the
          JAX `lax.psum`, left to XLA: a torch sum in f32, rounded once);
  fused — sequence-sharded, local routing, capacity-packed blocks
          through the grouped ag_gemm kernel (silu_pair, arrival order),
          the E-batched down product, the gather-formulated combine and
          the ring ReduceScatter kernel (`fused_ag_moe_up`,
          `fused_moe_down_combine_rs`). The default capacity is exact
          (m_tok * top_k rows an expert): lossless, like every mode.

`return_drops=True` returns (y, drops): (n,) dropped (token, choice)
rows a rank, zero but in `fused` with a smaller capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels import allgather_group_gemm as _agg
from triton_dist_tpu_torch.kernels import grouped_gemm as _gg
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    reduce_scatter_plain,
)
from triton_dist_tpu_torch.kernels.allgather import ring_all_gather_plain
from triton_dist_tpu_torch.kernels.moe_utils import (
    combine_topk,
    silu_mul,
    sort_by_expert,
    topk_routing,
)
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class TPMoEParams(NamedTuple):
    w_router: torch.Tensor   # (H, E) replicated
    w_gate_up: torch.Tensor  # (n, E, H, 2*I/n)
    w_down: torch.Tensor     # (n, E, I/n, H)


def _route(x_full: torch.Tensor, params: TPMoEParams, top_k: int):
    """Router on one copy of the full token set (M, H), in f32."""
    logits = x_full.float() @ params.w_router.float()
    weights, ids = topk_routing(logits, top_k)
    return weights, ids, sort_by_expert(ids, params.w_router.shape[-1])


def _ret(y: torch.Tensor, return_drops: bool):
    if not return_drops:
        return y
    return y, torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)


def tp_moe_ar_fwd(x: torch.Tensor, params: TPMoEParams, top_k: int,
                  world: VirtualWorld, return_drops: bool = False):
    """x (n, M, H) replicated -> (n, M, H) replicated."""
    weights, _, sort = _route(x[0], params, top_k)
    h = _gg.grouped_gemm(x[:, sort.token_idx], params.w_gate_up,
                         sort.group_sizes)
    act = silu_mul(h).to(x.dtype)
    y_sorted = _gg.grouped_gemm(act, params.w_down, sort.group_sizes,
                                out_dtype=torch.float32)
    y = combine_topk(y_sorted, sort, weights).to(x.dtype)
    total = y.float().sum(0).to(x.dtype)
    return _ret(total.expand_as(y), return_drops)


def tp_moe_xla_fwd(x: torch.Tensor, params: TPMoEParams, top_k: int,
                   world: VirtualWorld, return_drops: bool = False):
    """x (n, M/n, H) sharded -> (n, M/n, H) sharded."""
    x_full = ring_all_gather_plain(x)
    weights, _, sort = _route(x_full[0], params, top_k)
    h = _agg.ag_group_gemm_ref(x, params.w_gate_up, sort)
    act = silu_mul(h).to(x.dtype)
    y_sorted = _gg.grouped_gemm(act, params.w_down, sort.group_sizes,
                                out_dtype=torch.float32)
    y = combine_topk(y_sorted, sort, weights).to(x.dtype)
    return _ret(reduce_scatter_plain(y), return_drops)


def tp_moe_dist_fwd(x: torch.Tensor, params: TPMoEParams, top_k: int,
                    world: VirtualWorld, return_drops: bool = False):
    """x (n, M/n, H) sharded -> (n, M/n, H) sharded."""
    x_full = _agg.moe_all_gather(x)
    weights, _, sort = _route(x_full[0], params, top_k)
    h = _agg.ag_group_gemm(x_full, params.w_gate_up, sort)
    act = silu_mul(h).to(x.dtype)
    return _ret(_agg.moe_reduce_rs(act, params.w_down, sort, weights,
                                   out_dtype=x.dtype), return_drops)


def tp_moe_fused_fwd(x: torch.Tensor, params: TPMoEParams, top_k: int,
                     world: VirtualWorld, capacity=None,
                     return_drops: bool = False):
    """x (n, m_tok, H) sharded -> (n, m_tok, H) sharded; each rank routes
    its own tokens."""
    logits = x.float() @ params.w_router.float()
    weights, ids = topk_routing(logits, top_k)
    i2 = params.w_gate_up.shape[-1] // 2
    act, meta = _agg.fused_ag_moe_up(
        x, ids, weights, params.w_gate_up[..., :i2],
        params.w_gate_up[..., i2:], capacity=capacity)
    y = _agg.fused_moe_down_combine_rs(act, params.w_down, meta,
                                       out_dtype=x.dtype)
    return (y, meta.drops) if return_drops else y


MODES = {
    "xla": tp_moe_xla_fwd,
    "dist": tp_moe_dist_fwd,
    "ar": tp_moe_ar_fwd,
    "fused": tp_moe_fused_fwd,
}


def tp_moe_fwd(x: torch.Tensor, params: TPMoEParams, top_k: int,
               world: VirtualWorld, mode: str = "dist", **kw):
    """The block in `mode` (the JAX default "dist"): x sharded (n, M/n,
    H) in "dist", "xla" and "fused", replicated (n, M, H) in "ar". The
    fused lowering's capacity and every mode's return_drops pass through
    **kw."""
    return MODES[mode](x, params, top_k, world, **kw)

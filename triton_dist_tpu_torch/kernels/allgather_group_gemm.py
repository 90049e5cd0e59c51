"""AG + grouped GEMM and grouped GEMM + top-k combine + RS, the TP-MoE
pair — port of triton_dist_tpu.kernels.allgather_group_gemm
(`moe_all_gather`, `ag_group_gemm`, `ag_group_gemm_ref`,
`moe_reduce_rs`, `MoEFusedMeta`, `fused_ag_moe_up`,
`fused_moe_down_combine_rs`), over the virtual world.

Rank-stacked, as everywhere in the port: tokens x (n, m, H), expert
stacks w (n, E, K, N) (each rank's slice of every expert's FFN dim).
The routing of the sequence-sharded and replicated paths (ExpertSort) is
computed once from the gathered tokens, which every rank holds bitwise
alike, so one table serves all ranks, as the JAX package computes the
same table on each.

The hand-written kernels on these paths, called through their modules
so a caller can wrap them: the ring AllGather (`moe_all_gather`), the
ring ReduceScatter (`moe_reduce_rs`, `fused_moe_down_combine_rs`) and
the grouped form of the fused AllGather + GEMM (`fused_ag_moe_up`). The
grouped products of the sorted layout are `grouped_gemm` (torch, as the
JAX package leaves `ragged_dot` to XLA; called through its module too),
the fused path's E-batched down
product one `bmm` (the JAX `dot_general` outside any kernel), and the
metadata all-gathers and the combines are torch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triton_dist_tpu_torch.kernels import allgather as _ring
from triton_dist_tpu_torch.kernels import allgather_gemm as _ag
from triton_dist_tpu_torch.kernels import grouped_gemm as _gg
from triton_dist_tpu_torch.kernels import reduce_scatter as _rs
from triton_dist_tpu_torch.kernels.moe_utils import (
    ExpertSort,
    combine_topk,
    pack_by_expert,
)


def moe_all_gather(x_shard: torch.Tensor) -> torch.Tensor:
    """(n, m, H) -> every rank's gathered tokens (n, n*m, H), once a
    layer (the ring kernel); they feed both the router and the grouped
    gate|up product."""
    return _ring.ring_all_gather(x_shard)


def ag_group_gemm(x_full: torch.Tensor, w_stack: torch.Tensor,
                  sort: ExpertSort) -> torch.Tensor:
    """The gathered tokens (`moe_all_gather`'s, which the router reads
    too), each row repeated per routed expert in sorted order, grouped
    product with every rank's expert slice: (n, M*k, N_loc) in sorted
    order."""
    return _gg.grouped_gemm(x_full[:, sort.token_idx], w_stack,
                            sort.group_sizes)


def ag_group_gemm_ref(x_shard: torch.Tensor, w_stack: torch.Tensor,
                      sort: ExpertSort) -> torch.Tensor:
    """The unfused reference: a torch all-gather, then the grouped
    product."""
    return ag_group_gemm(_ring.ring_all_gather_plain(x_shard), w_stack, sort)


def moe_reduce_rs(act_sorted: torch.Tensor, w_down_stack: torch.Tensor,
                  sort: ExpertSort, topk_weights: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """Grouped down product (f32 out), top-k weighted combine, cast to
    out_dtype, then the ring ReduceScatter back to the sequence shards:
    (n, M/n, H)."""
    out_dtype = out_dtype or act_sorted.dtype
    y_sorted = _gg.grouped_gemm(act_sorted, w_down_stack, sort.group_sizes,
                                out_dtype=torch.float32)
    # the einsum leaves (n, M, H) in a permuted layout; the RS reads rows
    y = combine_topk(y_sorted, sort, topk_weights).to(out_dtype).contiguous()
    if y.shape[0] == 1:
        return y
    return _rs.reduce_scatter(y)


# -- the fused pair: capacity-packed blocks through the grouped ag_gemm ----


class MoEFusedMeta(NamedTuple):
    """The combine's metadata, gathered over the ranks (the JAX
    `lax.all_gather`s, a stack here: every rank holds the same table)."""

    slot_of: torch.Tensor  # (n, m_tok, k) slot in the source shard, -1 = drop
    weights: torch.Tensor  # (n, m_tok, k) f32 top-k weights
    drops: torch.Tensor    # (n,) int32 each rank's dropped (token, choice)


def capacity_rows(m_tok: int, k: int, dtype,
                  capacity: Optional[int] = None) -> int:
    """Rows an expert block: m_tok * k by default (lossless), or the
    caller's capacity; clamped to [1, m_tok*k] and rounded up to the JAX
    package's sublane tile (`min_tile`: 8 rows for 4-byte, 16 for 2-byte
    dtypes), so the shapes match its."""
    if capacity is None:
        capacity = m_tok * k
    tile = {4: 8, 2: 16}.get(torch.empty((), dtype=dtype).element_size(), 32)
    cap = min(max(capacity, 1), m_tok * k)
    return -(-cap // tile) * tile


def fused_ag_moe_up(x_shard: torch.Tensor, topk_ids: torch.Tensor,
                    topk_weights: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, capacity: Optional[int] = None):
    """Pack each rank's tokens into E blocks of cap rows, then one grouped
    ag_gemm (silu_pair, arrival order) gathers the blocks over the ring
    and multiplies block e by expert e's gate and up slices; the packs'
    counts tell it which rows of each block are live (the rest are zero
    rows, whose C rows are zero), so the card forwards and multiplies
    only those, with no host read of them. x_shard
    (n, m_tok, H), topk_ids / topk_weights (n, m_tok, k) (local routing),
    w_gate / w_up (n, E, H, I_loc) (views of one stack). Returns
    (act (n, n, E, cap, I_loc) [rank][arrival step][expert][row] in
    x.dtype, meta)."""
    n, m_tok, _ = x_shard.shape
    e = w_gate.shape[1]
    k = topk_ids.shape[-1]
    cap = capacity_rows(m_tok, k, x_shard.dtype, capacity)
    packs = [pack_by_expert(x_shard[r], topk_ids[r], e, cap)
             for r in range(n)]
    act = _ag.ag_gemm(torch.stack([p.x for p in packs]), (w_gate, w_up),
                      epilogue="silu_pair", c_order="arrival",
                      counts=torch.stack([p.counts for p in packs]))
    meta = MoEFusedMeta(slot_of=torch.stack([p.slot_of for p in packs]),
                        weights=topk_weights.float(),
                        drops=torch.stack([p.drops for p in packs]))
    return act.reshape(n, n, e, cap, w_gate.shape[-1]), meta


def fused_moe_down_combine_rs(act: torch.Tensor, w_down: torch.Tensor,
                              meta: MoEFusedMeta,
                              out_dtype=None) -> torch.Tensor:
    """E-batched down product in f32, the top-k combine as one gather
    through the packs' inverse maps, cast, then the ReduceScatter:
    act (n, n, E, cap, I_loc), w_down (n, E, I_loc, H) -> (n, m_tok, H).
    Source rank r's blocks sit at arrival step (me - r) mod n."""
    from triton_dist_tpu_torch.layers.linear import dot_f32

    n, _, e, cap, i_loc = act.shape
    h = w_down.shape[-1]
    out_dtype = out_dtype or act.dtype
    xe = act.permute(0, 2, 1, 3, 4).reshape(n * e, n * cap, i_loc)
    ye = dot_f32(xe, w_down.reshape(n * e, i_loc, h))  # [me, e] (s, p) rows
    ye = ye.reshape(n, e * n * cap, h)
    m_tok, k = meta.slot_of.shape[1:]
    dev = act.device
    me = torch.arange(n, device=dev)
    step = (me[:, None] - me[None, :]) % n  # [me][source rank r]
    live = meta.slot_of >= 0
    slot = meta.slot_of.clamp(min=0).long()
    # slot e*cap + p of rank r's pack -> row e*n*cap + s*cap + p of ye[me]
    row = ((slot // cap) * (n * cap) + slot % cap)[None] \
        + (step * cap)[:, :, None, None]
    row = torch.where(live[None], row, 0).reshape(n, -1)
    rows = ye[me[:, None], row].reshape(n, n, m_tok, k, h)
    wts = torch.where(live, meta.weights, 0.0)
    y = torch.einsum("anmkh,nmk->anmh", rows, wts)  # (n_me, n_r, m_tok, H)
    y = y.reshape(n, n * m_tok, h).to(out_dtype).contiguous()
    if n == 1:
        return y
    return _rs.reduce_scatter(y)

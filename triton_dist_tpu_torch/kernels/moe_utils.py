"""MoE routing utilities — port of triton_dist_tpu.kernels.moe_utils
(`topk_routing`, `silu_mul`, `expert_histogram`, `ExpertSort` /
`sort_by_expert`, `ExpertPack` / `pack_by_expert`, `chunk_group_sizes`,
`combine_topk`).

The JAX package leaves all of these to XLA, so they are torch ops here,
not kernels. Shapes are the JAX per-device ones ((M, E) logits, (M, k)
routing tables); `topk_routing` and `combine_topk` also take leading
rank dims. Nothing here waits on the card: the expert counts are a
`scatter_add_` into E bins (`torch.bincount` on a CUDA tensor reads the
largest id back to the host to size its output), and sorts are
`torch.sort(stable=True)`, so a layer's routing stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import silu_mul as _silu_mul


def topk_routing(router_logits: torch.Tensor, k: int,
                 normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k router on (..., M, E) logits, in f32. Returns
    (weights (..., M, k) f32, ids (..., M, k) int32), renormalised to
    sum 1 over the k choices when `normalize`."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    if normalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids.to(torch.int32)


def silu_mul(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up over a fused (..., 2I) gate|up product, in f32."""
    gate, up = torch.chunk(h.float(), 2, dim=-1)
    return _silu_mul(gate, up)


def expert_histogram(topk_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Tokens per expert (E,) int32, the `bincount(minlength=E)` of the
    routing table, counted on the device."""
    flat = topk_ids.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat)).to(torch.int32)


class ExpertSort(NamedTuple):
    """(token, choice) pairs sorted by expert id, stable."""

    sort_idx: torch.Tensor     # (M*k,) sorted position -> flat tok*k+j
    token_idx: torch.Tensor    # (M*k,) source token row per sorted position
    group_sizes: torch.Tensor  # (E,) rows per expert, in sorted order
    unsort_idx: torch.Tensor   # (M*k,) flat tok*k+j -> sorted position


def sort_by_expert(topk_ids: torch.Tensor, n_experts: int) -> ExpertSort:
    """Stable sort of the (M, k) routing table by expert id."""
    k = topk_ids.shape[1]
    flat = topk_ids.reshape(-1)
    sort_idx = torch.sort(flat, stable=True).indices
    unsort_idx = torch.sort(sort_idx, stable=True).indices
    return ExpertSort(sort_idx, sort_idx // k,
                      expert_histogram(topk_ids, n_experts), unsort_idx)


class ExpertPack(NamedTuple):
    """A rank's tokens packed into fixed-capacity per-expert blocks."""

    x: torch.Tensor        # (E * cap, H) tokens grouped by expert
    slot_of: torch.Tensor  # (M, k) flat slot e*cap+p per choice, -1 = drop
    counts: torch.Tensor   # (E,) tokens per expert, clamped to cap
    drops: torch.Tensor    # () int32 rows dropped beyond cap


def pack_by_expert(x: torch.Tensor, topk_ids: torch.Tensor, n_experts: int,
                   capacity: int) -> ExpertPack:
    """Slot (e, p) takes the p-th (token, choice) pair routed to expert
    e in stable token order; unfilled slots are zero rows, pairs beyond
    `capacity` are dropped. `slot_of` is the inverse map, which the
    combine reads the expert outputs back through. The JAX function's
    gather formulation, op for op."""
    m, k = topk_ids.shape
    c = capacity
    dev = x.device
    flat_ids = topk_ids.reshape(-1).long()
    order = torch.sort(flat_ids, stable=True).indices
    inv_order = torch.sort(order, stable=True).indices
    seg_count = expert_histogram(topk_ids, n_experts).long()
    seg_start = torch.cumsum(seg_count, 0) - seg_count

    slots = torch.arange(n_experts * c, device=dev)
    slot_e, slot_p = slots // c, slots % c
    valid = slot_p < torch.clamp(seg_count, max=c)[slot_e]
    entry = order[torch.clamp(seg_start[slot_e] + slot_p, max=m * k - 1)]
    tok = torch.where(valid, entry // k, 0)
    xp = torch.where(valid[:, None], x[tok], torch.zeros((), dtype=x.dtype,
                                                         device=dev))
    p_of = inv_order - seg_start[flat_ids]
    slot_of = torch.where(p_of < c, flat_ids * c + p_of, -1)
    drops = torch.clamp(seg_count - c, min=0).sum()
    return ExpertPack(x=xp, slot_of=slot_of.to(torch.int32).reshape(m, k),
                      counts=torch.clamp(seg_count, max=c).to(torch.int32),
                      drops=drops.to(torch.int32))


def chunk_group_sizes(expert_counts: torch.Tensor, capacity: int, lo: int,
                      rows: int) -> torch.Tensor:
    """Expert-group sizes of the capacity chunk [lo, lo + rows) of an
    expert-sorted dispatch buffer (kernels/ep_a2a.py): expert_counts
    (..., E) valid rows per (segment, expert), each segment's groups in
    expert order with its invalid slots at the tail. Returns (..., E+1)
    int32, the rows of each group inside the chunk, summing to `rows`
    (the last column is the null group of invalid slots). Pure
    arithmetic: the running sums clipped to the chunk."""
    counts = expert_counts.to(torch.int32)
    zero = torch.zeros((*counts.shape[:-1], 1), dtype=torch.int32,
                       device=counts.device)
    bounds = torch.cat([zero, torch.cumsum(counts, -1, dtype=torch.int32),
                        zero + capacity], dim=-1)
    clipped = torch.clamp(bounds, lo, lo + rows)
    return (clipped[..., 1:] - clipped[..., :-1]).to(torch.int32)


def combine_topk(y_sorted: torch.Tensor, sort: ExpertSort,
                 topk_weights: torch.Tensor) -> torch.Tensor:
    """Unsort and take the weighted sum over the k choices: y_sorted
    (..., M*k, H) in sorted order -> (..., M, H) f32."""
    m, k = topk_weights.shape
    y = y_sorted[..., sort.unsort_idx, :].float()
    y = y.reshape(*y.shape[:-2], m, k, y.shape[-1])
    return torch.einsum("...mkh,mk->...mh", y, topk_weights.float())

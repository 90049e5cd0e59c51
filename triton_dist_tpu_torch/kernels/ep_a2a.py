"""EP dispatch and combine — port of triton_dist_tpu.kernels.ep_a2a: the
expert-parallel token exchange over the all-to-all (kernels/
all_to_all.py), sequential (`ep_dispatch`, `ep_expert_ffn`,
`ep_combine`) and chunk-pipelined (`ep_dispatch_chunked`,
`ep_expert_ffn_chunked`, `ep_combine_chunked`, assembled by
`ep_moe_pipeline`).

Rank-stacked over the virtual world: x (n, M, H) holds rank r's tokens
at [r], the routing tables (n, M, k), each rank's experts w_gate_up (n,
E/n, H, 2I) as [gate | up] and w_down (n, E/n, I, H). Every function
computes all n ranks' per-device JAX functions at once; the JAX
per-device (n, C, ...) buffers gain the rank dim in front: (n, n, C,
...), [r, j] rank r's segment from (or for) rank j.

The formulation is the JAX package's, op for op: each rank packs at most
`capacity` routed (token, expert) pairs per destination rank in stable
token order (pairs beyond it are dropped and counted, GShard's trade),
with the local expert id folded into lane-padding column H of the
payload (round_up(H + 1, 128) columns), so one all-to-all moves tokens
and routing. The combine pairs the returned segments with the
origin-side metadata, so nothing travels back but the results. The
chunked forms expert-sort each segment at pack time and send the
per-expert counts in the splits row, so each capacity chunk's grouped
products follow from arithmetic (moe_utils.chunk_group_sizes).

Where the port differs, the result the same:
  - the null group: the JAX FFNs run the invalid slots through expert
    0's weights in a trailing group (`_extended_stacks`) and mask their
    rows to 0 after; here those rows are left out of the products and
    are 0 from the start, the same function bit for bit. At M = 128 a
    rank and the lossless capacity the null group is ~3/4 of the 4096
    received slots, and `grouped_gemm`'s card route pads every expert
    to its largest group; so `_extended_stacks` has no counterpart;
  - host syncs: the card route of an f32-out `grouped_gemm` needs its
    group sizes on the host. The sequential FFN reads them once for
    both products, the chunked FFN reads the received expert counts
    once and derives every chunk's sizes on the host (`chunk_group_
    sizes` is arithmetic): one sync an FFN, none a product;
  - the combine's scatter-add: JAX's `out.at[rows].add` on the CPU adds
    a row's contributions in ascending slot order. `index_add_` on the
    card uses atomics, whose order changes from run to run; the port
    gathers each token row's at most top_k slots in ascending slot
    order and adds them in that order (`_combine_scatter`), on every
    device, so two calls, and the chunked and single-shot transports,
    agree bitwise;
  - the trace outputs under `trace.building` are not ported.

payload_dtype=torch.float8_e4m3fn is the fp8 wire (the JAX `_byte_wire`
pack): each token is quantized with one scale a row (wire.quantize at
FP8, the codec's one definition), and its row of round_up(H + 8, 128)
bytes holds the e4m3 payload, then the f32 scale and the int32 local
expert id bitcast little-endian, then zeros. The pack keeps the bytes as
uint8 (the all-to-all kernels move bytes, whatever the dtype); the
receiver decodes payload times scale in f32, rounded to x.dtype. A
payload_dtype that is not one byte wide raises, as in JAX; None is the
x.dtype wire.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import grouped_gemm as _gg
from triton_dist_tpu_torch.kernels.all_to_all import (
    all_to_all,
    all_to_all_chunked,
    all_to_all_plain,
)
from triton_dist_tpu_torch.kernels.moe_utils import (
    chunk_group_sizes,
    silu_mul,
)


class EPDispatch(NamedTuple):
    """Received tokens and routing after dispatch; the send_* fields are
    the origin side's copy of what it packed for each destination."""

    x: torch.Tensor             # (n, n, C, H) tokens from each source rank
    local_expert: torch.Tensor  # (n, n, C) expert index within the rank
    valid: torch.Tensor         # (n, n, C) bool, receive side
    counts: torch.Tensor        # (n, n) valid slots per received segment
    send_src_row: torch.Tensor  # (n, n, C) our token row per sent slot
    send_weight: torch.Tensor   # (n, n, C) top-k weight per sent slot
    send_valid: torch.Tensor    # (n, n, C) bool, send side
    send_counts: torch.Tensor   # (n, n) slots sent per destination
    drops: torch.Tensor         # (n,) int32 pairs beyond capacity a rank


def _byte_wire(payload_dtype) -> bool:
    """True for the fp8 wire; a payload_dtype that is not one byte wide
    raises (a silently ignored one would ship the full-width wire)."""
    if payload_dtype is None:
        return False
    if payload_dtype.itemsize != 1:
        raise ValueError(
            f"payload_dtype {payload_dtype} unsupported: the quantized wire "
            "format requires a 1-byte dtype (torch.float8_e4m3fn) or None "
            "for the full-width x.dtype wire")
    if payload_dtype != torch.float8_e4m3fn:
        raise ValueError(
            f"payload_dtype {payload_dtype}: the one-byte wire is e4m3 "
            "(torch.float8_e4m3fn)")
    return True


class _Pack(NamedTuple):
    """Origin-side pack of routed tokens into per-destination buffers."""

    send_x: torch.Tensor     # (n, n, C, H_pad) wire payload
    src_rows: torch.Tensor   # (n, n, C) our token row per slot
    weights: torch.Tensor    # (n, n, C) f32 top-k weight per slot
    valid: torch.Tensor      # (n, n, C) bool
    counts: torch.Tensor     # (n, n) int32 valid slots per destination
    drops: torch.Tensor      # (n,) int32 pairs beyond capacity
    exp_counts: Optional[torch.Tensor]  # (n, n, E_loc) when expert_sorted


def _bins(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Per-rank bincount of idx (n, L) into `length` bins, on the device
    (no host sync)."""
    out = torch.zeros((idx.shape[0], length), dtype=torch.long,
                      device=idx.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx))


def _pack_by_dest(x, ids, weights, n_ranks, experts_per_rank, capacity,
                  payload_dtype=None, expert_sorted=False) -> _Pack:
    """Fixed-capacity per-destination send buffers for every rank: x (n,
    M, H), ids / weights (n, M, k). Slot (d, p) takes the p-th pair
    routed to rank d in stable token order (a stable sort by
    destination), the local expert id in payload column H. With
    expert_sorted, each destination block's kept slots are re-ordered by
    local expert (invalid slots at the tail) after the capacity cut, and
    the per-(destination, expert) counts come back in exp_counts. The
    fp8 wire (payload_dtype) packs uint8 rows of round_up(H + 8, 128)
    bytes: payload, f32 scale, int32 expert id, zeros."""
    n, m, k = ids.shape
    c = capacity
    dev = x.device
    flat_ids = ids.reshape(n, m * k).long()
    dest = flat_ids // experts_per_rank
    order = torch.sort(dest, dim=1, stable=True).indices
    seg_count = _bins(dest, n_ranks)
    seg_start = torch.cumsum(seg_count, 1) - seg_count

    slots = torch.arange(n_ranks * c, device=dev)
    slot_dest, slot_pos = slots // c, slots % c
    valid = slot_pos < torch.clamp(seg_count, max=c)[:, slot_dest]
    entry = torch.gather(order, 1, torch.clamp(
        seg_start[:, slot_dest] + slot_pos, max=m * k - 1))
    src_rows = torch.where(valid, entry // k, 0)
    local_exp = torch.where(
        valid, torch.gather(flat_ids, 1, entry) % experts_per_rank, 0)
    w_flat = torch.where(valid, torch.gather(
        weights.reshape(n, m * k).float(), 1, entry), 0.0)

    exp_counts = None
    if expert_sorted:
        key = slot_dest * (experts_per_rank + 1) + torch.where(
            valid, local_exp, experts_per_rank)
        perm = torch.sort(key, dim=1, stable=True).indices
        src_rows, local_exp, w_flat, valid = (
            torch.gather(t, 1, perm)
            for t in (src_rows, local_exp, w_flat, valid))
        exp_counts = _bins(torch.where(
            valid, slot_dest * experts_per_rank + local_exp,
            n_ranks * experts_per_rank), n_ranks * experts_per_rank + 1)
        exp_counts = exp_counts[:, :-1].reshape(
            n, n_ranks, experts_per_rank).to(torch.int32)

    h = x.shape[-1]
    idx = src_rows[..., None].expand(n, n_ranks * c, h)
    if _byte_wire(payload_dtype):
        q, scale = wire.quantize(x, wire.FP8)
        h_pad = -(-(h + 8) // 128) * 128
        send_x = torch.zeros((n, n_ranks * c, h_pad), dtype=torch.uint8,
                             device=dev)
        send_x[..., :h] = torch.where(
            valid[..., None],
            torch.gather(q.view(torch.uint8), 1, idx), 0)
        sc = torch.where(valid, torch.gather(scale[..., 0], 1, src_rows), 0.0)
        send_x[..., h:h + 4] = sc[..., None].contiguous().view(torch.uint8)
        send_x[..., h + 4:h + 8] = local_exp.to(torch.int32)[..., None] \
            .contiguous().view(torch.uint8)
    else:
        # the expert id travels in lane padding: exact in bf16 up to 256
        assert experts_per_rank <= 256 or x.element_size() >= 4, (
            "expert id not exactly representable in bf16 lane padding")
        h_pad = -(-(h + 1) // 128) * 128
        send_x = torch.zeros((n, n_ranks * c, h_pad), dtype=x.dtype,
                             device=dev)
        send_x[..., :h] = torch.where(
            valid[..., None], torch.gather(x, 1, idx),
            torch.zeros((), dtype=x.dtype, device=dev))
        send_x[..., h] = local_exp.to(x.dtype)
    return _Pack(
        send_x=send_x.reshape(n, n_ranks, c, h_pad),
        src_rows=src_rows.reshape(n, n_ranks, c),
        weights=w_flat.reshape(n, n_ranks, c),
        valid=valid.reshape(n, n_ranks, c),
        counts=torch.clamp(seg_count, max=c).to(torch.int32),
        drops=torch.clamp(seg_count - c, min=0).sum(1).to(torch.int32),
        exp_counts=exp_counts,
    )


def ep_dispatch(x: torch.Tensor, topk_ids: torch.Tensor,
                topk_weights: torch.Tensor, n_experts: int, capacity: int,
                payload_dtype=None, transport: str = "plain") -> EPDispatch:
    """Route every rank's tokens (n, M, H) to their experts' owner ranks
    over the single-shot all-to-all (transport "plain", the kernel) or
    its plain version ("ref"). payload_dtype=torch.float8_e4m3fn: the
    fp8 wire, tokens dequantized to x.dtype on arrival."""
    n, _, h = x.shape
    pack = _pack_by_dest(x, topk_ids, topk_weights, n, n_experts // n,
                         capacity, payload_dtype)
    recv, recv_counts = _a2a_select(transport, 1, None)(pack.send_x,
                                                         pack.counts)
    slot = torch.arange(capacity, device=x.device)
    tokens, local_expert = _decode_payload(recv, h, x.dtype)
    return EPDispatch(
        x=tokens, local_expert=local_expert,
        valid=slot < recv_counts[..., None], counts=recv_counts,
        send_src_row=pack.src_rows, send_weight=pack.weights,
        send_valid=pack.valid, send_counts=pack.counts, drops=pack.drops)


def _decode_payload(recv: torch.Tensor, h: int, out_dtype):
    """(tokens (..., C, H) in out_dtype, local_expert (..., C) int32):
    the payload's first H columns and the expert id in column H, or, on
    the fp8 wire (uint8 rows), the dequantized payload and the id from
    its metadata bytes."""
    if recv.dtype != torch.uint8:
        return recv[..., :h], recv[..., h].to(torch.int32)
    scale = recv[..., h:h + 4].contiguous().view(torch.float32)
    local_expert = recv[..., h + 4:h + 8].contiguous().view(torch.int32)
    q = recv[..., :h].contiguous().view(torch.float8_e4m3fn)
    return (wire.dequantize(q, scale, wire.FP8, out_dtype),
            local_expert[..., 0])


def ep_expert_ffn(disp: EPDispatch, w_gate_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """Every rank's experts over its received tokens -> (n, n, C, H)
    f32: the valid slots stable-sorted by local expert, the grouped
    gate|up and down products with f32 outputs (silu_mul between, cast
    to the token dtype), unsorted; invalid slots are 0 (module
    docstring: the null group is not computed)."""
    e_loc = w_gate_up.shape[1]
    n, n_src, c, h = disp.x.shape
    t = n_src * c
    x_flat = disp.x.reshape(n, t, h)
    exp = torch.where(disp.valid.reshape(n, t),
                      disp.local_expert.reshape(n, t).long(), e_loc)
    order = torch.sort(exp, dim=1, stable=True).indices
    inv = torch.sort(order, dim=1, stable=True).indices
    sizes = _bins(exp, e_loc + 1)[:, :e_loc]
    host = sizes.tolist()  # the FFN's one host sync
    x_sorted = torch.gather(x_flat, 1, order[..., None].expand(n, t, h))
    hh = _gg.grouped_gemm(x_sorted, w_gate_up, sizes,
                          out_dtype=torch.float32, host_sizes=host)
    act = silu_mul(hh).to(disp.x.dtype)
    y_sorted = _gg.grouped_gemm(act, w_down, sizes, out_dtype=torch.float32,
                                host_sizes=host)
    y = torch.gather(y_sorted, 1, inv[..., None].expand(n, t, h))
    return torch.where(disp.valid[..., None], y.reshape(n, n_src, c, h), 0.0)


def _combine_scatter(back: torch.Tensor, disp, m: int, top_k: int,
                     out_dtype) -> torch.Tensor:
    """Weighted sum of the returned segments back (n, n, C, H) f32 into
    every rank's (M, H): back[r, j] is the segment rank r packed for
    rank j, so the send_* fields pair with it. A token row adds its at
    most top_k contributions in ascending slot order from 0.0, the order
    of JAX's sequential `out.at[rows].add` on the CPU (an invalid slot
    adds 0.0 there, which changes no sum); no atomics and no host sync,
    so the result is the same on every device and every call."""
    n, n_dst, c, h = back.shape
    s = n_dst * c
    dev = back.device
    valid = disp.send_valid.reshape(n, s)
    rows = torch.where(valid, disp.send_src_row.reshape(n, s).long(), m)
    w = torch.where(valid, disp.send_weight.reshape(n, s), 0.0)
    contrib = back.reshape(n, s, h) * w[..., None]
    contrib = torch.cat([contrib, contrib.new_zeros((n, 1, h))], 1)
    # table[r, row, j]: the j-th slot of `row` in slot order (s: none);
    # the invalid slots go to row m, their places past top_k to column
    # top_k, both sliced off
    pos = torch.arange(s, device=dev)
    ranked = torch.sort(rows * s + pos, dim=1).values
    row_of, slot_of = ranked // s, ranked % s
    per_row = _bins(rows, m + 1)
    first = torch.cumsum(per_row, 1) - per_row
    place = torch.clamp(pos - torch.gather(first, 1, row_of), max=top_k)
    table = torch.full((n, m + 1, top_k + 1), s, dtype=torch.long,
                       device=dev)
    ranks = torch.arange(n, device=dev)[:, None]
    table[ranks.expand(n, s), row_of, place] = slot_of
    out = torch.zeros((n, m, h), dtype=torch.float32, device=dev)
    for j in range(top_k):
        out = out + contrib[ranks, table[:, :m, j]]
    return out.to(out_dtype)


def ep_combine(y: torch.Tensor, disp: EPDispatch, m: int, top_k: int,
               out_dtype, transport: str = "plain") -> torch.Tensor:
    """Send every rank's expert outputs y (n, n, C, H) back to their
    source ranks (f32) and take each token's weighted sum -> (n, M, H)
    in out_dtype."""
    back, _ = _a2a_select(transport, 1, None)(y.float(), disp.counts)
    return _combine_scatter(back, disp, m, top_k, out_dtype)


# -- the chunk-pipelined EP MoE -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpMoeConfig:
    """Knobs of the chunk-pipelined EP MoE: n_chunks, and capacity_factor
    (1.0 is lossless; below it opts into the GShard drop trade)."""

    n_chunks: int = 1
    capacity_factor: float = 1.0

    def fit_capacity(self, m: int, top_k: int) -> int:
        """The capacity of `capacity_factor`, rounded up, at least 1."""
        return max(1, math.ceil(m * top_k * self.capacity_factor))


class EPChunkDispatch(NamedTuple):
    """ep_dispatch_chunked's result: segments arrive expert-sorted
    (invalid slots at each segment's tail) with their per-expert counts
    in place of per-slot expert ids."""

    x: torch.Tensor              # (n, n, C, H) tokens, expert-sorted
    expert_counts: torch.Tensor  # (n, n, E_loc) valid rows a (segment, expert)
    valid: torch.Tensor          # (n, n, C) bool (tail slots invalid)
    counts: torch.Tensor         # (n, n) valid slots per received segment
    send_src_row: torch.Tensor   # (n, n, C)
    send_weight: torch.Tensor    # (n, n, C)
    send_valid: torch.Tensor     # (n, n, C)
    send_counts: torch.Tensor    # (n, n)
    drops: torch.Tensor          # (n,) int32


def _a2a_select(transport: str, n_chunks: int, straggler):
    """The transport arm, (x, splits) -> (out, out_splits): "chunked"
    (the chunked kernel, per-chunk delivery flags), "plain" (the
    single-shot kernel) or "ref" (the plain torch version: the
    bit-identity oracle, all three move the same bytes)."""
    if transport == "chunked":
        return lambda x, s: all_to_all_chunked(x, s, n_chunks=n_chunks,
                                               straggler=straggler)
    if transport == "plain":
        return all_to_all
    if transport == "ref":
        return all_to_all_plain
    raise ValueError(f"unknown transport {transport!r}")


def ep_dispatch_chunked(x: torch.Tensor, topk_ids: torch.Tensor,
                        topk_weights: torch.Tensor, n_experts: int,
                        capacity: int, n_chunks: int = 1,
                        payload_dtype=None, transport: str = "chunked",
                        straggler: Optional[Tuple[int, int]] = None
                        ) -> EPChunkDispatch:
    """Expert-sorted pack and the chunked all-to-all: the routing and
    drops of ep_dispatch (the capacity cut comes before the sort); the
    splits row [count, per-expert counts] travels with each segment;
    payload_dtype as in ep_dispatch."""
    n, _, h = x.shape
    pack = _pack_by_dest(x, topk_ids, topk_weights, n, n_experts // n,
                         capacity, payload_dtype, expert_sorted=True)
    meta = torch.cat([pack.counts[..., None], pack.exp_counts], -1)
    recv, recv_meta = _a2a_select(transport, n_chunks, straggler)(
        pack.send_x, meta)
    slot = torch.arange(capacity, device=x.device)
    recv_counts = recv_meta[..., 0]
    tokens, _ = _decode_payload(recv, h, x.dtype)
    return EPChunkDispatch(
        x=tokens, expert_counts=recv_meta[..., 1:],
        valid=slot < recv_counts[..., None], counts=recv_counts,
        send_src_row=pack.src_rows, send_weight=pack.weights,
        send_valid=pack.valid, send_counts=pack.counts, drops=pack.drops)


def fit_chunks(n_chunks: int, capacity: int) -> int:
    """The largest chunk count <= n_chunks that divides capacity: the
    count adapts, never the capacity (which fixes the drops)."""
    q = max(1, min(int(n_chunks), capacity))
    while capacity % q:
        q -= 1
    return q


def ep_expert_ffn_chunked(disp: EPChunkDispatch, w_gate_up: torch.Tensor,
                          w_down: torch.Tensor,
                          n_chunks: int = 1) -> torch.Tensor:
    """Every rank's experts chunk by chunk over its expert-sorted received
    tokens -> (n, n, C, H) f32 in slot order. Chunk c's group sizes are
    chunk_group_sizes of the travelled counts, derived on the host from
    one read of them; each (chunk, source segment) runs the grouped
    gate|up and down products for all ranks at once. Invalid rows are 0
    (module docstring: the null group is not computed)."""
    n, n_src, c, h = disp.x.shape
    if c % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} must divide capacity {c}")
    e_loc = w_gate_up.shape[1]
    counts = disp.expert_counts.cpu()  # the FFN's one host sync
    rows = c // n_chunks
    # every chunk's sizes (q, n, n_src, E_loc) on the host, and one copy
    # of them to the device that waits on nothing
    host = torch.stack([chunk_group_sizes(counts, c, ci * rows, rows)
                        for ci in range(n_chunks)])[..., :e_loc]
    dev = host.to(disp.x.device, non_blocking=True)
    host = host.tolist()
    ys = []
    for ci in range(n_chunks):
        lo = ci * rows
        yseg = []
        for j in range(n_src):
            sizes = dev[ci, :, j]
            hs = [row[j] for row in host[ci]]
            xc = disp.x[:, j, lo:lo + rows]
            hh = _gg.grouped_gemm(xc, w_gate_up, sizes,
                                  out_dtype=torch.float32, host_sizes=hs)
            act = silu_mul(hh).to(disp.x.dtype)
            yseg.append(_gg.grouped_gemm(act, w_down, sizes,
                                         out_dtype=torch.float32,
                                         host_sizes=hs))
        ys.append(torch.stack(yseg, 1))  # (n, n_src, rows, H)
    y = torch.cat(ys, 2) if len(ys) > 1 else ys[0]
    return torch.where(disp.valid[..., None], y, 0.0)


def ep_combine_chunked(y: torch.Tensor, disp: EPChunkDispatch, m: int,
                       top_k: int, out_dtype, n_chunks: int = 1,
                       transport: str = "chunked",
                       straggler: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """The combine over the chunked transport: each capacity chunk of
    the results travels back on its own delivery flag."""
    back, _ = _a2a_select(transport, n_chunks, straggler)(y.float(),
                                                          disp.counts)
    return _combine_scatter(back, disp, m, top_k, out_dtype)


def ep_moe_pipeline(x: torch.Tensor, topk_ids: torch.Tensor,
                    topk_weights: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, capacity: int, n_chunks: int = 1,
                    payload_dtype=None, transport: str = "chunked",
                    straggler: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked dispatch -> per-chunk grouped FFN -> chunked combine.
    Returns ((n, M, H) f32, drops (n,)): the routing and drops of the
    sequential composition."""
    n = x.shape[0]
    disp = ep_dispatch_chunked(
        x, topk_ids, topk_weights, w_gate_up.shape[1] * n, capacity,
        n_chunks=n_chunks, payload_dtype=payload_dtype, transport=transport,
        straggler=straggler)
    y = ep_expert_ffn_chunked(disp, w_gate_up, w_down, n_chunks=n_chunks)
    out = ep_combine_chunked(y, disp, x.shape[1], topk_ids.shape[-1],
                             torch.float32, n_chunks=n_chunks,
                             transport=transport, straggler=straggler)
    return out, disp.drops

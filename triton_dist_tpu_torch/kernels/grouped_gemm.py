"""Grouped GEMM over expert segments — port of triton_dist_tpu.kernels.
grouped_gemm (`grouped_gemm`, `grouped_gemm_ref`).

The JAX function is XLA's `lax.ragged_dot` with an f32 accumulator,
rounded to `out_dtype`: rows of sorted segment e multiply expert e's
weight, rows past the last segment are zero. It is not a Pallas kernel,
so the port computes it with torch ops, and with the rank dim of the
virtual world kept: x (T, K) shared by every rank or (n, T, K) one per
rank, w (n, E, K, N), group sizes (E,) shared (the TP ranks route
alike) or (n, E) one row a rank (EP: every rank receives other tokens),
result (n, T, N). Unstacked (T, K) x (E, K, N) gives (T, N).

Routes, by device and dtype (stated, not a silent fallback):

  CUDA, bfloat16 in and out — one `torch._grouped_mm` call a product,
      the rank dim folded into the groups: n*E groups over the n-times
      repeated rows,
      the offsets built on the device (no host sync; a `.tolist()` of
      the group sizes would cost a round trip per layer). The weight
      stack is read in place as (n*E, K, N), row-major: the layout the
      JAX package keeps, which `_grouped_mm` takes without a copy. Rows
      past the last group (sum(group_sizes) < T) fall, once the ranks are
      folded, into the next rank's first group, or past the last offset:
      they are zeroed after the call.
  CUDA, an f32 `out_dtype` (the MoE down product) — `_expert_rows`:
      the experts in consecutive chunks, each expert's rows in a block
      padded to its chunk's largest group, one batched product with an
      f32 output a chunk (a chunk and rank unless the chunk holds every
      expert), after one host sync for the group sizes, or none when the
      caller holds them on the host (`host_sizes`: the EP FFN reads its
      sizes once for both products, or once for every chunk). An expert
      is padded to its largest group over the ranks. A chunk's blocks
      stay under _SCRATCH_BYTES (an expert whose rows alone exceed it is
      a chunk of its own), so a skewed routing costs more products, not
      memory beyond the output and that budget.
      `_grouped_mm` refuses an f32 `out_dtype` for bf16 operands,
      and its bf16 result widened rounds once more than `ragged_dot`'s
      f32 output: on the card that fell outside the f32 epsilon band
      (cosine drift 1.3-1.4e-6 against 1e-6, PERF.md's parity table).
      The loop over every row for every expert (`grouped_gemm_plain`)
      took the Qwen3-30B-A3B 4 x 128 prefill from 0.2 to 2.8 s.
  anything else (the CPU, float32 on the card) — `grouped_gemm_plain`,
      a loop over the experts: every row times expert e's weight in f32,
      kept where the row lies in segment e (the JAX `grouped_gemm_ref`),
      E full products with no host sync.
"""

from __future__ import annotations

import torch

# bytes of one chunk of _expert_rows: its gathered rows and f32 products
# for every rank
_SCRATCH_BYTES = 512 << 20


def _stacked(x: torch.Tensor, w: torch.Tensor):
    """(x, w) with the rank dim: w (n, E, K, N), x (n, T, K)."""
    if w.dim() == 3:
        return x[None], w[None]
    if x.dim() == 2:
        x = x.expand(w.shape[0], *x.shape)
    return x, w


def grouped_gemm_plain(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                       group_sizes: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """The loop over experts: f32 products, one rounding to out_dtype."""
    out_dtype = out_dtype or x_sorted.dtype
    x, w = _stacked(x_sorted, w_stack)
    t = x.shape[-2]
    sizes = group_sizes.to(x.device, torch.long)[..., None, :]
    ends = torch.cumsum(sizes, -1)
    rows = torch.arange(t, device=x.device)[:, None]
    member = (rows >= ends - sizes) & (rows < ends)  # ([n,] T, E)
    xf = x.float()
    acc = torch.zeros((*x.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for e in range(w.shape[1]):
        acc = torch.where(member[..., e:e + 1], xf @ w[:, e].float(), acc)
    acc = acc.to(out_dtype)
    return acc if w_stack.dim() == 4 else acc[0]


def _expert_chunks(sizes, row_bytes: int):
    """Consecutive expert ranges (lo, hi, cap), cap the range's largest
    group, greedily as long as (hi - lo) * cap * row_bytes fits in
    _SCRATCH_BYTES (a range holds one expert at least); ranges with no
    rows are left out."""
    chunks, lo, cap = [], 0, 0
    for e, size in enumerate(sizes):
        wide = max(cap, size)
        if e > lo and (e + 1 - lo) * wide * row_bytes > _SCRATCH_BYTES:
            chunks.append((lo, e, cap))
            lo, wide = e, size
        cap = wide
    chunks.append((lo, len(sizes), cap))
    return [c for c in chunks if c[2] > 0]


def _expert_rows(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                 group_sizes: torch.Tensor, out_dtype,
                 host_sizes=None) -> torch.Tensor:
    """Each expert's rows times its weight with an f32 output: for each
    chunk of _expert_chunks (an expert padded to its largest group over
    the ranks), the sorted rows gathered into (E_chunk, cap, K) blocks a
    rank, `torch.bmm(out_dtype=f32)` (f32 accumulation, no rounding to
    bf16) over all ranks at once when the chunk holds every expert (the
    weight stack is then an (n*E, K, N) view), else a rank at a time,
    and the rows scattered back; rows past the last group are 0. One
    host sync (the group sizes), none with host_sizes (the same sizes as
    nested lists)."""
    x, w = _stacked(x_sorted, w_stack)
    n, e, k, nn = w.shape
    t = x.shape[-2]
    sizes = group_sizes.to(x.device, torch.long).expand(n, e)
    host = group_sizes.tolist() if host_sizes is None else host_sizes
    widest = ([max(col) for col in zip(*host)] if group_sizes.dim() == 2
              else host)
    starts = torch.cumsum(sizes, -1) - sizes
    out = torch.zeros((n, t + 1, nn), dtype=torch.float32, device=x.device)
    ranks = torch.arange(n, device=x.device)
    row_bytes = n * (k * x.element_size() + nn * 4)
    for lo, hi, cap in _expert_chunks(widest, row_bytes):
        j = torch.arange(cap, device=x.device)
        rows = starts[:, lo:hi, None] + j  # (n, hi - lo, cap)
        live = j < sizes[:, lo:hi, None]
        xe = x[ranks[:, None, None], torch.where(live, rows, 0)]
        # a padding row lands on the spare row t, sliced off below
        dst = torch.where(live, rows, t).reshape(n, -1)
        if hi - lo == e:
            ye = torch.bmm(xe.reshape(n * e, cap, k), w.reshape(n * e, k, nn),
                           out_dtype=torch.float32)
            out[ranks[:, None], dst] = ye.reshape(n, e * cap, nn)
            continue
        for r in range(n):
            out[r, dst[r]] = torch.bmm(xe[r], w[r, lo:hi],
                                       out_dtype=torch.float32).reshape(-1, nn)
    out = out[:, :t].to(out_dtype)
    return out if w_stack.dim() == 4 else out[0]


def grouped_gemm(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                 group_sizes: torch.Tensor, out_dtype=None,
                 host_sizes=None) -> torch.Tensor:
    """y[r, i] = x[r, i] @ w_stack[r, expert_of_segment(r, i)]; the route
    per device and dtype is the module docstring's. host_sizes: the
    group sizes as nested lists, when the caller holds them on the host
    (the f32-out card route then needs no sync)."""
    out_dtype = out_dtype or x_sorted.dtype
    if not (x_sorted.device.type == "cuda"
            and x_sorted.dtype == w_stack.dtype == torch.bfloat16):
        return grouped_gemm_plain(x_sorted, w_stack, group_sizes, out_dtype)
    if out_dtype != torch.bfloat16:
        return _expert_rows(x_sorted, w_stack, group_sizes, out_dtype,
                            host_sizes)
    x, w = _stacked(x_sorted, w_stack)
    n, e, k, nn = w.shape
    t = x.shape[1]
    ends = torch.cumsum(group_sizes, -1, dtype=torch.int32).expand(n, e)
    base = torch.arange(n, device=x.device, dtype=torch.int32)[:, None] * t
    offs = (base + ends).reshape(-1)
    y = torch._grouped_mm(x.reshape(n * t, k), w.reshape(n * e, k, nn),
                          offs=offs).reshape(n, t, nn)
    # the tail zeroed by a select (the last rank's rows hold whatever the
    # allocation held)
    keep = torch.arange(t, device=x.device)[None, :] < ends[:, -1:]
    y = torch.where(keep[..., None], y,
                    torch.zeros(1, dtype=out_dtype, device=x.device))
    return y if w_stack.dim() == 4 else y[0]

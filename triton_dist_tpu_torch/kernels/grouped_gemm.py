"""Grouped GEMM over expert segments — port of triton_dist_tpu.kernels.
grouped_gemm (`grouped_gemm`, `grouped_gemm_ref`).

The JAX function is XLA's `lax.ragged_dot` with an f32 accumulator,
rounded to `out_dtype`: rows of sorted segment e multiply expert e's
weight, rows past the last segment are zero. It is not a Pallas kernel,
so the port computes it with torch ops, and with the rank dim of the
virtual world kept: x (T, K) shared by every rank or (n, T, K) one per
rank, w (n, E, K, N), group sizes (E,) shared (the ranks route alike),
result (n, T, N). Unstacked (T, K) x (E, K, N) gives (T, N).

Routes, by device and dtype (stated, not a silent fallback):

  CUDA, bfloat16 — one `torch._grouped_mm` call a product, the rank dim
      folded into the groups: n*E groups over the n-times repeated rows,
      the offsets built on the device (no host sync; a `.tolist()` of
      the group sizes would cost a round trip per layer). The weight
      stack is read in place as (n*E, K, N), row-major: the layout the
      JAX package keeps, which `_grouped_mm` takes without a copy. Rows
      past the last group (sum(group_sizes) < T) fall, once the ranks are
      folded, into the next rank's first group, or past the last offset:
      they are zeroed after the call. `_grouped_mm` refuses an f32
      `out_dtype` for bf16 operands, so an f32 `out_dtype` (the MoE down
      product) is its bf16 result widened: one bf16 rounding a row more
      than `ragged_dot`'s f32 output, a deviation PERF.md's parity table
      lists.
  anything else (the CPU, float32 on the card) — `grouped_gemm_plain`,
      a loop over the experts: every row times expert e's weight in f32,
      kept where the row lies in segment e (the JAX `grouped_gemm_ref`),
      E full products with no host sync.
"""

from __future__ import annotations

import torch


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
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    rows = torch.arange(t, device=x.device)[:, None]
    member = (rows >= starts[None, :]) & (rows < ends[None, :])  # (T, E)
    xf = x.float()
    acc = torch.zeros((*x.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for e in range(w.shape[1]):
        acc = torch.where(member[:, e:e + 1], xf @ w[:, e].float(), acc)
    acc = acc.to(out_dtype)
    return acc if w_stack.dim() == 4 else acc[0]


def grouped_gemm(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                 group_sizes: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y[r, i] = x[r, i] @ w_stack[r, expert_of_segment(i)]; the route
    per device and dtype is the module docstring's."""
    out_dtype = out_dtype or x_sorted.dtype
    if not (x_sorted.device.type == "cuda"
            and x_sorted.dtype == w_stack.dtype == torch.bfloat16):
        return grouped_gemm_plain(x_sorted, w_stack, group_sizes, out_dtype)
    x, w = _stacked(x_sorted, w_stack)
    n, e, k, nn = w.shape
    t = x.shape[1]
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    base = torch.arange(n, device=x.device, dtype=torch.int32)[:, None] * t
    offs = (base + ends[None, :]).reshape(-1)
    y = torch._grouped_mm(x.reshape(n * t, k), w.reshape(n * e, k, nn),
                          offs=offs).reshape(n, t, nn)
    # the tail zeroed by a select (the last rank's rows hold whatever the
    # allocation held) and widened to out_dtype in the same pass: a
    # 1-element zero of out_dtype promotes the result to it
    keep = torch.arange(t, device=x.device)[:, None] < ends[-1]
    y = torch.where(keep, y, torch.zeros(1, dtype=out_dtype, device=x.device))
    return y if w_stack.dim() == 4 else y[0]

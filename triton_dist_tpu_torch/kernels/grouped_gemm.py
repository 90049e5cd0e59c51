"""Grouped GEMM over expert segments — port of triton_dist_tpu.kernels.
grouped_gemm (`grouped_gemm`, `grouped_gemm_ref`).

The JAX function is XLA's `lax.ragged_dot` with an f32 accumulator,
rounded to `out_dtype`: rows of sorted segment e multiply expert e's
weight, rows past the last segment are zero. It is not a Pallas kernel,
so the port computes it with torch ops, but for its f32-out card route,
a hand kernel (no library call serves it), and with the rank dim of the
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
  CUDA, bfloat16 in, an f32 `out_dtype` (the TP-MoE down product, both
      products of the EP FFN) —
      `grouped_gemm_f32`, the hand-written kernel of csrc/grouped_gemm.cu
      (counted "grouped_gemm_f32"): mma.sync over row tiles of one group
      each, the tile list derived on the card from the group sizes, f32
      accumulation and output, rows past the last group zeroed; no host
      read, so a CUDA graph captures it. `torch._grouped_mm` has no f32
      output for bf16 operands, and its bf16 result widened fell outside
      the f32 epsilon band (cosine drift 1.3-1.4e-6 against 1e-6,
      PERF.md's parity table), so no library call serves.
  anything else (the CPU, float32 on the card) — `grouped_gemm_plain`,
      a loop over the experts: every row times expert e's weight in f32,
      kept where the row lies in segment e (the JAX `grouped_gemm_ref`),
      E full products with no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build


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


# the f32-out kernel's row tile and N tile (csrc/grouped_gemm.cu BM, BN)
_BM, _BN = 64, 128
_SIGNATURES = {
    "grouped_f32_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "grouped_f32_max_experts": (ctypes.c_int, []),
    "grouped_f32_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _plan(t: int, e: int, nn: int, n: int, sms: int = _build.SMS) -> int:
    """The kernel's walkers a (rank, N tile): enough blocks for about 8 a
    SM over the grid, and no more than a rank's row tiles can be (every
    group's tiles, ceil(T / 64) + E at most)."""
    per = -(-nn // _BN) * n
    return max(1, min(-(-t // _BM) + e, -(-8 * sms // per)))


def grouped_gemm_f32_plain(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the loop over experts in f32."""
    return grouped_gemm_plain(x_sorted, w_stack, group_sizes, torch.float32)


@_build.counted("grouped_gemm_f32")
def grouped_gemm_f32(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """y[r, i] = x[r, i] @ w_stack[r, expert_of_segment(r, i)] in f32,
    the group sizes (E,) or (n, E) read on the device: the CUDA kernel on
    a CUDA tensor (bf16 operands, or a raise), the plain loop on a CPU
    tensor. Shapes as `grouped_gemm`."""
    if x_sorted.device.type == "cpu":
        return grouped_gemm_f32_plain(x_sorted, w_stack, group_sizes)
    return _launch_f32(x_sorted, w_stack, group_sizes)


def _launch_f32(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    x, w = _stacked(x_sorted, w_stack)
    n, e, k, nn = w.shape
    t = x.shape[-2]
    dev = x.device
    if not (x.dtype == w.dtype == torch.bfloat16):
        raise ValueError(f"grouped_gemm_f32 takes bf16 operands, got "
                         f"{x.dtype} and {w.dtype}")
    if w.device != dev or group_sizes.device != dev:
        raise ValueError("grouped_gemm_f32: x, w and the group sizes on one "
                         "device")
    if tuple(x.shape) != (n, t, k) or k % 8 or nn % 8:
        raise ValueError(f"grouped_gemm_f32: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}; K and N multiples of 8")
    if tuple(group_sizes.shape) not in ((e,), (n, e)):
        raise ValueError(f"group sizes {tuple(group_sizes.shape)}: ({e},) "
                         f"or ({n}, {e})")
    if not w.is_contiguous():
        raise ValueError("grouped_gemm_f32: w must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != k:
        x = x.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    lib = _build.load("grouped_gemm", _SIGNATURES)
    if e > lib.grouped_f32_max_experts():
        raise ValueError(f"grouped_gemm_f32: {e} experts, at most "
                         f"{lib.grouped_f32_max_experts()}")
    y = torch.empty((n, t, nn), dtype=torch.float32, device=dev)
    walkers = _plan(t, e, nn, n, _build.card_sms(dev))
    with _build.on_device(dev):
        err = lib.grouped_f32_launch(
            x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr(),
            sizes.data_ptr(), e if sizes.dim() == 2 else 0, n, t, k, nn, e,
            walkers, _build.raw_stream(dev))
    _build.check("grouped_gemm_f32", err, lib.grouped_f32_error_string)
    _build.count_launch("grouped_gemm_f32")
    return y if w_stack.dim() == 4 else y[0]


def grouped_gemm(x_sorted: torch.Tensor, w_stack: torch.Tensor,
                 group_sizes: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y[r, i] = x[r, i] @ w_stack[r, expert_of_segment(r, i)]; the route
    per device and dtype is the module docstring's."""
    out_dtype = out_dtype or x_sorted.dtype
    if not (x_sorted.device.type == "cuda"
            and x_sorted.dtype == w_stack.dtype == torch.bfloat16):
        return grouped_gemm_plain(x_sorted, w_stack, group_sizes, out_dtype)
    if out_dtype != torch.bfloat16:
        y = grouped_gemm_f32(x_sorted, w_stack, group_sizes)
        return y if out_dtype == torch.float32 else y.to(out_dtype)
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

"""GEMM + ReduceScatter — port of triton_dist_tpu.kernels.
gemm_reduce_scatter (`gemm_rs`: the Pallas kernels `_gemm_rs_kernel`,
`_gemm_rs_kernel_streamed` and their ring `_rs_ring`; at world 1 with
`force_kernel`, `_local_mm_kernel`).

Rank-stacked: a (n, M, K_loc), b (n, K_loc, N) hold every rank's operands
of the virtual world (runtime/symm_mem.py); the result (n, M/n, N) holds
rank c's reduced chunk, sum over r of (a[r] @ b[r])[c*M/n : (c+1)*M/n].
With a_order="arrival", a[r]'s row blocks come in ag_gemm's ring-arrival
order (block s = chunk (r - s) mod n, `arrival_to_rank_order`), as the
`dist` MLP's gate|up product leaves them; the kernel reads each chunk
from its arrival block, the JAX `_src_slot` remap. Two implementations
of one contract:

  gemm_rs — the hand-written CUDA kernel (csrc/gemm_reduce_scatter.cu),
      which computes the products inside the kernel. Launches on a CUDA
      tensor, or raises; on a CPU tensor it computes the plain version.
  gemm_rs_plain — the same function in plain torch: each rank's partial
      in f32, rounded to the output dtype (the kernel's heap slots hold
      rounded partials, as the JAX ring's do), folded over ranks 0..n-1
      in f32, rounded once.

The JAX ring folds in ring order, so in f32 the port agrees with it to
rounding (1e-5 at the tests' sizes), not bitwise. At world 1 without
`force_kernel` the product is a plain local matmul, as the JAX function
leaves it to XLA; with `force_kernel` the kernel runs with n = 1. The
TPU's VMEM-budget and interpret-mode fallbacks do not carry over: on the
card the kernel always runs.

`out_dtype` (default a.dtype) is also the native wire's accumulation
dtype, as in JAX: the partials are rounded to it, folded in f32 and
rounded to it once (float32 out of bf16 inputs: the f32-accumulation
option). On the card the kernel takes bf16 in with bf16 or f32 out, and
f32 in with f32 out.

A quantized `wire_format` (JAX `_rs_ring` with a wire format): each
rank's partials are f32, and the cross-rank fold is the ring order with
a requantization at every hop (`reduce_scatter.ring_reduce_scatter_
wire`), not the native all-slots rank-order fold, which computes a
different, more accurate function; the result is rounded once to
out_dtype. `gemm_rs_wire` launches the partial GEMM (this kernel in its
partials mode, counted as `gemm_rs_wire`), then the wire ring kernel
(`ring_rs_wire`): two launches, JAX's own fallback structure. At n = 1
without `force_kernel` the call is the plain product.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather_gemm import arrival_to_rank_order
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "gemm_rs_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_void_p]),
    "gemm_rs_flag_count": (ctypes.c_int, [ctypes.c_int] * 3),
    "gemm_rs_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(a, b, a_order):
    if a_order not in ("rank", "arrival"):
        raise ValueError(f"a_order={a_order!r}: 'rank' or 'arrival'")
    if a.dim() != 3 or b.dim() != 3 or b.shape[:2] != (a.shape[0],
                                                        a.shape[2]):
        raise ValueError(f"a (n, M, K) and b (n, K, N) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] % a.shape[0]:
        raise ValueError(f"M={a.shape[1]} not divisible by world size "
                         f"{a.shape[0]}")


def local_product(a: torch.Tensor, b: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """Each rank's a @ b, f32 accumulation rounded once to out_dtype
    (default a.dtype; the JAX jnp.dot(preferred_element_type=f32).astype
    outside a kernel)."""
    if out_dtype is None or out_dtype == a.dtype:
        return torch.matmul(a, b)
    from triton_dist_tpu_torch.layers.linear import dot_f32

    return dot_f32(a, b).to(out_dtype)


def reduce_scatter_plain(partial: torch.Tensor) -> torch.Tensor:
    """Rank-stacked partial sums (n, n*m, ...) -> (n, m, ...): rank c
    keeps the sum over ranks r of partial[r]'s row block c, folded in f32
    in rank order and rounded once (the JAX `lax.psum_scatter` of the
    `xla` mode, and gemm_rs's fold of its slots)."""
    n = partial.shape[0]
    part = partial.reshape(n, n, partial.shape[1] // n, *partial.shape[2:])
    acc = part[0].float()
    for r in range(1, n):
        acc = acc + part[r].float()
    return acc.to(partial.dtype)


def _partials(a: torch.Tensor, b: torch.Tensor,
              a_order: str) -> torch.Tensor:
    """Every rank's f32 partial (n, M, N), chunks in rank order."""
    if a_order == "arrival":
        a = arrival_to_rank_order(a)
    return torch.matmul(a.float(), b.float())


def gemm_rs_plain(a: torch.Tensor, b: torch.Tensor,
                  a_order: str = "rank", out_dtype=None) -> torch.Tensor:
    """Partials rounded to out_dtype (default a.dtype), folded over
    ranks in order in f32, one rounding. An arrival-order a is first put
    back in rank order."""
    return reduce_scatter_plain(
        _partials(a, b, a_order).to(out_dtype or a.dtype))


def gemm_rs_wire_plain(a: torch.Tensor, b: torch.Tensor, wire_format,
                       a_order: str = "rank",
                       out_dtype=None) -> torch.Tensor:
    """The f32 partials through the quantized ring's fold
    (reduce_scatter.ring_reduce_scatter_wire_plain), rounded once to
    out_dtype (default a.dtype)."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        ring_reduce_scatter_wire_plain,
    )

    return ring_reduce_scatter_wire_plain(
        _partials(a, b, a_order), wire_format, out_dtype or a.dtype)


@_build.counted("gemm_rs")
def gemm_rs(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
            force_kernel: bool = False, a_order: str = "rank",
            wire_format=None) -> torch.Tensor:
    """a (n, M, K), b (n, K, N) rank-stacked -> (n, M/n, N) in out_dtype
    (default a.dtype): the CUDA kernel on CUDA tensors (launched or
    raising, never replaced), the plain version on CPU tensors; at n = 1
    a local product unless force_kernel. A quantized wire_format takes
    gemm_rs_wire."""
    _check(a, b, a_order)
    out_dtype = out_dtype or a.dtype
    if a.shape[0] == 1 and not force_kernel:
        return local_product(a, b, out_dtype)
    if not wire.is_native(wire_format):
        return gemm_rs_wire(a, b, wire_format, out_dtype, a_order)
    if a.device.type == "cpu":
        return gemm_rs_plain(a, b, a_order, out_dtype)
    return _launch(a, b, a_order == "arrival", out_dtype)


@_build.counted("gemm_rs_wire")
def gemm_rs_wire(a: torch.Tensor, b: torch.Tensor, wire_format,
                 out_dtype=None, a_order: str = "rank") -> torch.Tensor:
    """The quantized-wire gemm_rs at every n: the partial-GEMM launch
    (counted here) and the wire ring (counted as ring_rs_wire) on CUDA
    tensors, gemm_rs_wire_plain on CPU tensors."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        ring_reduce_scatter_wire,
    )

    _check(a, b, a_order)
    fmt = wire.resolve(wire_format)
    if wire.is_native(fmt):
        raise ValueError("gemm_rs_wire takes a quantized wire format")
    wire.wire_cols(b.shape[-1], fmt)  # a block that does not divide N
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_rs_wire_plain(a, b, fmt, a_order, out_dtype)
    partial = _launch(a, b, a_order == "arrival", torch.float32,
                      partials=True)
    return ring_reduce_scatter_wire(partial, fmt, out_dtype)


def _launch(a: torch.Tensor, b: torch.Tensor, arrival: bool = False,
            out_dtype=None, partials: bool = False) -> torch.Tensor:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the gemm_rs kernel needs CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    out_dtype = out_dtype or a.dtype
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: the kernel takes "
                         "float32 or bfloat16, both alike")
    if out_dtype not in _DTYPE_CODE or (a.dtype == torch.float32
                                        and out_dtype != torch.float32):
        raise ValueError(f"out_dtype {out_dtype} of {a.dtype} inputs: the "
                         "kernel writes bf16 or f32 out of bf16, f32 out "
                         "of f32")
    n, M, K = a.shape
    N = b.shape[2]
    per = 16 // a.element_size()
    if K % per or N % per:
        raise ValueError(f"K={K} and N={N} must be multiples of {per}: the "
                         "kernel moves 16-byte rows")
    for name, x in (("a", a), ("b", b)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    world = VirtualWorld.of(a)
    m = M // n
    name = "gemm_rs_wire" if partials else "gemm_rs"
    if partials:  # every rank's f32 partial, no fold
        out = heap = torch.empty((n, M, N), dtype=torch.float32,
                                 device=a.device)
    else:
        out = torch.empty((n, m, N), dtype=out_dtype, device=a.device)
        heap = world.heap((n, m, N), out_dtype)  # [owner c][producer r]
    if out.numel() == 0:
        return out
    lib = _build.load("gemm_reduce_scatter", _SIGNATURES)
    code = _DTYPE_CODE[a.dtype]
    flags = world.flags(0 if partials else
                        lib.gemm_rs_flag_count(m, N, code))
    grid = _build.GridInfo()
    with torch.cuda.device(a.device):
        err = lib.gemm_rs_launch(
            a.data_ptr(), b.data_ptr(), heap.data_ptr(), out.data_ptr(),
            flags.data_ptr(), n, M, K, N, code, _DTYPE_CODE[out_dtype],
            int(partials), int(arrival), grid.ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(name, err, lib.gemm_rs_error_string, grid)
    _build.count_launch(name)
    return out

"""Ring ReduceScatter — port of triton_dist_tpu.kernels.reduce_scatter
(`ReduceScatterMethod`, `ring_reduce_scatter`: the Pallas kernel
`_ring_rs_kernel`, and `reduce_scatter` with its method routing), native
wire.

Rank-stacked: x (n, n*m, ...) holds every rank's contribution over the
virtual world (runtime/symm_mem.py); the result (n, m, ...) holds rank
c's chunk c of the sum over ranks. Two implementations of one contract:

  ring_reduce_scatter — the hand-written CUDA kernel
      (csrc/reduce_scatter.cu): the credit-flow ring with two
      accumulator slots a rank. Launches on a CUDA tensor, or raises; on
      a CPU tensor it computes the plain version.
  ring_reduce_scatter_plain — the same fold in plain torch.

The dtype contract is the JAX kernel's: accumulation in `accum_dtype`
(default: the input dtype), chunk c folded around the ring as
((x[c+1] + x[c+2]) + ...) + x[c] over the ranks, each add rounded to
the accumulation dtype, the result converted back to the input dtype.
Both implementations follow that order, so they agree bitwise with each
other and with the JAX kernel, in f32 and in bf16 (an add of two bf16
values in f32 is exact, so its one rounding is the correctly rounded
bf16 add in all three). This is not the fold of `gemm_reduce_scatter.
reduce_scatter_plain` (f32, rank order, one rounding), which stands for
XLA's `psum_scatter` in the `XLA` method and the `xla` modes.

At n = 1 without `force_kernel` the input comes back as it is, as the
JAX function returns it; with `force_kernel` the kernel runs with no
ring step. `reduce_scatter(method=Auto)` takes the ring when a chunk is
at most 4 MiB (the JAX rule, reduce_scatter.py:513-520) and the `XLA`
method above it; `method=None` takes the ring, as the JAX function does
for anything but `XLA`. `reduce_scatter_op(arr)` is the host entry
(the world is arr's leading dim). Quantized wire formats
(`_ring_rs_wire_kernel`) belong to the wire/ slice and raise.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    reduce_scatter_plain,
)
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class ReduceScatterMethod(enum.Enum):
    Auto = "auto"
    Ring1D = "ring_1d"
    XLA = "xla"


# the JAX Auto rule: the ring for chunks up to this many bytes
RING_CHUNK_LIMIT = 4 * (1 << 20)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# elements a tile: each tile runs its own ring (one block a rank)
_TILE = 8192
_SIGNATURES = {
    "rs_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "rs_tile_count": (ctypes.c_int, [ctypes.c_longlong, ctypes.c_int]),
    "rs_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(x: torch.Tensor, wire_format) -> None:
    if wire_format not in (None, "native"):
        raise NotImplementedError(
            f"wire_format={wire_format!r}: quantized wire images "
            "(_ring_rs_wire_kernel) come with the wire/ slice")
    if x.dim() < 2:
        raise ValueError(f"reduce_scatter needs rank-stacked (n, n*m, ...) "
                         f"contributions, got shape {tuple(x.shape)}")
    if x.shape[1] % x.shape[0]:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by "
                         f"{x.shape[0]}")


def _check_ring(x: torch.Tensor) -> None:
    """The kernel's layout, demanded on every device so a CPU run
    meets the condition a card run would."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def ring_reduce_scatter_plain(x: torch.Tensor,
                              accum_dtype=None) -> torch.Tensor:
    """The ring's fold: rank c's chunk c summed from rank c + 1 around
    to rank c, each add rounded to accum_dtype, then cast to x.dtype."""
    acc_dtype = accum_dtype or x.dtype
    n = x.shape[0]
    part = x.reshape(n, n, x.shape[1] // n, *x.shape[2:])  # [rank][chunk]
    c = torch.arange(n, device=x.device)
    acc = part[(c + 1) % n, c].to(acc_dtype)
    for j in range(2, n + 1):
        acc = acc + part[(c + j) % n, c].to(acc_dtype)
    return acc.to(x.dtype)


@_build.counted("ring_reduce_scatter")
def ring_reduce_scatter(x: torch.Tensor, accum_dtype=None,
                        force_kernel: bool = False,
                        wire_format=None) -> torch.Tensor:
    """x (n, n*m, ...) rank-stacked -> (n, m, ...): the CUDA kernel on a
    CUDA tensor (launched or raising, never replaced), the plain version
    on a CPU tensor; at n = 1 the input unless force_kernel."""
    _check(x, wire_format)
    if x.shape[0] == 1 and not force_kernel:
        return x
    _check_ring(x)
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x, accum_dtype)
    return _launch(x, accum_dtype or x.dtype)


def reduce_scatter(x: torch.Tensor, method=ReduceScatterMethod.Auto,
                   accum_dtype=None, wire_format=None) -> torch.Tensor:
    """x (n, n*m, ...) -> (n, m, ...) by `method`: Auto picks the ring
    for chunks of at most RING_CHUNK_LIMIT bytes, else XLA (here the
    rank-order f32 fold that stands for `lax.psum_scatter`)."""
    _check(x, wire_format)
    n = x.shape[0]
    if method == ReduceScatterMethod.Auto:
        chunk_bytes = x[0].numel() // n * x.element_size()
        method = (ReduceScatterMethod.Ring1D
                  if chunk_bytes <= RING_CHUNK_LIMIT
                  else ReduceScatterMethod.XLA)
    if method == ReduceScatterMethod.XLA:
        if accum_dtype is not None and accum_dtype != x.dtype:
            return reduce_scatter_plain(x.to(accum_dtype)).to(x.dtype)
        return reduce_scatter_plain(x)
    return ring_reduce_scatter(x, accum_dtype=accum_dtype)


def reduce_scatter_op(arr: torch.Tensor, method=ReduceScatterMethod.Auto,
                      wire_format=None) -> torch.Tensor:
    """The host entry: arr (n, n*m, ...) stacks one contribution a rank,
    the world its leading dim; rank r keeps chunk r of the sum. Returns
    (n*m, ...), the chunks in rank order (the JAX result sharded along
    its leading dim)."""
    out = reduce_scatter(arr, method=method, wire_format=wire_format)
    return out.reshape(-1, *out.shape[2:])


def _launch(x: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the reduce-scatter kernel needs a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in _DTYPE_CODE or acc_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {x.dtype} / accum {acc_dtype}: the kernel "
                         "takes float32 or bfloat16")
    world = VirtualWorld.of(x)
    n = x.shape[0]
    m = x.shape[1] // n
    out = torch.empty((n, m, *x.shape[2:]), dtype=x.dtype, device=x.device)
    chunk = out[0].numel()
    if chunk == 0:
        return out
    lib = _build.load("reduce_scatter", _SIGNATURES)
    acc = world.heap((2, chunk), acc_dtype)  # [rank][slot]
    flags = world.flags(3 * lib.rs_tile_count(chunk, _TILE))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_launch(x.data_ptr(), acc.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), n, chunk, _TILE,
                            _DTYPE_CODE[x.dtype], _DTYPE_CODE[acc_dtype],
                            grid.ptr(), stream)
    _build.check("ring_reduce_scatter", err, lib.rs_error_string, grid)
    _build.count_launch("ring_reduce_scatter")
    return out

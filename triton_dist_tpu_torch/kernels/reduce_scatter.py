"""Ring ReduceScatter — port of triton_dist_tpu.kernels.reduce_scatter
(`ReduceScatterMethod`, `ring_reduce_scatter`: the Pallas kernels
`_ring_rs_kernel` and, on a quantized wire, `_ring_rs_wire_kernel`; and
`reduce_scatter` with its method routing).

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
for anything but `XLA`. `reduce_scatter_op(arr)` is the host entry (the
world is arr's leading dim).

The quantized wire (`wire_format` "fp8", "int8" or a `wire.WireFormat`;
the JAX `_ring_rs_quantized`): the same ring, its travelling slots
holding the block-scaled wire image (wire/codec.py) instead of rows.
The send edge encodes the f32 stage; each consume edge decodes, adds
its own contribution in f32 and re-encodes, except the final arrival,
which is stored in the output dtype without a re-encode. Two
implementations:

  ring_reduce_scatter_wire — the CUDA kernel `ring_rs_wire_kernel`
      (csrc/reduce_scatter.cu), tiled by whole rows (a row's scale
      needs the amax of the whole row or block); on a CPU tensor the
      plain version.
  ring_reduce_scatter_wire_plain — the torch replay of the JAX
      `_wire_rs_xla` in the same fold order on the codec's
      encode_rows / decode_rows: bitwise `wire.simulate_ring_rs`.

The kernel encodes with the codec's arithmetic (IEEE division, round
half to even, no fused multiply-add), so the two agree bitwise. The
wire route skips the Auto rule (the XLA arm cannot requantize a hop);
an `accum_dtype` other than f32 with a quantized wire raises, as in
JAX; at n = 1 the input comes back unless `force_kernel`.
"""

from __future__ import annotations

import ctypes
import enum
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch import wire
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
# the wire kernel's rings a rank at most: a tile holds whole rows, at
# least one, m / _WIRE_TILES of them (rounded up)
_WIRE_TILES = 32
# the wire kernel stages one f32 row in shared memory
_WIRE_MAX_COLS = 48 * 1024
_SIGNATURES = {
    "rs_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "rs_tile_count": (ctypes.c_int, [ctypes.c_longlong, ctypes.c_int]),
    "rs_wire_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 12 + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p]),
    "rs_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(x: torch.Tensor) -> None:
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


def _wire_check(x: torch.Tensor, fmt: wire.WireFormat, accum_dtype) -> None:
    """The JAX quantized-wire refusals (reduce_scatter.py:331-341)."""
    if accum_dtype is not None and accum_dtype != torch.float32:
        raise ValueError(
            "quantized wire accumulates in f32 at the consume edge by "
            "construction; accum_dtype is the NATIVE wire's ring "
            f"accumulation knob — got accum_dtype={accum_dtype!r} with "
            f"wire_format={fmt}")
    if x.dim() < 3:
        raise ValueError(f"quantized wire needs >=2D per-device arrays, "
                         f"got {tuple(x.shape[1:])}")


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


def ring_reduce_scatter_wire_plain(x: torch.Tensor, wire_format,
                                   out_dtype=None) -> torch.Tensor:
    """The quantized ring's fold (the JAX `_wire_rs_xla`): rank me
    starts from its f32 contribution to chunk me - 1; at step s it
    encodes its value, the image moves one rank right, and the receiver
    decodes it and adds its own contribution to chunk me - s - 2 in f32.
    The last sum is rounded once to out_dtype (default x.dtype)."""
    fmt = wire.resolve(wire_format)
    n, rows = x.shape[:2]
    m = rows // n
    xf = x.reshape(n, n, m, -1).float()  # [rank][chunk][row][k]
    k = xf.shape[-1]
    me = torch.arange(n, device=x.device)
    val = xf[me, (me - 1) % n]
    for s in range(n - 1):
        w = wire.encode_rows(val.reshape(n * m, k), fmt)
        w = torch.roll(w.reshape(n, m, -1), 1, 0)  # from the left
        val = wire.decode_rows(w.reshape(n * m, -1), k, fmt,
                               torch.float32).reshape(n, m, k) \
            + xf[me, (me - s - 2) % n]
    return val.to(out_dtype or x.dtype).reshape(n, m, *x.shape[2:])


@_build.counted("ring_reduce_scatter")
def ring_reduce_scatter(x: torch.Tensor, accum_dtype=None,
                        force_kernel: bool = False,
                        wire_format=None) -> torch.Tensor:
    """x (n, n*m, ...) rank-stacked -> (n, m, ...): the CUDA kernel on a
    CUDA tensor (launched or raising, never replaced), the plain version
    on a CPU tensor; at n = 1 the input unless force_kernel. A quantized
    wire_format takes the wire kernel (ring_reduce_scatter_wire)."""
    _check(x)
    fmt = wire.resolve(wire_format)
    if not wire.is_native(fmt):
        _wire_check(x, fmt, accum_dtype)
        if x.shape[0] == 1 and not force_kernel:
            return x
        return ring_reduce_scatter_wire(x, fmt)
    if x.shape[0] == 1 and not force_kernel:
        return x
    _check_ring(x)
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x, accum_dtype)
    return _launch(x, accum_dtype or x.dtype)


@_build.counted("ring_rs_wire")
def ring_reduce_scatter_wire(x: torch.Tensor, wire_format, out_dtype=None,
                             straggler: Optional[Tuple[int, int]] = None
                             ) -> torch.Tensor:
    """The quantized ring: x (n, n*m, ...) float32 or bfloat16 -> (n, m,
    ...) in out_dtype (default x.dtype), the kernel on a CUDA tensor
    (launched or raising), the plain version on a CPU tensor, at every
    n (n = 1: x through f32). straggler: (rank, nanos), that rank's
    blocks stall on entry (the card only; the result is the same)."""
    fmt = wire.resolve(wire_format)
    if wire.is_native(fmt):
        raise ValueError("the wire ring takes a quantized wire format")
    _check(x)
    _wire_check(x, fmt, None)
    _check_ring(x)
    out_dtype = out_dtype or x.dtype
    k = x[0, 0].numel()
    wire.wire_cols(k, fmt)  # a block that does not divide k raises
    if x.device.type == "cpu":
        return ring_reduce_scatter_wire_plain(x, fmt, out_dtype)
    return _launch_wire(x, fmt, out_dtype, straggler)


def reduce_scatter(x: torch.Tensor, method=ReduceScatterMethod.Auto,
                   accum_dtype=None, wire_format=None) -> torch.Tensor:
    """x (n, n*m, ...) -> (n, m, ...) by `method`: Auto picks the ring
    for chunks of at most RING_CHUNK_LIMIT bytes, else XLA (here the
    rank-order f32 fold that stands for `lax.psum_scatter`). A
    quantized wire_format takes the wire ring whatever the method."""
    _check(x)
    if not wire.is_native(wire_format):
        return ring_reduce_scatter(x, accum_dtype=accum_dtype,
                                   wire_format=wire_format)
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


def _launch_wire(x: torch.Tensor, fmt: wire.WireFormat, out_dtype,
                 straggler) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the wire reduce-scatter kernel needs a CUDA "
                         f"tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {x.dtype} -> {out_dtype}: the kernel "
                         "takes float32 or bfloat16")
    world = VirtualWorld.of(x)
    n = x.shape[0]
    m = x.shape[1] // n
    k = x[0, 0].numel()
    if k > _WIRE_MAX_COLS:
        raise ValueError(f"rows of {k} elements: the wire kernel stages "
                         f"a row of at most {_WIRE_MAX_COLS} in shared "
                         "memory")
    rank, nanos = straggler if straggler is not None else (-1, 0)
    if straggler is not None and not (0 <= rank < n and nanos >= 0):
        raise ValueError(f"straggler {straggler}: (rank in [0, {n}), "
                         "nanos >= 0)")
    out = torch.empty((n, m, *x.shape[2:]), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    kw = wire.wire_cols(k, fmt)
    nb = wire.n_blocks(k, fmt)
    rows = max(1, -(-m // _WIRE_TILES))  # whole rows a ring
    tiles = -(-m // rows)
    lib = _build.load("reduce_scatter", _SIGNATURES)
    slots = world.heap((2, m, kw), torch.int8)  # [rank][slot] wire images
    flags = world.flags(3 * tiles)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.rs_wire_launch(
            x.data_ptr(), slots.data_ptr(), out.data_ptr(),
            flags.data_ptr(), n, m, k, int(fmt.kind == "fp8"), k // nb,
            nb, int(fmt.checksum), kw, rows, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], rank, nanos, grid.ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check("ring_rs_wire", err, lib.rs_error_string, grid)
    _build.count_launch("ring_rs_wire")
    return out

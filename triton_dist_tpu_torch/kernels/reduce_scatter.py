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

On the card both kernels take their slots and flag pools from `_POOLS`,
a cache of at most 8 entries keyed by (kernel, device, stream, n, slot
size, dtype, tiles): made once (the flags zeroed once), then reused,
since every slot is written before it is read in a call and each rank
leaves its flags at zero after its last wait (csrc/reduce_scatter.cu).
A call allocates only its output. `_ring_plan` and `_wire_plan` cut a
chunk into the rings that run side by side; `_launch(x, acc_dtype,
tile=, _straggler=(rank, nanos))` is the native launcher with a forced
tile and a delayed rank, for the sweep and the tests.
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
# The native ring's tiles (csrc/reduce_scatter.cu): 256 threads x 8
# elements x U, U = 1, 2, 4; each tile runs its own ring (one block a
# rank). _TILE is the default (the sweep of chip_smoke.py phase 5b); a
# thread's share of the accumulation slot stays within _THREAD_SHARE
# bytes (registers), and the kernel keeps _RING_PER_SM blocks an SM
# resident at that share (its __launch_bounds__).
_TILES = (2048, 4096, 8192)
_TILE = 2048
_THREAD_SHARE = 64
_RING_PER_SM = 4
# The wire kernel: a row in registers on a group of 1, 2, 4 or 8 warps,
# each thread holding at most _WIRE_UNITS units of 16 elements (a tile is
# one row a group); other rows are staged in shared memory, a block a
# row, at most _WIRE_MAX_COLS elements. _WIRE_PER_SM blocks an SM stay
# resident in the register form (its __launch_bounds__); the staged form
# plans for one.
_WIRE_UNIT = 16
_WIRE_UNITS = 2
_WIRE_PER_SM = 2
_WIRE_MAX_COLS = 48 * 1024
_SIGNATURES = {
    "rs_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "rs_wire_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 13 + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p]),
    "rs_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _ring_plan(chunk: int, itemsize: int, n: int, sms: int = _build.SMS,
               tile: Optional[int] = None) -> Tuple[int, int]:
    """(tile, tiles) of the native ring for a chunk of `chunk` elements
    whose accumulation slot has `itemsize`-byte elements, at world n:
    _TILE, doubled while the tiles of all n ranks exceed what stays
    resident (_RING_PER_SM blocks an SM) and a thread's share of the slot
    stays within _THREAD_SHARE bytes. Every tile is a whole number of
    16-byte words, so tiles start aligned wherever the chunk does. `tile`
    forces one of _TILES (the sweep)."""
    top = max(t for t in _TILES if t // _TILES[0] * 8 * itemsize
              <= _THREAD_SHARE)
    if tile is None:
        cap = max(1, _RING_PER_SM * sms // n)
        tile = _TILE
        while -(-chunk // tile) > cap and tile < top:
            tile *= 2
    elif tile not in _TILES or tile > top:
        raise ValueError(f"tile {tile}: one of {_TILES}, at most {top} for "
                         f"{itemsize}-byte accumulation")
    return tile, -(-chunk // tile)


def _wire_plan(m: int, k: int, blk: int, n: int,
               sms: int = _build.SMS) -> Tuple[int, int, int]:
    """(warps a row, rows a tile, tiles) of the wire ring for chunks of m
    rows of k elements, scale blocks of blk, at world n. In registers
    (k and blk multiples of 16, k <= 16 x _WIRE_UNITS x 256): the fewest
    warps that hold a row, widened while the tiles of all n ranks (one
    row a group, 8 / warps a tile) stay resident; else staged (warps 0),
    whole rows a tile, as many tiles as one block an SM keeps resident."""
    if (k % _WIRE_UNIT == 0 and blk % _WIRE_UNIT == 0
            and k <= _WIRE_UNIT * _WIRE_UNITS * 32 * 8):
        cap = max(1, _WIRE_PER_SM * sms // n)
        warps = 1
        while -(-k // _WIRE_UNIT) > _WIRE_UNITS * 32 * warps:
            warps *= 2
        while warps < 8 and -(-m // (4 // warps)) <= cap:
            warps *= 2
        rows = 8 // warps
        return warps, rows, -(-m // rows)
    rows = -(-m // max(1, sms // n))
    return 0, rows, -(-m // rows)


# persistent slots and flag pools a (kernel, device, stream, n, size,
# dtype, tiles)
_POOLS = _build.PoolCache()


def _pool_key(kernel: str, x: torch.Tensor, stream: int, size, dtype,
              tiles: int) -> tuple:
    """A pool's key: two calls share buffers only on one device and one
    stream (launches on a stream run one after another), at one world
    size, slot size and dtype, and tile count."""
    return (kernel, x.device, stream, x.shape[0], size, dtype, tiles)


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


def _ring_buffers(x: torch.Tensor, acc_dtype: torch.dtype,
                  tile: Optional[int] = None):
    """A native ring call's output, its persistent slots and flags, its
    tile and the stream: everything the launch needs but the launch."""
    n = x.shape[0]
    out = torch.empty((n, x.shape[1] // n, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = out[0].numel()
    tile, tiles = _ring_plan(chunk, acc_dtype.itemsize, n,
                             _build.card_sms(x.device), tile)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def make():
        world = VirtualWorld.of(x)
        return (world.heap((2, chunk), acc_dtype),  # [rank][slot]
                world.flags(3 * tiles))

    acc, flags = _POOLS.get(_pool_key("ring_reduce_scatter", x, stream, chunk,
                                      acc_dtype, tiles), make)
    return out, acc, flags, tile, stream


def _launch(x: torch.Tensor, acc_dtype: torch.dtype,
            tile: Optional[int] = None,
            _straggler: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The native ring kernel on x. tile: one of _TILES instead of the
    plan's; _straggler (rank, nanos): that rank's blocks stall on entry
    (a test hook; the result is the same)."""
    if x.device.type != "cuda":
        raise ValueError(f"the reduce-scatter kernel needs a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in _DTYPE_CODE or acc_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {x.dtype} / accum {acc_dtype}: the kernel "
                         "takes float32 or bfloat16")
    n = x.shape[0]
    rank, nanos = _build.straggler_args(_straggler, n)
    if x.numel() == 0:
        return torch.empty((n, x.shape[1] // n, *x.shape[2:]),
                           dtype=x.dtype, device=x.device)
    lib = _build.load("reduce_scatter", _SIGNATURES)
    out, acc, flags, tile, stream = _ring_buffers(x, acc_dtype, tile)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.rs_launch(x.data_ptr(), acc.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), n, out[0].numel(), tile,
                            _DTYPE_CODE[x.dtype], _DTYPE_CODE[acc_dtype],
                            rank, nanos, grid.ptr(), stream)
    _build.check("ring_reduce_scatter", err, lib.rs_error_string, grid)
    _build.count_launch("ring_reduce_scatter")
    return out


def _wire_buffers(x: torch.Tensor, fmt: wire.WireFormat, out_dtype):
    """A wire ring call's output, its persistent image slots and flags,
    its plan (warps a row, rows a tile) and the stream."""
    n = x.shape[0]
    m = x.shape[1] // n
    k = x[0, 0].numel()
    out = torch.empty((n, m, *x.shape[2:]), dtype=out_dtype,
                      device=x.device)
    kw = wire.wire_cols(k, fmt)
    warps, rows, tiles = _wire_plan(m, k, k // wire.n_blocks(k, fmt), n,
                                    _build.card_sms(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def make():
        world = VirtualWorld.of(x)
        return (world.heap((2, m, kw), torch.int8),  # [rank][slot] images
                world.flags(3 * tiles))

    slots, flags = _POOLS.get(_pool_key("ring_rs_wire", x, stream, (m, kw),
                                        torch.int8, tiles), make)
    return out, slots, flags, warps, rows, stream


def _launch_wire(x: torch.Tensor, fmt: wire.WireFormat, out_dtype,
                 straggler) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the wire reduce-scatter kernel needs a CUDA "
                         f"tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {x.dtype} -> {out_dtype}: the kernel "
                         "takes float32 or bfloat16")
    n = x.shape[0]
    k = x[0, 0].numel()
    if k > _WIRE_MAX_COLS:
        raise ValueError(f"rows of {k} elements: the wire kernel stages "
                         f"a row of at most {_WIRE_MAX_COLS} in shared "
                         "memory")
    rank, nanos = _build.straggler_args(straggler, n)
    if x.numel() == 0:
        return torch.empty((n, x.shape[1] // n, *x.shape[2:]),
                           dtype=out_dtype, device=x.device)
    lib = _build.load("reduce_scatter", _SIGNATURES)
    out, slots, flags, warps, rows, stream = _wire_buffers(x, fmt, out_dtype)
    nb = wire.n_blocks(k, fmt)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.rs_wire_launch(
            x.data_ptr(), slots.data_ptr(), out.data_ptr(),
            flags.data_ptr(), n, out.shape[1], k, int(fmt.kind == "fp8"),
            k // nb, nb, int(fmt.checksum), slots.shape[-1], warps, rows,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], rank, nanos,
            grid.ptr(), stream)
    _build.check("ring_rs_wire", err, lib.rs_error_string, grid)
    _build.count_launch("ring_rs_wire")
    return out

"""AllReduce — port of triton_dist_tpu.kernels.allreduce: the one-shot
kernel (`one_shot_all_reduce`, the Pallas kernel `_one_shot_ar_kernel`)
and the library's entry points (`AllReduceMethod`,
`choose_allreduce_method`, `two_shot_all_reduce`, `all_reduce`,
`all_reduce_op`).

The tensor is rank-stacked: x (n, ...) holds every rank's contribution
of the virtual world (runtime/symm_mem.py); the result (n, ...) holds
every rank's copy of the sum. Two implementations of one contract:

  one_shot_all_reduce — the hand-written CUDA kernel
      (csrc/allreduce.cu). Launches on a CUDA tensor, or raises; on a
      CPU tensor it computes the plain version (no kernel exists there).
  one_shot_all_reduce_plain — the same sum in plain torch: over ranks
      0..n-1 in that order, each add rounded to x.dtype (the JAX body's
      `acc = acc + ws[r]` with acc in x.dtype), broadcast to every rank.
      The kernel folds in the same order with the same roundings, so the
      two and the JAX kernel agree bitwise, in f32 and in bf16, and
      every rank's copy has the same bits.

On the card the kernel takes its workspace and flag pool from `_POOLS`
(a _build.PoolCache: made once, the flags zeroed once, then
reused; the kernel leaves every flag at zero), so a warm call allocates
only its output. `_ar_plan` cuts the tensor into tiles; `_launch(x,
tile=)` forces a tile (the sweep and the tests).

At n = 1 both return x,
as the JAX function does. The TPU's VMEM-budget fallback to lax.psum
is a rule of the TPU and does not carry over: on the card the kernel
always runs.

`two_shot_all_reduce` is the JAX host composition of two ported
kernels: the ring ReduceScatter, then the ring AllGather of the reduced
chunks (a rank's leading dim divisible by n). `all_reduce(x, method)`
routes as the JAX function does for one axis; `XLA` is `lax.psum`, left
to XLA there, and here the plain rank-order f32 fold rounded once
(`all_reduce_plain`). `Auto` keeps the JAX rule's chip-free parts: a
leading dim not divisible by n takes OneShot up to 256 KiB a rank and
XLA above; otherwise TwoShot above 256 KiB. Below that cap JAX asks its
TPU perf model; here the one-shot / two-shot crossover measured on the
card (`_ONE_SHOT_CROSSOVER_BYTES`) decides. `all_reduce_op(arr)` is the
host entry: arr (n, ...) stacks the contributions, the world its
leading dim; it returns the replicated sum.

A quantized `wire_format` is a two-shot construct, as in JAX: it forces
TwoShot, whose ReduceScatter leg is the wire ring (`ring_rs_wire_kernel`:
requantized at every hop, f32 at each consume edge) and whose
AllGather leg encodes each reduced chunk once (the gather forwards
bytes); a leading dim not divisible by n raises. The result is bitwise
`wire.simulate_allreduce`. Out of scope, raising NotImplementedError:
`wire_format="auto"` and `error_budget`, which need the perf model's
choose_wire_format (ROADMAP item 7), axis tuples (item 15) and
`all_reduce_op(fallback="xla")`, the guard ladder (item 8).
"""

from __future__ import annotations

import ctypes
import enum
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather as _ag
from triton_dist_tpu_torch.kernels import reduce_scatter as _rsr
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class AllReduceMethod(enum.Enum):
    Auto = "auto"
    OneShot = "one_shot"
    TwoShot = "two_shot"
    XLA = "xla"


# the JAX cap (allreduce.py:51): above it a rank's tensor goes two-shot
# (or, with a leading dim not divisible by n, XLA)
_ONE_SHOT_MAX_BYTES = 256 << 10
# Below the cap, the largest size a rank at which one-shot is no slower
# than two-shot on the card. chip_smoke.py phase 4c's sweep (4 KiB to
# 256 KiB a rank, bf16, n = 2 and 4, on an NVIDIA H100 80GB HBM3 at
# 700 W) found one-shot faster at every size at both world sizes (one
# launch against two; PERF.md): its largest size. Phase 4c fails if a
# sweep finds one-shot slower at or below it. It stands until the port
# has a perf model (ROADMAP item 7).
_ONE_SHOT_CROSSOVER_BYTES = 256 << 10
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's tiles (csrc/allreduce.cu): each tile has its own arrival
# counter, and is a power of two of 16-byte units on at most 128 threads,
# at most 8 units a thread (_AR_TILE_BYTES). _AR_TILE is the default:
# the fastest of the sweep at a decode step's (4, 4, 4096) bf16, 8
# blocks a rank (tools/profile_allreduce.py, NVIDIA H100 80GB HBM3: 6.3
# us against 6.8-7.0 for the smaller tiles that put a block on every SM
# and 7.3-9.1 for the larger; PERF.md). _ar_plan doubles it while a
# rank's tiles exceed what stays resident (_AR_PER_SM blocks an SM, the
# kernel's __launch_bounds__), which gives 8192 at a scheduler step's
# (4, 256, 4096), the fastest there too.
_AR_TILES = (256, 512, 1024, 2048, 4096, 8192)
_AR_TILE = 2048
_AR_TILE_BYTES = 16 * 8 * 128
_AR_PER_SM = 4
# persistent workspaces and flag pools (csrc/allreduce.cu leaves the
# flags at zero): at most _build.POOL_ENTRIES, the least recently used
# evicted
_POOLS = _build.PoolCache()
_SIGNATURES = {
    "ar_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]),
    "ar_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _ar_plan(E: int, n: int, itemsize: int, sms: int = _build.SMS,
             tile: Optional[int] = None) -> Tuple[int, int, int]:
    """(tile, blocks per rank, flags per rank) of the kernel for E
    elements a rank of `itemsize` bytes at world n. The tile: _AR_TILE
    (within _AR_TILE_BYTES), doubled while a rank's tiles exceed the
    resident blocks a rank (_AR_PER_SM an SM over n ranks); `tile`
    forces one of _AR_TILES (the sweep). Blocks: one a tile, at most the
    resident ones (the grid stays co-resident). Flags: an arrival counter
    a tile and an entry barrier a block index."""
    top = max(t for t in _AR_TILES if t * itemsize <= _AR_TILE_BYTES)
    cap = max(1, _AR_PER_SM * sms // n)
    if tile is None:
        tile = min(_AR_TILE, top)
        while -(-E // tile) > cap and tile < top:
            tile *= 2
    elif tile not in _AR_TILES or tile > top:
        raise ValueError(f"tile {tile}: one of {_AR_TILES}, at most {top} "
                         f"for {itemsize}-byte elements")
    tiles = -(-E // tile)
    blocks = min(tiles, cap)
    return tile, blocks, tiles + blocks


def one_shot_all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) dim in rank order, each add rounded to
    x.dtype; every rank gets the same copy."""
    if x.shape[0] == 1:
        return x
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = (acc.float() + x[r].float()).to(x.dtype)
    return acc.expand_as(x).contiguous()


def all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """The XLA method: the sum over ranks folded in f32 in rank order and
    rounded once (the stand-in for `lax.psum`), every rank's copy alike."""
    acc = x[0].float()
    for r in range(1, x.shape[0]):
        acc = acc + x[r].float()
    return acc.to(x.dtype).expand_as(x).contiguous()


def choose_allreduce_method(nbytes: int, n: int,
                            divisible: bool = True) -> AllReduceMethod:
    """The whole Auto rule for a rank's `nbytes`. A leading dim not
    divisible by n (`divisible` False): OneShot up to the one-shot cap,
    XLA above. Otherwise OneShot up to the crossover measured on the card
    (never above the cap; the same at n = 2 and 4, n kept for the JAX
    signature), TwoShot above."""
    if not divisible:
        return (AllReduceMethod.OneShot if nbytes <= _ONE_SHOT_MAX_BYTES
                else AllReduceMethod.XLA)
    if nbytes <= min(_ONE_SHOT_CROSSOVER_BYTES, _ONE_SHOT_MAX_BYTES):
        return AllReduceMethod.OneShot
    return AllReduceMethod.TwoShot


def _auto_wire(wire_format, error_budget) -> None:
    if wire_format == "auto" or error_budget is not None:
        raise NotImplementedError(
            "wire_format='auto' and error_budget ask the perf model's "
            "choose_wire_format (ROADMAP item 7)")


def two_shot_all_reduce(x: torch.Tensor, wire_format=None) -> torch.Tensor:
    """x (n, M, ...) -> (n, M, ...), M divisible by n: the ring
    ReduceScatter kernel, then the ring AllGather kernel; both legs on
    the quantized wire when wire_format asks for it."""
    _auto_wire(wire_format, None)
    fmt = wire.resolve(wire_format)
    return _ag.ring_all_gather(
        _rsr.ring_reduce_scatter(x, wire_format=fmt), wire_format=fmt)


def all_reduce(x: torch.Tensor, method=AllReduceMethod.Auto,
               wire_format=None, error_budget=None,
               axis=None) -> torch.Tensor:
    """x (n, M, ...) rank-stacked -> (n, M, ...), every rank's copy the
    sum, by `method` (the JAX routing for one axis; axis: the JAX mesh
    axis, one name, the world being x's leading dim)."""
    if axis is not None and not isinstance(axis, str):
        raise NotImplementedError(
            f"axis={axis!r}: stage-wise reductions over an axis tuple need "
            "a 2-D virtual world (ROADMAP item 15)")
    _auto_wire(wire_format, error_budget)
    if x.dim() < 2:
        raise ValueError(f"all_reduce needs rank-stacked (n, M, ...) "
                         f"tensors, got shape {tuple(x.shape)}")
    n = x.shape[0]
    if not wire.is_native(wire_format):
        if x.shape[1] % n:
            raise ValueError(
                f"quantized wire AR needs leading dim divisible by the "
                f"axis size (two-shot construct): {x.shape[1]} % {n}")
        return two_shot_all_reduce(x, wire_format=wire_format)
    if method == AllReduceMethod.Auto:
        method = choose_allreduce_method(x[0].numel() * x.element_size(), n,
                                         divisible=x.shape[1] % n == 0)
    if method == AllReduceMethod.XLA:
        return x if n == 1 else all_reduce_plain(x)
    if method == AllReduceMethod.OneShot:
        return one_shot_all_reduce(x)
    if method == AllReduceMethod.TwoShot:
        return two_shot_all_reduce(x)
    raise ValueError(f"unknown method {method}")


def all_reduce_op(arr: torch.Tensor, method=AllReduceMethod.Auto,
                  wire_format=None, fallback=None) -> torch.Tensor:
    """The host entry: arr (n, ...) stacks one contribution a rank, the
    world its leading dim; returns the sum (...), replicated (rank 0's
    copy)."""
    if fallback not in (None, "xla"):
        raise ValueError(f"unknown fallback {fallback!r} (None or 'xla')")
    if fallback == "xla":
        raise NotImplementedError(
            "fallback='xla' is the guard ladder's degradation route "
            "(ROADMAP item 8)")
    return all_reduce(arr, method=method, wire_format=wire_format)[0]


@_build.counted("one_shot_all_reduce")
def one_shot_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """x (n, ...) rank-stacked -> (n, ...), every rank's copy the sum:
    the CUDA kernel on a CUDA tensor (launched or raising, never
    replaced), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return one_shot_all_reduce_plain(x)
    return _launch(x)


def _ar_pool_key(x: torch.Tensor, stream: int, tile: int,
                 blocks: int) -> tuple:
    """A pool's key: two calls share a workspace and flags only on one
    device and one stream (launches on a stream run one after another),
    at one world size, size a rank and dtype, and one plan."""
    return (x.device, stream, x.shape[0], x[0].numel(), x.dtype, tile,
            blocks)


def _ar_buffers(x: torch.Tensor, tile: Optional[int] = None):
    """A call's output, its persistent workspace and flag pool, its plan
    (tile, blocks) and the stream: everything the launch needs but the
    launch."""
    n, e = x.shape[0], x[0].numel()
    out = torch.empty_like(x)
    tile, blocks, nf = _ar_plan(e, n, x.element_size(),
                                _build.card_sms(x.device), tile)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def make():
        world = VirtualWorld.of(x)
        return world.heap((n, e), x.dtype), world.flags(nf)

    ws, flags = _POOLS.get(_ar_pool_key(x, stream, tile, blocks), make)
    return out, ws, flags, tile, blocks, stream


def _launch(x: torch.Tensor, tile: Optional[int] = None) -> torch.Tensor:
    """The kernel on x; tile: one of _AR_TILES instead of the plan's (the
    sweep and the tests)."""
    if x.device.type != "cuda":
        raise ValueError(f"the all-reduce kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {x.dtype}: the kernel takes float32 or "
                         "bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    n, e = x.shape[0], x[0].numel()
    if n == 1:
        return x
    if e == 0:
        return x.clone()
    lib = _build.load("allreduce", _SIGNATURES)
    out, ws, flags, tile, blocks, stream = _ar_buffers(x, tile)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ar_launch(x.data_ptr(), ws.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), n, e, tile, blocks,
                            flags.shape[1], _DTYPE_CODE[x.dtype], grid.ptr(),
                            stream)
    _build.check("one_shot_all_reduce", err, lib.ar_error_string, grid)
    _build.count_launch("one_shot_all_reduce")
    return out

"""AllGather — port of triton_dist_tpu.kernels.allgather: the ring
(`ring_all_gather`, the Pallas kernel `_ring_ag_kernel`), the full mesh
(`full_mesh_all_gather`, `_full_mesh_ag_kernel`) and the library's
entry points (`AllGatherMethod`, `choose_allgather_method`,
`all_gather`, `all_gather_op`), on the native and the quantized wire.

Rank-stacked: x (n, m, ...) holds every rank's shard of the virtual
world (runtime/symm_mem.py); the result (n, n*m, ...) holds every rank's
gathered copy, chunk c from rank c. Each kernel has two implementations
of one contract:

  ring_all_gather, full_mesh_all_gather — the hand-written CUDA kernels
      (csrc/allgather.cu: the ring, and the full-mesh push of
      shmem::fcollect, one put a peer). Each launches on a CUDA tensor,
      or raises; on a CPU tensor it computes the plain version (no
      kernel exists there).
  ring_all_gather_plain, full_mesh_all_gather_plain — the same
      concatenation in plain torch.

Data movement only: all agree bitwise, with each other and with the JAX
functions. At n = 1 each returns x, as the JAX functions do.

`all_gather(x, method)` routes as the JAX function does for one axis:
`Auto` takes the full mesh for a rank's shard of at most 1 MiB and the
ring above; `XLA` is the plain concatenation (JAX leaves it to XLA).
`all_gather_op(arr)` is the host entry: arr is the rank-stacked tensor
and the world its leading dim; it returns the replicated (n*m, ...).

A quantized `wire_format` (the JAX `_wire_ag`): each rank's shard is
packed once at the send edge (wire.pack, the block-scaled int8 image),
the same ring or full-mesh kernel moves the image as bytes (a ring
forward re-sends received bytes: no per-hop requantization), and every
slot, the rank's own included, is unpacked at the consume edge, which
raises WireIntegrityError on a checksum format whose image fails. The
result is bitwise the pack / unpack roundtrip of the shards; at n = 1
it is that roundtrip. The XLA method gathers the same image. Auto
decides on the native bytes, as the JAX rule does. Out of scope,
raising NotImplementedError: axis tuples / `Ring2D`, which need a 2-D
virtual world (item 15).
"""

from __future__ import annotations

import ctypes
import enum
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class AllGatherMethod(enum.Enum):
    Auto = "auto"
    Ring1D = "ring_1d"
    FullMesh = "full_mesh"
    Ring2D = "ring_2d"
    XLA = "xla"


# the JAX Auto rule (allgather.py:62-68): a rank's shard of at most this
# many bytes goes full mesh (one put a peer), a larger one the ring
_FULL_MESH_MAX_BYTES = 1 << 20
# bytes per tile of the ring (csrc/allgather.cu kTileBytes): each (step,
# tile) pair has its own flag
_TILE_BYTES = 16384
# bytes a block of the full-mesh launch copies at least
_FM_BLOCK_BYTES = 32 << 10
_SIGNATURES = {
    "ag_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "ag_tile_count": (ctypes.c_int, [ctypes.c_longlong]),
    "fm_ag_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "fm_ag_flag_words": (ctypes.c_int, [ctypes.c_int]),
    "ag_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


# the ring's persistent flag pools, an entry a (device, stream, n, chunk
# bytes, tiles): (n - 2) x tiles flags a rank (the last step is not
# signalled), which its ranks leave at zero
_POOLS = _build.PoolCache()


def _ring_tiles(chunk: int) -> int:
    """Tiles of the ring for a shard of `chunk` bytes (each with its own
    flag a step): _TILE_BYTES each, the last one short."""
    return -(-chunk // _TILE_BYTES)


def _pool_key(x: torch.Tensor, stream: int, chunk: int) -> tuple:
    """A ring pool's key: two calls share flags only on one device and
    one stream (launches on a stream run one after another), at one world
    size and one tile count."""
    return (x.device, stream, x.shape[0], chunk, _ring_tiles(chunk))


def choose_allgather_method(nbytes_per_rank: int) -> AllGatherMethod:
    if nbytes_per_rank <= _FULL_MESH_MAX_BYTES:
        return AllGatherMethod.FullMesh
    return AllGatherMethod.Ring1D


def _check_shape(x: torch.Tensor) -> None:
    if x.dim() < 3:
        raise ValueError(f"all_gather needs rank-stacked >= 2-D shards "
                         f"(n, m, ...), got shape {tuple(x.shape)}")


def ring_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """(n, m, ...) -> (n, n*m, ...): every rank gets all n shards in
    rank order."""
    _check_shape(x)
    n = x.shape[0]
    if n == 1:
        return x
    full = x.reshape(n * x.shape[1], *x.shape[2:])
    return full.expand(n, *full.shape).contiguous()


def _wire_ag(x: torch.Tensor, fmt: wire.WireFormat,
             transport) -> torch.Tensor:
    """The quantized gather: pack every shard once, move the images
    with `transport` ((n, m, kw) int8 -> (n, n*m, kw)), unpack every
    slot."""
    _check_shape(x)
    n, m = x.shape[:2]
    w = wire.pack(x.reshape(n * m, *x.shape[2:]), fmt).reshape(n, m, -1)
    gathered = w if n == 1 else transport(w)
    out = wire.unpack(gathered.reshape(-1, w.shape[-1]), x.shape[2:], fmt,
                      x.dtype)
    return out.reshape(n, gathered.shape[1], *x.shape[2:])


@_build.counted("ring_all_gather")
def ring_all_gather(x: torch.Tensor, wire_format=None) -> torch.Tensor:
    """x (n, m, ...) rank-stacked -> (n, n*m, ...): the CUDA kernel on a
    CUDA tensor (launched or raising, never replaced), the plain version
    on a CPU tensor. A quantized wire_format moves the packed images."""
    fmt = wire.resolve(wire_format)
    if not wire.is_native(fmt):
        return _wire_ag(x, fmt, ring_all_gather)
    if x.device.type == "cpu":
        return ring_all_gather_plain(x)
    return _launch(x)


def full_mesh_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """The full mesh's result: the concatenation of ring_all_gather_plain."""
    return ring_all_gather_plain(x)


@_build.counted("full_mesh_all_gather")
def full_mesh_all_gather(x: torch.Tensor,
                         straggler: Optional[Tuple[int, int]] = None,
                         wire_format=None) -> torch.Tensor:
    """x (n, m, ...) rank-stacked -> (n, n*m, ...) by the full-mesh push:
    the CUDA kernel on a CUDA tensor (launched or raising, never
    replaced), the plain version on a CPU tensor. straggler: (rank,
    nanos), that rank's blocks stall after the barrier (the card only;
    the result is the same). A quantized wire_format moves the packed
    images."""
    fmt = wire.resolve(wire_format)
    if not wire.is_native(fmt):
        return _wire_ag(x, fmt, lambda w: full_mesh_all_gather(
            w, straggler=straggler))
    if x.device.type == "cpu":
        return full_mesh_all_gather_plain(x)
    return _launch_fm(x, straggler)


def all_gather(x: torch.Tensor, method=AllGatherMethod.Auto,
               wire_format=None, axis=None) -> torch.Tensor:
    """x (n, m, ...) -> (n, n*m, ...) by `method`: Auto picks the full
    mesh for a rank's shard (x[0]) of at most 1 MiB, else the ring; XLA
    is the plain concatenation. axis: the JAX mesh axis, one name
    (the world is x's leading dim); a tuple raises. A quantized
    wire_format gathers the packed images by the same method."""
    if axis is not None and not isinstance(axis, str):
        raise NotImplementedError(
            f"axis={axis!r}: stage-wise gathers over an axis tuple need a "
            "2-D virtual world (ROADMAP item 15)")
    if method == AllGatherMethod.Ring2D:
        raise NotImplementedError(
            "Ring2D is the stage-wise gather over an axis tuple, which needs "
            "a 2-D virtual world (ROADMAP item 15)")
    fmt = wire.resolve(wire_format)
    _check_shape(x)
    if method == AllGatherMethod.Auto:
        method = choose_allgather_method(x[0].numel() * x.element_size())
    if method == AllGatherMethod.XLA:
        if not wire.is_native(fmt):
            return _wire_ag(x, fmt, ring_all_gather_plain)
        return ring_all_gather_plain(x)
    if method == AllGatherMethod.Ring1D:
        return ring_all_gather(x, wire_format=fmt)
    if method == AllGatherMethod.FullMesh:
        return full_mesh_all_gather(x, wire_format=fmt)
    raise ValueError(f"unknown method {method}")


def all_gather_op(arr: torch.Tensor, method=AllGatherMethod.Auto,
                  wire_format=None) -> torch.Tensor:
    """The host entry: arr (n, m, ...) stacks every rank's shard, the
    world its leading dim; returns the gathered (n*m, ...), replicated
    (rank 0's copy)."""
    return all_gather(arr, method=method, wire_format=wire_format)[0]


def _check_launch(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the all-gather kernel needs a CUDA tensor, got "
                         f"{x.device}")
    _check_shape(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def _launch_fm(x: torch.Tensor, straggler) -> torch.Tensor:
    _check_launch(x)
    world = VirtualWorld.of(x)
    n, m = x.shape[:2]
    rank, nanos = straggler if straggler is not None else (-1, 0)
    if straggler is not None and not (0 <= rank < n and nanos >= 0):
        raise ValueError(f"straggler {straggler}: (rank in [0, {n}), "
                         "nanos >= 0)")
    if n == 1:
        return x
    out = torch.empty((n, n * m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = x[0].numel() * x.element_size()
    if chunk == 0:
        return out
    lib = _build.load("allgather", _SIGNATURES)
    flags = world.flags(lib.fm_ag_flag_words(n))
    want = max(1, -(-n * chunk // _FM_BLOCK_BYTES))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.fm_ag_launch(x.data_ptr(), out.data_ptr(),
                               flags.data_ptr(), n, chunk, rank, nanos, want,
                               grid.ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _build.check("full_mesh_all_gather", err, lib.ag_error_string, grid)
    _build.count_launch("full_mesh_all_gather")
    return out


def _ring_buffers(x: torch.Tensor):
    """A ring call's output, its persistent flag pool and the stream:
    everything the launch needs but the launch."""
    n, m = x.shape[:2]
    out = torch.empty((n, n * m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = x.numel() // n * x.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flags = _POOLS.get(_pool_key(x, stream, chunk), lambda: VirtualWorld.of(
        x).flags((n - 2) * _ring_tiles(chunk)))
    return out, flags, stream


def _launch(x: torch.Tensor) -> torch.Tensor:
    _check_launch(x)
    n = x.shape[0]
    if n == 1:
        return x
    chunk = x.numel() // n * x.element_size()
    if chunk == 0:
        return torch.empty((n, n * x.shape[1], *x.shape[2:]), dtype=x.dtype,
                           device=x.device)
    if chunk % 2:
        raise ValueError(f"shard of {chunk} bytes: the kernel moves words "
                         "of at least 2 bytes")
    lib = _build.load("allgather", _SIGNATURES)
    out, flags, stream = _ring_buffers(x)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                            n, chunk, grid.ptr(), stream)
    _build.check("ring_all_gather", err, lib.ag_error_string, grid)
    _build.count_launch("ring_all_gather")
    return out

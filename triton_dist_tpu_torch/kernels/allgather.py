"""Ring AllGather — port of triton_dist_tpu.kernels.allgather
(`ring_all_gather`, the Pallas kernel `_ring_ag_kernel`), native wire.

Rank-stacked: x (n, m, ...) holds every rank's shard of the virtual
world (runtime/symm_mem.py); the result (n, n*m, ...) holds every rank's
gathered copy, chunk c from rank c. Two implementations of one contract:

  ring_all_gather — the hand-written CUDA kernel (csrc/allgather.cu).
      Launches on a CUDA tensor, or raises; on a CPU tensor it computes
      the plain version (no kernel exists there).
  ring_all_gather_plain — the same concatenation in plain torch.

Data movement only: the two agree bitwise, with each other and with the
JAX function. At n = 1 both return x, as the JAX function does.
Quantized wire formats belong to the wire/ slice.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

# bytes per tile: each (step, tile) pair has its own flag
_TILE_BYTES = 16384
_SIGNATURES = {
    "ag_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
    "ag_tile_count": (ctypes.c_int, [ctypes.c_longlong, ctypes.c_int]),
    "ag_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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


@_build.counted("ring_all_gather")
def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """x (n, m, ...) rank-stacked -> (n, n*m, ...): the CUDA kernel on a
    CUDA tensor (launched or raising, never replaced), the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return ring_all_gather_plain(x)
    return _launch(x)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the all-gather kernel needs a CUDA tensor, got "
                         f"{x.device}")
    _check_shape(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    world = VirtualWorld.of(x)
    n, m = x.shape[:2]
    if n == 1:
        return x
    out = torch.empty((n, n * m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = x[0].numel() * x.element_size()
    if chunk == 0:
        return out
    if chunk % 2:
        raise ValueError(f"shard of {chunk} bytes: the kernel moves words "
                         "of at least 2 bytes")
    lib = _build.load("allgather", _SIGNATURES)
    flags = world.flags((n - 1) * lib.ag_tile_count(chunk, _TILE_BYTES))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                            n, chunk, _TILE_BYTES, grid.ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check("ring_all_gather", err, lib.ag_error_string, grid)
    _build.count_launch("ring_all_gather")
    return out

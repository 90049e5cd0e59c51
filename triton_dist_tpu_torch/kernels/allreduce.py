"""One-shot AllReduce — port of triton_dist_tpu.kernels.allreduce
(`one_shot_all_reduce`, the Pallas kernel `_one_shot_ar_kernel`).

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

At n = 1 both return x,
as the JAX function does. The TPU's VMEM-budget fallback to lax.psum
is a rule of the TPU and does not carry over: on the card the kernel
always runs.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# elements per tile: each tile has its own arrival counter
_TILE = 8192
_SIGNATURES = {
    "ar_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
    "ar_flag_count": (ctypes.c_int, [ctypes.c_longlong, ctypes.c_int]),
    "ar_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def one_shot_all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) dim in rank order, each add rounded to
    x.dtype; every rank gets the same copy."""
    if x.shape[0] == 1:
        return x
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = (acc.float() + x[r].float()).to(x.dtype)
    return acc.expand_as(x).contiguous()


@_build.counted("one_shot_all_reduce")
def one_shot_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """x (n, ...) rank-stacked -> (n, ...), every rank's copy the sum:
    the CUDA kernel on a CUDA tensor (launched or raising, never
    replaced), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return one_shot_all_reduce_plain(x)
    return _launch(x)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the all-reduce kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {x.dtype}: the kernel takes float32 or "
                         "bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    world = VirtualWorld.of(x)
    if world.n == 1:
        return x
    e = x[0].numel()
    if e == 0:
        return x.clone()
    lib = _build.load("allreduce", _SIGNATURES)
    ws = world.heap((world.n, e), x.dtype)
    out = torch.empty_like(x)
    flags = world.flags(lib.ar_flag_count(e, _TILE))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ar_launch(x.data_ptr(), ws.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), world.n, e, _TILE,
                            _DTYPE_CODE[x.dtype], grid.ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check("one_shot_all_reduce", err, lib.ar_error_string, grid)
    _build.count_launch("one_shot_all_reduce")
    return out

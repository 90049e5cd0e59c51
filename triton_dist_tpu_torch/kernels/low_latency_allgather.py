"""Low-latency AllGather — port of triton_dist_tpu.kernels.
low_latency_allgather (`create_ll_ag_buffer`, `ll_all_gather`, the
Pallas kernel `_ll_ag_kernel`), on the native and the quantized wire.

A small-message AllGather whose steady state needs no barrier: the
destination is a persistent context (2 parities x n slots a rank) that
the caller threads through calls, call k uses parity k % 2, and only
the first call on a fresh context barriers. The context is a
`SymmetricContext` (runtime/symm_mem.py): its data slots and its
(parity, source) flags persist across launches; call k sets a flag to
k + 1 and waits on it by value, and nothing is reset between calls.

Rank-stacked: x (n, ...) holds rank r's payload at [r]; the gathered
result (n, n, ...) holds at [r] rank r's copy of all n payloads in rank
order. Two implementations of one contract:

  ll_all_gather — the hand-written CUDA kernel
      (csrc/low_latency_allgather.cu). Launches on a CUDA tensor, or
      raises; on a CPU tensor it runs the plain version (no kernel
      exists there).
  ll_all_gather_plain — the same protocol's effect in plain torch: the
      slots and flags of the context written as the kernel writes them,
      and the gathered copy read back.

Data movement only: the two agree bitwise, with each other and with
the JAX function, and leave the context's slots and parity flags in the
same state (the kernel's entry barrier also counts in the flags' last
word). The JAX package's `segment_collect_start`, the per-segment form
of the same full-mesh push, is the device helper of that name in
csrc/shmem.cuh, which SP flash prefill's kernel calls
(csrc/flash_prefill.cu).

A quantized `wire_format`: the context made with it holds int8 slots of
the packed image, (n, 2, n, rows, wire_cols) (`create_ll_ag_buffer(...,
wire_format=)`); each call packs every rank's payload once, pushes the
images through the same kernel and parity protocol, and unpacks every
slot (WireIntegrityError on a checksum format whose image fails). The
result is bitwise the roundtrip of each payload; at n = 1 it is that
roundtrip and the context is not touched. A context made for another
format or dtype raises. `ll_all_gather_op` and its fallback ladder are
not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.device import resolve_device
from triton_dist_tpu_torch.runtime.symm_mem import (
    SymmetricContext,
    VirtualWorld,
)

_SIGNATURES = {
    "ll_ag_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
    "ll_ag_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def create_ll_ag_buffer(x_shape: Sequence[int], dtype: torch.dtype, n: int,
                        wire_format=None, device=None) -> SymmetricContext:
    """A fresh LL context for payloads of x_shape (one rank's shape) on
    a world of n: data (n, 2, n, *x_shape) (a quantized wire_format: (n,
    2, n, rows, wire_cols) int8 images) and flags (n, 2 n + 1), both
    zero (the FastAllGatherContext analog). Thread it through calls."""
    fmt = wire.resolve(wire_format)
    world = VirtualWorld(n, resolve_device(device))
    if not wire.is_native(fmt):
        kw = wire.wire_cols(math.prod(x_shape[1:]), fmt)
        return world.context((2, n, x_shape[0], kw), torch.int8, 2 * n + 1)
    return world.context((2, n, *x_shape), dtype, 2 * n + 1)


def _check(x: torch.Tensor, ctx: SymmetricContext, call_count: int) -> None:
    n = x.shape[0]
    if ctx.data.shape != (n, 2, n, *x.shape[1:]) or \
            ctx.data.dtype != x.dtype or \
            ctx.flags.shape != (n, 2 * n + 1):
        raise ValueError(f"context {tuple(ctx.data.shape)} "
                         f"{ctx.data.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype}")
    if ctx.data.device != x.device or ctx.flags.device != x.device:
        raise ValueError(f"context on {ctx.data.device}, x on {x.device}")
    if int(call_count) < 0:
        raise ValueError(f"call_count {call_count} must be >= 0")


def ll_all_gather_plain(x: torch.Tensor, ctx: SymmetricContext,
                        call_count: int) -> torch.Tensor:
    """The kernel's effect in torch: every rank's payload into slot
    (call_count % 2, rank) of every rank's partition, those slots' flags
    set to call_count + 1; returns a copy of each rank's gathered slots,
    (n, n, ...)."""
    _check(x, ctx, call_count)
    parity = int(call_count) % 2
    n = x.shape[0]
    ctx.data[:, parity] = x.unsqueeze(0).expand(n, *x.shape)
    ctx.flags[:, parity * n:(parity + 1) * n] = int(call_count) + 1
    return ctx.data[:, parity].clone()


@_build.counted("ll_all_gather")
def ll_all_gather(x: torch.Tensor, ctx: SymmetricContext, call_count: int,
                  wire_format=None) -> Tuple[torch.Tensor, SymmetricContext]:
    """x (n, ...) rank-stacked -> (gathered (n, n, ...), ctx): the CUDA
    kernel on a CUDA tensor (launched or raising, never replaced), the
    plain version on a CPU tensor. call_count is the 0-based call index
    on ctx; call 0 barriers. ctx is updated in place and returned, as
    the JAX function returns its donated context. At n = 1 the result
    is x[:, None], as the JAX function returns x[None] per rank. A
    quantized wire_format moves the packed images (module docstring)."""
    if x.dim() < 2:
        raise ValueError(f"x must be rank-stacked (n, ...), got "
                         f"{tuple(x.shape)}")
    fmt = wire.resolve(wire_format)
    if not wire.is_native(fmt):
        return _wire_ll(x, ctx, call_count, fmt), ctx
    if x.shape[0] == 1:
        _check(x, ctx, call_count)
        return x[:, None].clone(), ctx
    if x.device.type == "cpu":
        return ll_all_gather_plain(x, ctx, call_count), ctx
    return _launch(x, ctx, int(call_count)), ctx


def _wire_ll(x: torch.Tensor, ctx: SymmetricContext, call_count: int,
             fmt: wire.WireFormat) -> torch.Tensor:
    n = x.shape[0]
    xw = wire.pack(x.reshape(n * x.shape[1], *x.shape[2:]), fmt).reshape(
        n, x.shape[1], -1)
    _check(xw, ctx, call_count)
    if n == 1:
        return wire.roundtrip(x[0], fmt)[None, None]
    if x.device.type == "cpu":
        slots = ll_all_gather_plain(xw, ctx, call_count)
    else:
        slots = _launch(xw, ctx, int(call_count))
    out = wire.unpack(slots.reshape(-1, xw.shape[-1]), x.shape[2:], fmt,
                      x.dtype)
    return out.reshape(n, n, *x.shape[1:])


def _launch(x: torch.Tensor, ctx: SymmetricContext,
            call_count: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the LL all-gather kernel needs a CUDA tensor, "
                         f"got {x.device}")
    _check(x, ctx, call_count)
    if not x.is_contiguous() or not ctx.data.is_contiguous():
        raise ValueError("x and the context must be contiguous")
    n = x.shape[0]
    out = torch.empty((n, n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    nbytes = math.prod(x.shape[1:]) * x.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("low_latency_allgather", _SIGNATURES)
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ll_ag_launch(
            x.data_ptr(), ctx.data.data_ptr(), ctx.flags.data_ptr(),
            out.data_ptr(), n, nbytes, call_count, int(call_count == 0),
            grid.ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("ll_all_gather", err, lib.ll_ag_error_string, grid)
    _build.count_launch("ll_all_gather")
    return out

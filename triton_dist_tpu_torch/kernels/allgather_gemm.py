"""Fused AllGather + GEMM — port of triton_dist_tpu.kernels.
allgather_gemm (`ag_gemm`: the Pallas kernel `_ag_gemm_kernel`, dense
and grouped forms on the native wire, the dense form on the quantized
wire; and `arrival_to_rank_order`).

Rank-stacked: a (n, m, K) holds every rank's shard of the virtual world
(runtime/symm_mem.py), b (n, K, N) every rank's weight (or, with
epilogue="silu_pair", a pair (w_gate, w_up) of that shape); the result
(n, n*m, N) holds rank r's C = AllGather(a) @ b[r]. With silu_pair it is
silu(A @ w_gate[r]) * (A @ w_up[r]), computed in f32 on the f32
accumulators and rounded once (`silu_mul`, the JAX `_silu_mul_f32`).
c_order="rank" gives C's row blocks in rank order; c_order="arrival" in
ring-arrival order, row block s of rank r holding chunk (r - s) mod n,
which gemm_rs(a_order="arrival") reads as it is. return_gathered=True
also returns the gathered A (n, n*m, K) in rank order, the kernel's
workspace.

The grouped (MoE) form: b is (n, E, K, N) (or a pair of such), each
rank's m rows are E equal blocks of cap = m / E rows (pack_by_expert),
and row block e of every gathered chunk multiplies b[r][e]: rank r's C
is (n*m, N), chunk c's block e = A[c][e] @ b[r][e]. b is read through
its strides, so w_gate / w_up may be the two halves of one
[w_gate | w_up] stack (views, rows 2N apart); nothing is copied. Two
implementations of one contract:

  ag_gemm — the hand-written CUDA kernel (csrc/allgather_gemm.cu), which
      gathers over the ring and computes the product inside one launch.
      Launches on a CUDA tensor, or raises; on a CPU tensor it computes
      the plain version.
  ag_gemm_plain — the same function in plain torch: every rank's full
      A times b[r] in f32, rounded once to the dtype, row blocks then
      permuted for "arrival".

The kernel has two tile bodies. The main path's form (dense, native
wire, bf16 inputs, m a multiple of 64: a `dist` prefill's 128 rows a
rank and a scheduler step's 64) takes the TMA + wgmma body, every other
call (grouped, wire, f32, a decode step's m = 1) the mma.sync body;
`_body_for` is the rule, `_wgmma_bn` the wgmma body's tile width, and
`launches_by_body` counts each body's launches. `straggler=(rank,
nanos)` (the JAX config's straggler_rank / straggler_ns) stalls that
rank's ring producers on entry, on the card; the result is the same.

At n = 1 without `force_kernel` the call is a local product (plus
silu_mul for the pair), as the JAX function short-circuits to XLA; with
`force_kernel` the kernel runs with n = 1. The TPU's VMEM-budget and
interpret-mode fallbacks do not carry over: on the card the kernel
always runs. `out_dtype` (default a.dtype) is the dtype C is rounded
to once from the f32 accumulators; on the card bf16 inputs give bf16 or
f32, f32 inputs f32.

A quantized `wire_format` (dense form only; per-row scales; K a multiple
of 128; the JAX checks, allgather_gemm.py:586-601): each rank's A shard
is packed once (wire.pack), the ring forwards the (m, wire_cols) int8
image rows, and each A tile is dequantized right before its product
(float(q) * scale in f32, rounded to a.dtype: `a_dequant`). Every row
goes through the codec, the own shard included, so the product is that
of the roundtrip of A; return_gathered returns the decoded A. At n = 1
without `force_kernel` the call is the local product of the roundtrip.
`ag_gemm_wire` is the wire form's counted wrapper; ag_gemm dispatches
to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tile bodies of the native kernel (csrc/allgather_gemm.cu): 0 the
# mma.sync body (every form), 1 the TMA + wgmma body (the main path's
# form; _body_for)
_BODY_CODE = {"mma": 0, "wgmma": 1}
# the wgmma body's rows a TMA box (a step segment): m a multiple of it
_WGMMA_ROWS = 64
# C columns a wgmma tile (of each of gate and up with silu_pair): the
# candidates _wgmma_bn weighs, and the sweep's
_WGMMA_BN = (128, 192, 256)
_WGMMA_BN_PAIR = (64, 128)
# A tile's time grows as its accumulator columns plus this many: fitted
# to the BN sweep of tools/profile_ag_gemm.py at the main path's shapes
# (NVIDIA H100 80GB HBM3; PERF.md), where a wider tile costs less per
# column; with it the plan picks the sweep's fastest width at each
_WGMMA_FIXED_COLS = 128
# launches of the native kernel by body (ag_gemm.launches counts both):
# a run reads it around a path to show which body served it
launches_by_body = {"mma": 0, "wgmma": 0}
_SIGNATURES = {
    "ag_gemm_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 11 + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p]),
    "ag_gemm_encode_maps": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5),
    "ag_gemm_grouped_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 10 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "ag_gemm_wire_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_void_p]),
    "ag_gemm_flag_count": (ctypes.c_int, [ctypes.c_int]),
    "ag_gemm_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _body_for(a: torch.Tensor, bs, fmt, grouped: bool) -> str:
    """The tile body of a native-kernel call: "wgmma" (TMA + wgmma) for
    the main path's form, dense, native wire, bf16 inputs, m a multiple
    of _WGMMA_ROWS, K and N at least 64; "mma" (mma.sync) for every
    other call (grouped, wire, f32, ragged or small m such as a decode
    step's m = 1)."""
    n, m, k = a.shape
    if (grouped or not wire.is_native(fmt) or a.dtype != torch.bfloat16
            or m % _WGMMA_ROWS or k < 64 or bs[0].shape[-1] < 64):
        return "mma"
    return "wgmma"


def _wgmma_bn(M: int, N: int, n: int, pair: bool, sms: int = _build.SMS) -> int:
    """C columns a wgmma tile for M rows a rank (n*m), N columns, at world
    n: the candidate whose waves (each rank's tiles over its sms // n
    blocks) times a tile's time are the fewest, the widest on a tie. A
    tile's time is taken as its accumulator columns plus
    _WGMMA_FIXED_COLS (wave quantisation: QKV at 4 x 128 rows, N 1536 is
    128 tiles of 192 on 132 SMs, one wave, against 192 tiles of 128)."""
    per = max(1, sms // n)

    def cost(bn):
        tiles = -(-M // 128) * -(-N // bn)
        return (-(-tiles // per) * (bn * (2 if pair else 1)
                                    + _WGMMA_FIXED_COLS), -bn)

    return min(_WGMMA_BN_PAIR if pair else _WGMMA_BN, key=cost)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in f32, the JAX package's `_silu_mul_f32` formula."""
    g = g.float()
    return g * torch.sigmoid(g) * u.float()


def arrival_to_rank_order(c: torch.Tensor) -> torch.Tensor:
    """(n, n*m, ...) rank-stacked: rank r's row block s moves to block
    (r - s) mod n. Arrival order (block s = chunk (r - s) mod n) becomes
    rank order and back: the permutation is its own inverse."""
    n = c.shape[0]
    blocks = c.reshape(n, n, c.shape[1] // n, *c.shape[2:])
    r = torch.arange(n, device=c.device)[:, None]
    s = torch.arange(n, device=c.device)[None, :]
    return blocks[r, (r - s) % n].reshape(c.shape)


def _check(a, b, epilogue, c_order, return_gathered, fmt):
    """Raise on what is not a valid call; returns the weights as a tuple
    (one, or the silu_pair's two)."""
    if epilogue not in (None, "silu_pair"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if c_order not in ("rank", "arrival"):
        raise ValueError(f"c_order={c_order!r}: 'rank' or 'arrival'")
    if epilogue == "silu_pair":
        if not (isinstance(b, (tuple, list)) and len(b) == 2):
            raise ValueError("silu_pair takes b=(w_gate, w_up)")
        if return_gathered:
            raise ValueError("silu_pair does not return the gathered A")
        bs = tuple(b)
        if bs[0].shape != bs[1].shape:
            raise ValueError(f"w_gate {tuple(bs[0].shape)} and w_up "
                             f"{tuple(bs[1].shape)} differ")
    else:
        bs = (b,)
    w = bs[0]
    if a.dim() != 3 or w.dim() not in (3, 4) or (
            w.shape[0], w.shape[-2]) != (a.shape[0], a.shape[2]):
        raise ValueError(f"a (n, m, K) and b (n, K, N) or (n, E, K, N) "
                         f"expected, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    if w.dim() == 4 and a.shape[1] % w.shape[1]:
        raise ValueError(f"packed rows {a.shape[1]} must be E={w.shape[1]} "
                         "equal blocks")
    if not wire.is_native(fmt):
        if len(bs) == 2 or w.dim() == 4:
            raise ValueError(
                "quantized wire supports the dense ag_gemm form only "
                f"(silu_pair={len(bs) == 2}, grouped={w.dim() == 4})")
        if fmt.block is not None:
            raise ValueError(
                "ag_gemm wire uses per-row scales (block=None): the "
                "consumer loads one f32 scale per A row")
        if a.shape[2] % wire.LANE:
            raise ValueError(
                f"ag_gemm wire needs lane-aligned K (got {a.shape[2]})")
    return bs


def _product(full: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gathered A (n*m, K) times every rank's b in f32: (n, n*m, N).
    Grouped b (n, E, K, N): block e of each chunk times b[r][e]."""
    if w.dim() == 3:
        return torch.matmul(full.float(), w.float())
    n, e, k, nn = w.shape
    blocks = full.reshape(n, e, -1, k).float()  # [chunk][expert][row]
    c = torch.einsum("sepk,rekn->rsepn", blocks, w.float())
    return c.reshape(n, -1, nn)


def _roundtrip(a: torch.Tensor, fmt) -> torch.Tensor:
    """Every rank's shard through the codec: pack, unpack (n, m, K)."""
    n, m, k = a.shape
    return wire.roundtrip(a.reshape(n * m, k), fmt).reshape(n, m, k)


def ag_gemm_plain(a: torch.Tensor, b, epilogue=None, c_order: str = "rank",
                  return_gathered: bool = False, out_dtype=None,
                  wire_format=None):
    """Every rank's gathered A (through the codec on a quantized wire)
    times its b in f32, one rounding to out_dtype (default a.dtype); row
    blocks permuted for c_order="arrival"."""
    out_dtype = out_dtype or a.dtype
    if not wire.is_native(wire_format):
        a = _roundtrip(a, wire_format)
    n, m, k = a.shape
    full = a.reshape(n * m, k)
    if epilogue == "silu_pair":
        g, u = (_product(full, w) for w in b)
        c = silu_mul(g, u).to(out_dtype)
    else:
        c = _product(full, b).to(out_dtype)
    if c_order == "arrival":
        c = arrival_to_rank_order(c)
    if return_gathered:
        return c, full.expand(n, n * m, k).contiguous()
    return c


def _local(a, bs, return_gathered, out_dtype, fmt):
    """n = 1: the local product (of A's roundtrip on a quantized wire),
    f32 accumulation rounded once to out_dtype; for the pair, gate and
    up kept in f32 through silu_mul. The grouped form is the plain
    per-expert product (torch, as the JAX function leaves it to XLA)."""
    from triton_dist_tpu_torch.layers.linear import dot_f32

    if bs[0].dim() == 4:
        return ag_gemm_plain(a, bs if len(bs) == 2 else bs[0],
                             "silu_pair" if len(bs) == 2 else None,
                             return_gathered=return_gathered,
                             out_dtype=out_dtype)
    if not wire.is_native(fmt):
        a = _roundtrip(a, fmt)
    if len(bs) == 2:
        c = silu_mul(dot_f32(a, bs[0]), dot_f32(a, bs[1])).to(out_dtype)
    elif out_dtype == a.dtype:
        c = torch.matmul(a, bs[0])
    else:
        c = dot_f32(a, bs[0]).to(out_dtype)
    return (c, a) if return_gathered else c


@_build.counted("ag_gemm")
def ag_gemm(a: torch.Tensor, b, return_gathered: bool = False,
            out_dtype=None, force_kernel: bool = False, epilogue=None,
            c_order: str = "rank", wire_format=None,
            straggler: Optional[Tuple[int, int]] = None):
    """a (n, m, K), b (n, K, N), grouped (n, E, K, N), or a pair
    (w_gate, w_up) of either, rank-stacked -> C (n, n*m, N) in out_dtype
    (default a.dtype) (and the gathered A (n, n*m, K) with
    return_gathered): the CUDA kernel on CUDA tensors (launched or
    raising, never replaced), the plain version on CPU tensors; at n = 1
    a local product unless force_kernel. A quantized wire_format takes
    ag_gemm_wire. straggler: (rank, nanos), that rank's ring producers
    stall on entry (the JAX config's straggler_rank / straggler_ns; the
    card only, native wire; the result is the same)."""
    fmt = wire.resolve(wire_format)
    bs = _check(a, b, epilogue, c_order, return_gathered, fmt)
    _build.straggler_args(straggler, a.shape[0])
    if straggler is not None and not wire.is_native(fmt):
        raise ValueError("straggler delays the native ring; the wire form "
                         "takes none")
    out_dtype = out_dtype or a.dtype
    if a.shape[0] == 1 and not force_kernel:
        return _local(a, bs, return_gathered, out_dtype, fmt)
    if not wire.is_native(fmt):
        return ag_gemm_wire(a, bs[0], fmt, return_gathered, out_dtype,
                            c_order)
    if a.device.type == "cpu":
        return ag_gemm_plain(a, b, epilogue, c_order, return_gathered,
                             out_dtype)
    return _launch(a, bs, c_order == "arrival", return_gathered, out_dtype,
                   straggler=straggler)


@_build.counted("ag_gemm_wire")
def ag_gemm_wire(a: torch.Tensor, b: torch.Tensor, wire_format,
                 return_gathered: bool = False, out_dtype=None,
                 c_order: str = "rank"):
    """The dense ag_gemm on a quantized wire at every n: the kernel on
    CUDA tensors (A packed, the images gathered, each tile dequantized
    before its product), ag_gemm_plain on CPU tensors."""
    fmt = wire.resolve(wire_format)
    if wire.is_native(fmt):
        raise ValueError("ag_gemm_wire takes a quantized wire format")
    _check(a, b, None, c_order, return_gathered, fmt)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ag_gemm_plain(a, b, None, c_order, return_gathered,
                             out_dtype, fmt)
    return _launch_wire(a, b, fmt, c_order == "arrival", return_gathered,
                        out_dtype)


def _grouped_strides(bs, per: int):
    """B's (row, expert, rank) strides of a grouped b (or pair), in
    elements; raises unless the kernel can read it in place."""
    w = bs[0]
    st = w.stride()
    for x in bs:
        if x.stride() != st or x.stride(-1) != 1:
            raise ValueError(f"grouped b strides {[x.stride() for x in bs]}: "
                             "the kernel reads rows of unit-stride columns, "
                             "one stride pattern for both halves")
        if x.data_ptr() % 16:
            raise ValueError("grouped b must be 16-byte aligned")
    ldb, b_es, b_rs = st[2], st[1], st[0]
    if ldb < w.shape[3] or ldb % per or b_es % per or b_rs % per:
        raise ValueError(f"grouped b strides {st}: rows must not overlap "
                         f"and be multiples of {per} elements")
    return ldb, b_es, b_rs


def _check_launch(a: torch.Tensor, bs, out_dtype) -> None:
    if a.device.type != "cuda" or any(w.device != a.device for w in bs):
        raise ValueError(f"the ag_gemm kernel needs CUDA tensors on one "
                         f"device, got {a.device} and "
                         f"{[str(w.device) for w in bs]}")
    if a.dtype not in _DTYPE_CODE or any(w.dtype != a.dtype for w in bs):
        raise ValueError(f"dtypes {a.dtype}/{[w.dtype for w in bs]}: the "
                         "kernel takes float32 or bfloat16, all alike")
    if out_dtype not in _DTYPE_CODE or (a.dtype == torch.float32
                                        and out_dtype != torch.float32):
        raise ValueError(f"out_dtype {out_dtype} of {a.dtype} inputs: the "
                         "kernel writes bf16 or f32 out of bf16, f32 out "
                         "of f32")


def _launch_wire(a: torch.Tensor, b: torch.Tensor, fmt, arrival: bool,
                 return_gathered: bool, out_dtype):
    _check_launch(a, (b,), out_dtype)
    n, m, K = a.shape
    N = b.shape[-1]
    per = 16 // a.element_size()
    if N % per:
        raise ValueError(f"N={N} must be a multiple of {per}: the kernel "
                         "moves 16-byte rows")
    if not b.is_contiguous() or b.data_ptr() % 16:
        raise ValueError("b must be contiguous and 16-byte aligned")
    aw = wire.pack(a.reshape(n * m, K), fmt).reshape(n, m, -1)
    kw = aw.shape[-1]
    world = VirtualWorld.of(a)
    c = torch.empty((n, n * m, N), dtype=out_dtype, device=a.device)
    ws = world.heap((n * m, kw), torch.int8)  # [rank][chunk c's images]
    lib = _build.load("allgather_gemm", _SIGNATURES)
    flags = world.flags(lib.ag_gemm_flag_count(n))
    grid = _build.GridInfo()
    with torch.cuda.device(a.device):
        err = lib.ag_gemm_wire_launch(
            aw.data_ptr(), b.data_ptr(), ws.data_ptr(), c.data_ptr(),
            flags.data_ptr(), n, m, K, N, kw, _DTYPE_CODE[a.dtype],
            _DTYPE_CODE[out_dtype], int(fmt.kind == "fp8"), int(arrival),
            grid.ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("ag_gemm_wire", err, lib.ag_gemm_error_string, grid)
    _build.count_launch("ag_gemm_wire")
    if return_gathered:
        full = wire.unpack(ws.reshape(n * n * m, kw), (K,), fmt, a.dtype)
        return c, full.reshape(n, n * m, K)
    return c


def _launch(a: torch.Tensor, bs, arrival: bool, return_gathered: bool,
            out_dtype=None, straggler=None, bn: Optional[int] = None):
    """The native kernel; the body by _body_for, its tile width by
    _wgmma_bn unless `bn` forces one (the sweep)."""
    out_dtype = out_dtype or a.dtype
    _check_launch(a, bs, out_dtype)
    n, m, K = a.shape
    grouped = bs[0].dim() == 4
    N = bs[0].shape[-1]
    per = 16 // a.element_size()
    if K % per or N % per:
        raise ValueError(f"K={K} and N={N} must be multiples of {per}: the "
                         "kernel moves 16-byte rows")
    for name, x in (("a", a), *(() if grouped else (("b", w) for w in bs))):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if grouped:
        strides = _grouped_strides(bs, per)
    rank, nanos = _build.straggler_args(straggler, n)
    body = _body_for(a, bs, None, grouped)
    if body == "wgmma":
        pair = len(bs) == 2
        bn = bn or _wgmma_bn(n * m, N, n, pair, _build.card_sms(a.device))
        if bn not in (_WGMMA_BN_PAIR if pair else _WGMMA_BN):
            raise ValueError(f"bn={bn}: the wgmma body takes "
                             f"{_WGMMA_BN_PAIR if pair else _WGMMA_BN}")
    elif bn is not None:
        raise ValueError(f"bn={bn}: only the wgmma body takes a tile width")
    world = VirtualWorld.of(a)
    c = torch.empty((n, n * m, N), dtype=out_dtype, device=a.device)
    ws = world.heap((n * m, K), a.dtype)  # [rank][chunk c's rows]
    if c.numel() == 0:
        return (c, ws) if return_gathered else c
    lib = _build.load("allgather_gemm", _SIGNATURES)
    flags = world.flags(lib.ag_gemm_flag_count(n))
    grid = _build.GridInfo()
    ptrs = (a.data_ptr(), bs[0].data_ptr(), bs[-1].data_ptr(),
            ws.data_ptr(), c.data_ptr(), flags.data_ptr(), n, m, K, N,
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], int(len(bs) == 2),
            int(arrival))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if grouped:
            err = lib.ag_gemm_grouped_launch(
                *ptrs, bs[0].shape[1], *strides, rank, nanos, grid.ptr(),
                stream)
        else:
            err = lib.ag_gemm_launch(*ptrs, _BODY_CODE[body], bn or 0, rank,
                                     nanos, grid.ptr(), stream)
    _build.check("ag_gemm", err, lib.ag_gemm_error_string, grid)
    _build.count_launch("ag_gemm")
    launches_by_body[body] += 1
    return (c, ws) if return_gathered else c

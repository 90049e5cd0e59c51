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

The kernel has three bodies. The dense main-path form (native wire,
bf16 inputs, m a multiple of 64: a `dist` prefill's 128 rows a rank and
a scheduler step's 64) takes the TMA + wgmma body; the grouped form in
bf16 with `counts` (the `fused` MoE up-projection) the expert-major TMA
+ wgmma kernel; every other call (wire, f32, a decode step's m = 1, the
grouped form without counts) the mma.sync body. `_body_for` is the
rule, `_wgmma_bn` / `_grouped_bn` the wgmma bodies' tile widths, and
`launches_by_body` counts each body's launches.

The grouped form's live rows: `counts` (n, E) int32, on a's device,
gives the rows of each (rank, expert) block that are live, as
pack_by_expert's `counts` does; the rows past them are taken as zero,
so their C rows are zero. For pack_by_expert's inputs those rows are
zero in A anyway, so the function is the JAX function's. The grouped
kernel then forwards and multiplies only the live rows and zero-fills
the others' C rows; the plain version (and the mma.sync body, where a
call with counts takes it, after its launch) zeroes those C rows.
counts is never read on the host on the card (values outside [0, cap]
are clamped there; on the CPU they raise). It is refused on the dense
form, with return_gathered and on a quantized wire. Without counts
every row is live. `straggler=(rank,
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
# mma.sync body (every form), 1 the TMA + wgmma body (the dense main
# path's form; ag_gemm_launch) or, through ag_gemm_grouped_launch, the
# expert-major grouped kernel (_body_for)
_BODY_CODE = {"mma": 0, "wgmma": 1, "grouped": 1}
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
# the grouped kernel's C columns a tile (of each of gate and up), and the
# ranks its chunk table holds
_GROUPED_BN = (64, 128)
_GROUPED_MAX_N = 8
# launches of the native kernel by body (ag_gemm.launches counts all):
# a run reads it around a path to show which body served it
launches_by_body = {"mma": 0, "wgmma": 0, "grouped": 0}
_SIGNATURES = {
    "ag_gemm_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 11 + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p]),
    "ag_gemm_encode_maps": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5),
    "ag_gemm_grouped_launch": (ctypes.c_int, [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "ag_gemm_wire_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_void_p]),
    "ag_gemm_flag_count": (ctypes.c_int, [ctypes.c_int]),
    "ag_gemm_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _body_for(a: torch.Tensor, bs, fmt, grouped: bool,
              live: bool = False) -> str:
    """The body of a native-kernel call, for bf16 inputs on the native
    wire with K and N at least one 64-wide box: "grouped" (the
    expert-major TMA + wgmma kernel) for the grouped form with `counts`
    (live) at n <= _GROUPED_MAX_N, whatever its cap; "wgmma" (TMA +
    wgmma) for the dense form at m a multiple of _WGMMA_ROWS. "mma"
    (mma.sync, or FMA for f32) for every other call: wire, f32, ragged
    or small m such as a decode step's m = 1, a world above 8 ranks, and
    the grouped form without counts, whose every padded row the grouped
    kernel's 64-row tiles, one consumer warpgroup an SM, compute at half
    the mma.sync body's rate (PERF.md)."""
    n, m, k = a.shape
    if (not wire.is_native(fmt) or a.dtype != torch.bfloat16 or k < 64
            or bs[0].shape[-1] < 64):
        return "mma"
    if grouped:
        return "grouped" if live and n <= _GROUPED_MAX_N else "mma"
    return "mma" if m % _WGMMA_ROWS else "wgmma"


def _grouped_bn(N: int) -> int:
    """C columns a grouped tile for N columns (of each half): the width
    of _GROUPED_BN whose tiles a row (each streaming its B columns, the
    edge's zero fill costing no bytes) times a tile's time, taken as its
    columns plus _WGMMA_FIXED_COLS as for the dense body, are the fewest,
    the widest on a tie: the fused prefill's I_loc 192 takes 128 (its
    sweep: 418-422 against 449-457 µs at 64, PERF.md)."""
    def cost(bn):
        return (-(-N // bn) * (bn + _WGMMA_FIXED_COLS), -bn)

    return min(_GROUPED_BN, key=cost)


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


def _check(a, b, epilogue, c_order, return_gathered, fmt, counts=None):
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
    if counts is not None:
        _check_counts(a, w, counts, return_gathered, fmt)
    return bs


def _check_counts(a, w, counts, return_gathered, fmt) -> None:
    """Raise unless `counts` fits the grouped call: (n, E) int32 on a's
    device, native wire, no return_gathered. Values are checked (within
    [0, cap]) only on the CPU: on the card that would read them back on
    the host."""
    if w.dim() != 4:
        raise ValueError("counts takes the grouped form (b of (n, E, K, N))")
    if return_gathered:
        raise ValueError("counts leaves the rows past it out of the gather: "
                         "no return_gathered")
    if not wire.is_native(fmt):
        raise ValueError("counts takes the native wire")
    n, e = w.shape[:2]
    if (not isinstance(counts, torch.Tensor) or counts.dtype != torch.int32
            or tuple(counts.shape) != (n, e)):
        raise ValueError(f"counts must be an int32 tensor of shape ({n}, "
                         f"{e}), got {getattr(counts, 'dtype', type(counts))}"
                         f" {tuple(getattr(counts, 'shape', ()))}")
    if counts.device != a.device:
        raise ValueError(f"counts on {counts.device}, a on {a.device}")
    cap = a.shape[1] // e
    if counts.device.type == "cpu" and not bool(
            ((counts >= 0) & (counts <= cap)).all()):
        raise ValueError(f"counts outside [0, cap={cap}]: "
                         f"{counts.tolist()}")


def _zero_dead_rows(c: torch.Tensor, counts: torch.Tensor,
                    arrival: bool = False) -> torch.Tensor:
    """C (n, n*m, N), its rows past `counts` (n, E) of each (chunk,
    expert) block set to zero, the row blocks in rank or arrival order;
    torch ops, no host read."""
    n, e = counts.shape
    cap = c.shape[1] // (n * e)
    row = torch.arange(cap, device=c.device)
    dead = row[None, None, :] >= counts.to(c.device, torch.long)[..., None]
    dead = dead.reshape(1, -1, 1).expand(c.shape[0], -1, 1)
    if arrival:
        dead = arrival_to_rank_order(dead)
    return c.masked_fill(dead, 0)


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
                  wire_format=None, counts=None):
    """Every rank's gathered A (through the codec on a quantized wire)
    times its b in f32, one rounding to out_dtype (default a.dtype); the
    rows past `counts` (grouped form) zero; row blocks permuted for
    c_order="arrival"."""
    if counts is not None:
        _check_counts(a, (b[0] if epilogue == "silu_pair" else b), counts,
                      return_gathered, wire.resolve(wire_format))
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
    if counts is not None:
        c = _zero_dead_rows(c, counts)
    if c_order == "arrival":
        c = arrival_to_rank_order(c)
    if return_gathered:
        return c, full.expand(n, n * m, k).contiguous()
    return c


def _local(a, bs, return_gathered, out_dtype, fmt, counts=None):
    """n = 1: the local product (of A's roundtrip on a quantized wire),
    f32 accumulation rounded once to out_dtype; for the pair, gate and
    up kept in f32 through silu_mul. The grouped form is the plain
    per-expert product (torch, as the JAX function leaves it to XLA),
    its rows past counts zero."""
    from triton_dist_tpu_torch.layers.linear import dot_f32

    if bs[0].dim() == 4:
        return ag_gemm_plain(a, bs if len(bs) == 2 else bs[0],
                             "silu_pair" if len(bs) == 2 else None,
                             return_gathered=return_gathered,
                             out_dtype=out_dtype, counts=counts)
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
            straggler: Optional[Tuple[int, int]] = None, counts=None):
    """a (n, m, K), b (n, K, N), grouped (n, E, K, N), or a pair
    (w_gate, w_up) of either, rank-stacked -> C (n, n*m, N) in out_dtype
    (default a.dtype) (and the gathered A (n, n*m, K) with
    return_gathered): the CUDA kernel on CUDA tensors (launched or
    raising, never replaced), the plain version on CPU tensors; at n = 1
    a local product unless force_kernel. A quantized wire_format takes
    ag_gemm_wire. straggler: (rank, nanos), that rank's ring producers
    stall on entry (the JAX config's straggler_rank / straggler_ns; the
    card only, native wire; the result is the same). counts: the grouped
    form's live rows a (rank, expert) block, (n, E) int32 (module
    docstring)."""
    fmt = wire.resolve(wire_format)
    bs = _check(a, b, epilogue, c_order, return_gathered, fmt, counts)
    _build.straggler_args(straggler, a.shape[0])
    if straggler is not None and not wire.is_native(fmt):
        raise ValueError("straggler delays the native ring; the wire form "
                         "takes none")
    out_dtype = out_dtype or a.dtype
    if a.shape[0] == 1 and not force_kernel:
        return _local(a, bs, return_gathered, out_dtype, fmt, counts)
    if not wire.is_native(fmt):
        return ag_gemm_wire(a, bs[0], fmt, return_gathered, out_dtype,
                            c_order)
    if a.device.type == "cpu":
        return ag_gemm_plain(a, b, epilogue, c_order, return_gathered,
                             out_dtype, counts=counts)
    return _launch(a, bs, c_order == "arrival", return_gathered, out_dtype,
                   straggler=straggler, counts=counts)


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
            out_dtype=None, straggler=None, bn: Optional[int] = None,
            counts=None, body: Optional[str] = None):
    """The native kernel; the body by _body_for unless `body` forces
    "mma" (the A/B tools' old body), its tile width by _wgmma_bn /
    _grouped_bn unless `bn` forces one (the sweeps)."""
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
    if counts is not None and not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    rank, nanos = _build.straggler_args(straggler, n)
    pair = len(bs) == 2
    planned = _body_for(a, bs, None, grouped, counts is not None)
    body = body or planned
    if body not in ("mma", planned):
        raise ValueError(f"body={body!r}: this call takes {planned!r} or "
                         "'mma'")
    widths = {"wgmma": _WGMMA_BN_PAIR if pair else _WGMMA_BN,
              "grouped": _GROUPED_BN}.get(body)
    if body == "wgmma":
        bn = bn or _wgmma_bn(n * m, N, n, pair, _build.card_sms(a.device))
    elif body == "grouped":
        bn = bn or _grouped_bn(N)
    if bn is not None and (widths is None or bn not in widths):
        raise ValueError(f"bn={bn}: the {body} body takes {widths}")
    world = VirtualWorld.of(a)
    c = torch.empty((n, n * m, N), dtype=out_dtype, device=a.device)
    ws = world.heap((n * m, K), a.dtype)  # [rank][chunk c's rows]
    if c.numel() == 0:
        return (c, ws) if return_gathered else c
    lib = _build.load("allgather_gemm", _SIGNATURES)
    flags = world.flags(lib.ag_gemm_flag_count(n))
    grid = _build.GridInfo()
    ptrs = (a.data_ptr(), bs[0].data_ptr(), bs[-1].data_ptr(),
            ws.data_ptr(), c.data_ptr(), flags.data_ptr())
    dims = (n, m, K, N, _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
            int(pair), int(arrival))
    # the grouped kernel takes counts; the mma.sync body computes every
    # row, and the rows past counts are zeroed after it
    live = counts.data_ptr() if counts is not None and body == "grouped" \
        else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if grouped:
            err = lib.ag_gemm_grouped_launch(
                *ptrs, live, *dims, bs[0].shape[1], *strides,
                _BODY_CODE[body], bn or 0, rank, nanos, grid.ptr(), stream)
        else:
            err = lib.ag_gemm_launch(*ptrs, *dims, _BODY_CODE[body], bn or 0,
                                     rank, nanos, grid.ptr(), stream)
    _build.check("ag_gemm", err, lib.ag_gemm_error_string, grid)
    _build.count_launch("ag_gemm")
    launches_by_body[body] += 1
    if counts is not None and body != "grouped":
        c = _zero_dead_rows(c, counts, arrival)
    return (c, ws) if return_gathered else c

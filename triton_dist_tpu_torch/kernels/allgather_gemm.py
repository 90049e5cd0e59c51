"""Fused AllGather + GEMM — port of triton_dist_tpu.kernels.
allgather_gemm (`ag_gemm`: the Pallas kernel `_ag_gemm_kernel`, dense
form, native wire; and `arrival_to_rank_order`).

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
workspace. Two implementations of one contract:

  ag_gemm — the hand-written CUDA kernel (csrc/allgather_gemm.cu), which
      gathers over the ring and computes the product inside one launch.
      Launches on a CUDA tensor, or raises; on a CPU tensor it computes
      the plain version.
  ag_gemm_plain — the same function in plain torch: every rank's full
      A times b[r] in f32, rounded once to the dtype, row blocks then
      permuted for "arrival".

At n = 1 without `force_kernel` the call is a local product (plus
silu_mul for the pair), as the JAX function short-circuits to XLA; with
`force_kernel` the kernel runs with n = 1. The TPU's VMEM-budget and
interpret-mode fallbacks do not carry over: on the card the kernel
always runs. The grouped (MoE) form, quantized wire formats and an
`out_dtype` other than the input's are not ported yet and raise.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "ag_gemm_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]),
    "ag_gemm_flag_count": (ctypes.c_int, [ctypes.c_int]),
    "ag_gemm_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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


def _check(a, b, out_dtype, epilogue, c_order, return_gathered,
           wire_format):
    """Raise on what is not ported or not a valid call; returns the
    weights as a tuple (one, or the silu_pair's two)."""
    if wire_format is not None:
        raise NotImplementedError(
            f"wire_format={wire_format!r}: quantized wire images come with "
            "the wire/ slice")
    if out_dtype is not None and out_dtype != a.dtype:
        raise NotImplementedError(
            f"out_dtype={out_dtype}: an output dtype other than the "
            "input's is not ported")
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
    if any(w.dim() == 4 for w in bs):
        raise NotImplementedError(
            "a per-expert (n, E, K, N) b is the grouped MoE form: it comes "
            "with the MoE/EP slice")
    if a.dim() != 3 or bs[0].dim() != 3 or bs[0].shape[:2] != (a.shape[0],
                                                               a.shape[2]):
        raise ValueError(f"a (n, m, K) and b (n, K, N) expected, got "
                         f"{tuple(a.shape)} and {tuple(bs[0].shape)}")
    return bs


def ag_gemm_plain(a: torch.Tensor, b, epilogue=None, c_order: str = "rank",
                  return_gathered: bool = False):
    """Every rank's gathered A times its b in f32, one rounding; row
    blocks permuted for c_order="arrival"."""
    n, m, k = a.shape
    full = a.reshape(n * m, k)
    if epilogue == "silu_pair":
        g, u = (torch.matmul(full.float(), w.float()) for w in b)
        c = silu_mul(g, u).to(a.dtype)
    else:
        c = torch.matmul(full.float(), b.float()).to(a.dtype)
    if c_order == "arrival":
        c = arrival_to_rank_order(c)
    if return_gathered:
        return c, full.expand(n, n * m, k).contiguous()
    return c


def _local(a, bs, return_gathered):
    """n = 1: the local product, f32 accumulation rounded once to
    a.dtype; for the pair, gate and up kept in f32 through silu_mul."""
    if len(bs) == 2:
        from triton_dist_tpu_torch.layers.linear import dot_f32

        c = silu_mul(dot_f32(a, bs[0]), dot_f32(a, bs[1])).to(a.dtype)
    else:
        c = torch.matmul(a, bs[0])
    return (c, a) if return_gathered else c


@_build.counted("ag_gemm")
def ag_gemm(a: torch.Tensor, b, return_gathered: bool = False,
            out_dtype=None, force_kernel: bool = False, epilogue=None,
            c_order: str = "rank", wire_format=None):
    """a (n, m, K), b (n, K, N) or (w_gate, w_up) rank-stacked ->
    C (n, n*m, N) (and the gathered A (n, n*m, K) with
    return_gathered): the CUDA kernel on CUDA tensors (launched or
    raising, never replaced), the plain version on CPU tensors; at n = 1
    a local product unless force_kernel."""
    bs = _check(a, b, out_dtype, epilogue, c_order, return_gathered,
                wire_format)
    if a.shape[0] == 1 and not force_kernel:
        return _local(a, bs, return_gathered)
    if a.device.type == "cpu":
        return ag_gemm_plain(a, b, epilogue, c_order, return_gathered)
    return _launch(a, bs, c_order == "arrival", return_gathered)


def _launch(a: torch.Tensor, bs, arrival: bool, return_gathered: bool):
    if a.device.type != "cuda" or any(w.device != a.device for w in bs):
        raise ValueError(f"the ag_gemm kernel needs CUDA tensors on one "
                         f"device, got {a.device} and "
                         f"{[str(w.device) for w in bs]}")
    if a.dtype not in _DTYPE_CODE or any(w.dtype != a.dtype for w in bs):
        raise ValueError(f"dtypes {a.dtype}/{[w.dtype for w in bs]}: the "
                         "kernel takes float32 or bfloat16, all alike")
    n, m, K = a.shape
    N = bs[0].shape[2]
    per = 16 // a.element_size()
    if K % per or N % per:
        raise ValueError(f"K={K} and N={N} must be multiples of {per}: the "
                         "kernel moves 16-byte rows")
    for name, x in (("a", a), *(("b", w) for w in bs)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    world = VirtualWorld.of(a)
    c = torch.empty((n, n * m, N), dtype=a.dtype, device=a.device)
    ws = world.heap((n * m, K), a.dtype)  # [rank][chunk c's rows]
    if c.numel() == 0:
        return (c, ws) if return_gathered else c
    lib = _build.load("allgather_gemm", _SIGNATURES)
    flags = world.flags(lib.ag_gemm_flag_count(n))
    grid = _build.GridInfo()
    with torch.cuda.device(a.device):
        err = lib.ag_gemm_launch(
            a.data_ptr(), bs[0].data_ptr(), bs[-1].data_ptr(),
            ws.data_ptr(), c.data_ptr(), flags.data_ptr(), n, m, K, N,
            _DTYPE_CODE[a.dtype], int(len(bs) == 2), int(arrival),
            grid.ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("ag_gemm", err, lib.ag_gemm_error_string, grid)
    _build.count_launch("ag_gemm")
    return (c, ws) if return_gathered else c

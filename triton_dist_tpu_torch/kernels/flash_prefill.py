"""Flash prefill — port of triton_dist_tpu.kernels.flash_prefill: the
local kernel (`flash_prefill_local`, the Pallas `_fp_local_kernel`) and
the sequence-parallel one (`sp_flash_prefill`, the Pallas
`_fp_sp_kernel`), with `flash_prefill_ref` and the `sp_prefill_attention`
switch.

Local: GQA prefill attention over local KV with general `q_positions` /
`kv_len` masking, the serve plane's multi-token chunks and long-context
prefill alike. Shapes: q (B, S, Hq, D), k/v (B, T, Hkv, D), Hq = G * Hkv;
returns (B, S, Hq, D) in q.dtype. Key t is live for (b, s) when t <
kv_len[b] and, if causal, t <= q_positions[b, s].

  flash_prefill_local — the hand-written CUDA kernel
      (csrc/flash_prefill.cu). Launches on a CUDA tensor, or raises; on
      a CPU tensor it computes the plain version (no kernel exists
      there), which is the only case it does so.
  flash_prefill_plain — dense masked softmax in f32, rows with no live
      key set to 0: the reference the kernel is held to, and the CPU
      path the tests run.

SP: the sequence sharded over the n ranks of the virtual world, rank r
holding query and KV rows [r*S, (r+1)*S) of every batch row; the tensors
are rank-stacked, q (n, B, S, Hq, D), k/v (n, B, S, Hkv, D), kv_len (B,)
the GLOBAL valid length; returns (n, B, S, Hq, D), each rank's queries
attended over the whole sequence.

  sp_flash_prefill — the hand-written CUDA kernel (fp_sp_launch in
      csrc/flash_prefill.cu): one cooperative launch over all ranks that
      pushes each rank's K/V segments to every peer with a delivery flag
      per (tensor, offset, row) and folds the local segment first, then
      each remote one once its flags count every pushing block, in the
      JAX kernel's swizzle order. Bitwise the same whatever the arrival
      timing (`straggler`). At n = 1 it is flash_prefill_local, as the
      JAX function dispatches.
  flash_prefill_ref — the plain version: the gathered K/V folded page by
      page in the same swizzle order with the JAX kernel's block update,
      in f32. The JAX kernel is bitwise its flash_prefill_ref; the CUDA
      kernel folds 64-key tiles on the tensor cores, so it is held to
      this one within the epsilon band. It takes q_positions, so a
      subset of query rows is well defined (the card's check of a 32k
      prefill samples rows: the dense logits would not fit).
  sp_prefill_attention — impl "flash" (sp_flash_prefill) or "ring"
      (kernels/sp_attention.ring_attention). "auto" needs the JAX
      package's perf_model.choose_sp_prefill_impl, which waits for the
      port of plan/; until then it raises rather than pick silently.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

NEG_INF = -1e30

_SUPPORTED_D = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "fp_local_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                ctypes.c_void_p]),
    "fp_sp_launch": (ctypes.c_int, [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_void_p,
                                             ctypes.c_void_p]),
    "fp_sp_flag_words": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "fp_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# pushing blocks a rank in the SP kernel: enough to keep the segment
# copies near the card's copy rate while the rest fold local work
_SP_PRODUCERS = 8


def supports_flash_prefill(hq: int, hkv: int, d: int) -> bool:
    """Shapes the CUDA kernel takes: head_dim 64 or 128 (a template
    parameter) and an integral GQA group. Any S and T."""
    return d in _SUPPORTED_D and hkv > 0 and hq % hkv == 0


def fit_block(t: int) -> int:
    """The CUDA kernel's KV tile height on its bf16 path: 64 keys (the
    f32 path folds 32 at a time). The kernel masks the ragged edge
    itself, so unlike the TPU kernel's page fitting the tile does not
    depend on T."""
    return 64


def _normalize(q, k, q_positions, q_offset, kv_len):
    b, s = q.shape[:2]
    t = k.shape[1]
    if q_positions is None:
        q_positions = (torch.arange(s, device=q.device)[None, :]
                       + q_offset).expand(b, s)
    if kv_len is None:
        kv_len = torch.full((b,), t, device=q.device)
    kv_len = torch.clamp(kv_len.reshape(-1), max=t)
    return q_positions, kv_len


def flash_prefill_plain(q, k, v, q_positions=None, q_offset=0, kv_len=None,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked softmax in f32; rows with no live key are 0."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    q_positions, kv_len = _normalize(q, k, q_positions, q_offset, kv_len)
    qg = (q.float() * scale).reshape(b, s, hkv, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    kpos = torch.arange(t, device=q.device)
    live = (kpos[None, :] < kv_len[:, None])[:, None, :]  # (B, 1, T)
    if causal:
        live = live & (kpos[None, None, :] <= q_positions[:, :, None])
    live = live[:, None, None]  # (B, 1, 1, S or 1, T)
    logits = torch.where(live, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(logits - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    p = torch.where(den > 0, p / den.clamp_min(1e-30), 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check(q, k, v, q_positions, kv_len):
    b, s, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    hkv = k.shape[2]
    if not supports_flash_prefill(hq, hkv, d):
        raise ValueError(f"unsupported shape Hq={hq} Hkv={hkv} D={d}: "
                         f"needs D in {_SUPPORTED_D} and Hq % Hkv == 0")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         "kernel takes float32 or bfloat16, all alike")
    for name, x in (("q", q), ("k", k), ("v", v),
                    ("q_positions", q_positions), ("kv_len", kv_len)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (cp.async)")
    if q_positions.shape != (b, s) or kv_len.shape != (b,):
        raise ValueError("q_positions must be (B, S) and kv_len (B,)")


@_build.counted("flash_prefill_local")
def flash_prefill_local(q, k, v, q_positions=None, q_offset=0, kv_len=None,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Flash prefill on q's device: the CUDA kernel for a CUDA tensor
    (launched or raising, never replaced), flash_prefill_plain for a
    CPU tensor, where no kernel exists."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_positions, q_offset, kv_len,
                                   causal, scale)
    return _launch(q, k, v, q_positions, q_offset, kv_len, causal, scale)


def _launch(q, k, v, q_positions, q_offset, kv_len, causal,
            scale) -> torch.Tensor:
    """Launch csrc/flash_prefill.cu on the current stream. Raises on a
    tensor that is not on a CUDA device and on any shape, dtype or
    layout the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash prefill kernel needs CUDA tensors, "
                         f"got {q.device}")
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    q_positions, kv_len = _normalize(q, k, q_positions, q_offset, kv_len)
    # the kernel ABI takes int32 positions and lengths
    q_positions = q_positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    _check(q, k, v, q_positions, kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_prefill", _SIGNATURES)
    scale = float(scale if scale is not None else d ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fp_local_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), b, s, t, hq, hkv, d,
            _DTYPE_CODE[q.dtype], int(causal), scale, stream)
    if err != 0:
        raise RuntimeError("flash_prefill_local launch failed: "
                           + lib.fp_error_string(err).decode())
    _build.count_launch("flash_prefill_local")
    return out


# -- sequence-parallel -------------------------------------------------------


def _page(t: int, block: Optional[int] = None) -> int:
    """The JAX kernels' page height (flash_decode._fd_chunk through
    fit_block): the largest divisor of t that is a multiple of 8 and at
    most `block` (512 by default), or t when none is."""
    cap = int(block) if block else 512
    cands = [c for c in range(8, min(cap, t) + 1, 8) if t % c == 0]
    return cands[-1] if cands else t


def _check_sp(q, k, v, kv_len):
    if q.dim() != 5 or k.dim() != 5 or k.shape != v.shape \
            or k.shape[:3] != q.shape[:3] or k.shape[4] != q.shape[4]:
        raise ValueError(f"q {tuple(q.shape)}, k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)}: rank-stacked (n, B, S, H, D) "
                         "with one S")
    if kv_len is not None and kv_len.shape != (q.shape[1],):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} must be (B,)")


def flash_prefill_ref(q, k, v, causal: bool = True,
                      scale: Optional[float] = None, kv_len=None,
                      block: Optional[int] = None,
                      q_positions=None) -> torch.Tensor:
    """Plain SP prefill: every rank folds the gathered K/V segment by
    segment in the swizzle order (its own chunk, then chunk (r - i) mod
    n), page by page (`_page(S, block)` keys), with the JAX kernel's
    block update in f32 (`_head_update`: masked logits, running max,
    alpha, p, l, acc), then acc / l, rows with no live key 0.

    q (n, B, Sq, Hq, D); k/v (n, B, S, Hkv, D); kv_len (B,) global.
    q_positions: (n, B, Sq) global positions of q's rows; by default
    Sq = S and rank r's rows are r*S + arange(S)."""
    n, b, s = k.shape[:3]
    sq, hq, d = q.shape[2:]
    hkv = k.shape[3]
    g = hq // hkv
    dev = q.device
    scale = float(scale if scale is not None else d ** -0.5)
    blk = _page(s, block)
    if kv_len is None:
        kv_len = torch.full((b,), n * s, device=dev)
    kv_len = kv_len.reshape(-1).to(dev)
    if q_positions is None:
        if sq != s:
            raise ValueError("q_positions is needed for a subset of rows")
        q_positions = (torch.arange(n, device=dev)[:, None, None] * s
                       + torch.arange(s, device=dev)).expand(n, b, s)
    qp = q_positions.to(dev)[:, :, None, None, :, None]  # (n,B,1,1,Sq,1)
    # (n, B, Hkv, G, Sq, D), pre-scaled as the JAX slabs are
    qs = (q.float() * scale).reshape(n, b, sq, hkv, g, d).permute(
        0, 1, 3, 4, 2, 5)
    m = torch.full((n, b, hkv, g, sq, 1), NEG_INF, device=dev)
    lsum = torch.zeros((n, b, hkv, g, sq, 1), device=dev)
    acc = torch.zeros((n, b, hkv, g, sq, d), device=dev)
    ranks = torch.arange(n, device=dev)
    for i in range(n):
        chunk = (ranks - i) % n  # (n,) the chunk rank r folds at step i
        kseg = k[chunk].float()  # (n, B, S, Hkv, D)
        vseg = v[chunk].float()
        for j in range(s // blk):
            kp = kseg[:, :, j * blk:(j + 1) * blk].permute(0, 1, 3, 2, 4)
            vp = vseg[:, :, j * blk:(j + 1) * blk].permute(0, 1, 3, 2, 4)
            kpos = (chunk[:, None] * s + j * blk
                    + torch.arange(blk, device=dev))  # (n, blk)
            kpos = kpos[:, None, None, None, None, :]
            live = kpos < kv_len[None, :, None, None, None, None]
            if causal:
                live = live & (kpos <= qp)
            lg = torch.einsum("nbkgsd,nbktd->nbkgst", qs, kp)
            lg = torch.where(live, lg, NEG_INF)
            m_new = torch.maximum(m, lg.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(lg - m_new), 0.0)
            lsum = lsum * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("nbkgst,nbktd->nbkgsd", p, vp)
            m = m_new
    out = torch.where(lsum > 0, acc / lsum.clamp_min(1e-30), 0.0)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(n, b, sq, hq, d).to(
        q.dtype)


@_build.counted("sp_flash_prefill")
def sp_flash_prefill(q, k, v, causal: bool = True,
                     scale: Optional[float] = None, kv_len=None,
                     block: Optional[int] = None,
                     straggler: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """SP flash prefill over the rank-stacked q (n, B, S, Hq, D), k/v
    (n, B, S, Hkv, D): the CUDA kernel on CUDA tensors (launched or
    raising, never replaced), flash_prefill_ref on CPU tensors; at n = 1
    flash_prefill_local. block: the plain version's page height (the
    kernel's tile is fixed). straggler: (rank, nanos), that rank's
    pushing blocks wait nanos ns first (the kernel; the plain version
    has no timing)."""
    _check_sp(q, k, v, kv_len)
    n, b, s = q.shape[:3]
    if n == 1:
        return flash_prefill_local(q[0], k[0], v[0], kv_len=kv_len,
                                   causal=causal, scale=scale)[None]
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, causal, scale, kv_len, block)
    return _launch_sp(q, k, v, causal, scale, kv_len, straggler)


def _launch_sp(q, k, v, causal, scale, kv_len, straggler) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"the SP flash prefill kernel needs CUDA tensors, "
                         f"got {q.device}")
    n, b, s, hq, d = q.shape
    hkv = k.shape[3]
    if kv_len is None:
        kv_len = torch.full((b,), n * s, device=q.device)
    kv_len = kv_len.reshape(-1).to(q.device, torch.int32).contiguous()
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    _check(q[0], k[0], v[0], torch.zeros((b, s), dtype=torch.int32,
                                         device=q.device), kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    world = VirtualWorld.of(q)
    lib = _build.load("flash_prefill", _SIGNATURES)
    kbuf = world.heap((n - 1, b, s, hkv, d), k.dtype)
    vbuf = world.heap((n - 1, b, s, hkv, d), v.dtype)
    flags = world.flags(lib.fp_sp_flag_words(n, b))
    rank, nanos = straggler if straggler is not None else (-1, 0)
    if not -1 <= int(rank) < n or int(nanos) < 0:
        raise ValueError(f"straggler {straggler}: (rank in [0, n), nanos "
                         ">= 0)")
    scale = float(scale if scale is not None else d ** -0.5)
    grid = _build.GridInfo()
    with torch.cuda.device(q.device):
        err = lib.fp_sp_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
            flags.data_ptr(), n, b, s, hq, hkv, d, _DTYPE_CODE[q.dtype],
            int(causal), scale, _SP_PRODUCERS, int(rank), int(nanos),
            grid.ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("sp_flash_prefill", err, lib.fp_error_string, grid)
    _build.count_launch("sp_flash_prefill")
    return out


def sp_prefill_attention(q, k, v, causal: bool = True,
                         scale: Optional[float] = None, kv_len=None,
                         impl: str = "auto") -> torch.Tensor:
    """SP prefill with the impl named: "flash" (sp_flash_prefill) or
    "ring" (sp_attention.ring_attention). "auto" raises: the JAX pick is
    perf_model.choose_sp_prefill_impl, not ported yet (plan/)."""
    if impl == "flash":
        return sp_flash_prefill(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len)
    if impl == "ring":
        from triton_dist_tpu_torch.kernels.sp_attention import (
            ring_attention,
        )

        return ring_attention(q, k, v, causal=causal, scale=scale,
                              kv_len=kv_len)
    if impl == "auto":
        raise NotImplementedError(
            "impl='auto' is the JAX package's perf-model pick "
            "(perf_model.choose_sp_prefill_impl), which comes with the "
            "port of plan/; name 'flash' or 'ring'")
    raise ValueError(f"unknown sp prefill impl {impl!r}")

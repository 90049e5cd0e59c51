"""Local flash prefill — port of triton_dist_tpu.kernels.flash_prefill
(`flash_prefill_local`, the Pallas kernel `_fp_local_kernel`).

GQA prefill attention over local KV with general `q_positions` /
`kv_len` masking: the serve plane's multi-token chunks and long-context
prefill alike. Two implementations of one contract:

  flash_prefill_local — the hand-written CUDA kernel
      (csrc/flash_prefill.cu). Launches on a CUDA tensor, or raises; on
      a CPU tensor it computes the plain version (no kernel exists
      there), which is the only case it does so.
  flash_prefill_plain — dense masked softmax in f32, rows with no live
      key set to 0: the reference the kernel is held to, and the CPU
      path the tests run.

Shapes: q (B, S, Hq, D), k/v (B, T, Hkv, D), Hq = G * Hkv; returns
(B, S, Hq, D) in q.dtype. Key t is live for (b, s) when t < kv_len[b]
and, if causal, t <= q_positions[b, s].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _build

NEG_INF = -1e30

_SUPPORTED_D = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "fp_local_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                ctypes.c_void_p]),
    "fp_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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

"""Distributed flash decode — port of triton_dist_tpu.kernels.flash_decode
(`flash_decode_partial`, `flash_decode_partial_pallas` with the Pallas
kernel `_fd_partial_kernel`, `flash_decode_combine`,
`partials_buf_shape`, `create_sp_decode_buf`, `sp_flash_decode`).

The KV cache shards by sequence over the ranks of the virtual world:
rank r owns global positions [r*T_loc, (r+1)*T_loc). Each rank computes
a masked partial decode over its shard, (o normalised by the local sum,
lse per (row, head)); the partials are exchanged, by default through the
low-latency AllGather on a persistent context, and merged with the
online-softmax combine.

  flash_decode_partial — the plain version: the JAX formula in f32
      (einsum, masked max, exp, sum), the reference the kernel is held
      to and the "xla" partial_impl.
  flash_decode_partial_cuda — the hand-written CUDA kernel
      (csrc/flash_decode.cu), counted as "flash_decode_partial": split-KV
      over blocks and merged in the kernel. Launches on a CUDA tensor,
      or raises; on a CPU tensor it computes the plain version.
  flash_decode_combine — the cross-rank merge in torch (XLA code in the
      JAX package), the ranks added one by one in rank order, so two
      callers with the same bytes get the same bits.

Rank-stacked: q (n, B, Hq, D) (each rank's copy; the JAX q is replicated),
cache shards (n, B, T_loc, Hkv, D), kv_len (B,) global; partials
(n, B, Hq, D) and (n, B, Hq); the result (n, B, Hq, D), each rank's copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.low_latency_allgather import (
    create_ll_ag_buffer,
    ll_all_gather,
)
from triton_dist_tpu_torch.runtime.symm_mem import SymmetricContext

NEG_INF = -1e30

_SUPPORTED_D = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# keys a block folds: 8 tiles of 64; a 8192-key shard is 16 blocks a
# (row, kv head), 2048 blocks at batch 4 on 4 ranks with 8 kv heads
_SPLIT_KEYS = 512
_MAX_GROUP_WIDTH = 1024  # G * D: the kernel's outputs a block (128 x 8)
_SIGNATURES = {
    "fd_partial_launch": (ctypes.c_int, [ctypes.c_void_p] * 8
                          + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                  ctypes.c_void_p]),
    "fd_part_floats": (ctypes.c_longlong, [ctypes.c_int] * 6),
    "fd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_decode_partial(q, k_loc, v_loc, valid_len,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial attention over one shard: q (B, Hq, D), k/v (B, T_loc,
    Hkv, D), valid_len (B,) -> (o (B, Hq, D) f32 normalised by the local
    sum, lse (B, Hq) f32); a row with no valid key gives 0 and NEG_INF."""
    b, hq, d = q.shape
    t, hkv = k_loc.shape[1], k_loc.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    qf = q.float().reshape(b, hkv, g, d) * scale
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_loc.float())
    mask = (torch.arange(t, device=q.device)[None, :]
            < valid_len.reshape(-1, 1).to(q.device))  # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = m.clamp_min(NEG_INF / 2)
    empty = m <= NEG_INF / 2
    p = torch.where(empty, 0.0, torch.exp(s - safe_m))
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_loc.float()) \
        / lsum.clamp_min(1e-30)
    lse = (safe_m + torch.log(lsum.clamp_min(1e-30)))[..., 0]
    lse = torch.where(empty[..., 0], NEG_INF, lse)
    return o.reshape(b, hq, d), lse.reshape(b, hq)


@_build.counted("flash_decode_partial")
def flash_decode_partial_cuda(q, k_loc, v_loc, valid_len,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flash_decode_partial's contract on q's device: the CUDA kernel for
    CUDA tensors (launched or raising, never replaced: a shape the kernel
    does not take raises), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_decode_partial(q, k_loc, v_loc, valid_len, scale)
    return _launch(q, k_loc, v_loc, valid_len, scale)


def _launch(q, k, v, valid_len, scale):
    if q.device.type != "cuda":
        raise ValueError(f"the flash decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if not (d in _SUPPORTED_D and hkv > 0 and hq % hkv == 0
            and hq // hkv * d <= _MAX_GROUP_WIDTH):
        raise ValueError(f"unsupported shape Hq={hq} Hkv={hkv} D={d}: "
                         f"needs D in {_SUPPORTED_D}, Hq % Hkv == 0 and "
                         f"G * D <= {_MAX_GROUP_WIDTH}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         "kernel takes float32 or bfloat16, all alike")
    valid = valid_len.reshape(-1).to(q.device, torch.int32).contiguous()
    if valid.shape != (b,):
        raise ValueError(f"valid_len {tuple(valid_len.shape)} must be (B,)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on {q.device}")
    o = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        o.zero_()
        lse.fill_(NEG_INF)
        return o, lse
    lib = _build.load("flash_decode", _SIGNATURES)
    part = torch.empty((lib.fd_part_floats(b, t, hq, hkv, d, _SPLIT_KEYS),),
                       dtype=torch.float32, device=q.device)
    count = torch.zeros((b * hkv,), dtype=torch.int32, device=q.device)
    scale = float(scale if scale is not None else d ** -0.5)
    with torch.cuda.device(q.device):
        err = lib.fd_partial_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            part.data_ptr(), count.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, t, hq, hkv, d, _DTYPE_CODE[q.dtype], _SPLIT_KEYS, scale,
            torch.cuda.current_stream().cuda_stream)
    _build.check("flash_decode_partial", err, lib.fd_error_string)
    _build.count_launch("flash_decode_partial")
    return o, lse


def flash_decode_combine(o_parts: torch.Tensor,
                         lse_parts: torch.Tensor) -> torch.Tensor:
    """Online-softmax merge over the leading (source rank) dim:
    o_parts (n, ..., Hq, D) f32, lse_parts (n, ..., Hq) f32 ->
    (..., Hq, D): sum_i w_i o_i / sum_i w_i, w_i = exp(lse_i - max lse),
    a NEG_INF partial weighing 0; the ranks added in rank order."""
    lse_max = lse_parts.amax(dim=0)
    safe = lse_max.clamp_min(NEG_INF / 2)
    w = torch.where(lse_parts <= NEG_INF / 2, 0.0,
                    torch.exp(lse_parts - safe))
    denom = w[0]
    out = w[0][..., None] * o_parts[0]
    for i in range(1, o_parts.shape[0]):
        denom = denom + w[i]
        out = out + w[i][..., None] * o_parts[i]
    return out / denom.clamp_min(1e-30)[..., None]


def partials_buf_shape(b: int, hq: int, d: int) -> Tuple[int, int]:
    """One rank's payload of the packed (o, lse) exchange: (B, Hq*D + Hq
    rounded up to 128) f32."""
    return (b, round_up(hq * d + hq, 128))


def create_sp_decode_buf(b: int, hq: int, d: int, n: int,
                         device=None) -> SymmetricContext:
    """A fresh LL context for sp_flash_decode's partial exchange (the
    reference layer's FastAllGatherContext); thread it through decode
    steps with call_count 0, 1, 2, ..."""
    return create_ll_ag_buffer(partials_buf_shape(b, hq, d), torch.float32,
                               n, device=device)


def _partials(q, k_shard, v_shard, local_len, scale, partial_impl):
    n, b = q.shape[:2]
    args = (q.reshape(n * b, *q.shape[2:]),
            k_shard.reshape(n * b, *k_shard.shape[2:]),
            v_shard.reshape(n * b, *v_shard.shape[2:]),
            local_len.reshape(n * b))
    hq, d = q.shape[2:]
    if partial_impl in ("auto", "pallas"):
        o, lse = flash_decode_partial_cuda(*args, scale=scale)
    elif partial_impl == "xla":
        o, lse = flash_decode_partial(*args, scale=scale)
    else:
        raise ValueError(f"partial_impl={partial_impl!r}: one of 'auto', "
                         "'pallas' (the CUDA kernel), 'xla' (torch)")
    return o.reshape(n, b, hq, d), lse.reshape(n, b, hq)


def sp_flash_decode(q: torch.Tensor, k_shard: torch.Tensor,
                    v_shard: torch.Tensor, kv_len: torch.Tensor,
                    scale: Optional[float] = None,
                    ll_buf: Optional[SymmetricContext] = None,
                    call_count: int = 0, partial_impl: str = "auto"):
    """Decode over a sequence-sharded cache: q (n, B, Hq, D), shards
    (n, B, T_loc, Hkv, D), kv_len (B,) the GLOBAL valid length; returns
    (n, B, Hq, D) in q.dtype, every rank's copy alike.

    ll_buf: an LL context from create_sp_decode_buf; the packed (o, lse)
    partials then ride one ll_all_gather (call_count: the 0-based step on
    that context) and the call returns (out, ll_buf). Without it the
    packed partials are gathered by a torch copy; either way the same
    combine runs on the same bytes.
    partial_impl: "auto" or "pallas" (the JAX name): the kernel's
    wrapper, so the CUDA kernel on a CUDA tensor (a shape it does not
    take raises) and the plain version on the CPU; "xla": the torch
    einsum, only when asked for."""
    n, b, hq, d = q.shape
    t_loc = k_shard.shape[2]
    ranks = torch.arange(n, device=q.device)[:, None]
    local_len = (kv_len.to(q.device)[None, :] - ranks * t_loc).clamp(
        0, t_loc)
    o, lse = _partials(q, k_shard, v_shard, local_len, scale, partial_impl)
    wp = partials_buf_shape(b, hq, d)[1]
    payload = torch.nn.functional.pad(
        torch.cat([o.reshape(n, b, hq * d), lse], dim=-1),
        (0, wp - hq * d - hq))
    if ll_buf is not None:
        gathered, ll_buf = ll_all_gather(payload, ll_buf, call_count)
    else:
        gathered = payload[None].expand(n, *payload.shape).contiguous()
    # gathered (n ranks, n sources, B, Wp): combine over the sources
    parts = gathered.transpose(0, 1)
    o_parts = parts[..., :hq * d].reshape(n, n, b, hq, d)
    out = flash_decode_combine(o_parts, parts[..., hq * d:hq * d + hq])
    out = out.to(q.dtype)
    return (out, ll_buf) if ll_buf is not None else out

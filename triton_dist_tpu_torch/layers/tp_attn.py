"""Attention block — port of triton_dist_tpu.layers.tp_attn at world 1.

At world 1 every TP mode of the JAX package is the same computation:
QKV projection, per-head qk-norm, rope, attention over the cache, O
projection (gemm_ar is a local product there). This is `tp_attn_ar_fwd`
with the collective legs gone.

Weight layout (the JAX layout with the tp dim dropped):
  w_qkv (hidden, (Hq + 2*Hkv) * D) — q then k then v column blocks
  w_o   (Hq * D, hidden)
  q_norm, k_norm (D,) — per-head rmsnorm weights (Qwen3), or None
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triton_dist_tpu_torch.layers.attention import gqa_attention
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.rope import apply_rope


class TPAttnParams(NamedTuple):
    w_qkv: torch.Tensor
    w_o: torch.Tensor
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None


class TPAttnSpec(NamedTuple):
    num_q_heads: int
    num_kv_heads: int
    head_dim: int


class KVWrite(NamedTuple):
    """Where a step's K/V rows land in a (B, T, Hkv, D) cache layer:
    `rows` selects rows of the flattened (B*S) step, `dst` their flat
    (B*T) cache rows. Rows whose position lies past T are left out, as
    the JAX scatter drops out-of-bounds updates (a serve chunk's padding
    columns near the horizon)."""

    rows: torch.Tensor
    dst: torch.Tensor

    @staticmethod
    def at(positions: torch.Tensor, t: int) -> "KVWrite":
        b = positions.shape[0]
        bidx = torch.arange(b, device=positions.device)[:, None]
        flat = (bidx * t + positions).reshape(-1)
        rows = (positions < t).reshape(-1).nonzero().squeeze(1)
        return KVWrite(rows, flat[rows])


def _split_qkv(h, spec: TPAttnSpec, batch: int):
    """(M, (Hq+2Hkv)*D) -> q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    s = h.shape[0] // batch
    hq, hkv, d = spec.num_q_heads, spec.num_kv_heads, spec.head_dim
    q, k, v = torch.split(h, [hq * d, hkv * d, hkv * d], dim=-1)
    return (q.reshape(batch, s, hq, d), k.reshape(batch, s, hkv, d),
            v.reshape(batch, s, hkv, d))


def _qk_norm_rope(q, k, params: TPAttnParams, cos, sin, positions):
    if params.q_norm is not None:
        q = rms_norm(q, params.q_norm)
    if params.k_norm is not None:
        k = rms_norm(k, params.k_norm)
    return (apply_rope(q, cos, sin, positions),
            apply_rope(k, cos, sin, positions))


def _scatter_kv(cache: torch.Tensor, kv: torch.Tensor,
                write: KVWrite) -> None:
    """cache (B, T, H, D) <- kv (B, S, H, D) at write's rows, in place."""
    b, t, h, d = cache.shape
    src = kv.reshape(-1, h, d).index_select(0, write.rows)
    cache.view(b * t, h, d).index_copy_(0, write.dst, src.to(cache.dtype))


def _attn_core(qkv, params, spec, batch, cos, sin, positions, kv_cache,
               kv_len, kv_write: Optional[KVWrite]):
    """Split + qk-norm + rope + attention. With a cache, this step's K/V
    rows are written into it (in place) at `kv_write` first, then q
    attends causally by absolute position: one path for single-token
    decode and multi-token prefill into the cache.
    Returns attn_out (M, Hq*D)."""
    q, k, v = _split_qkv(qkv, spec, batch)
    q, k = _qk_norm_rope(q, k, params, cos, sin, positions)
    if kv_cache is None:
        out = gqa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        if kv_len is None or kv_write is None:
            raise ValueError("a kv cache needs kv_len (or attention reads "
                             "the cache's unwritten tail) and kv_write")
        k_cache, v_cache = kv_cache
        _scatter_kv(k_cache, k, kv_write)
        _scatter_kv(v_cache, v, kv_write)
        out = gqa_attention(q.contiguous(), k_cache, v_cache, causal=True,
                            q_positions=positions, kv_len=kv_len)
    return out.reshape(-1, spec.num_q_heads * spec.head_dim)


def tp_attn_fwd(x, params: TPAttnParams, spec: TPAttnSpec, cos, sin,
                positions, batch: int, kv_cache=None, kv_len=None,
                kv_write: Optional[KVWrite] = None) -> torch.Tensor:
    """x (M, hidden) -> (M, hidden): local QKV product cast to x.dtype,
    attention, O product cast to x.dtype (the JAX `ar` mode's cast
    points, tp_attn.py:168-169 and gemm_ar's world-1 product)."""
    qkv = x @ params.w_qkv
    out = _attn_core(qkv, params, spec, batch, cos, sin, positions,
                     kv_cache, kv_len, kv_write)
    return out @ params.w_o

"""Attention block — port of triton_dist_tpu.layers.tp_attn, the `ar`
form (`tp_attn_ar_fwd`) over the virtual world.

Heads shard over the n ranks (Hq/n query and Hkv/n kv heads a rank, the
spec below is per rank). Each rank holds a replica of the activations:
x (n, M, hidden) rank-stacked. Per rank: QKV product, per-head qk-norm,
rope, attention over the rank's kv heads, then the O projection through
`gemm_ar`, which all-reduces the ranks' partial sums (a local product at
world 1). In the attention the ranks are extra batch rows: rank r's
batch row b is row r*B + b of q, of the cache and of `positions` /
`kv_len`, so one flash-prefill launch covers every rank.

Weight layout (the JAX layout, rank dim kept):
  w_qkv (n, hidden, (Hq + 2*Hkv)/n * D) — q then k then v column blocks
  w_o   (n, Hq/n * D, hidden)
  q_norm, k_norm (D,) — per-head rmsnorm weights (Qwen3), or None
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar
from triton_dist_tpu_torch.layers.attention import gqa_attention
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.rope import apply_rope
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class TPAttnParams(NamedTuple):
    w_qkv: torch.Tensor
    w_o: torch.Tensor
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None


class TPAttnSpec(NamedTuple):
    """Static per-rank head geometry."""

    num_q_heads: int  # per rank
    num_kv_heads: int  # per rank
    head_dim: int


class KVWrite(NamedTuple):
    """Where a step's K/V rows land in a (R, T, Hkv, D) cache layer (R
    rank rows): `rows` selects rows of the flattened (R*S) step, `dst`
    their flat (R*T) cache rows. Rows whose position lies past T are
    left out, as the JAX scatter drops out-of-bounds updates (a serve
    chunk's padding columns near the horizon)."""

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
    """(R*S, (Hq+2Hkv)*D) -> q (R, S, Hq, D), k/v (R, S, Hkv, D)."""
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
    """cache (R, T, H, D) <- kv (R, S, H, D) at write's rows, in place."""
    b, t, h, d = cache.shape
    src = kv.reshape(-1, h, d).index_select(0, write.rows)
    cache.view(b * t, h, d).index_copy_(0, write.dst, src.to(cache.dtype))


def _attn_core(qkv, params, spec, rows, cos, sin, positions, kv_cache,
               kv_len, kv_write: Optional[KVWrite]):
    """Split + qk-norm + rope + attention over `rows` rank rows. With a
    cache, this step's K/V rows are written into it (in place) at
    `kv_write` first, then q attends causally by absolute position: one
    path for single-token decode and multi-token prefill into the cache.
    Returns attn_out (rows*S, Hq*D)."""
    q, k, v = _split_qkv(qkv, spec, rows)
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
                positions, batch: int, world: VirtualWorld, kv_cache=None,
                kv_len=None, kv_write: Optional[KVWrite] = None
                ) -> torch.Tensor:
    """x (n, M, hidden) -> (n, M, hidden), M = batch * S: local QKV
    product cast to x.dtype, attention, O projection through gemm_ar (the
    JAX `ar` mode's cast points, tp_attn.py:168-173). positions (n*B, S)
    and kv_len (n*B,) are given per rank row; kv_cache is (k, v), each
    (n*B, T, Hkv/n, D)."""
    n, m, _ = x.shape
    qkv = torch.matmul(x, params.w_qkv).reshape(n * m, -1)
    out = _attn_core(qkv, params, spec, n * batch, cos, sin, positions,
                     kv_cache, kv_len, kv_write)
    return gemm_ar(out.reshape(n, m, -1), params.w_o, world)

"""Attention block — port of triton_dist_tpu.layers.tp_attn over the
virtual world, in the JAX package's three modes (`MODES`,
`tp_attn_fwd(mode=)`):

  ar   — replicated input x (n, M, hidden): local QKV product cast to
         x.dtype, attention, O projection through `gemm_ar`, which
         all-reduces the ranks' partial sums (a local product at world 1;
         tp_attn.py:161-174);
  dist — sequence-sharded input x (n, M/n, hidden): ag_gemm gathers the
         rows and computes QKV in one kernel (rank order), attention,
         then gemm_rs reduce-scatters the O projection back to the shards
         (tp_attn.py:139-158);
  xla  — the same sharding with torch ops where the JAX package leaves
         them to XLA: all-gather, dot, attention, dot, psum_scatter (the
         plain versions of the ring all-gather and of gemm_rs's fold;
         tp_attn.py:121-136, the parity reference of `dist`).

Heads shard over the n ranks (Hq/n query and Hkv/n kv heads a rank, the
spec below is per rank). Per rank after the QKV product: per-head
qk-norm, rope, attention over the rank's kv heads, on all M rows in every
mode. In the attention the ranks are extra batch rows: rank r's batch
row b is row r*B + b of q, of the cache and of `positions` / `kv_len`,
so one flash-prefill launch covers every rank. The kernels are called
through their modules, so a caller can wrap them.

Weight layout (the JAX layout, rank dim kept):
  w_qkv (n, hidden, (Hq + 2*Hkv)/n * D) — q then k then v column blocks
  w_o   (n, Hq/n * D, hidden)
  q_norm, k_norm (D,) — per-head rmsnorm weights (Qwen3), or None
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triton_dist_tpu_torch.kernels import allgather as _ring
from triton_dist_tpu_torch.kernels import allgather_gemm as _ag
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as _rs
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar
from triton_dist_tpu_torch.layers.attention import gqa_attention
from triton_dist_tpu_torch.layers.linear import dot_f32
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
    rank rows), at a fixed shape: every row of the flattened (R*S) step
    has a flat (R*T) destination `dst`, and `keep` says whether it is
    written. Rows whose position lies past T are dropped, as the JAX
    scatter drops out-of-bounds updates (a serve chunk's padding columns
    near the horizon): such a row goes to cache row `position % T` of its
    rank row and writes back what that cell holds, so the cache is left
    bitwise as it was there. Those cells are free this step: a rank row
    writes the contiguous positions [p0, p0 + S), so its dropped rows
    (positions past T) map onto S distinct cells below p0, which no kept
    row writes, as long as S <= T. No row's destination decides another's
    write, and no host read or data-dependent shape is needed (a CUDA
    graph captures it)."""

    dst: torch.Tensor
    keep: torch.Tensor

    @staticmethod
    def at(positions: torch.Tensor, t: int) -> "KVWrite":
        """positions (R, S): each rank row's S contiguous positions."""
        b, s = positions.shape
        if s > t:
            raise ValueError(f"a step of {s} positions exceeds the cache "
                             f"horizon {t}")
        bidx = torch.arange(b, device=positions.device)[:, None]
        flat = (bidx * t + positions % t).reshape(-1)
        return KVWrite(flat, (positions < t).reshape(-1))


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
    """cache (R, T, H, D) <- kv (R, S, H, D) at write's kept rows, in
    place; a dropped row rewrites its destination's own value, read
    before the write."""
    b, t, h, d = cache.shape
    flat = cache.view(b * t, h, d)
    src = torch.where(write.keep[:, None, None],
                      kv.reshape(-1, h, d).to(cache.dtype),
                      flat.index_select(0, write.dst))
    flat.index_copy_(0, write.dst, src)


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


def tp_attn_ar_fwd(x, params: TPAttnParams, spec: TPAttnSpec, cos, sin,
                   positions, batch: int, world: VirtualWorld,
                   kv_cache=None, kv_len=None,
                   kv_write: Optional[KVWrite] = None) -> torch.Tensor:
    """x (n, M, hidden) replicated -> (n, M, hidden), M = batch * S."""
    n, m, _ = x.shape
    qkv = torch.matmul(x, params.w_qkv).reshape(n * m, -1)
    out = _attn_core(qkv, params, spec, n * batch, cos, sin, positions,
                     kv_cache, kv_len, kv_write)
    return gemm_ar(out.reshape(n, m, -1), params.w_o, world)


def tp_attn_dist_fwd(x, params: TPAttnParams, spec: TPAttnSpec, cos, sin,
                     positions, batch: int, world: VirtualWorld,
                     kv_cache=None, kv_len=None,
                     kv_write: Optional[KVWrite] = None) -> torch.Tensor:
    """x (n, M/n, hidden) sharded -> (n, M/n, hidden) sharded."""
    n, m, _ = x.shape
    qkv = _ag.ag_gemm(x, params.w_qkv)  # (n, M, qkv_loc), rank order
    out = _attn_core(qkv.reshape(n * n * m, -1), params, spec, n * batch,
                     cos, sin, positions, kv_cache, kv_len, kv_write)
    return _rs.gemm_rs(out.reshape(n, n * m, -1), params.w_o)


def tp_attn_xla_fwd(x, params: TPAttnParams, spec: TPAttnSpec, cos, sin,
                    positions, batch: int, world: VirtualWorld,
                    kv_cache=None, kv_len=None,
                    kv_write: Optional[KVWrite] = None) -> torch.Tensor:
    """x (n, M/n, hidden) sharded -> (n, M/n, hidden) sharded."""
    n, m, _ = x.shape
    qkv = dot_f32(_ring.ring_all_gather_plain(x), params.w_qkv).to(x.dtype)
    out = _attn_core(qkv.reshape(n * n * m, -1), params, spec, n * batch,
                     cos, sin, positions, kv_cache, kv_len, kv_write)
    partial = dot_f32(out.reshape(n, n * m, -1), params.w_o).to(x.dtype)
    return _rs.reduce_scatter_plain(partial)


MODES = {"xla": tp_attn_xla_fwd, "dist": tp_attn_dist_fwd,
         "ar": tp_attn_ar_fwd}


def tp_attn_fwd(x, params: TPAttnParams, spec: TPAttnSpec, cos, sin,
                positions, batch: int, world: VirtualWorld, kv_cache=None,
                kv_len=None, kv_write: Optional[KVWrite] = None,
                mode: str = "dist") -> torch.Tensor:
    """The block in `mode` (the JAX default "dist"); x is sharded (n,
    M/n, hidden) in "dist" and "xla", replicated (n, M, hidden) in "ar",
    M = batch * S, and so is the result. The JAX cast points are kept
    (QKV and O cast to x.dtype). positions (n*B, S) and kv_len (n*B,)
    are given per rank row; kv_cache is (k, v), each (n*B, T, Hkv/n, D),
    written in place at kv_write."""
    return MODES[mode](x, params, spec, cos, sin, positions, batch, world,
                       kv_cache=kv_cache, kv_len=kv_len, kv_write=kv_write)

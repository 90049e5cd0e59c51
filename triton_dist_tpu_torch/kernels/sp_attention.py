"""Sequence-parallel ring attention — port of triton_dist_tpu.kernels.
sp_attention (`_block_update`, `ring_attention`, `ring_attention_ref`).

The JAX ring rotates each rank's KV block to its right neighbour with
`lax.ppermute` (XLA code, no Pallas kernel) while every rank folds the
arriving block into its online-softmax state, its own block first. On
the virtual world the rotation is a roll of the rank dim, and the fold
is the same f32 torch arithmetic. It is the "ring" arm of
`kernels/flash_prefill.sp_prefill_attention`.

Rank-stacked: q (n, B, Sq, Hq, D), k/v (n, B, Skv, Hkv, D); rank r holds
query and KV rows [r*S, (r+1)*S); kv_len (B,) the GLOBAL valid length
(rows at or past it still attend the valid prefix; callers ignore them).
Returns (n, B, Sq, Hq, D) in q.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_update(q, k, v, q_pos, k_pos, acc, m, l, scale, causal,
                  kv_len=None):
    """Fold one KV block into the online-softmax state (f32).

    q (R, Sq, Hkv, G, D); k/v (R, Skv, Hkv, D); q_pos (R, Sq); k_pos
    (R, Skv); acc (R, Hkv, G, Sq, D); m, l (R, Hkv, G, Sq, 1); kv_len
    (R,) or None. R is any batch (the port folds the rank dim in)."""
    s = torch.einsum("bskgd,btkd->bkgst", q, k) * scale
    if causal:
        mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        s = torch.where(mask, s, NEG_INF)
    if kv_len is not None:
        valid = k_pos < kv_len.reshape(-1, 1)  # (R, Skv)
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m_blk = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    # a fully masked block: exp(NEG_INF - NEG_INF) would be 1
    dead = m_new <= NEG_INF / 2
    alpha = torch.where(dead, 1.0, torch.exp(m - m_new))
    p = torch.where(dead, 0.0, torch.exp(s - m_new))
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p, v)
    return acc_new, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SP GQA attention by the ring: at step i rank r folds chunk
    (r - i) mod n, its own at step 0; n - 1 rotations move n blocks."""
    n, b, sq, hq, d = q.shape
    skv, hkv = k.shape[2], k.shape[3]
    g = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    dev = q.device
    ranks = torch.arange(n, device=dev)
    qf = q.float().reshape(n * b, sq, hkv, g, d)
    q_pos = (ranks[:, None] * sq
             + torch.arange(sq, device=dev)).repeat_interleave(b, dim=0)
    kl = None if kv_len is None else kv_len.to(dev).repeat(n)
    acc = torch.zeros((n * b, hkv, g, sq, d), device=dev)
    m = torch.full((n * b, hkv, g, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((n * b, hkv, g, sq, 1), device=dev)
    k_cur, v_cur = k, v
    for step in range(n):
        chunk = (ranks - step) % n
        k_pos = (chunk[:, None] * skv
                 + torch.arange(skv, device=dev)).repeat_interleave(b, dim=0)
        acc, m, l = _block_update(
            qf, k_cur.float().reshape(n * b, skv, hkv, d),
            v_cur.float().reshape(n * b, skv, hkv, d), q_pos, k_pos, acc, m,
            l, scale, causal, kv_len=kl)
        if step < n - 1:  # the ppermute to the right neighbour
            k_cur = torch.roll(k_cur, 1, dims=0)
            v_cur = torch.roll(v_cur, 1, dims=0)
    out = acc / l.clamp_min(1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(n, b, sq, hq, d)
    return out.to(q.dtype)


def ring_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, scale: Optional[float] = None,
                       kv_len: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Unfused oracle: every rank attends the gathered KV with the dense
    masked softmax (kernels/flash_prefill.flash_prefill_plain)."""
    from triton_dist_tpu_torch.kernels.flash_prefill import (
        flash_prefill_plain,
    )

    n, b, sq = q.shape[:3]
    dev = q.device
    k_full = k.permute(1, 0, 2, 3, 4).reshape(b, -1, *k.shape[3:])
    v_full = v.permute(1, 0, 2, 3, 4).reshape(b, -1, *v.shape[3:])
    q_pos = (torch.arange(n, device=dev)[:, None] * sq
             + torch.arange(sq, device=dev)).repeat_interleave(b, dim=0)
    kl = None if kv_len is None else kv_len.to(dev).repeat(n)
    out = flash_prefill_plain(
        q.reshape(n * b, *q.shape[2:]),
        k_full.repeat(n, 1, 1, 1), v_full.repeat(n, 1, 1, 1),
        q_positions=q_pos, kv_len=kl, causal=causal, scale=scale)
    return out.reshape(q.shape)

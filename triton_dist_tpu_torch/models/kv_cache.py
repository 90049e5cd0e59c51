"""KV cache — port of triton_dist_tpu.models.kv_cache.

Shapes: k/v (L, B, T_max, Hkv, D), length (B,) int64. The JAX cache is
immutable and donated through each jit'd step; here `forward` writes a
step's K/V rows into the cache tensors in place and returns the cache
with its new length, which saves the copy of the whole cache per step.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, T_max, Hkv, D)
    v: torch.Tensor  # (L, B, T_max, Hkv, D)
    length: torch.Tensor  # (B,) valid entries per sequence

    @staticmethod
    def create(num_layers: int, batch: int, max_len: int,
               num_kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> "KVCache":
        shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int64, device=device),
        )

    @staticmethod
    def dense_view(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   table: torch.Tensor, lengths: torch.Tensor) -> "KVCache":
        """Dense (L, B, T, Hkv, D) copy of a paged pool: pool_k/pool_v are
        (L, Hkv, P, page, D) page pools and `table` (B, MAXP) maps each
        sequence's page grid onto pool pages. A pure gather, so values
        round-trip bitwise. Unallocated table entries point at page 0,
        the pool's null page; what they gather lies past each sequence's
        `lengths` and attention masks it."""
        L, hkv, _, page, d = pool_k.shape
        b, maxp = table.shape
        t = maxp * page

        def gather(pool):
            g = pool[:, :, table].reshape(L, hkv, b, t, d)
            return g.permute(0, 2, 3, 1, 4).contiguous()

        return KVCache(gather(pool_k), gather(pool_v), lengths)

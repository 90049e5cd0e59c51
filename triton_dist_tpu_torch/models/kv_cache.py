"""KV cache — port of triton_dist_tpu.models.kv_cache.

Shapes: k/v (L, n*B, T_max, Hkv/n, D), length (B,) int64. The JAX cache
is (L, B, T, Hkv, D) with the heads sharded over the n ranks
(dense.cache_specs); here each rank's heads are its own rows, rank r's
batch row b at row r*B + b, so the flash-prefill kernel sees the ranks
as extra batch rows without a copy. `jax_layout` converts back. At
world 1 the layout is the JAX one.

The JAX cache is immutable and donated through each jit'd step; here
`forward` writes a step's K/V rows into the cache tensors in place and
returns the cache with its new length, which saves the copy of the whole
cache per step.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, n*B, T_max, Hkv/n, D)
    v: torch.Tensor  # (L, n*B, T_max, Hkv/n, D)
    length: torch.Tensor  # (B,) valid entries per sequence

    @staticmethod
    def create(num_layers: int, batch: int, max_len: int,
               num_kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None, world: int = 1) -> "KVCache":
        """An empty cache of `batch` sequences whose num_kv_heads heads
        are split over `world` ranks, on the card unless `device` names
        another."""
        device = resolve_device(device)
        shape = (num_layers, world * batch, max_len, num_kv_heads // world,
                 head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int64, device=device),
        )

    def clone(self) -> "KVCache":
        """A copy of every tensor (a step on it leaves this one as is)."""
        return KVCache(self.k.clone(), self.v.clone(), self.length.clone())

    def jax_layout(self):
        """(k, v) in the JAX package's global layout (L, B, T, Hkv, D),
        rank r's heads at [r*Hkv/n, (r+1)*Hkv/n)."""

        def conv(x):
            L, nb, t, h, d = x.shape
            b = self.length.shape[0]
            return x.reshape(L, nb // b, b, t, h, d).permute(
                0, 2, 3, 1, 4, 5).reshape(L, b, t, nb // b * h, d)

        return conv(self.k), conv(self.v)

    @staticmethod
    def dense_view(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   table: torch.Tensor, lengths: torch.Tensor,
                   world: int = 1) -> "KVCache":
        """Dense (L, n*B, T, Hkv/n, D) copy of a paged pool: pool_k/pool_v
        are (L, Hkv, P, page, D) page pools, rank r's heads at
        [r*Hkv/n, (r+1)*Hkv/n), and `table` (B, MAXP) maps each
        sequence's page grid onto pool pages. A pure gather, so values
        round-trip bitwise. Unallocated table entries point at page 0,
        the pool's null page; what they gather lies past each sequence's
        `lengths` and attention masks it."""
        L, hkv, _, page, d = pool_k.shape
        b, maxp = table.shape
        t = maxp * page

        def gather(pool):
            g = pool[:, :, table].reshape(L, world, hkv // world, b, t, d)
            return g.permute(0, 1, 3, 4, 2, 5).reshape(
                L, world * b, t, hkv // world, d).contiguous()

        return KVCache(gather(pool_k), gather(pool_v), lengths)

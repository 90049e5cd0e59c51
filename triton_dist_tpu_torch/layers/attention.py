"""GQA attention core — port of triton_dist_tpu.layers.attention.

Shapes: q (B, S, Hq, D), k/v (B, T, Hkv, D), Hq = G * Hkv; softmax math
in f32; returns (B, S, Hq, D) in q.dtype. Routing:

  S > 1  — flash_prefill_local: the CUDA kernel on a CUDA tensor, its
           plain version on a CPU tensor. (The JAX package picks its
           Pallas kernel through the planner; the port has one kernel
           and always takes it.)
  S == 1 — dense masked softmax in plain torch: single-token decode,
           which the JAX package also leaves to its compiler.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import flash_prefill as _fp


def gqa_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention forward.

    q_offset: absolute position of q row 0 (decode: the cache length).
    q_positions: (B, S) absolute positions of the q rows; overrides
    q_offset. kv_len: (B,) valid KV prefix (masks the cache tail)."""
    if q.shape[1] > 1:
        return _fp.flash_prefill_local(q, k, v, q_positions=q_positions,
                                       q_offset=q_offset, kv_len=kv_len,
                                       causal=causal, scale=scale)
    return _fp.flash_prefill_plain(q, k, v, q_positions=q_positions,
                                   q_offset=q_offset, kv_len=kv_len,
                                   causal=causal, scale=scale)

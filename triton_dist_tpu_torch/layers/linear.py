"""The f32-result product of the dense model.

The JAX package writes every projection as `jnp.dot(a, b,
preferred_element_type=f32)`, then either casts the result to the
activation dtype (QKV, O, down: here `a @ b`, which accumulates in f32
and rounds once) or keeps it in f32 (gate/up, lm_head: here `dot_f32`).
Plain large products stay with torch, as the JAX package leaves them to
XLA; neither is a kernel of this repository.
"""

from __future__ import annotations

import torch


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) in float32, without an f32 copy of
    b: for bf16 on the card `torch.mm(..., out_dtype=torch.float32)`
    writes the f32 accumulator as it is."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        lead = a.shape[:-1]
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*lead, b.shape[-1])
    return torch.matmul(a.float(), b.float())

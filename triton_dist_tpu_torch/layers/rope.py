"""Rotary position embeddings — port of triton_dist_tpu.layers.rope.

Half-split convention (Llama/Qwen): (x1, x2) -> (x1*cos - x2*sin,
x2*cos + x1*sin). The (cos, sin) tables are f32 and gathered by
position, so prefill and decode share one path.
"""

from __future__ import annotations

import torch


def rope_table(head_dim: int, max_positions: int,
               theta: float = 1_000_000.0, device=None):
    """(cos, sin), each (max_positions, head_dim // 2) f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) / half
    inv_freq = 1.0 / (theta ** exponent)
    pos = torch.arange(max_positions, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv_freq)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, D) by the angles of positions (..., S).
    A position past the table reads its last row, as a JAX gather clamps
    (only a serve chunk's padding columns get there)."""
    half = x.shape[-1] // 2
    positions = positions.clamp(max=cos.shape[0] - 1)
    c = cos[positions].unsqueeze(-2)  # (..., S, 1, half)
    s = sin[positions].unsqueeze(-2)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)

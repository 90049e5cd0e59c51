"""RMSNorm — port of triton_dist_tpu.layers.norm.

Plain PyTorch: an elementwise chain that the JAX package also leaves to
its compiler. Same cast points: f32 math, result cast to x.dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """y = x / rms(x) * weight over the last axis, f32 math, x.dtype out.
    Qwen3's per-head qk-norm is the same call over head_dim."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)

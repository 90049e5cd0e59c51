"""Qwen3MoE — port of triton_dist_tpu.models.qwen_moe, the MoE model
family's entry points.

The MoE model shares the dense skeleton (models/dense.py: each layer's
MLP is the TP-MoE block when cfg.num_experts > 0), so the Engine, its
cache and the serve loop serve it unchanged. This module carries the
constructor with the Qwen3-30B-A3B default and the config dispatch.
"""

from __future__ import annotations

from typing import Optional

from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.engine import Engine


def qwen3_moe_engine(cfg: Optional[ModelConfig] = None, **kw) -> Engine:
    """An Engine for a Qwen3MoE model (default: the Qwen3-30B-A3B
    geometry); keyword arguments go to Engine (device, world, params,
    prefill_mode, decode_mode, ...)."""
    cfg = cfg or ModelConfig.qwen3_30b_a3b()
    if not cfg.is_moe:
        raise ValueError("qwen3_moe_engine requires an MoE config")
    return Engine(cfg, **kw)


def auto_engine(cfg: ModelConfig, **kw) -> Engine:
    """The Engine for any config: dense and MoE share it."""
    return Engine(cfg, **kw)

"""Layers of the dense model: norms, rope, GQA attention, and the
attention and MLP blocks at world 1."""

from triton_dist_tpu_torch.layers.attention import gqa_attention  # noqa: F401
from triton_dist_tpu_torch.layers.norm import rms_norm  # noqa: F401
from triton_dist_tpu_torch.layers.rope import apply_rope, rope_table  # noqa: F401
from triton_dist_tpu_torch.layers.tp_attn import (  # noqa: F401
    TPAttnParams,
    TPAttnSpec,
    tp_attn_fwd,
)
from triton_dist_tpu_torch.layers.tp_mlp import TPMLPParams, tp_mlp_fwd  # noqa: F401

"""Layers of the Qwen3 models: norms, rope, GQA attention, the
tensor-parallel attention and MLP blocks in the `ar`, `dist` and `xla`
modes, the TP-MoE block (those three and `fused`), the EP MoE layer,
the SP decode attention layer over a sequence-sharded cache, and the
pipeline-parallel transport (PPCommOp, pp_schedule_fwd)."""

from triton_dist_tpu_torch.layers.attention import gqa_attention  # noqa: F401
from triton_dist_tpu_torch.layers.ep_moe import (  # noqa: F401
    EPMoEParams,
    ep_moe_fwd,
    ep_moe_ref,
    ep_params_from_jax,
    ep_params_from_tp,
)
from triton_dist_tpu_torch.layers.norm import rms_norm  # noqa: F401
from triton_dist_tpu_torch.layers.p2p import PPCommOp, pp_schedule_fwd  # noqa: F401
from triton_dist_tpu_torch.layers.rope import apply_rope, rope_table  # noqa: F401
from triton_dist_tpu_torch.layers.sp_flash_decode import (  # noqa: F401
    SpDecodeParams,
    SpDecodeSpec,
    compiled_sp_decode_step,
    sp_decode_attn_fwd,
    sp_decode_step,
)
from triton_dist_tpu_torch.layers.tp_attn import (  # noqa: F401
    TPAttnParams,
    TPAttnSpec,
    tp_attn_fwd,
)
from triton_dist_tpu_torch.layers.tp_mlp import TPMLPParams, tp_mlp_fwd  # noqa: F401
from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd  # noqa: F401

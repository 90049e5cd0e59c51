"""Model configuration — a copy of triton_dist_tpu.models.config.

Copied, not imported: the port never imports the JAX package. The
geometry presets are the same (Qwen3-8B/32B, the tiny test config); the
MoE fields are kept so a config round-trips between the packages, but
this port serves dense models only.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151_936
    hidden_size: int = 5120
    intermediate_size: int = 25_600
    num_layers: int = 64
    num_q_heads: int = 64
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    max_positions: int = 4096
    dtype: str = "bfloat16"
    # qk-norm (Qwen3 applies rmsnorm over head_dim to q and k)
    use_qk_norm: bool = True
    tie_word_embeddings: bool = False
    # MoE (0 experts = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        """The activation and weight dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @staticmethod
    def qwen3_32b(**kw) -> "ModelConfig":
        """Qwen3-32B geometry."""
        return ModelConfig(
            vocab_size=151_936, hidden_size=5120, intermediate_size=25_600,
            num_layers=64, num_q_heads=64, num_kv_heads=8, head_dim=128,
            **kw,
        )

    @staticmethod
    def qwen3_8b(**kw) -> "ModelConfig":
        """Qwen3-8B geometry."""
        return ModelConfig(
            vocab_size=151_936, hidden_size=4096, intermediate_size=12_288,
            num_layers=36, num_q_heads=32, num_kv_heads=8, head_dim=128,
            **kw,
        )

    @staticmethod
    def tiny(**kw) -> "ModelConfig":
        """Test-scale config (CPU parity tests)."""
        defaults = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_q_heads=16, num_kv_heads=8, head_dim=32,
            max_positions=64, dtype="float32",
        )
        defaults.update(kw)
        return ModelConfig(**defaults)

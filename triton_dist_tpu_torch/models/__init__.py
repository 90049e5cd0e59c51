"""ModelConfig, KVCache, the Qwen3 forward (dense and MoE), the Engine
and the MoE entry points."""

from triton_dist_tpu_torch.models.config import ModelConfig  # noqa: F401
from triton_dist_tpu_torch.models.kv_cache import KVCache  # noqa: F401
from triton_dist_tpu_torch.models.dense import (  # noqa: F401
    DenseLLMParams,
    DenseLayerParams,
    forward,
    init_params,
    params_from_jax,
    shard_params,
)
from triton_dist_tpu_torch.models.engine import Engine, sample_token  # noqa: F401
from triton_dist_tpu_torch.models.qwen_moe import (  # noqa: F401
    auto_engine,
    qwen3_moe_engine,
)

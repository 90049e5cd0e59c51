"""ModelConfig, KVCache, the dense Qwen3 forward and the Engine."""

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

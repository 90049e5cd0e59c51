"""ModelConfig, KVCache, the Qwen3 forward (dense and MoE), the Engine,
the MoE entry points and the megakernel decode (MegaQwen3)."""

from triton_dist_tpu_torch.models.config import ModelConfig  # noqa: F401
from triton_dist_tpu_torch.models.kv_cache import KVCache  # noqa: F401
from triton_dist_tpu_torch.models.dense import (  # noqa: F401
    DenseLLMParams,
    DenseLayerParams,
    forward,
    init_params,
    layers_fwd,
    params_from_jax,
    pp_stage_fn,
    shard_params,
)
from triton_dist_tpu_torch.models.engine import Engine, sample_token  # noqa: F401
from triton_dist_tpu_torch.models.qwen_moe import (  # noqa: F401
    auto_engine,
    qwen3_moe_engine,
)

_MEGA = ("MegaKVCache", "MegaQwen3", "PagedMegaKVCache")


def __getattr__(name):
    """The megakernel decode's classes (mega/qwen3.py), imported at first
    use: mega/ imports these modules, so an import here would be a
    cycle."""
    if name in _MEGA:
        from triton_dist_tpu_torch.mega import qwen3

        return getattr(qwen3, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

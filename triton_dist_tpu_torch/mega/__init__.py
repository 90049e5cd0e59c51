"""The decode megakernel: the task graph (core, builder), its order and
slot plan (scheduler), the compiled queue and its CUDA kernel (kernel,
csrc/mega.cu) and the Qwen3 model over it (qwen3)."""

from triton_dist_tpu_torch.mega.qwen3 import (  # noqa: F401
    MegaKVCache,
    MegaQwen3,
    PagedMegaKVCache,
    build_qwen3_graph,
)

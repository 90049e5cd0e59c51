"""Hand-written CUDA kernels of the port, each beside its plain version.

`KERNELS` maps every kernel's name to its counted wrapper;
`reset_launches()` / `launches()` read and clear the launch counts.
"""

from triton_dist_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    build,
    launches,
    reset_launches,
)
from triton_dist_tpu_torch.kernels.allgather import (  # noqa: F401
    ring_all_gather,
    ring_all_gather_plain,
)
from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: F401
    ag_gemm,
    ag_gemm_plain,
    arrival_to_rank_order,
    silu_mul,
)
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: F401
    one_shot_all_reduce,
    one_shot_all_reduce_plain,
)
from triton_dist_tpu_torch.kernels.flash_prefill import (  # noqa: F401
    fit_block,
    flash_prefill_local,
    flash_prefill_plain,
    supports_flash_prefill,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar  # noqa: F401
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: F401
    gemm_rs,
    gemm_rs_plain,
)
from triton_dist_tpu_torch.kernels.mega import mega_step  # noqa: F401
from triton_dist_tpu_torch.kernels.reduce_scatter import (  # noqa: F401
    ReduceScatterMethod,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)

# kernel name -> its csrc/ source stem, for building all of them at once
SOURCES = {
    "flash_prefill_local": "flash_prefill",
    "one_shot_all_reduce": "allreduce",
    "ring_all_gather": "allgather",
    "gemm_rs": "gemm_reduce_scatter",
    "ag_gemm": "allgather_gemm",
    "ring_reduce_scatter": "reduce_scatter",
    "mega": "mega",
}

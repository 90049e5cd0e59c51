"""Hand-written CUDA kernels of the port, each beside its plain version.

`KERNELS` maps every kernel's name to its counted wrapper;
`reset_launches()` / `launches()` read and clear the launch counts.

`all_to_all` is a submodule and a function of it: the function is not
re-exported here, so `from triton_dist_tpu_torch.kernels import
all_to_all` is the module (import the function from
`triton_dist_tpu_torch.kernels.all_to_all`).
"""

from triton_dist_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    build,
    launches,
    reset_launches,
)
from triton_dist_tpu_torch.kernels.all_to_all import (  # noqa: F401
    all_to_all_chunked,
    all_to_all_plain,
    fast_all_to_all,
)
from triton_dist_tpu_torch.kernels.allgather import (  # noqa: F401
    AllGatherMethod,
    all_gather,
    all_gather_op,
    choose_allgather_method,
    full_mesh_all_gather,
    full_mesh_all_gather_plain,
    ring_all_gather,
    ring_all_gather_plain,
)
from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: F401
    ag_gemm,
    ag_gemm_plain,
    ag_gemm_wire,
    arrival_to_rank_order,
    silu_mul,
)
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: F401
    AllReduceMethod,
    all_reduce,
    all_reduce_op,
    all_reduce_plain,
    choose_allreduce_method,
    one_shot_all_reduce,
    one_shot_all_reduce_plain,
    two_shot_all_reduce,
)
from triton_dist_tpu_torch.kernels.ep_a2a import (  # noqa: F401
    EPChunkDispatch,
    EPDispatch,
    EpMoeConfig,
    ep_combine,
    ep_combine_chunked,
    ep_dispatch,
    ep_dispatch_chunked,
    ep_expert_ffn,
    ep_expert_ffn_chunked,
    ep_moe_pipeline,
    fit_chunks,
)
from triton_dist_tpu_torch.kernels.flash_decode import (  # noqa: F401
    create_sp_decode_buf,
    flash_decode_combine,
    flash_decode_partial,
    flash_decode_partial_cuda,
    partials_buf_shape,
    sp_flash_decode,
)
from triton_dist_tpu_torch.kernels.flash_prefill import (  # noqa: F401
    fit_block,
    flash_prefill_local,
    flash_prefill_plain,
    flash_prefill_ref,
    sp_flash_prefill,
    sp_prefill_attention,
    supports_flash_prefill,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar  # noqa: F401
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: F401
    gemm_rs,
    gemm_rs_plain,
    gemm_rs_wire,
    gemm_rs_wire_plain,
)
from triton_dist_tpu_torch.kernels.low_latency_allgather import (  # noqa: F401
    create_ll_ag_buffer,
    ll_all_gather,
    ll_all_gather_plain,
)
from triton_dist_tpu_torch.kernels.mega import mega_step  # noqa: F401
from triton_dist_tpu_torch.kernels.p2p import (  # noqa: F401
    p2p_read,
    p2p_send,
    p2p_send_plain,
    ring_shift,
    ring_shift_plain,
)
from triton_dist_tpu_torch.kernels.reduce_scatter import (  # noqa: F401
    ReduceScatterMethod,
    reduce_scatter_op,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
    ring_reduce_scatter_wire,
    ring_reduce_scatter_wire_plain,
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
    "sp_flash_prefill": "flash_prefill",
    "flash_decode_partial": "flash_decode",
    "ll_all_gather": "low_latency_allgather",
    "all_to_all": "all_to_all",
    "all_to_all_chunked": "all_to_all",
    "full_mesh_all_gather": "allgather",
    "p2p_send": "p2p",
    "ring_shift": "p2p",
    "ring_rs_wire": "reduce_scatter",
    "gemm_rs_wire": "gemm_reduce_scatter",
    "ag_gemm_wire": "allgather_gemm",
}

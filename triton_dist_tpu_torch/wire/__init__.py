"""triton_dist_tpu_torch.wire — port of triton_dist_tpu.wire, the
block-scaled quantized-wire plane.

  codec     WireFormat ("native" | "fp8" | "int8", block-scaled f32
            scales, optional per-row checksum), quantize / dequantize,
            the int8 wire image (encode_rows / decode_rows, pack /
            unpack), byte for byte the JAX package's.
  numerics  the cosine / ulp drift harness a (collective, format),
            replaying each kernel's fold order; DEFAULT_ERROR_BUDGET.

The quantized collectives take `wire_format=`: the gather family
(kernels/allgather.py, low_latency_allgather.py) packs once at the send
edge and moves the image through its native kernel; the reduction
family (kernels/reduce_scatter.py, the two-shot AllReduce, gemm_rs)
re-encodes at every ring hop in `ring_rs_wire_kernel`; ag_gemm
dequantizes each A tile right before its product. The EP dispatch's fp8
payload (kernels/ep_a2a.py) uses `quantize`. `wire_format="auto"` and
`error_budget` need the perf model's choose_wire_format (ROADMAP item
7) and raise.
"""

from triton_dist_tpu_torch.wire.codec import (  # noqa: F401
    CHECKSUM_BYTES,
    FP8,
    FP8_MAX,
    INT8,
    INT8_MAX,
    LANE,
    NATIVE,
    SCALE_BYTES,
    SCALE_EPS,
    WireFormat,
    decode_rows,
    dequantize,
    encode_rows,
    is_native,
    n_blocks,
    pack,
    payload_dtype,
    quantize,
    resolve,
    roundtrip,
    unpack,
    unpack_checked,
    verify_rows,
    wire_cols,
    wire_row_bytes,
)
from triton_dist_tpu_torch.wire.numerics import (  # noqa: F401
    COLLECTIVES,
    DEFAULT_ERROR_BUDGET,
    codec_drift,
    collective_drift,
    cosine_drift,
    drift_monotone_in_block,
    drift_table,
    max_ulp_f32,
    simulate_allreduce,
    simulate_ring_rs,
)

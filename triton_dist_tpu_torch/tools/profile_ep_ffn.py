"""The EP expert FFN's times at the EP path's shapes.

    python -m triton_dist_tpu_torch.tools.profile_ep_ffn

World 4, Qwen3-30B-A3B widths (128 experts, 32 a rank, H 2048, expert
intermediate 768), weights from chip_smoke.py's `rand` (scale 0.02),
tokens `rand` (scale 1) routed by the router's top 8 (layers/ep_moe.py
`_route`). For each run of chip_smoke.py's EP phase whose FFN differs
in shape: 128 tokens a rank at the lossless capacity 1024, sequential
(`ep_dispatch` + `ep_expert_ffn`) and chunked at q 1, 2, 4
(`ep_dispatch_chunked` + `ep_expert_ffn_chunked`), 128 a rank at
capacity 256 sequential, and 1 token a rank sequential. The dispatch is
made once; then the FFN on it: its result against the same FFN with
every grouped product replaced by `grouped_gemm_plain` (max abs error,
within chip_smoke.grouped_gemm_atol), its call ms (CUDA events,
chip_smoke.time_ms), device µs a call (every kernel,
chip_smoke.device_us_total), host ms a call (the host clock around
ITERS calls, each synchronised), the host syncs a call
(chip_smoke.host_syncs) and the grouped_gemm_f32 launches a call. Prints
one JSON line. chip_smoke.py is loaded from this file's checkout and the
FFN from whichever `triton_dist_tpu_torch` is imported first, so two
versions compare in one run by pointing PYTHONPATH at each checkout in
turn and running this file by its path (old, new, new, old). Needs a
CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.kernels import grouped_gemm as gg
from triton_dist_tpu_torch.layers.ep_moe import EPMoEParams, _route
from triton_dist_tpu_torch.models.config import ModelConfig

# (label, tokens a rank, capacity, chunks; 0 is the sequential FFN)
RUNS = (("M128 sequential", 128, 1024, 0),
        ("M128 chunked q1", 128, 1024, 1),
        ("M128 chunked q2", 128, 1024, 2),
        ("M128 chunked q4", 128, 1024, 4),
        ("M128 capacity 256 sequential", 128, 256, 0),
        ("M1 sequential", 1, 8, 0))
ITERS = 20


def _chip_smoke():
    """chip_smoke.py of this file's checkout (its timing helpers)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain_products():
    """Within the block, grouped_gemm is its plain loop over experts."""
    real = gg.grouped_gemm

    class Plain:
        def __enter__(self):
            gg.grouped_gemm = (lambda x, w, sizes, out_dtype=None, **_:
                               gg.grouped_gemm_plain(x, w, sizes, out_dtype))

        def __exit__(self, *exc):
            gg.grouped_gemm = real

    return Plain()


def main() -> None:
    cs = _chip_smoke()
    n, seed = 4, 200
    cfg = ModelConfig.qwen3_30b_a3b()
    h, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    k = cfg.num_experts_per_tok
    params = EPMoEParams(
        cs.rand((h, e), torch.bfloat16, seed, 0.02),
        cs.rand((n, e // n, h, 2 * i), torch.bfloat16, seed + 1, 0.02),
        cs.rand((n, e // n, i, h), torch.bfloat16, seed + 2, 0.02))
    rows = {}
    for label, m, cap, q in RUNS:
        x = cs.rand((n, m, h), torch.bfloat16, seed + 3 + m)
        weights, ids = _route(x, params, k)
        if q:
            disp = ep_a2a.ep_dispatch_chunked(x, ids, weights, e, cap,
                                              n_chunks=q)

            def ffn(disp=disp, q=q):
                return ep_a2a.ep_expert_ffn_chunked(
                    disp, params.w_gate_up, params.w_down, n_chunks=q)
        else:
            disp = ep_a2a.ep_dispatch(x, ids, weights, e, cap)

            def ffn(disp=disp):
                return ep_a2a.ep_expert_ffn(disp, params.w_gate_up,
                                            params.w_down)
        got = ffn()
        with _plain_products():
            want = ffn()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        atol = cs.grouped_gemm_atol(want)
        if not err <= atol:
            raise AssertionError(f"{label}: FFN off its plain products, "
                                 f"err {err}, atol {atol}")
        kernels.reset_launches()
        ffn()
        launches = kernels.launches().get("grouped_gemm_f32", 0)
        ms = cs.time_ms(ffn)
        dev_us = cs.device_us_total(ffn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            ffn()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        rows[label] = dict(ms=ms, device_us=dev_us, host_ms=host_ms,
                           host_syncs=cs.host_syncs(ffn),
                           grouped_gemm_f32_launches=launches,
                           max_abs_err=err, atol=atol,
                           routed_rows=int(disp.valid.sum().item()),
                           slots=int(disp.valid.numel()))
        print(json.dumps({label: rows[label]}), flush=True)
    print(json.dumps({"package": os.path.dirname(
        triton_dist_tpu_torch.__file__), "torch": torch.__version__,
        "ep_ffn": rows}))


if __name__ == "__main__":
    main()

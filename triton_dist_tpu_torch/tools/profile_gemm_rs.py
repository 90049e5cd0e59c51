"""The gemm_rs kernel's device times at the main path's shapes.

    python -m triton_dist_tpu_torch.tools.profile_gemm_rs [--wire]

bf16, world 4, Qwen3-8B widths, inputs from chip_smoke.py's `rand` (A
scale 1, weights 0.02): gemm_rs (csrc/gemm_reduce_scatter.cu) on the O
projection (a (4, 4m, 1024), b (4, 1024, 4096), rank order) and the down
projection (a (4, 4m, 3072), b (4, 3072, 4096), arrival order), each at
a prefill's m = 128 rows a rank and a scheduler step's m = 64: the
`dist` path's four calls; then the n = 1 form (force_kernel, PERF.md
row 6: chip_smoke's world-1 down projection, a (1, 512, 12288), b (1,
12288, 4096)), whose library call is one torch.matmul. Each case is
first held against gemm_rs_plain within chip_smoke.gemm_rs_atol (20
calls); then its device µs a call
(torch.profiler, chip_smoke.device_us on the kernels named gemm_rs*),
its call ms (CUDA events), the least time (chip_smoke.bound_ms: 2 n M K
N operations at the bf16 peak against n (M K + K N) read and n m N
written) and the library's one einsum over ranks and K (a yardstick the
port never calls), ms and device µs, read in three traces, with each
kernel's µs a call in the last (`library_kernels_us`) and the device µs
of that einsum's product alone (`gemm_us`: one matmul of A laid out as
(M, n K) beforehand by B as (n K, N)). Where the package has the wgmma
body (`gemm_reduce_scatter._body_for`): which body each case takes, the
mma.sync body forced on the same call, where the case takes the wgmma
body the BN sweep (each tile width forced through
`gemm_reduce_scatter._launch(..., bn=)`, within the atol),
the plan's pick, and each wgmma instantiation's registers and spills
from ptxas when this run built the library. Prints one JSON line.
chip_smoke.py is loaded from this file's checkout and the kernel from
whichever `triton_dist_tpu_torch` is imported first, so two versions
compare in one run by pointing PYTHONPATH at each checkout in turn and
running this file by its path (old, new, new, old). Needs a CUDA card.

--wire times only the quantized-wire form at phase 4w's shapes
(chip_smoke.WIRE_GEMM_RS: down, a (4, 512, 3072), and O, a (4, 512,
1024), b (4, K, 4096), rank order, chip_smoke's inputs), fp8, int8 and
int8 block 128: each case's partials (`_launch(..., partials=True)`)
held within 1e-5 of torch.matmul in f32 and its result bitwise the
plain wire fold of those partials (20 calls); then the device µs a call
of its two launches apart (the partial GEMM: the kernels named
gemm_rs*; the ring: ring_rs_wire_kernel), call ms, host µs a call
(unsynchronised calls), the caching allocator's allocations a call,
the bound (chip_smoke's: the operations at the bf16 peak against A, B
and the output once plus the ring's images), the native kernel's device
µs at the same shape, the body the partial GEMM took
(`launches_by_body`), the mma.sync body forced on the same partials
and, on the wgmma body, the plan's tile width and each width forced
(within 1e-5); ptxas's registers and spills of the wgmma
instantiations when this run built the library.
"""

from __future__ import annotations

import json
import os
import sys

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.tools.profile_flash import _allocs, _host_us
from triton_dist_tpu_torch.tools.profile_ring_rs import _chip_smoke

N_WORLD, N = 4, 4096
KEY = "gemm_rs"


def _cases(cs):
    for m, when in ((128, "prefill"), (64, "scheduler step")):
        for k, proj, order in ((1024, "O", "rank"), (3072, "down",
                                                     "arrival")):
            a = cs.rand((N_WORLD, N_WORLD * m, k), torch.bfloat16, m + k)
            b = cs.rand((N_WORLD, k, N), torch.bfloat16, k + 1, 0.02)
            yield f"{when} {proj} ({order})", a, b, order
    a = cs.rand((1, 512, 12288), torch.bfloat16, 5)
    b = cs.rand((1, 12288, N), torch.bfloat16, 6, 0.02)
    yield "n = 1 force_kernel (row 6)", a, b, "rank"


def _within(cs, fn, a, b, want, label):
    atol = cs.gemm_rs_atol(a, b, want)
    for _ in range(20):
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= atol:
            raise AssertionError(f"{label}: err {err} above atol {atol}")
    return err / atol


def _kernels_us(fn, reps=10):
    """Each kernel's device µs a call of fn (name -> µs), from one
    torch.profiler trace of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0:
            out[e.key[:100]] = us / reps
    return out


def _wire(cs):
    """Phase 4w's gemm_rs calls on the wire: {label: numbers}."""
    from triton_dist_tpu_torch import wire

    n, bf, f32 = cs.WIRE_WORLD, torch.bfloat16, torch.float32
    rows = {}
    for i, (name, mm, k, nn) in enumerate(cs.WIRE_GEMM_RS):
        a = cs.rand((n, mm, k), bf, 40 + i, 0.1)
        b = cs.rand((n, k, nn), bf, 50 + i, 0.05)
        exact = torch.matmul(a.float(), b.float())
        native = cs.device_us(lambda a=a, b=b: kernels.gemm_rs(a, b), KEY)
        for kind, block in cs.WIRE_FORMATS:
            f = wire.WireFormat(kind, block)
            label = f"{name} ({mm}, {k}) @ ({k}, {nn}) {cs.wire_label(f)}"

            def call(a=a, b=b, f=f):
                return kernels.gemm_rs(a, b, wire_format=f)

            def partial(a=a, b=b, body=None):
                return rs._launch(a, b, False, f32, partials=True,
                                  **({} if body is None else
                                     {"body": body}))

            before = dict(rs.launches_by_body)
            for _ in range(20):
                p = partial()
                torch.testing.assert_close(p, exact, rtol=1e-5, atol=1e-5)
                if not torch.equal(call(), kernels.
                                   ring_reduce_scatter_wire_plain(p, f, bf)):
                    raise AssertionError(f"{label}: not bitwise the plain "
                                         "fold of its own partials")
            body = {k2: (v - before[k2]) // 40 for k2, v in
                    rs.launches_by_body.items() if v != before[k2]}
            torch.testing.assert_close(partial(body="mma"), exact,
                                       rtol=1e-5, atol=1e-5)
            bound, by = cs.bound_ms(
                2 * n * mm * k * nn,
                (n * mm * k + n * k * nn + n * (mm // n) * nn) * 2
                + cs.wire_hop_bytes(n, mm // n, nn, f), "bfloat16")
            rows[label] = dict(
                gemm_device_us=cs.device_us(call, KEY),
                ring_device_us=cs.device_us(call, "ring_rs_wire_kernel"),
                ms=cs.time_ms(call), host_us_a_call=_host_us(call, 50),
                allocs_per_call=_allocs(call), bound_us=bound * 1e3,
                bound_by=by, native_device_us=native, bodies=body,
                mma_gemm_device_us=cs.device_us(
                    lambda: partial(body="mma"), KEY))
            if body != {"wgmma": 1}:
                continue
            rows[label]["plan_bn"] = rs._wgmma_bn(
                mm, nn, n, _build.card_sms(a.device))
            for bn in rs._WGMMA_BN:
                def fn(a=a, b=b, bn=bn):
                    return rs._launch(a, b, False, f32, partials=True, bn=bn)
                torch.testing.assert_close(fn(), exact, rtol=1e-5, atol=1e-5)
                rows[label][f"bn {bn} gemm_device_us"] = cs.device_us(fn, KEY)
    return rows


def main() -> None:
    cs = _chip_smoke()
    if "--wire" in sys.argv[1:]:
        rows = _wire(cs)
        print(json.dumps({
            "package": os.path.dirname(triton_dist_tpu_torch.__file__),
            "card": cs.card_line(), "wire": rows,
            "ptxas": _build.ptxas_summary("gemm_reduce_scatter",
                                          "gemm_rs_wgmma_kernel")}),
              flush=True)
        return
    rows, sweep, plan, bodies = {}, {}, {}, {}
    wgmma = hasattr(rs, "_body_for")
    for label, a, b, order in _cases(cs):
        n, M, k = a.shape
        want = kernels.gemm_rs_plain(a, b, order)

        def call(a=a, b=b, order=order):
            return kernels.gemm_rs(a, b, a_order=order, force_kernel=True)

        def library(a=a, b=b):
            if a.shape[0] == 1:
                return torch.matmul(a, b)
            return torch.einsum("rmk,rkn->mn", a, b)

        share = _within(cs, call, a, b, want, label)
        bound, by = cs.bound_ms(
            2 * n * M * k * N,
            (n * (M * k + k * N) + n * (M // n) * N) * a.element_size(),
            "bfloat16")
        rows[label] = dict(
            device_us=cs.device_us(call, KEY), ms=cs.time_ms(call),
            bound_us=bound * 1e3, bound_by=by, atol_share=share,
            library_us=cs.device_us_total(library),
            library_ms=cs.time_ms(library),
            library_us_reads=[cs.device_us_total(library)
                              for _ in range(3)],
            library_kernels_us=_kernels_us(library))
        a_cat = a.permute(1, 0, 2).reshape(M, n * k).contiguous()
        b_cat = b.reshape(n * k, N)
        rows[label]["gemm_us"] = cs.device_us_total(
            lambda: torch.matmul(a_cat, b_cat))
        if not wgmma:
            continue
        arrival = order == "arrival"
        bodies[label] = rs._body_for(n, M // n, k, N, a.dtype, a.dtype)
        plan[label] = rs._wgmma_bn(M, N, n, _build.card_sms(a.device))

        def mma(a=a, b=b, arrival=arrival):
            return rs._launch(a, b, arrival, body="mma")

        _within(cs, mma, a, b, want, f"{label} mma")
        rows[label]["mma_device_us"] = cs.device_us(mma, KEY)
        if bodies[label] != "wgmma":
            continue
        for bn in rs._WGMMA_BN:
            def fn(a=a, b=b, arrival=arrival, bn=bn):
                return rs._launch(a, b, arrival, bn=bn)
            _within(cs, fn, a, b, want, f"{label} bn {bn}")
            sweep[f"{label} bn {bn}"] = cs.device_us(fn, KEY)
    out = {"package": os.path.dirname(triton_dist_tpu_torch.__file__),
           "card": cs.card_line(), "rows": rows}
    if wgmma:
        out.update(bodies=bodies, plan=plan, bn_sweep_device_us=sweep,
                   ptxas=_build.ptxas_summary("gemm_reduce_scatter",
                                              "gemm_rs_wgmma_kernel"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

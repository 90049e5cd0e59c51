"""The ag_gemm kernel's device times at the main paths' shapes.

    python -m triton_dist_tpu_torch.tools.profile_ag_gemm

bf16, world 4, Qwen3-8B widths, inputs from chip_smoke.py's `rand` (A
scale 1, weights 0.02): ag_gemm (csrc/allgather_gemm.cu) on QKV (b (4,
4096, 1536), rank order) and gate|up (silu_pair, b 2 x (4, 4096, 3072),
arrival order), each at a prefill's m = 128 rows a rank and a scheduler
step's m = 64: the `dist` path's four calls. Each case is first held
against ag_gemm_plain within chip_smoke.ag_gemm_atol (20 calls); then
its device µs a call (torch.profiler, chip_smoke.device_us on the
kernels named ag_gemm*), its call ms (CUDA events), the least time
(chip_smoke.bound_ms: 2 n (n m) K N operations a weight at the bf16 peak
against the bytes read and written once) and the library's one einsum of
the gathered A with b (for the pair [w_gate | w_up] joined, the product
only: a yardstick the port never calls), ms and device µs. Where the
package has the wgmma body (`allgather_gemm._body_for`): which body each
case takes, the BN sweep (each tile width forced through
`allgather_gemm._launch(..., bn=)`, within the atol), the plan's pick,
the host µs the four tensor maps' encoding adds a call (1000 encodings),
and each wgmma instantiation's registers and spills from ptxas when this
run built the library. Then the grouped form at the Qwen3-30B-A3B
`fused` 4 x 32 prefill's shape (pack_by_expert of 32 tokens a rank, top
8 of 128 experts, cap 256; K 2048, gate and up 192 columns, views of one
[gate | up] stack; silu_pair, arrival order): held against
ag_gemm_plain within the atol once, then device µs and call ms with the
packs' counts (where the package takes `counts`, as the fused path
calls it), with every row live, and with the old mma.sync body forced
(where `_launch` takes `body=`), and the grouped kernel's BN sweep;
bound: each rank's B slices of the experts reached and the live A rows
read once, C written once; library: one batched matmul of the gathered
padded blocks with [gate | up]. Prints one JSON line. chip_smoke.py is loaded
from this file's checkout and the kernel from whichever
`triton_dist_tpu_torch` is imported first, so two versions compare in
one run by pointing PYTHONPATH at each checkout in turn and running this
file by its path (old, new, new, old). Needs a CUDA card.
"""

from __future__ import annotations

import inspect
import json
import os
import time

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.tools.profile_ring_rs import _chip_smoke

N_WORLD, K, N_QKV, N_FFN = 4, 4096, 1536, 3072
KEY = "ag_gemm"


def _cases(cs):
    for m, when in ((128, "prefill"), (64, "scheduler step")):
        a = cs.rand((N_WORLD, m, K), torch.bfloat16, m)
        w = cs.rand((N_WORLD, K, N_QKV), torch.bfloat16, m + 1, 0.02)
        yield f"{when} QKV", a, w, {}
        g = cs.rand((N_WORLD, K, N_FFN), torch.bfloat16, m + 2, 0.02)
        u = cs.rand((N_WORLD, K, N_FFN), torch.bfloat16, m + 3, 0.02)
        yield (f"{when} gate|up", a, (g, u),
               dict(epilogue="silu_pair", c_order="arrival"))


def _within(cs, fn, a, b, want, label, reps=20):
    atol = cs.ag_gemm_atol(a, b, want)
    for _ in range(reps):
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= atol:
            raise AssertionError(f"{label}: err {err} above atol {atol}")
    return err / atol


def _grouped(cs):
    """The fused prefill's grouped call: rows {label: numbers}, the BN
    sweep, and the body each label took (where the package counts)."""
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    n, e, k, i_loc, m_tok, top, cap = 4, 128, 2048, 192, 32, 8, 256
    g = torch.Generator().manual_seed(3)
    packs = []
    for _ in range(n):
        x = (torch.randn((m_tok, k), generator=g) * 0.5).to(torch.bfloat16)
        ids = torch.randn((m_tok, e), generator=g).topk(top, -1).indices
        packs.append(mu.pack_by_expert(x.cuda(), ids.to(torch.int32).cuda(),
                                       e, cap))
    a = torch.stack([p.x for p in packs])
    counts = torch.stack([p.counts for p in packs])
    gu = cs.rand((n, e, k, 2 * i_loc), torch.bfloat16, 9, 0.02)
    ws = (gu[..., :i_loc], gu[..., i_loc:])
    kw = dict(epilogue="silu_pair", c_order="arrival")
    live = int(counts.sum())
    reached = int((counts > 0).any(0).sum())
    bound, by = cs.bound_ms(
        2 * 2 * n * live * k * i_loc,
        (live * k + n * reached * k * 2 * i_loc + n * n * e * cap * i_loc)
        * a.element_size(), "bfloat16")
    xe = a.reshape(n, e, cap, k).permute(1, 0, 2, 3).reshape(
        e, n * cap, k).contiguous()

    def library():
        return torch.matmul(xe[None], gu)

    want = kernels.ag_gemm_plain(a, ws, **kw)
    takes_counts = "counts" in inspect.signature(kernels.ag_gemm).parameters
    takes_body = "body" in inspect.signature(ag._launch).parameters
    calls = {"fused grouped, every row live":
             lambda: kernels.ag_gemm(a, ws, **kw)}
    if takes_counts:
        calls["fused grouped, counts"] = lambda: kernels.ag_gemm(
            a, ws, counts=counts, **kw)
    if takes_body:
        calls["fused grouped, mma.sync body forced"] = lambda: ag._launch(
            a, ws, True, False, body="mma")
    rows, bodies, sweep = {}, {}, {}
    lib_us = cs.device_us_total(library)
    lib_ms = cs.time_ms(library, iters=5)
    for label, fn in calls.items():
        by_body = dict(getattr(ag, "launches_by_body", {}))
        share = _within(cs, fn, a, ws, want, label, reps=1)
        bodies[label] = {b: v - by_body[b] for b, v in
                         getattr(ag, "launches_by_body", {}).items()
                         if v != by_body[b]}
        rows[label] = dict(
            device_us=cs.device_us(fn, KEY, reps=5),
            ms=cs.time_ms(fn, iters=10), bound_us=bound * 1e3, bound_by=by,
            atol_share=share, live_rows=live, experts_reached=reached,
            library_us=lib_us, library_ms=lib_ms)
    for bn in getattr(ag, "_GROUPED_BN", ()):
        def fn(bn=bn):
            return ag._launch(a, ws, True, False, counts=counts, bn=bn)
        _within(cs, fn, a, ws, want, f"grouped bn {bn}", reps=1)
        sweep[f"fused grouped, counts, bn {bn}"] = cs.device_us(fn, KEY,
                                                                reps=5)
    return rows, bodies, sweep


def main() -> None:
    cs = _chip_smoke()
    rows, sweep, plan, bodies = {}, {}, {}, {}
    wgmma = hasattr(ag, "_body_for")
    for label, a, b, kw in _cases(cs):
        n, m, k = a.shape
        ws = b if isinstance(b, tuple) else (b,)
        nn = ws[0].shape[2]
        want = kernels.ag_gemm_plain(a, b, **kw)

        def call(a=a, b=b, kw=kw):
            return kernels.ag_gemm(a, b, **kw)

        share = _within(cs, call, a, b, want, label)
        full = a.reshape(n * m, k)
        wcat = torch.cat(ws, dim=2)
        bound, by = cs.bound_ms(
            2 * n * (n * m) * k * nn * len(ws),
            (n * m * k + len(ws) * n * k * nn + n * n * m * nn)
            * a.element_size(), "bfloat16")
        rows[label] = dict(
            device_us=cs.device_us(call, KEY), ms=cs.time_ms(call),
            bound_us=bound * 1e3, bound_by=by, atol_share=share,
            library_us=cs.device_us_total(
                lambda: torch.einsum("mk,rkn->rmn", full, wcat)),
            library_ms=cs.time_ms(
                lambda: torch.einsum("mk,rkn->rmn", full, wcat)))
        if not wgmma:
            continue
        pair = len(ws) == 2
        bodies[label] = ag._body_for(a, ws, None, False)
        plan[label] = ag._wgmma_bn(n * m, nn, n, pair,
                                   _build.card_sms(a.device))
        for bn in ag._WGMMA_BN_PAIR if pair else ag._WGMMA_BN:
            def fn(a=a, ws=ws, kw=kw, bn=bn):
                return ag._launch(a, ws, kw.get("c_order") == "arrival",
                                  False, bn=bn)
            _within(cs, fn, a, b, want, f"{label} bn {bn}")
            sweep[f"{label} bn {bn}"] = cs.device_us(fn, KEY)
    out = {"package": os.path.dirname(triton_dist_tpu_torch.__file__),
           "card": cs.card_line(), "rows": rows}
    if wgmma:
        lib = _build.load("allgather_gemm", ag._SIGNATURES)
        a = cs.rand((N_WORLD, 128, K), torch.bfloat16, 0)
        b = cs.rand((N_WORLD, K, N_QKV), torch.bfloat16, 1)
        heap = torch.empty((N_WORLD, N_WORLD * 128, K), dtype=a.dtype,
                           device=a.device)
        reps = 1000
        t0 = time.perf_counter()
        err = lib.ag_gemm_encode_maps(a.data_ptr(), b.data_ptr(),
                                      b.data_ptr(), heap.data_ptr(),
                                      N_WORLD, 128, K, N_QKV, reps)
        encode_us = (time.perf_counter() - t0) / reps * 1e6
        assert err == 0, err
        out.update(bodies=bodies, plan=plan, bn_sweep_device_us=sweep,
                   encode_us_a_call=encode_us,
                   ptxas=_build.ptxas_summary("allgather_gemm",
                                              "ag_gemm_wgmma_kernel"))
    grows, gbodies, gsweep = _grouped(cs)
    out.update(grouped=grows, grouped_bodies=gbodies,
               grouped_bn_sweep_device_us=gsweep,
               ptxas_grouped=_build.ptxas_summary(
                   "allgather_gemm", "ag_gemm_grouped_wgmma_kernel"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

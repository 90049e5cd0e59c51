"""The flash kernels' times at the Qwen3-8B head shapes.

    python -m triton_dist_tpu_torch.tools.profile_flash [--host | --sp |
                                                         --decode]

--decode times only the SP decode partial (`flash_decode_partial_cuda`,
PERF.md row 3) on phase 4s's last decode step: q (16, 32, 128) and the
(16, 8192, 8, 128) bf16 cache shards of world 4 x batch 4 (chip_smoke's
`rand`), the 16 (rank, row) valid lengths of kv_len chip_smoke.SP_KV_LEN
+ SP_STEPS as int32 on the card, as sp_flash_decode passes them. One
line: the body the package picks (`flash_decode._body_for`; a package
without it has only the FMA body), call ms (CUDA events), the kernel's
device µs (torch.profiler), the wrapper's host µs a call
(unsynchronised calls), the caching allocator's allocations a warm call,
the bound (chip_smoke.bound_ms over the valid K/V, q and the outputs)
and the library's one call (efficient attention with its lse,
chip_smoke.sp_decode_library).

--sp times only the SP kernel (`sp_flash_prefill`, PERF.md row 2) at
world 4: phase 4s's main path (4 rows x 32768 positions, 8192 a rank,
kv_len chip_smoke.SP_KV_LEN) and its whole check (4 x 4096,
chip_smoke.SP_SMALL_KV_LEN), int32 kv_len as the path passes it. A line
a case: the form the package picks (`flash_prefill._sp_plan`; a package
without it has only the mma.sync form) and who pushes the segments, call
ms (CUDA events), the kernel's device µs (torch.profiler), the wrapper's
host µs a call (unsynchronised calls), the caching allocator's
allocations a warm call, the bound, and the library's one call (4 x
4096: masked SDPA over every pair, chip_smoke.sp_sdpa; 32k: causal flash
SDPA over every position, chip_smoke.sp_causal_sdpa); the 4 x 4096 case
is also held to flash_prefill_ref in the epsilon band.

bf16. First the wrapper's host µs a call at a world-4 scheduler step's
rank rows (B 16, Hq 8, Hkv 2 a rank, kv_len 178-375), with int64 and
with int32 positions and lengths (200 unsynchronised calls; --host stops
there). Then, through chip_smoke.py's `time_flash_prefill` (the one timing path
of the flash kernels): its serve step (B 4, S 64, T 1024) and long
prefill (B 1, S = T = 2048), plus a world-4 scheduler step's rank rows
(B 16, Hq 8, Hkv 2 a rank, kv_len 178-375), once with int64 positions
and lengths (which the wrapper converts) and once with int32 ones (as
the model passes them). Prints one JSON line a case: ms a call (CUDA
events), the kernel's device µs (torch.profiler), plain and SDPA ms, and
the bound. Where the package has the wgmma fold
(`flash_prefill._fp_plan`), each case also names the fold and split
count the plan picks (chip_smoke.time_flash_prefill), and a last line holds
the sweep at the three main-path shapes (chip_smoke.fp_main_shapes) and
one request's step (chip_smoke.FP_ONE_REQUEST): device µs of the
mma.sync fold forced and of the wgmma fold at each split count of
chip_smoke.FP_SPLITS. chip_smoke.py is loaded from this file's checkout
and the kernels from whichever `triton_dist_tpu_torch` is imported
first, so two versions of the kernel compare in one run by pointing
PYTHONPATH at each checkout in turn and running this file by its path.
Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import torch

from triton_dist_tpu_torch.kernels import flash_decode as fd
from triton_dist_tpu_torch.kernels import flash_prefill as fp


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(cs):
    """{shape label: {fold/splits: device µs}} at the main-path shapes and
    one request's step (chip_smoke.FP_ONE_REQUEST, where the plan
    splits)."""
    out = {}
    for label, b, s, t, hq, hkv, d, starts in (*cs.fp_main_shapes(),
                                              cs.FP_ONE_REQUEST):
        inp = cs.fp_inputs(b, s, t, hq, hkv, d, starts, torch.bfloat16,
                           seed=1)
        args = (inp["q"], inp["k"], inp["v"],
                inp["q_positions"].to(torch.int32),
                0, inp["kv_len"].to(torch.int32), True, None)
        row = {"plan": fp._fp_plan(b, s, t, hq, hkv, d, torch.bfloat16),
               "mma": cs.device_us(lambda: fp._launch(*args, body="mma"),
                                   "fp_local")}
        for sp in cs.FP_SPLITS:
            row[f"wgmma/{sp}"] = cs.device_us(
                lambda sp=sp: fp._launch(*args, body="wgmma", splits=sp),
                "fp_local")
        out[label] = row
    return out


def _host_us(fn, calls=200) -> float:
    """A wrapper's host µs a call: time.perf_counter around `calls`
    unsynchronised calls of fn (the launches queue; the host cost is the
    wrapper's Python, its torch ops and the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _sp_case(cs, s, kv_len, seed):
    n, b, hq, hkv, d = cs.SP_WORLD, cs.SP_BATCH, 32, 8, 128
    q, k, v = (cs.rand((n, b, s, hh, d), torch.bfloat16, seed + i, 0.5)
               for i, hh in enumerate((hq, hkv, hkv)))
    return q, k, v, torch.tensor(kv_len, device="cuda", dtype=torch.int32)


def _allocs(fn, calls=3):
    """The caching allocator's allocations a warm call of fn."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.memory_stats()["allocation.all.allocated"]
            - before) / calls


def sp_rows(cs):
    """{case: row} of the SP kernel at phase 4s's two shapes."""
    n, b, hq, hkv, d = cs.SP_WORLD, cs.SP_BATCH, 32, 8, 128
    form = (fp._sp_plan(cs.SP_S_LOC, hq, hkv, d, torch.bfloat16)
            if hasattr(fp, "_sp_plan") else "mma")
    pushers = ("warps 1-3 of every block" if form == "wgmma"
               else "the first 8 blocks of each rank")
    rows = {}
    for label, s, kv_len, iters, big in (
            ("4 x 4096", cs.SP_SMALL_S_LOC, cs.SP_SMALL_KV_LEN, 20, False),
            ("main path 4 x 32768", cs.SP_S_LOC, cs.SP_KV_LEN, 3, True)):
        q, k, v, kl = _sp_case(cs, s, kv_len, 63 if not big else 70)

        def fn():
            return fp.sp_flash_prefill(q, k, v, kv_len=kl)

        ops, nbytes = cs.sp_prefill_work(kv_len, n, s, hq, hkv, d)
        bound, by = cs.bound_ms(ops, nbytes, "bfloat16")
        row = dict(form=form, pushers=pushers,
                   ms=cs.time_ms(fn, iters=iters, warmup=1),
                   device_us=cs.device_us(fn, "fp_sp_", reps=2 if big
                                          else 10),
                   host_us_a_call=_host_us(fn, 4 if big else 50),
                   allocs_per_call=_allocs(fn), bound_ms=bound,
                   bound_by=by)
        if big:
            row.update(cs.sp_causal_sdpa(q, k, v))
        else:
            _, row["band_cos"], row["band_ulp"] = cs.sp_check_prefill(
                fp, q, k, v, fn(), kv_len, "4 x 4096, whole")
            lib = cs.sp_sdpa(q, k, v, kv_len)
            row.update(library_ms=cs.time_ms(lib, iters=5, warmup=1),
                       library_us=cs.device_us_total(lib, reps=3))
        rows[label] = row
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def decode_row(cs):
    """Row 3 on phase 4s's last decode step (see --decode)."""
    n, b, s = cs.SP_WORLD, cs.SP_BATCH, cs.SP_S_LOC
    hq, hkv, d = 32, 8, 128
    kv_len = torch.tensor(cs.SP_KV_LEN, device="cuda") + cs.SP_STEPS
    local = (kv_len[None] - torch.arange(n, device="cuda")[:, None] * s
             ).clamp(0, s).reshape(-1).to(torch.int32)
    q = cs.rand((n * b, hq, d), torch.bfloat16, 71)
    k, v = (cs.rand((n * b, s, hkv, d), torch.bfloat16, 72 + i)
            for i in range(2))

    def fn():
        return fd.flash_decode_partial_cuda(q, k, v, local)

    valid = int(local.sum())
    bound, by = cs.bound_ms(
        4 * hq * d * valid,
        valid * 2 * hkv * d * 2 + q.numel() * 2 + n * b * hq * (d + 1) * 4,
        "bfloat16")
    body = (fd._body_for(q.dtype, d, hq // hkv)
            if hasattr(fd, "_body_for") else "fma")
    row = dict(lens=local.tolist(), body=body, ms=cs.time_ms(fn),
               device_us=cs.device_us(fn, "fd_"),
               host_us_a_call=_host_us(fn), allocs_per_call=_allocs(fn),
               bound_ms=bound, bound_by=by)
    row["library_ms"], row["library_us"] = cs.sp_decode_library(q, k, v,
                                                                local)
    return row


def main() -> None:
    cs = _chip_smoke()
    if "--decode" in sys.argv[1:]:
        print(json.dumps({"decode_case": "phase 4s last step",
                          **decode_row(cs), "card": cs.card_line(),
                          "package": os.path.dirname(os.path.dirname(
                              fd.__file__))}), flush=True)
        return
    if "--sp" in sys.argv[1:]:
        card = cs.card_line()
        for name, row in sp_rows(cs).items():
            print(json.dumps({"sp_case": name, **row, "card": card,
                              "package": os.path.dirname(os.path.dirname(
                                  fp.__file__))}), flush=True)
        return
    rows = cs.fp_inputs(16, 64, cs.MAX_LEN, 8, 2, 128,
                        [114, 311, 193, 262] * 4, torch.bfloat16, seed=1)
    rows32 = dict(rows, q_positions=rows["q_positions"].to(torch.int32),
                  kv_len=rows["kv_len"].to(torch.int32))
    label = "world-4 step rows B=16 S=64 T=1024 Hq=8 Hkv=2"
    card = cs.card_line()
    host = {"int64 positions": _host_us(
                lambda: fp.flash_prefill_local(**rows)),
            "int32 positions": _host_us(
                lambda: fp.flash_prefill_local(**rows32))}
    print(json.dumps({"case": label, "host_us_a_call": host, "card": card}),
          flush=True)
    if "--host" in sys.argv[1:]:
        return
    times = cs.time_flash_prefill(
        fp, extra=[(f"{label}, int64 positions", rows),
                   (f"{label}, int32 positions", rows32)])
    for name, row in times.items():
        print(json.dumps({"case": name, **row, "card": card}), flush=True)
    if hasattr(fp, "_fp_plan"):
        print(json.dumps({"split_sweep_device_us": _sweep(cs),
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()

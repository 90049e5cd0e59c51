"""The MoE all-to-all kernels' times at the EP path's shapes.

    python -m triton_dist_tpu_torch.tools.profile_a2a

World 4, payloads from chip_smoke.py's `rand`, splits seeded integers:
the EP layer's M 1 dispatch (4, 4, 8, 2176) bf16, M 128 dispatch (4, 4,
1024, 2176) bf16 and combine (4, 4, 1024, 2048) f32 (PERF.md rows 12,
13), each through all_to_all (csrc/all_to_all.cu a2a_kernel, (n, n)
splits) and all_to_all_chunked at q 1, 2, 4 (a2a_chunked_kernel; the
chunked dispatch's (n, n, 33) splits, 1 + E/n counts of Qwen3-30B-A3B).
Each case is first called 20 times on one stream, every result held
bitwise against its plain version; then its call ms (CUDA events),
device µs a call (torch.profiler, chip_smoke.device_us), the wrapper's
host µs a call (time.perf_counter around 100 unsynchronised calls), the
bound (every segment and splits row read once and written once) and the
library's one `x.transpose(0, 1).contiguous()` with the splits likewise
(ms and device µs: a yardstick the port never calls). Where the package
keeps its flags in a pool (`all_to_all._POOLS`) also: the host µs by
part (chip_smoke.a2a_host_parts) and the pools a warm call made; the
device µs with each body forced (register and bulk copy), and the
protocol's floor: the same kernel, body and grid on 16-byte chunks.
Then the EP layer around them (layers/ep_moe.py `ep_moe_fwd` at
Qwen3-30B-A3B widths, world 4, seeded random weights and tokens): its
warm ms (CUDA events, the median of LAYER_ITERS calls) LAYER_ROUNDS
times at 128 tokens a rank sequential and overlap q 4, and 1 token a
rank sequential. Prints one JSON line. chip_smoke.py is loaded from this
file's checkout and the kernels from whichever `triton_dist_tpu_torch`
is imported first, so two versions compare in one run by pointing
PYTHONPATH at each checkout in turn and running this file by its path
(old, new, new, old). Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import all_to_all as a2a
from triton_dist_tpu_torch.layers.ep_moe import EPMoEParams, ep_moe_fwd
from triton_dist_tpu_torch.models.config import ModelConfig

CASES = (("M1 dispatch", (4, 4, 8, 2176), torch.bfloat16),
         ("M128 dispatch", (4, 4, 1024, 2176), torch.bfloat16),
         ("M128 combine", (4, 4, 1024, 2048), torch.float32))
CHUNKS = (None, 1, 2, 4)  # None: the single-shot kernel
SPLITS_S = 33
LAYER_RUNS = (("M128 sequential", 128, {}),
              ("M128 overlap q4", 128, dict(overlap=True, n_chunks=4)),
              ("M1 sequential", 1, {}))
LAYER_ROUNDS, LAYER_ITERS = 5, 20


def _chip_smoke():
    """chip_smoke.py of this file's checkout (its timing helpers)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, calls=100):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def _splits(n, c, s, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, n) if s is None else (n, n, s)
    return torch.randint(0, c + 1, shape, generator=g, device="cuda",
                         dtype=torch.int32)


def _forced(cs, x, sp, q, key, want, **kw):
    """Device µs of the kernel with a launch option forced, held bitwise
    first."""
    name = "all_to_all" if q is None else "all_to_all_chunked"

    def call():
        return a2a._launch(name, x, sp, q or 1, q is not None, None, **kw)

    got = call()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name} {kw}: not bitwise its plain version")
    return cs.device_us(call, key)


def layer_ms(cs, n=4, seed=100):
    """{run: [warm ms of each round]} of the EP layer (module doc)."""
    cfg = ModelConfig.qwen3_30b_a3b()
    h, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    params = EPMoEParams(
        cs.rand((h, e), torch.bfloat16, seed, 0.02),
        cs.rand((n, e // n, h, 2 * i), torch.bfloat16, seed + 1, 0.02),
        cs.rand((n, e // n, i, h), torch.bfloat16, seed + 2, 0.02))
    out = {}
    for label, m, kw in LAYER_RUNS:
        x = cs.rand((n, m, h), torch.bfloat16, seed + 3)
        fn = (lambda x=x, kw=kw: ep_moe_fwd(x, params,
                                            cfg.num_experts_per_tok, **kw))
        out[label] = [cs.time_ms(fn, iters=LAYER_ITERS)
                      for _ in range(LAYER_ROUNDS)]
        print(json.dumps({f"layer {label}": out[label]}), flush=True)
    return out


def main() -> None:
    cs = _chip_smoke()
    pooled = hasattr(a2a, "_POOLS")
    rows = {}
    for seed, (label, shape, dtype) in enumerate(CASES):
        n, _, c = shape[:3]
        x = cs.rand(shape, dtype, seed)
        lib_sp = _splits(n, c, None, seed)
        library = (lambda x=x, sp=lib_sp: (x.transpose(0, 1).contiguous(),
                                           sp.transpose(0, 1).contiguous()))
        lib_ms, lib_us = cs.time_ms(library), cs.device_us_total(library)
        for q in CHUNKS:
            sp = lib_sp if q is None else _splits(n, c, SPLITS_S, seed)
            if q is None:
                fn = (lambda x=x, sp=sp: a2a.all_to_all(x, sp))
                key, what = "a2a_kernel", "single-shot"
                name = "all_to_all"
            else:
                fn = (lambda x=x, sp=sp, q=q: a2a.all_to_all_chunked(
                    x, sp, n_chunks=q))
                key, what = "a2a_chunked_kernel", f"chunked q{q}"
                name = "all_to_all_chunked"
            want = a2a.all_to_all_plain(x, sp)
            for _ in range(20):
                got = fn()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{label} {what}: not bitwise its "
                                         "plain version")
            nbytes = 2 * (x.numel() * x.element_size() + sp.numel() * 4)
            bound, by = cs.bound_ms(0, nbytes, "bfloat16")
            made = a2a._POOLS.made if pooled else None
            row = dict(shape=list(shape), dtype=str(dtype)[6:],
                       splits=list(sp.shape), ms=cs.time_ms(fn),
                       device_us=cs.device_us(fn, key), host_us=_host_us(fn),
                       bound_us=bound * 1e3, bound_by=by, library_ms=lib_ms,
                       library_us=lib_us)
            if pooled:
                qq = q or 1
                seg = x.numel() // (n * n) * x.element_size()
                body = a2a._body_for(n, seg, qq, True)
                grid = _build.GridInfo()
                a2a._launch(name, x, sp, qq, q is not None, None,
                            grid=grid)
                blocks = grid.per_rank
                row["body"] = body
                row["host_parts_us"] = cs.a2a_host_parts(kernels, x, sp, q)
                row["pools_made_warm"] = a2a._POOLS.made - made
                row["body_us"] = {b: _forced(cs, x, sp, q, key, want,
                                             body=b)
                                  for b in a2a._BODIES}
                tiny = torch.ones((n, n, qq, 16), dtype=torch.uint8,
                                  device="cuda")
                row["floor_us"] = _forced(cs, tiny, sp, q, key,
                                          a2a.all_to_all_plain(tiny, sp),
                                          body=body, blocks=blocks)
                row["blocks"] = blocks
            rows[f"{label} {what}"] = row
            print(json.dumps({f"{label} {what}": row}), flush=True)
    layer = layer_ms(cs)
    print(json.dumps({"package": os.path.dirname(
        triton_dist_tpu_torch.__file__), "card": cs.card_line(),
        "rows": rows, "layer_ms": layer}), flush=True)


if __name__ == "__main__":
    main()

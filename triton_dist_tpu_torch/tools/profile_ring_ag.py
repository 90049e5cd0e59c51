"""The ring AllGather kernel's times at the main paths' shapes.

    python -m triton_dist_tpu_torch.tools.profile_ring_ag

bf16, world 4, inputs from chip_smoke.py's `rand`: ring_all_gather
(csrc/allgather.cu ring_ag_kernel) at (4, 128, 4096), the Qwen3-8B
prefill's shard (PERF.md row 8a), (4, 128, 2048) and (4, 64, 2048), the
Qwen3-30B-A3B `dist` prefill's and scheduler step's MoE gathers. Each
case is first called 20 times on one stream, every result held bitwise
against its plain version; then its call ms (CUDA events), device µs a
call (torch.profiler, chip_smoke.device_us), the wrapper's host µs a
call (time.perf_counter around 100 unsynchronised calls) and, where the
package keeps its flags in a pool (`allgather._POOLS`), those µs by part
(chip_smoke.ag_host_parts) and the pools made; the bound (n shards read
and n * n written once) and the library's one `expand().contiguous()`
(ms and device µs: a yardstick the port never calls). Prints one JSON
line. chip_smoke.py is loaded from this file's checkout and the kernel
from whichever `triton_dist_tpu_torch` is imported first, so two
versions compare in one run by pointing PYTHONPATH at each checkout in
turn and running this file by its path (old, new, new, old). Needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import time

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import allgather as agr
from triton_dist_tpu_torch.tools.profile_ring_rs import _chip_smoke

SHAPES = (("8B prefill", (4, 128, 4096)), ("30B dist prefill", (4, 128, 2048)),
          ("30B scheduler step", (4, 64, 2048)))
KEY = "ring_ag_kernel"


def _host_us(fn, calls=100):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def main() -> None:
    cs = _chip_smoke()
    rows = {}
    pooled = hasattr(agr, "_POOLS")
    for seed, (label, shape) in enumerate(SHAPES):
        x = cs.rand(shape, torch.bfloat16, seed)
        n, m = shape[:2]
        want = kernels.ring_all_gather_plain(x)
        for _ in range(20):
            if not torch.equal(kernels.ring_all_gather(x), want):
                raise AssertionError(f"{label}: not bitwise its plain "
                                     "version")

        def call(x=x):
            return kernels.ring_all_gather(x)

        def library(x=x, n=n, m=m):
            return x.reshape(1, n * m, -1).expand(n, -1, -1).contiguous()

        chunk = x[0].numel() * x.element_size()
        bound, by = cs.bound_ms(0, n * chunk + n * n * chunk, "bfloat16")
        made = agr._POOLS.made if pooled else None
        rows[label] = dict(
            shape=list(shape), ms=cs.time_ms(call),
            device_us=cs.device_us(call, KEY), host_us=_host_us(call),
            bound_us=bound * 1e3, bound_by=by,
            library_ms=cs.time_ms(library),
            library_us=cs.device_us_total(library))
        if pooled and hasattr(cs, "ag_host_parts"):
            rows[label]["host_parts_us"] = cs.ag_host_parts(kernels, x)
            rows[label]["pools_made_warm"] = agr._POOLS.made - made
    print(json.dumps({"package": os.path.dirname(
        triton_dist_tpu_torch.__file__), "card": cs.card_line(),
        "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

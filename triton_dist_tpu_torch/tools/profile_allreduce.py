"""The one-shot AllReduce kernel's device times at the main path's shapes.

    python -m triton_dist_tpu_torch.tools.profile_allreduce

bf16, world 4, inputs from chip_smoke.py's `rand`: one_shot_all_reduce
(csrc/allreduce.cu one_shot_ar_kernel) at (4, 4, 4096), a decode step's
O and down projections, and (4, 256, 4096), a scheduler step's. Each
case is first called 20 times on one stream, every result held bitwise
against its plain version; then its device µs a call (torch.profiler,
chip_smoke.device_us), its call ms (CUDA events, chip_smoke.time_ms),
the least time of the function (n inputs read and n outputs written at
3.35 TB/s) and the library's one sum `x.sum(0)` (ms and device µs: a
yardstick the port never calls). Where the package has the tile plan
(`allreduce._ar_plan`), also each tile of the sweep forced
(`allreduce._launch(x, tile)`), bitwise, the plan's pick, and each
instantiation's registers and spills from ptxas when this run built the
library. Prints one JSON line. chip_smoke.py is loaded from this file's
checkout and the kernel from whichever `triton_dist_tpu_torch` is
imported first, so two versions compare in one run by pointing
PYTHONPATH at each checkout in turn and running this file by its path
(old, new, new, old). Needs a CUDA card.
"""

from __future__ import annotations

import json
import os

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import _build, allreduce
from triton_dist_tpu_torch.tools.profile_ring_rs import _chip_smoke

SHAPES = {"decode step": (4, 4, 4096), "scheduler step": (4, 256, 4096)}
KEY = "one_shot_ar_kernel"


def _bitwise(fn, x, want, label):
    for _ in range(20):
        if not torch.equal(fn(x), want):
            raise AssertionError(f"{label}: not bitwise its plain version")


def main() -> None:
    cs = _chip_smoke()
    rows, sweep, plan = {}, {}, {}
    for label, shape in SHAPES.items():
        x = cs.rand(shape, torch.bfloat16, shape[1])
        want = kernels.one_shot_all_reduce_plain(x)
        _bitwise(kernels.one_shot_all_reduce, x, want, label)
        n, e = x.shape[0], x[0].numel()
        bound, _ = cs.bound_ms(0, 2 * n * e * x.element_size(), "bfloat16")
        rows[label] = dict(
            device_us=cs.device_us(lambda x=x: kernels.one_shot_all_reduce(x),
                                   KEY),
            ms=cs.time_ms(lambda x=x: kernels.one_shot_all_reduce(x)),
            bound_us=bound * 1e3,
            library_us=cs.device_us_total(lambda x=x: x.sum(0)),
            library_ms=cs.time_ms(lambda x=x: x.sum(0)))
        if not hasattr(allreduce, "_ar_plan"):
            continue
        plan[label] = allreduce._ar_plan(e, n, x.element_size(),
                                         _build.card_sms(x.device))
        for tile in allreduce._AR_TILES:
            def fn(x, tile=tile):
                return allreduce._launch(x, tile)
            _bitwise(fn, x, want, f"{label} tile {tile}")
            sweep[f"{label} tile {tile}"] = cs.device_us(
                lambda x=x, fn=fn: fn(x), KEY)
    out = {"package": os.path.dirname(triton_dist_tpu_torch.__file__),
           "card": cs.card_line(), "rows": rows}
    if plan:
        out.update(plan=plan, tile_sweep_device_us=sweep,
                   pools_made=allreduce._POOLS.made,
                   pools_at_zero=all(not bool(f.any()) for _, f in
                                     allreduce._POOLS.entries.values()),
                   ptxas=_build.ptxas_summary("allreduce",
                                              "one_shot_ar_kernel"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""The ring ReduceScatter kernels' device times at the main paths' shapes.

    python -m triton_dist_tpu_torch.tools.profile_ring_rs

bf16, world 4, inputs from chip_smoke.py's `rand`: ring_reduce_scatter
(csrc/reduce_scatter.cu ring_rs_kernel) at (4, 512 | 128 | 4, 2048), the
Qwen3-30B-A3B `dist` prefill, fused prefill and a decode row, and the
fp8 wire ring (ring_rs_wire_kernel) at (4, 512 | 4, 4096). Each case is
first called 20 times on one stream, every result held bitwise against
its plain version, then its device µs a call is read by torch.profiler
(chip_smoke.device_us). Prints one JSON line: the package's path, the
card, and µs by case. chip_smoke.py is loaded from this file's checkout
and the kernels from whichever `triton_dist_tpu_torch` is imported
first, so two versions of a kernel compare in one run by pointing
PYTHONPATH at each checkout in turn and running this file by its path
(old, new, new, old). Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels, wire


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    cs = _chip_smoke()
    us = {}
    fp8 = wire.WireFormat("fp8")
    cases = [(f"native {rows}", (4, rows, 2048), rows,
              kernels.ring_reduce_scatter, kernels.ring_reduce_scatter_plain,
              "ring_rs_kernel") for rows in (512, 128, 4)]
    cases += [(f"wire {rows}", (4, rows, 4096), rows + 1,
               lambda x: kernels.ring_reduce_scatter_wire(x, fp8),
               lambda x: kernels.ring_reduce_scatter_wire_plain(x, fp8),
               "ring_rs_wire_kernel") for rows in (512, 4)]
    for label, shape, seed, fn, plain, key in cases:
        x = cs.rand(shape, torch.bfloat16, seed)
        want = plain(x)
        for _ in range(20):
            if not torch.equal(fn(x), want):
                raise AssertionError(f"{label}: not bitwise its plain "
                                     "version")
        us[label] = cs.device_us(lambda x=x, fn=fn: fn(x), key)
    print(json.dumps({"package": os.path.dirname(
        triton_dist_tpu_torch.__file__), "card": cs.card_line(),
        "device_us": us}), flush=True)


if __name__ == "__main__":
    main()

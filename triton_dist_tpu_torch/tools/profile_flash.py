"""The local flash prefill kernel's times at the Qwen3-8B head shapes.

    python -m triton_dist_tpu_torch.tools.profile_flash

bf16, through chip_smoke.py's `time_flash_prefill` (the one timing path
of the flash kernels): its serve step (B 4, S 64, T 1024) and long
prefill (B 1, S = T = 2048), plus a world-4 scheduler step's rank rows
(B 16, Hq 8, Hkv 2 a rank, kv_len 178-375). Prints one JSON line a case:
ms a call (CUDA events), the kernel's device µs (torch.profiler), plain
and SDPA ms, and the bound. chip_smoke.py is loaded from this file's
checkout and the kernels from whichever `triton_dist_tpu_torch` is
imported first, so two versions of the kernel compare in one run by
pointing PYTHONPATH at each checkout in turn and running this file by
its path. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os

import torch

from triton_dist_tpu_torch.kernels import flash_prefill as fp


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
    rows = cs.fp_inputs(16, 64, cs.MAX_LEN, 8, 2, 128,
                        [114, 311, 193, 262] * 4, torch.bfloat16, seed=1)
    times = cs.time_flash_prefill(
        fp, extra=[("world-4 step rows B=16 S=64 T=1024 Hq=8 Hkv=2", rows)])
    card = torch.cuda.get_device_name(0)
    for label, row in times.items():
        print(json.dumps({"case": label, **row, "card": card}), flush=True)


if __name__ == "__main__":
    main()

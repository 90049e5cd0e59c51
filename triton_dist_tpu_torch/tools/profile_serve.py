"""Where the time of Qwen3-8B serving goes on one card.

    python -m triton_dist_tpu_torch.tools.profile_serve

Builds Qwen3-8B at full width and depth (bf16, random weights from seed
0), warms up, then traces under torch.profiler: one scheduler step of
the (slots=4, chunk=64) serve geometry with every slot prefilling, and
one batch-4 decode step. For each it prints the host wall time, the
device time summed over kernels, the device busy share, and the kernels
that took the most device time. Needs a CUDA card.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.serve import Scheduler

REPS = 2  # traced repetitions of each step
TOP = 12  # kernels listed per step


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _report(label: str, prof, wall_ms: float) -> None:
    # kernels only: an aten op reports its kernels' device time as well
    rows = [(e.key, _self_device_us(e), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3
    print(f"== {label}: wall {wall_ms:.3f} ms, kernels {dev_ms:.3f} ms, "
          f"busy {dev_ms / wall_ms:.3f}, {sum(r[2] for r in rows)} launches")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")
    print("  (wall: host clock over all traced repetitions, profiler on)")


def _traced(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")

    cfg = ModelConfig.qwen3_8b()
    eng = Engine(cfg, device="cuda", seed=0, max_len=512)
    rng = np.random.default_rng(0)

    # a scheduler step with all four slots prefilling 64-token chunks
    sch = Scheduler(eng, slots=4, chunk=64, page=64)
    for n in (300, 280, 260, 240):
        sch.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 2)
    sch.step()  # warm-up: admission + first chunk
    prof, wall = _traced(sch.step)
    _report("scheduler step (4 slots x 64-token prefill chunks, 36 layers)",
            prof, wall)

    # a batch-4 decode step over a 128-token history
    logits, cache = eng.prefill(rng.integers(0, cfg.vocab_size, (4, 128)))
    tok = logits.argmax(-1)
    eng.decode_step(tok, cache)  # warm-up

    def decode():
        nonlocal cache
        _, cache = eng.decode_step(tok, cache)

    prof, wall = _traced(decode)
    _report("decode step (batch 4, 36 layers)", prof, wall)


if __name__ == "__main__":
    main()

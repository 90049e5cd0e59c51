"""Where the time of Qwen3 serving goes on one card.

    python -m triton_dist_tpu_torch.tools.profile_serve [--world N]
        [--prefill-mode M] [--decode-mode M]
        [--model qwen3-8b|qwen3-30b-a3b] [--resident W]

Builds the model (default Qwen3-8B; qwen3-30b-a3b is the TP-MoE
Qwen3-30B-A3B, whose ~61 GB of bf16 weights are drawn straight at world
N, one copy) at full width and depth (bf16, random weights from seed 0)
at world N (default 1; N > 1 runs the virtual world of N ranks) with the
Engine's prefill and decode modes (default "ar" for both: at world > 1
the prefill takes gemm_rs + ring all-gather; "dist" takes ag_gemm and
gemm_rs; an MoE model's "dist" and "fused" MoE blocks take the ring AG
or the grouped ag_gemm, and the ring RS), warms up, then traces under
torch.profiler: one scheduler step of the (slots=4, chunk=64) serve
geometry with every slot prefilling and one batch-4 decode step (both
in the decode mode; a sequence-sharded decode mode needs N to divide
the batch of 4; its history a prefill of the prompt length below), and
one 4 x 128 prefill (the prefill mode; 4 x 32 in `fused`), eager and
then replayed. The scheduler and decode steps and the second prefill
replay their captured CUDA graphs (the warm-up step captures them). For
each it prints the host wall time, the
device time summed over kernels, the device busy share, and the kernels
that took the most device time. With --resident W it also traces
windows of the resident loop (Scheduler(resident=True, window=W), one
captured graph of W steps a window): two windows with all four slots
decoding (every step live), then an all-dead window (no slot active:
every step's forward runs with no live row), each per window and per
step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.serve import Scheduler

REPS = 2  # traced repetitions of each step
TOP = 12  # kernels listed per step
# name fragments of the port's hand-written kernels (csrc/*.cu; both
# bodies of gemm_rs, ag_gemm and the local flash kernel)
OWN = ("fp_local", "one_shot_ar_kernel", "ring_ag_kernel", "gemm_rs",
       "ag_gemm", "ring_rs_kernel")
MODELS = {"qwen3-8b": ModelConfig.qwen3_8b,
          "qwen3-30b-a3b": ModelConfig.qwen3_30b_a3b}


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
    rows.sort(key=lambda r: -r[1])
    # the largest rows, then the port's own kernels wherever they rank
    for key, us, n in rows[:TOP] + [r for r in rows[TOP:]
                                    if any(k in r[0] for k in OWN)]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {us / n:8.1f} us/call  "
              f"{key[:80]}")
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=1,
                    help="tensor-parallel ranks on the one card")
    ap.add_argument("--model", default="qwen3-8b", choices=tuple(MODELS),
                    help="the model geometry")
    ap.add_argument("--prefill-mode", default="ar",
                    choices=("ar", "dist", "xla", "fused"),
                    help="the Engine's prefill_mode (fused: MoE only)")
    ap.add_argument("--decode-mode", default="ar",
                    choices=("ar", "dist", "xla"),
                    help="the Engine's decode_mode (decode and serve steps)")
    ap.add_argument("--resident", type=int, default=0, metavar="W",
                    help="also trace windows of W resident steps")
    args = ap.parse_args()
    world = args.world
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")

    cfg = MODELS[args.model]()
    eng = Engine(cfg, device="cuda", seed=0, max_len=512, world=world,
                 prefill_mode=args.prefill_mode,
                 decode_mode=args.decode_mode)
    rng = np.random.default_rng(0)
    print(f"{args.model}, world {world}, prefill mode {args.prefill_mode}, "
          f"decode mode {args.decode_mode}, captured steps")
    L = cfg.num_layers

    # a scheduler step with all four slots prefilling 64-token chunks
    sch = Scheduler(eng, slots=4, chunk=64, page=64)
    for n in (300, 280, 260, 240):
        sch.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 2)
    sch.step()  # warm-up: admission + first chunk
    prof, wall = _traced(sch.step)
    _report(f"scheduler step (4 slots x 64-token prefill chunks, {L} "
            "layers)", prof, wall)

    # a 4 x 128 prefill (M = 512 rows; at world > 1 in `ar`: gemm_rs +
    # ring AG, in `dist`: ag_gemm and gemm_rs); a `fused` MoE prefill 4 x
    # 32, whose capacity-padded blocks at 4 x 128 do not fit beside the
    # Qwen3-30B-A3B weights
    plen = 32 if args.prefill_mode == "fused" else 128

    # a batch-4 decode step over a plen-token history
    logits, cache = eng.prefill(rng.integers(0, cfg.vocab_size, (4, plen)))
    tok = logits.argmax(-1)
    eng.decode_step(tok, cache)  # warm-up

    def decode():
        nonlocal cache
        _, cache = eng.decode_step(tok, cache)

    prof, wall = _traced(decode)
    _report(f"decode step (batch 4, {L} layers)", prof, wall)

    ids = rng.integers(0, cfg.vocab_size, (4, plen))
    for graphed in (False, True):
        eng.cuda_graph = graphed
        eng.prefill(ids)  # warm-up
        prof, wall = _traced(lambda: eng.prefill(ids))
        _report(f"prefill (4 x {plen} tokens, {L} layers), "
                f"{'replayed' if graphed else 'eager'}", prof, wall)

    if args.resident:
        _resident(eng, args.resident, rng)


def _resident(eng: Engine, window: int, rng) -> None:
    """REPS windows of `window` live steps (four slots decoding), then an
    all-dead window, traced."""
    cfg = eng.cfg
    sch = Scheduler(eng, slots=4, chunk=64, page=64, resident=True,
                    window=window)
    for n in (60, 50, 40, 30):
        sch.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   (REPS + 2) * window)
    w, loop = sch.worker, sch.worker._fn
    sch._admit_resident()
    w.run_window()  # the one-chunk prefills, the capture (full windows)
    steps0 = w.n_steps
    prof, wall = _traced(w.run_window)
    live = w.n_steps - steps0
    _report(f"resident window ({window} steps, 4 slots decoding; "
            f"{live} live steps over {REPS} windows; per step: wall "
            f"{wall / (REPS * window):.3f} ms)", prof, wall)
    idle = np.zeros_like(w.slot_state)
    prof, wall = _traced(lambda: loop(loop.ring, 0, 0, 0, idle, w._table,
                                      w._lengths, sch.pool.k, sch.pool.v))
    _report(f"all-dead window ({window} dead steps; per step: wall "
            f"{wall / (REPS * window):.3f} ms)", prof, wall)
    for steps, g in sorted(loop.graphs.items()):
        print(f"  window graph of {steps} steps: capture {g.capture_s:.3f} "
              f"s, pool {g.pool_bytes / 1e6:.1f} MB, launches a replay "
              f"{g.launches}")


if __name__ == "__main__":
    main()

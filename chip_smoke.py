#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (triton_dist_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, or when run
outside a checkout of the repository. Phases, each fatal on failure:

  1. environment: card name and power limit, torch / CUDA / nvcc
     versions, SM count;
  2. build every kernel of the port from csrc/ with nvcc (in parallel);
  3. each kernel against its plain PyTorch version on the card: flash
     prefill at edge cases, the Qwen3-8B engine-prefill and serve-step
     shapes and a long prefill, and its wgmma fold at the serve step, the
     long prefill and the world-4 recorded step with every split count
     forced, a NaN cache tail past kv_len and a one-hot V; one-shot
     AllReduce, ring AllGather and
     gemm_rs at n = 2 and 4 (gemm_rs also n = 1, force_kernel), ragged
     sizes, M = 1 and the world-4 main-path shapes (the AllReduce also
     with every tile of its sweep forced); ag_gemm at n = 1
     (force_kernel), 2 and 4, both C orders, plain and silu_pair,
     return_gathered, m = 1, 64, 128 and ragged, N not a tile multiple,
     and its wgmma body at the world-4 dist path's Qwen3-8B shapes (QKV,
     gate|up; m 128 and 64), bf16 and f32 out, every tile width forced;
     gemm_rs with A in arrival order at n = 2 and 4, and its wgmma body
     at the dist path's O and down shapes (m 128 and 64), every tile
     width forced, each rank delayed, 50 calls leaving its persistent
     counters at zero; f32 and bf16; the
     ring ReduceScatter bitwise at n = 1 (force_kernel), 2 and 4 in f32,
     bf16 and bf16 with f32 accumulation, every tile forced, each rank
     delayed, and 50 calls back to back with the wire ring that leave
     its persistent flag pools at zero; the grouped ag_gemm (silu_pair,
     gate and up as views of one stack) at n = 2 and 4, cap 16, 64 and
     256, both orders; grouped_gemm's card route (torch._grouped_mm) at
     the Qwen3-30B-A3B shapes, with empty groups and trailing rows; the
     grouped_gemm's f32 route (the grouped_gemm_f32 kernel) and its host
     sizes route at the same shapes, a skewed routing too; the
     full-mesh AllGather, p2p_send / p2p_read and ring_shift bitwise at
     n = 2 and 4, f32 / bf16 / uint8, ragged and odd sizes, src = dst,
     shift in {1, -1, 3, n + 1}, and with rank 0 delayed;
  4. the main path, three times: Qwen3-8B at full width and depth,
     bf16, random weights from a seed, at world 1; then, on the same
     weights sharded by shard_params, at world 4 on the virtual world in
     the `ar` mode; then at world 4 with the Engine's default modes (a
     `dist` prefill, an `ar` decode) and a `dist` Scheduler; each
     through Engine.serve and the continuous-batching Scheduler, with
     every kernel's launch count read around it (ag_gemm's, gemm_rs's
     and the flash kernel's by body: every call of the serve and the
     Scheduler on the wgmma body) and the inputs of each
     kernel's first- and last-layer calls recorded; then the kernel
     path's logits against the plain versions' (and, for `dist`, the
     `xla` prefill's), and a small f32 model on the card against the CPU
     at world 1 and 4 (`ar` and `dist`);
  4g. inside each model path (4, 4m, 4b) and in 4s, 4e and 4p: the
     captured steps against the eager ones. The Engine and MegaQwen3
     replay CUDA graphs of their prefill, decode and serve steps on the
     card by default, so the main path's serve, Scheduler and megakernel
     steps above are replays (a replay counts the launches its capture
     recorded; a decode or serve capture runs the step once eagerly
     first, counted too; a prefill's first call of a shape is that
     warm-up, its result the call's). For the prefill (the path's mode,
     and 30B `fused`), the `ar` decode (and the Scheduler's mode where
     it is another), the serve step and the megakernel step: the
     replay's logits, tokens and cache (or pools) bitwise the eager
     step's from the same state (greedy and seeded sampling; a Scheduler
     each way on the same 6 requests), eager and replayed ms (ms/token,
     tokens/s for the Scheduler), capture s, the graph's pool bytes,
     device kernels (and a prefill's memsets) a step each way, peak GB,
     and no capture on a fresh cache of a known shape; in 4s the SP
     decode step (its LL call count a device word), in 4e the EP layer
     (M 128 sequential and overlap q 4, M 1 sequential and overlap q 1)
     and in 4p the whole PP schedule, each captured through
     `runtime.graphs.compiled` and replayed bitwise its eager run, with
     ms both ways, capture s and pool bytes;
  4r. the resident serving loop, after phase 4w, on phase 4's world-1
     weights: phase 4's six Scheduler requests (two sampled) through
     the host loop and through Scheduler(resident=True, window=16) on one
     Engine (Qwen3-8B, 36 layers, world 1), then at world 4 `ar` and
     `dist` on a 4-layer draw of Qwen3-8B's widths; the resident tokens
     bitwise the host loop's, greedy and sampled; the timed run's
     launches pinned (a window of W steps, W <= 16 as the Scheduler sizes
     it: W forwards, W sample_slots, W ring_emit, W + 1 ring_boundary)
     and its host syncs counted (one a window, its read); tokens/s both
     ways, windows and their lengths, live and dead steps, an all-dead
     window's ms, capture s and pool bytes of each window length's
     graph, peak GB; ring_boundary / ring_emit bitwise their plain
     versions on the recorded window inputs and 200 random states
     (half their admissions with a prefix-cache hit), sample_slots
     tokens equal and its keys and random bits bitwise at the
     vocabulary; each timed beside its bound and plain version
     (sample_slots also beside torch.multinomial);
  4h. the prefix cache, after 4r, on phase 4's world-1 weights: one
     512-token system prompt drawn from the seed and 8 requests behind
     it (suffixes of 32-160 tokens, 16 new tokens each, two sampled at
     T 0.9), wave 1 request 0 alone, wave 2 the other 7 together, on
     one Engine (Qwen3-8B, 36 layers, world 1; then world 4 `ar` on a
     4-layer draw of its widths) three ways: the cache off (the
     oracle), Scheduler(prefix_cache=True, prefix_block=64) in the host
     loop, and the same with resident=True, window=16; each way a first
     run (its captures) and a timed run whose launches are pinned; every
     stream of the cached runs bitwise the oracle's, each wave-2 request
     a hit of 512 tokens (7 hits, 1 miss), the pool's and the trie's
     invariants after each run; wave 2's TTFT p50 / p99, serve steps,
     prefill chunk steps, tokens/s, hits, misses, pages shared, free
     pages and peak GB each way; ring_boundary / ring_emit bitwise their
     plain versions on the resident run's recorded windows (the wave-2
     admissions carry IR_PREFIX 512) and 50 random states;
  4m. the fifth path, between the world-1 and world-4 Qwen3-8B runs of
     phase 4, on the same weights: the decode megakernel. The Engine's
     4 x 128 prefill, then 16 greedy steps of MegaQwen3, one `mega`
     launch each, at world 1 and at world 4 (a `dist` prefill), launch
     counts pinned, the weight pipeline's arena depth and its fed and
     cold matmul rows printed and held to the prefetch plan's; the
     kernel against run_plain on the first step's recorded inputs
     (logits within twice the one-ulp band), the eager Engine's decode
     of the same prefill beside it; ms a token on CUDA events and the
     host clock, the launch's device time against its bound; a batch-1,
     context-512 figure at world 1. (Phase 3 also holds every
     megakernel branch against run_plain at the Qwen3-8B widths of
     world 1 and 4, dense and paged KV, at arena depths 1 and auto (2),
     its fed and cold rows the plan's.)
  4s. the sixth path, after 4m at world 1, on layer 0's attention
     weights of the same Qwen3-8B draw: SP long-context attention on the
     virtual world of 4. An SP prefill of 4 rows x 32768 positions (8192
     a rank, a ragged kv_len with one row just under each shard
     boundary: QKV product, q/k-norm, rope, sp_flash_prefill, O
     product), whose K/V segments are the cache shards, then 16 SP decode
     steps threading one low-latency AllGather context, its call count a
     device word that the step advances: 16 replays of the step captured
     (on a scratch state) before the counted window; launches pinned
     (1 sp_flash_prefill, 16 flash_decode_partial, 16 ll_all_gather);
     the replays bitwise the same 16 steps eager, whose kernel calls are
     recorded for the checks below.
     The decode partial against its plain version on every step's inputs
     (epsilon band), the LL AllGather bitwise over all 16 calls (and
     its context's slots and parity flags a plain twin's after each), each
     step bitwise the same step with the partials gathered by a torch
     copy; SP prefill against its plain version on sampled rows and
     whole at 4 x 4096 (band), and bitwise itself with rank 0, then rank
     3, delayed; prefill ms and decode ms/step (eager and replayed), and
     each kernel's time (the LL AllGather with a host and a device count);
  4p. the eighth path, after 4s, on the same world-1 draw: PP at full
     width, 4 virtual stages of 9 of the 36 layers (models.pp_stage_fn,
     no KV cache) over 4 microbatches of 1 x 512 tokens embedded by the
     model: one pp_schedule_fwd (7 ring_shift launches), one
     send_backward, a p2p_send (stage 3 -> 0) and a p2p_read; launches
     pinned; the output bitwise each microbatch alone through the 36
     layers, every ring_shift / p2p_send launch bitwise its plain
     version; p2p_send 50 calls back to back (ragged, 4 MiB and 8 MiB a
     rank, each rank delayed in turn) leaving its delivery pool at zero,
     no pool made by a warm call; ms a schedule, the two kernels' times;
  4c. the ninth path, no weights: the collective library's entry points
     at Qwen3-8B widths, world 4, on shards of (4, 4096), (128, 4096)
     (1 MiB: Auto's full mesh), (129, 4096) (Auto's ring), (512, 4096)
     bf16 and (64, 4096) f32: all_gather by every method and Auto,
     all_reduce by OneShot, TwoShot, XLA and Auto, reduce_scatter_op and
     the three *_op wrappers; launches pinned; each bitwise its plain
     fold, AllReduce methods against the XLA fold by the epsilon band;
     full mesh against ring AG times, the ring RS's rows (call ms,
     device us, host us by part, library ms and device us, the bound's
     share), and the one-shot / two-shot
     AllReduce sweep (4 KiB to 256 KiB a rank, n = 2 and 4) that sets
     the library's Auto crossover;
  4w. the tenth path, no weights: the quantized wire at Qwen3-8B
     widths, world 4, bf16, seed 0, on fp8, int8 and int8 block 128:
     reduce_scatter_op and all_reduce_op on per-rank (512, 4096) and
     (4, 4096) (ring_rs_wire_kernel), all_gather ring and full mesh on
     (128, 4096) and three ll_all_gather calls on (4, 4096) (the images
     through the native kernels; the context's slots and parity flags
     a plain twin's after each call), ag_gemm at QKV and gate|up (fp8, int8)
     and gemm_rs at down and O (the partial GEMM, then the wire ring);
     launches pinned; RS bitwise its plain version, AR bitwise
     wire.simulate_allreduce, the gathers bitwise the roundtrip, gemm_rs
     bitwise the plain fold of its own partials and in the band's cosine
     end to end, ag_gemm in the bf16 band; every drift against the
     native fold at most DEFAULT_ERROR_BUDGET; each call's ms, device
     us and bound beside the native kernel's ms (the RS rows also the
     wrapper's host us by part and the native sum's ms and device us);
  5. every kernel against its plain version on the inputs recorded in
     phase 4, and its timing there (flash prefill also at two synthetic
     Qwen3-8B shapes), beside its bound over the work of all ranks, its
     plain version and one PyTorch library call (a yardstick only, its
     device time too); the device time of the virtual-world kernels from
     torch.profiler; the one-shot AllReduce 50 calls back to back on the
     recorded decode and scheduler inputs (bitwise, every pool flag left
     at zero, no pool made by a warm call, the pools' bytes) and its tile
     sweep;
  4b. the fourth path, after the Qwen3-8B weights are freed: Qwen3-30B-
     A3B (TP-MoE, 128 experts, top-8) at full width and depth, bf16,
     random weights drawn on the card at world 4 (one copy, ~61 GB), with
     the Engine's default modes (Engine.serve 4 x 128, +16 tokens), a
     `dist` Scheduler, and a `fused` prefill of 4 x 32 (the longest
     prompt whose capacity-padded transients fit beside the weights),
     launch counts pinned; the same logits checks, the fused prefill's
     too; a small f32 MoE model on the card against the CPU in `dist`
     and `fused`;
  5b. the ring ReduceScatter (bitwise), the grouped ag_gemm and
     grouped_gemm against their plain versions on the inputs recorded in
     4b (the other kernels too), and the kernels' timing there (the
     grouped f32 down product at a decode step's, a scheduler step's and
     the prefill's inputs, beside one bmm over the padded blocks); the ring
     RS at the dist prefill, scheduler step and fused prefill shapes with
     the host us by part and the library's device us, its tile sweep
     (2048, 4096, 8192 elements) and the bytes its persistent pools hold;
  4e. the seventh path, after 5b, on layer 0 of the same Qwen3-30B-A3B
     draw re-laid for EP (32 whole experts a rank): ep_moe_fwd at world
     4 over the MoE all-to-all kernels, 128 tokens a rank sequential and
     overlap at n_chunks 1, 2, 4, 1 token a rank, and a tight capacity
     that drops pairs, and the fp8 wire (payload_dtype float8_e4m3fn)
     at 128 tokens a rank sequential and overlap q 2; launches pinned;
     every A2A launch bitwise its plain version, every run bitwise over
     the plain transports, the fp8 wire within DEFAULT_ERROR_BUDGET of
     the bf16 wire with equal drops,
     sequential and overlap in the bf16 band of each other with equal
     drops, each expert-FFN product against grouped_gemm_plain, EP
     against the TP-MoE `dist` block on the same layer (f32 band; bf16
     against f32 by the band's cosine), the chunked kernel bitwise under
     a 5 ms straggler; the
     layer's ms, the kernels' times, host syncs a call, peak memory;
  6. the kernels line (JSON), the card line, and the result line.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet, dense): the least
# time a kernel could take is the larger of bytes / HBM rate and
# operations / the peak rate of the operands' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# max abs error allowed between a kernel and its plain version
F32_ATOL = 1e-4   # f32 sums over up to 2k keys in another order
BF16_ATOL = 2e-2  # both outputs rounded to bf16 (8 mantissa bits), |out| < 2

# the engine's horizon: the paged pool and the dense cache hold this many
# positions, so every multi-token attention on the main path has T = 1024
MAX_LEN = 1024
# the fused MoE prefill's prompt length (4 prompts): exact capacity pads
# every expert block to 4 ranks' worth of m_tok * 8 rows, so 4 x 128
# (~29 GB of transients) does not fit beside Qwen3-30B-A3B's ~61 GB of
# weights and 4 x 32 (cap 256, ~7-11 GB) does (PERF.md)
FUSED_LEN = 32


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- the flash-prefill kernel ---------------------------------------------


def fp_inputs(b, s, t, hq, hkv, d, starts, dtype, seed, causal=True):
    """q/k/v from a seeded generator on the card; row i's queries sit at
    positions starts[i] + [0, S) and its kv_len is starts[i] + S (the
    serve step's form), clamped to T."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.5).to(dtype)

    q, k, v = rnd(b, s, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d)
    st = torch.tensor(starts, device="cuda")
    qpos = (st[:, None] + torch.arange(s, device="cuda")[None]).contiguous()
    kv_len = (st + s).clamp(max=t)
    return dict(q=q, k=k, v=v, q_positions=qpos, kv_len=kv_len,
                causal=causal)


def bf16_atol(inp) -> float:
    """BF16_ATOL for outputs below 2; the output is a convex mix of v
    rows, so beyond that the rounding error grows with max |v|."""
    return BF16_ATOL * max(1.0, inp["v"].float().abs().max().item() / 2)


def fp_work(inp) -> tuple:
    """(operations, bytes) this call's data needs: the live (query, key)
    pairs times 4*D per query head, and each needed input byte read once
    (K/V rows up to min(kv_len, last position + 1)) plus the output."""
    q, k = inp["q"], inp["k"]
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qpos = inp["q_positions"].long().cpu()
    kv_len = inp["kv_len"].long().cpu()
    live = 0
    kv_rows = 0
    for i in range(b):
        n = int(kv_len[i])
        if inp["causal"]:
            live += int((qpos[i] + 1).clamp(min=0, max=n).sum())
            kv_rows += max(0, min(n, int(qpos[i].max()) + 1))
        else:
            live += s * n
            kv_rows += n
    item = q.element_size()
    ops = 4 * d * hq * live
    nbytes = (2 * q.numel() * item + 2 * kv_rows * hkv * d * item
              + 4 * (b * s + b))
    return ops, nbytes


def bound_ms(ops, nbytes, dtype_name):
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sdpa_call(inp):
    """One torch call computing the same function (a timing yardstick,
    never used by the port): SDPA with GQA and a boolean live mask."""
    import torch
    import torch.nn.functional as F

    q, k, v = (inp[n].transpose(1, 2) for n in ("q", "k", "v"))
    t = k.shape[2]
    kpos = torch.arange(t, device="cuda")
    live = kpos[None, None, :] < inp["kv_len"][:, None, None]
    if inp["causal"]:
        live = live & (kpos[None, None, :] <= inp["q_positions"][:, :, None])
    mask = live[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_flash_prefill(fp):
    """Kernel against plain on the card. Returns the max abs error at the
    Qwen3-8B shapes in bf16, the dtype of the main path."""
    import torch

    cases = [
        # (label, b, s, t, hq, hkv, d, starts, causal)
        ("edge d128 causal", 3, 16, 64, 4, 2, 128, [7, -16, 48], True),
        ("edge d128 full", 3, 16, 64, 4, 2, 128, [7, -16, 48], False),
        ("edge d64 causal", 3, 16, 64, 4, 2, 64, [7, -16, 48], True),
        ("edge ragged T", 1, 8, 23, 2, 1, 128, [15], True),
        ("edge G=1 ragged", 2, 33, 95, 3, 3, 64, [50, 0], True),
        ("qwen3-8b engine prefill", 4, 128, MAX_LEN, 32, 8, 128,
         [0, 0, 0, 0], True),
        ("qwen3-8b serve step", 4, 64, MAX_LEN, 32, 8, 128,
         [960, 600, 200, 0], True),
        ("qwen3-8b long prefill", 1, 2048, 2048, 32, 8, 128, [0], True),
    ]
    main_err = 0.0
    for label, b, s, t, hq, hkv, d, starts, causal in cases:
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            inp = fp_inputs(b, s, t, hq, hkv, d, starts, dtype, seed=b + s,
                            causal=causal)
            got = fp.flash_prefill_local(**inp)
            want = fp.flash_prefill_plain(**inp)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            log(f"  flash_prefill {label:24s} {str(dtype)[6:]:9s} "
                f"max_abs_err={err:.3e} (atol {atol:g})")
            if not finite or not err <= atol:
                raise AssertionError(f"flash_prefill {label} {dtype}: "
                                     f"err {err} finite {finite}")
            if label.startswith("qwen3") and dtype == torch.bfloat16:
                main_err = max(main_err, err)
        # a row with no live key is exactly 0 (kv_len 0 / start -16)
        if label == "edge d128 causal":
            assert float(got[1, :16].float().abs().max()) == 0.0
    return main_err


# the wgmma fold's split counts the card checks force (and the sweep)
FP_SPLITS = (1, 2, 3, 4)
# a shape whose row tiles leave most SMs idle, where the plan splits:
# one request's 64-token step against a 1k cache (the sweep's fourth)
FP_ONE_REQUEST = ("one-request step", 1, 64, MAX_LEN, 32, 8, 128, [960])
# the world-4 recorded scheduler step's rank rows (B 4 x 4 ranks, Hq 8,
# Hkv 2 a rank): kv_len 178-375 (PERF.md)
FP_RECORDED = (16, 64, MAX_LEN, 8, 2, 128, [114, 311, 193, 262] * 4)


def fp_main_shapes():
    """(label, b, s, t, hq, hkv, d, starts) of the local flash kernel's
    main-path shapes: Qwen3-8B's world-1 serve step and long prefill, and
    the world-4 recorded scheduler step."""
    return [("serve step", 4, 64, MAX_LEN, 32, 8, 128, [960, 600, 200, 0]),
            ("long prefill", 1, 2048, 2048, 32, 8, 128, [0]),
            ("world-4 recorded step", *FP_RECORDED)]


def check_flash_wgmma(fp):
    """The wgmma fold at the main-path shapes (fp_main_shapes), every
    split count of FP_SPLITS forced, against flash_prefill_plain within
    bf16_atol and the epsilon band; then with the cache's K and V past
    kv_len set to NaN (a recycled page: the fold must not read them) and
    with a one-hot V (v[t, h, d] = 1 where d = (t + h) mod 128: the
    register layout of P as the P.V product's A operand); every launch
    on the wgmma fold."""
    import torch

    before = dict(fp.launches_by_body)
    calls = 0
    for label, b, s, t, hq, hkv, d, starts in fp_main_shapes():
        inp = fp_inputs(b, s, t, hq, hkv, d, starts, torch.bfloat16,
                        seed=b + s)
        atol = bf16_atol(inp)
        want = fp.flash_prefill_plain(**inp)
        k_nan, v_nan = inp["k"].clone(), inp["v"].clone()
        for i in range(b):
            k_nan[i, int(inp["kv_len"][i]):] = float("nan")
            v_nan[i, int(inp["kv_len"][i]):] = float("nan")
        tt = torch.arange(t, device="cuda")[:, None, None]
        hh = torch.arange(hkv, device="cuda")[None, :, None]
        dd = torch.arange(d, device="cuda")[None, None, :]
        onehot = (dd == (tt + hh) % d).to(torch.bfloat16).expand(
            b, t, hkv, d).contiguous()
        runs = [(f"splits {sp}", inp, want, sp) for sp in FP_SPLITS]
        runs += [("NaN past kv_len", dict(inp, k=k_nan, v=v_nan), want,
                  None),
                 ("one-hot V", dict(inp, v=onehot),
                  fp.flash_prefill_plain(**dict(inp, v=onehot)), None)]
        for what, x, ref, sp in runs:
            got = fp._launch(x["q"], x["k"], x["v"], x["q_positions"], 0,
                             x["kv_len"], True, None, body="wgmma",
                             splits=sp)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if not bool(torch.isfinite(got).all()) or not err <= atol:
                raise AssertionError(f"flash_prefill wgmma {label} {what}: "
                                     f"err {err}, atol {atol}")
            band(ref, got, "flash_prefill")
            calls += 1
        log(f"  flash_prefill wgmma fold {label} (B {b}, S {s}, T {t}, Hq "
            f"{hq}, Hkv {hkv}): splits {FP_SPLITS} forced, NaN past kv_len,"
            f" one-hot V: within {atol:.3g} and the band (plan "
            f"{fp._fp_plan(b, s, t, hq, hkv, d, torch.bfloat16)})")
    got = {k: v - before[k] for k, v in fp.launches_by_body.items()}
    assert got == {"mma": 0, "wgmma": calls}, got


def time_flash_prefill(fp, extra=()):
    """Kernel, plain and SDPA times at the two synthetic Qwen3-8B shapes
    and at each (label, inputs) pair of `extra`."""
    import torch

    cases = [(label, fp_inputs(b, s, t, 32, 8, 128, starts, torch.bfloat16,
                               seed=1))
             for label, b, s, t, starts in (
                 ("serve step B=4 S=64 T=1024", 4, 64, MAX_LEN,
                  [960, 600, 200, 0]),
                 ("long prefill B=1 S=T=2048", 1, 2048, 2048, [0]))]
    rows = {}
    for label, inp in [*cases, *extra]:
        ops, nbytes = fp_work(inp)
        bnd, by = bound_ms(ops, nbytes, "bfloat16")
        row = dict(
            ms=time_ms(lambda: fp.flash_prefill_local(**inp)),
            device_us=device_us(lambda: fp.flash_prefill_local(**inp),
                                "fp_local"),
            plain_ms=time_ms(lambda: fp.flash_prefill_plain(**inp)),
            bound_ms=bnd, bound_by=by,
            library_ms=time_ms(sdpa_call(inp)),
            library_us=device_us_total(sdpa_call(inp)),
            gflop=ops / 1e9, mbytes=nbytes / 1e6)
        if hasattr(fp, "_fp_plan"):  # the fold and split count it took
            b, s, hq, d = inp["q"].shape
            row["plan"] = fp._fp_plan(b, s, inp["k"].shape[1], hq,
                                      inp["k"].shape[2], d, inp["q"].dtype)
        log(f"  flash_prefill {label}: kernel {row['ms']:.4f} ms, device "
            f"{row['device_us']} us, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms / "
            f"{row['library_us']} us device, bound {bnd:.4f} ms ({by}; "
            f"{row['gflop']:.2f} GFLOP, {row['mbytes']:.2f} MB)")
        rows[label] = row
    return rows


# -- the collective kernels of the virtual world ---------------------------


def rand(shape, dtype, seed, scale=1.0):
    """Seeded normal values on the card, rounded to dtype."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def gemm_rs_atol(a, b, want) -> float:
    """Kernel and plain both round each rank's partial to the output
    dtype and fold in rank order; their f32 products differ only in the
    order of the K sums. bf16: one bf16 ulp (2^-7 relative) of every
    partial and of the output; f32: 1e-5 relative to the larger of the
    partials and the output."""
    import torch

    n = a.shape[0]
    part = torch.matmul(a.float(), b.float()).abs().max().item()
    top = want.float().abs().max().item()
    if a.dtype == torch.bfloat16:
        return 2.0 ** -7 * (n * part + top)
    return 1e-5 * max(1.0, part, top)


def check_ar(kernels, x) -> None:
    """AllReduce kernel against plain: bitwise, every rank's copy alike."""
    import torch

    got = kernels.one_shot_all_reduce(x)
    want = kernels.one_shot_all_reduce_plain(x)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want)) and bool((got == got[:1]).all())
    if not same:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"one_shot_all_reduce {tuple(x.shape)} "
                             f"{x.dtype}: not bitwise (max abs err {err})")


def check_ag(kernels, x) -> None:
    """AllGather kernel against plain: bitwise."""
    import torch

    got = kernels.ring_all_gather(x)
    want = kernels.ring_all_gather_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"ring_all_gather {tuple(x.shape)} {x.dtype}: "
                             "not bitwise")


def check_rs(kernels, a, b, force_kernel=False, a_order="rank"):
    """gemm_rs kernel against plain, within gemm_rs_atol. Returns the
    max abs error and its share of the atol."""
    import torch

    got = kernels.gemm_rs(a, b, force_kernel=force_kernel, a_order=a_order)
    want = kernels.gemm_rs_plain(a, b, a_order)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = gemm_rs_atol(a, b, want)
    if not bool(torch.isfinite(got).all()) or not err <= atol:
        raise AssertionError(f"gemm_rs a {tuple(a.shape)} b "
                             f"{tuple(b.shape)} {a.dtype}: err {err}, atol "
                             f"{atol}")
    return err, err / atol


def check_collectives(kernels):
    """Each collective kernel against its plain version on the card at
    n = 2 and 4 (gemm_rs also at n = 1 with force_kernel), f32 and bf16:
    ragged sizes, M = 1, sizes whose rows are not 16-byte multiples, and
    the Qwen3-8B main-path shapes at world 4; the AllReduce also with
    every tile of its sweep forced."""
    import torch

    from triton_dist_tpu_torch.kernels import allreduce as ar

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for n in (2, 4):
            for m, w in ((1, 4096), (3, 1000), (5, 7), (4, 4096),
                         (256, 4096)):
                check_ar(kernels, rand((n, m, w), dtype, m + w, 0.5))
            for m in (4, 256):  # every tile of the sweep, forced
                x = rand((n, m, 4096), dtype, m + n, 0.5)
                want = kernels.one_shot_all_reduce_plain(x)
                for tile in ar._AR_TILES:
                    if tile * x.element_size() <= ar._AR_TILE_BYTES:
                        assert torch.equal(ar._launch(x, tile), want), (
                            n, m, dn, tile)
            log(f"  one_shot_all_reduce n={n} {dn}: M x N in (1, 4096), "
                "(3, 1000), (5, 7), (4, 4096), (256, 4096), and every tile "
                "forced at (4 | 256, 4096): bitwise, every rank's copy "
                "alike")
            for m, w in ((1, 4096), (3, 1000), (5, 7), (128, 4096)):
                check_ag(kernels, rand((n, m, w), dtype, m * w, 0.5))
            log(f"  ring_all_gather n={n} {dn}: m x W in (1, 4096), "
                "(3, 1000), (5, 7), (128, 4096): bitwise")
        shapes = [(1, 1, 64, 64, True), (1, 200, 136, 200, True),
                  (2, 8, 64, 128, False), (2, 6, 136, 200, False),
                  (4, 12, 128, 264, False), (4, 1024, 64, 72, False),
                  (4, 512, 1024, 4096, False), (4, 512, 3072, 4096, False)]
        for n, M, K, N, force in shapes:
            a = rand((n, M, K), dtype, M + K, 1.0)
            b = rand((n, K, N), dtype, K + N, 0.02)
            _, ratio = check_rs(kernels, a, b, force_kernel=force)
            worst = max(worst, ratio)
            log(f"  gemm_rs n={n} M={M} K={K} N={N} {dn}"
                f"{' force_kernel' if force else ''}: at most {ratio:.3f} "
                "of its atol")
    return worst


def products(a, w):
    """The gathered A times every rank's b in f32; for a grouped b (n, E,
    K, N), each chunk's expert block e times b[r][e]."""
    import torch

    full = a.reshape(-1, a.shape[-1]).float()
    if w.dim() == 3:
        return torch.matmul(full, w.float())
    n, e, k, _ = w.shape
    return torch.einsum("sepk,rekn->rsepn", full.reshape(n, e, -1, k),
                        w.float())


def ag_gemm_atol(a, b, want) -> float:
    """Kernel and plain both accumulate in f32 and round once; their f32
    sums run in another order. bf16: one ulp (2^-7 relative) of the
    largest output, plus the f32 term; f32: 1e-5 relative to the
    products (for silu_pair, to max|gate| x max|up|)."""
    import torch

    ws = b if isinstance(b, tuple) else (b,)
    prods = [products(a, w).abs().max().item() for w in ws]
    scale = max(1.0, prods[0]) * (max(1.0, prods[1]) if len(ws) == 2 else 1)
    ulp = 2.0 ** -7 * want.float().abs().max().item()
    return (ulp if a.dtype == torch.bfloat16 else 0.0) + 1e-5 * scale


def check_ag_gemm_call(kernels, a, b, force_kernel=False, **kw):
    """ag_gemm kernel against plain, within ag_gemm_atol (the gathered A
    of return_gathered bitwise). Returns the max abs error and its share
    of the atol."""
    import torch

    got = kernels.ag_gemm(a, b, force_kernel=force_kernel, **kw)
    want = kernels.ag_gemm_plain(a, b, **kw)
    torch.cuda.synchronize()
    if kw.get("return_gathered"):
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"ag_gemm {tuple(a.shape)}: the gathered "
                                 "A is not bitwise")
        got, want = got[0], want[0]
    err = (got.float() - want.float()).abs().max().item()
    atol = ag_gemm_atol(a, b, want)
    if not bool(torch.isfinite(got).all()) or not err <= atol:
        raise AssertionError(f"ag_gemm a {tuple(a.shape)} {kw} {a.dtype}: "
                             f"err {err}, atol {atol}")
    return err, err / atol


def check_ag_gemm(kernels):
    """ag_gemm kernel against its plain version on the card at n = 1
    (force_kernel), 2 and 4, f32 and bf16: both C orders, plain and
    silu_pair, return_gathered; m = 1, 64, 128 and a ragged 37, N not a
    multiple of the tile; then gemm_rs with A in ring-arrival order at
    n = 2 and 4 (n = 4 tells a wrong slot that n = 2's self-inverse
    permutation hides). Returns the largest share of an atol."""
    import torch

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for n in (1, 2, 4):
            for m, K, N in ((1, 512, 200), (37, 256, 200), (64, 512, 264),
                            (128, 512, 1536)):
                a = rand((n, m, K), dtype, n + m + K, 1.0)
                wg = rand((n, K, N), dtype, K + N, 0.05)
                wu = rand((n, K, N), dtype, K + N + 1, 0.05)
                ratio = 0.0
                for b, ep in ((wg, None), ((wg, wu), "silu_pair")):
                    for order in ("rank", "arrival"):
                        _, r = check_ag_gemm_call(
                            kernels, a, b, force_kernel=True, epilogue=ep,
                            c_order=order)
                        ratio = max(ratio, r)
                _, r = check_ag_gemm_call(kernels, a, wg, force_kernel=True,
                                          return_gathered=True)
                ratio = max(ratio, r)
                worst = max(worst, ratio)
                log(f"  ag_gemm n={n} m={m} K={K} N={N} {dn}: both orders, "
                    f"plain and silu_pair, return_gathered: at most "
                    f"{ratio:.3f} of its atol")
        for n in (2, 4):
            for M, K, N in ((8 * n, 136, 200), (128 * n, 512, 264)):
                a = rand((n, M, K), dtype, M + K + 7, 1.0)
                b = rand((n, K, N), dtype, K + N + 7, 0.02)
                _, ratio = check_rs(kernels, a, b, a_order="arrival")
                worst = max(worst, ratio)
                log(f"  gemm_rs a_order=arrival n={n} M={M} K={K} N={N} "
                    f"{dn}: at most {ratio:.3f} of its atol")
    return max(worst, check_wgmma_main_shapes(kernels),
               check_gemm_rs_main_shapes(kernels))


def band_cos(want, got, kernel):
    """The epsilon band's cosine of `kernel` at want's dtype; raises
    outside it. Returns (cos, ulp): gemm_rs's ulp leg does not hold by
    construction (each rank's partial is rounded to bf16 before the f32
    fold, so one ulp of a partial is many ulps of an output that
    cancels; its mma.sync body shows the same ulp), so it is reported,
    not held."""
    rep = torch_parity().check_epsilon(want.float().cpu().numpy(),
                                     got.float().cpu().numpy(), kernel,
                                     want.dtype)
    if not rep["cos"] <= rep["band_cos"]:
        raise AssertionError(f"{kernel} outside its band's cosine: {rep}")
    return rep["cos"], rep["ulp"]


# gemm_rs straggler delay a rank (ns) in the card checks
RS_STRAGGLE_NS = 2_000_000


def check_gemm_rs_main_shapes(kernels, calls=50):
    """gemm_rs's wgmma body at the world-4 dist path's Qwen3-8B shapes (O
    K 1024 in rank order, down K 3072 in arrival order, N 4096; m 128, a
    prefill, and 64, a scheduler step), every tile width of its sweep
    forced and each rank in turn delayed RS_STRAGGLE_NS, against
    gemm_rs_plain within gemm_rs_atol and the band's cosine; each launch
    took the wgmma body. Then `calls` back-to-back calls leave every
    counter of its persistent pools at zero and make no pool (a warm
    call launches no memset). Returns the largest share of an atol."""
    import torch

    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    worst, launched = 0.0, 0
    before = dict(grs.launches_by_body)
    for m in (128, 64):
        for k, order in ((1024, "rank"), (3072, "arrival")):
            a = rand((4, 4 * m, k), torch.bfloat16, m + k, 1.0)
            b = rand((4, k, 4096), torch.bfloat16, k + 1, 0.02)
            want = kernels.gemm_rs_plain(a, b, order)
            atol = gemm_rs_atol(a, b, want)
            runs = [(f"bn {bn}", lambda bn=bn: grs._launch(
                a, b, order == "arrival", bn=bn)) for bn in grs._WGMMA_BN]
            runs += [(f"rank {r} delayed", lambda r=r: kernels.gemm_rs(
                a, b, a_order=order, straggler=(r, RS_STRAGGLE_NS)))
                for r in range(4)]
            ulps = []
            for what, fn in runs:
                got = fn()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not bool(torch.isfinite(got).all()) or not err <= atol:
                    raise AssertionError(f"gemm_rs wgmma m {m} K {k} {what}:"
                                         f" err {err}, atol {atol}")
                ulps.append(band_cos(want, got, "gemm_rs")[1])
                worst, launched = max(worst, err / atol), launched + 1
            log(f"  gemm_rs wgmma body n=4 m={m} K={k} N=4096 {order}: "
                f"every tile width forced, each rank delayed "
                f"{RS_STRAGGLE_NS} ns: within the atol and the band's "
                f"cosine (ulp {min(ulps)}-{max(ulps)}, reported)")
    got = {k: v - before[k] for k, v in grs.launches_by_body.items()}
    assert got == {"mma": 0, "wgmma": launched}, got
    made = grs._POOLS.made
    for _ in range(calls):
        out = kernels.gemm_rs(a, b, a_order=order)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.gemm_rs(a, b, a_order=order))
    nonzero = sum(int(f.count_nonzero()) for _, f in
                  grs._POOLS.entries.values())
    assert nonzero == 0 and grs._POOLS.made == made, (nonzero, made)
    log(f"  gemm_rs {calls} back-to-back calls: every counter of "
        f"{len(grs._POOLS.entries)} persistent pools at zero, no pool "
        "made by a warm call")
    return worst


def check_wgmma_main_shapes(kernels):
    """ag_gemm's wgmma body at the world-4 dist path's Qwen3-8B shapes
    (QKV N 1536 in rank order, gate|up 2 x 3072 silu_pair in arrival
    order; m 128, a prefill, and 64, a scheduler step), bf16 and f32 out,
    every tile width of its sweep forced, against ag_gemm_plain within
    ag_gemm_atol and the bf16 band; each launch took the wgmma body.
    Returns the largest share of an atol."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    worst = 0.0
    before = dict(agm.launches_by_body)
    calls = 0
    for m in (128, 64):
        a = rand((4, m, 4096), torch.bfloat16, m, 1.0)
        for nn, pair in ((1536, False), (3072, True)):
            ws = tuple(rand((4, 4096, nn), torch.bfloat16, m + nn + h, 0.02)
                       for h in range(1 + pair))
            kw = (dict(epilogue="silu_pair", c_order="arrival") if pair
                  else dict(c_order="rank"))
            b = ws if pair else ws[0]
            for out in (torch.bfloat16, torch.float32):
                _, r = check_ag_gemm_call(kernels, a, b, out_dtype=out, **kw)
                worst, calls = max(worst, r), calls + 1
            want = kernels.ag_gemm_plain(a, b, **kw)
            for bn in agm._WGMMA_BN_PAIR if pair else agm._WGMMA_BN:
                got = agm._launch(a, ws, pair, False, bn=bn)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                atol = ag_gemm_atol(a, b, want)
                if not err <= atol:
                    raise AssertionError(f"ag_gemm wgmma bn {bn} m {m} N "
                                         f"{nn}: err {err}, atol {atol}")
                band(want, got, "ag_gemm")
                worst, calls = max(worst, err / atol), calls + 1
            log(f"  ag_gemm wgmma body n=4 m={m} K=4096 N={nn} "
                f"{'silu_pair arrival' if pair else 'rank'}: bf16 and f32 "
                f"out, every tile width forced, within the atol and band")
    got = {k: v - before[k] for k, v in agm.launches_by_body.items()}
    assert got == {"mma": 0, "wgmma": calls, "grouped": 0}, got
    return worst


# (rows, width) a chunk of the ring RS card checks: a 3-element chunk, a
# ragged one of several tiles, the Qwen3-30B-A3B path's scheduler step
# and prefill chunks, one decode row
RING_RS_CHUNKS = ((1, 3), (40, 1000), (64, 2048), (128, 2048), (1, 2048))


def check_ring_rs(kernels):
    """The ring ReduceScatter against its plain version on the card:
    bitwise, at n = 1 (force_kernel: no ring step), 2 and 4, in f32, bf16
    and bf16 with f32 accumulation; a 3-element chunk (the element-wise
    path), a ragged one of several tiles, the Qwen3-30B-A3B main-path
    chunks (64 and 128 rows of 2048) and a decode step's one row. Then at
    n = 2 and 4 (bf16): every tile the plan may take, forced; each rank
    in turn delayed 5 ms (the native launcher's _straggler, the wire
    ring's straggler); 50 calls on one stream alternating two shapes and
    the native ring with the fp8 wire ring, each bitwise, after which the
    persistent flag pools read all zeros and no call past the first of
    each configuration made a pool."""
    import torch

    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{label}: not bitwise (max abs err {err})")

    for n in (1, 2, 4):
        for dtype, acc in ((torch.float32, None), (torch.bfloat16, None),
                           (torch.bfloat16, torch.float32)):
            for m, w in RING_RS_CHUNKS:
                x = rand((n, n * m, w), dtype, n + m + w, 1.0)
                same(f"ring_reduce_scatter n={n} m={m} W={w} {dtype} "
                     f"accum {acc}",
                     kernels.ring_reduce_scatter(x, accum_dtype=acc,
                                                 force_kernel=n == 1),
                     kernels.ring_reduce_scatter_plain(x, acc))
            log(f"  ring_reduce_scatter n={n} {str(dtype)[6:]} accum "
                f"{str(acc)[6:] if acc else 'input dtype'}: m x W in "
                f"{RING_RS_CHUNKS}: bitwise")
    for n in (2, 4):
        x = rand((n, n * 64, 2048), torch.bfloat16, 90 + n)
        want = kernels.ring_reduce_scatter_plain(x)
        want_wire = kernels.ring_reduce_scatter_wire_plain(x, "int8")
        for tile in rs._TILES:
            same(f"ring_reduce_scatter n={n} tile {tile}",
                 rs._launch(x, x.dtype, tile=tile), want)
        for rank in range(n):
            same(f"ring_reduce_scatter n={n} rank {rank} delayed",
                 rs._launch(x, x.dtype, _straggler=(rank, 5_000_000)), want)
            same(f"ring_rs_wire n={n} rank {rank} delayed",
                 kernels.ring_reduce_scatter_wire(
                     x, "int8", straggler=(rank, 5_000_000)), want_wire)
        xs = [x, rand((n, n * 37, 4096), torch.bfloat16, 95 + n)]
        wants = [(kernels.ring_reduce_scatter_plain(y),
                  kernels.ring_reduce_scatter_wire_plain(y, "fp8"))
                 for y in xs]
        for i in range(50):
            y, (native, wired) = xs[i % 2], wants[i % 2]
            if i // 2 % 2:
                got, want = kernels.ring_reduce_scatter_wire(y, "fp8"), wired
            else:
                got, want = kernels.ring_reduce_scatter(y), native
            same(f"back-to-back call {i} n={n}", got, want)
            if i == 3:
                made = rs._POOLS.made
        assert rs._POOLS.made == made, "a warm call made a pool"
        assert all(not bool(f.any()) for _, f in rs._POOLS.entries.values()), \
            "a ring left a flag set"
        log(f"  ring RS n={n}: tiles {rs._TILES} forced, each rank delayed "
            f"(native and int8 wire), 50 calls back to back (native and fp8 "
            f"wire, two shapes): bitwise; pools at zero, none made warm")


def check_grouped_ag_gemm(kernels):
    """The grouped ag_gemm (bf16, silu_pair; w_gate / w_up views of one
    [gate | up] stack, rows 2N apart) against its plain version at n = 2
    and 4, cap 16, 48, 64 and 256 rows an expert block, both C orders,
    within ag_gemm_atol and the bf16 band: every row live (no counts),
    and with counts of live rows a (rank, expert) block drawn from [0,
    cap], 0 and cap included, the rows past them non-zero in A (so the
    kernel is seen to leave them out) and their C rows exactly zero.
    Every call with counts took the expert-major grouped kernel and made
    no host sync, every call without took the mma.sync body (the rule of
    allgather_gemm._body_for). Returns the largest share of an atol."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    worst, calls = 0.0, [0, 0]  # with counts, every row live
    before = dict(agm.launches_by_body)
    e, k, i_loc = 8, 512, 192
    for n in (2, 4):
        for cap in (16, 48, 64, 256):
            a = rand((n, e * cap, k), torch.bfloat16, n + cap, 1.0)
            gu = rand((n, e, k, 2 * i_loc), torch.bfloat16, n + cap + 1, 0.05)
            ws = (gu[..., :i_loc], gu[..., i_loc:])
            g = torch.Generator().manual_seed(n * cap)
            counts = torch.randint(0, cap + 1, (n, e), generator=g).to(
                torch.int32)
            counts[0, 0], counts[-1, -1], counts[0, -1] = 0, cap, cap // 2
            counts = counts.cuda()
            ratio = 0.0
            for order in ("rank", "arrival"):
                for cnt in (None, counts):
                    kw = dict(epilogue="silu_pair", c_order=order,
                              counts=cnt)
                    if cnt is not None:
                        torch.cuda.synchronize()
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        got = kernels.ag_gemm(a, ws, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    want = kernels.ag_gemm_plain(a, ws, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    atol = ag_gemm_atol(a, ws, want)
                    if not bool(torch.isfinite(got).all()) or not err <= atol:
                        raise AssertionError(
                            f"ag_gemm grouped n={n} cap={cap} {order} counts "
                            f"{cnt is not None}: err {err}, atol {atol}")
                    band(want, got, "ag_gemm")
                    if cnt is not None:
                        dead = agm._zero_dead_rows(
                            torch.ones_like(got[..., :1]), cnt,
                            order == "arrival") == 0
                        assert not bool(got[dead.expand_as(got)].any()), \
                            "a row past counts is not zero"
                    ratio = max(ratio, err / atol)
                    calls[cnt is None] += 1
            worst = max(worst, ratio)
            log(f"  ag_gemm grouped n={n} E={e} cap={cap} K={k} I={i_loc} "
                f"bf16 silu_pair, both orders, every row live and counts "
                f"{counts.tolist()[0][:4]}..., rows past them non-zero: at "
                f"most {ratio:.3f} of its atol, in the band, those C rows "
                "zero, no host sync")
    got = {key: v - before[key] for key, v in agm.launches_by_body.items()}
    assert got == {"mma": calls[1], "wgmma": 0, "grouped": calls[0]}, got
    return worst


def grouped_gemm_atol(want) -> float:
    """The bf16 card route rounds every product to bf16 after an f32 sum
    in another order: one bf16 ulp (2^-7 relative) of the largest output,
    plus 1e-5 of it (the f32 kernel, which does not round, is held to the
    same)."""
    top = want.float().abs().max().item()
    return 2.0 ** -7 * top + 1e-5 * max(1.0, top)


def check_grouped_gemm_call(x, w, sizes, out_dtype, label):
    """grouped_gemm's card route (torch._grouped_mm, the rank dim folded
    into the groups; for an f32 out_dtype the grouped_gemm_f32 kernel)
    against its loop over experts, within grouped_gemm_atol; rows past
    each rank's last group exactly zero. sizes (E,) shared or (n, E) a
    rank. Returns the max abs error."""
    import torch

    from triton_dist_tpu_torch.kernels import grouped_gemm as gg

    got = gg.grouped_gemm(x, w, sizes, out_dtype=out_dtype)
    want = gg.grouped_gemm_plain(x, w, sizes, out_dtype=out_dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = grouped_gemm_atol(want)
    used = sizes.to(torch.long).sum(-1, keepdim=True)  # (1,) or (n, 1)
    past = torch.arange(got.shape[-2], device=got.device)[None] >= used
    past = past.expand(got.shape[:-1]) if got.dim() == 3 else past[0]
    tail_zero = not bool(got[past].any())
    if (got.shape != want.shape or got.dtype != want.dtype
            or not bool(torch.isfinite(got).all()) or not err <= atol
            or not tail_zero):
        raise AssertionError(f"grouped_gemm {label}: err {err}, atol {atol}, "
                             f"rows past the last group zero {tail_zero}")
    return err


def check_grouped_gemm():
    """grouped_gemm's card route at the Qwen3-30B-A3B world-4 shapes
    (E 128; gate|up K 2048 N 384, down K 192 N 2048): routed group sizes
    with empty groups, the same with 100 rows past the last group, and a
    skewed routing (three experts, one holding 900 of 1024 rows);
    x shared by the ranks and one per rank; bf16 and f32 out; an
    unstacked weight."""
    import torch

    # why the route's f32 out_dtype is a widened bf16 result: what this
    # torch does with out_dtype=float32, held to no host sync
    x, w = rand((64, 64), torch.bfloat16, 1), rand((2, 64, 64),
                                                   torch.bfloat16, 2)
    offs = torch.tensor([32, 64], dtype=torch.int32).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = torch._grouped_mm(x, w, offs=offs, out_dtype=torch.float32)
        what = f"runs with no host sync, out {y.dtype}"
    except RuntimeError as exc:
        what = f"raises (host syncs refused): {str(exc).splitlines()[0]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"  torch._grouped_mm bf16 with out_dtype=float32: {what}")

    e, t = 128, 1024
    g = torch.Generator().manual_seed(5)

    def routed(rows):  # every odd expert empty
        ids = torch.randint(0, e // 2, (rows,), generator=g) * 2
        return torch.bincount(ids, minlength=e).to(torch.int32).cuda()

    skew = torch.zeros(e, dtype=torch.int32)
    skew[[5, 77, 126]] = torch.tensor([900, 3, 21], dtype=torch.int32)
    cases = (("routed", routed(t)), ("100 trailing rows", routed(t - 100)),
             ("skewed, 125 empty experts, 100 trailing rows", skew.cuda()))
    for k, nn in ((2048, 384), (192, 2048)):
        w = rand((4, e, k, nn), torch.bfloat16, k + nn, 0.05)
        for kind, x in (("shared x", rand((t, k), torch.bfloat16, k)),
                        ("x a rank", rand((4, t, k), torch.bfloat16, k + 1))):
            for name, gs in cases:
                err = max(check_grouped_gemm_call(
                    x, w, gs, od, f"{kind} {name} K={k} N={nn} {od}")
                    for od in (torch.bfloat16, torch.float32))
                log(f"  grouped_gemm n=4 E={e} T={t} K={k} N={nn} {kind}, "
                    f"{name}, {int((gs == 0).sum())} empty groups, bf16 "
                    f"and f32 out: max_abs_err={err:.3e}")
        x1 = rand((t, k), torch.bfloat16, k + 2)
        check_grouped_gemm_call(x1, w[0], cases[1][1], torch.float32,
                                f"unstacked K={k} N={nn}")
        # sizes a rank (EP: every rank receives other tokens), the last
        # rank's rows ending 100 early
        gs = torch.stack([routed(t), routed(t), routed(t), routed(t - 100)])
        xr = rand((4, t, k), torch.bfloat16, k + 3)
        err = max(check_grouped_gemm_call(
            xr, w, gs, od, f"sizes a rank K={k} N={nn} {od}")
            for od in (torch.bfloat16, torch.float32))
        log(f"  grouped_gemm n=4 E={e} T={t} K={k} N={nn}, (n, E) sizes a "
            f"rank, bf16 and f32 out: max_abs_err={err:.3e}")
    log("  grouped_gemm unstacked (T, K) x (E, K, N), 100 trailing rows: "
        "within its atol")


# -- the main path --------------------------------------------------------


def main_path_kernels():
    """kernel name -> (module, attribute) through which the main path
    calls it (attention.py and gemm_allreduce.py call the kernels
    through their modules, so a wrapper installed here sees every
    call)."""
    from triton_dist_tpu_torch.kernels import (
        allgather,
        allgather_gemm,
        allreduce,
        flash_prefill,
        gemm_reduce_scatter,
        reduce_scatter,
    )

    return {"flash_prefill_local": (flash_prefill, "flash_prefill_local"),
            "one_shot_all_reduce": (allreduce, "one_shot_all_reduce"),
            "ring_all_gather": (allgather, "ring_all_gather"),
            "gemm_rs": (gemm_reduce_scatter, "gemm_rs"),
            "ag_gemm": (allgather_gemm, "ag_gemm"),
            "ring_reduce_scatter": (reduce_scatter, "ring_reduce_scatter")}


SP_KERNELS = ("sp_flash_prefill", "flash_decode_partial", "ll_all_gather")
# the hand kernel for code the JAX package leaves to XLA: the TP-MoE down
# product (its `lax.ragged_dot`), on the MoE model's path
MOE_KERNELS = ("grouped_gemm_f32",)


def kernel_names():
    """Every counted kernel: the ones the main path calls through a module
    attribute, the megakernel (MegaQwen3 calls it through its queue), the
    SP path's three (the sixth path calls them through its layer), the
    EP path's two (the seventh, through kernels/ep_a2a.py), the PP
    transport's two (4p), the full-mesh AllGather (4c) and the quantized
    wire's three (4w), the MoE model's grouped f32 down product, and the
    serve step's sampler with the resident loop's two ring kernels
    (phase 4r)."""
    return [*main_path_kernels(), "mega", *SP_KERNELS, *EP_KERNELS,
            *PP_KERNELS, *COLL_KERNELS, *WIRE_KERNELS, *MOE_KERNELS,
            *RESIDENT_KERNELS]


def plain_versions():
    from triton_dist_tpu_torch import kernels

    def ag_gemm_plain(a, b, force_kernel=False, **kw):
        return kernels.ag_gemm_plain(a, b, **kw)

    return {"flash_prefill_local": kernels.flash_prefill_plain,
            "one_shot_all_reduce": kernels.one_shot_all_reduce_plain,
            "ring_all_gather": kernels.ring_all_gather_plain,
            "gemm_rs": kernels.gemm_rs_plain,
            "ag_gemm": ag_gemm_plain,
            "ring_reduce_scatter": kernels.ring_reduce_scatter_plain}


class Swapped:
    """Within the block, the main path calls fns[name] in place of the
    kernel `name`; restored on exit."""

    def __init__(self, fns):
        self.fns = fns
        self.saved = {}

    def __enter__(self):
        for name, fn in self.fns.items():
            mod, attr = main_path_kernels()[name]
            self.saved[name] = getattr(mod, attr)
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            mod, attr = main_path_kernels()[name]
            setattr(mod, attr, fn)


def _copy_fp(q, k, v, q_positions=None, q_offset=0, kv_len=None,
             causal=True, scale=None):
    import torch

    b, s = q.shape[:2]
    if q_positions is None:
        q_positions = (torch.arange(s, device=q.device)[None]
                       + q_offset).expand(b, s)
    if kv_len is None:
        kv_len = torch.full((b,), k.shape[1], device=q.device)
    return dict(q=q.clone(), k=k.clone(), v=v.clone(),
                q_positions=q_positions.clone().contiguous(),
                kv_len=kv_len.clone(), causal=causal, scale=scale)


# how a recorder copies a kernel's inputs
COPY = {"flash_prefill_local": _copy_fp,
        "one_shot_all_reduce": lambda x: dict(x=x.clone()),
        "ring_all_gather": lambda x: dict(x=x.clone()),
        # b is a weight (or a pair), never written: kept by reference;
        # the keyword options (a_order, epilogue, c_order) kept with it
        "gemm_rs": lambda a, b, **kw: dict(a=a.clone(), b=b, **kw),
        "ag_gemm": lambda a, b, **kw: dict(a=a.clone(), b=b, **kw),
        "ring_reduce_scatter": lambda x, **kw: dict(x=x.clone(), **kw)}
# a kernel's calls per layer in a forward that reaches it: the dense
# model (flash once; AR, AG and gemm_rs on O and down; ag_gemm on QKV
# and gate|up), the MoE model (the MLP's legs leave for the MoE block's
# ring AG and ring RS) and its fused prefill (ag_gemm on QKV and the
# grouped gate|up)
PER_LAYER = {
    "dense": dict(flash_prefill_local=1, one_shot_all_reduce=2,
                  ring_all_gather=2, gemm_rs=2, ag_gemm=2,
                  ring_reduce_scatter=1),
    "moe": dict(flash_prefill_local=1, one_shot_all_reduce=1,
                ring_all_gather=1, gemm_rs=1, ag_gemm=1,
                ring_reduce_scatter=1),
    "fused": dict(flash_prefill_local=1, one_shot_all_reduce=1,
                  ring_all_gather=1, gemm_rs=1, ag_gemm=2,
                  ring_reduce_scatter=1),
}


class GroupedRecorder:
    """Within the block, every grouped_gemm call of the MoE path (two a
    layer in every `dist`, `ar` and `xla` forward: gate|up and down)
    runs as before; the first call of each (layer, shape, out dtype) at
    the first and the last layer keeps a copy of its inputs (the weight
    by reference). Calls under a capture are left out, as Recorder's."""

    def __init__(self, num_layers):
        from triton_dist_tpu_torch.kernels import grouped_gemm as gg

        self.mod, self.fn = gg, gg.grouped_gemm
        self.layers = num_layers
        self.calls = 0
        self.records = {}

    def __call__(self, x, w, sizes, out_dtype=None):
        from triton_dist_tpu_torch.kernels import _build

        if _build.under_capture():  # records, runs nothing: not counted
            return self.fn(x, w, sizes, out_dtype)
        layer = self.calls % (2 * self.layers) // 2
        key = (layer, tuple(x.shape), out_dtype)
        if layer in (0, self.layers - 1) and key not in self.records:
            self.records[key] = dict(x=x.clone(), w=w, sizes=sizes.clone(),
                                     out_dtype=out_dtype)
        self.calls += 1
        return self.fn(x, w, sizes, out_dtype)

    def __enter__(self):
        self.mod.grouped_gemm = self
        return self

    def __exit__(self, *exc):
        self.mod.grouped_gemm = self.fn


class Recorder:
    """Wraps a kernel's wrapper so that the calls at the first and the
    last layer of each forward that reaches the kernel keep a copy of
    their inputs (PER_LAYER calls a layer, by the model's kind). Calls
    the kernel's wrapper, which counts the launch. A call under a CUDA
    graph's capture (which records the launch and runs nothing) is
    neither counted nor recorded: `forward` numbers the eager forwards
    and the captures' warm-ups."""

    def __init__(self, name, num_layers, kind="dense"):
        mod, attr = main_path_kernels()[name]
        self.fn = getattr(mod, attr)
        self.copy = COPY[name]
        self.per_layer = PER_LAYER[kind][name]
        self.layers = num_layers
        self.calls = 0
        self.grouped = 0  # ag_gemm calls in the grouped (MoE) form
        self.records = []

    def __call__(self, *a, **kw):
        from triton_dist_tpu_torch.kernels import _build

        if _build.under_capture():  # records, runs nothing: not counted
            return self.fn(*a, **kw)
        b = a[1] if len(a) > 1 else kw.get("b")
        if isinstance(b, tuple) and b[0].dim() == 4:
            self.grouped += 1
        every = self.per_layer * self.layers
        layer = self.calls % every // self.per_layer
        if layer in (0, self.layers - 1):
            self.records.append(dict(forward=self.calls // every,
                                     layer=layer, **self.copy(*a, **kw)))
        self.calls += 1
        return self.fn(*a, **kw)


def check_recorded_fp(fp, records):
    """The flash kernel against its plain version on the inputs the main
    path gave it. Returns the max abs error and the scheduler step (a
    record) with the most live work, for timing."""
    import torch

    err_max, ratio_max, busiest = 0.0, 0.0, None
    for rec in records:
        inp = {n: rec[n] for n in ("q", "k", "v", "q_positions", "kv_len",
                                   "causal", "scale")}
        got = fp.flash_prefill_local(**inp)
        want = fp.flash_prefill_plain(**inp)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        atol = bf16_atol(inp)
        if not bool(torch.isfinite(got).all()) or not err <= atol:
            raise AssertionError(f"flash_prefill on the main path's inputs "
                                 f"(forward {rec['forward']}, layer "
                                 f"{rec['layer']}): err {err}, atol {atol}")
        err_max, ratio_max = max(err_max, err), max(ratio_max, err / atol)
        if rec["forward"] > 0 and (busiest is None or fp_work(inp)[0]
                                   > fp_work(busiest[1])[0]):
            busiest = (rec, inp)
    shapes = sorted({(tuple(r["q"].shape), r["k"].shape[1])
                     for r in records})
    log(f"  flash_prefill on {len(records)} recorded main-path calls "
        f"(q shape, T) {shapes}: max_abs_err={err_max:.3e}, at most "
        f"{ratio_max:.3f} of its atol (bf16: {BF16_ATOL:g} x max(1, "
        f"max|v| / 2))")
    return err_max, busiest


def check_recorded_collectives(kernels, records):
    """Each collective kernel against its plain version on the inputs
    the world-4 main path gave it: AR and AG bitwise, gemm_rs within
    gemm_rs_atol. Returns name -> max abs error."""
    import torch

    errs = {}
    for rec in records["one_shot_all_reduce"]:
        check_ar(kernels, rec["x"])
    for rec in records["ring_all_gather"]:
        check_ag(kernels, rec["x"])
    errs["one_shot_all_reduce"] = errs["ring_all_gather"] = 0.0
    err_max, ratio_max = 0.0, 0.0
    for rec in records["gemm_rs"]:
        err, ratio = check_rs(kernels, rec["a"], rec["b"])
        err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
    errs["gemm_rs"] = err_max
    torch.cuda.synchronize()
    for name in ("one_shot_all_reduce", "ring_all_gather", "gemm_rs"):
        shapes = sorted({tuple(v.shape) for r in records[name]
                         for k, v in r.items() if k in ("x", "a", "b")})
        log(f"  {name} on {len(records[name])} recorded main-path calls, "
            f"shapes {shapes}: max_abs_err={errs[name]:.3e}"
            + (f", at most {ratio_max:.3f} of its atol"
               if name == "gemm_rs" else " (bitwise)"))
    return errs


def want_launches(L, world, prefill_mode, sched_mode, dec_steps,
                  sched_steps, moe=False):
    """The launch counts the main path must show: Engine.serve runs one
    multi-token forward (the prefill, M = 512 rows) and dec_steps `ar`
    decode steps (M = 4: local product + one-shot AR); the Scheduler
    sched_steps (slots, chunk) forwards of M = 256 rows. On the card a
    step is a replay of its captured graph, which counts the launches its
    capture recorded, and each capture runs the step once eagerly before
    (its warm-up): so dec_steps is gen - 1 plus the decode captures,
    sched_steps the Scheduler's steps plus its captures. At world > 1 an
    `ar` prefill takes gemm_rs + ring AG on O and down (M > 256), an `ar`
    scheduler step the one-shot AR; a `dist` forward takes ag_gemm on
    QKV and gate|up and gemm_rs on O and down, and no AR or AG. The MoE
    model (world 4, `dist` prefill and scheduler) keeps ag_gemm on QKV
    and gemm_rs on O, and its MoE block takes the ring AG and the ring
    RS once a layer; its `ar` decode the one-shot AR on O only; every
    one of its forwards the grouped f32 down product once a layer. Every
    Scheduler step samples its slots with one sample_slots launch (the
    greedy Engine.serve takes the argmax)."""
    serve = {name: 0 for name in kernel_names()}
    sched = dict(serve, flash_prefill_local=L * sched_steps,
                 sample_slots=sched_steps)
    serve["flash_prefill_local"] = L
    if moe:
        per = dict(ag_gemm=L, gemm_rs=L, ring_all_gather=L,
                   ring_reduce_scatter=L, grouped_gemm_f32=L)
        serve.update(per, one_shot_all_reduce=L * dec_steps,
                     grouped_gemm_f32=L * (1 + dec_steps))
        sched.update({k: v * sched_steps for k, v in per.items()})
        return serve, sched
    if world > 1:
        if prefill_mode == "dist":
            serve.update(ag_gemm=2 * L, gemm_rs=2 * L)
        else:
            serve.update(gemm_rs=2 * L, ring_all_gather=2 * L)
        serve["one_shot_all_reduce"] = 2 * L * dec_steps
        if sched_mode == "dist":
            sched.update(ag_gemm=2 * L * sched_steps,
                         gemm_rs=2 * L * sched_steps)
        else:
            sched.update(one_shot_all_reduce=2 * L * sched_steps)
    return serve, sched


# -- phase 4g: the captured steps against the eager ones --------------------

G_STEPS = 15  # decode steps timed a path (the serve's gen - 1)


def _cache_tensors(c):
    """A cache's tensors: the KVCache dataclass's fields, or a mega
    cache's (a named tuple)."""
    import dataclasses

    if dataclasses.is_dataclass(c):
        return [getattr(c, f.name) for f in dataclasses.fields(c)]
    return list(c)


def _clone_cache(c):
    return type(c)(*(t.clone() for t in _cache_tensors(c)))


# every profiler trace of the run, kept to the end: a finalized trace's
# profiler objects (they sit in reference cycles, so the collector frees
# them at any moment) can leave the trace running then without its
# kernel records (measured on an H100: 3-4 of 120 traces after a forced
# collection, none with the traces kept)
_TRACES: list = []


# whether the last profiler trace of a row lost its records: the next
# row then tries one trace before graph_device_us (the losses come in
# runs of rows)
_LOSING = [False]


def graph_device_us(fn, reps=10):
    """Device µs a call of fn where the profiler keeps losing its kernel
    records (on an H100 in PR 22's chip calls, the parent commit's run
    too, traces of the Qwen3-30B-A3B phases came back without any kernel
    record, five in a row, for most rows): `reps` calls of fn captured as
    one CUDA graph, one replay timed by CUDA events (no host time between
    the launches, so the time is the device's, gaps between kernels
    included). None, logged, if fn cannot be captured."""
    import torch

    from triton_dist_tpu_torch.runtime.graphs import StepGraph

    _LOSING[0] = True
    try:
        g = StepGraph(lambda commit: [fn() for _ in range(reps)], "cuda")
    except RuntimeError as e:
        log(f"  graph_device_us: the calls cannot be captured ({e})")
        return None
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    us = a.elapsed_time(b) * 1e3 / reps
    del g  # its pool holds every call's outputs
    torch.cuda.empty_cache()
    log(f"  graph_device_us: {us:.1f} us a call (CUDA events over a graph of "
        f"{reps} calls, the profiler's records lost)")
    return us


def kernels_a_call(fn) -> int:
    """Device kernels (and memsets / copies) one call of fn runs, from a
    torch.profiler trace of one call (after one untraced call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _TRACES.append(prof)
    return sum(e.count for e in prof.key_averages()
               if float(getattr(e, "self_device_time_total", getattr(
                   e, "self_cuda_time_total", 0.0))) > 0)


def trace_a_call(fn) -> dict:
    """One call of fn traced (after one untraced call): its device
    kernels (memsets and copies too), and its zero fills' count and
    device µs (cudaMemset and torch's fill kernel: a fresh zeroed flag
    pool, or a zeroed buffer of the step, costs one a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _TRACES.append(prof)
    kernels, memsets, memset_us = 0, 0, 0.0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us <= 0:
            continue
        kernels += e.count
        if "memset" in e.key.lower() or "FillFunctor" in e.key:
            memsets += e.count
            memset_us += us
    return dict(device_kernels=kernels, memsets=memsets, memset_us=memset_us)


def graph_row(g) -> dict:
    """What a captured step costs to hold: capture s, the graph's private
    pool bytes, the hand kernels' launches a replay."""
    return dict(capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                kernel_launches_a_replay=dict(g.launches))


def check_graph_decode(eng, prompts, label, steps=G_STEPS):
    """The Engine's captured decode step against its eager step from one
    prefill state: decode_step's logits, then `steps` greedy tokens of
    generate, then 4 sampled ones (the JAX chain from PRNGKey(3)), and
    the cache (rows and length)
    bitwise; ms/token eager and replayed (host clock, the replay after
    its capture), device kernels a step each way, capture s, pool bytes,
    peak GB. Then two Engine.serve calls of steps + 1 tokens, each on a
    fresh prefill cache: their wall s, and no capture in either (the
    graphs are kept by shape)."""
    import torch

    from triton_dist_tpu_torch.kernels.sample import seed_key

    torch.cuda.reset_peak_memory_stats()
    logits, c0 = eng.prefill(prompts)
    tok = logits.argmax(-1)
    caches = {}
    out = {}
    for graphed in (False, True):
        eng.cuda_graph = graphed
        c = _clone_cache(c0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, c = eng.decode_step(tok, c)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, c = eng.generate(first.argmax(-1), c, steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        sampled, c = eng.generate(ids[:, -1], c, 4, temperature=0.8,
                                  key=seed_key(3))
        torch.cuda.synchronize()
        caches[graphed] = c
        out[graphed] = (first, ids, sampled, ms, first_s)
    eng.cuda_graph = True
    (fe, ie, se, eager_ms, _), (fg, ig, sg, replay_ms, first_s) = (
        out[False], out[True])
    ok = (torch.equal(fe, fg) and torch.equal(ie, ig) and torch.equal(se, sg)
          and all(torch.equal(a, b) for a, b in zip(
              _cache_tensors(caches[False]), _cache_tensors(caches[True]))))
    if not ok:
        raise AssertionError(f"{label}: the replayed decode differs from the "
                             "eager step")
    g = eng._decode_graph(caches[True], tok)  # the greedy one, made above
    c1 = _clone_cache(caches[True])
    eng.cuda_graph = False
    eager_k = kernels_a_call(lambda: eng.decode_step(tok, c1))
    eng.cuda_graph = True
    replay_k = kernels_a_call(lambda: g.replay())
    made, serve_s = eng.decode_graphs.made, []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(prompts, steps + 1)
        torch.cuda.synchronize()
        serve_s.append(time.perf_counter() - t0)
    if eng.decode_graphs.made != made:
        raise AssertionError(f"{label}: Engine.serve on a fresh prefill "
                             "cache captured its step again")
    row = dict(eager_ms=eager_ms, replay_ms=replay_ms,
               first_call_s=first_s, device_kernels_eager=eager_k,
               device_kernels_replay=replay_k, serve_repeat_s=serve_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               **graph_row(g))
    log(f"  4g {label} decode: eager {eager_ms:.3f} ms/token, replay "
        f"{replay_ms:.3f} ms/token; capture {g.capture_s:.3f} s (first "
        f"call on a fresh cache {first_s:.3f} s), graph pool "
        f"{g.pool_bytes / 1e6:.1f} MB, device kernels a step {eager_k} "
        f"eager / {replay_k} replayed, hand kernels a replay {g.launches}; "
        f"peak {row['peak_gb']:.2f} GB; logits, {steps} greedy and 4 sampled "
        f"tokens and the cache bitwise the eager step's; Engine.serve "
        f"({steps + 1} tokens) twice on fresh prefill caches: "
        f"{serve_s[0]:.3f} s, {serve_s[1]:.3f} s, no capture")
    del c0, caches, c1
    return row


def check_graph_prefill(eng, prompts, label, iters=5):
    """The Engine's captured prefill against its eager prefill of the
    same prompts on fresh caches: logits and the cache (k, v, the new
    length) bitwise; ms a call each way (CUDA events, a fresh cache
    each call, `iters` calls after a warm-up), capture s (taken here
    if the path has not captured this shape yet), the graph's pool
    bytes, device kernels and zero fills of a replay (a fresh zeroed
    flag pool is one), peak GB; every fresh cache after the first
    replays the same graph. The MoE model's replay is not traced: after
    traces of its 6-16 thousand kernels a call, the profiler lost every
    kernel record of the traces after them (my chip call 4, PR 22)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    res, ms = {}, {}
    for graphed in (False, True):
        eng.cuda_graph = graphed
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        res[graphed] = (logits, _clone_cache(cache))
        del cache
        made = eng.prefill_graphs.made
        ms[graphed] = time_ms(lambda: eng.prefill(prompts), iters=iters,
                              warmup=1)
        if eng.prefill_graphs.made != made:
            raise AssertionError(f"{label}: a fresh cache of a known shape "
                                 "captured the prefill again")
    (le, ce), (lg, cg) = res[False], res[True]
    if not (torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(
            _cache_tensors(ce), _cache_tensors(cg)))):
        raise AssertionError(f"{label}: the replayed prefill differs from "
                             "the eager one")
    del res, le, ce, lg, cg
    g = next(reversed(eng.prefill_graphs.graphs.values()))  # this shape
    traced = {} if eng.cfg.is_moe else trace_a_call(
        lambda: eng.prefill(prompts))
    row = dict(eager_ms=ms[False], replay_ms=ms[True],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               **{f"{k}_replay": v for k, v in traced.items()},
               **graph_row(g))
    what = ("not traced" if not traced else
            f"device kernels a replay {traced['device_kernels']} "
            f"({traced['memsets']} zero fills, {traced['memset_us']:.1f} "
            "us)")
    log(f"  4g {label} prefill {tuple(prompts.shape)} "
        f"({eng.prefill_mode}): logits and cache bitwise the eager "
        f"prefill's; eager {ms[False]:.3f} ms, replayed {ms[True]:.3f} ms "
        f"a call (CUDA events, fresh caches, no capture); capture "
        f"{g.capture_s:.3f} s, graph pool {g.pool_bytes / 1e6:.1f} MB, "
        f"{what}, hand kernels a replay {g.launches}; peak "
        f"{row['peak_gb']:.2f} GB")
    return row


def check_graph_serve(eng, prompts, gen, label):
    """The Engine's captured serve step against its eager step: one step
    from the same pool state (its last logits, tokens and the pools past
    the null page bitwise), then a Scheduler each way on the same
    requests (greedy and sampled; every request's tokens bitwise), the
    replaying one on a fresh pool with no capture (the graph is kept by
    geometry); tokens/s each way, capture s, pool bytes, device kernels
    a step."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.serve import Scheduler, sampling_key
    from triton_dist_tpu_torch.serve.kv_pool import KVPool

    torch.cuda.reset_peak_memory_stats()
    cfg = eng.cfg
    pool = KVPool(eng, slots=4, page=64)
    rng = np.random.default_rng(4)
    dev = eng.device
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                             device=dev)
    table = torch.arange(1, 1 + 4 * pool.max_pages, device=dev).reshape(4, -1)
    lengths = torch.tensor([0, 64, 0, 200], device=dev)
    n_valid = torch.tensor([64, 30, 64, 1], device=dev)
    temps = np.array([0.0, 0.7, 0.0, 0.0], np.float32)
    keys = np.stack([sampling_key(i, 0) for i in range(4)])
    res = {}
    for graphed in (False, True):
        eng.cuda_graph = graphed
        fn = eng.make_serve_step(4, 64, 64, pool.max_pages)
        pk, pv = pool.k.clone(), pool.v.clone()
        tok, last = fn(tokens, pk, pv, table, lengths, n_valid, temps, keys)
        res[graphed] = (tok, last.clone(), pk, pv, fn)
    eng.cuda_graph = True
    # the pools past the null page 0 (the padding columns' sink, whose
    # duplicate writes land in no fixed order)
    if not (all(torch.equal(a, b) for a, b in zip(res[False][:2],
                                                   res[True][:2]))
            and all(torch.equal(a[:, :, 1:], b[:, :, 1:])
                    for a, b in zip(res[False][2:4], res[True][2:4]))):
        raise AssertionError(f"{label}: the replayed serve step differs "
                             "from the eager step")
    g = next(reversed(eng.serve_graphs.graphs.values()))  # just captured
    args = (tokens, res[True][2], res[True][3], table, lengths, n_valid,
            temps, keys)
    eager_k = kernels_a_call(lambda: res[False][4](*args))
    replay_k = kernels_a_call(lambda: g.replay())
    del res, pool
    runs = {}
    for graphed in (False, True):
        eng.cuda_graph = graphed
        made = eng.serve_graphs.made
        sch = Scheduler(eng, slots=4, chunk=64, page=64)
        reqs = [sch.submit(p, gen, temperature=0.7 if i % 3 == 2 else 0.0,
                           seed=i) for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sch.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if eng.serve_graphs.made != made:
            raise AssertionError(f"{label}: a Scheduler's fresh pool "
                                 "captured the serve step again")
        n_out = sum(len(r.out_tokens) for r in reqs)
        runs[graphed] = ([r.out_tokens for r in reqs], wall,
                         n_out / wall, sch.worker.n_steps)
        del sch
    eng.cuda_graph = True
    if runs[False][0] != runs[True][0]:
        raise AssertionError(f"{label}: the replayed Scheduler's tokens "
                             "differ from the eager one's")
    row = dict(eager_tokens_per_s=runs[False][2],
               replay_tokens_per_s=runs[True][2],
               eager_wall_s=runs[False][1], replay_wall_s=runs[True][1],
               steps=runs[True][3], device_kernels_eager=eager_k,
               device_kernels_replay=replay_k,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               **graph_row(g))
    log(f"  4g {label} serve step ({eng.decode_mode}): one step's last "
        f"logits, tokens and pools bitwise the eager step's; Scheduler "
        f"(6 requests, 2 sampled, {row['steps']} steps) tokens bitwise: "
        f"eager {runs[False][2]:.2f} tokens/s ({runs[False][1]:.3f} s), "
        f"replayed {runs[True][2]:.2f} tokens/s ({runs[True][1]:.3f} s, "
        f"a fresh pool, no capture); graph pool "
        f"{g.pool_bytes / 1e6:.1f} MB, device kernels a step {eager_k} "
        f"eager / {replay_k} replayed, hand kernels a replay {g.launches}; "
        f"peak {row['peak_gb']:.2f} GB")
    return row


def run_model(kernels, cfg, params, world: int, prefill_mode="ar",
              sched_mode="ar", device="cuda"):
    """The main path at `world`: Engine.serve of 4 x 128 prompts (a
    `prefill_mode` prefill, `ar` decode steps) and a Scheduler with 6
    requests whose steps run `sched_mode`, over `params`, every kernel's
    launches read around each, the kernels' inputs recorded (the decode
    and serve steps replay their captured graphs, as on every card run);
    for an MoE config also a `fused` prefill of 4 x FUSED_LEN; then the
    timed prefill, phase 4g (each captured step against the eager step:
    the `ar` decode, the `sched_mode` decode where it differs, the
    serve step), and the kernel path's logits against the plain
    versions' (and, for a sequence-sharded prefill, against the `xla`
    prefill's). Returns (launches of the whole path, records, model
    numbers)."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import flash_prefill as fp
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.models import Engine
    from triton_dist_tpu_torch.serve import Scheduler

    L = cfg.num_layers
    moe = cfg.is_moe
    eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                 world=world, prefill_mode=prefill_mode, decode_mode="ar")
    sched_eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                       world=world, prefill_mode=prefill_mode,
                       decode_mode=sched_mode)
    n_params = sum(p.numel() for p in eng.params.tensors())
    log(f"  model: {L} layers, hidden {cfg.hidden_size}, world {world}, "
        f"{n_params / 1e9:.3f} B params bf16; Engine.serve prefill "
        f"{prefill_mode}, decode ar; Scheduler steps {sched_mode}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    sched_prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                     for n in (100, 300, 180, 250, 120, 211)]
    gen = 16

    # (a) Engine.serve, (b) Scheduler: counts zeroed just before, read
    # just after; the serve-step wrapper below only reads the logits, and
    # the recorders keep the kernels' inputs at the first and last layer
    finite = []

    def watch(fn):
        def step(*a):
            tok, last = fn(*a)
            finite.append(bool(torch.isfinite(last).all()))
            return tok, last
        return step

    kind = "moe" if moe else "dense"
    wrappers = {name: Recorder(name, L, kind) for name in main_path_kernels()}
    grouped = GroupedRecorder(L)
    by_body = {"ag_gemm": agm, "gemm_rs": grs, "flash_prefill_local": fp}
    bodies0 = {k: dict(mod.launches_by_body) for k, mod in by_body.items()}
    with Swapped(wrappers), grouped:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(prompts, gen)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_n = kernels.launches()
        sch = Scheduler(sched_eng, slots=4, chunk=64, page=64)
        sch.worker._fn = watch(sch.worker._fn)
        reqs = [sch.submit(p, gen) for p in sched_prompts]
        t0 = time.perf_counter()
        sch.run()
        torch.cuda.synchronize()
        sched_s = time.perf_counter() - t0
        main_n = kernels.launches()
    bodies = {name: {k: v - bodies0[name][k]
                     for k, v in mod.launches_by_body.items()}
              for name, mod in by_body.items()}
    steps = sch.worker.n_steps
    records = {name: w.records for name, w in wrappers.items()}
    if moe:
        records["grouped_gemm"] = list(grouped.records.values())
    del grouped

    assert out.shape == (4, gen)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    assert all(len(r.out_tokens) == gen and r.finish_reason == "length"
               for r in reqs), "a scheduler request was not answered"
    assert all(finite), "non-finite serve-step logits"
    sched_n = {k: main_n[k] - serve_n[k] for k in main_n}
    # one capture each: the serve's prefill (its first call, run eagerly,
    # is the capture's warm-up) and decode step, the Scheduler's step
    assert (eng.prefill_graphs.made, eng.decode_graphs.made,
            sched_eng.serve_graphs.made) == (1, 1, 1)
    want_serve, want_sched = want_launches(
        L, world, prefill_mode, sched_mode, gen - 1 + eng.decode_graphs.made,
        steps + sched_eng.serve_graphs.made, moe)
    assert serve_n == want_serve, (serve_n, want_serve)
    assert sched_n == want_sched, (sched_n, want_sched)
    # every dense ag_gemm and every gemm_rs of a dist forward (gemm_rs of
    # an ar prefill too) has m = 128 (the prefill) or 64 (a scheduler
    # step) rows a rank, and every flash call is bf16 with D = 128 and
    # G = 4: all of them took the wgmma body or fold
    for name, got in bodies.items():
        assert got == {**dict.fromkeys(got, 0), "wgmma": main_n[name]}, (
            name, got)
        log(f"  {name} launches by body (Engine.serve and Scheduler): "
            f"{got}")
    model = {"ag_gemm_by_body": bodies["ag_gemm"],
             "gemm_rs_by_body": bodies["gemm_rs"],
             "flash_prefill_by_body": bodies["flash_prefill_local"]}

    # the kernel path's logits against the plain versions', swapped in
    # only for these comparisons; the bound is calibrated in the same run
    # by the drift that a one-ulp bf16 perturbation of every attention
    # output (the size of the kernels' own error) causes through the
    # layers of this random-weight model. The kernels' own evidence is
    # the check on their recorded inputs; this bound only shows nothing
    # else on the path (layout, cache, routing, packing, rank order)
    # differs. Random weights leave the top logits near-tied, so argmax
    # agreement is printed, not held.
    plain = plain_versions()

    def perturbed(seed):
        noise = torch.Generator(device=device).manual_seed(seed)

        def perturbed_plain(*a, **kw):
            out = fp.flash_prefill_plain(*a, **kw)
            sign = torch.randint(0, 2, out.shape, generator=noise,
                                 device=out.device) * 2 - 1
            return (out.float() * (1 + sign * 2.0 ** -8)).to(out.dtype)

        return {**plain, "flash_prefill_local": perturbed_plain}

    def against_plain(logits, run, seed, engine):
        """(relative L2 of logits and of the one-ulp perturbed plain run
        against the plain run, argmax agreement of each, plain logits).
        The plain runs are eager: a replay would run the kernels its
        graph captured."""
        engine.cuda_graph = False
        with Swapped(plain):
            base, _ = run()
        with Swapped(perturbed(seed)):
            floor, _ = run()
        engine.cuda_graph = True
        torch.cuda.synchronize()

        def rel(a):
            return ((a - base).norm() / base.norm()).item()

        def agree(a):
            return (a.argmax(-1) == base.argmax(-1)).float().mean().item()

        return (rel(logits), rel(floor), agree(logits), agree(floor), base)

    if moe:  # the fused prefill: its launches counted from 0 too
        fused = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                       world=world, prefill_mode="fused")
        fused_prompts = rng.integers(0, cfg.vocab_size, (4, FUSED_LEN))
        fwrap = {name: Recorder(name, L, "fused")
                 for name in main_path_kernels()}
        fused0 = dict(agm.launches_by_body)
        with Swapped(fwrap):
            kernels.reset_launches()
            torch.cuda.synchronize()
            fused_logits, _ = fused.prefill(fused_prompts)
            torch.cuda.synchronize()
            fused_n = kernels.launches()
        fused_bodies = {k: v - fused0[k]
                        for k, v in agm.launches_by_body.items()}
        want_fused = {name: 0 for name in kernel_names()}
        want_fused.update(flash_prefill_local=L, ag_gemm=2 * L, gemm_rs=L,
                          ring_reduce_scatter=L)
        assert fused_n == want_fused, (fused_n, want_fused)
        assert fused.prefill_graphs.made == 1  # its first call, captured
        assert fwrap["ag_gemm"].grouped == L, fwrap["ag_gemm"].grouped
        # QKV (m 32 a rank) on the mma.sync body, every grouped gate|up
        # on the expert-major grouped kernel
        assert fused_bodies == {"mma": L, "wgmma": 0, "grouped": L}, \
            fused_bodies
        model["fused_ag_gemm_by_body"] = fused_bodies
        assert bool(torch.isfinite(fused_logits).all()), "fused logits"
        assert fused_logits.shape == (4, cfg.vocab_size)
        for name, w in fwrap.items():
            wrappers[name].records.extend(w.records)
        main_n = {k: main_n[k] + fused_n[k] for k in main_n}
        model["grouped_launches"] = fwrap["ag_gemm"].grouped
        log(f"  fused prefill 4x{FUSED_LEN}: launches {fused_n}, grouped "
            f"ag_gemm {fwrap['ag_gemm'].grouped}, ag_gemm launches by body "
            f"{fused_bodies}")
        model["fused_prefill_graph"] = check_graph_prefill(
            fused, fused_prompts, f"Qwen3-30B-A3B world {world} fused",
            iters=3)
        model["fused_prefill_ms"] = model["fused_prefill_graph"]["replay_ms"]
        # the fused graph's pool (its capacity-padded transients) goes
        # before the plain runs, which need the room for their own
        fused.prefill_graphs.graphs.clear()
        torch.cuda.empty_cache()
        f_rel, f_floor, f_agree, f_agree_floor, _ = against_plain(
            fused_logits, lambda: fused.prefill(fused_prompts), seed=2,
            engine=fused)
        model.update(fused_logits_rel_l2=f_rel,
                     fused_logits_rel_l2_ulp=f_floor,
                     fused_argmax_agree=f_agree,
                     fused_argmax_agree_ulp=f_agree_floor)
        log(f"  fused prefill 4x{FUSED_LEN} logits kernels vs plain "
            f"versions: relative L2 {f_rel:.4e} (one-ulp perturbed plain: "
            f"{f_floor:.4e}); argmax agree {f_agree:.2f} (one-ulp "
            f"perturbed plain: {f_agree_floor:.2f})")
        if not f_rel <= 2 * f_floor:
            raise AssertionError("fused prefill logits drift more than twice "
                                 "the one-ulp perturbation's")
        dist_logits, _ = eng.prefill(fused_prompts)
        torch.cuda.synchronize()
        model["fused_rel_l2_dist"] = ((fused_logits - dist_logits).norm()
                                      / dist_logits.norm()).item()
        model["fused_argmax_agree_dist"] = (
            fused_logits.argmax(-1) == dist_logits.argmax(-1)).float().mean(
            ).item()
        log(f"  fused prefill 4x{FUSED_LEN}: {model['fused_prefill_ms']:.3f} "
            f"ms; logits against the dist prefill of the same prompts: "
            f"relative L2 {model['fused_rel_l2_dist']:.4e}, argmax agree "
            f"{model['fused_argmax_agree_dist']:.2f}")
        del fused, fused_logits, dist_logits
    m = sch.metrics()
    log(f"  Engine.serve 4x128 +{gen}: {serve_s:.3f} s, tokens "
        f"{out[0, :8].tolist()}...")
    log(f"  Scheduler slots=4 chunk=64 page=64, 6 requests: {steps} steps, "
        f"{sched_s:.3f} s, {m['tokens_per_s']:.2f} tok/s, ttft p50 "
        f"{m['ttft_p50_us'] / 1e3:.1f} ms, evicted {m['evicted']}")
    log(f"  launches: Engine.serve {serve_n}, Scheduler {sched_n}")

    # timed prefill, outside the counted window; then phase 4g: each step
    # replayed against the eager step, and its ms/token both ways
    def prefill():
        return eng.prefill(prompts)

    pre_ms = time_ms(prefill, iters=5, warmup=1)
    logits, cache = prefill()
    torch.cuda.synchronize()
    peak_main = torch.cuda.max_memory_allocated() / 1e9
    path = f"{'Qwen3-30B-A3B' if moe else 'Qwen3-8B'} world {world}"
    graphs = {f"prefill {prefill_mode}": check_graph_prefill(
        eng, prompts, path)}
    graphs["decode ar"] = check_graph_decode(eng, prompts, f"{path} ar")
    if sched_mode != "ar":
        graphs[f"decode {sched_mode}"] = check_graph_decode(
            sched_eng, prompts, f"{path} {sched_mode}")
    graphs[f"serve step {sched_mode}"] = check_graph_serve(
        sched_eng, sched_prompts, gen, path)
    decode_ms = graphs["decode ar"]["replay_ms"]
    model["graphs"] = graphs
    peak_gb = max(peak_main, *(g["peak_gb"] for g in graphs.values()))
    log(f"  prefill 4x128: {pre_ms:.3f} ms replayed ("
        f"{graphs[f'prefill {prefill_mode}']['eager_ms']:.3f} eager); "
        f"decode: {decode_ms:.3f} "
        f"ms/token replayed ({graphs['decode ar']['eager_ms']:.3f} eager; "
        f"batch 4, host clock); peak memory {peak_gb:.2f} GB")

    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    k_rel, k_floor, k_agree, k_agree_floor, plain_logits = against_plain(
        logits, prefill, seed=1, engine=eng)
    diff = (logits - plain_logits).abs().max().item()
    top2 = plain_logits.float().topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    log(f"  prefill logits kernels vs plain versions: relative L2 "
        f"{k_rel:.4e} (one-ulp perturbed plain: {k_floor:.4e}), max abs "
        f"diff {diff:.4e} of max |logit| "
        f"{plain_logits.abs().max().item():.4e}; argmax agree "
        f"{k_agree:.2f} (one-ulp perturbed plain: {k_agree_floor:.2f}); "
        f"plain top-1 minus top-2 logit per prompt "
        f"{[round(x, 4) for x in gap]}")
    model.update(model=("qwen3-30b-a3b" if moe else "qwen3-8b"),
                 world=world, prefill_mode=prefill_mode,
                 sched_mode=sched_mode, prefill_ms=pre_ms,
                 eager_prefill_ms=graphs[f"prefill {prefill_mode}"][
                     "eager_ms"],
                 decode_ms=decode_ms,
                 eager_decode_ms=graphs["decode ar"]["eager_ms"],
                 tokens_per_s=m["tokens_per_s"], peak_gb=peak_gb,
                 logits_rel_l2=k_rel, logits_rel_l2_ulp=k_floor,
                 argmax_agree=k_agree, argmax_agree_ulp=k_agree_floor)
    if not model["logits_rel_l2"] <= 2 * model["logits_rel_l2_ulp"]:
        raise AssertionError("kernel path logits drift more than twice the "
                             "one-ulp perturbation's")
    if prefill_mode == "dist":
        # the xla prefill on the same weights, torch ops only: its
        # collectives and dots are torch's, its attention the plain one
        xla = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                     world=world, prefill_mode="xla", cuda_graph=False)
        with Swapped(plain):
            xla_logits, _ = xla.prefill(prompts)
        torch.cuda.synchronize()

        def rel_xla(a):
            return ((a - xla_logits).norm() / xla_logits.norm()).item()

        model.update(logits_rel_l2_xla=rel_xla(logits),
                     plain_rel_l2_xla=rel_xla(plain_logits))
        log(f"  prefill logits against the world-{world} xla prefill (torch "
            f"ops, no kernel): relative L2 {rel_xla(logits):.4e} (kernels), "
            f"{rel_xla(plain_logits):.4e} (plain versions)")
        del xla, xla_logits
    del eng, sched_eng, cache, logits, plain_logits
    torch.cuda.empty_cache()
    return main_n, records, model


def check_small_model(world: int, prefill_mode: str = "ar",
                      moe: bool = False):
    """A small config with head_dim 128 in f32 on the card (the kernels)
    against the same weights on the CPU (the plain versions): logits of
    a prefill and three decode steps, and greedy tokens equal. World 1:
    a 3 x 37 prefill, within 1e-3. World 4: an 8 x 40 prefill (320 rows;
    `ar`: gemm_ar takes gemm_rs + ring AG; `dist`: ag_gemm and gemm_rs,
    80 rows a rank; decode takes the one-shot AR), within 1e-4. With
    moe, the tiny MoE config (4 experts, top-2): `dist` takes the ring
    AG and the ring RS around the block, `fused` the grouped ag_gemm and
    the ring RS."""
    import torch

    from triton_dist_tpu_torch.models import Engine, ModelConfig
    from triton_dist_tpu_torch.models.dense import init_params

    preset = ModelConfig.tiny_moe if moe else ModelConfig.tiny
    cfg = preset(head_dim=128, num_q_heads=8, num_kv_heads=4,
                 max_positions=128)
    params = init_params(cfg, device="cpu", seed=3, world=world)
    kw = dict(params=params, world=world, prefill_mode=prefill_mode)
    cpu = Engine(cfg, device="cpu", **kw)
    gpu = Engine(cfg, device="cuda", **{**kw, "params": params.to("cuda")})
    b, s, tol = (3, 37, 1e-3) if world == 1 else (8, 40, 1e-4)
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(0))
    kernels_before = _launch_total()
    err = 0.0
    (lc, cc), (lg, cg) = cpu.prefill(ids), gpu.prefill(ids)
    for _ in range(4):
        err = max(err, (lg.cpu() - lc).abs().max().item())
        tok = lc.argmax(-1)
        (lc, cc), (lg, cg) = cpu.decode_step(tok, cc), gpu.decode_step(tok, cg)
    want = cpu.serve(ids, 6).tolist()
    got = gpu.serve(ids, 6).cpu().tolist()
    launched = _launch_total() - kernels_before
    log(f"  small {'MoE ' if moe else ''}model (f32, head_dim 128, world "
        f"{world}, prefill {prefill_mode}) card vs CPU: "
        f"max abs logit diff {err:.3e} (atol {tol:g}), greedy tokens equal "
        f"{got == want}, {launched} kernel launches")
    assert err <= tol and got == want and launched > 0


def _launch_total() -> int:
    from triton_dist_tpu_torch import kernels

    return sum(kernels.launches().values())


def device_us(fn, key, reps=10, tries=5):
    """Mean device time in µs of the kernels whose name holds `key` over
    `reps` calls of fn traced by torch.profiler. A trace that holds no
    such kernel time is logged with the kernel names it did hold and
    taken again after half a second, up to `tries` traces (one where the
    last row's traces all missed); when every one missed, the time of a
    call in a CUDA graph of `reps` calls (graph_device_us). (On an H100 three traces in a row of one
    cooperative kernel once held its launches but no kernel record,
    while the next call's trace held its kernels.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tries = 1 if _LOSING[0] else tries
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        _TRACES.append(prof)
        events = prof.key_averages()
        hits = [e for e in events if key in e.key]
        calls = sum(e.count for e in hits)
        total = sum(float(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
                    for e in hits)
        if calls and total > 0:
            _LOSING[0] = False
            return total / calls
        free, total = torch.cuda.mem_get_info()
        log(f"  device_us: trace {attempt} of {tries} holds no {key} time "
            f"({len(hits)} matching keys, {calls} calls; keys "
            f"{sorted(e.key[:60] for e in events)[:12]}; {free / 1e9:.2f} "
            f"GB free of {total / 1e9:.2f}, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB held by torch)")
        time.sleep(0.5)
    return graph_device_us(fn, reps)


def device_us_total(fn, reps=10, tries=5):
    """Device µs a call of fn (for a library call whose kernels we do not
    pin), from a torch.profiler trace of `reps` calls. A trace on an H100
    may lose records (most often the last kernel's), so each kernel name
    gives its mean time over the records the trace holds, times its
    records a call (its count over reps, rounded up), and the call is
    their sum. A trace with no device record is logged and taken again
    after half a second, up to `tries` traces; when every one missed,
    graph_device_us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tries = 1 if _LOSING[0] else tries
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        _TRACES.append(prof)
        us, records = 0.0, 0
        for e in prof.key_averages():
            total = float(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
            if total > 0 and e.count:
                us += total / e.count * -(-e.count // reps)
                records += e.count
        if records:
            _LOSING[0] = False
            return us
        log(f"  device_us_total: trace {attempt} of {tries} holds no "
            "device record")
        time.sleep(0.5)
    return graph_device_us(fn, reps)


def host_parts(call, checks, buffers, launch, calls=100, pools=None,
               more=None):
    """A ring wrapper's host µs a call, time.perf_counter around `calls`
    unsynchronised calls of each: the whole call, and its parts: checks
    (the wrapper's Python checks), buffers (the output's allocation and
    the persistent pool's lookup), ctypes (the C entry called with n = 0,
    which returns before any CUDA call), launch (the C entry less that:
    launch_world's device query, its cached grid and the cooperative
    launch), the parts of `more` ({name: fn}), rest (the wrapper's other
    Python: library lookup, device guard, error check, count). Asserts
    that no warm call made a pool (`pools`: the wrapper's PoolCache; None
    for a wrapper that keeps none)."""
    import torch

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return dt

    made = None if pools is None else pools.made
    parts = dict(call=per_call(call), checks=per_call(checks),
                 buffers=per_call(buffers),
                 ctypes=per_call(lambda: launch(0)),
                 launch=per_call(lambda: launch(None)))
    parts.update({k: per_call(fn) for k, fn in (more or {}).items()})
    parts["launch"] -= parts["ctypes"]
    parts["rest"] = parts["call"] - sum(
        v for k, v in parts.items() if k != "call")
    assert pools is None or pools.made == made, "a warm call made a pool"
    return parts


def ag_host_parts(kernels, x):
    """host_parts of the ring AllGather's wrapper on x."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather as agr

    lib = _build.load("allgather", agr._SIGNATURES)
    out, flags, stream = agr._ring_buffers(x)
    grid = _build.GridInfo()
    chunk = x[0].numel() * x.element_size()

    def launch(n):
        err = lib.ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                            x.shape[0] if n is None else n, chunk,
                            grid.ptr(), stream)
        assert (err == 0) == (n is None), err

    return host_parts(
        lambda: kernels.ring_all_gather(x),
        lambda: (wire.resolve(None), agr._check_launch(x)),
        lambda: agr._ring_buffers(x), launch, pools=agr._POOLS)


def a2a_host_parts(kernels, x, sp, q=None):
    """host_parts of an A2A wrapper on (x, sp): the single-shot kernel,
    or with q the chunked one; its splits conversion timed apart from
    checks and buffers."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    lib = _build.load("all_to_all", a2a._SIGNATURES)
    seg, _, _ = a2a._check_launch(x, None)
    n, qq = x.shape[0], q or 1
    aligned = x.data_ptr() % 16 == 0
    body = a2a._body_for(n, seg, qq, aligned)
    word = a2a._word(seg, qq, aligned, body)
    spc = a2a._splits(x, sp)
    out, out_sp, flags, stream = a2a._buffers(x, spc, qq)
    grid = _build.GridInfo()

    def launch(m):
        err = lib.a2a_launch(
            x.data_ptr(), out.data_ptr(), spc.data_ptr(), out_sp.data_ptr(),
            flags.data_ptr(), n if m is None else m, seg // word,
            spc.numel() // (n * n), qq, word, int(q is not None),
            int(body == "bulk"), -1, 0, 0, grid.ptr(), stream)
        assert (err == 0) == (m is None), err

    if q is None:
        call = lambda: a2a.all_to_all(x, sp)  # noqa: E731
    else:
        call = lambda: a2a.all_to_all_chunked(x, sp, n_chunks=q)  # noqa
    return host_parts(
        call, lambda: (a2a._check(x, sp), a2a._check_launch(x, None)),
        lambda: a2a._buffers(x, spc, qq), launch, pools=a2a._POOLS,
        more=dict(splits=lambda: a2a._splits(x, sp)))


def check_a2a_pools(kernels, cases, calls=50):
    """The A2A kernels' persistent flag pools: `calls` back-to-back calls
    on one stream, in turn over cases ((x, splits, q): q None for the
    single-shot kernel, else the chunked one at q), so the two kernels,
    the chunk counts and the shapes alternate; each bitwise its plain
    version. Then every flag of every pool reads zero and no call past
    the first round made a pool. Returns {pool: bytes}."""
    import torch

    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    wants = [kernels.all_to_all_plain(x, sp) for x, sp, _ in cases]
    made = None
    for i in range(calls):
        x, sp, q = cases[i % len(cases)]
        got = (a2a.all_to_all(x, sp) if q is None else
               a2a.all_to_all_chunked(x, sp, n_chunks=q))
        torch.cuda.synchronize()
        want, want_sp = wants[i % len(cases)]
        assert torch.equal(got[0], want) and torch.equal(got[1], want_sp), i
        if i == len(cases) - 1:
            made = a2a._POOLS.made
    assert a2a._POOLS.made == made, "a warm all-to-all made a pool"
    zero = all(not bool(f.any()) for f in a2a._POOLS.entries.values())
    assert zero, "an all-to-all left a flag set"
    held = {f"n={k[2]} q={k[3]}": f.numel() * 4
            for k, f in a2a._POOLS.entries.items()}
    log(f"  all_to_all: {calls} calls back to back, single-shot and "
        f"chunked in turn over {[(tuple(x.shape), q) for x, _, q in cases]}"
        f", bitwise; every pool flag at zero; {a2a._POOLS.made} pools made, "
        f"none by a warm call; pool bytes {held}")
    return held


def check_ag_pools(kernels, xs, calls=50):
    """The ring AllGather's persistent flag pools: `calls` back-to-back
    calls on one stream over the inputs xs in turn, each bitwise its
    plain version; then every flag of every pool reads zero and no call
    past the first of each input made a pool. Returns {pool: bytes}."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather as agr

    wants = [kernels.ring_all_gather_plain(x) for x in xs]
    made = None
    for i in range(calls):
        got = kernels.ring_all_gather(xs[i % len(xs)])
        torch.cuda.synchronize()
        assert torch.equal(got, wants[i % len(xs)]), i
        if i == len(xs) - 1:
            made = agr._POOLS.made
    assert agr._POOLS.made == made, "a warm ring_all_gather made a pool"
    zero = all(not bool(f.any()) for f in agr._POOLS.entries.values())
    assert zero, "ring_all_gather left a flag set"
    held = {f"n={k[2]} chunk {k[3]} B, {k[4]} tiles": f.numel() * 4
            for k, f in agr._POOLS.entries.items()}
    log(f"  ring_all_gather: {calls} calls back to back over "
        f"{[tuple(x.shape) for x in xs]}, bitwise; every pool flag at zero; "
        f"{agr._POOLS.made} pools made, none by a warm call; pool bytes "
        f"{held}")
    return held


def check_fm_pools(kernels, xs, calls=50):
    """The full mesh's persistent delivery pool: `calls` back-to-back
    calls on one stream, with no synchronisation between them, in turn
    over a ragged payload (70 bytes a rank: not a multiple of 16 bytes)
    and the inputs xs, every fifth call with one rank delayed
    P2P_STRAGGLE_NS (each rank in turn); then each result bitwise its
    plain version, every word of every pool at zero, and no call past the
    first made a pool. Returns {pool: bytes}."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather as agr

    n = xs[0].shape[0]
    xs = [payload((n, 5, 7), torch.bfloat16, 301), *xs]
    runs, made = [], None
    for i in range(calls):
        x = xs[i % len(xs)]
        late = (i // 5 % n, P2P_STRAGGLE_NS) if i % 5 == 4 else None
        runs.append((i, x, late,
                     kernels.full_mesh_all_gather(x, straggler=late)))
        if i == 0:
            made = agr._FM_POOLS.made
    for i, x, late, got in runs:
        check_bitwise(f"full_mesh_all_gather call {i} {tuple(x.shape)} "
                      f"straggler {late}", got,
                      kernels.full_mesh_all_gather_plain(x))
    assert agr._FM_POOLS.made == made, "a warm full mesh made a pool"
    zero = all(not bool(f.any()) for f in agr._FM_POOLS.entries.values())
    assert zero, "full_mesh_all_gather left a delivery word set"
    held = {f"n={k[2]}": f.numel() * 4
            for k, f in agr._FM_POOLS.entries.items()}
    log(f"  full_mesh_all_gather: {calls} calls back to back over "
        f"{[tuple(x.shape) for x in xs]}, a straggler every fifth call, "
        f"bitwise; every pool word at zero; {agr._FM_POOLS.made} pools "
        f"made, none by a warm call; pool bytes {held}")
    return held


def rs_host_parts(kernels, x):
    """host_parts of the native ring's wrapper on x (its own dtype)."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    lib = _build.load("reduce_scatter", rs._SIGNATURES)
    out, acc, flags, tile, stream = rs._ring_buffers(x, x.dtype)
    grid = _build.GridInfo()
    code = rs._DTYPE_CODE[x.dtype]

    def launch(n):
        err = lib.rs_launch(x.data_ptr(), acc.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), x.shape[0] if n is None else n,
                            out[0].numel(), tile, code, code, -1, 0,
                            grid.ptr(), stream)
        assert (err == 0) == (n is None), err

    return host_parts(
        lambda: kernels.ring_reduce_scatter(x),
        lambda: (rs._check(x), wire.resolve(None), rs._check_ring(x)),
        lambda: rs._ring_buffers(x, x.dtype), launch, pools=rs._POOLS)


def rs_wire_host_parts(kernels, x, fmt):
    """host_parts of the wire ring's wrapper on x in format fmt."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    lib = _build.load("reduce_scatter", rs._SIGNATURES)
    out, slots, flags, warps, rows, stream = rs._wire_buffers(x, fmt,
                                                               x.dtype)
    grid = _build.GridInfo()
    k = x[0, 0].numel()
    nb = wire.n_blocks(k, fmt)
    code = rs._DTYPE_CODE[x.dtype]

    def launch(n):
        err = lib.rs_wire_launch(
            x.data_ptr(), slots.data_ptr(), out.data_ptr(),
            flags.data_ptr(), x.shape[0] if n is None else n, out.shape[1],
            k, int(fmt.kind == "fp8"), k // nb, nb, int(fmt.checksum),
            slots.shape[-1], warps, rows, code, code, -1, 0, grid.ptr(),
            stream)
        assert (err == 0) == (n is None), err

    return host_parts(
        lambda: kernels.ring_reduce_scatter_wire(x, fmt),
        lambda: (wire.resolve(fmt), rs._check(x), rs._wire_check(x, fmt, None),
                 rs._check_ring(x), wire.wire_cols(k, fmt)),
        lambda: rs._wire_buffers(x, fmt, x.dtype), launch, pools=rs._POOLS)


def rs_extras(label, row, x, host, wire_row=False):
    """Completes a ring RS row (time_collective's, the library one sum
    over the rank dim of the chunked input): for a wire row that sum in ms
    and device µs as a yardstick only, kept as sum_ms / sum_us (it does
    not requantize); the wrapper's host µs by part, and the share of the
    bound that the kernel's device time reaches; logs them."""
    n, nm = x.shape[:2]

    def library():
        return x.view(n, n, nm // n, -1).sum(0)

    ms_key, us_key = ("sum_ms", "sum_us") if wire_row else (
        "library_ms", "library_us")
    if wire_row:
        row[ms_key] = time_ms(library)
        row[us_key] = device_us_total(library)
    row["host_us"] = host
    dev = row.get("device_us")
    row["bound_share"] = None if not dev else row["bound_ms"] * 1e3 / dev
    parts = ", ".join(f"{k} {v:.1f}" for k, v in host.items() if k != "call")
    log(f"  {label}: call {row['ms']:.4f} ms, device {dev} us, host "
        f"{host['call']:.1f} us a call ({parts}), "
        f"{'sum' if wire_row else 'library'} {row[ms_key]:.4f} ms / "
        f"{row[us_key]} us device, bound {row['bound_ms']:.4f} ms, share "
        f"{row['bound_share']}")
    return row


def time_collective(label, fn, plain, library, ops, nbytes, dtype,
                    kernel_key=None):
    """Kernel, plain and library times of one call, beside the bound;
    with kernel_key, the kernel's device time from the profiler too; the
    library call's device time beside its call time (device_us_total).
    library None: timed by the caller."""
    bnd, by = bound_ms(ops, nbytes, str(dtype)[6:])
    row = dict(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=bnd,
               bound_by=by,
               library_ms=None if library is None else time_ms(library),
               gflop=ops / 1e9, mbytes=nbytes / 1e6)
    if kernel_key is not None:
        row["device_us"] = device_us(fn, kernel_key)
    if library is not None:
        row["library_us"] = device_us_total(library)
    dev = ("" if kernel_key is None else
           f", device {row['device_us']} us" if row["device_us"] is None else
           f", device {row['device_us']:.1f} us")
    lib = ("" if library is None else
           f", library {row['library_ms']:.4f} ms / {row['library_us']} us "
           "device")
    log(f"  {label}: kernel {row['ms']:.4f} ms{dev}, plain "
        f"{row['plain_ms']:.4f} ms{lib}, bound {bnd:.4f} ms ({by}; "
        f"{row['gflop']:.3f} GFLOP, {row['mbytes']:.2f} MB)")
    return row


def time_collectives(kernels, records):
    """Each collective kernel timed on inputs the world-4 main path gave
    it. AR: a scheduler step's (4, 256, 4096) and a decode step's
    (4, 4, 4096); AG: the prefill's (4, 128, 4096); gemm_rs: the
    prefill's down projection (K 3072) and O projection (K 1024), and
    the down projection at n = 1 (force_kernel, K 12288). The
    bound counts the work of all n ranks on the one card: AR n inputs
    read and n outputs written (its n(n-1) adds per element at the f32
    rate), AG n shards read and n*n written, gemm_rs 2nMKN operations at
    the bf16 peak against n(MK + KN) read and n(M/n)N written. Library
    yardsticks (never called by the port): x.sum(0) broadcast, one copy,
    one einsum. Returns name -> {label: row} and each kernel's main row
    label."""
    import torch

    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    def biggest(name, key, pick):
        return max(records[name], key=lambda r: pick(r[key].shape))

    ar_sched = biggest("one_shot_all_reduce", "x", lambda s: s[1])["x"]
    ar_dec = min(records["one_shot_all_reduce"],
                 key=lambda r: r["x"].shape[1])["x"]
    ag_x = records["ring_all_gather"][0]["x"]
    rs_down = biggest("gemm_rs", "a", lambda s: s[2])
    rs_o = min(records["gemm_rs"], key=lambda r: r["a"].shape[2])
    rows = {"one_shot_all_reduce": {}, "ring_all_gather": {}, "gemm_rs": {}}
    for x, step in ((ar_sched, "scheduler step"), (ar_dec, "decode step")):
        n, e = x.shape[0], x[0].numel()
        label = f"{step} x {tuple(x.shape)} bf16"
        rows["one_shot_all_reduce"][label] = time_collective(
            f"one_shot_all_reduce {label}",
            lambda x=x: kernels.one_shot_all_reduce(x),
            lambda x=x: kernels.one_shot_all_reduce_plain(x),
            lambda x=x: x.sum(0).expand_as(x),
            n * (n - 1) * e, 2 * n * e * x.element_size(), x.dtype,
            kernel_key="one_shot_ar_kernel")
    n, m = ag_x.shape[:2]
    out = torch.empty((n, n * m, *ag_x.shape[2:]), dtype=ag_x.dtype,
                      device=ag_x.device)
    label = f"prefill x {tuple(ag_x.shape)} bf16"
    chunk = ag_x[0].numel() * ag_x.element_size()
    row = time_collective(
        f"ring_all_gather {label}", lambda: kernels.ring_all_gather(ag_x),
        lambda: kernels.ring_all_gather_plain(ag_x),
        lambda: out.copy_(ag_x.reshape(1, n * m, *ag_x.shape[2:])
                          .expand(out.shape)),
        0, n * chunk + n * n * chunk, ag_x.dtype,
        kernel_key="ring_ag_kernel")
    row["host_us"] = ag_host_parts(kernels, ag_x)
    row["bound_share"] = (None if not row["device_us"]
                          else row["bound_ms"] * 1e3 / row["device_us"])
    parts = ", ".join(f"{k} {v:.1f}" for k, v in row["host_us"].items()
                      if k != "call")
    log(f"  ring_all_gather {label}: host {row['host_us']['call']:.1f} us a "
        f"call ({parts}); bound share {row['bound_share']}")
    rows["ring_all_gather"][label] = row
    for rec, proj in ((rs_down, "down"), (rs_o, "O")):
        a, b = rec["a"], rec["b"]
        n, M, K = a.shape
        N = b.shape[2]
        label = f"prefill {proj} projection a {tuple(a.shape)} b {tuple(b.shape)} bf16"
        rows["gemm_rs"][label] = time_collective(
            f"gemm_rs {label}", lambda a=a, b=b: kernels.gemm_rs(a, b),
            lambda a=a, b=b: kernels.gemm_rs_plain(a, b),
            lambda a=a, b=b: torch.einsum("rmk,rkn->mn", a, b),
            2 * n * M * K * N,
            (n * (M * K + K * N) + n * (M // n) * N) * a.element_size(),
            a.dtype, kernel_key="gemm_rs")
    # the same kernel at n = 1 (force_kernel; the JAX _local_mm_kernel's
    # place): the world-1 down projection, these ranks' K blocks joined
    a, b = rs_down["a"], rs_down["b"]
    n, M, K = a.shape
    a1 = a.permute(1, 0, 2).reshape(1, M, n * K).contiguous()
    b1 = b.reshape(1, n * K, -1)
    N = b1.shape[2]
    body = grs._body_for(1, M, n * K, N, a1.dtype, a1.dtype)
    label = (f"n = 1 force_kernel a {tuple(a1.shape)} b {tuple(b1.shape)} "
             f"bf16, {body} body")
    before = dict(grs.launches_by_body)
    _, ratio = check_rs(kernels, a1, b1, force_kernel=True)
    assert grs.launches_by_body[body] - before[body] == 1, (
        before, grs.launches_by_body)
    log(f"  gemm_rs {label}: at most {ratio:.3f} of its atol")
    rows["gemm_rs"][label] = time_collective(
        f"gemm_rs {label}",
        lambda: kernels.gemm_rs(a1, b1, force_kernel=True),
        lambda: kernels.gemm_rs_plain(a1, b1),
        lambda: torch.matmul(a1, b1), 2 * M * n * K * N,
        (M * n * K + n * K * N + M * N) * a1.element_size(), a1.dtype,
        kernel_key="gemm_rs")
    main = {"one_shot_all_reduce": next(iter(rows["one_shot_all_reduce"])),
            "ring_all_gather": next(iter(rows["ring_all_gather"])),
            "gemm_rs": next(iter(rows["gemm_rs"]))}
    pools = check_ar_pools(kernels, (ar_sched, ar_dec))
    sweep, plan = ar_tile_sweep((ar_dec, ar_sched))
    ag_pools = check_ag_pools(kernels, (ag_x, rand((4, 37, 1000),
                                                   torch.bfloat16, 37)))
    return rows, main, dict(pool_bytes=pools, tile_sweep=sweep, plan=plan,
                            ag_pool_bytes=ag_pools)


def check_ar_pools(kernels, xs, calls=50):
    """Row 7's persistent pools: `calls` back-to-back calls on one
    stream over the inputs xs (the recorded decode and scheduler steps'),
    in turn, each bitwise its plain version; then every flag of every
    pool reads zero, no call past the first of each input made a pool,
    and the bytes the pools hold are logged. Returns {pool: bytes}."""
    import torch

    from triton_dist_tpu_torch.kernels import allreduce as ar

    wants = [kernels.one_shot_all_reduce_plain(x) for x in xs]
    made = None
    for i in range(calls):
        got = kernels.one_shot_all_reduce(xs[i % len(xs)])
        torch.cuda.synchronize()
        assert torch.equal(got, wants[i % len(xs)]), i
        if i == len(xs) - 1:
            made = ar._POOLS.made
    assert ar._POOLS.made == made, "a warm one_shot_all_reduce made a pool"
    zero = all(not bool(f.any()) for _, f in ar._POOLS.entries.values())
    assert zero, "one_shot_all_reduce left a flag set"
    held = {f"n={k[2]} E={k[3]} {str(k[4])[6:]} tile {k[5]} blocks {k[6]}":
            sum(t.numel() * t.element_size() for t in v)
            for k, v in ar._POOLS.entries.items()}
    log(f"  one_shot_all_reduce: {calls} calls back to back over "
        f"{[tuple(x.shape) for x in xs]}, bitwise; every pool flag at zero; "
        f"{ar._POOLS.made} pools made, none by a warm call; pool bytes "
        f"(workspace + flags) {held}")
    return held


def ar_tile_sweep(xs):
    """Row 7 with each tile of its sweep forced, at each input of xs:
    bitwise, device µs a call; and the plan's pick. Returns {label: µs}
    and {shape: (tile, blocks, flags)}."""
    import torch

    from triton_dist_tpu_torch.kernels import allreduce as ar

    sweep, plan = {}, {}
    for x in xs:
        want = ar.one_shot_all_reduce_plain(x)
        for tile in ar._AR_TILES:
            def fn(x=x, tile=tile):
                return ar._launch(x, tile)
            assert torch.equal(fn(), want), (tuple(x.shape), tile)
            sweep[f"{tuple(x.shape)} tile {tile}"] = device_us(
                fn, "one_shot_ar_kernel")
        plan[str(tuple(x.shape))] = ar._ar_plan(
            x[0].numel(), x.shape[0], x.element_size(),
            torch.cuda.get_device_properties(0).multi_processor_count)
    log("  one_shot_all_reduce tile sweep (bf16, bitwise; device us): "
        + "; ".join(f"{k}: {v}" for k, v in sweep.items())
        + f"; the plan (tile, blocks, flags) takes {plan}")
    return sweep, plan


def check_recorded_dist(kernels, records):
    """ag_gemm and gemm_rs against their plain versions on the inputs
    the world-4 `dist` path gave them (QKV in rank order, gate|up
    silu_pair in arrival order; O in rank order, down in arrival order).
    Returns name -> max abs error."""
    errs = {}
    for name, check, opts in (
            ("ag_gemm", check_ag_gemm_call, ("epilogue", "c_order",
                                             "counts")),
            ("gemm_rs", check_rs, ("a_order",))):
        err_max, ratio_max = 0.0, 0.0
        for rec in records[name]:
            kw = {k: rec[k] for k in opts if k in rec}
            err, ratio = check(kernels, rec["a"], rec["b"], **kw)
            err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
        errs[name] = err_max
        shapes = sorted({(tuple(r["a"].shape),
                          tuple(r["b"][0].shape if isinstance(r["b"], tuple)
                                else r["b"].shape),
                          tuple(sorted((k, "live rows" if k == "counts"
                                        else r[k])
                                       for k in opts if k in r)))
                         for r in records[name]})
        log(f"  {name} on {len(records[name])} recorded dist-path calls, "
            f"(a, b, options) {shapes}: max_abs_err={err_max:.3e}, at most "
            f"{ratio_max:.3f} of its atol")
    return errs


def time_dist(kernels, records):
    """ag_gemm and gemm_rs timed on inputs the world-4 `dist` path gave
    them: QKV (rank order) and gate|up (silu_pair, arrival order) at the
    prefill (m 128 a rank) and at a scheduler step (m 64), and the down
    projection in arrival order at the prefill. Bound over all n ranks:
    ag_gemm 2 n (n m) K N operations (twice that for the pair) at the
    bf16 peak against n m K + n K N (per weight) read and n (n m) N
    written; gemm_rs as time_collectives. Library yardsticks (never
    called by the port): one einsum of the gathered A with b (for the
    pair, with [w_gate | w_up] joined: the product only, no silu), and
    one einsum for gemm_rs. Returns {label: row} for each, and ag_gemm's
    main label."""
    import torch

    ag_rows, rs_rows = {}, {}

    def pick(name, test):
        return next(r for r in records[name] if test(r))

    for m, when in ((128, "prefill"), (64, "scheduler step")):
        for pair in (False, True):
            rec = pick("ag_gemm", lambda r: r["a"].shape[1] == m
                       and isinstance(r["b"], tuple) == pair)
            a, b = rec["a"], rec["b"]
            kw = {k: rec[k] for k in ("epilogue", "c_order") if k in rec}
            ws = b if pair else (b,)
            n, _, K = a.shape
            N = ws[0].shape[2]
            full = a.reshape(n * m, K)
            wcat = torch.cat(ws, dim=2) if pair else b
            what = "gate|up silu_pair arrival" if pair else "QKV rank"
            label = (f"{when} {what} a {tuple(a.shape)} b {len(ws)} x "
                     f"{tuple(ws[0].shape)} bf16")
            ag_rows[label] = time_collective(
                f"ag_gemm {label}",
                lambda a=a, b=b, kw=kw: kernels.ag_gemm(a, b, **kw),
                lambda a=a, b=b, kw=kw: kernels.ag_gemm_plain(a, b, **kw),
                lambda full=full, wcat=wcat: torch.einsum("mk,rkn->rmn",
                                                          full, wcat),
                2 * n * (n * m) * K * N * len(ws),
                (n * m * K + len(ws) * n * K * N + n * n * m * N)
                * a.element_size(), a.dtype, kernel_key="ag_gemm")
    rec = pick("gemm_rs", lambda r: r.get("a_order") == "arrival"
               and r["a"].shape[1] == 512)
    a, b = rec["a"], rec["b"]
    n, M, K = a.shape
    N = b.shape[2]
    label = (f"prefill down projection, A in arrival order, a {tuple(a.shape)}"
             f" b {tuple(b.shape)} bf16")
    rs_rows[label] = time_collective(
        f"gemm_rs {label}",
        lambda: kernels.gemm_rs(a, b, a_order="arrival"),
        lambda: kernels.gemm_rs_plain(a, b, "arrival"),
        lambda: torch.einsum("rmk,rkn->mn", a, b), 2 * n * M * K * N,
        (n * (M * K + K * N) + n * (M // n) * N) * a.element_size(), a.dtype,
        kernel_key="gemm_rs")
    main = next(k for k in ag_rows if k.startswith("prefill gate|up"))
    return ag_rows, rs_rows, main


# -- the decode megakernel (the fifth path) -------------------------------

MEGA_STEPS = 16
# a layout, position or rank-order fault moves a step's logits by O(1)
# relative L2; the bf16 roundings that the eager and the megakernel paths
# take at other points move them by O(1e-2) (PERF.md)
MEGA_EAGER_REL_L2 = 0.25


def mega_atol(want) -> float:
    """Two bf16 ulps of the largest value of a megakernel output (2 * 2^-7
    of it): the kernel and run_plain round the same values to bf16 at the
    same points after f32 sums taken in another order, so one rounding may
    differ by an ulp and carry into the next."""
    return 2 * 2.0 ** -7 * want.float().abs().max().item() + 1e-6


def mega_row_outputs(row):
    """(slot, width) of each workspace output a queue row writes
    (mega/kernel.py lays the rows out)."""
    from triton_dist_tpu_torch.mega.kernel import OPS

    op, row = OPS[row[0]], [int(v) for v in row]
    if op == "matmul":
        return [(row[3], row[10])]
    if op in ("rms_norm", "add", "allreduce_add"):
        return [(row[3], row[9])]
    if op == "silu_mul":
        return [(row[2], row[9])]
    if op == "attention":
        hq_l, hkv_l, d = row[8:11]
        return [(row[3], hq_l * d), (row[4], hkv_l * d), (row[5], hkv_l * d)]
    return []


def check_mega_rows(cm, pos, table, ws, weights, norms, rope, kp, vp):
    """Teacher-forced, on one step's inputs: each queue row of `cm` once on
    the kernel (a queue of that row alone, its producers met) from the
    workspace run_plain has built up to that row, against run_plain's row.
    Each output within two bf16 ulps of its largest value (mega_atol), every
    other workspace value bitwise unchanged, and inside the epsilon band of
    its dtype (tests/torch_parity.py); raises naming every output outside
    it. Shared with tests/test_torch_cuda.py's branch test. Returns (max
    abs error, the worst err / atol, the op of its row, the band's worst
    (ulp, cos, op) and the count of outputs outside it, 0)."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.mega.kernel import _PLAIN, HINT, OPS

    parity = torch_parity()
    ws = ws.clone()
    err_max, worst, worst_op = 0.0, 0.0, None
    band_worst, outside = (0, 0.0, None), []
    for i, row in enumerate(cm.queue):
        alone = row.copy()
        alone[17] = 0
        alone[HINT] = 0  # no issuer in a queue of one row: cold
        one = dataclasses.replace(cm, queue=alone[None], _dev_queue={})
        got = one.run(pos, table, ws.clone(), weights, norms, rope, kp, vp)
        _PLAIN[OPS[row[0]]](cm, row, pos, table, ws, weights, norms, rope, kp,
                            vp)
        torch.cuda.synchronize()
        other = got != ws
        for slot, width in mega_row_outputs(row):
            g, w = got[:, slot, :, :width], ws[:, slot, :, :width]
            err = (g.float() - w.float()).abs().max().item()
            atol = mega_atol(w)
            if not bool(torch.isfinite(g).all()) or not err <= atol:
                raise AssertionError(f"mega row {i} ({OPS[row[0]]}) slot "
                                     f"{slot}: err {err}, atol {atol}")
            err_max = max(err_max, err)
            if err / atol > worst:
                worst, worst_op = err / atol, OPS[row[0]]
            rep = parity.check_epsilon(
                w.float().cpu().numpy(), g.float().cpu().numpy(), "mega",
                w.dtype)
            if not rep["ok"]:
                outside.append((i, OPS[row[0]], slot, rep["ulp"],
                                rep["cos"]))
            if rep["ulp"] > band_worst[0]:
                band_worst = (rep["ulp"], rep["cos"], OPS[row[0]])
            other[:, slot, :, :width] = False
        if bool(other.any()):
            raise AssertionError(f"mega row {i} ({OPS[row[0]]}) wrote "
                                 f"{int(other.sum())} workspace values "
                                 "outside its outputs")
    if outside:
        raise AssertionError(f"mega rows outside the epsilon band, teacher-"
                             f"forced (row, op, slot, ulp, cos): {outside}")
    return err_max, worst, worst_op, band_worst, len(outside)


def check_mega_branches(world, paged, depth=None, device="cuda"):
    """Every branch of the megakernel against run_plain at the Qwen3-8B
    widths a rank sees at `world` (hidden 4096, intermediate 12288 / n,
    32 / n q and 8 / n kv heads of 128, s_max MAX_LEN, batch 4; positions
    0, 127, 512 and 1023; a dense pool or 64-token pages through a
    shuffled table), bf16, one launch of the prefetching kernel at arena
    depth `depth` (None: auto), the gate|up weights tile-major as
    MegaQwen3 lays them out; each branch's output within two bf16 ulps of
    its largest value (the two round the same values at the same points
    after f32 sums in another order), and the fed / cold matmul rows of
    the queue the kernel read the plan's. Returns the max abs error."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch import kernels
    from triton_dist_tpu_torch.mega.builder import branch_graph
    from triton_dist_tpu_torch.mega.kernel import (
        blocks_per_rank,
        compile_graph,
        tile_weight_major,
    )
    from triton_dist_tpu_torch.mega.scheduler import (
        schedule_graph,
        validate_schedule,
    )

    b, h, d, s_max = 4, 4096, 128, MAX_LEN
    inter, hq, hkv = 12288 // world, 32 // world, 8 // world
    page = 64 if paged else s_max
    g = branch_graph(world, b, h, inter, hq, hkv, d, s_max,
                     page if paged else 0)
    blocks = blocks_per_rank(device, world)
    sched = schedule_graph(g, pf_depth=depth, blocks=blocks)
    validate_schedule(g, sched)
    tiled = ("w_gu", "w_gu2")
    cm = compile_graph(g, sched, torch.bfloat16, blocks=blocks, world=world,
                       tiled_weights=tiled)
    bf = torch.bfloat16
    shapes = {"w_gu": (h, 2 * inter), "w_dn": (inter, h),
              "w_qkv": (h, (hq + 2 * hkv) * d), "w_o": (hq * d, h),
              "w_gu2": (h, 2 * inter), "w_dn2": (inter, h)}
    weights = {k: rand((2, world, *sh), bf, 50 + i, 0.02)
               for i, (k, sh) in enumerate(shapes.items())}
    norms = 1.0 + rand((7, cm.norm_width), torch.float32, 60, 0.1)
    rope = rand((s_max, d), torch.float32, 61, 0.7)
    maxp = s_max // page
    pages = b * maxp + 1
    kp = rand((2, world * hkv, pages, page, d), bf, 62, 0.5)
    vp = rand((2, world * hkv, pages, page, d), bf, 63, 0.5)
    order = (np.random.default_rng(world).permutation(pages - 1)[:b * maxp]
             + 1) if paged else np.arange(b * maxp)
    table = torch.as_tensor(order.reshape(b, maxp), dtype=torch.int32,
                            device=device)
    pos = torch.tensor([0, 127, s_max // 2, s_max - 1], dtype=torch.int32,
                       device=device)
    weights = {k: (tile_weight_major(w, cm.tile_cols(k)) if k in tiled
                   else w) for k, w in weights.items()}
    ws = cm.workspace(device)
    ws[:, int(sched.buf_slot[0]), :, :h] = rand((b, h), bf, 64)
    want = cm.run_plain(pos, table, ws.clone(), weights, norms, rope, kp, vp)
    before = kernels.launches()["mega"]
    got = cm.run(pos, table, ws, weights, norms, rope, kp, vp)
    torch.cuda.synchronize()
    assert kernels.launches()["mega"] == before + 1
    fed, cold = cm.queue_counts(cm.queue_on(ws.device).cpu().numpy())
    if (fed, cold) != cm.plan_counts():
        raise AssertionError(f"mega branches (world {world}, depth "
                             f"{cm.pf_depth}): the queue feeds {fed} and "
                             f"opens {cold} cold, the plan "
                             f"{cm.plan_counts()}")
    err_max, worst = 0.0, {}
    for buf in g.buffers:
        sl = int(sched.buf_slot[buf.id])
        gv = got[:, sl, :, :buf.width].float()
        wv = want[:, sl, :, :buf.width].float()
        err = (gv - wv).abs().max().item()
        atol = mega_atol(wv)
        if not bool(torch.isfinite(gv).all()) or not err <= atol:
            raise AssertionError(f"mega branch output {buf.name} (world "
                                 f"{world}, paged {paged}): err {err}, atol "
                                 f"{atol}")
        err_max = max(err_max, err)
        worst[buf.name] = round(err / atol, 3)
    log(f"  mega branches, Qwen3-8B widths at world {world}, "
        f"{'paged 64' if paged else 'dense'} KV, bf16, arena depth "
        f"{cm.pf_depth} ({fed} fed, {cold} cold, as planned): max_abs_err="
        f"{err_max:.3e}; err / atol per output {worst}")
    return err_max


def mega_work(mega, pos):
    """(bytes, operations) one mega launch must move and do, over all
    ranks: every weight of the stack read once, each sequence's cached KV
    prefix (pos[b] positions of every layer and kv head), the norm rows,
    the input rows and the workspace rows it writes (the k/v rows, the
    final hidden); the products' 2 * B * weight elements and the
    attention's 4 * B * q heads * (pos + 1) * D a layer. And the bytes
    the whole step adds around it: the embed rows, the lm_head, the f32
    logits."""
    cfg = mega.cfg
    L, h, d = cfg.num_layers, cfg.hidden_size, cfg.head_dim
    isz = cfg.torch_dtype.itemsize
    b, n = mega.batch, mega.world
    w = sum(t.numel() for t in mega._weights.values())
    live = int(pos.sum())
    kv = 2 * L * cfg.num_kv_heads * live * d
    rows = n * b * h + 2 * L * b * cfg.num_kv_heads * d + n * b * h
    nbytes = (w + kv + rows) * isz + mega._norms.numel() * 4
    ops = 2 * b * w + 4 * L * cfg.num_q_heads * (live + b) * d
    around = (b * h + h * cfg.vocab_size) * isz + b * cfg.vocab_size * 4
    return nbytes, ops, around


def mega_decode_timing(mega, tok, cache, length0, steps=MEGA_STEPS):
    """ms a token of `steps` greedy decode steps from `cache` with its
    length reset in place to length0 (so a captured step is replayed,
    not captured again), on CUDA events and on the host clock (the
    second of two runs)."""
    import torch

    for _ in range(2):
        tok_ = tok
        cache.length.copy_(length0)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(steps):
            logits, cache = mega.decode_step(tok_, cache)
            tok_ = logits.argmax(-1)
        e.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / steps
    return a.elapsed_time(e) / steps, host


def check_graph_mega(mega, tok, start, label, steps=G_STEPS):
    """MegaQwen3's captured step against its eager step from one cache:
    decode_step's logits, `steps` tokens of decode_resident and the
    cache bitwise; ms/token each way (host clock; the replay after its
    capture), capture s, pool bytes, device kernels a step."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    res = {}
    for graphed in (False, True):
        mega.cuda_graph = graphed
        c = _clone_cache(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, c = mega.decode_step(tok, c)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, c = mega.decode_resident(first.argmax(-1), c, steps)
        torch.cuda.synchronize()
        res[graphed] = (first, ids, c, (time.perf_counter() - t0) * 1e3
                        / steps, first_s)
    mega.cuda_graph = True
    (fe, ie, ce, eager_ms, _), (fg, ig, cg, replay_ms, first_s) = (
        res[False], res[True])
    if not (torch.equal(fe, fg) and torch.equal(ie, ig)
            and all(torch.equal(a, b) for a, b in zip(ce, cg))):
        raise AssertionError(f"{label}: the replayed megakernel step differs "
                             "from the eager step")
    g = mega._graph(cg, tok)
    mega.cuda_graph = False
    eager_k = kernels_a_call(lambda: mega.decode_step(tok, ce))
    mega.cuda_graph = True
    replay_k = kernels_a_call(lambda: g.replay())
    row = dict(eager_ms=eager_ms, replay_ms=replay_ms, first_call_s=first_s,
               device_kernels_eager=eager_k, device_kernels_replay=replay_k,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               **graph_row(g))
    log(f"  4g {label}: eager {eager_ms:.3f} ms/token, replay "
        f"{replay_ms:.3f} ms/token (decode_resident); capture "
        f"{g.capture_s:.3f} s, graph pool {g.pool_bytes / 1e6:.1f} MB, device "
        f"kernels a step {eager_k} eager / {replay_k} replayed; peak "
        f"{row['peak_gb']:.2f} GB; logits, {steps} tokens and the cache "
        "bitwise the eager step's")
    return row


def run_mega(kernels, cfg, params, world, prefill_mode="ar", device="cuda"):
    """The fifth path at `world`: the Engine's 4 x 128 prefill
    (`prefill_mode`), then MEGA_STEPS greedy decode steps of MegaQwen3,
    one mega launch a step, launches counted from 0 around both; the
    first step's kernel inputs recorded. Then the kernel against
    run_plain on them (and the logits against the one-ulp band), the
    eager Engine's greedy decode of the same prefill beside it, and the
    timing. Returns (launches, numbers)."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.mega import kernel as mk
    from triton_dist_tpu_torch.models import Engine, MegaKVCache, MegaQwen3

    L = cfg.num_layers
    eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                 world=world, prefill_mode=prefill_mode, decode_mode="ar")
    mega = MegaQwen3(cfg, world=world, batch=4, s_max=MAX_LEN,
                     params=params, device=device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 128))
    real = mega.cm.run
    rec = []

    def record(*a):
        if not rec:
            rec.append([x.clone() if isinstance(x, torch.Tensor) else x
                        for x in a])
        return real(*a)

    mega.cm.run = record
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(prompts)
    mc = MegaKVCache.from_dense(cache, s_max=MAX_LEN)
    tok0 = tok = logits.argmax(-1)
    toks, first = [], None
    for _ in range(MEGA_STEPS):
        lm, mc = mega.decode_step(tok, mc)
        first = lm if first is None else first
        tok = lm.argmax(-1)
        toks.append(tok)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched = kernels.launches()
    mega.cm.run = real
    want = {name: 0 for name in kernel_names()}
    # the steps replay one captured graph: MEGA_STEPS launches, and one
    # more in the capture's warm-up
    assert mega.graphs.made == 1
    want.update(flash_prefill_local=L, mega=MEGA_STEPS + mega.graphs.made)
    if world > 1 and prefill_mode == "dist":
        want.update(ag_gemm=2 * L, gemm_rs=2 * L)
    elif world > 1:
        want.update(gemm_rs=2 * L, ring_all_gather=2 * L)
    assert launched == want, (launched, want)
    # the fed / cold matmul rows of the queue the kernel read: the plan's
    fed, cold = mega.cm.queue_counts(
        mega.cm.queue_on(mega.device).cpu().numpy())
    plan_fed, plan_cold = mega.cm.plan_counts()
    n_mega = launched["mega"]
    if (fed, cold) != (plan_fed, plan_cold):
        raise AssertionError(f"mega world {world}: the queue feeds {fed} "
                             f"and opens {cold} matmul rows cold; the plan "
                             f"feeds {plan_fed} and opens {plan_cold}")
    log(f"  mega world {world}: arena depth {mega.cm.pf_depth}, gate|up "
        f"tile-major at {mega.cm.tiled['w_gate_up']} columns; each of "
        f"{n_mega} launches fed {plan_fed} matmul rows from the arena and "
        f"opened {plan_cold} cold, as planned")
    mega_toks = torch.stack(toks, 1)
    assert bool(torch.isfinite(first).all()) and first.shape == (
        4, cfg.vocab_size)
    assert int(mega_toks.min()) >= 0 and int(mega_toks.max()) < cfg.vocab_size

    # the eager Engine's greedy decode of the same prefill
    eng.cuda_graph = False
    e_toks, e_first, tok = [], None, tok0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MEGA_STEPS):
        le, cache = eng.decode_step(tok, cache)
        e_first = le if e_first is None else e_first
        tok = le.argmax(-1)
        e_toks.append(tok)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / MEGA_STEPS
    agree = (mega_toks == torch.stack(e_toks, 1)).float().mean().item()
    rel_eager = ((first - e_first).norm() / e_first.norm()).item()

    # the kernel against run_plain on the recorded step, and the band
    pos, table, ws, weights, norms, rope, kp, vp = rec[0]
    ws_k = real(pos, table, ws.clone(), weights, norms, rope, kp, vp)
    ws_p = mega.cm.run_plain(pos, table, ws.clone(), weights, norms, rope,
                             kp, vp)
    torch.cuda.synchronize()
    err_ws = (ws_k.float() - ws_p.float()).abs().max().item()
    mag = ws_p.float().abs().max().item()
    fin = mega._final_slot  # the final rms-normed hidden rows
    err = (ws_k[:, fin].float() - ws_p[:, fin].float()).abs().max().item()
    lk, lp = mega.logits_from(ws_k), mega.logits_from(ws_p)
    attention = mk._PLAIN["attention"]
    noise = torch.Generator(device=device).manual_seed(1)

    def perturbed(cm, row, *a):  # the attention output one ulp off
        attention(cm, row, *a)
        out = a[2][:, int(row[3]), :, :int(row[8]) * int(row[10])]
        sign = torch.randint(0, 2, out.shape, generator=noise,
                             device=out.device) * 2 - 1
        out.copy_((out.float() * (1 + sign * 2.0 ** -8)).to(out.dtype))

    mk._PLAIN["attention"] = perturbed
    try:
        ws_f = mega.cm.run_plain(pos, table, ws.clone(), weights, norms,
                                 rope, kp, vp)
    finally:
        mk._PLAIN["attention"] = attention
    lf = mega.logits_from(ws_f)
    rel = ((lk - lp).norm() / lp.norm()).item()
    floor = ((lf - lp).norm() / lp.norm()).item()
    log(f"  mega world {world}: Engine prefill ({prefill_mode}) 4x128 + "
        f"{MEGA_STEPS} MegaQwen3 steps in {serve_s:.3f} s, launches "
        f"{launched}; tokens {mega_toks[0, :8].tolist()}...")
    log(f"  mega step vs run_plain on the recorded inputs: max_abs_err "
        f"{err:.3e} on the final normed hidden, {err_ws:.3e} over the "
        f"workspace (largest value {mag:.3e}); logits relative L2 {rel:.4e} "
        f"(one-ulp perturbed plain: {floor:.4e}); against the eager "
        f"Engine's first step: relative L2 {rel_eager:.4e}, greedy tokens "
        f"agree {agree:.2f} over {MEGA_STEPS} steps")
    if not rel <= 2 * floor:
        raise AssertionError("mega logits drift more than twice the one-ulp "
                             "perturbation's")
    if not rel_eager <= MEGA_EAGER_REL_L2:
        raise AssertionError(f"mega logits {rel_eager:.3e} off the eager "
                             "Engine's")
    row_err, row_worst, row_op, row_band, row_out = check_mega_rows(
        mega.cm, pos, table, ws, weights, norms, rope, kp, vp)
    log(f"  mega rows teacher-forced on the recorded inputs: each of "
        f"{len(mega.cm.queue)} rows within two bf16 ulps of its outputs' "
        f"largest value, max_abs_err {row_err:.3e}, worst err / atol "
        f"{row_worst:.3f} ({row_op}); bf16 epsilon band (judged): "
        f"{row_out} outputs outside, worst ulp {row_band[0]} cos "
        f"{row_band[1]:.3e} ({row_band[2]})")

    # timing: the step, the launch, its bound, the plain walk
    start = MegaKVCache.from_dense(cache, s_max=MAX_LEN)
    graphs = check_graph_mega(mega, tok0, start,
                              f"mega world {world}, batch 4")
    length0 = start.length.clone()
    ev_ms, host_ms = mega_decode_timing(mega, tok0, start, length0)
    call = lambda: real(pos, table, ws, weights, norms, rope, kp, vp)  # noqa: E731
    call_ms = time_ms(call)
    dev_us = device_us(call, "mega_kernel")
    plain_ms = time_ms(lambda: mega.cm.run_plain(
        pos, table, ws.clone(), weights, norms, rope, kp, vp), iters=3,
        warmup=1)
    nbytes, ops, around = mega_work(mega, pos)
    bnd, by = bound_ms(ops, nbytes, "bfloat16")
    step_floor = (nbytes + around) / HBM_BYTES_PER_S * 1e3
    share = None if dev_us is None else bnd / (dev_us / 1e3)
    log(f"  mega world {world} timing: {ev_ms:.3f} ms/token (CUDA events), "
        f"{host_ms:.3f} ms/token (host clock); one launch {call_ms:.4f} ms "
        f"call, {dev_us} us device; bound {bnd:.4f} ms ({by}; "
        f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP), share "
        f"{share}; step floor with embed rows, lm_head, logits "
        f"{step_floor:.4f} ms; plain walk {plain_ms:.3f} ms; eager "
        f"Engine.decode_step {eager_ms:.3f} ms/token (host clock)")
    row = dict(ms=call_ms, device_us=dev_us, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by, library_ms=None,
               bound_share=share, gbytes=nbytes / 1e9, gflop=ops / 1e9,
               step_floor_ms=step_floor, decode_ms_events=ev_ms,
               decode_ms_host=host_ms, eager_decode_ms_host=eager_ms,
               max_abs_err=err, max_abs_err_workspace=err_ws,
               max_abs_err_rows=row_err, rows_err_over_atol=row_worst,
               rows_band_worst=row_band, rows_band_outside=row_out,
               workspace_max=mag, logits_rel_l2=rel, logits_rel_l2_ulp=floor,
               eager_rel_l2=rel_eager, eager_token_agree=agree,
               graphs=graphs,
               tile_cols={k[1]: v for k, v in mega.cm.mm_tiles.items()},
               blocks_per_rank=mega.cm.blocks, pf_depth=mega.cm.pf_depth,
               pf_fed=plan_fed, pf_cold=plan_cold)
    del eng, mega, cache, mc, start, rec, ws_k, ws_p, ws_f
    torch.cuda.empty_cache()
    return launched, row


def mega_batch1(cfg, params, context=512, device="cuda"):
    """MegaQwen3 at world 1, batch 1, from a cache holding `context`
    random positions: ms a token over MEGA_STEPS steps, beside the
    launch's bound at that context."""
    import torch

    from triton_dist_tpu_torch.models import MegaQwen3

    mega = MegaQwen3(cfg, world=1, batch=1, s_max=MAX_LEN, params=params,
                     device=device)
    cache = mega.new_cache()
    g = torch.Generator(device=device).manual_seed(5)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    cache.length.fill_(context)
    tok = torch.tensor([7], device=device)
    ev_ms, host_ms = mega_decode_timing(mega, tok, cache,
                                        torch.full_like(cache.length, context))
    nbytes, ops, _ = mega_work(mega, cache.length)
    bnd, _ = bound_ms(ops, nbytes, "bfloat16")
    log(f"  mega world 1, batch 1, context {context}: {ev_ms:.3f} ms/token "
        f"(CUDA events), {host_ms:.3f} ms/token (host clock); launch bound "
        f"{bnd:.4f} ms")
    del mega, cache
    torch.cuda.empty_cache()
    return dict(batch=1, context=context, decode_ms_events=ev_ms,
                decode_ms_host=host_ms, bound_ms=bnd)


# -- the sixth path: SP long-context attention at Qwen3-8B widths ---------

SP_WORLD = 4
SP_BATCH = 4
SP_S_LOC = 8192  # 4 x 8192 = 32768 positions, Qwen3-8B's native context
# a ragged batch, one row just under each shard boundary: rows 1-3 cross
# into the next rank's shard during the decode steps (at 6, 4 and 2),
# row 0 fills the cache to its last position
SP_KV_LEN = (32752, 24570, 16380, 8190)
SP_STEPS = 16
SP_SAMPLE = 64  # sampled query rows: a rank's first, last, around kv_len
SP_STRAGGLE_NS = 5_000_000
# the whole check of SP prefill against its plain version, 4 x 4096
SP_SMALL_S_LOC = 1024
SP_SMALL_KV_LEN = (4080, 3070, 2044, 1022)


def torch_parity():
    """tests/torch_parity.py: the JAX package's epsilon bands, numpy
    only."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_parity

    return torch_parity


def band(want, got, kernel):
    """The epsilon band of `kernel` at want's dtype; raises outside it.
    Returns (cos, ulp)."""
    rep = torch_parity().check_epsilon(want.float().cpu().numpy(),
                                     got.float().cpu().numpy(), kernel,
                                     want.dtype)
    if not rep["ok"]:
        raise AssertionError(f"{kernel} outside its epsilon band: {rep}")
    return rep["cos"], rep["ulp"]


def sp_prefill_work(kv_len, n, s, hq, hkv, d, item=2):
    """(operations, bytes) of causal SP prefill over n*s positions: 4*D a
    live (query head, key) pair, where a query at p sees min(kv_len, p+1)
    keys (rows past kv_len attend the keys below it); q read and the
    output written once, each needed K/V row read once."""
    tot = n * s
    live = sum(l * (l + 1) // 2 + l * (tot - l) if l <= tot
               else tot * (tot + 1) // 2 for l in kv_len)
    b = len(kv_len)
    nbytes = (2 * b * tot * hq * d * item
              + sum(min(l, tot) for l in kv_len) * 2 * hkv * d * item)
    return 4 * hq * d * live, nbytes


def sp_prefill_layer(fp, x, sp, cos, sin, kv_len, hq, hkv, d):
    """The SP prefill of one Qwen3 attention layer on the virtual world:
    QKV product, q/k-norm, rope at each rank's positions, SP flash
    prefill, O product. x (n, B, S, H). Returns (y, q, k, v, att)."""
    import torch

    from triton_dist_tpu_torch.layers import apply_rope, rms_norm

    n, b, s, _ = x.shape
    qkv = torch.matmul(x, sp.w_qkv)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q = rms_norm(q.reshape(n, b, s, hq, d), sp.q_norm)
    k = rms_norm(k.reshape(n, b, s, hkv, d), sp.k_norm)
    v = v.reshape(n, b, s, hkv, d).contiguous()
    pos = (torch.arange(n, device=x.device)[:, None] * s
           + torch.arange(s, device=x.device))[:, None].expand(n, b, s)
    q = apply_rope(q, cos, sin, pos)
    k = apply_rope(k, cos, sin, pos).contiguous()
    del qkv
    att = fp.sp_prefill_attention(q, k, v, kv_len=kv_len, impl="flash")
    y = torch.matmul(att.reshape(n, b, s, hq * d), sp.w_o)
    return y, q, k, v, att


def sp_sampled_rows(kv_len, n, s, b):
    """(n, B, 3 * SP_SAMPLE) global positions: each rank's first and last
    SP_SAMPLE rows, and SP_SAMPLE rows around each row's kv_len clamped
    into the rank's shard."""
    import torch

    rows = []
    for r in range(n):
        per_b = []
        for bi in range(b):
            mid = min(max(kv_len[bi] - SP_SAMPLE // 2, r * s),
                      (r + 1) * s - SP_SAMPLE)
            per_b.append(torch.cat([
                torch.arange(r * s, r * s + SP_SAMPLE),
                torch.arange((r + 1) * s - SP_SAMPLE, (r + 1) * s),
                torch.arange(mid, mid + SP_SAMPLE)]))
        rows.append(torch.stack(per_b))
    return torch.stack(rows).cuda()


def sp_check_prefill(fp, q, k, v, out, kv_len, label):
    """SP flash prefill against flash_prefill_ref: on the sampled rows of
    a long prefill (the dense logits of a whole one would not fit), or
    whole. Two bf16 ulps of the largest output and the flash_prefill
    epsilon band. Returns (max_abs_err, cos, ulp)."""
    import torch

    n, b, s = q.shape[:3]
    kl = torch.tensor(kv_len, device="cuda")
    if s > SP_SMALL_S_LOC:
        pos = sp_sampled_rows(kv_len, n, s, b)
        ri = torch.arange(n, device="cuda")[:, None, None]
        bi = torch.arange(b, device="cuda")[None, :, None]
        local = pos - ri * s
        want = fp.flash_prefill_ref(q[ri, bi, local], k, v, kv_len=kl,
                                    q_positions=pos)
        got = out[ri, bi, local]
    else:
        want = fp.flash_prefill_ref(q, k, v, kv_len=kl)
        got = out
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = 2 * 2.0 ** -7 * want.float().abs().max().item()
    cos, ulp = band(want, got, "flash_prefill")
    log(f"  sp_flash_prefill {label}: {tuple(got.shape[:3])} rows, "
        f"max_abs_err {err:.3e} (atol {atol:.3e}), band cos {cos:.3e} "
        f"ulp {ulp}")
    if not (bool(torch.isfinite(got).all()) and err <= atol):
        raise AssertionError(f"sp_flash_prefill {label}: err {err}")
    return err, cos, ulp


def sp_sdpa(q, k, v, kv_len):
    """One torch call computing SP prefill (a yardstick the port never
    makes): SDPA of every rank's queries (ranks folded into the batch)
    over the gathered K/V, each kv head repeated for its query heads, a
    boolean mask of the live (query, key) pairs."""
    import torch
    import torch.nn.functional as F

    n, b, s, hq, d = q.shape
    hkv = k.shape[3]
    t = n * s
    kf = k.permute(1, 0, 2, 3, 4).reshape(b, t, hkv, d)
    vf = v.permute(1, 0, 2, 3, 4).reshape(b, t, hkv, d)

    def heads(x):
        x = x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        return x[None].expand(n, *x.shape).reshape(n * b, hq, t, d)

    kk, vv = heads(kf), heads(vf)
    qq = q.reshape(n * b, s, hq, d).transpose(1, 2)
    kpos = torch.arange(t, device="cuda")
    qpos = (torch.arange(n, device="cuda")[:, None] * s
            + torch.arange(s, device="cuda"))  # (n, S)
    kl = torch.tensor(kv_len, device="cuda")
    live = ((kpos[None, None, None] < kl[None, :, None, None])
            & (kpos[None, None, None] <= qpos[:, None, :, None]))
    mask = live.reshape(n * b, 1, s, t)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                  attn_mask=mask)


def sp_causal_sdpa(q, k, v):
    """Row 2's library time at the main path (a yardstick the port never
    calls): one scaled_dot_product_attention(is_causal=True) on the flash
    backend over the gathered (B, Hq, n S, D) queries, keys and values,
    each kv head repeated for its query heads. It attends every position
    causally and ignores kv_len, so its operation count (4 D a (query
    head, key) pair of the causal triangle) is given beside it. Returns
    library_ms (CUDA events), library_us (profiler, every kernel),
    library_gflop."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n, b, s, hq, d = q.shape
    g, t = hq // k.shape[3], n * s

    def gathered(x, rep):
        x = x.permute(1, 0, 2, 3, 4).reshape(b, t, x.shape[3], d)
        return x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()

    qq, kk, vv = gathered(q, 1), gathered(k, g), gathered(v, g)

    def call():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)

    out = dict(library_ms=time_ms(call, iters=3, warmup=1),
               library_us=device_us_total(call, reps=2),
               library_gflop=4 * d * hq * b * t * (t + 1) / 2 / 1e9)
    del qq, kk, vv
    torch.cuda.empty_cache()
    return out


def check_sp_pool(fp):
    """The SP kernel's persistent flag pools read zero after the phase's
    calls, and hold _sp_flag_words words a rank."""
    import torch

    torch.cuda.synchronize()
    for key, flags in fp._SP_POOLS.entries.items():
        assert flags.shape == (key[2], fp._sp_flag_words(key[2], key[3]))
        assert not bool(flags.any()), f"SP pool {key[2:]} left a flag set"
    log(f"  sp_flash_prefill: {fp._SP_POOLS.made} flag pools made, every "
        f"word at zero after the phase")


def sp_decode_library(q, k, v, valid):
    """One torch call computing the decode partial (a yardstick): the
    efficient-attention op with its log-sum-exp, kv heads repeated, a
    -inf bias past each row's valid length. Returns its (call ms, device
    µs); (None, None) where the op refuses the shapes (logged)."""
    import torch

    r, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qq = q[:, :, None]  # (R, Hq, 1, D)
    kk = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vv = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    kpos = torch.arange(t, device="cuda")
    bias = torch.where(kpos[None] < valid[:, None], 0.0, float("-inf")).to(
        q.dtype)[:, None, None].expand(r, hq, 1, t).contiguous()
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    def call():
        return efficient(qq, kk, vv, bias, True)

    try:
        return time_ms(call), device_us_total(call)
    except RuntimeError as e:  # a yardstick only: the port never calls it
        log(f"  decode partial library call refused: {e}")
        return None, None


def run_sp(kernels, cfg, params):
    """The sixth path, SP long-context attention at Qwen3-8B widths on the
    virtual world of 4: layer 0's attention weights of the world-1 draw
    (sp_params_from_dense), an SP prefill of 4 rows x 32768 positions
    (8192 a rank; kv_len SP_KV_LEN), whose K/V segments are the cache
    shards, then SP_STEPS decode steps threading one LL context
    (call_count 0..15); launches counted from 0 around both. Then each
    kernel against its plain version: the decode partial on every
    step's inputs (epsilon band), the LL AllGather bitwise over all its
    calls, each step's output bitwise the same step with the partials
    gathered by a torch copy; SP prefill on sampled rows and whole at 4 x
    4096 (band), and bitwise itself under a straggler on rank 0 and on
    rank 3. Then the timing. Returns (launches, rows, numbers)."""
    import torch

    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.kernels import flash_prefill as fp
    from triton_dist_tpu_torch.kernels import low_latency_allgather as llag
    from triton_dist_tpu_torch.layers import rope_table
    from triton_dist_tpu_torch.layers import sp_flash_decode as spl

    n, b, s = SP_WORLD, SP_BATCH, SP_S_LOC
    hq, hkv, d, h = (cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.hidden_size)
    t_max = n * s
    sp = spl.sp_params_from_dense(params, layer=0)
    spec = spl.SpDecodeSpec(hq, hkv, d)
    assert sp.w_qkv.shape == (h, (hq + 2 * hkv) * d)
    cos, sin = rope_table(d, t_max + SP_STEPS, cfg.rope_theta, device="cuda")
    x = rand((n, b, s, h), torch.bfloat16, 61)  # a rank's rows of each row
    xd = rand((SP_STEPS, b, h), torch.bfloat16, 62)
    kv_len = torch.tensor(SP_KV_LEN, device="cuda")
    # the prefill's kv_len as the kernel takes it (int32, made once, as
    # the model makes its positions once a step)
    kv32 = kv_len.to(torch.int32)
    rec_dec, rec_ll = [], []
    real_dec, real_ll = spl.sp_flash_decode, fd.ll_all_gather

    def dec(q, k, v, kl, **kw):
        res = real_dec(q, k, v, kl, **kw)
        rec_dec.append(dict(q=q.clone(), kv_len=kl.clone(),
                            out=res[0].clone()))
        return res

    def ll(xp, ctx, cc, **kw):
        got, ctx = real_ll(xp, ctx, cc, **kw)
        rec_ll.append(dict(x=xp.clone(), cc=cc.clone(), out=got.clone(),
                           data=ctx.data.clone(),
                           flags=ctx.flags[:, :2 * n].clone()))
        return got, ctx

    def sp_state(cache, lens):
        """A decode state: the cache shards, kv_len, a fresh LL context and
        its call count 0, on the card."""
        return (cache, lens, fd.create_sp_decode_buf(b, hq, d, n,
                                                     device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"))

    # the decode step captured before the counted window, on a scratch
    # state of the path's shapes (its first call is eager): the path's 16
    # steps are replays, bound to the path's own state
    step = spl.compiled_sp_decode_step()
    shard = (n, b, s, hkv, d)
    scratch = sp_state(tuple(torch.zeros(shard, dtype=torch.bfloat16,
                                         device="cuda") for _ in range(2)),
                       kv_len.clone())
    step(xd[0].expand(n, b, h), sp, spec, cos, sin, *scratch)
    torch.cuda.synchronize()
    g_sp = next(iter(step.graphs.graphs.values()))
    del scratch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    forms = dict(fp.sp_launches_by_body)
    fd_bodies = dict(fd.launches_by_body)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    y, q, k, v, att = sp_prefill_layer(fp, x, sp, cos, sin, kv32, hq,
                                       hkv, d)
    ev[1].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k0, v0 = k.clone(), v.clone()  # the eager twin's start
    cache, lens, ctx, count = sp_state((k, v), kv_len.clone())
    ys = [step(xd[i].expand(n, b, h), sp, spec, cos, sin, cache, lens, ctx,
               count) for i in range(SP_STEPS)]
    ev[2].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launched = kernels.launches()
    fd_window = {k_: v_ - fd_bodies[k_]
                 for k_, v_ in fd.launches_by_body.items()}
    want = {name: 0 for name in kernel_names()}
    want.update(sp_flash_prefill=1, flash_decode_partial=SP_STEPS,
                ll_all_gather=SP_STEPS)
    assert launched == want, (launched, want)
    assert step.graphs.made == 1, "the path's state captured the step again"
    assert count.item() == SP_STEPS and torch.equal(lens, kv_len + SP_STEPS)
    # the same steps eager from the same state, each kernel call recorded:
    # bitwise the replays (outputs, cache, kv_len, count, LL context)
    spl.sp_flash_decode, fd.ll_all_gather = dec, ll
    try:
        e_cache, e_lens, e_ctx, e_count = sp_state((k0, v0), kv_len.clone())
        torch.cuda.synchronize()
        ev_e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev_e[0].record()
        ys_eager = [spl.sp_decode_step(xd[i].expand(n, b, h), sp, spec, cos,
                                       sin, e_cache, e_lens, e_ctx, e_count)
                    for i in range(SP_STEPS)]
        ev_e[1].record()
        torch.cuda.synchronize()
    finally:
        spl.sp_flash_decode, fd.ll_all_gather = real_dec, real_ll
    if not (all(torch.equal(a, b_) for a, b_ in zip(ys, ys_eager))
            and all(torch.equal(a, b_) for a, b_ in zip(
                (*cache, lens, count, ctx.data, ctx.flags),
                (*e_cache, e_lens, e_count, e_ctx.data, e_ctx.flags)))):
        raise AssertionError("SP decode: the replayed steps differ from the "
                             "eager steps")
    eager_ms = ev_e[0].elapsed_time(ev_e[1]) / SP_STEPS
    del e_cache, k0, v0
    # the main path's SP prefill ran the TMA + wgmma form, its decode
    # partial the Hopper (TMA + mma.sync) body
    assert fp.sp_launches_by_body["wgmma"] - forms["wgmma"] == 1 and \
        fp.sp_launches_by_body["mma"] == forms["mma"], (
            forms, fp.sp_launches_by_body)
    fd_body = fd._body_for(torch.bfloat16, d, hq // hkv)
    assert fd_window == {"fma": 0, "mma": 0, fd_body: SP_STEPS}, fd_window
    assert y.shape == (n, b, s, h) and bool(torch.isfinite(y).all())
    yd = torch.stack(ys)
    assert yd.shape == (SP_STEPS, n, b, h) and bool(torch.isfinite(yd).all())
    for rd in rec_dec:  # the combine of the same gathered bytes, a rank each
        assert torch.equal(rd["out"], rd["out"][:1].expand_as(rd["out"]))
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[1].elapsed_time(ev[2]) / SP_STEPS
    log(f"  SP prefill layer (QKV, q/k-norm, rope, sp_flash_prefill, O) "
        f"4 x {t_max}: {prefill_ms:.3f} ms (CUDA events), "
        f"{(t1 - t0) * 1e3:.3f} ms host; {SP_STEPS} SP decode steps (LL "
        f"context, the call count a device word), replays of the captured "
        f"step: {decode_ms:.3f} ms/step (CUDA events), "
        f"{(t2 - t1) * 1e3 / SP_STEPS:.3f} ms/step host; launches "
        f"{ {k: v for k, v in launched.items() if v} }; decode partial "
        f"body {fd_body}")
    log(f"  4g SP decode step: the {SP_STEPS} replays bitwise the same steps "
        f"eager (outputs, cache, kv_len, call count, LL context): eager "
        f"{eager_ms:.3f} ms/step, replayed {decode_ms:.3f} ms/step (CUDA "
        f"events, first run); capture {g_sp.capture_s:.3f} s, graph pool "
        f"{g_sp.pool_bytes / 1e6:.1f} MB, hand kernels a replay "
        f"{g_sp.launches}")

    # row 3 on every step's inputs; row 9 bitwise on every call; the
    # LL-exchanged step bitwise the torch-gathered one
    fd_err, fd_cos, fd_ulp = 0.0, 0.0, 0
    twin = llag.create_ll_ag_buffer(rec_ll[0]["x"].shape[1:], torch.float32,
                                    n, device="cuda")
    for i, (rd, rl) in enumerate(zip(rec_dec, rec_ll)):
        local = (rd["kv_len"][None] - torch.arange(n, device="cuda")[:, None]
                 * s).clamp(0, s).reshape(-1)
        qi = rd["q"].reshape(n * b, hq, d)
        kf, vf = (c.reshape(n * b, s, hkv, d) for c in cache)
        o, lse = fd.flash_decode_partial_cuda(qi, kf, vf, local)
        o_p, lse_p = fd.flash_decode_partial(qi, kf, vf, local)
        torch.cuda.synchronize()
        err = max((o - o_p).abs().max().item(),
                  (lse - lse_p).abs().max().item())
        c1, u1 = band(o_p, o, "flash_decode_partial")
        c2, u2 = band(lse_p, lse, "flash_decode_partial")
        if not err <= F32_ATOL:
            raise AssertionError(f"flash_decode_partial step {i}: {err}")
        fd_err, fd_cos = max(fd_err, err), max(fd_cos, c1, c2)
        fd_ulp = max(fd_ulp, u1, u2)
        want_ll = llag.ll_all_gather_plain(rl["x"], twin, rl["cc"])
        if not torch.equal(rl["out"], want_ll):
            raise AssertionError(f"ll_all_gather call {i}: not bitwise")
        if not (torch.equal(rl["data"], twin.data)
                and torch.equal(rl["flags"], twin.flags[:, :2 * n])):
            raise AssertionError(f"ll_all_gather call {i}: the context's "
                                 "slots or parity flags differ from the "
                                 "plain twin's")
        gathered = fd.sp_flash_decode(rd["q"], *cache, rd["kv_len"])
        if not torch.equal(rd["out"], gathered):
            raise AssertionError(f"SP decode step {i}: the LL exchange is "
                                 "not bitwise the torch-gathered one")
    log(f"  flash_decode_partial on the {SP_STEPS} recorded steps: max_abs_"
        f"err {fd_err:.3e} (atol {F32_ATOL:g}), band worst cos {fd_cos:.3e} "
        f"ulp {fd_ulp}; ll_all_gather {len(rec_ll)} calls bitwise its plain "
        f"version, the context's slots and parity flags bitwise a plain "
        f"twin's after each; every step bitwise the torch-gathered "
        f"exchange")

    # row 2: sampled rows, straggler bitwise, whole at 4 x 4096
    fp_err, fp_cos, fp_ulp = sp_check_prefill(
        fp, q, k, v, att, SP_KV_LEN, f"4 x {t_max}, sampled rows")
    for rank in (0, n - 1):
        late = fp.sp_flash_prefill(q, k, v, kv_len=kv32,
                                   straggler=(rank, SP_STRAGGLE_NS))
        torch.cuda.synchronize()
        if not torch.equal(late, att):
            raise AssertionError(f"sp_flash_prefill straggler on rank "
                                 f"{rank}: not bitwise")
        del late
    log(f"  sp_flash_prefill with rank 0, then rank {n - 1} delayed "
        f"{SP_STRAGGLE_NS / 1e6:g} ms: bitwise the undelayed output")
    ss = SP_SMALL_S_LOC
    qs_, ks_, vs_ = (rand((n, b, ss, hh, d), torch.bfloat16, 63 + i, 0.5)
                     for i, hh in enumerate((hq, hkv, hkv)))
    kls = torch.tensor(SP_SMALL_KV_LEN, device="cuda", dtype=torch.int32)
    assert fp._sp_plan(ss, hq, hkv, d, torch.bfloat16) == "wgmma"
    small = fp.sp_flash_prefill(qs_, ks_, vs_, kv_len=kls)
    e2, c2, u2 = sp_check_prefill(fp, qs_, ks_, vs_, small, SP_SMALL_KV_LEN,
                                  f"4 x {n * ss}, whole")
    fp_err, fp_cos, fp_ulp = max(fp_err, e2), max(fp_cos, c2), max(fp_ulp, u2)

    # the path again, warm (the first run pays the lazy loading of every
    # kernel it meets); the decode rewrites the same rows with the same
    # values, eager on the eager twin's context (call count host ints
    # from SP_STEPS), then replayed on the path's (its device count goes
    # on from SP_STEPS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    sp_prefill_layer(fp, x, sp, cos, sin, kv32, hq, hkv, d)
    ev[1].record()
    for i in range(SP_STEPS):
        spl.sp_decode_attn_fwd(xd[i].expand(n, b, h), sp, spec, cos, sin,
                               cache, kv_len + i, ll_buf=e_ctx,
                               call_count=SP_STEPS + i)
    ev[2].record()
    lens.copy_(kv_len)
    for i in range(SP_STEPS):
        step(xd[i].expand(n, b, h), sp, spec, cos, sin, cache, lens, ctx,
             count)
    ev[3].record()
    torch.cuda.synchronize()
    prefill_warm = ev[0].elapsed_time(ev[1])
    decode_warm = ev[1].elapsed_time(ev[2]) / SP_STEPS
    replay_warm = (ev[2].elapsed_time(ev[3])) / SP_STEPS
    log(f"  warm: SP prefill layer {prefill_warm:.3f} ms, SP decode "
        f"{decode_warm:.3f} ms/step eager, {replay_warm:.3f} ms/step "
        f"replayed (CUDA events)")

    # timing
    rows = {}
    ops, nbytes = sp_prefill_work(SP_SMALL_KV_LEN, n, ss, hq, hkv, d)
    lab_small = (f"4 x {n * ss} (S_loc {ss} a rank), B {b}, kv_len "
                 f"{list(SP_SMALL_KV_LEN)}, bf16")
    rows[lab_small] = time_collective(
        f"sp_flash_prefill {lab_small}",
        lambda: fp.sp_flash_prefill(qs_, ks_, vs_, kv_len=kls),
        lambda: fp.flash_prefill_ref(qs_, ks_, vs_, kv_len=kls),
        sp_sdpa(qs_, ks_, vs_, SP_SMALL_KV_LEN), ops, nbytes, torch.bfloat16,
        kernel_key="fp_sp_")
    ops, nbytes = sp_prefill_work(SP_KV_LEN, n, s, hq, hkv, d)
    bnd, by = bound_ms(ops, nbytes, "bfloat16")
    fn = lambda: fp.sp_flash_prefill(q, k, v, kv_len=kv32)  # noqa: E731
    big = dict(ms=time_ms(fn, iters=5, warmup=1),
               device_us=device_us(fn, "fp_sp_", reps=3),
               plain_ms=None, bound_ms=bnd, bound_by=by,
               gflop=ops / 1e9, mbytes=nbytes / 1e6)
    big.update(sp_causal_sdpa(q, k, v))
    lab_big = (f"main path: 4 x {t_max} (S_loc {s} a rank), B {b}, kv_len "
               f"{list(SP_KV_LEN)}, bf16 (plain: not measured, the dense "
               "logits do not fit; library: causal flash SDPA over every "
               "position, kv_len ignored)")
    rows[lab_big] = big
    log(f"  sp_flash_prefill {lab_big}: kernel {big['ms']:.4f} ms, device "
        f"{big['device_us']} us, bound {bnd:.4f} ms ({by}; "
        f"{ops / 1e12:.2f} TFLOP, {nbytes / 1e9:.3f} GB), share "
        f"{None if not big['device_us'] else bnd / (big['device_us'] / 1e3)}"
        f"; library {big['library_ms']} ms / {big['library_us']} us device "
        f"over {big['library_gflop'] / 1e3:.2f} TFLOP")
    check_sp_pool(fp)

    rd = rec_dec[-1]
    local = (rd["kv_len"][None] - torch.arange(n, device="cuda")[:, None]
             * s).clamp(0, s).reshape(-1)
    qi = rd["q"].reshape(n * b, hq, d)
    kf, vf = (c.reshape(n * b, s, hkv, d) for c in cache)
    valid = int(local.sum())
    lab_dec = (f"decode step {SP_STEPS - 1}: q {tuple(qi.shape)}, shards "
               f"{tuple(kf.shape)}, {valid} valid rows, bf16, {fd_body} "
               "body")
    fd_rows = {lab_dec: time_collective(
        f"flash_decode_partial {lab_dec}",
        lambda: fd.flash_decode_partial_cuda(qi, kf, vf, local),
        lambda: fd.flash_decode_partial(qi, kf, vf, local),
        None, 4 * hq * d * valid,
        valid * 2 * hkv * d * 2 + qi.numel() * 2 + n * b * hq * (d + 1) * 4,
        torch.bfloat16, kernel_key="fd_")}
    fd_rows[lab_dec]["body"] = fd_body
    fd_rows[lab_dec]["library_ms"], fd_rows[lab_dec]["library_us"] = (
        sp_decode_library(qi, kf, vf, local))
    log(f"  flash_decode_partial library (efficient attention with lse): "
        f"{fd_rows[lab_dec]['library_ms']} ms / "
        f"{fd_rows[lab_dec]['library_us']} us device")

    xp = rec_ll[-1]["x"]
    cc = [2 * SP_STEPS - 1]  # the eager twin's context's next call

    def ll_call():
        cc[0] += 1
        return llag.ll_all_gather(xp, e_ctx, cc[0])

    twin_cc = [SP_STEPS]

    def ll_plain():
        twin_cc[0] += 1
        return llag.ll_all_gather_plain(xp, twin, twin_cc[0])

    def ll_device_count():  # the path's context, its count a device word
        got = llag.ll_all_gather(xp, ctx, count)
        count.add_(1)
        return got

    lab_ll = (f"payload {tuple(xp.shape)} f32 ({xp[0].numel() * 4} bytes a "
              "rank), one context, calls past 16")
    ll_rows = {lab_ll: time_collective(
        f"ll_all_gather {lab_ll}", ll_call, ll_plain,
        lambda: xp[None].expand(n, *xp.shape).contiguous(), 0,
        (n + n * n) * xp[0].numel() * 4, torch.float32,
        kernel_key="ll_ag_kernel")}
    lab_dev = f"{lab_ll}, the call count a device word"
    ll_rows[lab_dev] = time_collective(
        f"ll_all_gather {lab_dev}", ll_device_count, ll_plain,
        lambda: xp[None].expand(n, *xp.shape).contiguous(), 0,
        (n + n * n) * xp[0].numel() * 4, torch.float32,
        kernel_key="ll_ag_kernel")
    numbers = dict(prefill_ms_events=prefill_ms,
                   prefill_ms_host=(t1 - t0) * 1e3,
                   decode_ms_per_step_events=decode_ms,
                   decode_ms_per_step_host=(t2 - t1) * 1e3 / SP_STEPS,
                   prefill_ms_warm=prefill_warm,
                   decode_ms_per_step_warm=decode_warm,
                   decode_ms_per_step_eager_first=eager_ms,
                   decode_ms_per_step_replayed_warm=replay_warm,
                   graph=graph_row(g_sp),
                   context=t_max, batch=b, kv_len=list(SP_KV_LEN),
                   steps=SP_STEPS)
    # the line's numbers: the shape where the plain version and the
    # library call run whole; the main path's kernel time is in `rows`
    errs = dict(sp_flash_prefill=(fp_err, fp_cos, fp_ulp, lab_small, rows),
                flash_decode_partial=(fd_err, fd_cos, fd_ulp, lab_dec,
                                      fd_rows),
                ll_all_gather=(0.0, 0.0, 0, lab_ll, ll_rows))
    del x, y, q, k, v, att, cache, ctx, twin, rec_dec, rec_ll, qs_, ks_, vs_
    del step, g_sp, e_ctx, lens, count
    torch.cuda.empty_cache()
    return launched, errs, numbers


# -- the seventh path: EP MoE at Qwen3-30B-A3B widths ---------------------

EP_WORLD = 4
EP_TOKENS = 128  # tokens a rank: the 4 x 128 prefill's 512
EP_CHUNKS = (1, 2, 4)
EP_STRAGGLE_NS = 5_000_000
EP_KERNELS = ("all_to_all", "all_to_all_chunked")
EP_FP8 = "float8_e4m3fn"  # the fp8 wire's payload_dtype (a torch dtype name)


class A2ARecorder:
    """Within the block, every call of the two A2A wrappers that the EP
    layer makes (through kernels/ep_a2a.py's names) keeps a copy of its
    inputs and of its outputs, to hold each launch against the plain
    version afterwards. Calls the wrapper, which counts the launch."""

    def __init__(self):
        from triton_dist_tpu_torch.kernels import ep_a2a

        self.mod = ep_a2a
        self.saved = {}
        self.records = []

    def _wrap(self, name, fn):
        def call(x, splits, **kw):
            out, out_sp = fn(x, splits, **kw)
            self.records.append(dict(
                name=name, x=x.clone(), splits=splits.clone(), kw=kw,
                out=out.clone(), out_splits=out_sp.clone()))
            return out, out_sp
        return call

    def __enter__(self):
        for name in EP_KERNELS:
            self.saved[name] = getattr(self.mod, name)
            setattr(self.mod, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


class FfnRecorder:
    """Within the block, every grouped_gemm call of the EP expert FFN
    (kernels/ep_a2a.py through the grouped_gemm module: gate|up and down,
    sizes a rank) keeps a copy of its inputs (the weight by reference)
    and runs as before."""

    def __init__(self):
        from triton_dist_tpu_torch.kernels import grouped_gemm as gg

        self.mod, self.fn = gg, gg.grouped_gemm
        self.records = []

    def __call__(self, x, w, sizes, out_dtype=None):
        self.records.append(dict(x=x.clone(), w=w, sizes=sizes.clone(),
                                 out_dtype=out_dtype))
        return self.fn(x, w, sizes, out_dtype)

    def __enter__(self):
        self.mod.grouped_gemm = self
        return self

    def __exit__(self, *exc):
        self.mod.grouped_gemm = self.fn


EP_GRAPHED = ("M128 sequential", "M128 overlap q4", "M1 sequential",
              "M1 overlap q1")


def check_graph_ep(ep, k, runs, outs, warm_ms):
    """Phase 4g for EP: ep_moe_fwd through graphs.compiled (weights
    static) at each of EP_GRAPHED's runs: its first call and a replay
    bitwise the eager layer's output and drops; ms a call replayed (CUDA
    events) beside the eager warm ms, capture s, pool bytes."""
    import torch

    from triton_dist_tpu_torch.layers.ep_moe import ep_moe_fwd
    from triton_dist_tpu_torch.runtime.graphs import compiled

    layer = compiled(ep_moe_fwd, static=("params",), size=len(EP_GRAPHED))
    rows = {}
    for label in EP_GRAPHED:
        kw = dict(runs[label])
        x = kw.pop("x")

        def call():
            return layer(x, ep, k, return_drops=True, **kw)

        got = [call() for _ in range(2)]
        torch.cuda.synchronize()
        y, drops = outs[label]
        if not all(torch.equal(a, y) and torch.equal(d, drops)
                   for a, d in got):
            raise AssertionError(f"ep {label}: the replayed layer differs "
                                 "from the eager one")
        g = next(reversed(layer.graphs.graphs.values()))
        rows[label] = dict(eager_ms=warm_ms[label],
                           replay_ms=time_ms(call, iters=5, warmup=1),
                           **graph_row(g))
        log(f"  4g ep layer {label} as one graph: bitwise the eager layer; "
            f"eager {warm_ms[label]:.3f} ms, replayed "
            f"{rows[label]['replay_ms']:.3f} ms (CUDA events, warm); "
            f"capture {g.capture_s:.3f} s, graph pool "
            f"{g.pool_bytes / 1e6:.1f} MB, hand kernels a replay "
            f"{g.launches}")
    assert layer.graphs.made == len(EP_GRAPHED)
    del layer
    return rows


def host_syncs(fn) -> int:
    """Host syncs of one call of fn: the synchronizing CUDA operations
    that torch.cuda's sync debug mode reports (not its once-a-process
    notice that the mode is a prototype)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def ep_a2a_row(kernels, label, x, sp, chunked, q=1):
    """One A2A kernel timed at x, beside its plain version, the library
    yardstick (x.transpose(0, 1).contiguous(), the splits likewise) and
    its bound: each segment and splits row read once and written once."""
    import torch

    from triton_dist_tpu_torch.kernels.all_to_all import (
        all_to_all,
        all_to_all_chunked,
    )

    if chunked:
        fn = lambda: all_to_all_chunked(x, sp, n_chunks=q)  # noqa: E731
    else:
        fn = lambda: all_to_all(x, sp)  # noqa: E731
    nbytes = 2 * (x.numel() * x.element_size() + sp.numel() * 4)
    row = time_collective(
        label, fn, lambda: kernels.all_to_all_plain(x, sp),
        lambda: (x.transpose(0, 1).contiguous(),
                 sp.transpose(0, 1).contiguous()),
        0, nbytes, torch.bfloat16,
        kernel_key="a2a_chunked_kernel" if chunked else "a2a_kernel")
    host = a2a_host_parts(kernels, x, sp, q if chunked else None)
    row["host_us"] = host
    dev = row["device_us"]
    row["bound_share"] = None if not dev else row["bound_ms"] * 1e3 / dev
    parts = ", ".join(f"{k} {v:.1f}" for k, v in host.items() if k != "call")
    log(f"  {label}: host {host['call']:.1f} us a call ({parts}); bound "
        f"share {row['bound_share']}")
    return row


def run_ep(kernels, cfg, params, device="cuda"):
    """The seventh path: ep_moe_fwd on layer 0 of the Qwen3-30B-A3B draw
    at world 4, re-laid by ep_params_from_tp (32 whole experts a rank),
    on tokens from seed 0 (the layer's post-attention norm of embedded
    random ids): M = 128 a rank sequential and overlap at n_chunks 1, 2,
    4 (capacity 1024, lossless); M = 1 sequential and overlap at 1; a
    tight capacity of 256 at M = 128, sequential and overlap at 2 (drops
    nonzero). Launches counted from 0 around these runs, each A2A call
    recorded, and each grouped_gemm call of the expert FFN. Then: each
    recorded launch bitwise its plain version; each recorded FFN product
    against grouped_gemm_plain on the same inputs; every run bitwise the
    same layer over the plain transports; sequential and overlap inside
    the bf16 band of each other, drops equal (and equal the plain
    composition's); EP against the TP-MoE `dist` block on the same layer
    and tokens (f32 judged by the f32 band; the bf16 EP output against
    the f32 TP output judged by the band's cosine, its ulp measured; bf16
    against bf16 measured); the chunked kernel with rank 0, then rank 3,
    delayed 5 ms, bitwise; 50 back-to-back calls over every recorded
    (kernel, q, shape, dtype) in turn, bitwise, leaving the flag pools
    at zero with no pool made by a warm call (check_a2a_pools).
    Timing: the layer's ms (first run and warm), rows 12 and 13 (with
    the wrappers' host µs by part), host syncs a call, peak GB. Returns
    (launches, errs, numbers)."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels.all_to_all import all_to_all_chunked
    from triton_dist_tpu_torch.layers import rms_norm
    from triton_dist_tpu_torch.layers.ep_moe import (
        ep_moe_fwd,
        ep_params_from_tp,
    )
    from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd
    from triton_dist_tpu_torch.runtime import VirtualWorld

    n, k = EP_WORLD, cfg.num_experts_per_tok
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lp = params.layers.layer(0)
    tp = TPMoEParams(lp.w_router, lp.w_gate_up, lp.w_down)
    ep = ep_params_from_tp(tp)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (n, EP_TOKENS))
    ids = torch.as_tensor(ids, device=device)
    x = rms_norm(params.embed[ids], lp.post_attn_ln, cfg.rms_eps)
    x1 = x[:, :1].contiguous()
    tight = EP_TOKENS * k // n
    runs = {"M128 sequential": dict(x=x),
            **{f"M128 overlap q{q}": dict(x=x, overlap=True, n_chunks=q)
               for q in EP_CHUNKS},
            "M1 sequential": dict(x=x1),
            "M1 overlap q1": dict(x=x1, overlap=True, n_chunks=1),
            f"M128 capacity {tight} sequential": dict(x=x, capacity=tight),
            f"M128 capacity {tight} overlap q2": dict(
                x=x, capacity=tight, overlap=True, n_chunks=2),
            "M128 fp8 sequential": dict(x=x, payload_dtype=EP_FP8),
            "M128 fp8 overlap q2": dict(x=x, overlap=True, n_chunks=2,
                                        payload_dtype=EP_FP8)}

    def layer(kw, **extra):
        kw = dict(kw, **extra)
        if "payload_dtype" in kw:
            kw["payload_dtype"] = getattr(torch, kw["payload_dtype"])
        return ep_moe_fwd(kw.pop("x"), ep, k, return_drops=True, **kw)

    outs, first_ms = {}, {}
    kernels.reset_launches()
    torch.cuda.synchronize()
    with A2ARecorder() as rec, FfnRecorder() as ffn:
        for label, kw in runs.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            outs[label] = layer(kw)
            b.record()
            b.synchronize()
            first_ms[label] = a.elapsed_time(b)
    launched = kernels.launches()
    seq = [lab for lab, kw in runs.items() if not kw.get("overlap")]
    want = {name: 0 for name in kernel_names()}
    # the expert FFN: gate|up and down, once a sequential run, once a
    # (chunk, source rank) of a chunked one
    ffn_calls = sum(2 * kw["n_chunks"] * n if kw.get("overlap") else 2
                    for kw in runs.values())
    want.update(all_to_all=2 * len(seq),
                all_to_all_chunked=2 * (len(runs) - len(seq)),
                grouped_gemm_f32=ffn_calls)
    assert launched == want, (launched, want)
    assert len(ffn.records) == ffn_calls, (len(ffn.records), ffn_calls)
    for label, (y, drops) in outs.items():
        x_in = runs[label]["x"]
        assert y.shape == x_in.shape and y.dtype == x_in.dtype, label
        assert bool(torch.isfinite(y).all()), label

    # each A2A launch of the window against its plain version
    a2a_err = {name: 0.0 for name in EP_KERNELS}
    for r in rec.records:
        want_out, want_sp = kernels.all_to_all_plain(r["x"], r["splits"])
        err = max((r["out"].float() - want_out.float()).abs().max().item(),
                  (r["out_splits"] - want_sp).abs().max().item())
        a2a_err[r["name"]] = max(a2a_err[r["name"]], err)
        if not (torch.equal(r["out"], want_out)
                and torch.equal(r["out_splits"], want_sp)):
            raise AssertionError(f"{r['name']} {tuple(r['x'].shape)} "
                                 f"{r['kw']}: not bitwise its plain "
                                 f"version, max abs err {err}")
    shapes = sorted({(r["name"], tuple(r["x"].shape), str(r["x"].dtype))
                     for r in rec.records})
    log(f"  ep: {len(rec.records)} recorded A2A launches bitwise their "
        f"plain version (max abs err {a2a_err}): {shapes}")

    # each product of the expert FFN (grouped_gemm_f32) against the loop
    # over experts, and each shape's timing beside the padded bmm
    ffn_rows, _, ffn_err = time_grouped_f32(ffn.records, prefix="ep ",
                                            main_rows=None)
    shapes = sorted({(tuple(r["x"].shape), tuple(r["w"].shape),
                      str(r["out_dtype"])) for r in ffn.records})
    log(f"  ep: {len(ffn.records)} recorded expert-FFN grouped_gemm calls "
        f"(sizes a rank, each a grouped_gemm_f32 launch) within "
        f"grouped_gemm_atol of grouped_gemm_plain: max_abs_err="
        f"{ffn_err:.3e}; (x, w, out dtype) {shapes}")
    del ffn

    # (a) the same layer over the plain transports, bitwise
    for label, kw in runs.items():
        y, drops = outs[label]
        others = ("plain", "ref") if kw.get("overlap") else ("ref",)
        for transport in others:
            y2, d2 = layer(kw, _transport=transport)
            if not (torch.equal(y, y2) and torch.equal(drops, d2)):
                raise AssertionError(f"ep {label}: not bitwise the "
                                     f"_transport={transport!r} run")
    log(f"  ep: every run bitwise the same layer over the plain transports "
        f"(sequential: 'ref'; overlap: 'plain' and 'ref')")

    # sequential against overlap: drops equal, outputs in the bf16 band
    bands = {}
    for label, kw in runs.items():
        if not kw.get("overlap"):
            continue
        ref_label = next(lab for lab, kw2 in runs.items()
                         if not kw2.get("overlap") and kw2["x"] is kw["x"]
                         and kw2.get("capacity") == kw.get("capacity")
                         and kw2.get("payload_dtype") == kw.get(
                             "payload_dtype"))
        (y_s, d_s), (y_o, d_o) = outs[ref_label], outs[label]
        if not torch.equal(d_s, d_o):
            raise AssertionError(f"ep drops {d_o.tolist()} ({label}) != "
                                 f"{d_s.tolist()} ({ref_label})")
        bands[label] = band(y_s, y_o, "ep_moe")
    # the fp8 wire against the bf16 wire: drops equal, drift in budget
    from triton_dist_tpu_torch import wire

    fp8_drift = {}
    for label in ("M128 fp8 sequential", "M128 fp8 overlap q2"):
        ref = "M128 sequential" if "sequential" in label else \
            "M128 overlap q2"
        if not torch.equal(outs[label][1], outs[ref][1]):
            raise AssertionError(f"ep {label}: drops differ from {ref}")
        fp8_drift[label] = wire_drift(f"ep {label}", outs[label][0],
                                      outs[ref][0])
    log(f"  ep: the fp8 wire against the bf16 wire, drift (cos, ulp): "
        f"{fp8_drift}")
    drops_tight = outs[f"M128 capacity {tight} sequential"][1]
    assert int(drops_tight.sum()) > 0, "the tight capacity dropped nothing"
    assert int(outs["M128 sequential"][1].sum()) == 0
    log(f"  ep: overlap against sequential, bf16 band (cos, ulp): {bands}; "
        f"drops at capacity {tight}: {drops_tight.tolist()}, equal in both "
        "paths and in the plain composition")

    # (b) against the TP-MoE dist block on the same layer and tokens
    world = VirtualWorld(n, device)
    tp_band = {}
    for label, xin in (("M128", x), ("M1", x1)):
        rep = torch_parity().check_epsilon(
            tp_moe_fwd(xin, tp, k, world, mode="dist").float().cpu().numpy(),
            outs[f"{label} sequential"][0].float().cpu().numpy(), "ep_moe",
            torch.bfloat16)
        tp_band[f"{label} bf16 (measured)"] = (rep["cos"], rep["ulp"])
    tp32 = TPMoEParams(*(w.float() for w in tp))
    ep32 = ep_params_from_tp(tp32)
    for label, xin in (("M128", x), ("M1", x1)):
        x32 = xin.float()
        y_tp32 = tp_moe_fwd(x32, tp32, k, world, mode="dist")
        tp_band[f"{label} f32 (judged)"] = band(
            y_tp32, ep_moe_fwd(x32, ep32, k), "ep_moe")
        # the bf16 main path against the f32 TP block: an independent
        # product of the same function; EP rounds the activation between
        # the products to bf16, so near-zero outputs keep no ulp bound
        rep = torch_parity().check_epsilon(
            y_tp32.cpu().numpy(),
            outs[f"{label} sequential"][0].float().cpu().numpy(), "ep_moe",
            torch.bfloat16)
        if not rep["cos"] <= rep["band_cos"]:
            raise AssertionError(f"ep {label} bf16 against TP-MoE dist in "
                                 f"f32: outside the bf16 cosine band {rep}")
        tp_band[f"{label} bf16 vs f32 TP (cos judged)"] = (rep["cos"],
                                                           rep["ulp"])
    del tp32, ep32, y_tp32
    torch.cuda.empty_cache()
    log(f"  ep against TP-MoE dist, same layer and tokens (cos, ulp): "
        f"{tp_band}")

    # the chunked kernel with a straggler, on the main path's dispatch
    disp = next(r for r in rec.records if r["name"] == "all_to_all_chunked"
                and r["x"].shape[2] == EP_TOKENS * k)
    want_out, want_sp = kernels.all_to_all_plain(disp["x"], disp["splits"])
    for rank in (0, n - 1):
        got, got_sp = all_to_all_chunked(disp["x"], disp["splits"],
                                         n_chunks=4,
                                         straggler=(rank, EP_STRAGGLE_NS))
        torch.cuda.synchronize()
        if not (torch.equal(got, want_out) and torch.equal(got_sp, want_sp)):
            raise AssertionError(f"all_to_all_chunked with rank {rank} "
                                 "delayed: not bitwise")
    log(f"  ep: all_to_all_chunked q4 at {tuple(disp['x'].shape)} with rank "
        f"0, then rank {n - 1}, delayed {EP_STRAGGLE_NS / 1e6:.0f} ms: "
        "bitwise")

    # the persistent flag pools: both kernels, every q and shape in turn
    cases, seen = [], set()
    for r in rec.records:
        q = r["kw"].get("n_chunks") if r["name"] == "all_to_all_chunked" \
            else None
        key = (q, tuple(r["x"].shape), r["x"].dtype)
        if key not in seen:
            seen.add(key)
            cases.append((r["x"], r["splits"], q))
    pool_bytes = check_a2a_pools(kernels, cases)

    # timing: the layer, host syncs, the two kernels
    warm_ms = {label: time_ms(lambda kw=kw: layer(kw), iters=5, warmup=1)
               for label, kw in runs.items()}
    ep_graphs = check_graph_ep(ep, k, runs, outs, warm_ms)
    syncs = {label: host_syncs(lambda kw=runs[label]: layer(kw))
             for label in ("M128 sequential", "M128 overlap q4",
                           "M1 sequential", "M1 overlap q1")}
    for label in runs:
        log(f"  ep layer {label}: first run {first_ms[label]:.3f} ms, warm "
            f"{warm_ms[label]:.3f} ms (CUDA events)")
    log(f"  ep host syncs a call: {syncs}")
    a2a_rows, chunk_rows = {}, {}
    for r in rec.records:  # each (kernel, shape, dtype, q) once
        x_r, q = r["x"], r["kw"].get("n_chunks", 1)
        what = "combine" if x_r.dtype == torch.float32 else "dispatch"
        label = f"{what} x {tuple(x_r.shape)} {str(x_r.dtype)[6:]}"
        if r["name"] == "all_to_all" and label not in a2a_rows:
            a2a_rows[label] = ep_a2a_row(kernels, f"all_to_all {label}",
                                         x_r, r["splits"], False)
        elif (r["name"] == "all_to_all_chunked"
              and f"{label} q{q}" not in chunk_rows):
            chunk_rows[f"{label} q{q}"] = ep_a2a_row(
                kernels, f"all_to_all_chunked {label} q{q}", x_r,
                r["splits"], True, q)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ep_gb = sum(w.numel() * w.element_size() for w in ep[1:]) / 1e9
    log(f"  ep peak {peak:.2f} GB beyond the {base / 1e9:.2f} GB held before "
        f"(the EP weights {ep_gb:.2f} GB)")
    main = next(iter(a2a_rows))  # the first launch: M128's dispatch
    numbers = dict(first_ms=first_ms, warm_ms=warm_ms, host_syncs=syncs,
                   graphs=ep_graphs,
                   peak_gb_beyond_weights=peak, bands_seq_overlap=bands,
                   ep_vs_tp_dist=tp_band,
                   drops_tight=drops_tight.tolist(), fp8_drift=fp8_drift,
                   max_abs_err=a2a_err, ffn_max_abs_err=ffn_err,
                   a2a_pool_bytes=pool_bytes, grouped_f32_rows=ffn_rows)
    errs = dict(all_to_all=(a2a_rows, main, a2a_err["all_to_all"]),
                all_to_all_chunked=(chunk_rows, f"{main} q4",
                                    a2a_err["all_to_all_chunked"]))
    del ep, x, x1, outs, rec, disp, want_out
    torch.cuda.empty_cache()
    return launched, errs, numbers


# -- the collective library and the PP transport (phases 3, 4p, 4c) ---------

PP_KERNELS = ("p2p_send", "ring_shift")
COLL_KERNELS = ("full_mesh_all_gather",)
P2P_STRAGGLE_NS = 5_000_000
PP_STAGES = 4  # 9 of Qwen3-8B's 36 layers a stage
PP_MICROBATCHES = 4
PP_TOKENS = 512  # a microbatch: one sequence of 512 tokens
COLL_WORLD = 4
# per-rank shards of phase 4c: (rows, width, dtype name, what it is)
COLL_SHAPES = (
    (4, 4096, "bfloat16", "decode hidden state, 32 KiB"),
    (128, 4096, "bfloat16", "1 MiB: Auto takes FullMesh"),
    (129, 4096, "bfloat16", "1 MiB + 1 row: Auto takes Ring1D"),
    (512, 4096, "bfloat16", "4 x 128 prefill, 4 MiB: AR TwoShot"),
    (64, 4096, "float32", "1 MiB f32"),
)
# the one-shot / two-shot AllReduce sweep: bytes a rank, rows of 512 bf16
AR_SWEEP_BYTES = tuple(4096 << i for i in range(7))  # 4 KiB .. 256 KiB
AR_SWEEP_WIDTH = 512
# each point is the median of this many rounds of 10 calls, one-shot and
# two-shot in turn: the calls are host-bound, and a host stall during one
# block of calls must not decide a point (one 20-call block read a
# one-shot call at 0.1309 ms against its usual 0.05-0.10; PERF.md)
AR_SWEEP_ROUNDS = 5


def payload(shape, dtype, seed):
    """Seeded values on the card; uint8 takes random bytes, so every bit
    pattern travels."""
    import torch

    if dtype == torch.uint8:
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                             generator=g)
    return rand(shape, dtype, seed, 2.0)


def check_bitwise(label, got, want):
    """Raises unless got is bitwise want; returns max |got - want|, taken
    in f64 (0 for an empty tensor)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: not bitwise its plain version")
    if got.numel() == 0:
        return 0.0
    return (got.double() - want.double()).abs().max().item()


def check_p2p_kernels(kernels):
    """The full-mesh AllGather, p2p_send (and p2p_read) and ring_shift
    against their plain versions on the card, bitwise, at n = 2 and 4,
    f32, bf16 and uint8: M = 1, ragged rows (3 x 1000, 5 x 7), odd byte
    counts (7 uint8), src = dst, shift in {1, -1, 3, n + 1}; each also
    with rank 0 delayed P2P_STRAGGLE_NS."""
    import torch

    late = (0, P2P_STRAGGLE_NS)
    for n in (2, 4):
        for dtype in (torch.float32, torch.bfloat16, torch.uint8):
            dn = str(dtype)[6:]
            for i, shape in enumerate(((1, 4096), (3, 1000), (5, 7),
                                       (1, 7))):
                x = payload((n, *shape), dtype, 100 * n + i)
                lab = f"n={n} {dn} {shape}"
                want = kernels.full_mesh_all_gather_plain(x)
                check_bitwise(f"full_mesh_all_gather {lab}",
                              kernels.full_mesh_all_gather(x), want)
                check_bitwise(f"full_mesh_all_gather {lab} straggler",
                              kernels.full_mesh_all_gather(x, straggler=late),
                              want)
                for src, dst in ((0, n - 1), (n - 1, 0), (1, 1)):
                    want = kernels.p2p_send_plain(x, src, dst)
                    check_bitwise(f"p2p_send {src}->{dst} {lab}",
                                  kernels.p2p_send(x, src, dst), want)
                    check_bitwise(f"p2p_read {dst}<-{src} {lab}",
                                  kernels.p2p_read(x, dst, src), want)
                check_bitwise(f"p2p_send straggler {lab}",
                              kernels.p2p_send(x, n - 1, 0, straggler=late),
                              kernels.p2p_send_plain(x, n - 1, 0))
                for shift in (1, -1, 3, n + 1):
                    want = kernels.ring_shift_plain(x, shift)
                    check_bitwise(f"ring_shift {shift} {lab}",
                                  kernels.ring_shift(x, shift), want)
                check_bitwise(f"ring_shift straggler {lab}",
                              kernels.ring_shift(x, 1, straggler=late),
                              kernels.ring_shift_plain(x, 1))
        log(f"  full_mesh_all_gather, p2p_send / p2p_read (src->dst (0, "
            f"{n - 1}), ({n - 1}, 0), (1, 1)), ring_shift (1, -1, 3, "
            f"{n + 1}) n={n}, f32 / bf16 / uint8, m x W in (1, 4096), "
            "(3, 1000), (5, 7), (1, 7), rank 0 delayed "
            f"{P2P_STRAGGLE_NS / 1e6:g} ms: bitwise")


def check_p2p_pools(kernels, act, calls=50):
    """p2p_send's persistent delivery pool: `calls` back-to-back calls on
    one stream, with no synchronisation between them, in turn over a
    ragged payload (70 bytes a rank), the PP handoff act (4 MiB a rank:
    the largest grid) and twice its rows (8 MiB, the grid capped), every
    (src, dst) pair in turn, every fifth call with one rank delayed
    P2P_STRAGGLE_NS (each rank in turn); then each result bitwise its
    plain version, every word of every pool at zero, and no call past the
    first made a pool. Returns {pool: bytes}."""
    import torch

    from triton_dist_tpu_torch.kernels import p2p

    n = act.shape[0]
    xs = [payload((n, 5, 7), torch.bfloat16, 300), act,
          torch.cat([act, act], 1)]
    pairs = [(src, dst) for src in range(n) for dst in range(n)]
    runs, made = [], None
    for i in range(calls):
        x = xs[i % len(xs)]
        src, dst = pairs[i % len(pairs)]
        late = (i // 5 % n, P2P_STRAGGLE_NS) if i % 5 == 4 else None
        runs.append((i, x, src, dst, late,
                     kernels.p2p_send(x, src, dst, straggler=late)))
        if i == 0:
            made = p2p._POOLS.made
    for i, x, src, dst, late, got in runs:
        check_bitwise(f"p2p_send call {i} {tuple(x.shape)} {src}->{dst} "
                      f"straggler {late}", got,
                      kernels.p2p_send_plain(x, src, dst))
    assert p2p._POOLS.made == made, "a warm p2p_send made a pool"
    zero = all(not bool(f.any()) for f in p2p._POOLS.entries.values())
    assert zero, "p2p_send left a delivery word set"
    held = {f"n={k[2]}": f.numel() * 4 for k, f in p2p._POOLS.entries.items()}
    log(f"  p2p_send: {calls} calls back to back over "
        f"{[tuple(x.shape) for x in xs]}, every (src, dst), a straggler "
        f"every fifth call, bitwise; every pool word at zero; "
        f"{p2p._POOLS.made} pools made, none by a warm call; pool bytes "
        f"{held}")
    return held


class P2PRecorder:
    """Within the block, every ring_shift and p2p_send call made through
    kernels/p2p.py (the PP layer's route, and p2p_read's) is recorded
    with its input and output."""

    def __enter__(self):
        from triton_dist_tpu_torch.kernels import p2p

        self.mod, self.records = p2p, []
        self.real = {name: getattr(p2p, name) for name in PP_KERNELS}

        def wrap(name):
            real = self.real[name]

            def fn(x, *args, **kw):
                out = real(x, *args, **kw)
                kw.pop("straggler", None)
                self.records.append(dict(kernel=name, x=x.clone(),
                                         args=args, kw=kw, out=out.clone()))
                return out
            return fn

        for name in PP_KERNELS:
            setattr(p2p, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, name, fn)


def run_pp(kernels, cfg, params, device="cuda"):
    """Phase 4p, PP at Qwen3-8B full width: PP_STAGES virtual stages of
    9 of the 36 layers each (models.pp_stage_fn over the world-1 draw,
    dense.py's layer function with no KV cache), PP_MICROBATCHES
    microbatches of 1 x PP_TOKENS tokens embedded by the model. Launches
    counted from 0 around one pp_schedule_fwd (7 ring_shift launches),
    one send_backward and a p2p_send (stage 3 -> 0) and p2p_read on the
    output microbatches. Then: the PP output bitwise each microbatch run
    alone through the 36 layers; every ring_shift / p2p_send launch
    bitwise its plain version; ms a schedule on CUDA events (first and
    warm); the two kernels' times on the handoff buffer. Returns
    (launches, rows, numbers)."""
    import torch

    from triton_dist_tpu_torch.kernels import p2p
    from triton_dist_tpu_torch.layers import PPCommOp, pp_schedule_fwd
    from triton_dist_tpu_torch.models import layers_fwd, pp_stage_fn

    n, nmb, s = PP_STAGES, PP_MICROBATCHES, PP_TOKENS
    L = cfg.num_layers
    g = torch.Generator(device=device).manual_seed(71)
    ids = torch.randint(0, cfg.vocab_size, (nmb, s), device=device,
                        generator=g)
    x = params.embed[ids]  # (microbatches, 512, 4096) bf16
    comm = PPCommOp(n)
    stage_fn = pp_stage_fn(cfg, params, n)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with P2PRecorder() as rec:
        kernels.reset_launches()
        torch.cuda.synchronize()
        ev[0].record()
        out = pp_schedule_fwd(comm, stage_fn, x.expand(n, *x.shape), nmb)
        ev[1].record()
        # rank r holds output microbatch r: distinct buffers to hand off
        act = out[0].contiguous()
        back = comm.send_backward(act)
        sent = p2p.p2p_send(act, n - 1, 0)
        read = p2p.p2p_read(act, 0, n - 1)
        torch.cuda.synchronize()
        launched = kernels.launches()
    first_ms = ev[0].elapsed_time(ev[1])
    want = {name: 0 for name in kernel_names()}
    want.update(flash_prefill_local=L * (nmb + n - 1), ring_shift=nmb + n,
                p2p_send=2)
    assert launched == want, (launched, want)
    assert out.shape == (n, nmb, s, cfg.hidden_size)
    assert bool(torch.isfinite(out).all())
    errs = {name: [] for name in PP_KERNELS}
    for r in rec.records:
        plain = (kernels.ring_shift_plain if r["kernel"] == "ring_shift"
                 else kernels.p2p_send_plain)
        errs[r["kernel"]].append(check_bitwise(
            f"{r['kernel']}{r['args']}{r['kw']} on the PP path", r["out"],
            plain(r["x"], *r["args"], **r["kw"])))
    assert torch.equal(back, torch.roll(act, -1, 0))
    assert torch.equal(sent[0], act[n - 1]) and torch.equal(sent, read)
    assert torch.equal(sent[1:], act[1:])
    log(f"  {len(rec.records)} ring_shift / p2p_send launches on the PP "
        "path: bitwise their plain versions; send_backward and p2p_send "
        "(3 -> 0), p2p_read: as expected")
    pool_bytes = check_p2p_pools(kernels, act)
    seq_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    seq_ev[0].record()
    alone = [layers_fwd(cfg, params, x[i], range(L)) for i in range(nmb)]
    seq_ev[1].record()
    torch.cuda.synchronize()
    for i in range(nmb):
        if not torch.equal(out[0, i], alone[i]):
            err = (out[0, i].float() - alone[i].float()).abs().max().item()
            raise AssertionError(f"PP output microbatch {i}: not bitwise the "
                                 f"sequential layers (max abs err {err})")
    warm_ms = time_ms(lambda: pp_schedule_fwd(
        comm, stage_fn, x.expand(n, *x.shape), nmb), iters=3, warmup=1)
    numbers = dict(stages=n, microbatches=nmb, tokens=s,
                   schedule_ms_first=first_ms, schedule_ms_warm=warm_ms,
                   sequential_ms=seq_ev[0].elapsed_time(seq_ev[1]),
                   ring_shift_launches=nmb + n - 1,
                   p2p_pool_bytes=pool_bytes)
    log(f"  PP schedule, {n} stages x {L // n} layers, {nmb} x 1 x {s} "
        f"tokens: bitwise the sequential {L} layers; {first_ms:.3f} ms "
        f"(warm {warm_ms:.3f}), the {nmb} microbatches alone "
        f"{numbers['sequential_ms']:.3f} ms")
    numbers["graph"] = check_graph_pp(cfg, params, comm, stage_fn,
                                      x.expand(n, *x.shape), nmb, out,
                                      warm_ms, alone)
    nbytes = act[0].numel() * act.element_size()
    label = f"PP handoff {tuple(act.shape)} bf16"
    rows = {"ring_shift": {label: time_collective(
        f"ring_shift {label}", lambda: kernels.ring_shift(act, 1),
        lambda: kernels.ring_shift_plain(act, 1),
        lambda: torch.roll(act, 1, 0), 0, 2 * n * nbytes, act.dtype,
        kernel_key="ring_shift_kernel")}}
    rows["p2p_send"] = {label: time_collective(
        f"p2p_send 3 -> 0 {label}", lambda: kernels.p2p_send(act, n - 1, 0),
        lambda: kernels.p2p_send_plain(act, n - 1, 0),
        lambda: act.clone()[0].copy_(act[n - 1]), 0,
        (2 * n - 1) * nbytes, act.dtype, kernel_key="p2p_kernel")}
    del out, act, back, sent, read, alone, rec
    torch.cuda.empty_cache()
    return launched, (rows, label, {k: max(v) for k, v in errs.items()}), \
        numbers


def check_graph_pp(cfg, params, comm, stage_fn, x, nmb, eager_out,
                   eager_ms, alone):
    """Phase 4g for PP: the whole schedule (every tick's stages and
    ring_shift) captured as one graph through graphs.compiled (comm and
    the stage function static); its first call and a replay bitwise the
    eager schedule's output; ms a schedule replayed (CUDA events) beside
    the eager one's, and against the microbatches alone through the same
    layers, eager and as one graph (bitwise `alone`), capture s, pool
    bytes, device kernels and zero fills of a replay (each ring_shift
    takes a fresh zeroed flag pool: its fill is recorded and
    replayed)."""
    import torch

    from triton_dist_tpu_torch.layers import pp_schedule_fwd
    from triton_dist_tpu_torch.models import layers_fwd
    from triton_dist_tpu_torch.runtime.graphs import compiled

    def microbatches_alone(weights, mbs):
        return [layers_fwd(cfg, weights, mbs[i], range(cfg.num_layers))
                for i in range(nmb)]

    one_by_one = compiled(microbatches_alone, static=("weights",))
    mbs = x[0]
    got = [one_by_one(params, mbs) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for run in got for a, b in zip(run, alone)):
        raise AssertionError("PP: the microbatches alone as one graph "
                             "differ from their eager run")
    del got
    alone_eager_ms = time_ms(lambda: microbatches_alone(params, mbs),
                             iters=3, warmup=1)
    alone_ms = time_ms(lambda: one_by_one(params, mbs), iters=3, warmup=1)
    del one_by_one
    sched = compiled(pp_schedule_fwd, static=("comm", "stage_fn"))
    outs = [sched(comm, stage_fn, x, nmb) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(o, eager_out) for o in outs):
        raise AssertionError("PP: the replayed schedule differs from the "
                             "eager one")
    assert sched.graphs.made == 1
    g = next(iter(sched.graphs.graphs.values()))
    del outs
    replay_ms = time_ms(lambda: sched(comm, stage_fn, x, nmb), iters=3,
                        warmup=1)
    replay_t = trace_a_call(lambda: sched(comm, stage_fn, x, nmb))
    row = dict(eager_ms=eager_ms, replay_ms=replay_ms,
               alone_eager_ms=alone_eager_ms, alone_replay_ms=alone_ms,
               ratio_eager=eager_ms / alone_eager_ms,
               ratio_replay=replay_ms / alone_ms,
               device_kernels_replay=replay_t["device_kernels"],
               memsets_replay=replay_t["memsets"],
               memset_us_replay=replay_t["memset_us"], **graph_row(g))
    log(f"  4g PP schedule as one graph: bitwise the eager schedule; eager "
        f"{eager_ms:.3f} ms, replayed {replay_ms:.3f} ms (CUDA events, "
        f"warm); the microbatches alone {alone_eager_ms:.3f} ms eager, "
        f"{alone_ms:.3f} ms as one graph (bitwise); schedule over alone "
        f"{row['ratio_eager']:.3f} eager, {row['ratio_replay']:.3f} "
        f"replayed; capture {g.capture_s:.3f} s, graph pool "
        f"{g.pool_bytes / 1e6:.1f} MB, device kernels a replay "
        f"{replay_t['device_kernels']} ({replay_t['memsets']} zero fills, "
        f"{replay_t['memset_us']:.1f} us), hand kernels a replay "
        f"{g.launches}")
    del sched, g
    return row


def coll_inputs():
    import torch

    return {f"({rows}, {w}) {dn}: {what}": rand(
        (COLL_WORLD, rows, w), getattr(torch, dn), 200 + i)
        for i, (rows, w, dn, what) in enumerate(COLL_SHAPES)}


def run_coll(kernels):
    """Phase 4c, the collective library at Qwen3-8B widths on the virtual
    world of 4, no weights: on each COLL_SHAPES shard, all_gather by
    every method and Auto, all_gather_op, all_reduce by OneShot, TwoShot
    (a leading dim divisible by 4), XLA and Auto, all_reduce_op, and
    reduce_scatter_op by Auto, Ring1D and XLA (divisible shapes),
    launches counted from 0 around them. Then: the gathers bitwise each
    other and the plain concatenation; each AllReduce bitwise its own
    plain fold (OneShot the rank-order fold, TwoShot the ring RS fold then
    the gather), Auto bitwise the method it took, and each against the
    XLA fold by the epsilon band (judged in f32, printed in bf16); the
    ReduceScatters bitwise their folds. Then the timing: full mesh
    against ring at each shape, and the one-shot / two-shot sweep at
    n = 2 and 4. Returns (launches, rows, main label, numbers)."""
    import torch

    AG, AR, RS = (kernels.AllGatherMethod, kernels.AllReduceMethod,
                  kernels.ReduceScatterMethod)
    n = COLL_WORLD
    xs = coll_inputs()
    outs, want = {}, {name: 0 for name in kernel_names()}

    def expect(name, k=1):
        want[name] += k

    kernels.reset_launches()
    torch.cuda.synchronize()
    for label, x in xs.items():
        rows = x.shape[1]
        chunk = x[0].numel() * x.element_size()
        auto = kernels.choose_allgather_method(chunk)
        for m in (AG.FullMesh, AG.Ring1D, AG.XLA, AG.Auto):
            outs[("ag", label, m)] = kernels.all_gather(x, method=m)
            route = auto if m == AG.Auto else m
            if route != AG.XLA:
                expect("full_mesh_all_gather" if route == AG.FullMesh
                       else "ring_all_gather")
        outs[("ag_op", label)] = kernels.all_gather_op(x)
        expect("full_mesh_all_gather" if auto == AG.FullMesh
               else "ring_all_gather")
        ar_auto = kernels.choose_allreduce_method(chunk, n,
                                                  divisible=rows % n == 0)
        methods = [AR.OneShot, AR.XLA, AR.Auto]
        if rows % n == 0:
            methods.insert(1, AR.TwoShot)
        for m in methods:
            outs[("ar", label, m)] = kernels.all_reduce(x, method=m)
        outs[("ar_op", label)] = kernels.all_reduce_op(x)
        # each method's call, Auto's and all_reduce_op's by ar_auto
        for route in [ar_auto if m == AR.Auto else m for m in methods] + [
                ar_auto]:
            if route == AR.OneShot:
                expect("one_shot_all_reduce")
            elif route == AR.TwoShot:
                expect("ring_reduce_scatter")
                expect("ring_all_gather")
        if rows % n == 0:
            for m in (RS.Auto, RS.Ring1D, RS.XLA):
                outs[("rs_op", label, m)] = kernels.reduce_scatter_op(
                    x, method=m)
            expect("ring_reduce_scatter", 2)
    torch.cuda.synchronize()
    launched = kernels.launches()
    assert launched == want, (launched, want)
    # Auto's pinned routes: 1 MiB a rank full mesh, a row more the ring;
    # the 4 MiB prefill two-shot
    routes = {label: dict(ag=kernels.choose_allgather_method(
        x[0].numel() * x.element_size()).value) for label, x in xs.items()}
    labels = list(xs)
    assert routes[labels[1]]["ag"] == "full_mesh"
    assert routes[labels[2]]["ag"] == "ring_1d"
    assert kernels.choose_allreduce_method(4 << 20, n) == AR.TwoShot

    bands, fm_errs = {}, []
    for label, x in xs.items():
        gathered = kernels.ring_all_gather_plain(x)
        full_mesh = routes[label]["ag"] == AG.FullMesh.value
        for m in (AG.FullMesh, AG.Ring1D, AG.XLA, AG.Auto):
            err = check_bitwise(f"all_gather {m.value} {label}",
                                outs[("ag", label, m)], gathered)
            if m == AG.FullMesh or (m == AG.Auto and full_mesh):
                fm_errs.append(err)
        err = check_bitwise(f"all_gather_op {label}", outs[("ag_op", label)],
                            gathered[0])
        if full_mesh:
            fm_errs.append(err)
        folds = {AR.OneShot: kernels.one_shot_all_reduce_plain(x),
                 AR.XLA: kernels.all_reduce_plain(x)}
        if x.shape[1] % n == 0:
            folds[AR.TwoShot] = kernels.ring_all_gather_plain(
                kernels.ring_reduce_scatter_plain(x))
        for m, fold in folds.items():
            check_bitwise(f"all_reduce {m.value} {label}",
                          outs[("ar", label, m)], fold)
        auto = outs[("ar", label, AR.Auto)]
        took = [m.value for m in folds if torch.equal(auto, folds[m])]
        assert took, f"all_reduce auto {label}: no method's result"
        routes[label]["ar"] = took
        check_bitwise(f"all_reduce_op {label}", outs[("ar_op", label)],
                      auto[0])
        for m in (AR.OneShot, AR.TwoShot):
            if m not in folds:
                continue
            rep = torch_parity().check_epsilon(
                folds[AR.XLA].float().cpu().numpy(),
                outs[("ar", label, m)].float().cpu().numpy(), "allreduce",
                x.dtype)
            bands[f"{m.value} {label}"] = (rep["cos"], rep["ulp"])
            if x.dtype == torch.float32 and not rep["ok"]:
                raise AssertionError(f"all_reduce {m.value} {label} outside "
                                     f"the f32 band of the XLA fold: {rep}")
            log(f"  all_reduce {m.value} {label} against the XLA fold: "
                f"cos={rep['cos']:.3e} ulp={rep['ulp']} (band "
                f"{rep['band_cos']:.0e}, {rep['band_ulp']}; "
                f"{'judged' if x.dtype == torch.float32 else 'printed'})")
        if x.shape[1] % n == 0:
            ring = kernels.ring_reduce_scatter_plain(x)
            check_bitwise(f"reduce_scatter_op ring {label}",
                          outs[("rs_op", label, RS.Ring1D)],
                          ring.reshape(-1, x.shape[2]))
            check_bitwise(f"reduce_scatter_op auto {label}",
                          outs[("rs_op", label, RS.Auto)],
                          ring.reshape(-1, x.shape[2]))
            check_bitwise(f"reduce_scatter_op xla {label}",
                          outs[("rs_op", label, RS.XLA)],
                          kernels.gemm_reduce_scatter.reduce_scatter_plain(
                              x).reshape(-1, x.shape[2]))
    del outs
    log(f"  all_gather (full_mesh, ring_1d, xla, auto), all_gather_op, "
        f"all_reduce (one_shot, two_shot, xla, auto), all_reduce_op, "
        f"reduce_scatter_op (auto, ring_1d, xla) on {len(xs)} shapes: "
        f"bitwise their folds; routes {routes}")

    fm_rows, ring_rows = {}, {}
    for label, x in xs.items():
        chunk = x[0].numel() * x.element_size()
        out = torch.empty((n, n * x.shape[1], x.shape[2]), dtype=x.dtype,
                          device=x.device)

        def library(x=x, out=out):
            full = x.reshape(1, -1, x.shape[2])
            return out.copy_(full.expand(out.shape))

        nbytes = n * chunk + n * n * chunk
        fm_rows[label] = time_collective(
            f"full_mesh_all_gather {label}",
            lambda x=x: kernels.full_mesh_all_gather(x),
            lambda x=x: kernels.full_mesh_all_gather_plain(x), library, 0,
            nbytes, x.dtype, kernel_key="fm_ag_kernel")
        ring_rows[label] = time_collective(
            f"ring_all_gather {label}",
            lambda x=x: kernels.ring_all_gather(x),
            lambda x=x: kernels.ring_all_gather_plain(x), None, 0, nbytes,
            x.dtype, kernel_key="ring_ag_kernel")
        for key in ("library_ms", "library_us"):
            ring_rows[label][key] = fm_rows[label][key]
    rs_rows = {}
    for label, x in xs.items():
        rows, w = x.shape[1:]
        if rows % n:
            continue
        m = rows // n
        rs_rows[label] = rs_extras(
            f"ring_reduce_scatter {label}", time_collective(
                f"ring_reduce_scatter {label}",
                lambda x=x: kernels.ring_reduce_scatter(x),
                lambda x=x: kernels.ring_reduce_scatter_plain(x),
                lambda x=x, m=m: x.view(n, n, m, -1).sum(0),
                n * (n - 1) * m * w, (n * rows * w + n * m * w)
                * x.element_size(), torch.float32,
                kernel_key="ring_rs_kernel"), x, rs_host_parts(kernels, x))
    sweep = {}
    for nn in (2, 4):
        for b in AR_SWEEP_BYTES:
            rows = b // (2 * AR_SWEEP_WIDTH)
            x = rand((nn, rows, AR_SWEEP_WIDTH), torch.bfloat16, b + nn)
            ones, twos = [], []
            for _ in range(AR_SWEEP_ROUNDS):
                ones.append(time_ms(lambda x=x: kernels.one_shot_all_reduce(
                    x), iters=10))
                twos.append(time_ms(lambda x=x: kernels.two_shot_all_reduce(
                    x), iters=10))
            one, two = statistics.median(ones), statistics.median(twos)
            sweep[f"n={nn} {b // 1024} KiB"] = dict(n=nn, bytes=b,
                                                    one_shot_ms=one,
                                                    two_shot_ms=two)
            log(f"  all_reduce sweep n={nn} {b // 1024:4d} KiB a rank: "
                f"one_shot {one:.4f} ms, two_shot {two:.4f} ms")
    crossover = {}
    for nn in (2, 4):
        below = 0
        for b in AR_SWEEP_BYTES:
            r = sweep[f"n={nn} {b // 1024} KiB"]
            if r["one_shot_ms"] > r["two_shot_ms"]:
                break
            below = b
        crossover[nn] = below
    lib_cross = kernels.allreduce._ONE_SHOT_CROSSOVER_BYTES
    log(f"  one-shot / two-shot crossover (largest size with one-shot no "
        f"slower, bytes a rank): {crossover}; the library's {lib_cross}")
    for nn, below in crossover.items():
        assert below >= lib_cross, (
            f"n={nn}: one-shot slower than two-shot at or below the "
            f"library's crossover {lib_cross} (measured {below})")
    fm_pool = check_fm_pools(kernels, [xs[labels[0]], xs[labels[1]],
                                       xs[labels[3]]])
    numbers = dict(routes=routes, bands=bands, ar_sweep=sweep,
                   ar_crossover=crossover, full_mesh_pool_bytes=fm_pool,
                   full_mesh_vs_ring={k: dict(
                       full_mesh_ms=fm_rows[k]["ms"],
                       full_mesh_us=fm_rows[k]["device_us"],
                       ring_ms=ring_rows[k]["ms"],
                       ring_us=ring_rows[k]["device_us"])
                       for k in fm_rows},
                   ring_rs=rs_rows)
    return launched, fm_rows, labels[1], max(fm_errs), numbers


# -- the quantized wire (phase 4w) --------------------------------------------

WIRE_KERNELS = ("ring_rs_wire", "gemm_rs_wire", "ag_gemm_wire")
WIRE_WORLD = 4
WIRE_SEED = 0
# the formats of every group (ag_gemm takes per-row scales only)
WIRE_FORMATS = (("fp8", None), ("int8", None), ("int8", 128))
# per-rank shapes at Qwen3-8B widths: (rows, width, what)
WIRE_RS_SHAPES = ((512, 4096, "the 4 x 128 prefill"),
                  (4, 4096, "a decode step"))
WIRE_AG_SHAPE = (128, 4096, "1 MiB a rank")
WIRE_LL_SHAPE = (4, 4096, "a decode step")
WIRE_LL_CALLS = 3
# (name, m a rank, K, N): ag_gemm's A shard (m, K) times B (K, N) a rank
WIRE_AG_GEMM = (("QKV", 128, 4096, 1536), ("gate|up", 128, 4096, 6144))
# (name, M, K a rank, N): gemm_rs's a (M, K) times b (K, N) a rank
WIRE_GEMM_RS = (("down", 512, 3072, 4096), ("O", 512, 1024, 4096))


def wire_label(fmt) -> str:
    return fmt.kind + ("" if fmt.block is None else f" block {fmt.block}")


def wire_hop_bytes(n, m, k, fmt) -> int:
    """The wire images a ring moves over all ranks: (n - 1) hops, each
    rank's m image rows of wire_cols bytes read and written once."""
    from triton_dist_tpu_torch import wire

    return 2 * (n - 1) * n * m * wire.wire_cols(k, fmt)


def wire_drift(label, got, native) -> tuple:
    """(cos, ulp) of a wire result against the native fold; raises
    above DEFAULT_ERROR_BUDGET."""
    from triton_dist_tpu_torch import wire

    cos, ulp = wire.cosine_drift(got, native), wire.max_ulp_f32(got, native)
    if not cos <= wire.DEFAULT_ERROR_BUDGET:
        raise AssertionError(f"{label}: drift {cos:.3e} against the native "
                             f"fold above {wire.DEFAULT_ERROR_BUDGET}")
    return cos, ulp


def wire_row(label, fn, plain, native, ops, nbytes, keys, drift):
    """A wire call's row: call ms and device µs (the sum over `keys`),
    plain ms, bound, the native kernel's call ms at the same shape, the
    drift against the native fold."""
    import torch

    row = time_collective(label, fn, plain, None, ops, nbytes,
                          torch.bfloat16)
    us = [device_us(fn, key) for key in keys]
    row["device_us"] = None if None in us else sum(us)
    row["device_us_by_kernel"] = dict(zip(keys, us))
    row["native_ms"] = time_ms(native)
    row["drift_cos"], row["drift_ulp"] = drift
    dev = ("None" if row["device_us"] is None
           else f"{row['device_us']:.1f}")
    log(f"    device {dev} us ({' + '.join(keys)}); native {row['native_ms']:.4f} "
        f"ms (wire / native {row['ms'] / row['native_ms']:.2f}); drift "
        f"cos {drift[0]:.3e} ulp {drift[1]}")
    return row


def run_wire(kernels):
    """Phase 4w, the quantized wire at Qwen3-8B widths on the virtual
    world of 4, bf16, seed 0, no weights: reduce_scatter_op and
    all_reduce_op on per-rank (512, 4096) and (4, 4096); all_gather ring
    and full mesh on (128, 4096) and ll_all_gather on (4, 4096) (three
    calls on one context); ag_gemm at QKV and gate|up, gemm_rs at down
    and O; each on fp8, int8 and int8 block 128 (ag_gemm: fp8 and int8),
    launches counted from 0 around them. Then: RS bitwise its plain
    version; AR bitwise wire.simulate_allreduce; the gathers bitwise the
    roundtrip of the shards; gemm_rs bitwise the plain fold of the
    kernel's own f32 partials (teacher-forced) and within the bf16 band's
    cosine of the end-to-end plain version; ag_gemm within the bf16 band
    of its plain version; every result's drift against the native fold
    at most DEFAULT_ERROR_BUDGET. The body each ag_gemm and partial-GEMM
    launch took (launches_by_body) is held to its module's _body_for
    rule. Then each call's timing beside the native kernel's, the
    partial GEMM's and the ring's device µs apart. Returns (launches,
    {kernel: (rows, main label, max abs err)}, numbers)."""
    import torch

    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import low_latency_allgather as llag

    n, bf = WIRE_WORLD, torch.bfloat16
    AG = kernels.AllGatherMethod
    fmts = [wire.WireFormat(kind, block) for kind, block in WIRE_FORMATS]
    per_row = [f for f in fmts if f.block is None]
    seed = iter(range(WIRE_SEED, WIRE_SEED + 100))
    rs_x = {rows: rand((n, rows, w), bf, next(seed))
            for rows, w, _ in WIRE_RS_SHAPES}
    ag_x = rand((n, WIRE_AG_SHAPE[0], WIRE_AG_SHAPE[1]), bf, next(seed))
    ll_x = [rand((n, *WIRE_LL_SHAPE[:2]), bf, next(seed))
            for _ in range(WIRE_LL_CALLS)]
    agg = {name: (rand((n, m, k), bf, next(seed), 0.1),
                  rand((n, k, nn), bf, next(seed), 0.05))
           for name, m, k, nn in WIRE_AG_GEMM}
    grs_in = {name: (rand((n, mm, k), bf, next(seed), 0.1),
                     rand((n, k, nn), bf, next(seed), 0.05))
              for name, mm, k, nn in WIRE_GEMM_RS}
    dev = ag_x.device
    ll_ctx = {wire_label(f): llag.create_ll_ag_buffer(
        WIRE_LL_SHAPE[:2], bf, n, wire_format=f, device=dev) for f in fmts}
    outs, want = {}, {name: 0 for name in kernel_names()}
    ll_snaps = {}  # (call, format): the context's slots, parity flags

    def expect(name, k=1):
        want[name] += k

    # the body each ag_gemm and partial-GEMM launch takes, by the rules
    want_bodies = {"ag_gemm_wire": {}, "gemm_rs_wire": {}}
    for a, b in agg.values():
        body = agm._body_for(a, (b,), per_row[0], False)
        want_bodies["ag_gemm_wire"][body] = want_bodies["ag_gemm_wire"].get(
            body, 0) + len(per_row)
    for a, b in grs_in.values():
        body = grs._body_for(n, a.shape[1] // n, a.shape[2], b.shape[2], bf,
                             torch.float32, partials=True)
        want_bodies["gemm_rs_wire"][body] = want_bodies["gemm_rs_wire"].get(
            body, 0) + len(fmts)
    bodies0 = {"ag_gemm_wire": dict(agm.launches_by_body),
               "gemm_rs_wire": dict(grs.launches_by_body)}
    kernels.reset_launches()
    torch.cuda.synchronize()
    for f in fmts:
        fl = wire_label(f)
        for rows, x in rs_x.items():
            outs[("rs", rows, fl)] = kernels.reduce_scatter_op(
                x, wire_format=f)
            outs[("ar", rows, fl)] = kernels.all_reduce_op(x, wire_format=f)
            expect("ring_rs_wire", 2)
            expect("ring_all_gather")
        for meth in (AG.Ring1D, AG.FullMesh):
            outs[("ag", meth.value, fl)] = kernels.all_gather(
                ag_x, method=meth, wire_format=f)
            expect("ring_all_gather" if meth == AG.Ring1D
                   else "full_mesh_all_gather")
        for i, x in enumerate(ll_x):
            outs[("ll", i, fl)], _ = kernels.ll_all_gather(
                x, ll_ctx[fl], i, wire_format=f)
            ll_snaps[(i, fl)] = (ll_ctx[fl].data.clone(),
                                 ll_ctx[fl].flags[:, :2 * n].clone())
            expect("ll_all_gather")
        for name, (a, b) in grs_in.items():
            outs[("gemm_rs", name, fl)] = kernels.gemm_rs(a, b,
                                                          wire_format=f)
            expect("gemm_rs_wire")
            expect("ring_rs_wire")
        if f.block is None:
            for name, (a, b) in agg.items():
                outs[("ag_gemm", name, fl)] = kernels.ag_gemm(
                    a, b, wire_format=f)
                expect("ag_gemm_wire")
    torch.cuda.synchronize()
    launched = kernels.launches()
    assert launched == want, (launched, want)
    bodies = {name: {k: v - bodies0[name][k] for k, v in by.items()
                     if v != bodies0[name][k]}
              for name, by in (("ag_gemm_wire", agm.launches_by_body),
                               ("gemm_rs_wire", grs.launches_by_body))}
    assert bodies == want_bodies, (bodies, want_bodies)
    log(f"  wire launches by body: {bodies} (the rules' {want_bodies})")
    for key, y in outs.items():
        assert bool(torch.isfinite(y.float()).all()), key

    # each result against its plain version, and its drift against the
    # native fold
    drift, errs = {}, {name: 0.0 for name in WIRE_KERNELS}
    native_rs = {rows: kernels.reduce_scatter_op(x) for rows, x in
                 rs_x.items()}
    native_ar = {rows: kernels.all_reduce_op(
        x, method=kernels.AllReduceMethod.TwoShot) for rows, x in
        rs_x.items()}
    for f in fmts:
        fl = wire_label(f)
        for rows, x in rs_x.items():
            got = outs[("rs", rows, fl)]
            errs["ring_rs_wire"] = max(errs["ring_rs_wire"], check_bitwise(
                f"reduce_scatter_op {fl} {rows}", got,
                kernels.ring_reduce_scatter_wire_plain(x, f).reshape(
                    got.shape)))
            drift[("reduce_scatter_op", rows, fl)] = wire_drift(
                f"reduce_scatter_op {fl} {rows}", got, native_rs[rows])
            got = outs[("ar", rows, fl)]
            check_bitwise(f"all_reduce_op {fl} {rows}", got,
                          wire.simulate_allreduce(x, f, n))
            drift[("all_reduce_op", rows, fl)] = wire_drift(
                f"all_reduce_op {fl} {rows}", got, native_ar[rows])
        rt = wire.roundtrip(ag_x.reshape(-1, ag_x.shape[2]), f)
        for meth in (AG.Ring1D, AG.FullMesh):
            got = outs[("ag", meth.value, fl)]
            check_bitwise(f"all_gather {meth.value} {fl}", got,
                          rt.expand(n, *rt.shape))
            drift[("all_gather", meth.value, fl)] = wire_drift(
                f"all_gather {meth.value} {fl}", got,
                ag_x.reshape(1, -1, ag_x.shape[2]).expand(got.shape))
        twin = llag.create_ll_ag_buffer(WIRE_LL_SHAPE[:2], bf, n,
                                        wire_format=f, device=dev)
        for i, x in enumerate(ll_x):
            rt = wire.roundtrip(x.reshape(-1, x.shape[2]), f).reshape(
                x.shape)
            check_bitwise(f"ll_all_gather {fl} call {i}",
                          outs[("ll", i, fl)], rt[None].expand(n, *x.shape))
            xw = wire.pack(x.reshape(-1, x.shape[2]), f).reshape(
                n, x.shape[1], -1)
            llag.ll_all_gather_plain(xw, twin, i)
            data, flags = ll_snaps[(i, fl)]
            check_bitwise(f"ll_all_gather {fl} call {i}: context slots",
                          data, twin.data)
            check_bitwise(f"ll_all_gather {fl} call {i}: parity flags",
                          flags, twin.flags[:, :2 * n])
        drift[("ll_all_gather", fl)] = wire_drift(
            f"ll_all_gather {fl}", outs[("ll", 0, fl)],
            ll_x[0][None].expand(n, *ll_x[0].shape))
        for name, (a, b) in grs_in.items():
            got = outs[("gemm_rs", name, fl)]
            partial = grs._launch(a, b, False, torch.float32, partials=True)
            errs["gemm_rs_wire"] = max(errs["gemm_rs_wire"], check_bitwise(
                f"gemm_rs {name} {fl} teacher-forced", got,
                kernels.ring_reduce_scatter_wire_plain(partial, f, bf)))
            rep = torch_parity().check_epsilon(
                kernels.gemm_rs_wire_plain(a, b, f).float().cpu().numpy(),
                got.float().cpu().numpy(), "gemm_rs", bf)
            if not rep["cos"] <= rep["band_cos"]:
                raise AssertionError(f"gemm_rs {name} {fl} outside the bf16 "
                                     f"band's cosine of its plain version: "
                                     f"{rep}")
            log(f"  gemm_rs {name} {fl}: bitwise the plain fold of its own "
                f"partials; end to end cos {rep['cos']:.3e} ulp "
                f"{rep['ulp']} (band cos {rep['band_cos']:.0e}, judged)")
            drift[("gemm_rs", name, fl)] = wire_drift(
                f"gemm_rs {name} {fl}", got, kernels.gemm_rs(a, b))
        for name, (a, b) in agg.items():
            if f.block is not None:
                continue
            got = outs[("ag_gemm", name, fl)]
            want_c = kernels.ag_gemm_plain(a, b, wire_format=f)
            band(want_c, got, "ag_gemm")
            errs["ag_gemm_wire"] = max(
                errs["ag_gemm_wire"],
                (got.float() - want_c.float()).abs().max().item())
            drift[("ag_gemm", name, fl)] = wire_drift(
                f"ag_gemm {name} {fl}", got, kernels.ag_gemm(a, b))
    log(f"  wire: {len(outs)} calls, launches {dict((k, v) for k, v in launched.items() if v)}; "
        "RS bitwise its plain version, AR bitwise simulate_allreduce, the "
        "gathers bitwise the roundtrip, gemm_rs teacher-forced bitwise, "
        "ag_gemm in the bf16 band; drift against the native fold (cos, "
        f"ulp): {drift}")
    del outs, native_rs, native_ar

    # timing: each call, its device time, the native kernel's
    rows = {name: {} for name in WIRE_KERNELS}
    timings = {}
    for f in fmts:
        fl = wire_label(f)
        for (rows_n, w, what), x in zip(WIRE_RS_SHAPES, rs_x.values()):
            m = rows_n // n
            ins, out = n * rows_n * w * 2, n * m * w * 2
            hops = wire_hop_bytes(n, m, w, f)
            label = f"({rows_n}, {w}) bf16 a rank, {what}, {fl}"
            rows["ring_rs_wire"][f"reduce_scatter_op {label}"] = rs_extras(
                f"reduce_scatter_op {label}", wire_row(
                    f"reduce_scatter_op {label}",
                    lambda x=x, f=f: kernels.reduce_scatter_op(
                        x, wire_format=f),
                    lambda x=x, f=f: kernels.ring_reduce_scatter_wire_plain(
                        x, f),
                    lambda x=x: kernels.reduce_scatter_op(x),
                    n * (n - 1) * m * w, ins + out + hops,
                    ["ring_rs_wire_kernel"],
                    drift[("reduce_scatter_op", rows_n, fl)]),
                x, rs_wire_host_parts(kernels, x, f), wire_row=True)
            timings[f"all_reduce_op {label}"] = wire_row(
                f"all_reduce_op {label}",
                lambda x=x, f=f: kernels.all_reduce_op(x, wire_format=f),
                lambda x=x, f=f: wire.simulate_allreduce(x, f, n),
                lambda x=x: kernels.all_reduce_op(
                    x, method=kernels.AllReduceMethod.TwoShot),
                n * (n - 1) * m * w, ins + n * rows_n * w * 2 + hops
                + wire_hop_bytes(n, m, w, f),
                ["ring_rs_wire_kernel", "ring_ag_kernel"],
                drift[("all_reduce_op", rows_n, fl)])
        rows_n, w, what = WIRE_AG_SHAPE
        nbytes = (n * rows_n * w + n * n * rows_n * w) * 2 + \
            wire_hop_bytes(n, rows_n, w, f)
        for meth, key in ((AG.Ring1D, "ring_ag_kernel"),
                          (AG.FullMesh, "fm_ag_kernel")):
            label = f"all_gather {meth.value} ({rows_n}, {w}) bf16, {what}, {fl}"
            timings[label] = wire_row(
                label,
                lambda f=f, meth=meth: kernels.all_gather(
                    ag_x, method=meth, wire_format=f),
                lambda f=f: wire.roundtrip(ag_x.reshape(-1, w), f),
                lambda meth=meth: kernels.all_gather(ag_x, method=meth), 0,
                nbytes, [key], drift[("all_gather", meth.value, fl)])
        rows_n, w, what = WIRE_LL_SHAPE
        ctx_w = llag.create_ll_ag_buffer((rows_n, w), bf, n, wire_format=f,
                                         device=dev)
        ctx_n = llag.create_ll_ag_buffer((rows_n, w), bf, n, device=dev)
        calls = {"wire": 0, "native": 0}

        def ll_call(which, f=f, ctx_w=ctx_w, ctx_n=ctx_n, calls=calls):
            i = calls[which]
            calls[which] += 1
            if which == "wire":
                return kernels.ll_all_gather(ll_x[0], ctx_w, i,
                                             wire_format=f)
            return kernels.ll_all_gather(ll_x[0], ctx_n, i)

        label = f"ll_all_gather ({rows_n}, {w}) bf16, {what}, {fl}"
        timings[label] = wire_row(
            label, lambda: ll_call("wire"),
            lambda f=f: wire.roundtrip(ll_x[0].reshape(-1, w), f),
            lambda: ll_call("native"), 0,
            (n * rows_n * w + n * n * rows_n * w) * 2
            + wire_hop_bytes(n, rows_n, w, f),
            ["ll_ag_kernel"], drift[("ll_all_gather", fl)])
        for name, mm, k, nn in WIRE_GEMM_RS:
            a, b = grs_in[name]
            label = (f"gemm_rs {name} ({mm}, {k}) @ ({k}, {nn}) bf16 a "
                     f"rank, {fl}")
            rows["gemm_rs_wire"][label] = wire_row(
                label, lambda a=a, b=b, f=f: kernels.gemm_rs(
                    a, b, wire_format=f),
                lambda a=a, b=b, f=f: kernels.gemm_rs_wire_plain(a, b, f),
                lambda a=a, b=b: kernels.gemm_rs(a, b), 2 * n * mm * k * nn,
                (n * mm * k + n * k * nn + n * (mm // n) * nn) * 2
                + wire_hop_bytes(n, mm // n, nn, f),
                ["gemm_rs", "ring_rs_wire_kernel"],
                drift[("gemm_rs", name, fl)])
        if f.block is not None:
            continue
        for name, m, k, nn in WIRE_AG_GEMM:
            a, b = agg[name]
            label = (f"ag_gemm {name} ({m}, {k}) @ ({k}, {nn}) bf16 a rank, "
                     f"{fl}")
            rows["ag_gemm_wire"][label] = wire_row(
                label, lambda a=a, b=b, f=f: kernels.ag_gemm(
                    a, b, wire_format=f),
                lambda a=a, b=b, f=f: kernels.ag_gemm_plain(
                    a, b, wire_format=f),
                lambda a=a, b=b: kernels.ag_gemm(a, b),
                2 * n * n * m * k * nn,
                (n * m * k + n * k * nn + n * n * m * nn) * 2
                + wire_hop_bytes(n, m, k, f), ["ag_gemm"],
                drift[("ag_gemm", name, fl)])
    mains = {"ring_rs_wire": next(iter(rows["ring_rs_wire"])),
             "gemm_rs_wire": next(iter(rows["gemm_rs_wire"])),
             "ag_gemm_wire": next(iter(rows["ag_gemm_wire"]))}
    numbers = dict(drift={" ".join(map(str, k)): v for k, v in
                          drift.items()},
                   timings=timings, bodies=bodies)
    return launched, {name: (rows[name], mains[name], errs[name])
                      for name in WIRE_KERNELS}, numbers


# -- phase 4r: the resident serving loop --------------------------------------

RESIDENT_KERNELS = ("sample_slots", "ring_boundary", "ring_emit")
RES_WINDOW = 16         # steps a window (the JAX ResidentWorker's default)
RES_GEO = dict(slots=4, chunk=64, page=64)
RES_GEN = 16
RES_SMALL_LAYERS = 4    # the world-4 windows' depth
# the eos traffic: request i stops at the token its no-eos stream emits at
# index EOS_AT[i] (or at an earlier emission of that token)
EOS_AT = (2, 5, 4, 3, 8, 6)
RING_CASES = 200        # random states a ring-kernel check


def sched_prompts(cfg):
    """Phase 4's six Scheduler prompts (100-300 tokens), drawn as
    run_model draws them."""
    import numpy as np

    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (4, 128))
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (100, 300, 180, 250, 120, 211)]


def ring_case(rng, geo, cap, rw):
    """A random window state the loop can meet: a ring of admissions (half
    of them with a prefix-cache hit), retirements (matching and stale),
    no-ops and torn records under at_step gates, and a state block (header counters, slot states with
    prefill positions inside their prompts, table, lengths, some output
    records). Returns (ring (cap, rw), block (words,)) int32 numpy."""
    import numpy as np

    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    K, C, maxp = geo.slots, geo.chunk, geo.max_pages
    prompt_cap = rw - mring.IR_HEADER - maxp - C
    ring = np.zeros((cap, rw), np.int32)
    consumed = int(rng.integers(0, 40))
    published = consumed + int(rng.integers(0, cap + 1))
    for i in range(max(0, consumed - cap), published):
        r = ring[i % cap]
        r[:] = rng.integers(-50, 5000, rw)
        r[mring.IR_SEQ] = 0 if (i >= consumed and rng.random() < 0.1) \
            else i + 1
        r[mring.IR_KIND] = rng.choice([0, 1, 1, 1, 2, 2, 3])
        r[mring.IR_SLOT] = rng.integers(0, K)
        r[mring.IR_AT_STEP] = rng.integers(0, 12)
        plen = int(rng.integers(1, prompt_cap + 1))
        r[mring.IR_PROMPT_LEN] = plen
        r[mring.IR_MAX_NEW] = rng.integers(1, 20)
        r[mring.IR_TEMP_BITS] = np.float32(rng.choice([0.0, 0.7, 1.3])).view(
            np.int32)
        r[mring.IR_EOS] = rng.integers(0, 3)
        # half the admissions a prefix-cache hit: a block (chunk) multiple
        # below the prompt length
        r[mring.IR_PREFIX] = (C * rng.integers(0, (plen - 1) // C + 1)
                              if rng.random() < 0.5 else 0)
        r[mring.IR_REQID] = rng.integers(0, 8)
        r[mring.IR_NOUT] = rng.integers(0, 20)
        r[mring.IR_SPEC_K] = rng.integers(1, 4)
    blk = np.zeros((geo.words,), np.int32)
    hdr = blk[:kring.HEADER_WORDS]
    hdr[kring.H_PUBLISHED] = published
    hdr[kring.H_CONSUMED] = consumed
    hdr[kring.H_STEP0] = rng.integers(0, 1000)
    hdr[kring.H_EXECUTED] = rng.integers(0, geo.window + 1)
    hdr[kring.H_IDLE] = rng.integers(0, geo.poll_budget + 1)
    hdr[kring.H_LIVE] = rng.random() < 0.9
    hdr[kring.H_STEP_LIVE] = rng.random() < 0.8
    hdr[kring.H_OUT_COUNT] = rng.integers(0, geo.out_cap // 2)
    ss = blk[geo.ss_at:geo.table_at].reshape(K, mring.SS_WIDTH)
    for s in range(K):
        plen = int(rng.integers(1, prompt_cap + 1))
        ss[s, mring.SS_ACTIVE] = rng.random() < 0.7
        ss[s, mring.SS_PHASE] = rng.integers(0, 2)
        ss[s, mring.SS_PROMPT_LEN] = plen
        ss[s, mring.SS_POS] = (plen if ss[s, mring.SS_PHASE]
                               else rng.integers(0, plen))
        ss[s, mring.SS_MAX_NEW] = rng.integers(1, 20)
        ss[s, mring.SS_N_OUT] = rng.integers(0, 19)
        ss[s, mring.SS_TEMP_BITS] = np.float32(
            rng.choice([0.0, 0.7])).view(np.int32)
        ss[s, mring.SS_SEED] = rng.integers(-2**31, 2**31 - 1)
        ss[s, mring.SS_EOS] = rng.integers(0, 3)
        ss[s, mring.SS_LAST_TOK] = rng.integers(0, 5000)
        ss[s, mring.SS_REC] = rng.integers(0, cap)
        ss[s, mring.SS_REQID] = rng.integers(0, 8)
    blk[geo.table_at:geo.lengths_at] = rng.integers(0, 64, K * maxp)
    blk[geo.lengths_at:geo.out_at] = rng.integers(0, 900, K)
    if geo.spec_k:
        # a staged verify record on each slot: fresh (its ring row a
        # committed KIND_VERIFY of the slot's req_id at its n_out), or
        # stale by its seq, n_out or req_id, or none staged
        for s in range(K):
            row = int(rng.integers(0, cap))
            r = ring[row]
            if rng.random() < 0.6:
                r[mring.IR_KIND] = mring.KIND_VERIFY
                r[mring.IR_SEQ] = r[mring.IR_SEQ] or row + 1
                r[mring.IR_REQID] = ss[s, mring.SS_REQID]
                r[mring.IR_NOUT] = ss[s, mring.SS_N_OUT]
                r[mring.IR_SPEC_K] = rng.integers(1, geo.spec_k + 3)
            ss[s, mring.SS_SPEC_REC] = row
            ss[s, mring.SS_SPEC_SEQ] = r[mring.IR_SEQ] + (
                cap if rng.random() < 0.1 else 0)
            ss[s, mring.SS_SPEC_K] = r[mring.IR_SPEC_K] * (rng.random() < 0.9)
            ss[s, mring.SS_N_OUT] += rng.random() < 0.1
        blk[geo.ss_at:geo.table_at] = ss.ravel()
    return ring, blk


def check_ring_case(ring, blk, geo, tok, label):
    """ring_boundary (step form, then final form) and ring_emit on the card
    against their plain versions on the same state, tok the step's
    tokens ((K,), or (K, C) with geo.spec_k; or a function of the plain
    boundary's step buffers giving them): the state block and every step
    buffer bitwise after each. Raises on a difference."""
    import torch

    from triton_dist_tpu_torch.kernels import ring as kring

    ring_d = torch.as_tensor(ring, device="cuda")
    ring_h = torch.as_tensor(ring)
    states = {}
    for dev in ("cpu", "cuda"):
        b = torch.as_tensor(blk.copy(), device=dev)
        bufs = kring.StepBuffers.create(geo, dev)
        r = ring_d if dev == "cuda" else ring_h
        kring.ring_boundary(r, b, geo, bufs)
        after_b = [b.cpu().clone()] + [x.cpu().clone() for x in bufs]
        if callable(tok):
            tok = tok(bufs)
        kring.ring_emit(torch.as_tensor(tok, device=dev), b, geo, bufs)
        after_e = b.cpu().clone()
        kring.ring_boundary(r, b, geo, bufs, final=True)
        states[dev] = after_b + [after_e, b.cpu().clone()]
    torch.cuda.synchronize()
    names = ["block after boundary", *kring.StepBuffers._fields,
             "block after emit", "block after the final boundary"]
    for name, g, w in zip(names, states["cuda"], states["cpu"]):
        if not torch.equal(g, w):
            bad = torch.nonzero(g.reshape(-1) != w.reshape(-1)).flatten()
            raise AssertionError(
                f"{label}: ring kernels differ from their plain versions in "
                f"the {name} at {bad[:8].tolist()}: "
                f"{g.reshape(-1)[bad[:8]].tolist()} vs "
                f"{w.reshape(-1)[bad[:8]].tolist()}")


def check_ring_kernels(recorded, geo, cap, rw, vocab, n_random=RING_CASES):
    """The ring kernels bitwise their plain versions on the window inputs
    a resident run recorded (each window's first boundary) and on
    n_random random states; the step's tokens random, a third of them
    each slot's eos. Returns the cases checked."""
    import numpy as np

    from triton_dist_tpu_torch.mega import ring as mring

    rng = np.random.default_rng(5)
    cases = [(r, b, f"recorded window {i}") for i, (r, b) in
             enumerate(recorded)]
    cases += [(*ring_case(rng, geo, cap, rw), f"random state {i}")
              for i in range(n_random)]
    for ring, blk, label in cases:
        ss = blk[geo.ss_at:geo.table_at].reshape(geo.slots, mring.SS_WIDTH)
        eos = ss[:, mring.SS_EOS]
        if geo.spec_k:
            def tok(bufs, eos=eos):
                # the fed tokens one column on (each draft accepted), a
                # third of them replaced, a tenth by the slot's eos
                t = np.roll(bufs.tokens.cpu().numpy(), -1, axis=1)
                shape = t.shape
                t = np.where(rng.random(shape) < 0.3,
                             rng.integers(0, vocab, shape), t)
                return np.where((rng.random(shape) < 0.1)
                                & (eos[:, None] > 0), eos[:, None] - 1,
                                t).astype(np.int64)
        else:
            tok = rng.integers(0, vocab, geo.slots)
            tok = np.where((rng.random(geo.slots) < 0.3) & (eos > 0),
                           eos - 1, tok).astype(np.int64)
        check_ring_case(ring, blk, geo, tok, label)
    form = f"spec forms (spec_k {geo.spec_k})" if geo.spec_k else "step forms"
    log(f"  ring_boundary / ring_emit {form}: bitwise their plain versions "
        f"on {len(recorded)} recorded window inputs and {n_random} random "
        "states (boundary, emit, final boundary)")
    return len(cases)


def check_sample_kernel(V, R=4, trials=3):
    """sample_slots on the card against its plain version at R x V:
    greedy and sampled rows, a row per key and one flat draw, with and
    without the split: tokens equal, the next keys and every sampled
    row's random bits bitwise (the kernel's bits hook). Returns the
    number of rows checked."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels import sample as ks
    from triton_dist_tpu_torch.serve import sampling_key

    rows = 0
    for t in range(trials):
        logits = rand((R, V), torch.float32, 900 + t, scale=3.0)
        keys = torch.as_tensor(ks.as_int32(np.stack(
            [sampling_key(t * 7 + r, 3 + r) for r in range(R)])),
            device="cuda")
        temps = torch.tensor([0.7, 0.0, 1.3, 0.9][:R] + [0.8] * (R - 4),
                             device="cuda")
        for flat in (False, True):
            for split in (False, True):
                nxt_k = torch.zeros((R, 2), dtype=torch.int32, device="cuda")
                nxt_p = torch.zeros_like(nxt_k)
                bits = torch.zeros((R, V), dtype=torch.int32, device="cuda")
                got = ks._launch(logits, keys, temps, flat,
                                 nxt_k if split else None, bits)
                want = ks.sample_slots_plain(logits, keys, temps, flat,
                                             nxt_p if split else None)
                sub = ks._split_words(keys)[1] if split else keys
                base = (torch.arange(R, device="cuda") * V if flat else 0)
                wbits = ks.random_bits(sub, V, base)
                hot = temps > 0
                if not (torch.equal(got, want) and torch.equal(nxt_k, nxt_p)
                        and torch.equal(bits[hot].long() & ks.MASK,
                                        wbits[hot])):
                    raise AssertionError(
                        f"sample_slots differs from its plain version "
                        f"(trial {t}, flat {flat}, split {split}): tokens "
                        f"{got.tolist()} vs {want.tolist()}")
                rows += R
    torch.cuda.synchronize()
    log(f"  sample_slots: tokens equal and keys / random bits bitwise its "
        f"plain version on {rows} rows of {V} (greedy and sampled, a key a "
        "row and flat, split and not)")
    return rows


def resident_bytes(geo, rw, consumed):
    """Bytes a step's ring_boundary and ring_emit must move: the block
    read and written, the records consumed and the slots' prompt chunks
    read, the step's buffers written; the emit the block and the step's
    n_valid, emits and tokens."""
    K, C = geo.slots, geo.chunk
    blk = geo.words * 4
    bufs = K * C * 8 + K * 8 * 2 + K * geo.max_pages * 8 + K * (4 + 8 + 4)
    return (2 * blk + consumed * rw * 4 + K * C * 4 + bufs,
            2 * blk + K * (8 + 8 + 4))


def time_resident_kernels(recorded, geo, rw, vocab):
    """The three kernels timed at phase 4r's shapes: sample_slots on a
    step's (4, V) logits with two sampled rows (bound: the logits read
    once; library: torch.multinomial over the softmax of logits / T),
    ring_boundary on the busiest recorded window input (the most records
    consumed at its first boundary) and ring_emit after it (bound: the
    block and the step's buffers once; no library call); each call puts
    the block back first (a copy on the card, in the call ms, not in the
    kernel's device µs); their plain versions run on the host. Returns
    ({name: {label: row}}, {name: label})."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.kernels import sample as ks
    from triton_dist_tpu_torch.serve import sampling_key

    R, V = geo.slots, vocab
    logits = rand((R, V), torch.float32, 77, scale=3.0)
    keys = torch.as_tensor(ks.as_int32(np.stack(
        [sampling_key(r, 5) for r in range(R)])), device="cuda")
    temps = torch.tensor([0.7, 0.0, 0.0, 0.9], device="cuda")
    hot = int((temps > 0).sum())
    slabel = (f"a serve step's ({R}, {V}) f32 logits, {hot} sampled rows "
              f"(T 0.7, 0.9), {R - hot} greedy")
    probs_t = torch.clamp_min(temps, 1e-6)[:, None]
    rows = {"sample_slots": {slabel: time_collective(
        f"sample_slots {slabel}",
        lambda: ks.sample_slots(logits, keys, temps),
        lambda: ks.sample_slots_plain(logits, keys, temps),
        lambda: torch.multinomial(torch.softmax(logits / probs_t, -1), 1),
        hot * V * 10 + R * V, R * V * 4 + R * 12 + R * 8, torch.float32,
        kernel_key="sample_kernel")}}
    best = max(recorded, key=lambda rb: int(rb[1][kring.H_PUBLISHED])
               - int(rb[1][kring.H_CONSUMED]))
    ring, blk0 = best
    pending = int(blk0[kring.H_PUBLISHED]) - int(blk0[kring.H_CONSUMED])
    ring_d = torch.as_tensor(ring, device="cuda")
    blk0_d = torch.as_tensor(blk0, device="cuda")
    blk = blk0_d.clone()
    bufs = kring.StepBuffers.create(geo, "cuda")
    ring_h, blk_h = torch.as_tensor(ring), torch.as_tensor(blk0.copy())
    bufs_h = kring.StepBuffers.create(geo, "cpu")
    blabel = (f"a recorded window's first boundary: {pending} records "
              f"pending, K {geo.slots}, C {geo.chunk}, record width {rw}")
    b_bytes, e_bytes = resident_bytes(geo, rw, pending)

    def boundary():
        blk.copy_(blk0_d)
        kring.ring_boundary(ring_d, blk, geo, bufs)

    def boundary_plain():
        blk_h.copy_(torch.as_tensor(blk0))
        kring.ring_boundary_plain(ring_h, blk_h, geo, bufs_h)

    boundary()
    after = blk.clone()
    tok = torch.arange(geo.slots, device="cuda", dtype=torch.int64)

    def emit():
        blk.copy_(after)
        kring.ring_emit(tok, blk, geo, bufs)

    after_h = after.cpu()
    tok_h = tok.cpu()

    def emit_plain():
        blk_h.copy_(after_h)
        kring.ring_emit_plain(tok_h, blk_h, geo, bufs_h)

    rows["ring_boundary"] = {blabel: time_collective(
        f"ring_boundary {blabel}", boundary, boundary_plain, None, 0,
        b_bytes, torch.float32, kernel_key="ring_boundary_kernel")}
    elabel = f"the step after it, K {geo.slots}"
    rows["ring_emit"] = {elabel: time_collective(
        f"ring_emit {elabel}", emit, emit_plain, None, 0, e_bytes,
        torch.float32, kernel_key="ring_emit_kernel")}
    return rows, {"sample_slots": slabel, "ring_boundary": blabel,
                  "ring_emit": elabel}


def stop_at_eos(tokens, eos):
    """A request's tokens as its run with eos_id `eos` must give them: up
    to and including the first eos (the stream does not depend on
    where the run stops)."""
    return tokens[:tokens.index(eos) + 1] if eos in tokens else tokens


def resident_window_launches(cfg, world, mode, steps):
    """The launches of one window of `steps` steps, worked out apart from
    the graph: `steps` times a Scheduler step's (want_launches: L
    flash_prefill_local and one sample_slots a step; at world > 1 2L
    one-shot AR in `ar`, 2L ag_gemm and 2L gemm_rs in `dist`), `steps`
    ring_emit and steps + 1 ring_boundary (the final one)."""
    per = want_launches(cfg.num_layers, world, "dist", mode, 0, 1)[1]
    got = {k: v * steps for k, v in per.items() if v}
    got.update(ring_emit=steps, ring_boundary=steps + 1)
    return got


def run_resident(kernels, cfg, params, world, mode, label,
                 window=RES_WINDOW, record=False, device="cuda"):
    """The resident path at `world` in `mode`: phase 4's six Scheduler
    requests (two sampled) through the host loop (replayed steps) and
    through Scheduler(resident=True, window) on the same Engine; the
    resident tokens bitwise the host loop's, greedy and sampled. Each way
    a first run (its capture) and a timed run; the resident timed run
    counts its launches from 0, held against the windows it ran
    (`resident_window_launches`, each window's length the Scheduler's
    pick, `_resident_steps`), as is every window graph's own count, and
    a third run counts its host syncs (one a window: the window's read).
    Then the same requests with an eos each, a token its no-eos stream
    emits early (EOS_AT), both ways: tokens bitwise, each the no-eos
    stream cut at its first eos; the windows run past the last
    retirement are the dead steps the sizing cannot foresee. An all-dead
    window of the full length times what a dead step costs.
    Returns (launches of the timed resident run, recorded window inputs
    (ring, block) when `record`, numbers)."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.models import Engine
    from triton_dist_tpu_torch.serve import Scheduler

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                 world=world, decode_mode=mode)
    prompts = sched_prompts(cfg)

    def scheduler(resident, eos=None):
        sch = Scheduler(eng, **RES_GEO, resident=resident,
                        **({"window": window} if resident else {}))
        reqs = [sch.submit(p, RES_GEN, temperature=0.7 if i % 3 == 2
                           else 0.0, seed=i,
                           eos_id=None if eos is None else eos[i])
                for i, p in enumerate(prompts)]
        return sch, reqs

    def timed(resident, wrap=None, eos=None):
        sch, reqs = scheduler(resident, eos)
        if wrap is not None:
            sch.worker._fn = wrap(sch.worker._fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sch.run()
        torch.cuda.synchronize()
        return sch, [r.out_tokens for r in reqs], time.perf_counter() - t0

    def held(w, n, what):
        """The launches n of a resident run against its windows, and each
        window graph's own count, worked out apart from the graphs."""
        for steps, g in loop.graphs.items():
            want_g = resident_window_launches(cfg, world, mode, steps)
            if {k: v for k, v in g.launches.items() if v} != want_g:
                raise AssertionError(f"{label}: the window graph of {steps} "
                                     f"steps launches {dict(g.launches)}, "
                                     f"want {want_g}")
        want = {name: 0 for name in kernel_names()}
        for steps, runs in w.windows_by_steps.items():
            for k, v in resident_window_launches(cfg, world, mode,
                                                 steps).items():
                want[k] += v * runs
        if n != want:
            raise AssertionError(f"{label}: {what} launches {n}, want {want}")

    timed(False)  # the host loop's capture
    host, host_toks, host_wall = timed(False)
    recorder = None
    if record:
        def recorder(loop):
            rec = RecordingLoop(loop)
            recorded.append(rec)
            return rec
    recorded = []
    t0 = time.perf_counter()
    first, first_toks, _ = timed(True, recorder)  # the window's capture
    first_s = time.perf_counter() - t0
    loop = eng.resident_loops[next(iter(eng.resident_loops))]
    kernels.reset_launches()
    sch, res_toks, res_wall = timed(True)
    n = kernels.launches()
    counted, _ = scheduler(True)
    syncs = host_syncs(counted.run)
    w = sch.worker
    windows, live = w.n_windows, w.n_steps
    unrolled = sum(k * v for k, v in w.windows_by_steps.items())
    dead = unrolled - live
    if not (res_toks == host_toks == first_toks
            and all(len(t) == RES_GEN for t in res_toks)):
        raise AssertionError(f"{label}: the resident tokens differ from the "
                             "host loop's")
    held(w, n, "resident")
    if syncs != counted.worker.n_windows or counted.worker.n_reads != \
            counted.worker.n_windows:
        raise AssertionError(f"{label}: {syncs} host syncs over "
                             f"{counted.worker.n_windows} windows")
    one = resident_window_launches(cfg, world, mode, 1)
    # the eos traffic: each request stops at a token its stream emits
    # early, which the window sizing cannot foresee
    eos = [host_toks[i][j] for i, j in enumerate(EOS_AT)]
    want_eos = [stop_at_eos(t, e) for t, e in zip(host_toks, eos)]
    timed(True, eos=eos)  # window lengths this traffic picks first
    eos_host, eos_host_toks, eos_host_wall = timed(False, eos=eos)
    kernels.reset_launches()
    eos_sch, eos_toks, eos_wall = timed(True, eos=eos)
    held(eos_sch.worker, kernels.launches(), "eos resident")
    if not eos_toks == eos_host_toks == want_eos:
        raise AssertionError(f"{label}: with eos the resident tokens "
                             f"{eos_toks}, the host loop's {eos_host_toks}, "
                             f"want {want_eos}")
    ew = eos_sch.worker
    eos_unrolled = sum(k * v for k, v in ew.windows_by_steps.items())
    # an all-dead window of the loop's full length: nothing active,
    # nothing pending
    ss = np.zeros_like(w.slot_state)
    dead_ms = time_ms(lambda: loop(loop.ring, 0, 0, 0, ss, w._table,
                                   w._lengths, sch.pool.k, sch.pool.v,
                                   steps=window), iters=3, warmup=1)
    graphs = {steps: dict(capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                          launches=dict(g.launches))
              for steps, g in sorted(loop.graphs.items())}
    sizes = {k: (round(g["capture_s"], 3), round(g["pool_bytes"] / 1e6, 1))
             for k, g in graphs.items()}
    tokens = sum(len(t) for t in res_toks)
    eos_tokens = sum(len(t) for t in eos_toks)
    eos_dead = eos_unrolled - ew.n_steps
    eos_row = dict(
        eos=eos, tokens=eos_tokens,
        host_tokens_per_s=eos_tokens / eos_host_wall,
        resident_tokens_per_s=eos_tokens / eos_wall,
        host_wall_s=eos_host_wall, resident_wall_s=eos_wall,
        host_steps=eos_host.worker.n_steps, windows=ew.n_windows,
        windows_by_steps=dict(ew.windows_by_steps), live_steps=ew.n_steps,
        dead_steps=eos_dead, dead_steps_ms=eos_dead * dead_ms / window)
    row = dict(
        world=world, mode=mode, window=window, layers=cfg.num_layers,
        host_tokens_per_s=tokens / host_wall,
        resident_tokens_per_s=tokens / res_wall, host_wall_s=host_wall,
        resident_wall_s=res_wall, host_steps=host.worker.n_steps,
        windows=windows, windows_by_steps=dict(w.windows_by_steps),
        live_steps=live, dead_steps=dead, syncs=syncs,
        reads_per_live_step=windows / max(live, 1),
        reads_per_step=syncs / sum(
            k * v for k, v in counted.worker.windows_by_steps.items()),
        dead_window_ms=dead_ms, dead_step_ms=dead_ms / window,
        dead_steps_ms=dead * dead_ms / window, first_run_s=first_s,
        capture_s=sum(g["capture_s"] for g in graphs.values()),
        pool_bytes=sum(g["pool_bytes"] for g in graphs.values()),
        graphs=graphs, launches_a_one_step_window=one, eos_traffic=eos_row,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  4r {label}: resident, windows of at most {window}: tokens "
        f"bitwise the host loop's (6 requests, 2 sampled); "
        f"{row['resident_tokens_per_s']:.2f} tokens/s ({res_wall:.3f} s) "
        f"against the host loop's {row['host_tokens_per_s']:.2f} "
        f"({host_wall:.3f} s, {host.worker.n_steps} steps); {windows} "
        f"windows (steps: runs {w.windows_by_steps}), {live} live and "
        f"{dead} dead; "
        f"host syncs {syncs} ({syncs / max(live, 1):.3f} a live step, "
        f"{row['reads_per_step']:.4f} a step); an all-dead window of "
        f"{window} {dead_ms:.3f} ms ({dead_ms / window:.3f} a step); first "
        f"run (its captures) {first_s:.3f} s; window graphs by length "
        f"(capture s, pool MB): {sizes}, {row['pool_bytes'] / 1e6:.1f} MB "
        f"in all (one shared pool); launches a window of "
        f"{max(loop.graphs)} {graphs[max(loop.graphs)]['launches']}, each "
        f"window's held against a one-step window's {one} (W times, "
        f"ring_boundary W + 1); with eos {eos}: "
        f"{eos_tokens} tokens bitwise the host loop's and each no-eos "
        f"stream cut at its eos, {eos_row['resident_tokens_per_s']:.2f} "
        f"tokens/s ({eos_wall:.3f} s) against the host loop's "
        f"{eos_row['host_tokens_per_s']:.2f} ({eos_host_wall:.3f} s, "
        f"{eos_row['host_steps']} steps), {ew.n_windows} windows (steps: "
        f"runs {ew.windows_by_steps}), {ew.n_steps} live and {eos_dead} "
        f"dead (about {eos_row['dead_steps_ms']:.1f} ms); peak "
        f"{row['peak_gb']:.2f} GB; {card_line()}")
    inputs = recorded[0].inputs if recorded else []
    # the loop's graphs and pools are released before the next phase
    del eng, sch, first, counted, host, loop, w, recorded, eos_sch, ew
    del eos_host
    gc.collect()
    torch.cuda.empty_cache()
    return n, inputs, row


class RecordingLoop:
    """A resident loop that keeps each window's inputs, (ring, state
    block) as numpy, before it runs the window (a read of the ring: for
    a run whose syncs are not counted)."""

    def __init__(self, loop):
        self.loop = loop
        self.inputs = []

    def __getattr__(self, name):
        return getattr(self.loop, name)

    def __call__(self, ring, published, consumed, step0, ss, tb, ln, *a,
                 **kw):
        import numpy as np

        from triton_dist_tpu_torch.kernels import ring as kring

        g = self.loop.geo
        blk = np.zeros((g.words,), np.int32)
        blk[kring.H_PUBLISHED] = published
        blk[kring.H_CONSUMED] = consumed
        blk[kring.H_STEP0] = step0
        blk[kring.H_LIVE] = 1
        blk[g.ss_at:g.table_at] = np.asarray(ss).ravel()
        blk[g.table_at:g.lengths_at] = np.asarray(tb).ravel()
        blk[g.lengths_at:g.out_at] = np.asarray(ln).ravel()
        self.inputs.append((ring.cpu().numpy().copy(), blk))
        return self.loop(ring, published, consumed, step0, ss, tb, ln, *a,
                         **kw)


def run_resident_phase(kernels, cfg, params):
    """Phase 4r: Qwen3-8B world 1 at full depth (the main resident path,
    recorded), then world 4 `ar` and `dist` at RES_SMALL_LAYERS layers of
    a fresh draw (the collectives' pools inside one W-step capture); then
    the three kernels against their plain versions (recorded and random
    window states; sample_slots at the vocabulary) and timed. Returns
    ({path: launches}, {kernel: (rows, main label, err)}, numbers)."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring
    from triton_dist_tpu_torch.models.dense import init_params

    n1, recorded, row1 = run_resident(kernels, cfg, params, 1, "ar",
                                      "Qwen3-8B world 1", record=True)
    small = dataclasses.replace(cfg, num_layers=RES_SMALL_LAYERS)
    p4 = init_params(small, device="cuda", seed=1, world=4)
    runs = {"resident_world1": n1}
    rows = {"world 1": row1}
    for mode in ("ar", "dist"):
        runs[f"resident_world4_{mode}"], _, rows[f"world 4 {mode}"] = \
            run_resident(kernels, small, p4, 4, mode,
                         f"Qwen3-8B widths, {RES_SMALL_LAYERS} layers, world "
                         f"4 {mode}")
    del p4
    torch.cuda.empty_cache()
    max_pages = MAX_LEN // RES_GEO["page"]
    cap = max(4 * RES_GEO["slots"], 16)
    geo = kring.WindowGeometry(RES_GEO["slots"], RES_GEO["chunk"], max_pages,
                               RES_WINDOW * RES_GEO["slots"] + cap,
                               RES_WINDOW, 8)
    rw = mring.ring_width(max_pages, MAX_LEN, RES_GEO["chunk"])
    cases = check_ring_kernels(recorded, geo, cap, rw, cfg.vocab_size)
    sampled = check_sample_kernel(cfg.vocab_size)
    timing, mains = time_resident_kernels(recorded, geo, rw, cfg.vocab_size)
    errs = {name: (timing[name], mains[name], 0.0)
            for name in RESIDENT_KERNELS}
    numbers = dict(paths=rows, ring_cases=cases, sample_rows=sampled,
                   conditional_node=hasattr(torch.cuda.CUDAGraph,
                                            "begin_capture_to_if_node"))
    log("  4r resident paths: " + json.dumps(rows))
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"  after 4r: {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved by torch")
    return runs, errs, numbers


# -- phase 4h: the prefix cache -----------------------------------------------

PREFIX_LEN = 512        # the shared system prompt's tokens
# each request's own suffix after it: request 0 is wave 1, the rest wave 2
PREFIX_SUFFIXES = (32, 64, 96, 128, 160, 48, 80, 112)
PREFIX_GEN = 16
PREFIX_BLOCK = 64       # tokens a trie node: one page
PREFIX_SAMPLED = {2: 1002, 5: 1005}  # request -> seed, at PREFIX_TEMP
PREFIX_TEMP = 0.9
# the runs' Scheduler arguments: the cache off (the oracle), the cache in
# the host loop, the cache in windows of RES_WINDOW
PREFIX_RUNS = {
    "cold": {},
    "host": dict(prefix_cache=True, prefix_block=PREFIX_BLOCK),
    "resident": dict(prefix_cache=True, prefix_block=PREFIX_BLOCK,
                     resident=True, window=RES_WINDOW)}


def prefix_prompts(cfg):
    """Phase 4h's traffic: one PREFIX_LEN-token system prompt drawn from
    the seed, each request's distinct suffix after it."""
    import numpy as np

    rng = np.random.default_rng(24)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    return [prefix + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in PREFIX_SUFFIXES]


def prefix_traffic(eng, prompts, run, wrap=None):
    """Wave 1 (request 0 alone, run to its end), then wave 2 (the other
    requests, submitted together) through one Scheduler on eng, two of
    them sampled. Returns (scheduler, requests, numbers): walls, tokens/s,
    wave 2's TTFT p50 / p99 (`summarize`), serve steps (wave 2's too),
    each request's prefill chunk steps and prefix_len, the cache's
    counters, free pages and peak GB."""
    import torch

    from triton_dist_tpu_torch.serve import Scheduler, summarize

    sch = Scheduler(eng, **RES_GEO, **PREFIX_RUNS[run])
    if wrap is not None:
        sch.worker._fn = wrap(sch.worker._fn)

    def submit(i):
        seed = PREFIX_SAMPLED.get(i)
        return sch.submit(prompts[i], PREFIX_GEN,
                          temperature=0.0 if seed is None else PREFIX_TEMP,
                          seed=seed or 0)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(0)]
    sch.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps1 = sch.counters["steps"]
    reqs += [submit(i) for i in range(1, len(prompts))]
    sch.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wave = summarize(reqs[1:])
    m = sch.metrics()
    tokens = sum(len(r.out_tokens) for r in reqs)
    row = dict(
        wall_s=t2 - t0, wave2_wall_s=t2 - t1, tokens_per_s=tokens / (t2 - t0),
        wave2_tokens_per_s=wave["tokens_per_s"],
        wave2_ttft_p50_ms=wave["ttft_p50_us"] / 1e3,
        wave2_ttft_p99_ms=wave["ttft_p99_us"] / 1e3,
        steps=m["steps"], wave2_steps=m["steps"] - steps1,
        prefill_chunks=[r.n_prefill_chunks for r in reqs],
        wave2_prefill_chunk_steps=sum(r.n_prefill_chunks for r in reqs[1:]),
        prefix_len=[r.prefix_len for r in reqs],
        hits=m["prefix_hits"], misses=m["prefix_misses"],
        pages_shared=m["prefix_pages_shared"], blocks=m["prefix_blocks"],
        free_pages=m["pool_free_pages"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if run == "resident":
        w = sch.worker
        row.update(windows=w.n_windows, windows_by_steps=dict(
            w.windows_by_steps), dead_steps=sum(
            k * v for k, v in w.windows_by_steps.items()) - w.n_steps)
    return sch, reqs, row


def check_prefix_run(sch, reqs, row, run, label):
    """A phase-4h run's own checks: every request answered, the pool's and
    the trie's invariants, and with the cache on, request 0 a miss and
    every wave-2 request a hit of the whole system prompt."""
    if not all(len(r.out_tokens) == PREFIX_GEN and r.finish_reason == "length"
               for r in reqs):
        raise AssertionError(f"{label} {run}: a request was not answered")
    sch.pool.check()
    if sch.prefix is not None:
        sch.prefix.check()
    want = ([0] * len(reqs) if run == "cold"
            else [0] + [PREFIX_LEN] * (len(reqs) - 1))
    if row["prefix_len"] != want:
        raise AssertionError(f"{label} {run}: prefix_len {row['prefix_len']}"
                             f", want {want}")
    hits = (0, 0) if run == "cold" else (len(reqs) - 1, 1)
    if (row["hits"], row["misses"]) != hits:
        raise AssertionError(f"{label} {run}: {row['hits']} hits and "
                             f"{row['misses']} misses, want {hits}")


def run_prefix(kernels, cfg, params, world, mode, label, record=False,
               device="cuda"):
    """Phase 4h at `world` in `mode`: the shared-prompt traffic through
    three Schedulers on one Engine, the cache off (the oracle), on in the
    host loop (replayed steps) and on in the resident loop. Each run goes
    once to capture the graphs its steps need (the resident one records
    its window inputs when `record`), then once timed with every launch
    counted from 0: the host loop's held to its steps, the resident
    loop's to its windows, as phases 4 and 4r hold theirs. Every stream
    of runs 2 and 3, greedy and sampled, is bitwise run 1's. Returns
    ({path: launches}, recorded window inputs, {run: numbers})."""
    from triton_dist_tpu_torch.models import Engine

    eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                 world=world, decode_mode=mode)
    prompts = prefix_prompts(cfg)
    recorded = []

    def recorder(loop):
        rec = RecordingLoop(loop)
        recorded.append(rec)
        return rec

    rows, paths, streams = {}, {}, {}
    tag = f"world{world}" + ("" if world == 1 else f"_{mode}")
    for run in PREFIX_RUNS:
        wrap = recorder if record and run == "resident" else None
        sch, reqs, row0 = prefix_traffic(eng, prompts, run, wrap)
        check_prefix_run(sch, reqs, row0, run, label)
        warm = [r.out_tokens for r in reqs]
        del sch, reqs
        made = eng.serve_graphs.made
        kernels.reset_launches()
        sch, reqs, row = prefix_traffic(eng, prompts, run)
        n = kernels.launches()
        check_prefix_run(sch, reqs, row, run, label)
        streams[run] = [r.out_tokens for r in reqs]
        if streams[run] != warm or streams[run] != streams["cold"]:
            bad = [i for i, (a, b) in enumerate(zip(streams[run],
                                                    streams["cold"]))
                   if a != b]
            raise AssertionError(f"{label} {run}: the streams of requests "
                                 f"{bad} differ from the cold run's (or "
                                 "from their own first run)")
        if run == "resident":
            w = sch.worker
            loop = eng.resident_loops[next(iter(eng.resident_loops))]
            want = {name: 0 for name in kernel_names()}
            for steps, runs in w.windows_by_steps.items():
                if steps not in loop.graphs:
                    raise AssertionError(f"{label}: a window of {steps} steps "
                                         "was captured in the timed run")
                for k, v in resident_window_launches(cfg, world, mode,
                                                     steps).items():
                    want[k] += v * runs
        else:
            if eng.serve_graphs.made != made:
                raise AssertionError(f"{label} {run}: a serve step was "
                                     "captured in the timed run")
            want = want_launches(cfg.num_layers, world, "dist", mode, 0,
                                 sch.worker.n_steps)[1]
        if n != want:
            raise AssertionError(f"{label} {run}: launches {n}, want {want}")
        if run != "cold":
            paths[f"prefix_{run}_{tag}"] = n
        row["launches"] = {k: v for k, v in n.items() if v}
        rows[run] = row
        log(f"  4h {label} {run}: wave 2 TTFT p50 {row['wave2_ttft_p50_ms']:.1f}"
            f" ms, p99 {row['wave2_ttft_p99_ms']:.1f} ms; wave 2 "
            f"{row['wave2_steps']} serve steps, {row['wave2_prefill_chunk_steps']}"
            f" prefill chunk steps ({row['prefill_chunks'][1:]}); all "
            f"{row['steps']} steps, {row['tokens_per_s']:.2f} tokens/s "
            f"({row['wall_s']:.3f} s); hits {row['hits']}, misses "
            f"{row['misses']}, pages shared {row['pages_shared']}, blocks "
            f"{row['blocks']}; free pages {row['free_pages']}; peak "
            f"{row['peak_gb']:.2f} GB"
            + (f"; {row['windows']} windows {row['windows_by_steps']}, "
               f"{row['dead_steps']} dead steps" if run == "resident" else "")
            + f"; launches {row['launches']}; {card_line()}")
        del sch, reqs
    log(f"  4h {label}: the host and resident streams bitwise the cold "
        f"run's ({len(prompts)} requests, {len(PREFIX_SAMPLED)} sampled), "
        f"each wave-2 request a hit of {PREFIX_LEN} tokens")
    inputs = recorded[0].inputs if recorded else []
    del eng, recorded
    gc.collect()
    return paths, inputs, rows


def check_prefix_records(recorded):
    """How many recorded window inputs hold a pending admission with a
    prefix (IR_PREFIX > 0) at their first boundary."""
    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    hits = 0
    for ring, blk in recorded:
        cap = ring.shape[0]
        for i in range(int(blk[kring.H_CONSUMED]),
                       int(blk[kring.H_PUBLISHED])):
            r = ring[i % cap]
            hits += int(r[mring.IR_KIND] == mring.KIND_ADMIT
                        and r[mring.IR_PREFIX] > 0)
    return hits


def run_prefix_phase(kernels, cfg, params):
    """Phase 4h: the prefix cache at Qwen3-8B world 1, full depth (the
    resident run's window inputs recorded), then world 4 `ar` on a
    RES_SMALL_LAYERS-layer draw of the same widths; ring_boundary /
    ring_emit against their plain versions on the recorded windows (the
    wave-2 admissions carry IR_PREFIX = PREFIX_LEN) and on random states
    whose admissions carry prefixes. Returns ({path: launches},
    numbers)."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring
    from triton_dist_tpu_torch.models.dense import init_params

    paths, recorded, rows1 = run_prefix(kernels, cfg, params, 1, "ar",
                                        "Qwen3-8B world 1", record=True)
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=RES_SMALL_LAYERS)
    p4 = init_params(small, device="cuda", seed=1, world=4)
    p, _, rows4 = run_prefix(kernels, small, p4, 4, "ar",
                             f"Qwen3-8B widths, {RES_SMALL_LAYERS} layers, "
                             "world 4 ar")
    paths.update(p)
    del p4
    torch.cuda.empty_cache()
    with_prefix = check_prefix_records(recorded)
    if with_prefix == 0:
        raise AssertionError("4h: no recorded window holds an admission with "
                             "a prefix")
    max_pages = MAX_LEN // RES_GEO["page"]
    cap = max(4 * RES_GEO["slots"], 16)
    geo = kring.WindowGeometry(RES_GEO["slots"], RES_GEO["chunk"], max_pages,
                               RES_WINDOW * RES_GEO["slots"] + cap,
                               RES_WINDOW, 8)
    rw = mring.ring_width(max_pages, MAX_LEN, RES_GEO["chunk"])
    cases = check_ring_kernels(recorded, geo, cap, rw, cfg.vocab_size,
                               n_random=RING_CASES // 4)
    numbers = {"world 1": rows1, "world 4 ar": rows4, "ring_cases": cases,
               "recorded_prefix_admissions": with_prefix}
    log("  4h prefix cache: " + json.dumps(numbers))
    gc.collect()
    torch.cuda.empty_cache()
    return paths, numbers


# -- phase 4v: speculative decoding -------------------------------------------

SPEC_K = 4              # draft tokens a verify row at most
SPEC_LENS = (64, 128)   # prompt lengths drawn from [64, 128]
SPEC_REQS = 8
SPEC_GEN = 48
SPEC_SAMPLED = {2: 2002, 5: 2005}  # request -> seed, at SPEC_TEMP
SPEC_TEMP = 0.8
# the runs: spec off (the oracle), prompt-lookup drafts, and a scripted
# draft that proposes the oracle's next tokens with the one at draft index
# (request mod 5) wrong, so that every acceptance count 0..k occurs
SPEC_DRAFTS = ("off", "ngram", "scripted")


def spec_prompts(cfg):
    """Phase 4v's traffic: SPEC_REQS random prompts of 64-128 tokens."""
    import numpy as np

    rng = np.random.default_rng(25)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(SPEC_LENS[0], SPEC_LENS[1] + 1, SPEC_REQS)]


class ScriptedDraft:
    """A `spec.Draft` that knows each request's spec-off stream: it
    proposes the stream's next k tokens, the one at draft index (request
    mod 5) replaced by another token, so request i's full-width verify
    rows accept min(i mod 5, k) drafts. A request is told by its prompt,
    the head of the history."""

    def __init__(self, prompts, streams, vocab):
        self.prompts = [list(p) for p in prompts]
        self.streams = streams
        self.vocab = vocab

    def propose(self, history, k):
        hist = list(history)
        for i, p in enumerate(self.prompts):
            if hist[:len(p)] == p:
                n_out = len(hist) - len(p)
                nxt = list(self.streams[i][n_out:n_out + k])
                if i % 5 < len(nxt):
                    nxt[i % 5] = (nxt[i % 5] + 1) % self.vocab
                return nxt
        raise AssertionError("a history of no phase-4v request")


def spec_traffic(eng, prompts, draft, resident, oracle=None, wrap=None):
    """One phase-4v run: the SPEC_REQS requests (two sampled) through a
    Scheduler on eng, spec off or SpecConfig(SPEC_K) with `draft`
    ("ngram" or "scripted", which proposes from `oracle`, the spec-off
    streams), host loop or resident windows of RES_WINDOW. Returns
    (scheduler, requests, numbers): wall, tokens/s, serve steps, verify
    steps, proposed, accepted, rate, the accepted count of every verify
    row ({count: rows}), host ms a step (the wall outside the worker's
    device calls over the steps), dead steps, peak GB."""
    import torch

    from triton_dist_tpu_torch.serve import Scheduler
    from triton_dist_tpu_torch.serve import scheduler as smod
    from triton_dist_tpu_torch.spec import NgramDraft, SpecConfig

    spec = None
    if draft == "ngram":
        spec = SpecConfig(k=SPEC_K, draft=NgramDraft())
    elif draft == "scripted":
        spec = SpecConfig(k=SPEC_K, draft=ScriptedDraft(
            prompts, oracle, eng.cfg.vocab_size))
    sch = Scheduler(eng, **RES_GEO, spec=spec, resident=resident,
                    **({"window": RES_WINDOW} if resident else {}))
    w = sch.worker
    if wrap is not None:
        w._fn = wrap(w._fn)
    accepted, device_s = {}, [0.0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                device_s[0] += time.perf_counter() - t0
        return call

    if resident:
        run_window = w.run_window

        def window(*a, **kw):
            recs = run_window(*a, **kw)
            groups = {}
            for r in recs:
                if r.spec and r.emitted:
                    g = groups.setdefault((r.slot, r.step), [0, -1])
                    g[0] = g[0] or r.spec_k
                    g[1] += 1
            for kd, extra in groups.values():
                if kd:
                    accepted[extra] = accepted.get(extra, 0) + 1
            return recs

        w.run_window = timed(window)
    else:
        w._run = timed(w._run)
    orig = smod.accept_tokens

    def accept(proposed, row, eos_id=None, max_emit=None):
        out = orig(proposed, row, eos_id, max_emit)
        if proposed:
            accepted[len(out) - 1] = accepted.get(len(out) - 1, 0) + 1
        return out

    reqs = [sch.submit(p, SPEC_GEN,
                       temperature=SPEC_TEMP if i in SPEC_SAMPLED else 0.0,
                       seed=SPEC_SAMPLED.get(i, 0))
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    smod.accept_tokens = accept
    try:
        t0 = time.perf_counter()
        sch.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        smod.accept_tokens = orig
    m = sch.metrics()
    tokens = sum(len(r.out_tokens) for r in reqs)
    row = dict(
        draft=draft, resident=resident, wall_s=wall,
        tokens_per_s=tokens / wall, steps=w.n_steps,
        verify_steps=sum(r.n_spec_steps for r in reqs),
        proposed=m["spec_proposed"], accepted=m["spec_accepted"],
        accept_rate=m["spec_accept_rate"],
        accepted_counts=dict(sorted(accepted.items())),
        host_ms_a_step=(wall - device_s[0]) * 1e3 / max(w.n_steps, 1),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if resident:
        row.update(windows=w.n_windows, windows_by_steps=dict(
            w.windows_by_steps), dead_steps=sum(
            k * v for k, v in w.windows_by_steps.items()) - w.n_steps)
    return sch, reqs, row


def run_spec(kernels, cfg, params, world, mode, label, record=False,
             device="cuda"):
    """Phase 4v at `world` in `mode`: the SPEC_REQS requests through six
    Schedulers on one Engine, spec off, prompt-lookup drafts and the
    scripted draft, each in the host loop (replayed steps) and in
    resident windows of RES_WINDOW. Each run goes once to capture what it
    needs (the scripted resident run records its window inputs when
    `record`), then once timed with every launch counted from
    0 and held to its steps (host) or windows (resident). Every stream is
    bitwise the host loop's spec-off stream, greedy and sampled; the
    scripted runs accept every count 0..SPEC_K; the pool's invariants
    hold after each run. Returns ({path: launches}, recorded window
    inputs, {run: numbers})."""
    from triton_dist_tpu_torch.models import Engine

    eng = Engine(cfg, device=device, params=params, max_len=MAX_LEN,
                 world=world, decode_mode=mode)
    prompts = spec_prompts(cfg)
    recorded = []

    def recorder(loop):
        rec = RecordingLoop(loop)
        recorded.append(rec)
        return rec

    rows, paths, oracle = {}, {}, None
    tag = f"world{world}" + ("" if world == 1 else f"_{mode}")
    for draft in SPEC_DRAFTS:
        for resident in (False, True):
            run = f"{draft} {'resident' if resident else 'host'}"
            # the scripted run's windows: verify records in every one
            wrap = (recorder if record and resident and draft == "scripted"
                    else None)
            sch, reqs, _ = spec_traffic(eng, prompts, draft, resident,
                                        oracle, wrap)
            warm = [r.out_tokens for r in reqs]
            del sch, reqs
            made = eng.serve_graphs.made
            kernels.reset_launches()
            sch, reqs, row = spec_traffic(eng, prompts, draft, resident,
                                          oracle)
            n = kernels.launches()
            got = [r.out_tokens for r in reqs]
            if oracle is None:
                oracle = got
            if got != warm or got != oracle or not all(
                    len(t) == SPEC_GEN for t in got):
                bad = [i for i, (a, b) in enumerate(zip(got, oracle))
                       if a != b]
                raise AssertionError(f"4v {label} {run}: the streams of "
                                     f"requests {bad} differ from the "
                                     "spec-off host loop's (or from their "
                                     "own first run)")
            sch.pool.check()
            w = sch.worker
            if resident:
                loop = w._fn
                want = {name: 0 for name in kernel_names()}
                for steps, runs in w.windows_by_steps.items():
                    if steps not in loop.graphs:
                        raise AssertionError(f"4v {label} {run}: a window of "
                                             f"{steps} steps was captured in "
                                             "the timed run")
                    for k, v in resident_window_launches(
                            cfg, world, mode, steps).items():
                        want[k] += v * runs
            else:
                if eng.serve_graphs.made != made:
                    raise AssertionError(f"4v {label} {run}: a serve step "
                                         "was captured in the timed run")
                want = want_launches(cfg.num_layers, world, "dist", mode, 0,
                                     w.n_steps)[1]
            if n != want:
                raise AssertionError(f"4v {label} {run}: launches {n}, want "
                                     f"{want}")
            if draft == "scripted" and set(row["accepted_counts"]) != set(
                    range(SPEC_K + 1)):
                raise AssertionError(f"4v {label} {run}: accepted counts "
                                     f"{row['accepted_counts']}, want every "
                                     f"count 0..{SPEC_K}")
            if draft != "off":
                paths[f"spec_{draft}_{'resident' if resident else 'host'}"
                      f"_{tag}"] = n
            row["launches"] = {k: v for k, v in n.items() if v}
            rows[run] = row
            log(f"  4v {label} {run}: {row['tokens_per_s']:.2f} tokens/s "
                f"({row['wall_s']:.3f} s), {row['steps']} serve steps, "
                f"{row['verify_steps']} verify steps; proposed "
                f"{row['proposed']}, accepted {row['accepted']} (rate "
                f"{row['accept_rate']}; rows by accepted count "
                f"{row['accepted_counts']}); host {row['host_ms_a_step']:.3f}"
                f" ms a step"
                + (f"; {row['windows']} windows {row['windows_by_steps']}, "
                   f"{row['dead_steps']} dead steps" if resident else "")
                + f"; peak {row['peak_gb']:.2f} GB; launches "
                f"{row['launches']}; {card_line()}")
            del sch, reqs
    log(f"  4v {label}: every stream bitwise the spec-off host loop's "
        f"({SPEC_REQS} requests, {len(SPEC_SAMPLED)} sampled), host loop and "
        "resident, prompt lookup and scripted drafts")
    inputs = recorded[0].inputs if recorded else []
    del eng, recorded
    gc.collect()
    return paths, inputs, rows


def spec_geometry():
    """The spec resident loop's window geometry and record width at
    phase 4v's Scheduler (RES_GEO, horizon MAX_LEN, windows of
    RES_WINDOW)."""
    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    max_pages = MAX_LEN // RES_GEO["page"]
    cap = max(4 * RES_GEO["slots"], 16)
    K = RES_GEO["slots"]
    geo = kring.WindowGeometry(K, RES_GEO["chunk"], max_pages,
                               RES_WINDOW * K * (1 + SPEC_K) + cap,
                               RES_WINDOW, 8, SPEC_K)
    return geo, cap, mring.ring_width(max_pages, MAX_LEN, RES_GEO["chunk"])


def verify_records(ring_blk):
    """Verify records pending at a recorded window input's first
    boundary."""
    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    ring, blk = ring_blk
    cap = ring.shape[0]
    return sum(int(ring[i % cap][mring.IR_KIND] == mring.KIND_VERIFY)
               for i in range(int(blk[kring.H_CONSUMED]),
                              int(blk[kring.H_PUBLISHED])))


def time_spec_kernels(recorded, geo, rw, vocab):
    """The three kernels at phase 4v's shapes: sample_slots over a verify
    step's K C rows of (V,) logits (two slots sampled, a key a column;
    bound: the logits read once; library: torch.multinomial over the
    softmax of logits / T), the spec ring_boundary on the recorded window
    input with the most verify records pending and the spec ring_emit
    after it on (K, C) tokens that accept every draft (bound: the block
    and the step's buffers once; no library call). Returns ({name: {label:
    row}}, {name: label})."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.kernels import sample as ks
    from triton_dist_tpu_torch.serve import sampling_key

    K, C, V = geo.slots, geo.chunk, vocab
    R = K * C
    logits = rand((R, V), torch.float32, 78, scale=3.0)
    keys = torch.as_tensor(ks.as_int32(np.stack(
        [sampling_key(r // C, r % C) for r in range(R)])), device="cuda")
    temps = torch.tensor([0.8, 0.0, 0.0, 0.8], device="cuda"
                         ).repeat_interleave(C)
    hot = int((temps > 0).sum())
    slabel = (f"a verify step's ({K} x {C}, {V}) f32 logits, a key a column, "
              f"{hot} sampled rows (T 0.8), {R - hot} greedy")
    probs_t = torch.clamp_min(temps, 1e-6)[:, None]
    rows = {"sample_slots": {slabel: time_collective(
        f"sample_slots {slabel}",
        lambda: ks.sample_slots(logits, keys, temps),
        lambda: ks.sample_slots_plain(logits, keys, temps),
        lambda: torch.multinomial(torch.softmax(logits / probs_t, -1), 1),
        hot * V * 10 + R * V, R * V * 4 + R * 12 + R * 8, torch.float32,
        kernel_key="sample_kernel")}}

    ring, blk0 = max(recorded, key=verify_records)
    pending = int(blk0[kring.H_PUBLISHED]) - int(blk0[kring.H_CONSUMED])
    ring_d = torch.as_tensor(ring, device="cuda")
    blk0_d = torch.as_tensor(blk0, device="cuda")
    blk = blk0_d.clone()
    bufs = kring.StepBuffers.create(geo, "cuda")
    ring_h, blk_h = torch.as_tensor(ring), torch.as_tensor(blk0.copy())
    bufs_h = kring.StepBuffers.create(geo, "cpu")
    blabel = (f"a recorded spec window's first boundary: {pending} records "
              f"pending ({verify_records((ring, blk0))} verify), K {K}, C {C}, "
              f"spec_k {geo.spec_k}, record width {rw}")
    b_bytes, e_bytes = resident_bytes(geo, rw, pending)
    b_bytes += K * C * 4  # a key a column
    e_bytes += K * C * 16  # the step's (K, C) tokens and the fed tokens

    def boundary():
        blk.copy_(blk0_d)
        kring.ring_boundary(ring_d, blk, geo, bufs)

    def boundary_plain():
        blk_h.copy_(torch.as_tensor(blk0))
        kring.ring_boundary_plain(ring_h, blk_h, geo, bufs_h)

    boundary()
    after = blk.clone()
    tok = torch.roll(bufs.tokens, -1, 1).contiguous()  # every draft accepted

    def emit():
        blk.copy_(after)
        kring.ring_emit(tok, blk, geo, bufs)

    after_h, tok_h = after.cpu(), tok.cpu()
    boundary_plain()

    def emit_plain():
        blk_h.copy_(after_h)
        kring.ring_emit_plain(tok_h, blk_h, geo, bufs_h)

    rows["ring_boundary"] = {blabel: time_collective(
        f"ring_boundary {blabel}", boundary, boundary_plain, None, 0,
        b_bytes, torch.float32, kernel_key="ring_boundary_kernel")}
    elabel = (f"the verify step after it, K {K}, C {C}, spec_k "
              f"{geo.spec_k}, every draft accepted")
    rows["ring_emit"] = {elabel: time_collective(
        f"ring_emit {elabel}", emit, emit_plain, None, 0, e_bytes,
        torch.float32, kernel_key="ring_emit_kernel")}
    return rows, {"sample_slots": slabel, "ring_boundary": blabel,
                  "ring_emit": elabel}


def run_spec_phase(kernels, cfg, params):
    """Phase 4v: speculative decoding at Qwen3-8B world 1, full depth (the
    scripted resident run's window inputs recorded), then world 4
    `ar` on a RES_SMALL_LAYERS-layer draw of the same widths; the spec
    forms of ring_boundary / ring_emit against their plain versions on
    the recorded windows and RING_CASES random states with fresh and
    stale verify records; sample_slots at a verify step's K C rows and at
    K (SPEC_K + 1) rows against its plain version; the three timed at
    4v's shapes. Returns ({path: launches}, {kernel: {label: row}},
    numbers)."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.models.dense import init_params

    paths, recorded, rows1 = run_spec(kernels, cfg, params, 1, "ar",
                                      "Qwen3-8B world 1", record=True)
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=RES_SMALL_LAYERS)
    p4 = init_params(small, device="cuda", seed=1, world=4)
    p, _, rows4 = run_spec(kernels, small, p4, 4, "ar",
                           f"Qwen3-8B widths, {RES_SMALL_LAYERS} layers, "
                           "world 4 ar")
    paths.update(p)
    del p4
    torch.cuda.empty_cache()
    if not any(verify_records(rb) for rb in recorded):
        raise AssertionError("4v: no recorded window holds a verify record")
    geo, cap, rw = spec_geometry()
    cases = check_ring_kernels(recorded, geo, cap, rw, cfg.vocab_size)
    K, C = RES_GEO["slots"], RES_GEO["chunk"]
    sampled = (check_sample_kernel(cfg.vocab_size, R=K * C, trials=2)
               + check_sample_kernel(cfg.vocab_size, R=K * (SPEC_K + 1)))
    timing, mains = time_spec_kernels(recorded, geo, rw, cfg.vocab_size)
    numbers = {"world 1": rows1, "world 4 ar": rows4, "ring_cases": cases,
               "sample_rows": sampled, "timed": mains}
    log("  4v speculative decoding: " + json.dumps(numbers))
    gc.collect()
    torch.cuda.empty_cache()
    return paths, timing, numbers


SOURCES = {
    "mega": ("triton_dist_tpu_torch/csrc/mega.cu",
             "triton_dist_tpu/mega/kernel.py:1192"),
    "sp_flash_prefill": ("triton_dist_tpu_torch/csrc/flash_prefill.cu",
                         "triton_dist_tpu/kernels/flash_prefill.py:379"),
    "flash_decode_partial": ("triton_dist_tpu_torch/csrc/flash_decode.cu",
                             "triton_dist_tpu/kernels/flash_decode.py:85"),
    "ll_all_gather": ("triton_dist_tpu_torch/csrc/low_latency_allgather.cu",
                      "triton_dist_tpu/kernels/low_latency_allgather.py:72"),
    "ag_gemm": ("triton_dist_tpu_torch/csrc/allgather_gemm.cu",
                "triton_dist_tpu/kernels/allgather_gemm.py:116"),
    "flash_prefill_local": ("triton_dist_tpu_torch/csrc/flash_prefill.cu",
                            "triton_dist_tpu/kernels/flash_prefill.py:231"),
    "one_shot_all_reduce": ("triton_dist_tpu_torch/csrc/allreduce.cu",
                            "triton_dist_tpu/kernels/allreduce.py:75"),
    "ring_all_gather": ("triton_dist_tpu_torch/csrc/allgather.cu",
                        "triton_dist_tpu/kernels/allgather.py:71"),
    "gemm_rs": ("triton_dist_tpu_torch/csrc/gemm_reduce_scatter.cu",
                "triton_dist_tpu/kernels/gemm_reduce_scatter.py:261"),
    "ring_reduce_scatter": ("triton_dist_tpu_torch/csrc/reduce_scatter.cu",
                            "triton_dist_tpu/kernels/reduce_scatter.py:77"),
    "all_to_all": ("triton_dist_tpu_torch/csrc/all_to_all.cu",
                   "triton_dist_tpu/kernels/all_to_all.py:46"),
    "all_to_all_chunked": ("triton_dist_tpu_torch/csrc/all_to_all.cu",
                           "triton_dist_tpu/kernels/all_to_all.py:144"),
    "full_mesh_all_gather": ("triton_dist_tpu_torch/csrc/allgather.cu",
                             "triton_dist_tpu/kernels/allgather.py:116"),
    "p2p_send": ("triton_dist_tpu_torch/csrc/p2p.cu",
                 "triton_dist_tpu/kernels/p2p.py:36"),
    "ring_shift": ("triton_dist_tpu_torch/csrc/p2p.cu",
                   "triton_dist_tpu/kernels/p2p.py:130"),
    "ring_rs_wire": ("triton_dist_tpu_torch/csrc/reduce_scatter.cu",
                     "triton_dist_tpu/kernels/reduce_scatter.py:188"),
    "gemm_rs_wire": ("triton_dist_tpu_torch/csrc/gemm_reduce_scatter.cu",
                     "triton_dist_tpu/kernels/gemm_reduce_scatter.py:152"),
    "ag_gemm_wire": ("triton_dist_tpu_torch/csrc/allgather_gemm.cu",
                     "triton_dist_tpu/kernels/allgather_gemm.py:116"),
    "grouped_gemm_f32": ("triton_dist_tpu_torch/csrc/grouped_gemm.cu",
                         "triton_dist_tpu/kernels/grouped_gemm.py:26"),
    "sample_slots": ("triton_dist_tpu_torch/csrc/sample.cu",
                     "triton_dist_tpu/models/engine.py:84"),
    "ring_boundary": ("triton_dist_tpu_torch/csrc/ring.cu",
                      "triton_dist_tpu/mega/ring.py:387"),
    "ring_emit": ("triton_dist_tpu_torch/csrc/ring.cu",
                  "triton_dist_tpu/models/engine.py:662"),
}


def check_recorded_rs(kernels, records):
    """The ring ReduceScatter against its plain version on the inputs the
    MoE path gave it: bitwise. Returns the max abs error (0)."""
    import torch

    for rec in records:
        x = rec["x"]
        acc = rec.get("accum_dtype")
        got = kernels.ring_reduce_scatter(x, accum_dtype=acc)
        want = kernels.ring_reduce_scatter_plain(x, acc)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"ring_reduce_scatter on the main path's "
                                 f"input {tuple(x.shape)} (forward "
                                 f"{rec['forward']}, layer {rec['layer']}): "
                                 f"not bitwise, max abs err {err}")
    shapes = sorted({tuple(r["x"].shape) for r in records})
    log(f"  ring_reduce_scatter on {len(records)} recorded MoE-path calls, "
        f"shapes {shapes}: bitwise")
    return 0.0


def check_recorded_grouped_gemm(records):
    """grouped_gemm's card route against its loop over experts on the
    inputs the MoE path gave it (gate|up with bf16 out, down with f32
    out; the `dist` prefill, `ar` decode and `dist` scheduler steps, at
    the first and the last layer). Returns the max abs error."""
    err = max(check_grouped_gemm_call(
        r["x"], r["w"], r["sizes"], r["out_dtype"],
        f"recorded x {tuple(r['x'].shape)} out {r['out_dtype']}")
        for r in records)
    shapes = sorted({(tuple(r["x"].shape), tuple(r["w"].shape),
                      str(r["out_dtype"])) for r in records})
    log(f"  grouped_gemm on {len(records)} recorded MoE-path calls, (x, w, "
        f"out dtype) {shapes}: max_abs_err={err:.3e}, within "
        "grouped_gemm_atol")
    return err


def time_moe(kernels, records):
    """The ring ReduceScatter at the `dist` prefill's (4, 512, 2048), a
    `dist` scheduler step's (4, 256, 2048) and the fused prefill's (4,
    4 x FUSED_LEN, 2048), and the grouped ag_gemm at the fused prefill's
    shapes, on inputs the MoE path gave them. RS bound: n chunks read and
    one written a rank (its adds at the f32 rate); library: one sum over
    the rank dim of the chunked input, in ms and device µs; the
    wrapper's host µs by part (rs_extras). Then the ring's tile sweep at
    the first two: each of its tiles forced, bitwise, call ms and device
    µs. Grouped
    ag_gemm bound: the work this run's routing needs, the live (token,
    choice) rows times the gate and up slices of the experts they reach
    (2 x 2 x rows x K x I_loc operations a rank; those experts' B, the
    live A rows and C rows read or written once), not the capacity
    padding the kernel computes; library: one batched matmul of the
    gathered packed blocks against [w_gate | w_up]. Returns {label: row}
    for each, their main labels and the RS tile sweep."""
    import torch

    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    rs_rows, ag_rows, sweep, plan = {}, {}, {}, {}
    for rows, when in ((512, "dist prefill"), (256, "dist scheduler step"),
                       (4 * FUSED_LEN, f"fused prefill 4x{FUSED_LEN}")):
        rec = next(r for r in records["ring_reduce_scatter"]
                   if r["x"].shape[1] == rows)
        x = rec["x"]
        n, nm, w = x.shape
        m = nm // n
        label = f"{when} x {tuple(x.shape)} bf16"
        rs_rows[label] = rs_extras(
            f"ring_reduce_scatter {label}", time_collective(
                f"ring_reduce_scatter {label}",
                lambda x=x: kernels.ring_reduce_scatter(x),
                lambda x=x: kernels.ring_reduce_scatter_plain(x),
                lambda x=x, n=n, m=m, w=w: x.view(n, n, m, w).sum(0),
                n * (n - 1) * m * w,
                (n * nm * w + n * m * w) * x.element_size(), torch.float32,
                kernel_key="ring_rs_kernel"), x, rs_host_parts(kernels, x))
        if rows == 4 * FUSED_LEN:
            continue
        want = kernels.ring_reduce_scatter_plain(x)
        for tile in rs._TILES:
            def fn(x=x, tile=tile):
                return rs._launch(x, x.dtype, tile=tile)
            assert torch.equal(fn(), want), (tuple(x.shape), tile)
            sweep[f"{tuple(x.shape)} tile {tile}"] = dict(
                ms=time_ms(fn), device_us=device_us(fn, "ring_rs_kernel"),
                tiles=rs._ring_plan(m * w, 2, n, tile=tile)[1])
        plan[str(tuple(x.shape))] = rs._ring_plan(m * w, 2, n)[0]
    log("  ring_reduce_scatter tile sweep (bf16, bitwise; call ms / device "
        "us / tiles a rank): " + "; ".join(
            f"{k}: {v['ms']:.4f} / {v['device_us']} / {v['tiles']}"
            for k, v in sweep.items()) + f"; the plan takes {plan}")
    held = {f"{k[0]} n={k[3]} size {k[4]} {str(k[5])[6:]} tiles {k[6]}":
            sum(t.numel() * t.element_size() for t in v)
            for k, v in rs._POOLS.entries.items()}
    log(f"  ring RS persistent pools (slots + flags, bytes; {len(held)} of "
        f"{rs._POOLS.size} entries, {rs._POOLS.made} made): {held}")
    rec = next(r for r in records["ag_gemm"]
               if isinstance(r["b"], tuple) and r["b"][0].dim() == 4)
    a, (wg, wu) = rec["a"], rec["b"]
    kw = {k: rec[k] for k in ("epilogue", "c_order", "counts") if k in rec}
    counts = kw["counts"]  # the fused path passes its packs' counts
    n, m, k = a.shape
    e, i_loc = wg.shape[1], wg.shape[3]
    cap = m // e
    blocks = a.reshape(n, e, cap, k)
    # the live rows: the packs' counts, and the non-zero rows of A agree
    live = blocks.abs().amax(-1) > 0  # (n source ranks, E, cap)
    live_rows = int(live.sum())
    assert live_rows == int(counts.sum()), (live_rows, counts.sum())
    live_e = int((counts > 0).any(0).sum())
    gu = wg.as_strided((n, e, k, 2 * i_loc), wg.stride())  # [gate | up]
    xe = blocks.permute(1, 0, 2, 3).reshape(e, n * cap, k).contiguous()
    label = (f"fused prefill 4x{FUSED_LEN} a {tuple(a.shape)} b 2 x "
             f"{tuple(wg.shape)} (E {e}, cap {cap}; {live_rows} live rows, "
             f"{live_e} experts reached) bf16, counts")
    # bound: each rank's B slices of the experts reached, the live A rows
    # and C, its zero rows included (the function writes them), once
    ag_rows[label] = time_collective(
        f"ag_gemm grouped {label}",
        lambda: kernels.ag_gemm(a, (wg, wu), **kw),
        lambda: kernels.ag_gemm_plain(a, (wg, wu), **kw),
        lambda: torch.matmul(xe[None], gu),
        2 * 2 * n * live_rows * k * i_loc,
        (live_rows * k + n * live_e * k * 2 * i_loc + n * n * m * i_loc)
        * a.element_size(), a.dtype,
        kernel_key="ag_gemm_grouped_wgmma_kernel")
    nocount = {key: v for key, v in kw.items() if key != "counts"}
    # the recorded input with every row live (the mma.sync body) is
    # within the atol too; with counts check_recorded_dist held it
    _, ratio = check_ag_gemm_call(kernels, a, (wg, wu), **nocount)
    log(f"  ag_gemm grouped on the recorded fused-prefill input, every row "
        f"live: at most {ratio:.3f} of its atol")
    # without counts every padded row is live: the mma.sync body's call
    ag_rows[label[:-len(", counts")] + ", every row live"] = time_collective(
        f"ag_gemm grouped {label[:-len(', counts')]}, every row live",
        lambda: kernels.ag_gemm(a, (wg, wu), **nocount),
        lambda: kernels.ag_gemm_plain(a, (wg, wu), **nocount),
        lambda: torch.matmul(xe[None], gu),
        2 * 2 * n * n * m * k * i_loc,
        (n * m * k + n * e * k * 2 * i_loc + n * n * m * i_loc)
        * a.element_size(), a.dtype, kernel_key="ag_gemm_kernel")
    return rs_rows, ag_rows, next(iter(rs_rows)), label, sweep


def time_grouped_f32(records, prefix="", main_rows=32):
    """The grouped f32 product (grouped_gemm_f32) on the inputs a MoE path
    gave it: every recorded f32 call against its plain version
    (grouped_gemm_atol, tail rows zero), then one call of each (rows, K,
    N) timed (the TP-MoE down product: an `ar` decode step's 32 rows a
    rank, a `dist` scheduler step's, the `dist` prefill's; the EP FFN's
    gate|up and down products of every run). Bound: the reached (rank,
    expert) weights, the routed rows of x and all of y once; 2 x rows x K
    x N operations at the bf16 rate. Library: one `torch.bmm(out_dtype=
    float32)` over the padded (rank, expert) blocks, every expert's rows
    padded to the widest group (the product of the port's route before
    the kernel, its gather done before the timing). Labels start with
    `prefix`. Returns ({label: row}, the label of main_rows rows (else
    the first), max abs error)."""
    import torch

    from triton_dist_tpu_torch.kernels import grouped_gemm as gg

    recs = [r for r in records if r["out_dtype"] == torch.float32]
    err = max(check_grouped_gemm_call(
        r["x"], r["w"], r["sizes"], torch.float32,
        f"{prefix}f32 recorded x {tuple(r['x'].shape)}") for r in recs)
    picks = {}
    for r in recs:
        picks.setdefault((r["x"].shape[-2], *r["w"].shape[-2:]), r)
    rows, main = {}, None
    for (t, _, _), r in sorted(picks.items()):
        x, w, sizes = r["x"], r["w"], r["sizes"]
        n, e, k, nn = w.shape
        xs = x.expand(n, *x.shape) if x.dim() == 2 else x
        sz = sizes.to(torch.long).expand(n, e)
        cap = max(int(sz.max()), 1)
        live, reached = int(sz.sum()), int((sz > 0).sum())
        j = torch.arange(cap, device=x.device)
        idx = (torch.cumsum(sz, -1) - sz)[..., None] + j
        idx = torch.where(j < sz[..., None], idx, 0)
        ranks = torch.arange(n, device=x.device)[:, None, None]
        xe = xs[ranks, idx].reshape(n * e, cap, k)
        wb = w.reshape(n * e, k, nn)
        label = (f"{prefix}x {tuple(xs.shape)} w {tuple(w.shape)}, {live} "
                 f"routed rows, {reached} (rank, expert) pairs reached, "
                 f"widest group {cap}")
        rows[label] = time_collective(
            f"grouped_gemm_f32 {label}",
            lambda x=x, w=w, sizes=sizes: gg.grouped_gemm_f32(x, w, sizes),
            lambda x=x, w=w, sizes=sizes: gg.grouped_gemm_f32_plain(
                x, w, sizes),
            lambda xe=xe, wb=wb: torch.bmm(xe, wb, out_dtype=torch.float32),
            2 * live * k * nn,
            reached * k * nn * 2 + live * k * 2 + n * t * nn * 4,
            torch.bfloat16, kernel_key="grouped_f32_kernel")
        if t == main_rows:
            main = label
    return rows, main or next(iter(rows)), err


def entry(name, launches, by_path, err, rows, main_label, **extra):
    source, replaces = SOURCES[name]
    t = rows[main_label]
    blind = [label for label, r in rows.items()
             if "device_us" in r and r["device_us"] is None]
    assert not blind, f"{name}: no device time from the profiler for {blind}"
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                shape=main_label, launches_by_path=by_path, timings=rows,
                **extra)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "triton_dist_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from triton_dist_tpu_torch import kernels
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import flash_prefill as fp
    from triton_dist_tpu_torch.models import ModelConfig, shard_params
    from triton_dist_tpu_torch.models.dense import init_params

    t_start = time.perf_counter()
    log("== 1. environment")
    card = card_line()
    props = torch.cuda.get_device_properties(0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, SMs {props.multi_processor_count}")
    log(f"  nvcc: {nvcc.strip().splitlines()[-1]}")

    log("== 2. build")
    t0 = time.perf_counter()
    kernels.build(kernels.SOURCES.values())
    log(f"  built {sorted(kernels.SOURCES.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            # C7510 / C7518: ptxas serialized a kernel's wgmma
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"  {name}: {line.strip()}")
    # ag_gemm's wgmma bodies (dense, wire and grouped) and gemm_rs's
    # (native and partials) issue no serialized wgmma
    for name in ("allgather_gemm", "gemm_reduce_scatter"):
        serial = [line.strip() for line in _build.build_log.get(
            name, "").splitlines()
            if any(w in line for w in ("C7510", "C7515", "C7518"))]
        assert not serial, f"ptxas serialized {name}'s wgmma: {serial}"
        if name in _build.build_log:
            log(f"  {name}: no C7510 / C7515 / C7518 from ptxas")

    log("== 3. kernels against their plain versions")
    fp_err = check_flash_prefill(fp)
    check_flash_wgmma(fp)
    rs_ratio = check_collectives(kernels)
    check_p2p_kernels(kernels)
    ag_ratio = check_ag_gemm(kernels)
    check_ring_rs(kernels)
    grouped_ratio = check_grouped_ag_gemm(kernels)
    check_grouped_gemm()
    mega_branch_err = max(check_mega_branches(world, paged, depth)
                          for world in (1, 4) for paged in (False, True)
                          for depth in (1, None))

    log("== 4. main path: Qwen3-8B, Engine.serve and Scheduler, world 1, "
        "world 4 (ar), world 4 (default modes: dist prefill, ar decode; "
        "dist scheduler)")
    cfg = ModelConfig.qwen3_8b()
    params = init_params(cfg, device="cuda", seed=0)
    n1, rec1, model1 = run_model(kernels, cfg, params, world=1)
    log("== 4m. the fifth path: the decode megakernel (MegaQwen3) at world 1")
    nm1, mega1 = run_mega(kernels, cfg, params, world=1)
    mega_b1 = mega_batch1(cfg, params)
    log("== 4s. the sixth path: SP long-context attention at Qwen3-8B "
        "widths, world 4, a 32768-position context (layer 0's weights)")
    nsp, sp_errs, sp_numbers = run_sp(kernels, cfg, params)
    log("== 4p. the eighth path: PP at Qwen3-8B full width, 4 stages x 9 "
        "layers of the same draw, 4 microbatches of 1 x 512 tokens")
    npp, (pp_rows, pp_main, pp_errs), pp_numbers = run_pp(kernels, cfg,
                                                          params)
    log("== 4c. the ninth path: the collective library at Qwen3-8B widths, "
        "world 4 (no weights)")
    ncoll, fm_rows, fm_main, fm_err, coll_numbers = run_coll(kernels)
    log("== 4w. the tenth path: the quantized wire at Qwen3-8B widths, world "
        "4 (no weights): fp8, int8, int8 block 128")
    nwire, wire_errs, wire_numbers = run_wire(kernels)
    log("== 4r. the resident serving loop: Qwen3-8B world 1 at full depth, "
        f"windows of {RES_WINDOW} against the host loop; world 4 ar and dist "
        f"at {RES_SMALL_LAYERS} layers; the ring kernels and the sampler "
        "against their plain versions")
    nres, res_errs, res_numbers = run_resident_phase(kernels, cfg, params)
    log("== 4h. the prefix cache: one shared 512-token system prompt, 8 "
        "requests in two waves, the cache off, in the host loop and in the "
        f"resident loop; Qwen3-8B world 1 at full depth, world 4 ar at "
        f"{RES_SMALL_LAYERS} layers")
    nprefix, prefix_numbers = run_prefix_phase(kernels, cfg, params)
    log(f"== 4v. speculative decoding: {SPEC_REQS} requests of 64-128 tokens, "
        f"{SPEC_GEN} new each, spec off, k {SPEC_K} with prompt-lookup "
        "drafts and with a scripted draft, in the host loop and in the "
        f"resident loop; Qwen3-8B world 1 at full depth, world 4 ar at "
        f"{RES_SMALL_LAYERS} layers")
    nspec, spec_timing, spec_numbers = run_spec_phase(kernels, cfg, params)
    # the same weights laid out for 4 ranks; the world-1 engine is gone
    params = shard_params(params, 4)
    torch.cuda.empty_cache()
    n4, rec4, model4 = run_model(kernels, cfg, params, world=4)
    torch.cuda.empty_cache()
    nd, recd, modeld = run_model(kernels, cfg, params, world=4,
                                 prefill_mode="dist", sched_mode="dist")
    log("== 4m. the fifth path at world 4 (default modes' dist prefill)")
    nm4, mega4 = run_mega(kernels, cfg, params, world=4, prefill_mode="dist")
    del params
    torch.cuda.empty_cache()
    check_small_model(world=1)
    check_small_model(world=4)
    check_small_model(world=4, prefill_mode="dist")

    log("== 5. the kernels on the main path's inputs, and timing (bf16)")
    err1, _ = check_recorded_fp(fp, rec1["flash_prefill_local"])
    err4, (busy_rec, busy_inp) = check_recorded_fp(
        fp, rec4["flash_prefill_local"])
    errd, _ = check_recorded_fp(fp, recd["flash_prefill_local"])
    errs = check_recorded_collectives(kernels, rec4)
    errs_dist = check_recorded_dist(kernels, recd)
    b, s = busy_inp["q"].shape[:2]
    busy = (f"world-4 recorded scheduler step {busy_rec['forward']} layer "
            f"{busy_rec['layer']} B=4x4 rank rows S={s} T={MAX_LEN}, Hq=8 "
            f"Hkv=2 a rank, kv_len {busy_inp['kv_len'][:4].tolist()}")
    del rec1
    fp_rows = time_flash_prefill(fp, [(busy, busy_inp)])
    coll_rows, coll_main, ar_extra = time_collectives(kernels, rec4)
    del rec4
    ag_rows, rs_dist_rows, ag_main = time_dist(kernels, recd)
    del recd
    coll_rows["gemm_rs"].update(rs_dist_rows)
    errs["gemm_rs"] = max(errs["gemm_rs"], errs_dist["gemm_rs"])
    torch.cuda.empty_cache()

    log("== 4b. main path, fourth: Qwen3-30B-A3B (TP-MoE) at world 4, "
        "default modes (dist prefill, ar decode), dist scheduler, fused "
        "prefill")
    cfg = ModelConfig.qwen3_30b_a3b()
    free, total = torch.cuda.mem_get_info()
    log(f"  before the draw: {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB")
    params = init_params(cfg, device="cuda", seed=0, world=4)
    torch.cuda.synchronize()
    free, _ = torch.cuda.mem_get_info()
    n_w = sum(p.numel() * p.element_size() for p in params.tensors())
    log(f"  drawn at world 4 on the card: {n_w / 1e9:.2f} GB of weights, "
        f"{free / 1e9:.2f} GB free after")
    nm, recm, modelm = run_model(kernels, cfg, params, world=4,
                                 prefill_mode="dist", sched_mode="dist")
    check_small_model(world=4, prefill_mode="dist", moe=True)
    check_small_model(world=4, prefill_mode="fused", moe=True)

    log("== 5b. the kernels on the fourth path's inputs, and timing (bf16)")
    errm, _ = check_recorded_fp(fp, recm["flash_prefill_local"])
    errs_m = check_recorded_collectives(kernels, recm)
    errs_md = check_recorded_dist(kernels, recm)
    err_rs = check_recorded_rs(kernels, recm["ring_reduce_scatter"])
    modelm["grouped_gemm_max_abs_err"] = check_recorded_grouped_gemm(
        recm["grouped_gemm"])
    gf32_rows, gf32_main, gf32_err = time_grouped_f32(recm["grouped_gemm"])
    moe_rs_rows, moe_ag_rows, rs_main, grouped_main, rs_sweep = time_moe(
        kernels, recm)
    del recm
    torch.cuda.empty_cache()
    log("== 4e. the seventh path: EP MoE (ep_moe_fwd) on layer 0 of the "
        "same Qwen3-30B-A3B weights, world 4, 32 experts a rank")
    nep, ep_errs, ep_numbers = run_ep(kernels, cfg, params)
    del params
    torch.cuda.empty_cache()
    ag_rows.update(moe_ag_rows)
    for name in ("one_shot_all_reduce", "ring_all_gather"):
        errs[name] = max(errs[name], errs_m[name])
    errs["gemm_rs"] = max(errs["gemm_rs"], errs_m["gemm_rs"],
                          errs_md["gemm_rs"])

    # launches: the four main-path runs, each counted from 0
    paths = {"world1": n1, "world4_ar": n4, "world4_dist": nd,
             "world4_moe": nm, "mega_world1": nm1, "mega_world4": nm4,
             "sp_world4": nsp, "ep_world4": nep, "pp_world4": npp,
             "coll_world4": ncoll, "wire_world4": nwire, **nres, **nprefix,
             **nspec}

    def by_path(name):
        return {k: v[name] for k, v in paths.items()}

    def total(name):
        return sum(by_path(name).values())

    def by_body(key):  # each path's serve and Scheduler launches by body
        return {"world1": model1[key], "world4_ar": model4[key],
                "world4_dist": modeld[key], "world4_moe": modelm[key]}

    lines = [entry("flash_prefill_local", total("flash_prefill_local"),
                   by_path("flash_prefill_local"),
                   max(err1, err4, errd, errm), fp_rows, busy,
                   max_abs_err_synthetic=fp_err,
                   launches_by_body=by_body("flash_prefill_by_body"))]
    extras = {"one_shot_all_reduce": ar_extra,
              "ring_all_gather": dict(
                  pool_bytes=ar_extra.pop("ag_pool_bytes"),
                  device_us=coll_rows["ring_all_gather"][
                      coll_main["ring_all_gather"]]["device_us"])}
    for name in ("one_shot_all_reduce", "ring_all_gather", "gemm_rs"):
        lines.append(entry(name, total(name), by_path(name), errs[name],
                           coll_rows[name], coll_main[name],
                           **extras.get(name, {})))
    lines[-1]["atol_ratio_synthetic"] = rs_ratio
    lines[-1]["launches_by_body"] = by_body("gemm_rs_by_body")
    lines.append(entry("ag_gemm", total("ag_gemm"), by_path("ag_gemm"),
                       max(errs_dist["ag_gemm"], errs_md["ag_gemm"]),
                       ag_rows, ag_main, atol_ratio_synthetic=ag_ratio,
                       launches_by_body={
                           "world4_dist": modeld["ag_gemm_by_body"],
                           "world4_moe": modelm["ag_gemm_by_body"],
                           "world4_moe_fused":
                               modelm["fused_ag_gemm_by_body"]},
                       grouped=dict(launches=modelm["grouped_launches"],
                                    shape=grouped_main,
                                    **{k: ag_rows[grouped_main][k] for k in (
                                        "ms", "device_us", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                                    atol_ratio_synthetic=grouped_ratio)))
    lines.append(entry("ring_reduce_scatter", total("ring_reduce_scatter"),
                       by_path("ring_reduce_scatter"), err_rs, moe_rs_rows,
                       rs_main, device_us=moe_rs_rows[rs_main]["device_us"],
                       tile_sweep=rs_sweep))
    mega_rows = {"world 1, batch 4, Qwen3-8B decode step": mega1,
                 "world 4, batch 4, Qwen3-8B decode step": mega4}
    lines.append(entry("mega", total("mega"), by_path("mega"),
                       max(mega1["max_abs_err"], mega4["max_abs_err"]),
                       mega_rows, next(iter(mega_rows)),
                       device_us=mega1["device_us"],
                       max_abs_err_branches=mega_branch_err,
                       batch1_context512=mega_b1))
    gf32_rows.update(ep_numbers.pop("grouped_f32_rows"))
    lines.append(entry("grouped_gemm_f32", total("grouped_gemm_f32"),
                       by_path("grouped_gemm_f32"),
                       max(gf32_err, ep_numbers["ffn_max_abs_err"]),
                       gf32_rows,
                       gf32_main, device_us=gf32_rows[gf32_main]["device_us"],
                       replaces_note="none: XLA's lax.ragged_dot (no Pallas "
                       "kernel); a hand kernel for code the JAX package "
                       "leaves to XLA"))
    for name in SP_KERNELS:
        err, cos, ulp, main_label, rows = sp_errs[name]
        lines.append(entry(name, total(name), by_path(name), err, rows,
                           main_label, band_cos=cos, band_ulp=ulp))
    for name in EP_KERNELS:
        rows, main_label, err = ep_errs[name]
        lines.append(entry(name, total(name), by_path(name), err, rows,
                           main_label,
                           device_us=rows[main_label]["device_us"]))
    lines.append(entry("full_mesh_all_gather", total("full_mesh_all_gather"),
                       by_path("full_mesh_all_gather"), fm_err, fm_rows,
                       fm_main, device_us=fm_rows[fm_main]["device_us"]))
    for name in PP_KERNELS:
        lines.append(entry(name, total(name), by_path(name), pp_errs[name],
                           pp_rows[name], pp_main,
                           device_us=pp_rows[name][pp_main]["device_us"]))
    for name in WIRE_KERNELS:
        rows, main_label, err = wire_errs[name]
        lines.append(entry(name, total(name), by_path(name), err, rows,
                           main_label,
                           device_us=rows[main_label]["device_us"],
                           native_ms=rows[main_label]["native_ms"],
                           **({"launches_by_body": wire_numbers["bodies"][
                               name]} if name in wire_numbers["bodies"]
                              else {})))
    notes = {"sample_slots": "none: XLA's jax.random.categorical under "
             "fold_in(PRNGKey(seed), n_out) keys (no Pallas kernel); a hand "
             "kernel for code the JAX package leaves to XLA",
             "ring_boundary": "none: XLA code of the resident while_loop "
             "(its cond, device_consume, slot_plan); a hand kernel for code "
             "the JAX package leaves to XLA",
             "ring_emit": "none: XLA code of the resident loop body's "
             "epilogue (run_step; run_step_spec with spec_k > 0); a hand "
             "kernel for code the JAX package leaves to XLA"}
    for name in RESIDENT_KERNELS:
        rows, main_label, err = res_errs[name]
        rows = dict(rows, **spec_timing[name])
        lines.append(entry(name, total(name), by_path(name), err, rows,
                           main_label,
                           device_us=rows[main_label]["device_us"],
                           replaces_note=notes[name]))
    missing = set(kernels.KERNELS) - {e["name"] for e in lines}
    assert not missing, f"kernels without a line: {missing}"
    assert all(e["launches"] > 0 for e in lines), "a kernel never launched"
    graphs = {f"{m['model']} world {m['world']} {key}": row
              for m in (model1, model4, modeld, modelm)
              for key, row in m["graphs"].items()}
    graphs.update({f"mega world {w}": row["graphs"]
                   for w, row in ((1, mega1), (4, mega4))})
    keep = ("eager_ms", "replay_ms", "eager_tokens_per_s",
            "replay_tokens_per_s", "capture_s", "pool_bytes",
            "device_kernels_eager", "device_kernels_replay", "peak_gb")
    log("  4g captured steps: " + json.dumps(
        {k: {f: v[f] for f in keep if f in v} for k, v in graphs.items()}))
    log("== 6. summary")
    log(f"  wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"model": [model1, model4, modeld, modelm],
                    "mega": dict(mega_rows, batch1=mega_b1),
                    "sp": sp_numbers, "ep": ep_numbers, "pp": pp_numbers,
                    "coll": coll_numbers, "wire": wire_numbers,
                    "resident": res_numbers, "prefix": prefix_numbers,
                    "spec": spec_numbers}))
    print(json.dumps({"kernels": lines}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

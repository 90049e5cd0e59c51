#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (triton_dist_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, or when run
outside a checkout of the repository. Phases, each fatal on failure:

  1. environment: card name and power limit, torch / CUDA / nvcc
     versions, SM count;
  2. build every kernel of the port from csrc/ with nvcc (in parallel);
  3. each kernel against its plain PyTorch version on the card: edge
     cases, the Qwen3-8B engine-prefill and serve-step shapes and a long
     prefill, in f32 and bf16;
  4. the main path: Qwen3-8B at full width and depth, bf16, random
     weights from a seed, through Engine.serve and the continuous-
     batching Scheduler, with every kernel's launch count read around
     it and the kernel's inputs recorded; then the kernel path's logits
     against the plain attention's, and a small model on the card
     against the CPU reference;
  5. the kernel against its plain version on the inputs recorded in
     phase 4, and its timing there (the busiest scheduler step) and at
     the two synthetic Qwen3-8B shapes, beside its bound, its plain
     version and one PyTorch library call (a yardstick only);
  6. the kernels line (JSON), the card line, and the result line.
"""

from __future__ import annotations

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
            plain_ms=time_ms(lambda: fp.flash_prefill_plain(**inp)),
            bound_ms=bnd, bound_by=by,
            library_ms=time_ms(sdpa_call(inp)),
            gflop=ops / 1e9, mbytes=nbytes / 1e6)
        log(f"  flash_prefill {label}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; {row['gflop']:.2f} GFLOP, "
            f"{row['mbytes']:.2f} MB)")
        rows[label] = row
    return rows


# -- the main path --------------------------------------------------------


def recorder(fp, every: int):
    """Wrap fp.flash_prefill_local so that the first and the last call
    of each run of `every` calls (the first and last layer of one
    forward) keeps a copy of its inputs. Returns (wrapper, records);
    the wrapper calls the kernel's wrapper, which counts the launch."""
    import torch

    kernel_fn = fp.flash_prefill_local
    records = []
    calls = [0]

    def recording(q, k, v, q_positions=None, q_offset=0, kv_len=None,
                  causal=True, scale=None):
        i = calls[0]
        calls[0] += 1
        if i % every in (0, every - 1):
            b, s = q.shape[:2]
            if q_positions is None:
                q_positions = (torch.arange(s, device=q.device)[None]
                               + q_offset).expand(b, s)
            if kv_len is None:
                kv_len = torch.full((b,), k.shape[1], device=q.device)
            records.append(dict(
                forward=i // every, layer=i % every, q=q.clone(),
                k=k.clone(), v=v.clone(),
                q_positions=q_positions.clone().contiguous(),
                kv_len=kv_len.clone(), causal=causal, scale=scale))
        return kernel_fn(q, k, v, q_positions=q_positions,
                         q_offset=q_offset, kv_len=kv_len, causal=causal,
                         scale=scale)

    return recording, records


def check_recorded(fp, records):
    """The kernel against its plain version on the inputs the main path
    gave it. Returns the max abs error and the scheduler step (a record)
    with the most live work, for timing."""
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


def run_model(kernels, cfg, device="cuda"):
    import numpy as np
    import torch

    from triton_dist_tpu_torch.kernels import flash_prefill as fp
    from triton_dist_tpu_torch.models import Engine
    from triton_dist_tpu_torch.serve import Scheduler

    t0 = time.perf_counter()
    eng = Engine(cfg, device=device, seed=0, max_len=MAX_LEN)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in (eng.params.embed, eng.params.lm_head,
                                       *eng.params.layers))
    log(f"  model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    sched_prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                     for n in (100, 300, 180, 250, 120, 211)]
    gen = 16

    # (a) Engine.serve, (b) Scheduler: counts zeroed just before, read
    # just after; the serve-step wrapper below only reads the logits, and
    # the recorder keeps the kernel's inputs of the first and last layer
    # of each multi-token forward (forward 0: Engine.serve's prefill,
    # then one per scheduler step)
    finite = []
    kernel_fn = fp.flash_prefill_local
    fp.flash_prefill_local, records = recorder(fp, cfg.num_layers)

    def watch(fn):
        def step(*a):
            tok, last = fn(*a)
            finite.append(bool(torch.isfinite(last).all()))
            return tok, last
        return step

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(prompts, gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = kernels.launches()
    sch = Scheduler(eng, slots=4, chunk=64, page=64)
    sch.worker._fn = watch(sch.worker._fn)
    reqs = [sch.submit(p, gen) for p in sched_prompts]
    t0 = time.perf_counter()
    sch.run()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    main_launches = kernels.launches()
    fp.flash_prefill_local = kernel_fn
    steps = sch.worker.n_steps

    assert out.shape == (4, gen)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    assert all(len(r.out_tokens) == gen and r.finish_reason == "length"
               for r in reqs), "a scheduler request was not answered"
    assert all(finite), "non-finite serve-step logits"
    n_fp = main_launches["flash_prefill_local"]
    n_fp_serve = serve_launches["flash_prefill_local"]
    # Engine.serve runs one multi-token forward (the prefill); every
    # scheduler step is a (slots, chunk) multi-token forward
    assert n_fp_serve >= cfg.num_layers, n_fp_serve
    assert n_fp - n_fp_serve >= cfg.num_layers * steps, (n_fp, steps)
    m = sch.metrics()
    log(f"  Engine.serve 4x128 +{gen}: {serve_s:.3f} s, tokens "
        f"{out[0, :8].tolist()}...")
    log(f"  Scheduler slots=4 chunk=64 page=64, 6 requests: {steps} steps, "
        f"{sched_s:.3f} s, {m['tokens_per_s']:.2f} tok/s, ttft p50 "
        f"{m['ttft_p50_us'] / 1e3:.1f} ms, evicted {m['evicted']}")
    log(f"  launches on the main path: {main_launches}")

    # timed prefill and decode, outside the counted window
    def prefill():
        return eng.prefill(prompts)

    pre_ms = time_ms(prefill, iters=5, warmup=1)
    logits, cache = prefill()
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(tok, cache, gen - 1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  prefill 4x128: {pre_ms:.3f} ms; decode: {decode_ms:.3f} "
        f"ms/token (batch 4, host clock); peak memory {peak_gb:.2f} GB")

    # the kernel path's logits against the plain attention's, swapped
    # in here and only here; the bound is calibrated in the same run by
    # the drift that a one-ulp bf16 perturbation of every attention
    # output (the size of the kernel's own error) causes through the
    # 36 layers of this random-weight model. The kernel's own evidence
    # is check_recorded above; this bound only shows nothing else on the
    # path (layout, cache, routing) differs. Random weights leave the
    # top logits near-tied, so argmax agreement is printed, not held.
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    noise = torch.Generator(device=device).manual_seed(1)

    def perturbed_plain(*a, **kw):
        out = fp.flash_prefill_plain(*a, **kw)
        sign = torch.randint(0, 2, out.shape, generator=noise,
                             device=out.device) * 2 - 1
        return (out.float() * (1 + sign * 2.0 ** -8)).to(out.dtype)

    fp.flash_prefill_local = fp.flash_prefill_plain
    plain_logits, _ = prefill()
    fp.flash_prefill_local = perturbed_plain
    floor_logits, _ = prefill()
    fp.flash_prefill_local = kernel_fn
    torch.cuda.synchronize()

    def rel(a):
        return ((a - plain_logits).norm() / plain_logits.norm()).item()

    def agree(a):
        return (a.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()

    diff = (logits - plain_logits).abs().max().item()
    top2 = plain_logits.float().topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    log(f"  prefill logits kernel vs plain attention: relative L2 "
        f"{rel(logits):.4e} (one-ulp perturbed plain: "
        f"{rel(floor_logits):.4e}), max abs diff {diff:.4e} of max "
        f"|logit| {plain_logits.abs().max().item():.4e}; argmax agree "
        f"{agree(logits):.2f} (one-ulp perturbed plain: "
        f"{agree(floor_logits):.2f}); plain top-1 minus top-2 logit per "
        f"prompt {[round(x, 4) for x in gap]}")
    model = dict(prefill_ms=pre_ms, decode_ms=decode_ms,
                 tokens_per_s=m["tokens_per_s"], peak_gb=peak_gb,
                 logits_rel_l2=rel(logits),
                 logits_rel_l2_ulp=rel(floor_logits),
                 argmax_agree=agree(logits),
                 argmax_agree_ulp=agree(floor_logits))
    if not model["logits_rel_l2"] <= 2 * model["logits_rel_l2_ulp"]:
        raise AssertionError("kernel path logits drift more than twice the "
                             "one-ulp perturbation's")
    del eng, cache, logits, plain_logits, floor_logits
    torch.cuda.empty_cache()
    return n_fp, records, model


def check_small_model():
    """A small config with head_dim 128 in f32 on the card (the kernel)
    against the same weights on the CPU (the plain versions): logits of
    a prefill and two decode steps within 1e-3, greedy tokens equal."""
    import torch

    from triton_dist_tpu_torch.models import Engine, ModelConfig
    from triton_dist_tpu_torch.models.dense import init_params

    cfg = ModelConfig.tiny(head_dim=128, num_q_heads=8, num_kv_heads=2,
                           max_positions=128)
    params = init_params(cfg, device="cpu", seed=3)
    cpu = Engine(cfg, device="cpu", params=params)
    gpu = Engine(cfg, device="cuda", params=params.to("cuda"))
    ids = torch.randint(0, cfg.vocab_size, (3, 37),
                        generator=torch.Generator().manual_seed(0))
    err = 0.0
    (lc, cc), (lg, cg) = cpu.prefill(ids), gpu.prefill(ids)
    for _ in range(3):
        err = max(err, (lg.cpu() - lc).abs().max().item())
        tok = lc.argmax(-1)
        (lc, cc), (lg, cg) = cpu.decode_step(tok, cc), gpu.decode_step(tok, cg)
    want = cpu.serve(ids, 6).tolist()
    got = gpu.serve(ids, 6).cpu().tolist()
    log(f"  small model (f32, head_dim 128) card vs CPU: max abs logit "
        f"diff {err:.3e}, greedy tokens equal {got == want}")
    assert err <= 1e-3 and got == want


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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    fp_err = check_flash_prefill(fp)

    log("== 4. main path: Qwen3-8B, Engine.serve and Scheduler")
    from triton_dist_tpu_torch.models import ModelConfig

    n_fp, records, model = run_model(kernels, ModelConfig.qwen3_8b())
    check_small_model()

    log("== 5. the kernel on the main path's inputs, and timing (bf16)")
    rec_err, (busy_rec, busy_inp) = check_recorded(fp, records)
    busy = (f"recorded scheduler step {busy_rec['forward']} layer "
            f"{busy_rec['layer']} B=4 S=64 T={MAX_LEN}, kv_len "
            f"{busy_inp['kv_len'].tolist()}")
    del records
    timing = time_flash_prefill(fp, [(busy, busy_inp)])

    main_t = timing[busy]
    entry = dict(
        name="flash_prefill_local", route="cuda",
        source="triton_dist_tpu_torch/csrc/flash_prefill.cu",
        replaces="triton_dist_tpu/kernels/flash_prefill.py:231",
        launches=n_fp, max_abs_err=rec_err, ms=main_t["ms"],
        plain_ms=main_t["plain_ms"], bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"], library_ms=main_t["library_ms"],
        shape=f"bf16 {busy}, Hq=32 Hkv=8 D=128, causal",
        max_abs_err_synthetic=fp_err, timings=timing)
    missing = set(kernels.KERNELS) - {entry["name"]}
    assert not missing, f"kernels without a line: {missing}"
    log("== 6. summary")
    log(json.dumps({"model": model}))
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

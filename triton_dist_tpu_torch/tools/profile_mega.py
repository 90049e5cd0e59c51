"""Where the time of a megakernel decode step goes, branch by branch.

    python -m triton_dist_tpu_torch.tools.profile_mega [--world N]
        [--batch B] [--context T]

At the Qwen3-8B widths a rank sees at world N (bf16, random inputs from
seed 0), builds one graph a branch kind with one task a layer (36), each
compiled and launched alone as the decode step's graph is (csrc/mega.cu):
the four matmuls with their prologues (rms + w_qkv, w_o, rms +
[gate|up], silu + w_down), the attention over a cached prefix of T
positions a sequence, and the allreduce_add. Each kind runs twice: its
36 tasks independent (no edge: tiles of every task may run at once, so
the time is the branch's own rate) and chained (each task waits on the
one before, as in the step: the difference over 36 is the hand-off cost
a task). Then the whole MegaQwen3 step at the same batch and context.
Prints device ms a launch (CUDA events over 10 launches), the bytes each
launch must move and the rate. Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from triton_dist_tpu_torch.mega.builder import ModelBuilder
from triton_dist_tpu_torch.mega.kernel import blocks_per_rank, compile_graph
from triton_dist_tpu_torch.mega.scheduler import (
    schedule_graph,
    validate_schedule,
)
from triton_dist_tpu_torch.models import MegaQwen3, ModelConfig

HBM_BYTES_PER_S = 3.35e12
REPS = 10  # timed launches a measurement, after one warm-up


def _graph(kind, cfg, world, batch, chained):
    """36 tasks of one branch kind, independent or chained."""
    L, H, D = cfg.num_layers, cfg.hidden_size, cfg.head_dim
    hq, hkv = cfg.num_q_heads // world, cfg.num_kv_heads // world
    inter = cfg.intermediate_size // world
    wqkv = (hq + 2 * hkv) * D
    mb = ModelBuilder(batch, world=world)
    width = {"qkv": H, "o": hq * D, "gate_up": H, "down": 2 * inter,
             "attention": wqkv, "allreduce_add": H}[kind]
    x = mb.buffer(width, "x", pinned=True)
    r = mb.buffer(H, "r", pinned=True)
    mb.make_barrier()
    for layer in range(L):
        if kind == "qkv":
            mb.make_rms_matmul("w_qkv", layer, x, H, wqkv, layer, 1e-6)
        elif kind == "o":
            mb.make_matmul("w_o", layer, x, hq * D, H)
        elif kind == "gate_up":
            mb.make_rms_matmul("w_gate_up", layer, x, H, 2 * inter, layer,
                               1e-6)
        elif kind == "down":
            mb.make_act_matmul("w_down", layer, x, inter, H)
        elif kind == "attention":
            mb.make_attention(layer, x, hq, hkv, D, cfg.max_positions, 1e-6,
                              True, q_norm_base=L, k_norm_base=2 * L)
        else:
            mb.make_allreduce_add(x, r, H)
    g = mb.graph
    tasks = [t.id for t in g.tasks if t.op != "barrier"]
    if chained:
        for a, b in zip(tasks, tasks[1:]):
            g._edge(a, b)
    return g


def _inputs(cm, cfg, world, batch, context, device):
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    L, D = cfg.num_layers, cfg.head_dim
    shapes = {}
    for k in cm.branch_keys:
        if k[0] == "matmul":
            shapes[k[1]] = (L, world, k[2], k[3])
    weights = {name: rnd(*s, scale=0.02) for name, s in shapes.items()}
    norms = 1.0 + rnd(3 * L + 1, cm.norm_width, scale=0.1,
                      dtype=torch.float32)
    rope = rnd(cfg.max_positions, D, scale=0.7, dtype=torch.float32)
    pool = (L, cfg.num_kv_heads, batch, cfg.max_positions, D)
    kp, vp = rnd(*pool, scale=0.5), rnd(*pool, scale=0.5)
    table = torch.arange(batch, dtype=torch.int32,
                         device=device).reshape(batch, 1)
    pos = torch.full((batch,), context, dtype=torch.int32, device=device)
    ws = cm.workspace(device)
    ws.normal_(generator=gen)
    return pos, table, ws, weights, norms, rope, kp, vp


def _bytes(cm, kind, cfg, world, batch, context):
    L, D = cfg.num_layers, cfg.head_dim
    n = 0
    for k in cm.branch_keys:
        if k[0] == "matmul":
            n += L * world * k[2] * k[3]
    if kind == "attention":
        n += 2 * L * cfg.num_kv_heads * batch * context * D
    return 2 * n


def _time(fn):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=136)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mega needs a CUDA card")
    dev = torch.device("cuda")
    cfg = ModelConfig.qwen3_8b(max_positions=1024)
    w, b, ctx = args.world, args.batch, args.context
    blocks = blocks_per_rank(dev, w)
    print(f"card {torch.cuda.get_device_name(0)}; Qwen3-8B widths, world {w}"
          f", batch {b}, context {ctx}, {blocks} blocks a rank")
    for kind in ("qkv", "o", "gate_up", "down", "attention",
                 "allreduce_add"):
        row = {}
        for chained in (False, True):
            g = _graph(kind, cfg, w, b, chained)
            sched = schedule_graph(g)
            validate_schedule(g, sched)
            cm = compile_graph(g, sched, torch.bfloat16, blocks=blocks,
                               world=w)
            inp = _inputs(cm, cfg, w, b, ctx, dev)
            row[chained] = _time(lambda: cm.run(*inp))
            nbytes = _bytes(cm, kind, cfg, w, b, ctx)
            del inp
            torch.cuda.empty_cache()
        tiles = int(cm.queue[1, 7])
        print(f"  {kind:14s} 36 tasks of {tiles} tiles: independent "
              f"{row[False]:.4f} ms, chained {row[True]:.4f} ms "
              f"(+{(row[True] - row[False]) / 36 * 1e3:.2f} us a task); "
              f"{nbytes / 1e9:.3f} GB, "
              f"{nbytes / (row[False] * 1e-3) / 1e12:.3f} TB/s independent, "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    mega = MegaQwen3(cfg, world=w, batch=b, s_max=1024, device=dev)
    cache = mega.new_cache()
    cache.length.fill_(ctx)
    tok = torch.zeros(b, dtype=torch.int64, device=dev)
    step = _time(lambda: mega.decode_step(
        tok, cache._replace(length=torch.full_like(cache.length, ctx))))
    print(f"  whole decode step (MegaQwen3): {step:.4f} ms")


if __name__ == "__main__":
    main()

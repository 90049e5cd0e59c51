"""Where the time of a megakernel decode step goes, branch by branch, and
what the weight pipeline does to it.

    python -m triton_dist_tpu_torch.tools.profile_mega [--world N]
        [--batch B] [--context T] [--depths 1,auto] [--kinds qkv,o,
        gate_up,down,attention,allreduce_add] [--no-step] [--json PATH]

At the Qwen3-8B widths a rank sees at world N (bf16, random inputs from
seed 0), builds one graph a branch kind with one task a layer (36), each
compiled and launched alone as the decode step's graph is (csrc/mega.cu):
the four matmuls with their prologues (rms + w_qkv, w_o, rms +
[gate|up], silu + w_down), the attention over a cached prefix of T
positions a sequence, and the allreduce_add. Each kind runs twice: its
36 tasks independent (no edge: tiles of every task may run at once, so
the time is the branch's own rate) and chained (each task waits on the
one before, as in the step: the difference over 36 is the hand-off cost
a task). A matmul kind runs at each prefetch arena depth of --depths
(`schedule_graph(pf_depth=)`; "auto" is auto_pf_depth), its weight
row-major (TMA boxes), and [gate|up] also tile-major
(compile_graph(tiled_weights=), as MegaQwen3 lays it out). Then the
whole MegaQwen3 step at the same batch and context, replayed, with its
gate|up tile-major as MegaQwen3 lays it out and row-major (the queue
recompiled with no tiled weight, the same weights untiled), in the
order tile-major, row-major, row-major, tile-major. Prints device ms a
launch (CUDA events over 10 launches, after one warm-up), the bytes
each launch must move, the rate and the bound at 3.35 TB/s; --json
writes the same rows. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from triton_dist_tpu_torch.mega.builder import ModelBuilder
from triton_dist_tpu_torch.mega.kernel import (
    blocks_per_rank,
    compile_graph,
    tile_weight_major,
)
from triton_dist_tpu_torch.mega.scheduler import (
    schedule_graph,
    validate_schedule,
)
from triton_dist_tpu_torch.models import MegaQwen3, ModelConfig

HBM_BYTES_PER_S = 3.35e12
REPS = 10  # timed launches a measurement, after one warm-up
MATMULS = {"qkv": "w_qkv", "o": "w_o", "gate_up": "w_gate_up",
           "down": "w_down"}


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


def _weights(kind, cfg, world, device):
    """The kind's (L, n, K, N) bf16 weight, drawn once for every variant."""
    if kind not in MATMULS:
        return {}
    H, D = cfg.hidden_size, cfg.head_dim
    hq, hkv = cfg.num_q_heads // world, cfg.num_kv_heads // world
    inter = cfg.intermediate_size // world
    k, n = {"qkv": (H, (hq + 2 * hkv) * D), "o": (hq * D, H),
            "gate_up": (H, 2 * inter), "down": (inter, H)}[kind]
    gen = torch.Generator(device=device).manual_seed(1)
    w = torch.randn((cfg.num_layers, world, k, n), generator=gen,
                    device=device, dtype=torch.bfloat16) * 0.02
    return {MATMULS[kind]: w}


def _inputs(cm, cfg, world, batch, context, device):
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    L, D = cfg.num_layers, cfg.head_dim
    norms = 1.0 + rnd(3 * L + 1, cm.norm_width, scale=0.1,
                      dtype=torch.float32)
    rope = rnd(cfg.max_positions, D, scale=0.7, dtype=torch.float32)
    if cm.attn is not None:
        pool = (L, cfg.num_kv_heads, batch, cfg.max_positions, D)
        kp, vp = rnd(*pool, scale=0.5), rnd(*pool, scale=0.5)
    else:
        kp = vp = torch.zeros((1, 1, 1, 1, D), dtype=torch.bfloat16,
                              device=device)
    table = torch.arange(batch, dtype=torch.int32,
                         device=device).reshape(batch, 1)
    pos = torch.full((batch,), context, dtype=torch.int32, device=device)
    ws = cm.workspace(device)
    ws.normal_(generator=gen)
    return pos, table, ws, norms, rope, kp, vp


def _bytes(kind, weights, cfg, world, batch, context):
    n = sum(w.numel() for w in weights.values())
    if kind == "attention":
        n += 2 * cfg.num_layers * cfg.num_kv_heads * batch * context * \
            cfg.head_dim
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


def _variants(kind, depths):
    """(layout, depth) of each run of a kind."""
    if kind not in MATMULS:
        return [("-", None)]
    out = [("row-major", d) for d in depths]
    if kind == "gate_up":
        out += [("tiled", d) for d in depths]
    return out


def _run_kind(kind, cfg, args, dev, blocks, rows):
    w, b, ctx = args.world, args.batch, args.context
    weights = _weights(kind, cfg, w, dev)
    tiled_w = {}
    nbytes = _bytes(kind, weights, cfg, w, b, ctx)
    for layout, depth in _variants(kind, args.depths):
        res = {}
        for chained in (False, True):
            g = _graph(kind, cfg, w, b, chained)
            sched = schedule_graph(g, pf_depth=depth, blocks=blocks)
            validate_schedule(g, sched)
            tiled = (MATMULS[kind],) if layout == "tiled" else ()
            cm = compile_graph(g, sched, torch.bfloat16, blocks=blocks,
                               world=w, tiled_weights=tiled)
            ws_in = dict(weights)
            for name in tiled:
                if name not in tiled_w:
                    tiled_w[name] = tile_weight_major(weights[name],
                                                      cm.tile_cols(name))
                ws_in[name] = tiled_w[name]
            pos, table, ws, norms, rope, kp, vp = _inputs(cm, cfg, w, b, ctx,
                                                          dev)
            res[chained] = _time(lambda: cm.run(pos, table, ws, ws_in,
                                                norms, rope, kp, vp))
            del ws, kp, vp
        fed, cold = cm.plan_counts()
        ind, chn = res[False], res[True]
        row = dict(kind=kind, layout=layout,
                   depth=cm.pf_depth if kind in MATMULS else None,
                   fed=fed, cold=cold, tiles=int(cm.queue[1, 7]),
                   tile=list(next(iter(cm.mm_tiles.values()), (0, 0))),
                   independent_ms=ind, chained_ms=chn,
                   handoff_us=(chn - ind) / 36 * 1e3, gbytes=nbytes / 1e9,
                   tbps=nbytes / (ind * 1e-3) / 1e12,
                   tbps_chained=nbytes / (chn * 1e-3) / 1e12,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
        print(f"  {kind:13s} {layout:9s} depth {row['depth']} "
              f"({fed} fed, {cold} cold), 36 tasks of {row['tiles']} tiles "
              f"{row['tile']}: independent {ind:.4f} ms, chained "
              f"{chn:.4f} ms (+{row['handoff_us']:.2f} us a task); "
              f"{row['gbytes']:.3f} GB, {row['tbps']:.3f} TB/s independent, "
              f"{row['tbps_chained']:.3f} chained, bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
    del weights, tiled_w
    torch.cuda.empty_cache()


def _untile(w):
    """(L, n, N // tn, K, tn) tile-major -> (L, n, K, N) row-major."""
    L, n, nt, k, tn = w.shape
    return w.permute(0, 1, 3, 2, 4).reshape(L, n, k, nt * tn).contiguous()


def _time_steps(cfg, w, b, ctx, dev):
    """The replayed MegaQwen3 step with gate|up tile-major (as the model
    lays it out) and row-major, in the order tiled, row-major, row-major,
    tiled; one row each."""
    mega = MegaQwen3(cfg, world=w, batch=b, s_max=1024, device=dev)
    tiled_cm, tiled_w = mega.cm, mega._weights["w_gate_up"]
    row_cm = compile_graph(mega.graph, mega.sched, mega.dtype,
                           blocks=tiled_cm.blocks, world=w)
    row_w = _untile(tiled_w)
    cache = mega.new_cache()
    tok = torch.zeros(b, dtype=torch.int64, device=dev)
    steps = []
    for layout in ("tiled", "row-major", "row-major", "tiled"):
        mega.cm, mega._weights["w_gate_up"] = (
            (tiled_cm, tiled_w) if layout == "tiled" else (row_cm, row_w))
        mega.graphs.graphs.clear()  # a capture holds its queue and weights
        ms = _time(lambda: mega.decode_step(
            tok, cache._replace(length=torch.full_like(cache.length, ctx))))
        fed, cold = mega.cm.plan_counts()
        steps.append(dict(gate_up=layout, step_ms=ms, depth=mega.cm.pf_depth,
                          fed=fed, cold=cold))
        print(f"  whole decode step (MegaQwen3, gate|up {layout}, depth "
              f"{mega.cm.pf_depth}, {fed} fed, {cold} cold): {ms:.4f} ms",
              flush=True)
    return steps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=136)
    ap.add_argument("--depths", default="1,auto")
    ap.add_argument("--kinds", default="qkv,o,gate_up,down,attention,"
                    "allreduce_add")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    args.depths = [None if d == "auto" else int(d)
                   for d in args.depths.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("profile_mega needs a CUDA card")
    dev = torch.device("cuda")
    cfg = ModelConfig.qwen3_8b(max_positions=1024)
    w, b, ctx = args.world, args.batch, args.context
    blocks = blocks_per_rank(dev, w)
    print(f"card {torch.cuda.get_device_name(0)}; Qwen3-8B widths, world {w}"
          f", batch {b}, context {ctx}, {blocks} blocks a rank", flush=True)
    rows, steps = [], []
    for kind in args.kinds.split(","):
        _run_kind(kind, cfg, args, dev, blocks, rows)
    if not args.no_step:
        steps = _time_steps(cfg, w, b, ctx, dev)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=torch.cuda.get_device_name(0), world=w,
                           batch=b, context=ctx, branches=rows, steps=steps),
                      f, indent=1)


if __name__ == "__main__":
    main()

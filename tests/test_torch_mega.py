"""The port's megakernel decode (triton_dist_tpu_torch.mega) against the
JAX package's (triton_dist_tpu.mega), on the CPU.

The graph builder, the scheduler's order and the branches are held
against the JAX functions on the same numpy inputs; the JAX megakernel
runs in interpret mode, as its own tests run it (world 1 on a 1-device
`tp` mesh, world 4 under shard_map on 4 of the 12 virtual CPU devices).
On the CPU the port's `run` is its plain version (`run_plain`). The JAX
MegaQwen3 is slow in interpret mode, so one module-scoped fixture per
world runs it once: an Engine prefill, then 4 greedy steps whose logits,
caches and tokens the MegaQwen3 cases reuse. Tiny f32 config; the port
keeps the JAX rounding points, so logits agree to f32 summation order
(1e-4 on logits of magnitude ~1, over two layers), branch outputs and
cache rows to 1e-5."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.mega import builder as jax_builder
from triton_dist_tpu.mega import core as jax_core
from triton_dist_tpu.mega import scheduler as jax_scheduler
from triton_dist_tpu.mega.kernel import compile_graph as jax_compile_graph
from triton_dist_tpu.mega.kernel import tile_weight_major as jax_tile_major
from triton_dist_tpu.mega.qwen3 import MegaKVCache as JaxMegaKVCache
from triton_dist_tpu.mega.qwen3 import MegaQwen3 as JaxMegaQwen3
from triton_dist_tpu.mega.qwen3 import build_qwen3_graph as jax_build_graph
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.mega import builder, core, scheduler
from triton_dist_tpu_torch.mega.kernel import (
    HINT,
    compile_graph,
    tile_weight_major,
)
from triton_dist_tpu_torch.mega.qwen3 import (
    MegaKVCache,
    MegaQwen3,
    PagedMegaKVCache,
    build_qwen3_graph,
)
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax

S_MAX = 32
B, S = 4, 7  # the 2nd step crosses a page edge (PAGE 8)
STEPS = 4
PAGE, TOTAL_PAGES = 8, 14  # a pool smaller than B * S_MAX / PAGE = 16
LOGIT_ATOL = 1e-4
ROW_ATOL = 1e-5


# -- (a)-(c): graph, order, slot plan ---------------------------------------


def _graph_fields(g):
    return ([(t.op, t.branch_key, t.args, t.reads, t.writes, t.buf_args)
             for t in g.tasks], list(g.edges),
            [(b.width, g.pinned[b.id]) for b in g.buffers])


@pytest.mark.parametrize("world", [1, 4])
def test_build_qwen3_graph_matches_jax(world):
    """Task ops, branch keys, args, reads, writes and edges equal the JAX
    builder's, buffer widths and pins too."""
    jg, jmeta = jax_build_graph(JaxModelConfig.tiny(max_positions=S_MAX),
                                B, world, S_MAX)
    tg, tmeta = build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B,
                                  world, S_MAX)
    assert _graph_fields(tg.graph) == _graph_fields(jg.graph)
    assert tmeta["final"].id == jmeta["final"].id
    assert [b.id for b in tmeta["kn_bufs"]] == [b.id for b in
                                               jmeta["kn_bufs"]]
    ops = [t.op for t in tg.graph.tasks]
    assert ops.count("attention") == 2 and ops.count("allreduce_add") == 4
    assert ops.count("barrier") == (world > 1)


def _mlp_graph(mod, world=1):
    """The JAX tests' standalone MLP graph (test_mega_model.py:148)."""
    mb = mod.ModelBuilder(batch=2, world=world)
    x = mb.buffer(128, "x", pinned=True)
    h1 = mb.make_rms_norm(0, x, 128, 1e-6)
    gu = mb.make_matmul("w_gate_up", 0, h1, 128, 512)
    act = mb.make_silu_mul(gu, 256)
    dn = mb.make_matmul("w_down", 0, act, 256, 128)
    out = mb.make_add(dn, x, 128)
    mb.graph.pinned[out.id] = True
    return mb.graph


@pytest.mark.parametrize("which", ["qwen3_w1", "qwen3_w4", "mlp"])
def test_schedule_order_matches_jax_single_core(which):
    if which == "mlp":
        jg, tg = _mlp_graph(jax_builder), _mlp_graph(builder)
    else:
        world = int(which[-1])
        jg = jax_build_graph(JaxModelConfig.tiny(max_positions=S_MAX), B,
                             world, S_MAX)[0].graph
        tg = build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B,
                               world, S_MAX)[0].graph
    js = jax_scheduler.schedule_graph(jg, num_cores=1)
    ts = scheduler.schedule_graph(tg)
    scheduler.validate_schedule(tg, ts)
    assert ts.order == list(js.order)
    assert list(ts.pos[ts.order]) == list(range(len(ts.order)))


def test_schedule_rejects_cycles_and_tracks_war_waw():
    """WAR and WAW edges as the JAX Graph records them, and a cycle
    (an edge added against the order) refused."""
    graphs = []
    for mod in (jax_core, core):
        g = mod.Graph(batch=1)
        a, b = g.buffer(8, "a"), g.buffer(8, "b")
        g.add_task("add", ("add", 8), [0, 0, 1], [a], [b])   # 0: a -> b
        g.add_task("add", ("add", 8), [1, 1, 0], [b], [a])   # 1: WAR on a
        g.add_task("add", ("add", 8), [1, 1, 1], [b], [b])   # 2: WAW on b
        graphs.append(g)
    jg, tg = graphs
    assert tg.edges == jg.edges
    assert (0, 1) in tg.edges and (1, 2) in tg.edges  # RAW/WAR, WAW/WAR
    scheduler.validate_schedule(tg, scheduler.schedule_graph(tg))
    tg._edge(2, 0)
    with pytest.raises(ValueError, match="cycle"):
        scheduler.schedule_graph(tg)


def _reaches(g, a, b):
    succ = {}
    for s, d in g.edges:
        succ.setdefault(s, []).append(d)
    seen, todo = set(), list(succ.get(a, []))
    while todo:
        t = todo.pop()
        if t == b:
            return True
        if t not in seen:
            seen.add(t)
            todo.extend(succ.get(t, []))
    return False


def _assert_slots_ordered(g, sched):
    """Two buffers share a slot only when every task touching one reaches
    the other's defining task along the edges (the kernel's waits)."""
    users = {b.id: [] for b in g.buffers}
    define = {}
    for t in g.tasks:
        for b in t.writes:
            define.setdefault(b, t.id)
            users[b].append(t.id)
        for b in t.reads:
            users[b].append(t.id)
    by_slot = {}
    for b in g.buffers:
        by_slot.setdefault(int(sched.buf_slot[b.id]), []).append(b.id)
    shared = 0
    for bufs in by_slot.values():
        for i, b1 in enumerate(bufs):
            for b2 in bufs[i + 1:]:
                shared += 1
                ok = any(d in define and all(_reaches(g, u, define[d])
                                             for u in users[o])
                         for o, d in ((b1, b2), (b2, b1)))
                assert ok, (b1, b2)
    return shared


@pytest.mark.parametrize("world", [1, 4])
def test_slot_plan_is_ordered_by_waited_edges(world):
    g = build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B, world,
                          S_MAX)[0].graph
    sched = scheduler.schedule_graph(g)
    assert _assert_slots_ordered(g, sched) > 0  # slots are reused
    jsched = jax_scheduler.schedule_graph(
        jax_build_graph(JaxModelConfig.tiny(max_positions=S_MAX), B, world,
                        S_MAX)[0].graph, num_cores=1)
    assert sched.n_slots == jsched.n_slots  # a chain: nothing runs beside


def test_slot_plan_keeps_unordered_buffers_apart():
    """Two branches off x: t0 writes A (never read), t1 writes Bb, t2
    reads Bb and writes C. Neither t1 nor t2 is ordered after t0, so
    neither Bb nor C may take A's slot; the JAX single-core interval
    planner gives Bb A's slot (t0 comes first in the queue)."""
    g = core.Graph(batch=1)
    x = g.buffer(8, "x", pinned=True)
    a, bb, c = g.buffer(8, "A"), g.buffer(8, "Bb"), g.buffer(8, "C")
    g.add_task("add", ("add", 8), [0, 0, 1], [x], [a], cost=3.0)
    g.add_task("add", ("add", 8), [0, 0, 2], [x], [bb], cost=2.0)
    g.add_task("add", ("add", 8), [2, 2, 3], [bb], [c], cost=1.0)
    sched = scheduler.schedule_graph(g)
    scheduler.validate_schedule(g, sched)
    _assert_slots_ordered(g, sched)
    assert sched.buf_slot[a.id] not in (sched.buf_slot[bb.id],
                                        sched.buf_slot[c.id])
    assert sched.order == [0, 1, 2]
    ndef, last = [0, 0, 1, 2], [1, 0, 2, 2]  # in the order t0, t1, t2
    linear, _ = jax_scheduler._py_plan_slots(ndef, last,
                                             [True, False, False, False])
    assert linear[a.id] == linear[bb.id]
    with pytest.raises(AssertionError, match="live at once"):
        scheduler.validate_schedule(g, scheduler.Schedule(
            sched.order, sched.pos, np.asarray(linear), 3))


# -- the weight-prefetch plan and the tile-major layout ----------------------


def _chain_graph(mod, layers=3):
    """The JAX tests' MLP chain (test_mega_core.py:182): norm -> gate_up
    -> silu -> down -> add, repeated."""
    mb = mod.ModelBuilder(batch=2, world=1)
    x = mb.buffer(128, "x", pinned=True)
    h = x
    for layer in range(layers):
        h1 = mb.make_rms_norm(layer, h, 128, 1e-6)
        gu = mb.make_matmul("w_gate_up", layer, h1, 128, 512)
        act = mb.make_silu_mul(gu, 256)
        dn = mb.make_matmul("w_down", layer, act, 256, 128)
        h = mb.make_add(dn, h, 128)
    mb.graph.pinned[h.id] = True
    return mb.graph


def _matmuls_back_to_back(mod, layers=3):
    """Matmuls with no row between them: each one's issuer is the matmul
    before it, the case the planner's single-tile rule decides."""
    mb = mod.ModelBuilder(batch=2, world=1)
    h = mb.buffer(128, "x", pinned=True)
    for layer in range(layers):
        gu = mb.make_matmul("w_up", layer, h, 128, 512)
        h = mb.make_matmul("w_dn", layer, gu, 512, 128)
    mb.graph.pinned[h.id] = True
    return mb.graph


def _plan_graphs(which):
    if which == "mlp":
        return _chain_graph(jax_builder), _chain_graph(builder)
    if which == "back_to_back":
        return (_matmuls_back_to_back(jax_builder),
                _matmuls_back_to_back(builder))
    world = int(which[-1])
    return (jax_build_graph(JaxModelConfig.tiny(max_positions=S_MAX), B,
                            world, S_MAX)[0].graph,
            build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B,
                              world, S_MAX)[0].graph)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("which", ["qwen3_w1", "qwen3_w4", "mlp",
                                   "back_to_back"])
def test_prefetch_plan_matches_jax(which, depth):
    """Given the JAX tile map (as (TN, 1)) and the JAX order, the port's
    plan_prefetch gives the JAX PrefetchPlan array for array: issue code,
    issue layer, issue slot, consume, and the cold list; and it passes
    the port's validator (the CUDA kernel's same-row order)."""
    jg, tg = _plan_graphs(which)
    js = jax_scheduler.schedule_graph(jg, num_cores=1, use_native=False,
                                      pf_depth=depth)
    ts = scheduler.schedule_graph(tg, pf_depth=depth)
    assert ts.order == list(js.order)
    jmap = jax_core.plan_mm_tiles([t.branch_key for t in jg.tasks
                                   if t.op == "matmul"])
    plan = scheduler.plan_prefetch(tg, ts, {k: (tn, 1)
                                            for k, tn in jmap.items()},
                                   depth=depth)
    want = js.prefetch
    for field in ("issue_code", "issue_layer", "issue_slot", "consume"):
        np.testing.assert_array_equal(getattr(plan, field),
                                      getattr(want, field), err_msg=field)
    assert plan.cold == list(want.cold)
    assert [s[:3] for s in plan.specs] == list(want.specs)
    assert plan.depth == want.depth == depth
    ts.prefetch = plan
    scheduler.validate_schedule(tg, ts)


@pytest.mark.parametrize("which", ["qwen3_w1", "qwen3_w4", "mlp",
                                   "back_to_back"])
def test_prefetch_deeper_arena_never_adds_a_cold_consumer(which):
    """As JAX test_mega_core.py:225: a deeper arena only turns cold opens
    into fed ones, on the port's own tile map; every prefetchable matmul
    is fed or cold, never both."""
    _, g = _plan_graphs(which)
    cold = []
    for depth in (1, 2, 3, 4):
        plan = scheduler.schedule_graph(g, pf_depth=depth).prefetch
        cold.append(set(plan.cold))
        fed = set(plan.fed())
        mm = {t.id for t in g.tasks if t.op == "matmul"}
        assert fed | cold[-1] == mm and not fed & cold[-1]
    assert cold[1] <= cold[0] and cold[2] <= cold[1] and cold[3] <= cold[2]


def test_prefetch_plan_tamper_detected():
    """validate_schedule replays the arena, as JAX
    test_prefetch_plan_tamper_detected (test_mega_core.py:239): a fed
    consumer un-flagged, a hint whose stage nobody reads, issues into
    slots never read, a read of an empty slot, a slot refilled before its
    read, or a consumer of the wrong layer all raise."""
    g = _chain_graph(builder)

    def fresh():
        s = scheduler.schedule_graph(g, pf_depth=2)
        scheduler.validate_schedule(g, s)
        return s, s.prefetch, s.prefetch.fed()

    s, plan, fed = fresh()
    assert fed
    plan.consume[fed[0]] = 0  # neither fed nor cold
    with pytest.raises(AssertionError):
        scheduler.validate_schedule(g, s)

    s, plan, fed = fresh()
    plan.consume[fed[-1]] = 0  # the last stage issued is never read
    plan.cold.append(fed[-1])
    with pytest.raises(AssertionError, match="in flight"):
        scheduler.validate_schedule(g, s)

    s, plan, fed = fresh()
    plan.consume[:] = 0  # no stage read: the third issue finds a full slot
    plan.cold = [t.id for t in g.tasks if t.op == "matmul"]
    with pytest.raises(AssertionError, match="unread"):
        scheduler.validate_schedule(g, s)

    s, plan, fed = fresh()
    issuer = s.order[int(s.pos[fed[0]]) - 1]
    plan.issue_code[issuer] = 0  # a read with nothing issued
    with pytest.raises(AssertionError, match="no prefetch"):
        scheduler.validate_schedule(g, s)

    s, plan, fed = fresh()
    issuer = s.order[int(s.pos[fed[2]]) - 1]
    before = s.order[int(s.pos[fed[2]]) - 2]  # issues the same stage first
    for a in (plan.issue_code, plan.issue_layer, plan.issue_slot):
        a[before] = a[issuer]
    with pytest.raises(AssertionError, match="unread"):
        scheduler.validate_schedule(g, s)

    s, plan, fed = fresh()
    plan.issue_layer[s.order[int(s.pos[fed[0]]) - 1]] += 1  # wrong layer
    with pytest.raises(AssertionError, match="holds"):
        scheduler.validate_schedule(g, s)


def test_compile_graph_writes_the_plan_into_the_queue():
    """The queue's hint columns are the plan's; a schedule without a plan
    gets one at compile time (as JAX's compile_graph); a plan made for
    another block count is refused."""
    g = build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B, 4,
                          S_MAX)[0].graph
    s = scheduler.schedule_graph(g, blocks=33)
    cm = compile_graph(g, s, torch.float32, blocks=33, world=4,
                       tiled_weights=("w_gate_up",))
    plan = s.prefetch
    want = np.stack([plan.issue_code, plan.issue_layer, plan.issue_slot,
                     plan.consume], 1)[s.order]
    np.testing.assert_array_equal(cm.queue[:, HINT], want)
    assert cm.plan_counts() == (len(plan.fed()), len(plan.cold))
    assert cm.queue_counts() == cm.plan_counts()
    assert cm.tiled == {"w_gate_up": cm.tile_cols("w_gate_up")}
    bare = scheduler.Schedule(s.order, s.pos, s.buf_slot, s.n_slots)
    again = compile_graph(g, bare, torch.float32, blocks=33, world=4)
    np.testing.assert_array_equal(again.queue, cm.queue)
    with pytest.raises(ValueError, match="tile map"):
        compile_graph(g, s, torch.float32, blocks=1, world=4)
    with pytest.raises(ValueError, match="tiled_weights"):
        compile_graph(g, s, torch.float32, blocks=33, world=4,
                      tiled_weights=("w_gate",))


@pytest.mark.parametrize("world", [1, 4])
def test_queue_counts_follow_the_hint_columns(world):
    """queue_counts reads (fed, cold) back from the queue's hint columns:
    the plan's on the tiny Qwen3 graph, and with two consumers made cold
    (their issuers' hints cleared) two fewer fed and two more cold, on the
    queue as compiled and on a copy of it."""
    g = build_qwen3_graph(ModelConfig.tiny(max_positions=S_MAX), B, world,
                          S_MAX)[0].graph
    s = scheduler.schedule_graph(g, blocks=33)
    cm = compile_graph(g, s, torch.float32, blocks=33, world=world,
                       tiled_weights=("w_gate_up",))
    fed, cold = cm.queue_counts()
    assert (fed, cold) == cm.plan_counts() and fed > 2
    plan = s.prefetch
    for tid in plan.fed()[:2]:
        issuer = s.order[int(s.pos[tid]) - 1]
        plan.issue_code[issuer] = plan.issue_layer[issuer] = 0
        plan.issue_slot[issuer] = plan.consume[tid] = 0
        plan.cold.append(tid)
    scheduler.validate_schedule(g, s)
    cm = compile_graph(g, s, torch.float32, blocks=33, world=world,
                       tiled_weights=("w_gate_up",))
    assert cm.queue_counts() == cm.plan_counts() == (fed - 2, cold + 2)
    assert cm.queue_counts(cm.queue.copy()) == (fed - 2, cold + 2)


@pytest.mark.parametrize("name,value", [
    ("kScratchBytes", core.SCRATCH_BYTES), ("kStageBytes", core.STAGE_BYTES),
    ("kRingStages", core.RING_STAGES), ("kSmemMax", core.SMEM_BYTES),
    ("kMaxDepth", core.MAX_PF_DEPTH)])
def test_core_mirrors_the_kernel_shared_memory(name, value):
    """mega/core.py's shared-memory layout is csrc/mega.cu's, and the
    arena's depth cap is what auto_pf_depth gives (2 slots of 32 KB past
    the scratch and the ring)."""
    import pathlib
    import re

    src = (pathlib.Path(core.__file__).parents[1] / "csrc" /
           "mega.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m and int(m.group(1)) == value, (name, m and m.group(1), value)
    assert scheduler.auto_pf_depth([("w", 4096, 192)]) == core.MAX_PF_DEPTH


@pytest.mark.parametrize("tn", [8, 64, 128])
def test_tile_weight_major_matches_jax(tn):
    """tile_weight_major is the JAX function bitwise: (L, n, K, N) ->
    (L, n, N // tn, K, tn), block [..., j] the column slice j."""
    w = np.random.default_rng(tn).standard_normal((2, 3, 16, 256)).astype(
        np.float32)
    got = tile_weight_major(torch.from_numpy(w), tn)
    want = np.asarray(jax_tile_major(jnp.asarray(w), tn))
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tile_weight_major(torch.from_numpy(w), 96)


@pytest.mark.parametrize("which,world", [("branches", 1),
                                         ("allreduce_add", 4)])
def test_run_plain_tiled_equals_row_major(which, world):
    """run_plain with the gate|up-like weights tile-major (read through
    w_tile_src) is bitwise run_plain with them row-major; a weight in the
    other layout raises."""
    ins = _branch_inputs(which, world)
    g = _branch_graph(builder, which, world)
    sched = scheduler.schedule_graph(g)
    names = sorted({t.branch_key[1] for t in g.tasks if t.op == "matmul"})
    tiled = tuple(n for n in names if "gu" in n)
    rm = compile_graph(g, sched, torch.float32, world=world)
    tl = compile_graph(g, sched, torch.float32, world=world,
                       tiled_weights=tiled)
    t = torch.from_numpy
    w_rm = {k: t(v) for k, v in ins["weights"].items()}
    w_tl = {k: (tile_weight_major(v, tl.tile_cols(k)) if k in tiled else v)
            for k, v in w_rm.items()}
    ws = rm.workspace("cpu")
    ws[:, 0, :, :H] = t(ins["x"][..., :H])
    norms = t(ins["norms"][:, :rm.norm_width]).contiguous()
    rest = (norms, t(ins["rope"]), t(ins["k"]), t(ins["v"]))
    consts = (t(ins["pos"]), t(ins["table"]))
    want = rm.run_plain(*consts, ws.clone(), w_rm, *rest)
    got = tl.run_plain(*consts, ws.clone(), w_tl, *rest)
    assert torch.equal(got, want)
    if tiled:
        with pytest.raises(ValueError, match="tile-major"):
            tl.run_plain(*consts, ws.clone(), w_rm, *rest)
        with pytest.raises(ValueError, match="row-major"):
            rm.run_plain(*consts, ws.clone(), w_tl, *rest)


def test_mega_qwen3_strips_split_weights_not_the_callers():
    """MegaQwen3 lays [gate|up] out tile-major at the kernel's tile width
    and drops w_gate / w_up from its own params; the params object the
    caller passed keeps them (an Engine shares it)."""
    cfg = ModelConfig.tiny(max_positions=S_MAX)
    from triton_dist_tpu_torch.models import init_params

    params = init_params(cfg, "cpu", seed=3)
    mega = MegaQwen3(cfg, batch=B, s_max=S_MAX, params=params, device="cpu")
    assert params.layers.w_gate is not None and params.layers.w_up is not None
    assert mega.params.layers.w_gate is None and mega.params.layers.w_up is None
    tn = mega.cm.tile_cols("w_gate_up")
    gu = mega._weights["w_gate_up"]
    assert mega.cm.tiled == {"w_gate_up": tn}
    assert gu.dim() == 5 and gu.shape[-1] == tn
    fused = torch.cat([params.layers.w_gate, params.layers.w_up], -1)
    assert torch.equal(gu, tile_weight_major(fused, tn))


# -- (d): each branch against a JAX standalone graph ------------------------

H, INTER, HQ, HKV, D = 128, 256, 4, 2, 32


def _branch_graph(mod, which, world):
    """The same graph through either package's ModelBuilder, every buffer
    pinned so each branch keeps its output."""
    mb = mod.ModelBuilder(batch=B, world=world)
    x = mb.buffer((HQ + 2 * HKV) * D if which == "paged_attention" else H,
                  "x", pinned=True)
    if which == "branches":  # every branch of world 1, dense attention
        h1 = mb.make_rms_norm(0, x, H, 1e-6)
        gu = mb.make_matmul("w_gu", 0, h1, H, 2 * INTER)
        act = mb.make_silu_mul(gu, INTER)
        dn = mb.make_matmul("w_dn", 0, act, INTER, H)
        s = mb.make_add(dn, x, H)
        qkv = mb.make_rms_matmul("w_qkv", 0, s, H, (HQ + 2 * HKV) * D, 1,
                                 1e-6)
        attn, _, _ = mb.make_attention(0, qkv, HQ, HKV, D, S_MAX, 1e-6,
                                       True, q_norm_base=3, k_norm_base=4)
        o = mb.make_matmul("w_o", 0, attn, HQ * D, H)
        x2 = mb.make_allreduce_add(o, s, H)
        gu2 = mb.make_rms_matmul("w_gu2", 0, x2, H, 2 * INTER, 2, 1e-6)
        mb.make_act_matmul("w_dn2", 0, gu2, INTER, H)
    elif which == "paged_attention":
        mb.make_attention(0, x, HQ, HKV, D, S_MAX, 1e-6, True,
                          q_norm_base=3, k_norm_base=4, page=PAGE)
    else:  # allreduce_add at n = 4: x the partial, r the residual
        r = mb.buffer(H, "r", pinned=True)
        mb.make_barrier()
        mb.make_allreduce_add(x, r, H)
    for b in mb.graph.buffers:
        mb.graph.pinned[b.id] = True
    return mb.graph


def _branch_inputs(which, world, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x_w = (HQ + 2 * HKV) * D if which == "paged_attention" else H
    ins = dict(
        x=r(world, B, x_w), res=r(world, B, H),
        weights={"w_gu": r(1, world, H, 2 * INTER, scale=0.05),
                 "w_dn": r(1, world, INTER, H, scale=0.05),
                 "w_qkv": r(1, world, H, (HQ + 2 * HKV) * D, scale=0.05),
                 "w_o": r(1, world, HQ * D, H, scale=0.05),
                 "w_gu2": r(1, world, H, 2 * INTER, scale=0.05),
                 "w_dn2": r(1, world, INTER, H, scale=0.05)},
        norms=1.0 + r(5, H, scale=0.1), rope=r(S_MAX + 1, D, scale=0.7),
        pos=np.array([0, 5, 31, 17], np.int32))
    if which == "paged_attention":
        maxp = S_MAX // PAGE
        pages = B * maxp + 4
        ins["table"] = (rng.permutation(pages - 1)[:B * maxp] + 1
                        ).reshape(B, maxp).astype(np.int32)
        pool = (1, HKV * world, pages, PAGE, D)
    else:
        ins["table"] = np.arange(B, dtype=np.int32).reshape(B, 1)
        pool = (1, HKV * world, B, S_MAX, D)
    ins["k"], ins["v"] = r(*pool, scale=0.5), r(*pool, scale=0.5)
    return ins


def _run_jax_branches(which, world, ins):
    g = _branch_graph(jax_builder, which, world)
    sched = jax_scheduler.schedule_graph(g, num_cores=1)
    cm = jax_compile_graph(g, sched, jnp.float32,
                           name=f"mega_port_{which}{world}")
    pb = cm.pb
    ws = np.zeros((world, cm.n_slots * pb, cm.wmax), np.float32)
    for name, key in (("x", "x"), ("r", "res")):
        for b in g.buffers:
            if b.name == name:
                s = int(sched.buf_slot[b.id]) * pb
                ws[:, s:s + B, :b.width] = ins[key][..., :b.width]
    norms = np.zeros((5, cm.norm_width), np.float32)
    norms[:, :H] = ins["norms"]
    consts = (jnp.asarray(ins["pos"]), jnp.asarray(ins["table"]))
    tail = (jnp.repeat(jnp.asarray(norms), 8, 0),
            jnp.repeat(jnp.asarray(ins["rope"]), 8, 0))
    if world == 1:
        w = {k: jnp.asarray(v[:, 0]) for k, v in ins["weights"].items()
             if k in cm.weight_names}
        out = jax.jit(lambda ws: cm.run(*consts, ws, w, *tail,
                                        jnp.asarray(ins["k"]),
                                        jnp.asarray(ins["v"])))(
            jnp.asarray(ws[0]))[None]
    else:
        mesh = make_mesh(mesh_shape=(world,), axis_names=("tp",))
        kv = jnp.zeros((1, 1, B, 8, 128), jnp.float32)
        fn = jax.shard_map(
            lambda ws: cm.run(*consts, ws, {}, *tail, kv, kv), mesh=mesh,
            in_specs=P("tp"), out_specs=P("tp"), check_vma=False)
        out = jax.jit(fn)(jnp.asarray(ws.reshape(-1, cm.wmax)))
        out = out.reshape(world, -1, cm.wmax)
    out = np.asarray(out)
    return {b.name: out[:, int(sched.buf_slot[b.id]) * pb:][:, :B, :b.width]
            for b in g.buffers}


def _run_port_branches(which, world, ins):
    g = _branch_graph(builder, which, world)
    sched = scheduler.schedule_graph(g)
    scheduler.validate_schedule(g, sched)
    cm = compile_graph(g, sched, torch.float32, world=world)
    ws = cm.workspace("cpu")
    for name, key in (("x", "x"), ("r", "res")):
        for b in g.buffers:
            if b.name == name:
                ws[:, int(sched.buf_slot[b.id]), :, :b.width] = \
                    torch.from_numpy(ins[key][..., :b.width])
    norms = torch.from_numpy(ins["norms"][:, :cm.norm_width]).contiguous()
    t = torch.from_numpy
    out = cm.run(t(ins["pos"]), t(ins["table"]), ws,
                 {k: t(v) for k, v in ins["weights"].items()}, norms,
                 t(ins["rope"]), t(ins["k"]), t(ins["v"]))
    return {b.name: out[:, int(sched.buf_slot[b.id]), :, :b.width].numpy()
            for b in g.buffers}, cm


@pytest.mark.parametrize("which,world", [("branches", 1),
                                         ("paged_attention", 1),
                                         ("allreduce_add", 4)])
def test_branches_match_jax_standalone_graph(which, world):
    """matmul with none / rms / silu prologue, rms_norm, silu_mul, add,
    allreduce_add (n = 1 and n = 4) and attention (dense, and paged
    through a shuffled page table) against the JAX kernel's branches:
    every buffer of the graph within 1e-5 (f32)."""
    ins = _branch_inputs(which, world)
    want = _run_jax_branches(which, world, ins)
    got, cm = _run_port_branches(which, world, ins)
    ops = {k[0] for k in cm.branch_keys}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=ROW_ATOL, err_msg=name)
    if which == "branches":
        assert ops == {"rms_norm", "matmul", "silu_mul", "add",
                       "attention", "allreduce_add"}
        assert {k[4] for k in cm.branch_keys if k[0] == "matmul"} == {
            None, "rms", "silu"}
    elif which == "allreduce_add":
        assert ops == {"barrier", "allreduce_add"}


@pytest.mark.parametrize("world,page", [(1, 0), (4, PAGE)])
def test_branch_graph_holds_every_branch(world, page):
    """builder.branch_graph, the graph the card checks hold the kernel
    against run_plain on: every branch once (the barrier at world > 1),
    the three matmul prologues, every buffer in a slot of its own."""
    g = builder.branch_graph(world, B, H, INTER, HQ, HKV, D, S_MAX, page)
    ops = [t.op for t in g.tasks]
    want = {"rms_norm", "matmul", "silu_mul", "add", "attention",
            "allreduce_add"} | ({"barrier"} if world > 1 else set())
    assert set(ops) == want and ops.count("barrier") == (world > 1)
    assert sorted(str(t.branch_key[4]) for t in g.tasks
                  if t.op == "matmul") == sorted(
        ["None", "None", "None", "rms", "rms", "silu"])
    assert [t.branch_key[-1] for t in g.tasks if t.op == "attention"] == [
        page]
    sched = scheduler.schedule_graph(g)
    scheduler.validate_schedule(g, sched)
    slots = [int(sched.buf_slot[b.id]) for b in g.buffers]
    assert all(g.pinned[b.id] for b in g.buffers)
    assert len(set(slots)) == len(slots)
    assert slots[0] == 0 and g.buffers[0].name == "x"


# -- (e)-(h): MegaQwen3 against the JAX MegaQwen3 ----------------------------


def _jax_run(world):
    """The JAX Engine prefill (xla mode) of B x S prompts, then STEPS
    greedy steps of the JAX MegaQwen3 (dense; at world 1 also a paged one
    from the same prefill for two steps)."""
    cfg = JaxModelConfig.tiny(max_positions=S_MAX)
    mesh = make_mesh(mesh_shape=(world,), axis_names=("tp",))
    eng = JaxEngine(cfg, mesh, prefill_mode="xla", decode_mode="xla",
                    donate_cache=False, max_len=S_MAX)
    mega = JaxMegaQwen3(cfg, mesh, batch=B, s_max=S_MAX, params=eng.params,
                        donate_cache=False)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = eng.prefill(prompt)
    run = types.SimpleNamespace(
        params=jax.tree.map(np.asarray, eng.params), prompt=prompt,
        prefill_tok=np.asarray(jnp.argmax(logits, -1)).astype(np.int32),
        tokens=[], logits=[], k=[], v=[], length=[])
    mc = JaxMegaKVCache.from_dense(cache, s_max=S_MAX)
    tok = jnp.asarray(run.prefill_tok)
    for _ in range(STEPS):
        lm, mc = mega.decode_step(tok, mc)
        run.tokens.append(np.asarray(tok))
        run.logits.append(np.asarray(lm))
        run.k.append(np.asarray(mc.k))
        run.v.append(np.asarray(mc.v))
        run.length.append(np.asarray(mc.length))
        tok = jnp.argmax(lm, -1).astype(jnp.int32)
    run.tokens.append(np.asarray(tok))
    if world == 1:
        pm = JaxMegaQwen3(cfg, mesh, batch=B, s_max=S_MAX,
                          params=eng.params, donate_cache=False, paged=True,
                          page_size=PAGE, total_pages=TOTAL_PAGES)
        pc = pm.paged_cache_from_dense(cache)
        run.paged0 = (np.asarray(pc.table), int(pc.next_free))
        run.paged = []
        for i in range(2):
            lp, pc = pm.decode_step(jnp.asarray(run.tokens[i]), pc)
            run.paged.append((np.asarray(lp), np.asarray(pc.table),
                              int(pc.next_free)))
    return run


@pytest.fixture(scope="module")
def jax_w1():
    return _jax_run(1)


@pytest.fixture(scope="module")
def jax_w4():
    return _jax_run(4)


def _port(run, world, **kw):
    """The port's Engine and MegaQwen3 on the JAX weights, and the
    Engine's prefill cache of the same prompts."""
    cfg = ModelConfig.tiny(max_positions=S_MAX)
    params = params_from_jax(run.params, device="cpu")
    eng = Engine(cfg, device="cpu", params=params, world=world,
                 max_len=S_MAX, prefill_mode="xla")
    mega = MegaQwen3(cfg, world=world, batch=B, s_max=S_MAX, params=params,
                     device="cpu", **kw)
    logits, cache = eng.prefill(run.prompt)
    return eng, mega, logits, cache


def _clone(cache):
    return type(cache)(*(t.clone() for t in cache))


@pytest.mark.parametrize("world", [1, 4])
def test_mega_decode_step_matches_jax(world, jax_w1, jax_w4):
    """Three steps on the JAX run's tokens: logits within 1e-4, lengths
    equal, and the k/v rows each step writes within 1e-5."""
    run = jax_w1 if world == 1 else jax_w4
    _, mega, _, cache = _port(run, world)
    assert mega._weights["w_gate_up"].dim() == 5  # tile-major
    mc = MegaKVCache.from_dense(cache, s_max=S_MAX)
    assert mc.k.shape == run.k[0].shape
    for step in range(3):
        logits, mc = mega.decode_step(run.tokens[step], mc)
        np.testing.assert_allclose(logits.numpy(), run.logits[step], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(mc.length.numpy(), run.length[step])
        at = run.length[step] - 1  # the row this step wrote, per sequence
        for got, want in ((mc.k, run.k[step]), (mc.v, run.v[step])):
            rows = got.numpy()[:, :, np.arange(B), at]
            np.testing.assert_allclose(rows, want[:, :, np.arange(B), at],
                                       rtol=0, atol=ROW_ATOL)


@pytest.mark.parametrize("world", [1, 4])
def test_mega_greedy_matches_jax_and_engine(world, jax_w1, jax_w4):
    """Greedy tokens over STEPS steps: the port's MegaQwen3 feeding its
    own argmax, the JAX MegaQwen3's, and the port Engine's decode."""
    run = jax_w1 if world == 1 else jax_w4
    eng, mega, logits, cache = _port(run, world)
    mc = MegaKVCache.from_dense(cache, s_max=S_MAX)
    tok = logits.argmax(-1)
    assert tok.tolist() == run.prefill_tok.tolist()
    t_mega = t_eng = tok
    for step in range(STEPS):
        lm, mc = mega.decode_step(t_mega, mc)
        le, cache = eng.decode_step(t_eng, cache)
        t_mega, t_eng = lm.argmax(-1), le.argmax(-1)
        assert t_mega.tolist() == run.tokens[step + 1].tolist(), step
        assert t_eng.tolist() == t_mega.tolist(), step


@pytest.mark.parametrize("world", [1, 4])
def test_decode_resident_bitwise_equals_steps(world, jax_w1, jax_w4):
    run = jax_w1 if world == 1 else jax_w4
    _, mega, logits, cache = _port(run, world)
    start = MegaKVCache.from_dense(cache, s_max=S_MAX)
    tok0 = logits.argmax(-1)
    mc, tok, ids = _clone(start), tok0, []
    for _ in range(STEPS):
        lm, mc = mega.decode_step(tok, mc)
        tok = lm.argmax(-1)
        ids.append(tok)
    got, rc = mega.decode_resident(tok0, _clone(start), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    assert torch.equal(got.long(), torch.stack(ids, 1))
    for a, b in zip(rc, mc):
        assert torch.equal(a, b)


def test_paged_cache_matches_jax_and_dense(jax_w1):
    """PagedMegaKVCache.from_dense's table and next_free equal the JAX
    ones, and after two steps (which allocate pages) so do the bump
    allocator's; paged logits equal the dense cache's."""
    run = jax_w1
    _, mega, _, cache = _port(run, 1, paged=True, page_size=PAGE,
                              total_pages=TOTAL_PAGES)
    pc = mega.paged_cache_from_dense(cache)
    assert isinstance(pc, PagedMegaKVCache)
    np.testing.assert_array_equal(pc.table.numpy(), run.paged0[0])
    assert int(pc.next_free) == run.paged0[1]
    dense_mega = _port(run, 1)[1]
    mc = MegaKVCache.from_dense(cache, s_max=S_MAX)
    for step in range(2):
        lp, pc = mega.decode_step(run.tokens[step], pc)
        ld, mc = dense_mega.decode_step(run.tokens[step], mc)
        want_logits, want_table, want_free = run.paged[step]
        np.testing.assert_array_equal(pc.table.numpy(), want_table)
        assert int(pc.next_free) == want_free
        np.testing.assert_allclose(lp.numpy(), want_logits, rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=0,
                                   atol=1e-6)
    fresh = mega.new_paged_cache()
    assert fresh.k.shape == (2, 8, TOTAL_PAGES, PAGE, 32)
    assert int(fresh.next_free) == 0


def test_mega_qwen3_without_device_raises_on_cpu_only_machine():
    """The entry point runs on the card unless asked for the CPU: with no
    card and no device it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MegaQwen3(ModelConfig.tiny(max_positions=S_MAX), batch=B)

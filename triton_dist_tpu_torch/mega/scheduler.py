"""Megakernel scheduler: task order, workspace slot plan and weight-prefetch
plan — port of the Python path of triton_dist_tpu.mega.scheduler.

`schedule_graph` is the JAX function at num_cores=1 (scheduler.py:666,
its `_py_schedule`): critical-path list scheduling into one topological
queue, the order every block of the CUDA kernel walks. The costs are the
port's byte counts (builder.py), so a graph with independent branches may
order them otherwise than the JAX perf model does; the Qwen3 graph is a
chain and orders identically.

The slot plan is the JAX happens-before planner (`_py_plan_slots_hb`,
`_buffer_users`, `_validate_slots_hb`, scheduler.py:291-350, :874), with
the happens-before relation of the CUDA kernel: tiles of many tasks run
at once on a rank's blocks, and a tile starts only after every tile of
each of its task's producers has finished (csrc/mega.cu). So a task
starts after another completes exactly when a path of graph edges leads
from one to the other — program order alone orders nothing. A slot is
reused only when every task touching its previous tenant reaches the new
tenant's defining task along those edges; the JAX single-core interval
planner (`_py_plan_slots`) would let a late reader of the old tenant
race the new writer here.

The weight-prefetch plan is the JAX one (`PrefetchPlan`,
`prefetch_specs`, `plan_prefetch`, `_validate_prefetch`, `auto_pf_depth`,
scheduler.py:43-540): each prefetchable matmul (the consumer) gets a
rotating arena slot k % depth and the row just before it in the queue
(the issuer), which starts the consumer's first weight stage into that
slot; a consumer with no legal issuer opens cold and is listed in `cold`.
The tile map is an argument, (tile cols, K splits) per matmul key: the
port's `plan_mm_tiles` fills the card's blocks, the JAX one budgets VMEM,
and handed the JAX map (as (TN, 1)) this planner gives the JAX plan. The
arena lives in the shared memory of each block of csrc/mega.cu, so
`auto_pf_depth` budgets what the branches leave of it.

Not ported (ROADMAP.md): the native scheduler (`csrc/scheduler.cc`),
multi-queue schedules, watermarks and `predicted_stalls`, and the
store/forward plan (`plan_store_forward`): every task of the CUDA kernel
runs on all blocks at once and a consumer tile reads the whole input row
that every block wrote, so a store left in flight by one block has no
CUDA form yet.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from triton_dist_tpu_torch.mega.core import (
    ARENA_BYTES,
    H100_SMS,
    STAGE_BYTES,
    Graph,
    plan_mm_tiles,
)

TileMap = Dict[Hashable, Tuple[int, int]]  # matmul key -> (tile cols, splits)


def auto_pf_depth(specs) -> int:
    """The arena depth: as many slots of one weight stage
    (core.STAGE_BYTES) as the block's shared memory holds past the
    branches' scratch and the matmul ring (core.ARENA_BYTES), clamped to
    [2, 4] as in JAX (scheduler.py:43): two keep a stage in flight across
    every task boundary, four bound the plan's churn. A graph with no
    prefetchable weight takes 2."""
    if not specs:
        return 2
    return max(2, min(4, ARENA_BYTES // STAGE_BYTES))


@dataclasses.dataclass
class PrefetchPlan:
    """The cross-task weight-streaming plan (JAX scheduler.py:63): each
    prefetchable matmul (a consumer) is given a rotating arena slot and
    the queue row before it (its issuer), which starts the consumer's
    first weight stage into that slot. depth = arena slots. Consumers with
    no legal issuer open cold and are listed in `cold`; validate_schedule
    holds every consumer to exactly one of the two. `tiles` is the tile
    map the plan was made on."""

    depth: int
    specs: List[Tuple[str, int, int, int]]  # [(wname, K, TN, splits)]
    issue_code: np.ndarray                  # (n_tasks,) 0 = no hint
    issue_layer: np.ndarray
    issue_slot: np.ndarray
    consume: np.ndarray                     # (n_tasks,) slot + 1, 0 = cold
    cold: List[int]                         # consumer task ids opening cold
    tiles: TileMap = dataclasses.field(default_factory=dict, repr=False)

    def fed(self) -> List[int]:
        """The consumer task ids that find their first stage in a slot."""
        return [int(t) for t in np.flatnonzero(self.consume)]


@dataclasses.dataclass
class Schedule:
    order: List[int]         # task ids in queue order (topological)
    pos: np.ndarray          # (n_tasks,) queue position of each task
    buf_slot: np.ndarray     # (n_bufs,) workspace slot per buffer
    n_slots: int
    prefetch: Optional[PrefetchPlan] = None


def _topo_order(n: int, edges, cost) -> List[int]:
    """The JAX `_py_schedule` at num_cores=1: critical-path priorities
    (own cost plus the costliest path after), then list scheduling from a
    heap of (-priority, task id). Raises on a cycle."""
    succ: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for s, d in edges:
        succ[s].append(d)
        indeg[d] += 1
    topo = []
    stack = [t for t in range(n) if indeg[t] == 0]
    deg = list(indeg)
    while stack:
        t = stack.pop()
        topo.append(t)
        for s in succ[t]:
            deg[s] -= 1
            if deg[s] == 0:
                stack.append(s)
    if len(topo) != n:
        raise ValueError("dependency cycle in megakernel graph")
    prio = [0.0] * n
    for t in reversed(topo):
        prio[t] = cost[t] + max((prio[s] for s in succ[t]), default=0.0)
    ready = [(-prio[t], t) for t in range(n) if indeg[t] == 0]
    heapq.heapify(ready)
    deg = list(indeg)
    order = []
    while ready:
        _, t = heapq.heappop(ready)
        order.append(t)
        for s in succ[t]:
            deg[s] -= 1
            if deg[s] == 0:
                heapq.heappush(ready, (-prio[s], s))
    return order


def _buffer_users(graph: Graph) -> Tuple[List[int], List[List[int]]]:
    """(defining task per buffer (-1 if external), every accessing task
    per buffer) — shared by the slot planner and its validator."""
    nb = len(graph.buffers)
    def_task = [-1] * nb
    users: List[List[int]] = [[] for _ in range(nb)]
    for t in graph.tasks:
        for b in t.writes:
            if def_task[b] < 0:
                def_task[b] = t.id
            users[b].append(t.id)
        for b in t.reads:
            users[b].append(t.id)
    return def_task, users


def after_sets(graph: Graph, order: List[int]) -> List[int]:
    """after[t] = the tasks that start only after t completes, as a bitset
    (bit d set): t's successors along the graph's edges, transitively.
    These are the kernel's only waits, so this is its whole
    happens-before relation."""
    succ: List[List[int]] = [[] for _ in graph.tasks]
    for s, d in graph.edges:
        succ[s].append(d)
    after = [0] * len(graph.tasks)
    for t in reversed(order):
        for s in succ[t]:
            after[t] |= after[s] | (1 << s)
    return after


def _plan_slots_hb(graph: Graph, order: List[int],
                   after: List[int]) -> Tuple[np.ndarray, int]:
    """Buffers in the order of their defining task; each takes the first
    slot whose previous tenant's every user happens-before its defining
    task (release[s] holds the tasks after all of them), else a new slot.
    A pinned buffer keeps its slot to itself; a buffer no task touches is
    never released."""
    nb = len(graph.buffers)
    gpos = {t: i for i, t in enumerate(order)}
    def_task, users = _buffer_users(graph)
    order_b = sorted(range(nb), key=lambda b: gpos.get(def_task[b], -1))
    slot = np.zeros(nb, np.int32)
    release: List[Optional[int]] = []
    for b in order_b:
        pinned = graph.pinned.get(b, False)
        d = def_task[b]
        chosen = -1
        if not pinned and d >= 0:
            for s, rel in enumerate(release):
                if rel is not None and (rel >> d) & 1:
                    chosen = s
                    break
        if chosen < 0:
            chosen = len(release)
            release.append(0)
        slot[b] = chosen
        if pinned:
            release[chosen] = None
        elif users[b]:
            rel = -1  # all bits: intersected with every user's after set
            for u in users[b]:
                rel &= after[u]
            release[chosen] = rel
        else:
            release[chosen] = 0
    return slot, len(release)


# -- the weight-prefetch plan -------------------------------------------------


def matmul_tiles(graph: Graph, blocks: int = H100_SMS) -> TileMap:
    """The port's tile map of a graph's matmuls over `blocks` resident
    blocks a rank: the map compile_graph tiles with."""
    return plan_mm_tiles([t.branch_key for t in graph.tasks
                          if t.op == "matmul"], blocks)


def prefetch_specs(tasks, tiles: TileMap
                   ) -> Tuple[List[Tuple[str, int, int, int]], dict]:
    """([(wname, K, TN, splits)] in issue-code order, wname -> issue
    code) (JAX scheduler.py:376). A weight is prefetchable only when every
    matmul that uses it shares one (K, tile): the one arena-stage geometry
    that issuer and consumer must agree on."""
    name_dims: dict = {}
    for t in tasks:
        if t.op != "matmul":
            continue
        k = t.branch_key
        name_dims.setdefault(k[1], set()).add((k[2], *tiles[k]))
    specs: List[Tuple[str, int, int, int]] = []
    code_of: dict = {}
    for wname in sorted(name_dims):
        if len(name_dims[wname]) == 1:
            (kk, tn, split), = name_dims[wname]
            code_of[wname] = len(specs) + 1
            specs.append((wname, kk, tn, split))
    return specs, code_of


def _matmul_nt(task, tiles: TileMap) -> int:
    """The tiles of a matmul task (JAX scheduler.py:402, there N // TN)."""
    tn, split = tiles[task.branch_key]
    return task.branch_key[3] // tn * split


def plan_prefetch(graph: Graph, sched: Schedule, tiles: TileMap,
                  depth: Optional[int] = None) -> PrefetchPlan:
    """Give each prefetchable matmul a rotating arena slot and an issuing
    row (JAX scheduler.py:407, its algorithm unchanged): the hint rides
    the row just before the consumer, into slot k % depth for the k-th
    fed consumer. The issue into a slot must come after the slot's
    previous consumer read it; issuer and previous consumer on one row is
    legal only for a matmul of more than one tile (the JAX rule, kept so
    the plans agree). Otherwise the consumer opens cold."""
    tasks = graph.tasks
    n = len(tasks)
    specs, code_of = prefetch_specs(tasks, tiles)
    if depth is None:
        depth = auto_pf_depth(specs)
    if depth < 1:
        raise ValueError(f"prefetch depth {depth}: at least 1")
    plan = PrefetchPlan(
        depth=depth, specs=specs,
        issue_code=np.zeros(n, np.int32),
        issue_layer=np.zeros(n, np.int32),
        issue_slot=np.zeros(n, np.int32),
        consume=np.zeros(n, np.int32), cold=[], tiles=dict(tiles))
    q = sched.order
    cons_rows: List[int] = []  # queue rows of the fed consumers
    for qi, tid in enumerate(q):
        t = tasks[tid]
        if t.op != "matmul" or t.branch_key[1] not in code_of:
            continue
        k = len(cons_rows)
        lo = cons_rows[k - depth] if k >= depth else -1
        isr = qi - 1
        ok = isr >= 0 and plan.issue_code[q[isr]] == 0
        if ok and isr == lo:
            prev = tasks[q[isr]]
            ok = prev.op == "matmul" and _matmul_nt(prev, tiles) > 1
        elif ok:
            ok = isr > lo
        if not ok:
            plan.cold.append(tid)
            continue
        plan.issue_code[q[isr]] = code_of[t.branch_key[1]]
        plan.issue_layer[q[isr]] = t.args[0]
        plan.issue_slot[q[isr]] = k % depth
        plan.consume[tid] = k % depth + 1
        cons_rows.append(qi)
    _validate_prefetch(graph, sched, plan)
    return plan


def _validate_prefetch(graph: Graph, sched: Schedule,
                       plan: PrefetchPlan) -> None:
    """Replay the arena in queue order (JAX scheduler.py:472) in the CUDA
    kernel's same-row order: a row that issues into the slot it reads
    reads first, any other issue comes first. Every issue finds its slot
    drained, every read finds its slot holding the matmul's own weight
    and layer, every prefetchable matmul is fed or cold, and nothing is
    left in flight at the queue's end."""
    tasks = graph.tasks
    specs, code_of = prefetch_specs(tasks, plan.tiles)
    assert plan.specs == specs, "prefetch plan built for a different graph"
    assert plan.depth >= 1
    cold = set(plan.cold)
    filled: dict = {}  # slot -> (issue code, layer)
    for tid in sched.order:
        t = tasks[tid]
        is_consumer = t.op == "matmul" and t.branch_key[1] in code_of
        code = int(plan.issue_code[tid])
        cons = int(plan.consume[tid])
        if not is_consumer:
            assert cons == 0, (
                f"task {tid} ({t.tag}) is no prefetchable matmul but "
                "consumes an arena slot")

        def read():
            slot = cons - 1
            assert slot in filled, (
                f"task {tid} reads arena slot {slot} but no prefetch is in "
                "flight there")
            got = filled.pop(slot)
            want = (code_of[t.branch_key[1]], t.args[0])
            assert got == want, (
                f"task {tid}: arena slot {slot} holds (code, layer) {got}, "
                f"expected {want}")

        read_first = cons > 0 and code and int(plan.issue_slot[tid]) == cons - 1
        if read_first:
            read()
        if code:
            slot = int(plan.issue_slot[tid])
            assert 0 <= slot < plan.depth, f"task {tid}: slot {slot}"
            assert slot not in filled, (
                f"task {tid} issues into arena slot {slot} while the stage "
                "there is unread")
            filled[slot] = (code, int(plan.issue_layer[tid]))
        if is_consumer:
            if cons > 0:
                assert tid not in cold, f"task {tid} is both fed and cold"
                if not read_first:
                    read()
            else:
                assert tid in cold, (
                    f"matmul task {tid} ({t.tag}) has no issuing row and is "
                    "not listed cold")
    assert not filled, f"prefetches left in flight at the queue's end: {filled}"
    assert cold <= {t.id for t in tasks
                    if t.op == "matmul" and t.branch_key[1] in code_of}, (
        "a cold task is no prefetchable matmul")


def schedule_graph(graph: Graph, pf_depth: Optional[int] = None,
                   blocks: int = H100_SMS) -> Schedule:
    """Order + slot plan + weight-prefetch plan of a Graph: one
    topological queue (the JAX num_cores=1 order), the happens-before
    slot plan and `plan_prefetch` on the tile map of `blocks` resident
    blocks a rank (compile_graph's), at arena depth `pf_depth` (None:
    auto_pf_depth)."""
    n = len(graph.tasks)
    if n == 0:
        raise ValueError("empty megakernel graph")
    order = _topo_order(n, graph.edges, [t.cost for t in graph.tasks])
    pos = np.zeros(n, np.int32)
    pos[order] = np.arange(n, dtype=np.int32)
    slot, n_slots = _plan_slots_hb(graph, order, after_sets(graph, order))
    sched = Schedule(order=order, pos=pos, buf_slot=slot, n_slots=n_slots)
    sched.prefetch = plan_prefetch(graph, sched, matmul_tiles(graph, blocks),
                                   depth=pf_depth)
    return sched


def _reaches(succ: List[List[int]], a: int, b: int) -> bool:
    """A path of one or more edges from task a to task b (a BFS, kept apart
    from the planner's bitsets so the validator checks it)."""
    seen = set()
    todo = deque(succ[a])
    while todo:
        t = todo.popleft()
        if t == b:
            return True
        if t not in seen:
            seen.add(t)
            todo.extend(succ[t])
    return False


def _validate_slots_hb(graph: Graph, sched: Schedule) -> None:
    """For each pair of buffers sharing a slot, one buffer's every user
    must reach the other's defining task along the graph's edges."""
    succ: List[List[int]] = [[] for _ in graph.tasks]
    for s, d in graph.edges:
        succ[s].append(d)
    def_task, users = _buffer_users(graph)

    def all_before(b1: int, b2: int) -> bool:
        d = def_task[b2]
        return d >= 0 and all(_reaches(succ, u, d) for u in users[b1])

    by_slot: dict = {}
    for b in graph.buffers:
        by_slot.setdefault(int(sched.buf_slot[b.id]), []).append(b.id)
    for slot, bufs in by_slot.items():
        for i, b1 in enumerate(bufs):
            for b2 in bufs[i + 1:]:
                assert all_before(b1, b2) or all_before(b2, b1), (
                    f"slot {slot}: buffers {b1} and {b2} may be live at "
                    "once: no edge path orders their users")


def validate_schedule(graph: Graph, sched: Schedule) -> None:
    """The queue holds every task once, every edge runs forward in it, no
    two buffers that share a slot can be live at once, and the prefetch
    plan, where the schedule carries one, replays without a race."""
    assert sorted(sched.order) == list(range(len(graph.tasks))), \
        "queue is not a permutation of the tasks"
    for s, d in graph.edges:
        assert sched.pos[s] < sched.pos[d], (s, d)
    _validate_slots_hb(graph, sched)
    if sched.prefetch is not None:
        _validate_prefetch(graph, sched, sched.prefetch)

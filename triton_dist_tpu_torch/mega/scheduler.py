"""Megakernel scheduler: task order and workspace slot plan — port of the
Python path of triton_dist_tpu.mega.scheduler.

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

Not ported (ROADMAP.md): the native scheduler (`csrc/scheduler.cc`),
multi-queue schedules and watermarks, the prefetch and store/forward
plans, which are the TPU kernel's DMA pipeline.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from triton_dist_tpu_torch.mega.core import Graph


@dataclasses.dataclass
class Schedule:
    order: List[int]         # task ids in queue order (topological)
    pos: np.ndarray          # (n_tasks,) queue position of each task
    buf_slot: np.ndarray     # (n_bufs,) workspace slot per buffer
    n_slots: int


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


def schedule_graph(graph: Graph) -> Schedule:
    """Order + slot plan of a Graph: one topological queue (the JAX
    num_cores=1 order) and the happens-before slot plan."""
    n = len(graph.tasks)
    if n == 0:
        raise ValueError("empty megakernel graph")
    order = _topo_order(n, graph.edges, [t.cost for t in graph.tasks])
    pos = np.zeros(n, np.int32)
    pos[order] = np.arange(n, dtype=np.int32)
    slot, n_slots = _plan_slots_hb(graph, order, after_sets(graph, order))
    return Schedule(order=order, pos=pos, buf_slot=slot, n_slots=n_slots)


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
    """The queue holds every task once, every edge runs forward in it, and
    no two buffers that share a slot can be live at once."""
    assert sorted(sched.order) == list(range(len(graph.tasks))), \
        "queue is not a permutation of the tasks"
    for s, d in graph.edges:
        assert sched.pos[s] < sched.pos[d], (s, d)
    _validate_slots_hb(graph, sched)

"""Megakernel task graph: buffers, tasks, dependency tracking — port of
triton_dist_tpu.mega.core.

`BufferHandle`, `Task` and `Graph` are the JAX package's (core.py:94-221),
copied: activations live in one workspace of uniform B-row slots, tasks
carry slot indices and layer ids in their int32 queue rows, and
dependencies come from buffer def/use (RAW, WAR and WAW edges).

What differs is the tiling. The JAX `fit_mm_tile` / `mm_tile_cap` /
`plan_mm_tiles` size a matmul's weight tile to a VMEM byte budget for one
TensorCore that walks the whole queue. On an H100 every task is cut into
tiles that all resident blocks of a rank share (csrc/mega.cu), so the
tiling follows the block count instead: `mm_tiling` (a column block and
a K range of the weight) and `mm_tile_cols` (elementwise tasks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Sequence, Tuple

# blocks a rank plans for where no card says otherwise: one block on each
# of an H100's 132 SMs
H100_SMS = 132

# The shared memory of a block of csrc/mega.cu (kThreads 256, one block a
# SM), in the kernel's order: the branches' scratch (a matmul's staged
# activations and epilogue, the attention's q / logits / P.V partials,
# the norms' reductions), the ring of weight stages, the prefetch arena
# (one stage a slot), the stages' mbarriers; the ring starts 128-byte
# aligned (a TMA destination). Mirrored by kScratchBytes, kStageBytes,
# kRingStages, kMaxDepth and kSmemMax there. Stages of 32 KB: smaller
# ones streamed slower (PERF.md PR 23).
SMEM_BYTES = 232448          # an H100 block's opt-in maximum (227 KB)
SCRATCH_BYTES = 66560
STAGE_BYTES = 32768
RING_STAGES = 3
# what the ring leaves: each stage brings its 8-byte mbarrier
ARENA_BYTES = (SMEM_BYTES - SCRATCH_BYTES - 128
               - RING_STAGES * (STAGE_BYTES + 8))
MAX_PF_DEPTH = ARENA_BYTES // (STAGE_BYTES + 8)  # arena slots that fit: 2
assert MAX_PF_DEPTH >= 2, "the arena must hold auto_pf_depth's floor of 2"

# columns of a matmul or elementwise tile are a multiple of this: one
# 16-byte vector of bf16 (two of f32); at most MAX_TILE_COLS, one 16-byte
# column group for each of a block's 256 threads in f32
COL_ALIGN = 8
MAX_TILE_COLS = 1024


def mm_tile_cols(n_cols: int, blocks: int) -> int:
    """The tile width of an elementwise task of n_cols columns over
    `blocks` resident blocks of a rank: among the multiples of COL_ALIGN
    up to MAX_TILE_COLS that divide n_cols, the one that puts the fewest
    columns on the busiest block (ceil(tiles / blocks) * width), ties to
    the wider tile. At 132 blocks a 4096-wide AllReduce takes 32."""
    best, best_cost = 0, 0
    for w in range(COL_ALIGN, min(n_cols, MAX_TILE_COLS) + 1, COL_ALIGN):
        if n_cols % w:
            continue
        cost = -(-(n_cols // w) // max(blocks, 1)) * w
        if not best or cost < best_cost or (cost == best_cost and w > best):
            best, best_cost = w, cost
    if not best:
        raise ValueError(f"{n_cols} columns: the kernel's tiles need a "
                         f"multiple of {COL_ALIGN}")
    return best


# a tile reads runs of at least this many columns of a row-major weight
# row (256 bytes of bf16) where N allows: 64- and 96-byte runs streamed at
# 1.3-1.45 TB/s on an H100, 384-byte runs at 2.4 (PERF.md, profile_mega)
MIN_RUN_COLS = 128
MAX_SPLIT = 16


def mm_tiling(k: int, n_cols: int, blocks: int) -> Tuple[int, int]:
    """(tile width, K splits) of a (K, N) matmul over `blocks` resident
    blocks: tiles of runs of at least MIN_RUN_COLS columns (all N when
    narrower), K cut into up to MAX_SPLIT ranges whose f32 partial sums
    the last tile of a column block adds in order and rounds once. Least
    rows x columns on the busiest block (ceil(tiles / blocks) * width *
    K / splits); ties to the fewer splits, then to the wider tile. At 132
    blocks: w_qkv 192 x 4, w_o 128 x 4, [gate|up] 192 x 1, w_down 128 x
    4; at world 4 (33 blocks) w_qkv 192 x 4, the others unsplit."""
    best, best_key = None, None
    min_cols = min(MIN_RUN_COLS, n_cols)
    for w in range(COL_ALIGN, min(n_cols, MAX_TILE_COLS) + 1, COL_ALIGN):
        if n_cols % w or w < min_cols:
            continue
        for s in range(1, MAX_SPLIT + 1):
            if k % s or (k // s) % COL_ALIGN:
                continue
            cost = -(-(n_cols // w * s) // max(blocks, 1)) * w * (k // s)
            key = (cost, s, -w)
            if best_key is None or key < best_key:
                best, best_key = (w, s), key
    if best is None:
        raise ValueError(f"matmul ({k}, {n_cols}): the kernel's tiles need "
                         f"multiples of {COL_ALIGN}")
    return best


def plan_mm_tiles(mm_keys: Sequence[Hashable], blocks: int
                  ) -> Dict[Hashable, Tuple[int, int]]:
    """branch_key -> (tile width, K splits) for every matmul branch key
    (the JAX function of the same name budgets VMEM; this one fills
    `blocks`)."""
    return {k: mm_tiling(k[2], k[3], blocks) for k in set(mm_keys)
            if k and k[0] == "matmul"}


@dataclasses.dataclass(frozen=True)
class BufferHandle:
    """One logical activation tensor: a B-row × width stripe of the
    workspace. `slot` is assigned by the planner at compile time."""

    id: int
    width: int
    name: str = ""


@dataclasses.dataclass
class Task:
    """One schedulable unit. branch_key is the op kind plus its static
    config, so all layers sharing a shape share one branch and layer_id
    rides in the dynamic args."""

    id: int
    op: str
    branch_key: Hashable
    args: List[int]                 # dynamic scalars for the queue row
    reads: List[int]                # buffer ids
    writes: List[int]               # buffer ids
    cost: float = 1.0               # byte-count estimate for the scheduler
    tag: str = ""
    # arg positions holding buffer ids, rewritten to workspace slots at
    # compile time (queue rows carry slots, not graph buffer ids)
    buf_args: Tuple[int, ...] = ()


class Graph:
    """Append-only op graph with last-writer/reader dependency tracking."""

    def __init__(self, batch: int):
        self.batch = batch
        self.buffers: List[BufferHandle] = []
        self.tasks: List[Task] = []
        self._writer: Dict[int, int] = {}        # buf -> task that wrote it
        self._readers: Dict[int, List[int]] = {}  # buf -> tasks that read it
        self._edges: set = set()
        self.edges: List[Tuple[int, int]] = []
        self.pinned: Dict[int, bool] = {}
        # last barrier task id: every task added after a barrier depends
        # on it, so no put can land in a rank that has not arrived
        self.barrier: int = -1

    def buffer(self, width: int, name: str = "",
               pinned: bool = False) -> BufferHandle:
        """New logical activation buffer. pinned=True gives it a dedicated
        workspace slot (kernel I/O: the planner must not reuse it)."""
        b = BufferHandle(len(self.buffers), int(width), name)
        self.buffers.append(b)
        self.pinned[b.id] = pinned
        return b

    def _edge(self, src: int, dst: int) -> None:
        if src != dst and (src, dst) not in self._edges:
            self._edges.add((src, dst))
            self.edges.append((src, dst))

    def add_task(
        self,
        op: str,
        branch_key: Hashable,
        args: Sequence[int],
        reads: Sequence[BufferHandle],
        writes: Sequence[BufferHandle],
        cost: float = 1.0,
        tag: str = "",
        buf_args: Sequence[int] = (),
        extra_deps: Sequence["Task"] = (),
    ) -> Task:
        t = Task(len(self.tasks), op, branch_key, list(args),
                 [b.id for b in reads], [b.id for b in writes],
                 cost, tag, tuple(buf_args))
        for b in t.reads:
            w = self._writer.get(b)
            if w is not None:
                self._edge(w, t.id)          # RAW
            self._readers.setdefault(b, []).append(t.id)
        for b in t.writes:
            w = self._writer.get(b)
            if w is not None:
                self._edge(w, t.id)          # WAW
            for r in self._readers.get(b, ()):
                self._edge(r, t.id)          # WAR
            self._writer[b] = t.id
            self._readers[b] = []
        for d in extra_deps:
            self._edge(d.id, t.id)
        if op == "barrier":
            self.barrier = t.id
        elif self.barrier >= 0:
            self._edge(self.barrier, t.id)
        self.tasks.append(t)
        return t

    def preds(self) -> List[List[int]]:
        """Each task's direct producers (the edges into it), in edge order:
        the counters a tile of the task waits on."""
        p: List[List[int]] = [[] for _ in self.tasks]
        for s, d in self.edges:
            p[d].append(s)
        return p

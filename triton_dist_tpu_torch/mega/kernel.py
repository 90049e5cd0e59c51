"""The megakernel: one decode step's task queue as one persistent CUDA
kernel (csrc/mega.cu) — port of triton_dist_tpu.mega.kernel
(`compile_graph`, kernel.py:980; its branches :286-925).

On the TPU one core walks the queue in program order, so a task's inputs
are ready when it starts. On an H100 every task is cut into tiles that
all resident blocks of a rank share (the reference's scoreboard,
SURVEY.md §2.8): each block walks the same queue in order and takes the
tiles i ≡ block (mod blocks a rank); before a tile it waits until the
completion counter of each producer task (a graph edge) holds that
producer's tile count; after it, it adds one to its own task's counter.
`compile_graph` plans the slots (scheduler.py, happens-before over those
edges), and lays the queue out as int32 rows:

  col 0      op code (OPS)
  cols 1-6   the task's args, buffer ids rewritten to workspace slots
  col 7      tiles
  cols 8-16  static config: matmul (tile cols, K, N, prologue, weight
             index, arrival-flag base, eps bits, K splits, partial-sum
             offset); rms_norm / silu_mul / add / allreduce_add (tile
             cols, width, -, -, mailbox index, arrival-flag base, eps
             bits); attention (hq_l, hkv_l, D, use_qk_norm, q-norm base
             row, k-norm base row, eps bits)
  col 17     producer count; cols 18-25 the producers' queue positions
  cols 26-29 the weight-prefetch hint (scheduler.plan_prefetch, the JAX
             row's pf_code, pf_layer, pf_slot, pf_in): issue code (1 +
             index into the plan's specs, 0 = none), the consumer's
             layer, the arena slot it fills, and the slot this matmul
             reads its first stage from (slot + 1, 0 = cold)

A matmul tile is a column block of the weight and, where N is too narrow
to give every block a run of MIN_RUN_COLS columns, a range of K: the
tiles of one column block write f32 partial sums, and the last to finish
(an arrival flag) adds them in K order and rounds once.

The weight pipeline is the JAX one in CUDA form: a matmul tile streams
its weight rows through a ring of shared-memory stages filled by async
copies, and the schedule's prefetch plan starts the next matmul's first
stage one row early into an arena slot (csrc/mega.cu). A weight named in
`tiled_weights` is laid out tile-major once (`tile_weight_major`, JAX
kernel.py:123), so each tile is one contiguous block and each stage one
bulk copy; `w_tile_src` is the one definition of where a tile lies, as
JAX's `_w_tile_src`. Not carried over: the store/forward plan, VMEM
budgets and num_cores (ROADMAP.md). The mailbox AllReduce gets one heap
slot per AR task (the JAX kernel double-buffers by parity across steps):
one launch never reuses a slot, and the next launch starts after this
one ends, so neither the parity nor its flow control is needed.

`run` launches the kernel on a CUDA tensor (kernels/mega.py, counted as
`mega`) and never falls back; `run_plain` is the plain PyTorch version:
the same queue in order, one torch function per branch, every rank of
the virtual world at once, with the JAX rounding points.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import mega as _mk
from triton_dist_tpu_torch.layers.linear import dot_f32
from triton_dist_tpu_torch.mega.core import (
    COL_ALIGN,
    H100_SMS,
    MAX_PF_DEPTH,
    STAGE_BYTES,
    Graph,
    mm_tile_cols,
    plan_mm_tiles,
)
from triton_dist_tpu_torch.mega.scheduler import (
    PrefetchPlan,
    Schedule,
    plan_prefetch,
)

OPS = ("matmul", "rms_norm", "silu_mul", "add", "allreduce_add",
       "attention", "barrier", "noop")
ROW = 30
HINT = slice(26, 30)  # issue code, issue layer, issue slot, consume
MAX_PRODUCERS = 8
MAX_BATCH = 16
PROLOGUES = {None: 0, "rms": 1, "silu": 2}


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def _bits_f32(i: int) -> float:
    return struct.unpack("<f", struct.pack("<i", int(i)))[0]


def _kv_chunk(smax: int, page: int = 0) -> int:
    """KV page length of the attention: whole-cache at small contexts,
    512-token pages past that; page > 0 pins an explicit page size (the
    paged-cache mode). Copied from the JAX kernel (kernel.py:658)."""
    if page > 0:
        assert smax % page == 0, f"s_max {smax} % page {page} != 0"
        return page
    if smax <= 1024:
        return smax
    assert smax % 512 == 0, f"s_max {smax} must be a multiple of 512"
    return 512


def tile_weight_major(w: torch.Tensor, tn: int) -> torch.Tensor:
    """A stacked weight (..., K, N) laid out tile-major (..., N // tn, K,
    tn), as JAX kernel.py:123: block [..., j] is then one contiguous run
    of K * tn elements, which the kernel streams as bulk copies. Made once
    at init (a copy), never a step."""
    *lead, k, n = w.shape
    nt = n // tn
    if nt * tn != n:
        raise ValueError(f"N={n} is not a multiple of the tile {tn}")
    return w.reshape(*lead, k, nt, tn).movedim(-2, -3).contiguous()


def w_tile_src(w: torch.Tensor, tiled: bool, layer: int, j: int,
               tn: int) -> torch.Tensor:
    """The (n, K, tn) source of column tile j of a weight's layer: a
    tile-major weight (L, n, N // tn, K, tn) indexes one block, a
    row-major (L, n, K, N) one a column slice. The one definition of the
    two layouts (JAX kernel.py:205 `_w_tile_src`): csrc/mega.cu mm_tile
    addresses the same block."""
    if tiled:
        return w[layer, :, j]
    return w[layer, :, :, j * tn:(j + 1) * tn]


def blocks_per_rank(device, world: int) -> int:
    """The resident blocks a rank of the kernel gets: one a SM of the card,
    split over the ranks (an H100's 132 where there is no card)."""
    dev = torch.device(device)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    if sms < world:
        raise ValueError(f"{world} ranks need a block each; the card has "
                         f"{sms} SMs")
    return sms // world


@dataclasses.dataclass
class CompiledMega:
    """The queue and the static plan of one graph at one world size."""

    queue: np.ndarray          # (n_rows, ROW) int32
    dtype: torch.dtype         # activations and weights
    n_slots: int
    pb: int                    # rows of a workspace slot (the batch)
    wmax: int                  # columns of a workspace slot
    norm_width: int            # columns of the stacked norms array
    branch_keys: List[Any]
    weight_names: List[str]
    mm_tiles: Dict[Any, Any]   # matmul key -> (tile cols, K splits)
    blocks: int                # resident blocks a rank (tiles are cut for it)
    world: int
    n_flags: int               # flags a rank: counters, arrivals, barrier
    n_partial: int             # f32 partial sums a rank (split matmuls)
    n_ar: int                  # allreduce_add tasks (mailbox slots)
    arw: int                   # mailbox width
    attn: Optional[Dict[str, int]]  # the one attention geometry, if any
    prefetch: Optional[PrefetchPlan] = None  # the queue's hint columns
    tiled: Dict[str, int] = dataclasses.field(default_factory=dict)
    # weight -> (K, N, tile cols, K splits) of its matmuls, None where
    # they differ (such a weight is never prefetched)
    w_geom: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _dev_queue: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def pf_depth(self) -> int:
        return self.prefetch.depth if self.prefetch is not None else 1

    def tile_cols(self, name: str) -> int:
        """The one tile width of weight `name`'s matmuls (JAX
        CompiledMega.tile_cols)."""
        tns = {v[0] for k, v in self.mm_tiles.items() if k[1] == name}
        if len(tns) != 1:
            raise ValueError(f"weight {name} is tiled at {sorted(tns)}")
        return tns.pop()

    def weight_shape(self, name: str, layers: int) -> tuple:
        """The layout the kernel takes weight `name` in: (L, n, N // tn,
        K, tn) tile-major, else (L, n, K, N)."""
        g = self.w_geom[name]
        if name in self.tiled:
            tn = self.tiled[name]
            return (layers, self.world, g[1] // tn, g[0], tn)
        return (layers, self.world, *(g[:2] if g else (None, None)))

    def plan_counts(self) -> tuple:
        """(fed, cold) matmul rows of one step, by the plan."""
        if self.prefetch is None:
            return 0, 0
        return len(self.prefetch.fed()), len(self.prefetch.cold)

    def queue_counts(self, queue=None) -> tuple:
        """(fed, cold) matmul rows of one step, as the hint columns of
        `queue` (default this queue; a copy read back from a device to
        check what the kernel reads) say: rows that take their first
        stage from an arena slot, and rows of a prefetched weight that
        open cold."""
        q = self.queue if queue is None else np.asarray(queue)
        mm = q[:, 0] == OPS.index("matmul")
        fed = mm & (q[:, HINT.stop - 1] != 0)
        specs = self.prefetch.specs if self.prefetch is not None else []
        pf = [self.weight_names.index(s[0]) for s in specs]
        cold = mm & ~fed & np.isin(q[:, 12], pf)
        return int(fed.sum()), int(cold.sum())

    def workspace(self, device) -> torch.Tensor:
        """(n ranks, n_slots, pb, wmax): rank r's slot s is [r, s]."""
        return torch.zeros((self.world, self.n_slots, self.pb, self.wmax),
                           dtype=self.dtype, device=device)

    def queue_on(self, device) -> torch.Tensor:
        key = str(device)
        q = self._dev_queue.get(key)
        if q is None:
            q = torch.from_numpy(self.queue).to(device)
            self._dev_queue[key] = q
        return q

    def run(self, pos, table, ws, weights, norms, rope_cs, k_pool, v_pool):
        """One decode step over the workspace, in place (and returned).
        pos (B,) int32; table (B, MAXP) int32 maps (sequence, page) to a
        pool page; ws (n, n_slots, B, wmax); weights {name: (L, n, K, N)};
        norms (rows, norm_width) f32; rope_cs (positions, D) f32 [cos |
        sin]; k_pool / v_pool (L, Hkv, pages, page, D), rank r's heads at
        [r*Hkv/n, (r+1)*Hkv/n). The CUDA kernel on CUDA tensors, the plain
        version on CPU ones (kernels/mega.py)."""
        return _mk.mega_step(self, pos, table, ws, weights, norms, rope_cs,
                             k_pool, v_pool)

    def run_plain(self, pos, table, ws, weights, norms, rope_cs, k_pool,
                  v_pool):
        """The plain PyTorch version of `run`: the queue in order."""
        for row in self.queue:
            _PLAIN[OPS[row[0]]](self, row, pos, table, ws, weights, norms,
                                rope_cs, k_pool, v_pool)
        return ws


def compile_graph(graph: Graph, sched: Schedule, dtype,
                  blocks: int = H100_SMS, world: int = 1,
                  tiled_weights: tuple = ()) -> CompiledMega:
    """Lower (graph, schedule) to the queue the CUDA kernel walks, for
    `world` ranks of `blocks` resident blocks each (blocks_per_rank),
    activations and weights in `dtype`. The weights in `tiled_weights`
    are taken tile-major (tile_weight_major at `tile_cols`). The
    schedule's prefetch plan fills the hint columns; a schedule without
    one gets one planned here at the auto depth (as JAX does)."""
    B = graph.batch
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B}: the megakernel takes 1 to {MAX_BATCH} "
                         "rows")
    tasks = graph.tasks
    order = sched.order
    pos_of = {t: i for i, t in enumerate(order)}
    preds = graph.preds()
    keys = [t.branch_key for t in tasks]
    branch_keys = list(dict.fromkeys(keys[t] for t in order))
    mm_keys = [k for k in branch_keys if k[0] == "matmul"]
    mm_tiles = plan_mm_tiles(mm_keys, blocks)
    weight_names = sorted({k[1] for k in mm_keys})
    isz = torch.empty((), dtype=dtype).element_size()
    for k, (tn, _) in mm_tiles.items():
        if 8 * tn * isz > STAGE_BYTES:
            raise ValueError(f"matmul {k}: tiles of {tn} columns leave a "
                             "weight stage fewer than 8 rows")
    geoms: Dict[str, set] = {}
    for k in mm_keys:
        geoms.setdefault(k[1], set()).add((k[2], k[3], *mm_tiles[k]))
    w_geom = {n: (next(iter(g)) if len(g) == 1 else None)
              for n, g in geoms.items()}
    tiled_weights = tuple(tiled_weights)
    if not set(tiled_weights) <= set(weight_names):
        raise ValueError(f"tiled_weights {tiled_weights}: not all matmul "
                         f"weights of the graph ({weight_names})")
    plan = sched.prefetch
    if plan is None:
        plan = plan_prefetch(graph, sched, mm_tiles)
    if plan.tiles != mm_tiles:
        raise ValueError("the schedule's prefetch plan was made on another "
                         "tile map: schedule_graph(..., blocks=) must get "
                         f"compile_graph's {blocks}")
    one = set(tiled_weights) | {spec[0] for spec in plan.specs}
    if any(w_geom[name] is None for name in one):
        raise ValueError("a tiled or prefetched weight needs one (K, N) "
                         "and one tiling over its matmuls")
    if not 1 <= plan.depth <= MAX_PF_DEPTH:
        raise ValueError(f"prefetch depth {plan.depth}: the kernel's arena "
                         f"holds 1 to {MAX_PF_DEPTH} slots")
    at_keys = [k for k in branch_keys if k[0] == "attention"]
    if len({k[1:] for k in at_keys}) > 1:
        raise ValueError("one attention geometry per megakernel graph")
    attn = None
    if at_keys:
        _, hq_l, hkv_l, D, smax, _, _, _, _, page = at_keys[0]
        if (hq_l % hkv_l or D not in (32, 64, 128, 256)
                or (hq_l // hkv_l) * D > 1024):
            raise ValueError(f"attention heads {hq_l}/{hkv_l} x D {D}: the "
                             "kernel takes D of 32, 64, 128 or 256 and at "
                             "most 1024 q values a kv head")
        schunk = _kv_chunk(smax, page)
        attn = dict(hq_l=hq_l, hkv_l=hkv_l, D=D, smax=smax, page=schunk,
                    maxp=smax // schunk)

    n_rows = len(order)
    queue = np.zeros((n_rows, ROW), np.int32)
    flag = n_rows  # arrival flags follow the task counters
    n_ar = n_partial = 0
    arw = COL_ALIGN
    for qi, tid in enumerate(order):
        t = tasks[tid]
        k = t.branch_key
        row = queue[qi]
        args = list(t.args)
        for p in t.buf_args:
            args[p] = int(sched.buf_slot[args[p]])
        row[0] = OPS.index(t.op)
        row[1:1 + len(args)] = args
        row[15] = 1
        if t.op == "matmul":
            _, wname, K, N, prologue, eps = k
            tn, split = mm_tiles[k]
            row[7] = N // tn * split
            row[8:17] = [tn, K, N, PROLOGUES[prologue],
                         weight_names.index(wname), flag, _f32_bits(eps),
                         split, n_partial]
            if split > 1:  # an arrival flag a column block, its partials
                flag += N // tn
                n_partial += split * B * N
        elif t.op == "rms_norm":
            row[7] = B
            row[8:15] = [0, k[1], 0, 0, 0, 0, _f32_bits(k[2])]
        elif t.op in ("silu_mul", "add", "allreduce_add"):
            W = k[1]
            te = mm_tile_cols(W, blocks)
            row[7] = W // te
            row[8:10] = [te, W]
            if t.op == "allreduce_add":
                row[12:14] = [n_ar, flag]
                n_ar += 1
                flag += row[7]
                arw = max(arw, W)
        elif t.op == "attention":
            row[7] = B * k[2]
            row[8:15] = [k[1], k[2], k[3], int(k[6]), k[7], k[8],
                         _f32_bits(k[5])]
        elif t.op == "barrier":
            row[7] = blocks  # every block of every rank meets once
        else:
            row[7] = 1
        ps = [pos_of[p] for p in preds[tid]]
        if len(ps) > MAX_PRODUCERS:
            raise ValueError(f"task {t.tag}: {len(ps)} producers, the queue "
                             f"row holds {MAX_PRODUCERS}")
        row[17] = len(ps)
        row[18:18 + len(ps)] = ps
        row[HINT] = [plan.issue_code[tid], plan.issue_layer[tid],
                     plan.issue_slot[tid], plan.consume[tid]]

    wmax = max(b.width for b in graph.buffers)
    wmax = -(-wmax // COL_ALIGN) * COL_ALIGN
    norm_ws = [k[1] for k in branch_keys if k[0] == "rms_norm"]
    norm_ws += [k[2] for k in mm_keys if k[4] == "rms"]
    if any(k[6] for k in at_keys):
        norm_ws.append(at_keys[0][3])
    norm_width = max(norm_ws, default=COL_ALIGN)
    cm = CompiledMega(
        queue=queue, dtype=dtype, n_slots=sched.n_slots, pb=B, wmax=wmax,
        norm_width=norm_width, branch_keys=branch_keys,
        weight_names=weight_names, mm_tiles=mm_tiles, blocks=blocks,
        world=world, n_flags=flag + 1, n_partial=n_partial, n_ar=n_ar,
        arw=arw, attn=attn, prefetch=plan, w_geom=w_geom)
    cm.tiled = {name: cm.tile_cols(name) for name in tiled_weights}
    return cm


# -- the plain version, one function per branch ---------------------------
# Every tensor carries the rank dim first; `row` is a queue row. Math in
# f32, rounded to the activation dtype where the JAX branch rounds.


def _rms_f32(x, w, eps):
    """rms_norm in f32 (kernel.py:192): x (..., W), w (W,)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w


def _silu_f32(g, u):
    """kernel.py:198."""
    return g * torch.sigmoid(g) * u


def _slot(cm, ws, s, width):
    return ws[:, s, :cm.pb, :width]


def _plain_weight(cm, weights, name, layer):
    """(n, K, N) of weight `name` at `layer`, from the layout the queue
    takes it in: a tile-major one through w_tile_src, tile by tile."""
    w = weights[name]
    if name not in cm.tiled:
        if w.dim() != 4:
            raise ValueError(f"weight {name} {tuple(w.shape)}: the queue "
                             "takes it row-major (L, n, K, N)")
        return w[layer]
    tn = cm.tiled[name]
    if w.dim() != 5 or w.shape[-1] != tn:
        raise ValueError(f"weight {name} {tuple(w.shape)}: the queue takes "
                         f"it tile-major (L, n, N // {tn}, K, {tn})")
    return torch.cat([w_tile_src(w, True, layer, j, tn)
                      for j in range(w.shape[2])], dim=-1)


def _plain_matmul(cm, row, pos, table, ws, weights, norms, *_):
    layer, src, dst, nrow = (int(v) for v in row[1:5])
    K, N, pro = int(row[9]), int(row[10]), int(row[11])
    w = _plain_weight(cm, weights, cm.weight_names[int(row[12])], layer)
    raw = _slot(cm, ws, src, 2 * K if pro == 2 else K)
    if pro == 1:
        a = _rms_f32(raw.float(), norms[nrow, :K], _bits_f32(row[14]))
        a = a.to(ws.dtype)
    elif pro == 2:
        a = _silu_f32(raw[..., :K].float(), raw[..., K:].float()).to(ws.dtype)
    else:
        a = raw
    _slot(cm, ws, dst, N).copy_(dot_f32(a, w).to(ws.dtype))


def _plain_rms_norm(cm, row, pos, table, ws, weights, norms, *_):
    nrow, src, dst = (int(v) for v in row[1:4])
    W = int(row[9])
    y = _rms_f32(_slot(cm, ws, src, W).float(), norms[nrow, :W],
                 _bits_f32(row[14]))
    _slot(cm, ws, dst, W).copy_(y.to(ws.dtype))


def _plain_silu_mul(cm, row, pos, table, ws, *_):
    src, dst = int(row[1]), int(row[2])
    W = int(row[9])
    x = _slot(cm, ws, src, 2 * W).float()
    _slot(cm, ws, dst, W).copy_(_silu_f32(x[..., :W], x[..., W:])
                                .to(ws.dtype))


def _plain_add(cm, row, pos, table, ws, *_):
    a, b, dst = (int(v) for v in row[1:4])
    W = int(row[9])
    # in the activation dtype, as the JAX branch adds (kernel.py:516)
    _slot(cm, ws, dst, W).copy_(_slot(cm, ws, a, W) + _slot(cm, ws, b, W))


def _plain_allreduce_add(cm, row, pos, table, ws, *_):
    src, res, dst = (int(v) for v in row[1:4])
    W = int(row[9])
    part = _slot(cm, ws, src, W)
    acc = part[0].float()
    for r in range(1, part.shape[0]):  # ranks 0..n-1, then the residual
        acc = acc + part[r].float()
    out = acc[None] + _slot(cm, ws, res, W).float()
    _slot(cm, ws, dst, W).copy_(out.to(ws.dtype))


def _plain_attention(cm, row, pos, table, ws, weights, norms, rope_cs,
                     k_pool, v_pool):
    """qk-norm, rope at pos[b] (half split), GQA softmax over the cached
    prefix read through the page table plus the new token, which enters
    the softmax unrounded and the cache not at all (kernel.py:671)."""
    layer, src, dst, kn_dst, vn_dst = (int(v) for v in row[1:6])
    hq_l, hkv_l, D, qkn, qb, kb = (int(v) for v in row[8:14])
    eps = _bits_f32(row[14])
    n, B = ws.shape[0], cm.pb
    g, half = hq_l // hkv_l, D // 2
    hqd, kw = hq_l * D, hkv_l * D
    qkv = _slot(cm, ws, src, hqd + 2 * kw).float()
    q = qkv[..., :hqd].reshape(n, B, hq_l, D)
    kn = qkv[..., hqd:hqd + kw].reshape(n, B, hkv_l, D)
    vn = qkv[..., hqd + kw:].reshape(n, B, hkv_l, D)
    if qkn:
        q = _rms_f32(q, norms[qb + layer, :D], eps)
        kn = _rms_f32(kn, norms[kb + layer, :D], eps)
    cs = rope_cs[pos.long()]  # (B, D)
    c, s = cs[:, None, :half], cs[:, None, half:D]

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    q, kn = rope(q), rope(kn)
    _slot(cm, ws, kn_dst, kw).copy_(kn.reshape(n, B, kw).to(ws.dtype))
    _slot(cm, ws, vn_dst, kw).copy_(vn.reshape(n, B, kw).to(ws.dtype))

    # the cached prefix through the table: (n, hkv_l, B, MAXP*page, D)
    L, hkv, P, page, _ = k_pool.shape
    tbl = table.long()

    def gather(pool):
        pr = pool[layer].reshape(n, hkv_l, P, page, D)
        return pr[:, :, tbl].reshape(n, hkv_l, B, -1, D).float()

    kc, vc = gather(k_pool), gather(v_pool)
    T = kc.shape[3]
    qs = q.reshape(n, B, hkv_l, g, D) * (D ** -0.5)
    lg = torch.einsum("nbhgd,nhbtd->nbhgt", qs, kc)
    live = torch.arange(T, device=lg.device)[None, :] < pos.long()[:, None]
    lg = torch.where(live[None, :, None, None, :], lg,
                     torch.full_like(lg, -1e30))
    lg_new = (qs * kn[:, :, :, None, :]).sum(-1, keepdim=True)
    m = torch.maximum(lg.amax(-1, keepdim=True), lg_new)
    p, p_new = torch.exp(lg - m), torch.exp(lg_new - m)
    den = p.sum(-1, keepdim=True) + p_new
    out = (torch.einsum("nbhgt,nhbtd->nbhgd", p, vc)
           + p_new * vn[:, :, :, None, :]) / den
    _slot(cm, ws, dst, hqd).copy_(out.reshape(n, B, hqd).to(ws.dtype))


def _plain_nothing(*_):
    pass


_PLAIN = {"matmul": _plain_matmul, "rms_norm": _plain_rms_norm,
          "silu_mul": _plain_silu_mul, "add": _plain_add,
          "allreduce_add": _plain_allreduce_add,
          "attention": _plain_attention, "barrier": _plain_nothing,
          "noop": _plain_nothing}

"""Qwen3 megakernel decode — port of triton_dist_tpu.mega.qwen3.

The whole layer stack of one decode step is one task graph
(`build_qwen3_graph`), ordered by the scheduler and compiled to one queue
(kernel.py); a decode step is then the embed gather, one launch of the
CUDA megakernel (csrc/mega.cu) over every rank of the virtual world, the
lm_head product per rank (torch), the logits gathered across ranks and
the KV scatter of the step's k_new/v_new rows (torch indexing). The JAX
package leaves the same four to XLA (qwen3.py:410-483).

Weights are the port's `DenseLLMParams` with the rank dim, as
`init_params`, `params_from_jax` and `shard_params` give them: no other
weight-carrying function is needed. The fused [gate|up] copy is made once
at init, tile-major at the kernel's gate|up tile width (JAX qwen3.py:
276-300: each tile one contiguous block, streamed as bulk copies), and
the model's own params drop the split w_gate / w_up (a `_replace` copy:
the caller's params keep them, for an Engine that shares them).

Caches keep the JAX layouts, the kv heads global with rank r's at
[r*Hkv/n, (r+1)*Hkv/n): `MegaKVCache` (L, Hkv, B, S_max, D) and
`PagedMegaKVCache`, shared page pools (L, Hkv, pages, page, D) with a
(B, MAXP) page table and a bump allocator. The dense cache walks an
identity page table over its own page grid, so one kernel path serves
both. Unlike the JAX caches, which are donated through each jit'd step,
a step writes its k/v rows into the cache tensors and advances its
`length` (a paged cache also its table and `next_free`) in place, and
returns the cache it was given.

On the card the step (embed, launch, `logits_from`, KV scatter, the
greedy token) is captured once a cache layout and shape as a CUDA graph
(runtime/graphs.py; at most 8 graphs) that owns its cache: the cache a
call brings is bound to the graph's (`Resident`: copied in the first
time, then views of the graph's memory), so a fresh cache replays the
same graph. `decode_step` and `decode_resident` replay it, the token
copied into the graph's static buffer or, in `decode_resident`, fed back
on the card: the JAX package jits the same step.
`MegaQwen3(cuda_graph=False)` runs the same step function eagerly (A/B
runs, tests); the CPU is always eager.

Dropped from the JAX class: the head_dim % 128 check (Mosaic's), and
`straggler`, `num_cores` and the trace build (test and TPU knobs; see
ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from triton_dist_tpu_torch.layers.linear import dot_f32
from triton_dist_tpu_torch.layers.rope import rope_table
from triton_dist_tpu_torch.mega.builder import ModelBuilder
from triton_dist_tpu_torch.mega.kernel import (
    CompiledMega,
    _kv_chunk,
    blocks_per_rank,
    compile_graph,
    tile_weight_major,
)
from triton_dist_tpu_torch.mega.scheduler import (
    schedule_graph,
    validate_schedule,
)
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import (
    DenseLLMParams,
    check_world,
    init_params,
)
from triton_dist_tpu_torch.runtime.device import resolve_device
from triton_dist_tpu_torch.runtime.graphs import (
    GraphCache,
    Resident,
    StepGraph,
    shape_key,
)


class MegaKVCache(NamedTuple):
    """Decode cache in megakernel layout (L, Hkv, B, S_max, D)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32

    @staticmethod
    def create(cfg: ModelConfig, batch: int, s_max: int, hkv: int,
               device=None) -> "MegaKVCache":
        device = resolve_device(device)
        shape = (cfg.num_layers, hkv, batch, s_max, cfg.head_dim)
        dt = cfg.torch_dtype
        return MegaKVCache(torch.zeros(shape, dtype=dt, device=device),
                           torch.zeros(shape, dtype=dt, device=device),
                           torch.zeros((batch,), dtype=torch.int32,
                                       device=device))

    @staticmethod
    def from_dense(cache, s_max: Optional[int] = None) -> "MegaKVCache":
        """The port's KVCache (L, n*B, T, Hkv/n, D), e.g. an Engine
        prefill's, in megakernel layout, padded to s_max positions."""
        k, v = cache.jax_layout()  # (L, B, T, Hkv, D)
        t = k.shape[2]
        pad = 0 if s_max is None else s_max - t
        if pad < 0:
            raise ValueError(f"cache of {t} positions is longer than the "
                             f"megakernel's s_max {s_max}")

        def conv(x):
            x = x.permute(0, 3, 1, 2, 4)  # (L, Hkv, B, T, D)
            return torch.nn.functional.pad(x, (0, 0, 0, pad)).contiguous()

        return MegaKVCache(conv(k), conv(v),
                           cache.length.to(torch.int32).clone())


class PagedMegaKVCache(NamedTuple):
    """Paged decode cache: k/v are shared page pools (L, Hkv, n_pages,
    PAGE, D); `table` (B, MAXP) int32 maps (sequence, page index) to a
    pool page, allocated on demand by the bump allocator `next_free` as
    sequences grow, so ragged batches take pool pages in proportion to
    their lengths."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor      # (B, MAXP) int32; 0 until allocated
    length: torch.Tensor     # (B,) int32
    next_free: torch.Tensor  # () int32 bump-allocator head

    @staticmethod
    def create(cfg: ModelConfig, batch: int, hkv: int, page: int,
               max_pages: int, total_pages: int,
               device=None) -> "PagedMegaKVCache":
        device = resolve_device(device)
        shape = (cfg.num_layers, hkv, total_pages, page, cfg.head_dim)
        dt = cfg.torch_dtype

        def i32(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)

        return PagedMegaKVCache(torch.zeros(shape, dtype=dt, device=device),
                                torch.zeros(shape, dtype=dt, device=device),
                                i32(batch, max_pages), i32(batch), i32())

    @staticmethod
    def from_dense(cache, page: int, total_pages: int,
                   max_pages: int) -> "PagedMegaKVCache":
        """Page an Engine prefill cache (the port's KVCache): each
        sequence's valid prefix (cache.length, not the allocated T) takes
        ceil(len/page) consecutive pool pages in sequence order, so
        next_free == sum_b ceil(len_b / page). The lengths are read on the
        host."""
        k, v = cache.jax_layout()  # (L, B, T, Hkv, D)
        L, B, T, Hkv, D = k.shape
        if T % page:
            raise ValueError(f"cache length {T} % page {page}")
        lengths = cache.length.cpu().numpy()
        pages_per = -(-lengths // page)
        used = int(pages_per.sum())
        if used > total_pages:
            raise ValueError("pool too small for the prefill")
        if int(pages_per.max(initial=0)) > max_pages:
            raise ValueError("prefill longer than the table's max_pages")
        dev = k.device
        src_b = torch.as_tensor(np.repeat(np.arange(B), pages_per),
                                device=dev)
        src_p = torch.as_tensor(
            np.concatenate([np.arange(p) for p in pages_per])
            if used else np.zeros((0,), np.int64), device=dev)

        def pool(x):
            grid = x.permute(0, 3, 1, 2, 4).reshape(L, Hkv, B, T // page,
                                                    page, D)
            out = torch.zeros((L, Hkv, total_pages, page, D), dtype=x.dtype,
                              device=dev)
            out[:, :, :used] = grid[:, :, src_b, src_p]
            return out

        table = np.zeros((B, max_pages), np.int32)
        off = 0
        for b in range(B):
            table[b, :pages_per[b]] = np.arange(off, off + pages_per[b])
            off += int(pages_per[b])
        return PagedMegaKVCache(
            pool(k), pool(v), torch.as_tensor(table, device=dev),
            cache.length.to(torch.int32).clone(),
            torch.tensor(used, dtype=torch.int32, device=dev))


def build_qwen3_graph(cfg: ModelConfig, batch: int, world: int, s_max: int,
                      axis: str = "tp", page: int = 0
                      ) -> Tuple[ModelBuilder, dict]:
    """The decode-step task graph (the JAX function, qwen3.py:138).

    Norms-array row layout (stacked into one (4L+1, NW) input):
      [0,L) input_ln · [L,2L) post_attn_ln · [2L] final_ln ·
      [2L+1,3L+1) q_norm · [3L+1,4L+1) k_norm
    """
    n = world
    L = cfg.num_layers
    H = cfg.hidden_size
    D = cfg.head_dim
    hq_l = cfg.num_q_heads // n
    hkv_l = cfg.num_kv_heads // n
    i_l = cfg.intermediate_size // n
    wqkv = (hq_l + 2 * hkv_l) * D

    mb = ModelBuilder(batch, axis, world=n)
    x = mb.buffer(H, "x", pinned=True)
    mb.make_barrier()
    kn_bufs, vn_bufs = [], []
    for l in range(L):
        qkv = mb.make_rms_matmul("w_qkv", l, x, H, wqkv, norm_row=l,
                                 eps=cfg.rms_eps, tag=f"ln1+qkv[{l}]")
        attn, kn, vn = mb.make_attention(
            l, qkv, hq_l, hkv_l, D, s_max, cfg.rms_eps, cfg.use_qk_norm,
            q_norm_base=2 * L + 1, k_norm_base=3 * L + 1, page=page,
        )
        kn_bufs.append(kn)
        vn_bufs.append(vn)
        o = mb.make_matmul("w_o", l, attn, hq_l * D, H, tag=f"o[{l}]")
        x = mb.make_allreduce_add(o, x, H, tag=f"ar_attn[{l}]")
        gu = mb.make_rms_matmul("w_gate_up", l, x, H, 2 * i_l,
                                norm_row=L + l, eps=cfg.rms_eps,
                                tag=f"ln2+gate_up[{l}]")
        dn = mb.make_act_matmul("w_down", l, gu, i_l, H,
                                tag=f"silu+down[{l}]")
        x = mb.make_allreduce_add(dn, x, H, tag=f"ar_mlp[{l}]")
    final = mb.make_rms_norm(2 * L, x, H, cfg.rms_eps, tag="final_ln")
    mb.graph.pinned[final.id] = True
    meta = dict(input_buf=0, final=final, kn_bufs=kn_bufs, vn_bufs=vn_bufs,
                hq_l=hq_l, hkv_l=hkv_l, i_l=i_l, wqkv=wqkv)
    return mb, meta


class MegaQwen3:
    """Engine-compatible decode over the megakernel.

    decode_step has models.engine.Engine.decode_step's contract: tokens
    (B,) -> (logits (B, V) f32, cache). Prefill runs through the regular
    Engine (the megakernel covers decode, as in the reference);
    MegaKVCache.from_dense / paged_cache_from_dense bridge the layouts.

    device: "cuda" by default, where every step is one `mega` launch;
    "cpu" runs the kernel's plain version (kernel.run_plain). world: the
    tensor-parallel size n, run as n ranks of one launch on the one card.
    cuda_graph: on the card, replay the step as a captured CUDA graph;
    False runs it eagerly. donate_cache: step the caller's cache in place
    (True, the JAX default) or a copy of it, leaving the caller's as it
    was (on the card the graph then binds the copy).
    """

    def __init__(self, cfg: ModelConfig, world: int = 1, batch: int = 1,
                 s_max: Optional[int] = None,
                 params: Optional[DenseLLMParams] = None, device=None,
                 paged: bool = False, page_size: Optional[int] = None,
                 total_pages: Optional[int] = None, seed: int = 0,
                 cuda_graph: bool = True, donate_cache: bool = True):
        if cfg.is_moe:
            raise ValueError("the megakernel covers the dense decode graph")
        check_world(cfg, world)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.world = world
        self.batch = batch
        self.s_max = s_max or cfg.max_positions
        if self.s_max > cfg.max_positions:
            raise ValueError(f"s_max {self.s_max} exceeds the rope table's "
                             f"{cfg.max_positions} positions")
        self.hkv_loc = cfg.num_kv_heads // world
        self.params = (params if params is not None else
                       init_params(cfg, self.device, seed=seed, world=world))
        if self.params.world_size != world:
            raise ValueError(f"params are sharded over "
                             f"{self.params.world_size} ranks, the model runs "
                             f"{world}: see dense.shard_params")
        self.dtype = cfg.torch_dtype

        self.paged = paged
        self.page = page_size or _kv_chunk(self.s_max)
        if self.s_max % self.page:
            raise ValueError(f"s_max {self.s_max} % page {self.page}")
        self.max_pages = self.s_max // self.page
        self.total_pages = (total_pages if total_pages is not None
                            else batch * self.max_pages)

        mb, meta = build_qwen3_graph(
            cfg, batch, world, self.s_max,
            page=self.page if paged else (page_size or 0))
        self.graph = mb.graph
        blocks = blocks_per_rank(self.device, world)
        self.sched = schedule_graph(self.graph, blocks=blocks)
        validate_schedule(self.graph, self.sched)
        self.cm: CompiledMega = compile_graph(
            self.graph, self.sched, self.dtype, blocks=blocks, world=world,
            tiled_weights=("w_gate_up",))
        self._meta = meta

        lp = self.params.layers
        self._weights = {"w_qkv": lp.w_qkv, "w_o": lp.w_o,
                         "w_gate_up": self._tiled_gate_up(lp),
                         "w_down": lp.w_down}
        # the kernel never reads the split copies: the model's own params
        # drop them (a caller's params object keeps its own)
        self.params = self.params._replace(
            layers=lp._replace(w_gate=None, w_up=None))
        cos, sin = rope_table(cfg.head_dim, cfg.max_positions,
                              cfg.rope_theta, device=self.device)
        self._rope_cs = torch.cat([cos, sin], dim=-1).contiguous()
        self._norms = self._stack_norms()
        self._ws = self.cm.workspace(self.device)

        slot = self.sched.buf_slot
        self._x_slot = int(slot[meta["input_buf"]])
        self._final_slot = int(slot[meta["final"].id])
        self._kn_slots = torch.as_tensor(
            [int(slot[b.id]) for b in meta["kn_bufs"]], device=self.device)
        self._vn_slots = torch.as_tensor(
            [int(slot[b.id]) for b in meta["vn_bufs"]], device=self.device)
        self._schunk = _kv_chunk(self.s_max, self.page if paged
                                 else (page_size or 0))
        nch = self.s_max // self._schunk
        self._ident_table = torch.arange(
            batch * nch, dtype=torch.int32,
            device=self.device).reshape(batch, nch)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.donate_cache = donate_cache
        self.graphs = GraphCache(8)

    def _tiled_gate_up(self, lp) -> torch.Tensor:
        """[gate | up] (L, n, H, 2I/n) tile-major (L, n, 2I/n // tn, H, tn)
        at the kernel's gate|up tile width, a layer at a time (no full
        row-major copy is ever held)."""
        tn = self.cm.tile_cols("w_gate_up")
        g, u = lp.w_gate, lp.w_up
        L, n, h, i = g.shape
        out = torch.empty((L, n, 2 * i // tn, h, tn), dtype=g.dtype,
                          device=g.device)
        for layer in range(L):
            out[layer] = tile_weight_major(
                torch.cat([g[layer], u[layer]], -1), tn)
        return out

    def _stack_norms(self) -> torch.Tensor:
        """(4L+1, NW) f32 in the row layout of build_qwen3_graph."""
        nw = self.cm.norm_width
        lp = self.params.layers

        def pad_to(v):
            v = v.float().reshape(-1, v.shape[-1])
            return torch.nn.functional.pad(v, (0, nw - v.shape[-1]))

        return torch.cat([pad_to(lp.input_ln), pad_to(lp.post_attn_ln),
                          pad_to(self.params.final_ln), pad_to(lp.q_norm),
                          pad_to(lp.k_norm)]).contiguous()

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        return torch.as_tensor(np.array(tokens), dtype=torch.int64,
                               device=self.device)

    def _step(self, tokens: torch.Tensor, cache, commit: bool = True):
        """One step over `cache`, in place: the logits (B, V) f32. With
        commit=False (a graph's warm-up) the same rows are written but
        the length and the allocator head stay (the table entries a step
        claims are rewritten alike by the next call)."""
        cfg = self.cfg
        L, H, D = cfg.num_layers, cfg.hidden_size, cfg.head_dim
        B, n = self.batch, self.world
        ws = self._ws
        ws[:, self._x_slot, :, :H] = self.params.embed[tokens]
        pos = cache.length.to(torch.int32)
        if isinstance(cache, PagedMegaKVCache):
            k_pool, v_pool, table = cache.k, cache.v, cache.table
        else:
            grid = (L, cache.k.shape[1], -1, self._schunk, D)
            k_pool, v_pool = cache.k.view(grid), cache.v.view(grid)
            table = self._ident_table
        self.cm.run(pos, table, ws, self._weights, self._norms,
                    self._rope_cs, k_pool, v_pool)

        logits = self.logits_from(ws)

        # the step's k/v rows out of the workspace, at each sequence's
        # position: rank r's heads at [r*Hkv/n, (r+1)*Hkv/n)
        kw = self.hkv_loc * D

        def rows(slots):
            r = ws[:, slots, :, :kw].reshape(n, L, B, self.hkv_loc, D)
            return r.permute(1, 0, 3, 2, 4).reshape(L, n * self.hkv_loc, B,
                                                    D)

        kn, vn = rows(self._kn_slots), rows(self._vn_slots)
        bidx = torch.arange(B, device=self.device)
        length = cache.length.long()
        if isinstance(cache, PagedMegaKVCache):
            # bump allocation: a sequence entering a fresh page claims the
            # next pool page this step
            pidx = length // self.page
            need = (length % self.page) == 0
            needi = need.to(torch.int32)
            new_ids = cache.next_free + torch.cumsum(needi, 0) - needi
            cur = cache.table[bidx, pidx]
            cache.table[bidx, pidx] = torch.where(need, new_ids.to(
                torch.int32), cur)
            slots = cache.table[bidx, pidx].long()
            offs = length % self.page
            cache.k[:, :, slots, offs] = kn
            cache.v[:, :, slots, offs] = vn
            if commit:
                cache.next_free.add_(needi.sum().to(torch.int32))
                cache.length.add_(1)
            return logits
        cache.k[:, :, bidx, length] = kn
        cache.v[:, :, bidx, length] = vn
        if commit:
            cache.length.add_(1)
        return logits

    def _step_fn(self, cache, tok: torch.Tensor):
        """The step, step(commit) -> (logits, tok): the token in `tok`
        (B,) through `_step`, then the greedy token, fed back into `tok`
        with commit. A graph captures it; the eager routes call it."""

        def step(commit: bool):
            logits = self._step(tok, cache, commit)
            nxt = torch.argmax(logits, dim=-1)
            if commit:
                tok.copy_(nxt)
            return logits, tok

        return step

    def _graph(self, cache, tok: torch.Tensor) -> StepGraph:
        """The captured step for caches of `cache`'s layout and shapes:
        reads the static token `.tok` (B,), updates its own cache
        `.state` and feeds the greedy token back into `.tok`; outputs
        (logits, tok). A new graph binds `cache` and warms up on `tok`,
        the step's own state."""
        key = (type(cache).__name__, shape_key(*cache))

        def make():
            state = Resident(cache)
            state.bind(cache)
            static = tok.clone()
            g = StepGraph(self._step_fn(type(cache)(*state.tensors), static),
                          self.device)
            g.state, g.tok = state, static
            return g

        return self.graphs.get(key, make)

    def _replayed(self, cache, tok: torch.Tensor, steps: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`steps` replays of the captured step from token `tok` over
        `cache`, bound to the graph's; out[:, i] gets the i-th token.
        Returns the last logits (the graph's buffer)."""
        g = self._graph(cache, tok)
        g.state.bind(cache)
        g.tok.copy_(tok)
        for i in range(steps):
            logits, nxt = g.replay()
            if out is not None:
                out[:, i] = nxt
        return logits

    # -- public API ----------------------------------------------------------

    def logits_from(self, ws: torch.Tensor) -> torch.Tensor:
        """(B, V) f32 logits of a step's workspace: each rank's final
        hidden rows times its lm_head slice, gathered along the vocab."""
        hidden = ws[:, self._final_slot, :, :self.cfg.hidden_size]
        logits = dot_f32(hidden, self.params.lm_head)  # (n, B, V/n)
        return logits.permute(1, 0, 2).reshape(self.batch, -1)

    def new_cache(self) -> MegaKVCache:
        return MegaKVCache.create(self.cfg, self.batch, self.s_max,
                                  self.cfg.num_kv_heads, self.device)

    def new_paged_cache(self) -> PagedMegaKVCache:
        if not self.paged:
            raise ValueError("construct MegaQwen3 with paged=True")
        return PagedMegaKVCache.create(self.cfg, self.batch,
                                       self.cfg.num_kv_heads, self.page,
                                       self.max_pages, self.total_pages,
                                       self.device)

    def paged_cache_from_dense(self, cache) -> PagedMegaKVCache:
        if not self.paged:
            raise ValueError("construct MegaQwen3 with paged=True")
        return PagedMegaKVCache.from_dense(cache, self.page,
                                           self.total_pages, self.max_pages)

    def _stepped(self, cache):
        """The cache a step advances: the caller's, or with
        donate_cache=False a copy of it."""
        if self.donate_cache:
            return cache
        return type(cache)(*(t.clone() for t in cache))

    def decode_step(self, tokens, cache):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache returned
        advanced (the one given, or its copy with donate_cache=False). On
        the card a replay of the captured step."""
        tok = self._tokens(tokens)
        cache = self._stepped(cache)
        if not self.cuda_graph:
            return self._step_fn(cache, tok.clone())(True)[0], cache
        return self._replayed(cache, tok, 1).clone(), cache

    def decode_resident(self, tokens, cache, steps: int):
        """`steps` decode steps with the greedy token fed back on the
        device (argmax, no host sync between steps): tokens (B,) ->
        (generated ids (B, steps) int32, cache). Bitwise equal to
        `steps` repeated decode_step + argmax calls."""
        if steps < 1:
            raise ValueError("steps must be at least 1")
        tok = self._tokens(tokens)
        cache = self._stepped(cache)
        out = torch.empty((self.batch, steps), dtype=torch.int32,
                          device=self.device)
        if self.cuda_graph:
            self._replayed(cache, tok, steps, out)
            return out, cache
        step = self._step_fn(cache, tok.clone())
        for i in range(steps):
            out[:, i] = step(True)[1]
        return out, cache

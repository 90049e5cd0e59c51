"""Inference engine — port of triton_dist_tpu.models.engine (host loop).

Prefill, single-token decode and a serve loop over `dense.forward`, plus
the fixed-geometry serve step the continuous-batching Scheduler replays,
at world n on the virtual world of one card (runtime/symm_mem.py): the
weights carry a rank dim, the cache and the serve pool each rank's kv
heads. As in the JAX Engine, `prefill` runs `prefill_mode` (default
"dist": the sequence-sharded stream, ag_gemm on QKV and gate|up, gemm_rs
on O and down) and `decode_step`, `generate` and the serve step run
`decode_mode` (default "ar": gemm_ar, a one-shot all-reduce or gemm_rs +
ring all-gather); "xla" runs the sequence-sharded stream on torch ops.
An MoE config (Qwen3-30B-A3B) runs the same loop with the TP-MoE block
in each layer; its "fused" mode is sequence-sharded.
At world 1 every mode is the same computation.

Compiled steps: where the JAX Engine jits its decode step, rolls
`generate` into one `lax.fori_loop` and jits the serve step, the port on
the card captures each step as a CUDA graph (runtime/graphs.py) and
replays it: `decode_step` and `generate` replay one captured decode step
a token (the reference's per-step graph, Triton-distributed
models/engine.py:75-105), the sampled token fed back on the card; the
serve step replays one captured (slots, chunk) forward. A graph is kept
per Engine, keyed by the shapes that fix it: (batch, cache horizon,
greedy or the sampling temperature) for decode, (slots, chunk, page,
pages) for the serve step; at most 8 decode and 2 serve graphs, the
least recently used dropped (the JAX `_gen_cache` is bounded by shape
the same way). Each graph owns the state it updates in place, a cache
or a pair of pools, and the cache or pools a call brings are bound to it
(runtime/graphs.py `Resident`: copied in the first time, then views of
the graph's memory), so every cache of one shape, a fresh prefill's too,
replays the same graph. Inputs are copied into the graph's static
buffers before each replay. A sampled `generate` splits its JAX key on
the card each step, so the draws are bitwise the eager ones. `prefill`
is captured too, as the JAX Engine jits it (`prefill_fn`, `wrap`): one
graph per (batch, prompt length, cache shape), at most 8
(runtime/graphs.py `compiled`; `Engine.prefill_graphs`), its first call
of a shape run eagerly and captured, later calls replayed. The prefill
and decode graphs of one cache shape share one `Resident` state
(`cache_states`), so a prefill's cache goes on into `generate` with no
copy.
`Engine(cuda_graph=False)` runs every step eagerly on the card, for A/B
runs and tests, through the same step functions; the CPU is always
eager.

The cache: with `donate_cache=True` (the default, as the JAX Engine's)
`prefill` writes the prompt's K/V rows into the cache given (its length
left, the returned cache's the new one), and `decode_step` and
`generate` write the step's K/V rows and advance `cache.length` in the
cache given and return it; on the card that cache becomes a view of its
graph's state. With `donate_cache=False` each of them steps a copy and
returns it, and the cache passed in keeps its value, bitwise: the eager
route clones it, and a graph binds the clone (a prefill with no cache
needs no copy).

Sampling: greedy is argmax. With temperature > 0 a token is drawn by the
Gumbel-max rule on the JAX package's threefry key stream, by the
`sample_slots` kernel (kernels/sample.py): the serve step samples each
slot under the key the caller derives from (request seed, output token
index) (`serve.worker.sampling_key`, as the JAX Worker), so a request's
sampled tokens do not depend on scheduling and equal the JAX package's;
`serve` and `generate` follow the JAX `PRNGKey(seed)` / `split` chain.

The resident loop (`make_resident_loop`, JAX engine.py:371): a window of
up to W serve steps in one call, the work injected through the ring of
mega/ring.py and consumed on the card at each step boundary. On the card
the window is one CUDA graph of W unrolled steps, each `ring_boundary`
(kernels/ring.py) -> the serve forward -> `sample_slots` -> `ring_emit`,
then a final `ring_boundary`; the loop's exit is a device word, so the
steps after it run dead (no live row; their KV writes land on the null
page 0). The host writes the window's inputs once and reads its state
block back once. On the CPU the window is a Python loop over the same
functions' plain versions, stopping at the exit.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import ring as kring
from triton_dist_tpu_torch.kernels.sample import (
    as_int32,
    key_words,
    sample_slots,
    seed_key,
    split,
)
from triton_dist_tpu_torch.mega import ring as mring
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import (
    SEQ_SHARDED_MODES,
    DenseLLMParams,
    forward,
    init_params,
)
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.runtime.device import check_modes, resolve_device
from triton_dist_tpu_torch.runtime.graphs import (
    GraphCache,
    Resident,
    StepGraph,
    compiled,
    shape_key,
)
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


def _key_rows(key, rows: int, device) -> torch.Tensor:
    """A JAX key's words as the (rows, 2) int32 of one shared draw."""
    w = torch.as_tensor(as_int32(key_words(key)), device=device)
    return w.expand(rows, 2).contiguous()


def _serve_forward(cfg: ModelConfig, mode: str, slots: int, chunk: int,
                   page: int, t_pool: int, params: DenseLLMParams, tokens,
                   pool_k, pool_v, table, lengths, n_valid):
    """One fixed-geometry (slots, chunk) forward over the paged pool's
    dense view, the logits at column n_valid - 1, and the KV scatter back
    into the pool with padding columns routed to the null page 0:
    everything of the serve step before the sampling, with no host read
    (a CUDA graph captures it). tokens (K, C), table (K, MAXP), lengths
    (K,), n_valid (K,) are int64 tensors on the pool's device; pool_k /
    pool_v are updated in place. Returns last_logits (K, V) f32."""
    dev = tokens.device
    n = params.world_size
    cache = KVCache.dense_view(pool_k, pool_v, table, lengths, n)
    logits, new_cache = forward(cfg, params, tokens, cache, mode=mode,
                                return_full_logits=True)  # (K, C, V)
    bidx = torch.arange(slots, device=dev)
    last = logits[bidx, (n_valid - 1).clamp(min=0)]  # (K, V)

    # this step's K/V rows back into the pool: valid columns land on
    # their table pages; padding columns go to the null page 0 (their
    # positions may lie past the slot's pages, where the table still
    # maps live pages of other slots). Rank r's rows hold its heads.
    col = torch.arange(chunk, device=dev)
    posc = (lengths[:, None] + col[None, :]).clamp(max=t_pool - 1)
    valid = col[None, :] < n_valid[:, None]
    pg = torch.where(valid, table[bidx[:, None], posc // page], 0)
    off = posc % page
    for pool, dense in ((pool_k, new_cache.k), (pool_v, new_cache.v)):
        L, _, t, h, d = dense.shape
        rows = dense.reshape(L, n, slots, t, h, d)[:, :, bidx[:, None], posc]
        # (L, n, K, C, Hkv/n, D) -> (L, Hkv, K, C, D)
        rows = rows.permute(0, 1, 4, 2, 3, 5).reshape(L, n * h, slots,
                                                       chunk, d)
        pool[:, :, pg, off] = rows.to(pool.dtype)
    return last


def _prefill_step(cfg: ModelConfig):
    """The prefill as a step function of its state: step(ids (B, S),
    cache (k, v, length), params, mode) -> (last-token logits (B, V)
    f32, the new length (B,)); the prompt's K/V rows are written into k
    and v in place, length is left."""

    def step(ids, cache, params, mode):
        logits, new = forward(cfg, params, ids, KVCache(*cache), mode=mode)
        return logits, new.length

    return step


class WindowResult(NamedTuple):
    """A resident window's outputs (the JAX loop's contract), host side:
    the ring's consumed count, the live steps executed, the slot state
    (K, 16), table (K, MAXP) and lengths (K,) int32, the output ring's
    first out_count records (out_count, 8) int32, out_count, and whether
    the head record was found abandoned."""

    consumed: int
    executed: int
    slot_state: np.ndarray
    table: np.ndarray
    lengths: np.ndarray
    out_ring: np.ndarray
    out_count: int
    starved: bool


class ResidentLoop:
    """The resident serving loop of one geometry (`Engine.
    make_resident_loop`), callable once a window:

      loop(ring (cap, RW) int32 on the engine's device, published,
           consumed, step0, slot_state (K, 16), table (K, MAXP),
           lengths (K,) (host int32 arrays), pool_k, pool_v,
           steps=None) -> WindowResult

    `steps` (default the loop's `window`, at most it) is this window's
    length W: the loop's exit rule is `executed < W`. The window's state
    is one int32 block on the device (kernels/ring.py `WindowGeometry`):
    the call writes its inputs (the counters, the slot state, the table
    and the lengths) with one copy, runs up to W steps, and reads the
    block back with one copy, `reads` counting the reads. The pools are
    updated in place. On the card a window of W steps is the replay of
    one captured graph of W unrolled steps (`graphs[W]`, captured at the
    first window of that length); the graphs share one `Resident` state,
    which owns the pools the call's are bound to, as the serve step's
    does, and one graph memory pool (`graph_pool`): they replay one at a
    time, and their state (the block, the step buffers, the ring, the
    pools) lives outside it. `ring` is the loop's ring buffer, which a caller may fill
    (`upload_ring`) and pass (else the call copies the ring given into
    it). The inputs go through pinned staging, so a window's one
    synchronisation is its read."""

    def __init__(self, engine: "Engine", slots: int, chunk: int, page: int,
                 max_pages: int, window: int, ring_cap: int,
                 prompt_cap: int, poll_budget: int):
        if window < 1 or ring_cap < 2 or poll_budget < 1:
            raise ValueError("a resident loop needs window >= 1, ring_cap "
                             ">= 2 and poll_budget >= 1")
        if not 1 <= slots <= kring.MAX_SLOTS:
            raise ValueError(f"{slots} slots: the resident loop takes 1 to "
                             f"{kring.MAX_SLOTS}")
        # the engine holds its loops: a weak reference back, so a dropped
        # engine frees its loops' graphs at once, not at a collection
        self._engine = weakref.ref(engine)
        self.page = page
        self.t_pool = max_pages * page
        # every step may emit on every slot, plus one token-less record
        # per host retirement the ring can carry
        self.geo = kring.WindowGeometry(slots, chunk, max_pages,
                                        window * slots + ring_cap, window,
                                        poll_budget)
        dev = engine.device
        self.ring = torch.zeros(
            (ring_cap, mring.ring_width(max_pages, prompt_cap, chunk)),
            dtype=torch.int32, device=dev)
        self.blk = self.geo.new_block(dev)
        self.bufs = kring.StepBuffers.create(self.geo, dev)
        # host staging of the window's inputs and of the ring: pinned on
        # the card, so their copies are queued on the stream and sync
        # nothing (the window's read comes after them)
        pin = dev.type == "cuda"
        self._inputs = torch.zeros((self.geo.out_at,), dtype=torch.int32,
                                   pin_memory=pin)
        self._ring_host = torch.zeros(self.ring.shape, dtype=torch.int32,
                                      pin_memory=pin)
        self.graphs: dict = {}  # window length -> StepGraph
        self.graph_pool = None  # the graphs' one memory pool, on the card
        self.state: Optional[Resident] = None
        self.reads = 0

    @property
    def engine(self) -> "Engine":
        return self._engine()

    def upload_ring(self, buf: np.ndarray) -> None:
        """The host ring `buf` (cap, RW) int32 into the loop's ring buffer,
        queued on the current stream."""
        self._ring_host.numpy()[...] = buf
        self.ring.copy_(self._ring_host, non_blocking=True)

    def _window(self, pool_k, pool_v, steps: int, stop_early: bool) -> None:
        """A window's steps over the state block: `steps` unrolled steps
        (or, with stop_early, until the loop's exit, read on the host),
        then the final boundary."""
        eng, bufs = self.engine, self.bufs
        geo = self.geo._replace(window=steps)
        for _ in range(steps):
            kring.ring_boundary(self.ring, self.blk, geo, bufs)
            if stop_early and not int(self.blk[kring.H_STEP_LIVE]):
                break
            last = _serve_forward(eng.cfg, eng.decode_mode, geo.slots,
                                  geo.chunk, self.page, self.t_pool,
                                  eng.params, bufs.tokens, pool_k, pool_v,
                                  bufs.table, bufs.lengths, bufs.n_valid)
            tok = sample_slots(last, bufs.keys, bufs.temps)
            kring.ring_emit(tok, self.blk, geo, bufs)
        kring.ring_boundary(self.ring, self.blk, geo, bufs, final=True)

    def _capture(self, pool_k, pool_v, steps: int) -> StepGraph:
        """A window of `steps` steps as one graph; its warm-up runs the
        window eagerly on the call's state and puts the block back (the
        pools' rows it wrote are the ones the first replay rewrites)."""
        if self.state is None:
            self.state = Resident((pool_k, pool_v))
        self.state.bind((pool_k, pool_v))

        def fn(commit: bool):
            if not commit:
                saved = self.blk.clone()
            self._window(*self.state.tensors, steps, stop_early=False)
            if not commit:
                self.blk.copy_(saved)

        if self.graph_pool is None:
            self.graph_pool = torch.cuda.graph_pool_handle()
        return StepGraph(fn, self.engine.device, pool=self.graph_pool)

    def __call__(self, ring, published: int, consumed: int, step0: int,
                 slot_state, table, lengths, pool_k, pool_v,
                 steps: Optional[int] = None) -> WindowResult:
        geo = self.geo
        steps = geo.window if steps is None else steps
        if not 1 <= steps <= geo.window:
            raise ValueError(f"a window of {steps} steps: the loop takes 1 "
                             f"to {geo.window}")
        if ring.data_ptr() != self.ring.data_ptr():
            self.ring.copy_(ring)
        inputs = self._inputs.numpy()
        inputs[:kring.HEADER_WORDS] = 0
        inputs[kring.H_PUBLISHED] = published
        inputs[kring.H_CONSUMED] = consumed
        inputs[kring.H_STEP0] = step0
        inputs[kring.H_LIVE] = 1
        for at, x in ((geo.ss_at, slot_state), (geo.table_at, table),
                      (geo.lengths_at, lengths)):
            x = np.asarray(x, np.int32).ravel()
            inputs[at:at + x.size] = x
        self.blk[:geo.out_at].copy_(self._inputs, non_blocking=True)
        eng = self.engine
        if not eng.cuda_graph:
            self._window(pool_k, pool_v, steps,
                         stop_early=eng.device.type == "cpu")
        else:
            g = self.graphs.get(steps)
            if g is None:
                g = self.graphs[steps] = self._capture(pool_k, pool_v, steps)
            self.state.bind((pool_k, pool_v))
            g.replay()
        blk = self.blk.cpu().numpy()  # the window's one read
        self.reads += 1
        hdr, ss, tb, ln, out = geo.views(torch.from_numpy(blk))
        count = int(hdr[kring.H_OUT_COUNT])
        return WindowResult(
            consumed=int(hdr[kring.H_CONSUMED]),
            executed=int(hdr[kring.H_EXECUTED]), slot_state=ss.numpy(),
            table=tb.numpy(), lengths=ln.numpy(),
            out_ring=out[:count].numpy(), out_count=count,
            starved=bool(hdr[kring.H_STARVED]))


class Engine:
    """Parameters on one card plus prefill / decode / serve entry points.

    device: "cuda" by default; "cpu" runs every kernel's plain version.
    world: tensor-parallel size n, run as a virtual world of n ranks on
    the one device. prefill_mode / decode_mode: the JAX package's mode
    strings, "dist", "xla" or "ar" (an MoE config also "fused"), with its
    defaults. Dense and MoE configs share the Engine. cuda_graph: on the
    card, replay each prefill, decode and serve step as a captured CUDA
    graph (the module docstring); False runs them eagerly. donate_cache:
    step the caller's cache in place (True, the JAX default) or a copy
    of it."""

    def __init__(self, cfg: ModelConfig, device=None,
                 params: Optional[DenseLLMParams] = None, seed: int = 0,
                 max_len: Optional[int] = None, world: int = 1,
                 prefill_mode: str = "dist", decode_mode: str = "ar",
                 cuda_graph: bool = True, donate_cache: bool = True):
        check_modes(prefill_mode, decode_mode, cfg.is_moe)
        self.cfg = cfg
        self.prefill_mode = prefill_mode
        self.decode_mode = decode_mode
        self.device = resolve_device(device)
        self.world = VirtualWorld(world, self.device)
        self.max_len = max_len or cfg.max_positions
        if self.max_len > cfg.max_positions:
            raise ValueError(f"max_len {self.max_len} exceeds the rope "
                             f"table's {cfg.max_positions} positions")
        self.params = (params if params is not None
                       else init_params(cfg, self.device, seed=seed,
                                        world=world))
        if self.params.world_size != world:
            raise ValueError(f"params are sharded over "
                             f"{self.params.world_size} ranks, the engine "
                             f"runs {world}: see dense.shard_params")
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.donate_cache = donate_cache
        self.decode_graphs = GraphCache(8)
        self.serve_graphs = GraphCache(2)
        self.resident_loops: dict = {}
        # the graphs' cache state, one a cache shape, shared by the
        # prefill and decode graphs of that shape (held by the graphs)
        self.cache_states = weakref.WeakValueDictionary()
        self._prefill = compiled(_prefill_step(cfg), state=("cache",),
                                 static=("params",),
                                 states=self.cache_states)
        self.prefill_graphs = self._prefill.graphs

    def _ids(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=self.device)

    def new_cache(self, batch: int) -> KVCache:
        cfg = self.cfg
        return KVCache.create(cfg.num_layers, batch, self.max_len,
                              cfg.num_kv_heads, cfg.head_dim,
                              cfg.torch_dtype, self.device, self.world.n)

    def prefill(self, input_ids, cache: Optional[KVCache] = None):
        """input_ids (B, S) -> (last-token logits (B, V) f32, cache): the
        prompt's K/V rows written into the cache given (or a fresh one),
        or with donate_cache=False into a copy of it, the returned cache
        holding the new length. On the card a replay of the captured
        prefill of that shape (the first call of a shape captures)."""
        ids = self._ids(input_ids)
        cache = (self.new_cache(ids.shape[0]) if cache is None
                 else self._stepped(cache))
        step = self._prefill if self.cuda_graph else self._prefill.fn
        logits, length = step(ids, (cache.k, cache.v, cache.length),
                              self.params, self.prefill_mode)
        return logits, KVCache(cache.k, cache.v, length)

    def _cache_state(self, cache: KVCache) -> Resident:
        """The graphs' state for caches shaped as `cache` (made on first
        use), which the prefill and decode graphs of that shape share."""
        key = shape_key(cache.k, cache.v, cache.length)
        state = self.cache_states.get(key)
        if state is None:
            state = self.cache_states[key] = Resident(
                (cache.k, cache.v, cache.length))
        return state

    def _stepped(self, cache: KVCache) -> KVCache:
        """The cache a step advances: the caller's, or with
        donate_cache=False a copy of it."""
        return cache if self.donate_cache else cache.clone()

    def decode_step(self, tokens, cache: KVCache):
        """tokens (B,) -> (logits (B, V) f32, cache): the step's K/V rows
        written and the length advanced in the cache returned (the one
        given, or its copy with donate_cache=False). On the card a replay
        of the captured step."""
        tok = self._ids(tokens)
        cache = self._stepped(cache)
        if not self.cuda_graph:
            logits, _ = self._decode_fn(cache, tok.clone())(True)
            return logits, cache
        g = self._decode_graph(cache, tok)
        return self._replayed(g, cache, tok, 1).clone(), cache

    def generate(self, tokens, cache: KVCache, steps: int,
                 temperature: float = 0.0, key=None):
        """Decode `steps` tokens after `tokens` (B,), one forward each.
        Returns (ids (B, steps) int64, cache) as `decode_step`. Greedy at
        temperature <= 0 or with no key, as the JAX Engine.generate; else
        by its chain from the JAX key `key` ((2,) words): each step
        `key, sub = split(key)`, then categorical(sub) over the (B, V)
        logits / T. On the card each step is a replay of the captured
        step, which samples and feeds the token back on the card."""
        tok = self._ids(tokens)
        cache = self._stepped(cache)
        key_buf = None
        if key is not None and temperature > 0.0:
            key_buf = _key_rows(key, 1, self.device)
        if not self.cuda_graph:
            step = self._decode_fn(cache, tok.clone(), temperature, key_buf)
            out = [step(True)[1].clone() for _ in range(steps)]
            return torch.stack(out, dim=1), cache
        g = self._decode_graph(cache, tok, temperature, key_buf is not None)
        out = torch.empty((tok.shape[0], steps), dtype=torch.int64,
                          device=self.device)
        if key_buf is not None:
            g.key.copy_(key_buf)
        self._replayed(g, cache, tok, steps, out)
        return out, cache

    def _decode_fn(self, cache: KVCache, tok: torch.Tensor,
                   temperature: float = 0.0,
                   key: Optional[torch.Tensor] = None):
        """The decode step, step(commit) -> (logits, tok): the forward of
        the token in `tok` (B,) over `cache`, then the next token (the
        argmax, or with `key` (1, 2) int32 the JAX chain's draw at
        `temperature` under split(key)[1]); with commit it
        advances cache.length, feeds the token back into `tok` and
        advances `key` to split(key)[0], without it it leaves them (a
        graph's warm-up). A graph captures it; the eager routes call
        it."""
        keyed = key is not None
        if keyed:
            b = tok.shape[0]
            temps = torch.full((b,), float(temperature), dtype=torch.float32,
                               device=tok.device)
            key_next = torch.zeros((b, 2), dtype=torch.int32,
                                   device=tok.device)

        def step(commit: bool):
            logits, new = forward(self.cfg, self.params, tok[:, None],
                                  cache, mode=self.decode_mode)
            if keyed:
                nxt = sample_slots(logits, key.expand(b, 2).contiguous(),
                                   temps, flat=True, key_next=key_next)
            else:
                nxt = torch.argmax(logits, dim=-1)
            if commit:
                cache.length.copy_(new.length)
                tok.copy_(nxt)
                if keyed:
                    key.copy_(key_next[:1])
            return logits, tok

        # a graph of the step reads and writes these: its owner keeps them
        step.buffers = (temps, key_next) if keyed else ()
        return step

    def _decode_graph(self, cache: KVCache, tok: torch.Tensor,
                      temperature: float = 0.0,
                      keyed: bool = False) -> StepGraph:
        """The captured decode step for caches shaped as `cache`, greedy
        or, `keyed`, sampled at `temperature` by a JAX key: it reads the
        static token `.tok` (B,), writes the step's K/V rows into its own
        cache `.state`, advances its length, takes the next token (the
        argmax, or the draw under its static key `.key`, which it splits)
        and feeds it back into `.tok`; outputs (logits, tok). A new graph
        binds `cache` and warms up on `tok`, the step's own state."""
        key = (shape_key(cache.k, cache.v, cache.length),
               float(temperature) if keyed else None)

        def make():
            state = self._cache_state(cache)
            state.bind((cache.k, cache.v, cache.length))
            static = tok.clone()
            kbuf = (torch.zeros((1, 2), dtype=torch.int32,
                                device=self.device) if keyed else None)
            fn = self._decode_fn(KVCache(*state.tensors), static,
                                 temperature, kbuf)
            g = StepGraph(fn, self.device)
            g.state, g.tok, g.key = state, static, kbuf
            g.buffers = fn.buffers
            return g

        return self.decode_graphs.get(key, make)

    @staticmethod
    def _replayed(g: StepGraph, cache: KVCache, tok: torch.Tensor,
                  steps: int, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """`steps` replays of the decode graph `g` from token `tok` over
        `cache`, bound to the graph's state. out[:, i] gets the i-th
        token. Returns the last logits (the graph's buffer)."""
        g.state.bind((cache.k, cache.v, cache.length))
        g.tok.copy_(tok)
        for i in range(steps):
            logits, nxt = g.replay()
            if out is not None:
                out[:, i].copy_(nxt)
        return logits

    def serve(self, input_ids, gen_len: int, temperature: float = 0.0,
              seed: int = 0, slots: Optional[int] = None,
              chunk: Optional[int] = None, page: Optional[int] = None):
        """Prefill + gen_len decode steps. Returns ids (B, gen_len) int64.
        Sampled by the JAX Engine.serve's key chain: key = PRNGKey(seed);
        key, sub = split(key) draws the first token, key, sub =
        split(key) seeds `generate`'s chain.

        With `slots` set, the rows instead go through a fresh
        continuous-batching Scheduler at the (slots, chunk, page) serve
        geometry, row i sampling under seed + i: the sequential baseline
        the Scheduler's in-flight batching reproduces token for token."""
        if slots is not None:
            from triton_dist_tpu_torch.serve.scheduler import Scheduler

            sch = Scheduler(self, slots=slots, chunk=chunk, page=page)
            rows = (input_ids.tolist() if isinstance(input_ids, torch.Tensor)
                    else np.asarray(input_ids).tolist())
            reqs = [sch.submit(row, gen_len, temperature=temperature,
                               seed=seed + i)
                    for i, row in enumerate(rows)]
            sch.run()
            return torch.tensor([r.out_tokens for r in reqs],
                                dtype=torch.int64, device=self.device)
        key, sub = split(seed_key(seed))
        logits, cache = self.prefill(input_ids)
        b = logits.shape[0]
        if temperature > 0.0:
            tok = sample_slots(logits, _key_rows(sub, b, self.device),
                               torch.full((b,), float(temperature),
                                          dtype=torch.float32,
                                          device=self.device), flat=True)
        else:
            tok = torch.argmax(logits, dim=-1)
        if gen_len == 1:
            return tok[:, None]
        key, sub = split(key)
        rest, _ = self.generate(tok, cache, gen_len - 1, temperature,
                                key=sub)
        return torch.cat([tok[:, None], rest], dim=1)

    # -- serve step (the Scheduler's batch-of-sequence-states contract) --

    def make_serve_step(self, slots: int, chunk: int, page: int,
                        max_pages: int):
        """The step function the serve Worker calls every step:

          fn(tokens (K, C), pool_k, pool_v (L, Hkv, P, page, D) with
             rank r's heads at [r*Hkv/n, (r+1)*Hkv/n),
             table (K, MAXP), lengths (K,), n_valid (K,), temps (K,) f32,
             keys (K, 2) (JAX key words)) -> (next_token (K,) int64,
             last_logits (K, V) f32)

        next_token is the argmax where temps <= 0, else the categorical
        draw on logits / max(T, 1e-6) under the slot's key (the JAX
        serve step's rule; `sample_slots`). On the card the function
        replays the captured step (dense view, forward, last logits,
        pool scatter, sampling) after binding the pools to the graph's
        and copying the step's tensors into its static buffers. The last
        logits returned are the graph's own buffer, valid until the next
        step.

        Every step runs the model over the whole (slots, chunk) block
        whatever mix of prefill chunks and decode tokens it carries; a
        slot's row holds n_valid real tokens from its current length on,
        the rest is padding whose outputs are dropped and whose KV lands
        on the null page. The step runs `decode_mode`. The pools are
        updated in place."""
        self._check_serve_geometry(slots, chunk, page, max_pages)
        t_pool = max_pages * page
        cfg, params, mode = self.cfg, self.params, self.decode_mode
        dev = self.device

        def args(tokens, table, lengths, n_valid, temps, keys):
            def ids(x):
                return torch.as_tensor(x, device=dev).to(torch.int64)

            return (ids(tokens), ids(table), ids(lengths), ids(n_valid),
                    torch.as_tensor(temps, device=dev).to(torch.float32),
                    torch.as_tensor(as_int32(np.asarray(keys))
                                    if not isinstance(keys, torch.Tensor)
                                    else keys, device=dev).to(torch.int32))

        def run(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                keys):
            last = _serve_forward(cfg, mode, slots, chunk, page, t_pool,
                                  params, tokens, pool_k, pool_v, table,
                                  lengths, n_valid)
            return sample_slots(last, keys, temps), last

        if not self.cuda_graph:
            def step(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                     keys):
                t, tb, ln, nv, tp, ks = args(tokens, table, lengths, n_valid,
                                             temps, keys)
                return run(t, pool_k, pool_v, tb, ln, nv, tp, ks)

            return step

        def step(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                 keys):
            key = (slots, chunk, page, max_pages, shape_key(pool_k, pool_v))
            inputs = args(tokens, table, lengths, n_valid, temps, keys)

            def make():
                state = Resident((pool_k, pool_v))
                state.bind((pool_k, pool_v))
                static = [x.clone() for x in inputs]

                def fwd(commit: bool):
                    t, tb, ln, nv, tp, ks = static
                    return run(t, *state.tensors, tb, ln, nv, tp, ks)

                g = StepGraph(fwd, self.device)
                g.state, g.static = state, static
                return g

            g = self.serve_graphs.get(key, make)
            g.state.bind((pool_k, pool_v))
            for dst, src in zip(g.static, inputs):
                dst.copy_(src)
            return g.replay()

        return step

    def make_resident_loop(self, slots: int, chunk: int, page: int,
                           max_pages: int, window: int, ring_cap: int = 64,
                           prompt_cap: Optional[int] = None,
                           poll_budget: int = 8) -> ResidentLoop:
        """The resident serving loop (JAX engine.py:371, spec_k = 0): up to
        `window` serve steps a call, each consuming the injection ring's
        visible records at its boundary, running the serve step's forward
        and sampling, self-feeding decode tokens and streaming emitted
        tokens and retirements into the output ring. A call returns the
        JAX contract's outputs (`WindowResult`: consumed, executed,
        slot_state, table, lengths, out_ring, out_count, starved). The
        loop exits when `window` steps executed, or nothing is active and
        the pending records' poll budget is spent; `starved` is set when
        a published head record was never committed (an abandoned ring).
        Tokens are bitwise the host-loop Scheduler's: both run
        `_serve_forward` and `sample_slots`, and the boundary builds the
        host Scheduler's step inputs field for field. One loop is kept
        per geometry (the JAX executable cache)."""
        self._check_serve_geometry(slots, chunk, page, max_pages)
        prompt_cap = prompt_cap if prompt_cap is not None \
            else max_pages * page
        key = (slots, chunk, page, max_pages, window, ring_cap, prompt_cap,
               poll_budget)
        loop = self.resident_loops.get(key)
        if loop is None:
            loop = self.resident_loops[key] = ResidentLoop(
                self, slots, chunk, page, max_pages, window, ring_cap,
                prompt_cap, poll_budget)
        return loop

    def _check_serve_geometry(self, slots: int, chunk: int, page: int,
                              max_pages: int) -> None:
        """The JAX Engine's check (engine.py:353-367): the pool horizon
        within the rope table, and a sequence-sharded decode_mode's
        slots * chunk rows divisible by the world."""
        t_pool = max_pages * page
        if t_pool > self.cfg.max_positions:
            raise ValueError(f"pool horizon {t_pool} exceeds max_positions "
                             f"{self.cfg.max_positions} (rope table)")
        n = self.world.n
        if self.decode_mode in SEQ_SHARDED_MODES and (slots * chunk) % n:
            raise ValueError(f"sequence-sharded mode {self.decode_mode!r} "
                             f"needs slots*chunk ({slots}*{chunk}) to divide "
                             f"by tp={n}")

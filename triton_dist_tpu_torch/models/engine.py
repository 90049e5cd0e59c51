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
buffers before each replay. A sampled `generate` draws inside the graph
from the graph's own generator, registered with it
(`CUDAGraph.register_generator_state`), which takes the caller's
generator's state before the replays and hands it back after, so the
draws are bitwise the eager ones. `prefill` stays eager.
`Engine(cuda_graph=False)` runs every step eagerly on the card, for A/B
runs and tests, through the same step functions; the CPU is always
eager. Either way `decode_step` and `generate` write the step's K/V rows
and advance `cache.length` in place and return the cache they were
given.

Sampling: greedy is argmax. With temperature > 0 a token is drawn by the
Gumbel-max rule from a `torch.Generator`: in `generate`, one generator
for the batch; in the serve step, one per slot, seeded from (request
seed, output token index) so a request's sampled tokens do not depend on
scheduling, as the JAX key stream does (engine.py:299-303). The bits
differ from the JAX package's: the two draw different random numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    shape_key,
)
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64: argmax at temperature <= 0 (or
    with no generator), else argmax(logits / T + Gumbel noise), a draw
    from softmax(logits / T)."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=generator)
    return torch.argmax(logits.float() / temperature - torch.log(e), dim=-1)


def _serve_forward(cfg: ModelConfig, mode: str, slots: int, chunk: int,
                   page: int, t_pool: int, params: DenseLLMParams, tokens,
                   pool_k, pool_v, table, lengths, n_valid):
    """One fixed-geometry (slots, chunk) forward over the paged pool's
    dense view, the greedy token at column n_valid - 1, and the KV
    scatter back into the pool with padding columns routed to the null
    page 0: everything of the serve step that runs on the card, with no
    host read (a CUDA graph captures it). tokens (K, C), table (K, MAXP),
    lengths (K,), n_valid (K,) are int64 tensors on the pool's device;
    pool_k / pool_v are updated in place. Returns (argmax (K,),
    last_logits (K, V) f32)."""
    dev = tokens.device
    n = params.world_size
    cache = KVCache.dense_view(pool_k, pool_v, table, lengths, n)
    logits, new_cache = forward(cfg, params, tokens, cache, mode=mode,
                                return_full_logits=True)  # (K, C, V)
    bidx = torch.arange(slots, device=dev)
    last = logits[bidx, (n_valid - 1).clamp(min=0)]  # (K, V)
    tok = torch.argmax(last, dim=-1)

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
    return tok, last


def _sample_slots(tok: torch.Tensor, last: torch.Tensor, temps: np.ndarray,
                  seeds: np.ndarray) -> torch.Tensor:
    """The step's next tokens: a copy of the greedy `tok`, each slot with
    temperature > 0 drawn from its logits row by its own generator
    (seeded from its seed); temps / seeds (K,) are host arrays."""
    tok = tok.clone()
    for slot in np.flatnonzero(np.asarray(temps) > 0.0):
        gen = torch.Generator(device=tok.device).manual_seed(int(seeds[slot]))
        tok[slot] = sample_token(last[slot:slot + 1], gen,
                                 float(temps[slot]))[0]
    return tok


class Engine:
    """Parameters on one card plus prefill / decode / serve entry points.

    device: "cuda" by default; "cpu" runs every kernel's plain version.
    world: tensor-parallel size n, run as a virtual world of n ranks on
    the one device. prefill_mode / decode_mode: the JAX package's mode
    strings, "dist", "xla" or "ar" (an MoE config also "fused"), with its
    defaults. Dense and MoE configs share the Engine. cuda_graph: on the
    card, replay each decode and serve step as a captured CUDA graph (the
    module docstring); False runs them eagerly."""

    def __init__(self, cfg: ModelConfig, device=None,
                 params: Optional[DenseLLMParams] = None, seed: int = 0,
                 max_len: Optional[int] = None, world: int = 1,
                 prefill_mode: str = "dist", decode_mode: str = "ar",
                 cuda_graph: bool = True):
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
        self.decode_graphs = GraphCache(8)
        self.serve_graphs = GraphCache(2)

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
        """input_ids (B, S) -> (last-token logits (B, V) f32, cache)."""
        ids = self._ids(input_ids)
        if cache is None:
            cache = self.new_cache(ids.shape[0])
        return forward(self.cfg, self.params, ids, cache,
                       mode=self.prefill_mode)

    def decode_step(self, tokens, cache: KVCache):
        """tokens (B,) -> (logits (B, V) f32, cache): the step's K/V rows
        written and cache.length advanced in place, the cache given
        returned. On the card a replay of the captured step."""
        tok = self._ids(tokens)
        if not self.cuda_graph:
            logits, _ = self._decode_fn(cache, tok.clone())(True)
            return logits, cache
        g = self._decode_graph(cache, tok)
        return self._replayed(g, cache, tok, 1).clone(), cache

    def generate(self, tokens, cache: KVCache, steps: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """Decode `steps` tokens after `tokens` (B,), one forward each, the
        cache advanced in place. Returns (ids (B, steps) int64, cache). On
        the card each step is a replay of the captured step, which samples
        and feeds the token back on the card."""
        tok = self._ids(tokens)
        if not self.cuda_graph:
            step = self._decode_fn(cache, tok.clone(), temperature, generator)
            out = [step(True)[1].clone() for _ in range(steps)]
            return torch.stack(out, dim=1), cache
        g = self._decode_graph(cache, tok, temperature, generator)
        out = torch.empty((tok.shape[0], steps), dtype=torch.int64,
                          device=self.device)
        self._replayed(g, cache, tok, steps, generator, out)
        return out, cache

    def _decode_fn(self, cache: KVCache, tok: torch.Tensor,
                   temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None):
        """The decode step, step(commit) -> (logits, tok): the forward of
        the token in `tok` (B,) over `cache`, then the sampled token
        (argmax, or the draw from `generator`); with commit it advances
        cache.length and feeds the token back into `tok`, without it it
        leaves both (a graph's warm-up). A graph captures it; the eager
        routes call it."""

        def step(commit: bool):
            logits, new = forward(self.cfg, self.params, tok[:, None],
                                  cache, mode=self.decode_mode)
            nxt = sample_token(logits, generator, temperature)
            if commit:
                cache.length.copy_(new.length)
                tok.copy_(nxt)
            return logits, tok

        return step

    def _decode_graph(self, cache: KVCache, tok: torch.Tensor,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None
                      ) -> StepGraph:
        """The captured decode step for caches shaped as `cache`, greedy
        or sampled at `temperature`: it reads the static token `.tok`
        (B,), writes the step's K/V rows into its own cache `.state`,
        advances its length, samples (argmax, or the Gumbel draw from its
        own generator `.generator`) and feeds the token back into `.tok`;
        outputs (logits, tok). A new graph binds `cache` and warms up on
        `tok`, the step's own state."""
        sampled = temperature > 0.0 and generator is not None
        key = (shape_key(cache.k, cache.v, cache.length),
               float(temperature) if sampled else None)

        def make():
            state = Resident((cache.k, cache.v, cache.length))
            state.bind((cache.k, cache.v, cache.length))
            static = tok.clone()
            gen = torch.Generator(device=self.device) if sampled else None
            g = StepGraph(self._decode_fn(KVCache(*state.tensors), static,
                                          temperature, gen),
                          self.device, [gen] if sampled else [])
            g.state, g.tok, g.generator = state, static, gen
            return g

        return self.decode_graphs.get(key, make)

    @staticmethod
    def _replayed(g: StepGraph, cache: KVCache, tok: torch.Tensor,
                  steps: int, generator: Optional[torch.Generator] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`steps` replays of the decode graph `g` from token `tok` over
        `cache`, bound to the graph's state; a sampled graph draws from
        `generator`'s state, which it takes back after. out[:, i] gets
        the i-th token. Returns the last logits (the graph's buffer)."""
        g.state.bind((cache.k, cache.v, cache.length))
        g.tok.copy_(tok)
        if g.generator is not None:
            g.generator.set_state(generator.get_state())
        for i in range(steps):
            logits, nxt = g.replay()
            if out is not None:
                out[:, i].copy_(nxt)
        if g.generator is not None:
            generator.set_state(g.generator.get_state())
        return logits

    def serve(self, input_ids, gen_len: int, temperature: float = 0.0,
              seed: int = 0, slots: Optional[int] = None,
              chunk: Optional[int] = None, page: Optional[int] = None):
        """Prefill + gen_len decode steps. Returns ids (B, gen_len) int64.

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
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.prefill(input_ids)
        tok = sample_token(logits, gen, temperature)
        if gen_len == 1:
            return tok[:, None]
        rest, _ = self.generate(tok, cache, gen_len - 1, temperature, gen)
        return torch.cat([tok[:, None], rest], dim=1)

    # -- serve step (the Scheduler's batch-of-sequence-states contract) --

    def make_serve_step(self, slots: int, chunk: int, page: int,
                        max_pages: int):
        """The step function the serve Worker calls every step:

          fn(tokens (K, C), pool_k, pool_v (L, Hkv, P, page, D) with
             rank r's heads at [r*Hkv/n, (r+1)*Hkv/n),
             table (K, MAXP), lengths (K,), n_valid (K,), temps (K,),
             seeds (K,)) -> (next_token (K,), last_logits (K, V) f32)

        On the card the function replays the captured `_serve_forward`
        (dense view, forward, last logits, argmax, pool scatter) after
        binding the pools to the graph's and copying the step's tensors
        into its static buffers; the sampled slots are then drawn from
        the replay's last logits, as the eager step draws them. The last
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

        if not self.cuda_graph:
            def step(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                     seeds):
                tok, last = _serve_forward(cfg, mode, slots, chunk, page,
                                           t_pool, params, tokens, pool_k,
                                           pool_v, table, lengths, n_valid)
                return _sample_slots(tok, last, temps, seeds), last

            return step

        def step(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                 seeds):
            key = (slots, chunk, page, max_pages, shape_key(pool_k, pool_v))
            inputs = (tokens, table, lengths, n_valid)

            def make():
                state = Resident((pool_k, pool_v))
                state.bind((pool_k, pool_v))
                static = [x.clone() for x in inputs]

                def fwd(commit: bool):
                    return _serve_forward(cfg, mode, slots, chunk, page,
                                          t_pool, params, static[0],
                                          *state.tensors, *static[1:])

                g = StepGraph(fwd, self.device)
                g.state, g.static = state, static
                return g

            g = self.serve_graphs.get(key, make)
            g.state.bind((pool_k, pool_v))
            for dst, src in zip(g.static, inputs):
                dst.copy_(src)
            tok, last = g.replay()
            return _sample_slots(tok, last, temps, seeds), last

        return step

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

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
PyTorch runs eagerly, so there is nothing to compile: `generate` is a
Python loop of decode steps (a CUDA graph of the step is later work) and
`make_serve_step` returns a plain function.

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


def _serve_step_math(cfg: ModelConfig, mode: str, slots: int, chunk: int,
                     page: int, t_pool: int, params: DenseLLMParams, tokens,
                     pool_k, pool_v, table, lengths, n_valid,
                     temps: np.ndarray, seeds: np.ndarray):
    """One fixed-geometry (slots, chunk) forward over the paged pool's
    dense view, per-slot sampling at column n_valid - 1, and the KV
    scatter back into the pool with padding columns routed to the null
    page 0. tokens (K, C), table (K, MAXP), lengths (K,), n_valid (K,)
    are int64 tensors on the pool's device; temps / seeds (K,) are host
    arrays. pool_k / pool_v are updated in place.
    Returns (next_token (K,), last_logits (K, V) f32)."""
    dev = tokens.device
    n = params.world_size
    cache = KVCache.dense_view(pool_k, pool_v, table, lengths, n)
    logits, new_cache = forward(cfg, params, tokens, cache, mode=mode,
                                return_full_logits=True)  # (K, C, V)
    bidx = torch.arange(slots, device=dev)
    last = logits[bidx, (n_valid - 1).clamp(min=0)]  # (K, V)
    tok = torch.argmax(last, dim=-1)
    for slot in np.flatnonzero(np.asarray(temps) > 0.0):
        gen = torch.Generator(device=dev).manual_seed(int(seeds[slot]))
        tok[slot] = sample_token(last[slot:slot + 1], gen,
                                 float(temps[slot]))[0]

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


class Engine:
    """Parameters on one card plus prefill / decode / serve entry points.

    device: "cuda" by default; "cpu" runs every kernel's plain version.
    world: tensor-parallel size n, run as a virtual world of n ranks on
    the one device. prefill_mode / decode_mode: the JAX package's mode
    strings, "dist", "xla" or "ar" (an MoE config also "fused"), with its
    defaults. Dense and MoE configs share the Engine."""

    def __init__(self, cfg: ModelConfig, device=None,
                 params: Optional[DenseLLMParams] = None, seed: int = 0,
                 max_len: Optional[int] = None, world: int = 1,
                 prefill_mode: str = "dist", decode_mode: str = "ar"):
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
        """tokens (B,) -> (logits (B, V) f32, cache)."""
        return forward(self.cfg, self.params, self._ids(tokens)[:, None],
                       cache, mode=self.decode_mode)

    def generate(self, tokens, cache: KVCache, steps: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """Decode `steps` tokens after `tokens` (B,), one forward each.
        Returns (ids (B, steps) int64, cache)."""
        tok = self._ids(tokens)
        out = []
        for _ in range(steps):
            logits, cache = self.decode_step(tok, cache)
            tok = sample_token(logits, generator, temperature)
            out.append(tok)
        return torch.stack(out, dim=1), cache

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

        Every step runs the model over the whole (slots, chunk) block
        whatever mix of prefill chunks and decode tokens it carries; a
        slot's row holds n_valid real tokens from its current length on,
        the rest is padding whose outputs are dropped and whose KV lands
        on the null page. The step runs `decode_mode`. The pools are
        updated in place."""
        self._check_serve_geometry(slots, chunk, page, max_pages)
        t_pool = max_pages * page
        cfg, params, mode = self.cfg, self.params, self.decode_mode

        def step(tokens, pool_k, pool_v, table, lengths, n_valid, temps,
                 seeds):
            return _serve_step_math(cfg, mode, slots, chunk, page, t_pool,
                                    params, tokens, pool_k, pool_v, table,
                                    lengths, n_valid, temps, seeds)

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

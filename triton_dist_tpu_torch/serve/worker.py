"""Worker — port of triton_dist_tpu.serve.worker (host-loop Worker).

The Scheduler decides what runs each step; the Worker is the one part
that touches the device: it moves the step's arguments to the engine's
device, calls the engine's serve step over the pool, and advances the
pool lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.serve.kv_pool import KVPool


def sampling_seed(seed: int, token_index: int) -> int:
    """The seed of a request's generator for one output token, derived
    from the request seed and the output token index only, so sampled
    tokens, like greedy ones, do not depend on scheduling or eviction."""
    ss = np.random.SeedSequence([int(seed), int(token_index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Worker:
    def __init__(self, engine, pool: KVPool, chunk: int):
        self.engine = engine
        self.pool = pool
        self.chunk = chunk
        self._fn = engine.make_serve_step(pool.slots, chunk, pool.page,
                                          pool.max_pages)
        self.n_steps = 0

    def step(self, tokens: np.ndarray, n_valid: np.ndarray,
             temps: np.ndarray, seeds: np.ndarray) -> np.ndarray:
        """One serve step. tokens (K, C), n_valid (K,), temps (K,),
        seeds (K,) host arrays. Advances the pool lengths by n_valid and
        returns the per-slot next token (K,); only slots whose chunk
        completed (prefill tail or decode) carry a meaningful token."""
        pool = self.pool
        dev = self.engine.device

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=dev)

        tok, _last = self._fn(put(tokens), pool.k, pool.v, put(pool.table),
                              put(pool.lengths), put(n_valid), temps, seeds)
        pool.lengths = pool.lengths + np.asarray(n_valid, np.int64)
        self.n_steps += 1
        return tok.cpu().numpy()

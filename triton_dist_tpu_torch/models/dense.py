"""Dense Qwen3 model — port of triton_dist_tpu.models.dense at world 1.

Parameters keep the JAX package's layout (`DenseLLMParams`,
dense.py:20-24) with its tp dim of size 1 dropped, and `(in, out)`
weights so `x @ W` needs no transpose:

  embed (V, H) · input_ln / post_attn_ln (L, H) · q_norm / k_norm (L, D)
  w_qkv (L, H, (Hq + 2*Hkv) * D) · w_o (L, Hq * D, H)
  w_gate / w_up (L, H, I) · w_down (L, I, H)
  final_ln (H,) · lm_head (H, V)

`forward` is a Python loop over the layers where the JAX package runs a
`lax.scan`, and writes each step's K/V into the cache in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from triton_dist_tpu_torch.layers.linear import dot_f32
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.rope import rope_table
from triton_dist_tpu_torch.layers.tp_attn import (
    KVWrite,
    TPAttnParams,
    TPAttnSpec,
    tp_attn_fwd,
)
from triton_dist_tpu_torch.layers.tp_mlp import TPMLPParams, tp_mlp_fwd
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.runtime.device import resolve_device


class DenseLayerParams(NamedTuple):
    """Stacked per-layer weights, leading dim L."""

    input_ln: torch.Tensor
    post_attn_ln: torch.Tensor
    w_qkv: torch.Tensor
    w_o: torch.Tensor
    q_norm: torch.Tensor
    k_norm: torch.Tensor
    w_down: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor


class DenseLLMParams(NamedTuple):
    embed: torch.Tensor
    layers: DenseLayerParams
    final_ln: torch.Tensor
    lm_head: torch.Tensor

    def to(self, device) -> "DenseLLMParams":
        """A copy of every tensor on `device`."""
        return DenseLLMParams(
            self.embed.to(device),
            DenseLayerParams(*(w.to(device) for w in self.layers)),
            self.final_ln.to(device), self.lm_head.to(device))


def init_params(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> DenseLLMParams:
    """Random weights drawn on `device` from `generator` (a new one
    seeded with `seed` when none is given): N(0, 0.02) matrices, unit
    norms, as the JAX package's init. The two packages draw different
    numbers from one seed; tests carry the JAX weights across with
    `params_from_jax`."""
    if cfg.is_moe:
        raise NotImplementedError("the port serves dense models only")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    hq, hkv, inter = cfg.num_q_heads, cfg.num_kv_heads, cfg.intermediate_size

    def mk(*shape):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = DenseLayerParams(
        input_ln=ones(L, h), post_attn_ln=ones(L, h),
        w_qkv=mk(L, h, (hq + 2 * hkv) * d), w_o=mk(L, hq * d, h),
        q_norm=ones(L, d), k_norm=ones(L, d),
        w_down=mk(L, inter, h), w_gate=mk(L, h, inter), w_up=mk(L, h, inter),
    )
    return DenseLLMParams(embed=mk(cfg.vocab_size, h), layers=layers,
                          final_ln=ones(h), lm_head=mk(h, cfg.vocab_size))


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch shares it
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(p, device=None) -> DenseLLMParams:
    """The port's parameters from the JAX package's `DenseLLMParams` as
    numpy arrays (any object with its attribute names, such as
    `jax.tree.map(np.asarray, params)`), built for a tp size of 1: the
    size-1 tp dim of the sharded weights is dropped, nothing else moves."""
    dev = resolve_device(device)
    lay = p.layers
    if lay.w_gate is None:
        raise NotImplementedError("the port serves dense models only")

    def shard(a):
        if a.shape[1] != 1:
            raise ValueError(f"tp dim of size {a.shape[1]}: the port runs "
                             "at world 1")
        return _tensor(a[:, 0], dev)

    layers = DenseLayerParams(
        input_ln=_tensor(lay.input_ln, dev),
        post_attn_ln=_tensor(lay.post_attn_ln, dev),
        w_qkv=shard(lay.w_qkv), w_o=shard(lay.w_o),
        q_norm=_tensor(lay.q_norm, dev), k_norm=_tensor(lay.k_norm, dev),
        w_down=shard(lay.w_down), w_gate=shard(lay.w_gate),
        w_up=shard(lay.w_up),
    )
    if p.lm_head.shape[0] != 1:
        raise ValueError("lm_head sharded over more than one rank")
    return DenseLLMParams(embed=_tensor(p.embed, dev), layers=layers,
                          final_ln=_tensor(p.final_ln, dev),
                          lm_head=_tensor(p.lm_head[0], dev))


def _layer_fwd(cfg: ModelConfig, spec: TPAttnSpec, cos, sin, positions,
               kv_len, write: KVWrite, batch: int, x, lp: DenseLayerParams,
               kv):
    """One transformer block: x + attn(norm(x)), then + mlp(norm(x))."""
    attn_params = TPAttnParams(
        w_qkv=lp.w_qkv, w_o=lp.w_o,
        q_norm=lp.q_norm if cfg.use_qk_norm else None,
        k_norm=lp.k_norm if cfg.use_qk_norm else None)
    h = rms_norm(x, lp.input_ln, cfg.rms_eps)
    x = x + tp_attn_fwd(h, attn_params, spec, cos, sin, positions, batch,
                        kv_cache=kv, kv_len=kv_len, kv_write=write)
    h = rms_norm(x, lp.post_attn_ln, cfg.rms_eps)
    return x + tp_mlp_fwd(h, TPMLPParams(lp.w_gate, lp.w_up, lp.w_down))


def forward(cfg: ModelConfig, params: DenseLLMParams, tokens: torch.Tensor,
            cache: KVCache, return_full_logits: bool = False):
    """tokens (B, S) -> (logits, cache): logits (B, V) f32 for the last
    position, or (B, S, V) with return_full_logits. The tokens sit at
    positions cache.length + [0, S); their K/V rows are written into the
    cache in place and the returned cache has length + S."""
    if cache is None:
        raise ValueError("forward requires a KVCache (create one per serve)")
    b, s = tokens.shape
    dev = tokens.device
    spec = TPAttnSpec(cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim)
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta,
                          device=dev)
    start = cache.length
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    kv_len = start + s
    write = KVWrite.at(positions, cache.k.shape[2])

    x = params.embed[tokens].reshape(b * s, cfg.hidden_size)
    lay = params.layers
    for i in range(cfg.num_layers):
        lp = DenseLayerParams(*(w[i] for w in lay))
        x = _layer_fwd(cfg, spec, cos, sin, positions, kv_len, write, b,
                       x, lp, (cache.k[i], cache.v[i]))

    x = rms_norm(x, params.final_ln, cfg.rms_eps).reshape(b, s, -1)
    if not return_full_logits:
        x = x[:, -1]
    # bf16 operands, f32 result: no f32 copy of the (H, V) head
    logits = dot_f32(x, params.lm_head)
    return logits, KVCache(cache.k, cache.v, kv_len)

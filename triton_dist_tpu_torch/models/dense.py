"""Qwen3 model, dense and MoE — port of triton_dist_tpu.models.dense
over the virtual world of n ranks (runtime/symm_mem.py), in the JAX
package's modes.

Parameters keep the JAX package's layout (`DenseLLMParams`, dense.py:
20-24) with its rank dim n, and `(in, out)` weights so `x @ W` needs no
transpose:

  embed (V, H) · input_ln / post_attn_ln (L, H) · q_norm / k_norm (L, D)
  w_qkv (L, n, H, (Hq + 2*Hkv)/n * D) · w_o (L, n, Hq/n * D, H)
  dense: w_gate / w_up (L, n, H, I/n) · w_down (L, n, I/n, H)
  MoE:   w_gate_up (L, n, E, H, 2*Im/n), rank r's [gate_r | up_r]
         (load_hf.py:213-229) · w_down (L, n, E, Im/n, H) ·
         w_router (L, H, E), replicated
  final_ln (H,) · lm_head (n, H, V/n)

The expert stacks stay in that row-major (K, N) layout: the grouped ag_gemm
kernel reads it through its strides and `torch._grouped_mm` takes it as
it is, so no weight is copied or transposed at call time.

`forward` keeps the residual stream per rank, as shard_map does: in
the `ar` mode every rank holds all M = B*S rows, x (n, M, H) (the
all-reduces keep the replicas bitwise equal); in the sequence-sharded
`dist` and `xla` modes rank r holds rows [r*M/n, (r+1)*M/n), x (n, M/n,
H), split on entry by `shard_tokens` and regathered before the final
norm by `gather_tokens`, the port's copy of plan/execute.py:40-58.
There is no planner: the mode string is the plan; "fused" (MoE only,
planner.py:538-558) runs the attention as `dist` and the MoE block as
its one-kernel `fused` lowering. At world 1 the modes are one
computation, and `forward` runs it as `ar`. It is a Python
loop over the layers where the JAX package runs a `lax.scan`, and it
writes each step's K/V into the cache in place. The logits are each
rank's vocab slice, gathered along the vocab with a torch op (the JAX
`lax.all_gather` there is XLA's).
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
from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd
from triton_dist_tpu_torch.kernels.allgather import ring_all_gather_plain
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.runtime.device import MODES, resolve_device
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld


class DenseLayerParams(NamedTuple):
    """Stacked per-layer weights, leading dim L; sharded ones then n. A
    dense model has w_gate / w_up, an MoE one w_gate_up / w_router; the
    other pair is None."""

    input_ln: torch.Tensor
    post_attn_ln: torch.Tensor
    w_qkv: torch.Tensor
    w_o: torch.Tensor
    q_norm: torch.Tensor
    k_norm: torch.Tensor
    w_down: torch.Tensor
    w_gate: Optional[torch.Tensor] = None
    w_up: Optional[torch.Tensor] = None
    w_gate_up: Optional[torch.Tensor] = None
    w_router: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "DenseLayerParams":
        """Layer i's weights (None stays None)."""
        return DenseLayerParams(*(None if w is None else w[i] for w in self))


class DenseLLMParams(NamedTuple):
    embed: torch.Tensor
    layers: DenseLayerParams
    final_ln: torch.Tensor
    lm_head: torch.Tensor

    @property
    def world_size(self) -> int:
        """n, the ranks the weights are sharded over."""
        return self.lm_head.shape[0]

    def tensors(self):
        """Every weight tensor (the absent dense or MoE pair skipped)."""
        return [w for w in (self.embed, *self.layers, self.final_ln,
                            self.lm_head) if w is not None]

    def to(self, device) -> "DenseLLMParams":
        """A copy of every tensor on `device`."""
        return DenseLLMParams(
            self.embed.to(device),
            DenseLayerParams(*(None if w is None else w.to(device)
                               for w in self.layers)),
            self.final_ln.to(device), self.lm_head.to(device))


def check_world(cfg: ModelConfig, n: int) -> None:
    """Raise unless n ranks divide the heads, the vocab and the MLP (an
    MoE model: each expert's FFN dim)."""
    if n < 1:
        raise ValueError(f"world size {n} must be at least 1")
    sizes = dict(num_q_heads=cfg.num_q_heads, num_kv_heads=cfg.num_kv_heads,
                 vocab_size=cfg.vocab_size)
    if cfg.is_moe:
        sizes["moe_intermediate_size"] = cfg.moe_intermediate_size
    else:
        sizes["intermediate_size"] = cfg.intermediate_size
    bad = {k: v for k, v in sizes.items() if v % n}
    if bad:
        raise ValueError(f"world size {n} must divide {bad}")


def init_params(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0, world: int = 1) -> DenseLLMParams:
    """Random weights for `world` ranks drawn on `device` from
    `generator` (a new one seeded with `seed` when none is given):
    N(0, 0.02) matrices, unit norms, as the JAX package's init. The two
    packages draw different numbers from one seed; tests carry the JAX
    weights across with `params_from_jax`. The same model at another
    world size is `shard_params` of these; draw a model that fills the
    card straight at its world (one copy of the weights)."""
    check_world(cfg, world)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    n = world
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    hq, hkv = cfg.num_q_heads // n, cfg.num_kv_heads // n

    def mk(*shape):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    if cfg.is_moe:
        e, mi_l = cfg.num_experts, cfg.moe_intermediate_size // n
        ffn = dict(w_gate_up=mk(L, n, e, h, 2 * mi_l),
                   w_down=mk(L, n, e, mi_l, h), w_router=mk(L, h, e))
    else:
        i_l = cfg.intermediate_size // n
        ffn = dict(w_down=mk(L, n, i_l, h), w_gate=mk(L, n, h, i_l),
                   w_up=mk(L, n, h, i_l))
    layers = DenseLayerParams(
        input_ln=ones(L, h), post_attn_ln=ones(L, h),
        w_qkv=mk(L, n, h, (hq + 2 * hkv) * d), w_o=mk(L, n, hq * d, h),
        q_norm=ones(L, d), k_norm=ones(L, d), **ffn)
    return DenseLLMParams(embed=mk(cfg.vocab_size, h), layers=layers,
                          final_ln=ones(h),
                          lm_head=mk(n, h, cfg.vocab_size // n))


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.array(a, order="C")  # a writable copy: torch shares it
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(p, device=None) -> DenseLLMParams:
    """The port's parameters from the JAX package's `DenseLLMParams` as
    numpy arrays (any object with its attribute names, such as
    `jax.tree.map(np.asarray, params)`) at any tp size n, dense or MoE:
    the layout is the same, rank dim included, so every array crosses as
    it is (the MoE [gate_r | up_r] stack too)."""
    dev = resolve_device(device)
    lay = p.layers
    n = p.lm_head.shape[0]
    moe = getattr(lay, "w_gate_up", None) is not None
    ffn = ("w_gate_up",) if moe else ("w_gate", "w_up")
    for name in ("w_qkv", "w_o", "w_down", *ffn):
        if getattr(lay, name).shape[1] != n:
            raise ValueError(f"{name} is sharded over "
                             f"{getattr(lay, name).shape[1]} ranks, lm_head "
                             f"over {n}")
    return DenseLLMParams(
        embed=_tensor(p.embed, dev),
        layers=DenseLayerParams(*(_tensor(getattr(lay, f, None), dev)
                                  for f in DenseLayerParams._fields)),
        final_ln=_tensor(p.final_ln, dev), lm_head=_tensor(p.lm_head, dev))


def shard_params(p: DenseLLMParams, n: int) -> DenseLLMParams:
    """World-1 parameters laid out for n ranks by the JAX package's own
    unsharded -> sharded rule (models/load_hf.py:176-203): w_qkv takes
    each rank's block of q, k and v columns and concatenates them per
    rank; w_o and w_down are split by rows, w_gate, w_up and lm_head by
    columns; norms and the embedding stay replicated (shared). An MoE
    model's w_gate_up takes rank r's gate and up columns as [gate_r |
    up_r] per expert, its w_down is split by rows, the router stays
    replicated (load_hf.py:213-229)."""
    if p.world_size != 1:
        raise ValueError(f"params are sharded over {p.world_size} ranks "
                         "already")
    lay = p.layers
    d = lay.q_norm.shape[-1]
    hq_d = lay.w_o.shape[2]
    kv_d = (lay.w_qkv.shape[3] - hq_d) // 2
    if hq_d % (n * d) or kv_d % (n * d):
        raise ValueError(f"{n} ranks do not divide the heads")

    def cols(w):  # (..., 1, in, out) -> (..., n, in, out / n)
        *lead, _, i, o = w.shape
        return w.reshape(*lead, i, n, o // n).transpose(-3, -2).contiguous()

    def rows(w):  # (L, 1, in, out) -> (L, n, in / n, out), a view
        return w.reshape(w.shape[0], n, -1, w.shape[3])

    q, k, v = torch.split(lay.w_qkv, [hq_d, kv_d, kv_d], dim=-1)
    layers = lay._replace(
        w_qkv=torch.cat([cols(q), cols(k), cols(v)], dim=-1),
        w_o=rows(lay.w_o))
    if lay.w_gate_up is not None:
        L, _, e, h, mi2 = lay.w_gate_up.shape
        mi = mi2 // 2
        if mi % n:
            raise ValueError(f"{n} ranks do not divide the expert FFN {mi}")
        gu = lay.w_gate_up[:, 0].reshape(L, e, h, 2, n, mi // n)
        layers = layers._replace(
            w_gate_up=gu.permute(0, 4, 1, 2, 3, 5).reshape(
                L, n, e, h, 2 * (mi // n)),
            w_down=lay.w_down.reshape(L, e, n, mi // n, h).transpose(
                1, 2).contiguous())
    else:
        layers = layers._replace(w_down=rows(lay.w_down),
                                 w_gate=cols(lay.w_gate),
                                 w_up=cols(lay.w_up))
    return p._replace(layers=layers, lm_head=cols(p.lm_head))


SEQ_SHARDED_MODES = ("dist", "xla", "fused")


def shard_tokens(x: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """x (M, H) -> every rank's rows: (n, M/n, H) in a sequence-sharded
    mode, rank r holding rows [r*M/n, (r+1)*M/n) (a view), else the
    replicas (n, M, H). The JAX function slices with XLA ops, so a torch
    reshape does it here."""
    m = x.shape[0]
    if mode not in SEQ_SHARDED_MODES:
        return x.expand(n, *x.shape)
    if m % n:
        raise ValueError(f"B*S={m} must divide by tp={n} in {mode} mode")
    return x.reshape(n, m // n, *x.shape[1:])


def gather_tokens(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Every rank's copy of all M rows before the head: the shards
    gathered in a sequence-sharded mode (the JAX `lax.all_gather` is
    XLA's, so the torch op of the ring all-gather's plain version does
    it here), the replicas unchanged else."""
    return ring_all_gather_plain(x) if mode in SEQ_SHARDED_MODES else x


def _layer_fwd(cfg: ModelConfig, spec: TPAttnSpec, world: VirtualWorld,
               mode: str, cos, sin, positions, kv_len, write: KVWrite,
               batch: int, x, lp: DenseLayerParams, kv):
    """One transformer block: x + attn(norm(x)), then + ffn(norm(x)),
    the FFN the MLP or, for an MoE config, the TP-MoE block."""
    ffn_mode = mode
    if mode == "fused":  # the MoE pipeline beside a dist attention
        mode = "dist"
    attn_params = TPAttnParams(
        w_qkv=lp.w_qkv, w_o=lp.w_o,
        q_norm=lp.q_norm if cfg.use_qk_norm else None,
        k_norm=lp.k_norm if cfg.use_qk_norm else None)
    h = rms_norm(x, lp.input_ln, cfg.rms_eps)
    x = x + tp_attn_fwd(h, attn_params, spec, cos, sin, positions, batch,
                        world, kv_cache=kv, kv_len=kv_len, kv_write=write,
                        mode=mode)
    h = rms_norm(x, lp.post_attn_ln, cfg.rms_eps)
    if cfg.is_moe:
        return x + tp_moe_fwd(h, TPMoEParams(lp.w_router, lp.w_gate_up,
                                             lp.w_down),
                              cfg.num_experts_per_tok, world, mode=ffn_mode)
    return x + tp_mlp_fwd(h, TPMLPParams(lp.w_gate, lp.w_up, lp.w_down),
                          world, mode=mode)


def layers_fwd(cfg: ModelConfig, params: DenseLLMParams, x: torch.Tensor,
               layers, batch: int = 1) -> torch.Tensor:
    """x (B*S, H) through `layers` (layer indices, in order) at world 1
    with no KV cache: each of the `batch` sequences of S tokens sits at
    positions [0, S) and attends causally over itself (the attention's
    cache-free branch). A pipeline stage's function (`pp_stage_fn`) and
    its sequential reference both run through here."""
    if params.world_size != 1:
        raise ValueError(f"layers_fwd runs at world 1; the params carry "
                         f"{params.world_size} ranks")
    m = x.shape[0]
    if m % batch:
        raise ValueError(f"{m} rows do not split into {batch} sequences")
    s = m // batch
    dev = x.device
    spec = TPAttnSpec(cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim)
    cos, sin = rope_table(cfg.head_dim, s, cfg.rope_theta, device=dev)
    positions = torch.arange(s, device=dev).repeat(batch, 1)
    world = VirtualWorld(1, dev)
    x = x[None]
    for i in layers:
        x = _layer_fwd(cfg, spec, world, "ar", cos, sin, positions, None,
                       None, batch, x, params.layers.layer(i), None)
    return x[0]


def pp_stage_fn(cfg: ModelConfig, params: DenseLLMParams, n_stages: int,
                batch: int = 1):
    """stage_fn(stage, act) for layers.p2p.pp_schedule_fwd: stage s runs
    layers [s*L/n, (s+1)*L/n) of the world-1 params on act (B*S, H)."""
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"{n_stages} stages")
    per = cfg.num_layers // n_stages

    def stage_fn(stage: int, act: torch.Tensor) -> torch.Tensor:
        return layers_fwd(cfg, params, act,
                          range(stage * per, (stage + 1) * per), batch)

    return stage_fn


def forward(cfg: ModelConfig, params: DenseLLMParams, tokens: torch.Tensor,
            cache: KVCache, mode: str = "dist",
            return_full_logits: bool = False):
    """tokens (B, S) -> (logits, cache): logits (B, V) f32 for the last
    position, or (B, S, V) with return_full_logits. The world is the
    params' rank dim n; mode is "dist" (the JAX default), "xla", "ar" or,
    for an MoE config, "fused"; a sequence-sharded mode needs n to divide
    B*S. The cache holds n * B
    rank rows (KVCache). The tokens sit at positions cache.length + [0,
    S); their K/V rows are written into the cache in place and the
    returned cache has length + S."""
    if cache is None:
        raise ValueError("forward requires a KVCache (create one per serve)")
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    if mode == "fused" and not cfg.is_moe:
        raise ValueError("mode='fused' is the MoE one-kernel pipeline; the "
                         "model is dense")
    b, s = tokens.shape
    dev = tokens.device
    n = params.world_size
    world = VirtualWorld(n, dev)
    spec = TPAttnSpec(cfg.num_q_heads // n, cfg.num_kv_heads // n,
                      cfg.head_dim)
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta,
                          device=dev)
    start = cache.length
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    kv_len = start + s
    # the ranks are extra batch rows of the attention: row r * B + b
    rank_pos, rank_len = positions.repeat(n, 1), kv_len.repeat(n)
    write = KVWrite.at(rank_pos, cache.k.shape[2])

    if n == 1:
        mode = "ar"  # one computation at world 1
    x = params.embed[tokens].reshape(b * s, cfg.hidden_size)
    x = shard_tokens(x, n, mode)
    lay = params.layers
    for i in range(cfg.num_layers):
        lp = lay.layer(i)
        x = _layer_fwd(cfg, spec, world, mode, cos, sin, rank_pos, rank_len,
                       write, b, x, lp, (cache.k[i], cache.v[i]))

    x = gather_tokens(x, mode)  # (n, M, H)
    x = rms_norm(x, params.final_ln, cfg.rms_eps).reshape(n, b, s, -1)
    if not return_full_logits:
        x = x[:, :, -1:]
    # bf16 operands, f32 result: no f32 copy of the (H, V/n) head; then
    # rank r's vocab slice of every row, gathered along the vocab
    logits = dot_f32(x.reshape(n, -1, cfg.hidden_size), params.lm_head)
    logits = logits.reshape(n, b, -1, logits.shape[-1]).permute(1, 2, 0, 3)
    logits = logits.reshape(b, -1, n * logits.shape[-1])
    if not return_full_logits:
        logits = logits[:, 0]
    return logits, KVCache(cache.k, cache.v, kv_len)

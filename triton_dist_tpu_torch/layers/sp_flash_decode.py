"""SP flash-decode attention layer — port of triton_dist_tpu.layers.
sp_flash_decode (`SpDecodeParams`, `SpDecodeSpec`, `sp_cache_write`,
`sp_decode_attn_fwd`).

Decode over a sequence-sharded KV cache: each step writes the new
token's K/V on the rank owning its position, runs the distributed flash
decode (kernels/flash_decode.sp_flash_decode) and projects the merged
heads. QKV/O weights are replicated over the ranks.

Rank-stacked: x (n, B, H) (every rank's copy of the replicated token
rows), cache shards (n, B, T_loc, Hkv, D), kv_len (B,) global. The cache
is written in place (the JAX function returns a new array; at 32k
positions a copy a step would move the whole cache) and returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels.flash_decode import sp_flash_decode
from triton_dist_tpu_torch.layers.norm import rms_norm
from triton_dist_tpu_torch.layers.rope import apply_rope


class SpDecodeParams(NamedTuple):
    w_qkv: torch.Tensor  # (H, (Hq + 2 Hkv) * D), columns q | k | v
    w_o: torch.Tensor  # (Hq * D, H)
    q_norm: Optional[torch.Tensor] = None  # (D,)
    k_norm: Optional[torch.Tensor] = None


class SpDecodeSpec(NamedTuple):
    num_q_heads: int
    num_kv_heads: int
    head_dim: int


def sp_params_from_jax(p, device=None) -> SpDecodeParams:
    """The port's SpDecodeParams from the JAX package's (numpy arrays,
    e.g. `jax.tree.map(np.asarray, params)`), bitwise."""
    from triton_dist_tpu_torch.models.dense import _tensor
    from triton_dist_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    return SpDecodeParams(*(_tensor(getattr(p, f), dev)
                            for f in SpDecodeParams._fields))


def sp_params_from_dense(params, layer: int = 0) -> SpDecodeParams:
    """Layer `layer`'s attention weights of a world-1 dense model
    (models.dense.DenseLLMParams: w_qkv (L, 1, H, (Hq + 2 Hkv) D) with
    columns q | k | v, the split sp_decode_attn_fwd makes), as views."""
    lay = params.layers
    if lay.w_qkv.shape[1] != 1:
        raise ValueError(f"world-1 params needed; w_qkv is sharded over "
                         f"{lay.w_qkv.shape[1]} ranks")
    return SpDecodeParams(w_qkv=lay.w_qkv[layer, 0], w_o=lay.w_o[layer, 0],
                          q_norm=lay.q_norm[layer], k_norm=lay.k_norm[layer])


def sp_cache_write(cache: torch.Tensor, kv_new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Write kv_new (n, B, Hkv, D) at global position pos (B,) of the
    rank-stacked shards (n, B, T_loc, Hkv, D): only the owner rank
    pos // T_loc stores (its own copy of the row); a position past the
    last rank is dropped, not wrapped. In place, without a host sync."""
    n, b, t_loc = cache.shape[:3]
    dev = cache.device
    pos = pos.to(dev).long()
    owner = pos // t_loc
    keep = (owner >= 0) & (owner < n)
    owner = owner.clamp(0, n - 1)
    local = (pos - owner * t_loc).clamp(0, t_loc - 1)
    rows = torch.arange(b, device=dev)
    flat = cache.view(n * b * t_loc, *cache.shape[3:])
    idx = (owner * b + rows) * t_loc + local
    # a dropped write stores the row's own value back
    new = torch.where(keep[:, None, None],
                      kv_new[owner, rows].to(cache.dtype), flat[idx])
    flat[idx] = new
    return cache


def sp_decode_attn_fwd(x: torch.Tensor, params: SpDecodeParams,
                       spec: SpDecodeSpec, cos: torch.Tensor,
                       sin: torch.Tensor,
                       kv_cache: Tuple[torch.Tensor, torch.Tensor],
                       kv_len: torch.Tensor, ll_buf=None,
                       call_count: int = 0, partial_impl: str = "auto"):
    """One decode step: x (n, B, H), kv_len (B,) the global length before
    this token. Returns (y (n, B, H), (k, v) cache), plus the LL context
    when ll_buf is given (thread it through steps with call_count 0, 1,
    ...)."""
    n, b, h = x.shape
    hq, hkv, d = spec.num_q_heads, spec.num_kv_heads, spec.head_dim
    qkv = torch.matmul(x, params.w_qkv)  # f32 accumulation, x.dtype out
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(n, b, 1, hq, d)
    k = k.reshape(n, b, 1, hkv, d)
    v = v.reshape(n, b, 1, hkv, d)
    if params.q_norm is not None:
        q = rms_norm(q, params.q_norm)
    if params.k_norm is not None:
        k = rms_norm(k, params.k_norm)
    pos = kv_len.to(x.device)[:, None]  # (B, 1) this token's position
    q = apply_rope(q, cos, sin, pos)
    k = apply_rope(k, cos, sin, pos)

    k_cache, v_cache = kv_cache
    sp_cache_write(k_cache, k[:, :, 0], kv_len)
    sp_cache_write(v_cache, v[:, :, 0], kv_len)
    res = sp_flash_decode(q[:, :, 0], k_cache, v_cache, kv_len + 1,
                          ll_buf=ll_buf, call_count=call_count,
                          partial_impl=partial_impl)
    out, new_buf = res if ll_buf is not None else (res, None)
    y = torch.matmul(out.reshape(n, b, hq * d).to(x.dtype), params.w_o)
    if ll_buf is not None:
        return y, (k_cache, v_cache), new_buf
    return y, (k_cache, v_cache)

"""EP MoE layer — port of triton_dist_tpu.layers.ep_moe (`EPMoEParams`,
`ep_moe_fwd`, `ep_moe_ref`), plus the weights carried across from the
JAX package and from the port's TP-MoE layout.

Experts shard across ranks: each rank owns E/n whole experts, and every
token travels to its experts' owners and back (kernels/ep_a2a.py over
the all-to-all kernels). Rank-stacked over the virtual world: x (n, M,
H) holds rank r's M tokens at [r] (the sequence-sharded layout of the
TP-MoE `dist` mode), w_router (H, E) is replicated, w_gate_up (n, E/n,
H, 2I) as [gate | up] and w_down (n, E/n, I, H) hold rank r's experts
at [r]; drops come back as (n,).

`ep_moe_fwd(overlap=True)` takes the chunk pipeline. Its chunk count
comes from the caller: `n_chunks=None`, which the JAX function hands to
the planner (plan/, `plan_ep_chunks`), raises until plan/ is ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.kernels.moe_utils import silu_mul, topk_routing
from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams
from triton_dist_tpu_torch.runtime.device import resolve_device


class EPMoEParams(NamedTuple):
    w_router: torch.Tensor   # (H, E) replicated
    w_gate_up: torch.Tensor  # (n, E/n, H, 2I) rank r's experts, [gate | up]
    w_down: torch.Tensor     # (n, E/n, I, H)


def _route(x: torch.Tensor, params: EPMoEParams, top_k: int):
    """The router on every rank's tokens in f32, as one (n*M, H) product
    (the shape of the TP-MoE router over the same tokens)."""
    n, m, h = x.shape
    logits = x.reshape(n * m, h).float() @ params.w_router.float()
    weights, ids = topk_routing(logits, top_k)
    return weights.reshape(n, m, top_k), ids.reshape(n, m, top_k)


def ep_moe_fwd(x: torch.Tensor, params: EPMoEParams, top_k: int,
               capacity: Optional[int] = None, payload_dtype=None,
               overlap: bool = False, n_chunks: Optional[int] = None,
               return_drops: bool = False, _transport: str = "chunked"):
    """EP MoE forward: route -> dispatch -> local grouped FFN -> combine.
    x (n, M, H) -> (n, M, H) in x.dtype, or with return_drops ((n, M,
    H), drops (n,) int32: the (token, choice) pairs beyond `capacity`
    a rank, which lose their expert's contribution). capacity None is
    the lossless M * top_k.

    overlap=True: the chunk pipeline (ep_a2a.ep_moe_pipeline), the same
    routing and drops; n_chunks is fitted down to a divisor of capacity.
    `_transport` picks its all-to-all, the JAX test hook: "chunked" (the
    chunked kernel), "plain" (the single-shot kernel) or "ref" (the
    plain torch version); the sequential path takes the single-shot
    kernel, or the plain version with "ref"."""
    n, m, _ = x.shape
    e_loc = params.w_gate_up.shape[1]
    if capacity is None:
        capacity = m * top_k
    if overlap and n_chunks is None:
        raise NotImplementedError(
            "overlap=True with n_chunks=None: the JAX function asks the "
            "planner (plan/, plan_ep_chunks), which is not ported; pass "
            "n_chunks")
    weights, ids = _route(x, params, top_k)
    if overlap:
        out, drops = ep_a2a.ep_moe_pipeline(
            x, ids, weights, params.w_gate_up, params.w_down, capacity,
            n_chunks=ep_a2a.fit_chunks(n_chunks, capacity),
            payload_dtype=payload_dtype, transport=_transport)
        out = out.to(x.dtype)
    else:
        transport = "ref" if _transport == "ref" else "plain"
        disp = ep_a2a.ep_dispatch(x, ids, weights, e_loc * n, capacity,
                                  payload_dtype=payload_dtype,
                                  transport=transport)
        y = ep_a2a.ep_expert_ffn(disp, params.w_gate_up, params.w_down)
        out = ep_a2a.ep_combine(y, disp, m, top_k, x.dtype,
                                transport=transport)
        drops = disp.drops
    return (out, drops) if return_drops else out


def ep_moe_ref(x: torch.Tensor, params: EPMoEParams,
               top_k: int) -> torch.Tensor:
    """Dense reference: every expert on every rank, no token travel, f32
    (one (M, H, 2I) weight gather a choice: a test oracle, not a path)."""
    n, m, h = x.shape
    w_gu_all = params.w_gate_up.reshape(-1, *params.w_gate_up.shape[2:])
    w_dn_all = params.w_down.reshape(-1, *params.w_down.shape[2:])
    weights, ids = _route(x, params, top_k)
    xf = x.float()
    out = torch.zeros_like(xf)
    for j in range(top_k):
        eid = ids[..., j].long()
        hh = torch.einsum("rmh,rmhi->rmi", xf, w_gu_all[eid].float())
        y = torch.einsum("rmi,rmih->rmh", silu_mul(hh),
                         w_dn_all[eid].float())
        out = out + y * weights[..., j:j + 1]
    return out.to(x.dtype)


def ep_params_from_jax(w_router, w_gate_up, w_down, world: int,
                       device=None) -> EPMoEParams:
    """The JAX global weights as numpy arrays: w_router (H, E), w_gate_up
    (E, H, 2I), w_down (E, I, H), which the JAX tests shard over the EP
    axis with P(axis) (rank r holds experts [r E/n, (r+1) E/n)); here
    the same split as the rank dim, on `device` (the card unless the
    caller names another)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    gu, dn = t(w_gate_up), t(w_down)
    return EPMoEParams(
        w_router=t(w_router),
        w_gate_up=gu.reshape(world, gu.shape[0] // world, *gu.shape[1:]),
        w_down=dn.reshape(world, dn.shape[0] // world, *dn.shape[1:]))


def ep_params_from_tp(tp: TPMoEParams) -> EPMoEParams:
    """One layer of the port's TP-MoE weights (layers/tp_moe.py: w_gate_up
    (n, E, H, 2I/n) as [gate_r | up_r], w_down (n, E, I/n, H), rank r
    holding columns and rows [r I/n, (r+1) I/n) of every expert) re-laid
    as whole experts a rank: (n, E/n, H, 2I) as [gate | up] and (n, E/n,
    I, H). One copy of each stack (~1.21 GB for a Qwen3-30B-A3B layer)."""
    n, e, h, i2 = tp.w_gate_up.shape
    i_loc = i2 // 2
    gu = tp.w_gate_up.reshape(n, e, h, 2, i_loc).permute(1, 2, 3, 0, 4)
    gu = gu.reshape(n, e // n, h, 2 * n * i_loc)
    dn = tp.w_down.permute(1, 0, 2, 3).reshape(n, e // n, n * i_loc,
                                               tp.w_down.shape[-1])
    return EPMoEParams(w_router=tp.w_router, w_gate_up=gu, w_down=dn)

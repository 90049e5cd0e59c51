"""The port's pipeline-parallel layer (triton_dist_tpu_torch.layers:
PPCommOp, pp_schedule_fwd; models.pp_stage_fn / layers_fwd) against
the JAX package's.

The JAX side runs under `jax.shard_map` on n in {2, 4} of the 12
virtual CPU devices with a `pp` axis (its ring_shift kernel in
interpret mode); for stages made of a model's layers, on a 2-D mesh of
`pp` = n by `tp` = 1 (runtime/init.py's PP_AXIS), so the layers' TP
collectives reduce over one rank and never across stages. The port's
stages are the ranks of a virtual world: activations rank-stacked, one
ring_shift a tick, plain on the CPU. Same numpy inputs and weights
(`params_from_jax`) for both.

Tolerances: the JAX test's stage function (an add a stage) bitwise; a
tiny f32 dense model's layers as stages 1e-5 (the two libraries' sums
run in other orders); the port's schedule against its own layers run
one microbatch at a time bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import PPCommOp as JaxPPCommOp
from triton_dist_tpu.layers import TPAttnParams as JaxAttnParams
from triton_dist_tpu.layers import TPAttnSpec as JaxAttnSpec
from triton_dist_tpu.layers import TPMLPParams as JaxMLPParams
from triton_dist_tpu.layers import pp_schedule_fwd as jax_pp_schedule_fwd
from triton_dist_tpu.layers import rms_norm as jax_rms_norm
from triton_dist_tpu.layers import rope_table as jax_rope_table
from triton_dist_tpu.layers import tp_attn_fwd as jax_tp_attn_fwd
from triton_dist_tpu.layers import tp_mlp_fwd as jax_tp_mlp_fwd
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.models.dense import init_params as jax_init_params
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu.runtime.init import PP_AXIS, TP_AXIS
from triton_dist_tpu_torch.kernels import p2p as port_p2p
from triton_dist_tpu_torch.layers import PPCommOp, pp_schedule_fwd
from triton_dist_tpu_torch.models import (
    ModelConfig,
    layers_fwd,
    params_from_jax,
    pp_stage_fn,
)

LAYER_ATOL = 1e-5
N_MB = 4


@pytest.fixture
def shifts(monkeypatch):
    """Counts the layer's ring_shift calls (on the CPU the wrapper's
    launch count stays 0: no kernel runs there)."""
    calls = []
    real = port_p2p.ring_shift

    def counted(x, shift=1, **kw):
        calls.append(shift)
        return real(x, shift, **kw)

    monkeypatch.setattr(port_p2p, "ring_shift", counted)
    return calls


@pytest.mark.parametrize("n", [2, 4])
def test_pp_schedule_matches_jax_with_the_jax_test_stage_fn(n, shifts):
    """tests/test_layers.py's stage function, act + (stage + 1), on
    random microbatches: bitwise, n_microbatches + n - 1 ring shifts."""
    mb, feat = 2, 128
    x = np.random.default_rng(n).standard_normal(
        (N_MB, mb, feat)).astype(np.float32)

    def per_rank(xs):
        def stage_fn(stage, act):
            return act + (stage.astype(jnp.float32) + 1.0)

        return jax_pp_schedule_fwd(JaxPPCommOp(axis=PP_AXIS), stage_fn, xs,
                                   N_MB)

    mesh = make_mesh(mesh_shape=(n,), axis_names=(PP_AXIS,))
    want = np.asarray(jax.jit(jax.shard_map(
        per_rank, mesh=mesh, in_specs=P(), out_specs=P(),
        check_vma=False))(x))
    xt = torch.from_numpy(x)
    got = pp_schedule_fwd(PPCommOp(n), lambda s, a: a + (s + 1.0),
                          xt.expand(n, *xt.shape), N_MB)
    assert got.shape == (n, N_MB, mb, feat)
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want)
    # every stage added its index + 1 once (in sequence, so to f32
    # rounding of the single sum)
    np.testing.assert_allclose(want, x + n * (n + 1) / 2, rtol=0, atol=1e-6)
    assert shifts == [1] * (N_MB + n - 1)


def test_pp_comm_op_matches_jax():
    """send_forward / send_backward are the JAX ring shifts by +1 / -1."""
    n, m, w = 4, 8, 128
    x = np.random.default_rng(3).standard_normal((n * m, w)).astype(
        np.float32)
    mesh = make_mesh(mesh_shape=(n,), axis_names=(PP_AXIS,))
    comm, jcomm = PPCommOp(n), JaxPPCommOp(axis=PP_AXIS)
    xt = torch.from_numpy(x).reshape(n, m, w)
    for name in ("send_forward", "send_backward"):
        want = np.asarray(jax.jit(jax.shard_map(
            getattr(jcomm, name), mesh=mesh, in_specs=P(PP_AXIS),
            out_specs=P(PP_AXIS), check_vma=False))(x))
        got = getattr(comm, name)(xt)
        np.testing.assert_array_equal(got.numpy().reshape(n * m, w), want)
    with pytest.raises(ValueError, match="pipeline of 4 stages"):
        comm.send_forward(torch.ones(2, 3))
    with pytest.raises(ValueError, match="microbatches"):
        pp_schedule_fwd(comm, lambda s, a: a, torch.ones(4, 3, 2), N_MB)


def _jax_layers_pp(cfg, jp, x, n, s):
    """JAX pp_schedule_fwd on a (pp = n, tp = 1) mesh; rank r holds
    layers [r L/n, (r+1) L/n) and applies them with the JAX `ar` blocks
    of tp size 1, no KV cache."""
    per = cfg.num_layers // n
    # strip the tp dim of the sharded weights: (L, 1, ...) -> (L, ...)
    lay = {k: (v[:, 0] if k in ("w_qkv", "w_o", "w_gate", "w_up", "w_down")
               else v)
           for k, v in jp.layers._asdict().items() if v is not None}
    spec = JaxAttnSpec(cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim)

    def per_rank(xs, lp):
        cos, sin = jax_rope_table(cfg.head_dim, s, cfg.rope_theta)
        positions = jnp.arange(s)[None]

        def stage_fn(stage, act):
            for i in range(per):
                li = {k: v[i] for k, v in lp.items()}
                h = jax_rms_norm(act, li["input_ln"], cfg.rms_eps)
                attn = JaxAttnParams(
                    w_qkv=li["w_qkv"], w_o=li["w_o"],
                    q_norm=li["q_norm"] if cfg.use_qk_norm else None,
                    k_norm=li["k_norm"] if cfg.use_qk_norm else None)
                a, _ = jax_tp_attn_fwd(h, attn, spec, cos, sin, positions, 1,
                                       axis=TP_AXIS, mode="ar")
                act = act + a
                h = jax_rms_norm(act, li["post_attn_ln"], cfg.rms_eps)
                act = act + jax_tp_mlp_fwd(
                    h, JaxMLPParams(li["w_gate"], li["w_up"], li["w_down"]),
                    axis=TP_AXIS, mode="ar")
            return act

        return jax_pp_schedule_fwd(JaxPPCommOp(axis=PP_AXIS), stage_fn, xs,
                                   x.shape[0])

    mesh = make_mesh(mesh_shape=(n, 1), axis_names=(PP_AXIS, TP_AXIS))
    return np.asarray(jax.jit(jax.shard_map(
        per_rank, mesh=mesh, in_specs=(P(), P(PP_AXIS)), out_specs=P(),
        check_vma=False))(x, lay))


@pytest.mark.parametrize("n", [2, 4])
def test_pp_schedule_of_model_layers_matches_jax(n, shifts):
    """A tiny f32 dense model of 4 layers cut into n stages (pp_stage_fn)
    against the JAX schedule over the JAX layers, 1e-5; and bitwise the
    port's own layers run on each microbatch alone, in order."""
    kw = dict(num_layers=4, num_q_heads=4, num_kv_heads=2, max_positions=64)
    jcfg, cfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    mesh1 = make_mesh(mesh_shape=(1,), axis_names=(TP_AXIS,))
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, mesh1, seed=5))
    params = params_from_jax(types.SimpleNamespace(**jp._asdict()),
                             device="cpu")
    s = 8
    ids = np.random.default_rng(n).integers(0, cfg.vocab_size, (N_MB, s))
    x = jp.embed[ids]  # (microbatches, S, H): one sequence a microbatch
    want = _jax_layers_pp(jcfg, jp, x, n, s)
    xt = torch.from_numpy(x)
    got = pp_schedule_fwd(PPCommOp(n), pp_stage_fn(cfg, params, n),
                          xt.expand(n, *xt.shape), N_MB)
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0,
                                   atol=LAYER_ATOL)
    for i in range(N_MB):
        alone = layers_fwd(cfg, params, xt[i], range(cfg.num_layers))
        assert torch.equal(got[0, i], alone)
    assert len(shifts) == N_MB + n - 1


def test_pp_stage_fn_needs_whole_stages():
    cfg = ModelConfig.tiny(num_layers=4)
    with pytest.raises(ValueError, match="3 stages"):
        pp_stage_fn(cfg, None, 3)
    params = types.SimpleNamespace(world_size=4)
    with pytest.raises(ValueError, match="world 1"):
        layers_fwd(cfg, params, torch.ones(8, 128), range(4))

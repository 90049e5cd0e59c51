"""The port's dense model and Engine (triton_dist_tpu_torch.models)
against the JAX package's, with the JAX weights carried across.

Tiny config in f32 on the CPU, the JAX Engine on a 1-device tp mesh.
The port keeps the JAX cast points, so the logits agree to f32
rounding: 1e-4 absolute on logits of magnitude ~1 (the sums run in
another order in the two libraries, over two layers)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.models.dense import init_params as jax_init_params
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.models import (
    Engine,
    ModelConfig,
    forward,
    params_from_jax,
)
from triton_dist_tpu_torch.models.dense import init_params

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=64)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG), mesh, decode_mode="ar",
                     max_len=64, donate_cache=False)
    np_params = jax.tree.map(np.asarray, jeng.params)
    eng = Engine(ModelConfig.tiny(**CFG), device="cpu", max_len=64,
                 params=params_from_jax(np_params, device="cpu"))
    return jeng, eng, np_params


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(7).integers(0, 256, (2, 11)).astype(np.int32)


def test_params_from_jax_round_trip(engines):
    _, eng, p = engines
    got = eng.params
    np.testing.assert_array_equal(got.embed.numpy(), p.embed)
    np.testing.assert_array_equal(got.lm_head.numpy(), p.lm_head[0])
    np.testing.assert_array_equal(got.final_ln.numpy(), p.final_ln)
    for name in ("w_qkv", "w_o", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(getattr(got.layers, name).numpy(),
                                      getattr(p.layers, name)[:, 0])
    for name in ("input_ln", "post_attn_ln", "q_norm", "k_norm"):
        np.testing.assert_array_equal(getattr(got.layers, name).numpy(),
                                      getattr(p.layers, name))


def test_params_from_jax_carries_bf16_bits():
    """bf16 arrays cross as their bits, without a float round trip; any
    object with the JAX attribute names will do."""
    cfg = JaxModelConfig.tiny(**CFG, dtype="bfloat16")
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jp = jax.tree.map(np.asarray, jax_init_params(cfg, mesh, seed=3))
    got = params_from_jax(types.SimpleNamespace(**jp._asdict()),
                          device="cpu")
    assert got.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.embed.view(torch.int16).numpy(),
                                  jp.embed.view(np.int16))


def test_init_params_shapes_and_seed():
    cfg = ModelConfig.tiny(**CFG)
    a = init_params(cfg, device="cpu", seed=1)
    b = init_params(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    assert a.layers.w_qkv.shape == (2, 128, (4 + 2 * 2) * 32)
    assert a.lm_head.shape == (128, 256)
    assert torch.equal(a.layers.w_down, b.layers.w_down)


def test_prefill_and_decode_logits_match_jax(engines, prompts):
    """Prefill, then three greedy decode steps, each step's logits held
    against the JAX Engine's on the same tokens."""
    jeng, eng, _ = engines
    jl, jcache = jeng.prefill(jnp.asarray(prompts))
    tl, tcache = eng.prefill(prompts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jeng.decode_step(jnp.asarray(tok), jcache)
        tl, tcache = eng.decode_step(tok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tcache.length.tolist() == [prompts.shape[1] + 3] * 2


def test_full_logits_match_last_logits(engines, prompts):
    _, eng, _ = engines
    full, _ = forward(eng.cfg, eng.params, torch.from_numpy(prompts).long(),
                      eng.new_cache(2), return_full_logits=True)
    last, _ = eng.prefill(prompts)
    assert full.shape == (2, prompts.shape[1], 256)
    torch.testing.assert_close(full[:, -1], last, rtol=0, atol=1e-6)


def test_serve_greedy_tokens_match_jax(engines, prompts):
    jeng, eng, _ = engines
    want = np.asarray(jeng.serve(jnp.asarray(prompts), 6))
    got = eng.serve(prompts, 6)
    assert got.tolist() == want.tolist()


def test_serve_sampled_is_seeded(engines, prompts):
    """Temperature sampling draws from a seeded generator: the same seed
    gives the same tokens, the tokens are valid ids."""
    _, eng, _ = engines
    a = eng.serve(prompts, 4, temperature=0.8, seed=5)
    b = eng.serve(prompts, 4, temperature=0.8, seed=5)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 256


def test_world_above_one_names_missing_kernels():
    with pytest.raises(NotImplementedError, match="gemm_rs"):
        Engine(ModelConfig.tiny(**CFG), device="cpu", world=2)

"""The port's dense model and Engine (triton_dist_tpu_torch.models)
against the JAX package's, with the JAX weights carried across.

Tiny config in f32 on the CPU, the JAX Engine on a 1-device tp mesh and,
for tensor parallelism, on a 4-device mesh in the `ar` mode (its
collectives in interpret mode) against the port's Engine at world 4 (the
virtual world, plain collectives on the CPU). The port keeps the JAX
cast points, so the logits agree to f32 rounding: 1e-4 absolute on
logits of magnitude ~1 (the sums run in another order in the two
libraries, over two layers)."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.models import load_hf
from triton_dist_tpu.models.dense import init_params as jax_init_params
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.models import (
    Engine,
    KVCache,
    ModelConfig,
    forward,
    params_from_jax,
    shard_params,
)
from triton_dist_tpu_torch.models.dense import init_params

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=64)
CFG4 = dict(max_positions=64)  # 16 q / 8 kv heads: 4 and 2 a rank
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


def _assert_params_equal(got, want):
    """Every array of the port's params equals the JAX (numpy) one
    bitwise, rank dims included."""
    for name in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    for name in ("w_qkv", "w_o", "w_gate", "w_up", "w_down", "input_ln",
                 "post_attn_ln", "q_norm", "k_norm"):
        np.testing.assert_array_equal(getattr(got.layers, name).numpy(),
                                      getattr(want.layers, name))


def test_params_from_jax_round_trip(engines):
    _, eng, p = engines
    assert eng.params.world_size == 1
    _assert_params_equal(eng.params, p)


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
    assert a.layers.w_qkv.shape == (2, 1, 128, (4 + 2 * 2) * 32)
    assert a.lm_head.shape == (1, 128, 256)
    assert torch.equal(a.layers.w_down, b.layers.w_down)
    c = init_params(ModelConfig.tiny(), device="cpu", seed=1, world=4)
    assert c.layers.w_qkv.shape == (2, 4, 128, (4 + 2 * 2) * 32)
    assert c.layers.w_down.shape == (2, 4, 64, 128)
    assert c.lm_head.shape == (4, 128, 64)


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
    """What world > 1 refuses, now that every mode runs there: a
    sequence-sharded forward whose B*S rows n does not divide, a `dist`
    serve step whose slots*chunk rows n does not divide, an unknown mode,
    and a world that does not divide the heads."""
    cfg = ModelConfig.tiny(**CFG)
    eng = Engine(cfg, device="cpu", world=2, max_len=64)
    assert (eng.prefill_mode, eng.decode_mode) == ("dist", "ar")
    with pytest.raises(ValueError, match="divide"):
        eng.prefill(np.zeros((1, 3), np.int64))
    with pytest.raises(ValueError, match="divide"):
        Engine(cfg, device="cpu", world=2, max_len=64,
               decode_mode="dist").make_serve_step(3, 3, 8, 8)
    with pytest.raises(ValueError, match="mode"):
        Engine(cfg, device="cpu", world=2, prefill_mode="ring")
    with pytest.raises(ValueError, match="divide"):
        Engine(ModelConfig.tiny(**CFG), device="cpu", world=4,
               prefill_mode="ar")


# ---------- tensor parallelism: world 4, `ar` mode ----------


@pytest.fixture(scope="module")
def engines4():
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG4), mesh, prefill_mode="ar",
                     decode_mode="ar", max_len=64, donate_cache=False)
    np_params = jax.tree.map(np.asarray, jeng.params)
    eng = Engine(ModelConfig.tiny(**CFG4), device="cpu", max_len=64, world=4,
                 prefill_mode="ar", params=params_from_jax(np_params, "cpu"))
    return jeng, eng, np_params


def test_params_from_jax_round_trip_world4(engines4):
    _, eng, p = engines4
    assert eng.params.world_size == 4
    assert eng.params.layers.w_qkv.shape == (2, 4, 128, (4 + 2 * 2) * 32)
    _assert_params_equal(eng.params, p)


def test_world4_prefill_and_decode_logits_match_jax(engines4):
    """One prefill of 8 x 40 = 320 rows (> 256 and divisible by 4, so
    gemm_ar takes gemm_rs + ring AG), then three greedy decode steps (8
    rows: local product + one-shot AR), each step's logits against the
    JAX Engine's on a 4-device mesh; the caches agree in the JAX
    layout."""
    jeng, eng, _ = engines4
    ids = np.random.default_rng(8).integers(0, 256, (8, 40)).astype(np.int32)
    jl, jcache = jeng.prefill(jnp.asarray(ids))
    tl, tcache = eng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jeng.decode_step(jnp.asarray(tok), jcache)
        tl, tcache = eng.decode_step(tok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    k, v = tcache.jax_layout()
    live = ids.shape[1] + 3
    np.testing.assert_allclose(k[:, :, :live].numpy(),
                               np.asarray(jcache.k)[:, :, :live], atol=1e-5)
    np.testing.assert_allclose(v[:, :, :live].numpy(),
                               np.asarray(jcache.v)[:, :, :live], atol=1e-5)


def test_world4_serve_greedy_tokens_match_jax(engines4):
    jeng, eng, _ = engines4
    ids = np.random.default_rng(9).integers(0, 256, (2, 11)).astype(np.int32)
    want = np.asarray(jeng.serve(jnp.asarray(ids), 6))
    assert eng.serve(ids, 6).tolist() == want.tolist()


def test_world4_kv_cache_layout():
    """Rank r's kv heads are rows r*B..r*B+B-1 of the port's cache; the
    JAX layout puts them at heads r*Hkv/n.."""
    c = KVCache.create(2, 3, 5, 8, 4, torch.float32, "cpu", world=4)
    assert c.k.shape == (2, 12, 5, 2, 4) and c.length.shape == (3,)
    c.k.copy_(torch.arange(c.k.numel(), dtype=torch.float32).reshape(
        c.k.shape))
    k, _ = c.jax_layout()
    assert k.shape == (2, 3, 5, 8, 4)
    assert torch.equal(k[:, 1, :, 6:8], c.k[:, 3 * 3 + 1])


_CONSTRUCTORS = {
    "KVCache.create": lambda cfg, **kw: KVCache.create(
        2, 3, 8, cfg.num_kv_heads, cfg.head_dim, cfg.torch_dtype, **kw),
    "MegaKVCache.create": lambda cfg, **kw: _mega().MegaKVCache.create(
        cfg, 3, 8, cfg.num_kv_heads, **kw),
    "PagedMegaKVCache.create": lambda cfg, **kw: (
        _mega().PagedMegaKVCache.create(cfg, 3, cfg.num_kv_heads, 4, 2, 7,
                                        **kw)),
    "rope_table": lambda cfg, **kw: _rope_table(cfg.head_dim, 8, **kw),
}


def _mega():
    from triton_dist_tpu_torch.mega import qwen3

    return qwen3


def _rope_table(*a, **kw):
    from triton_dist_tpu_torch.layers.rope import rope_table

    return rope_table(*a, **kw)


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """With no device the public constructors resolve "cuda", as every
    entry point does (runtime.device.resolve_device): on a host without
    CUDA they raise instead of allocating on the CPU; with device="cpu"
    they build there."""
    cfg = ModelConfig.tiny()
    make = _CONSTRUCTORS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(cfg)
    built = make(cfg, device="cpu")
    items = built if isinstance(built, tuple) else vars(built).values()
    tensors = [t for t in items if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def _params_to_hf(cfg, p):
    """HF-layout tensors (torch (out, in) Linear weights) of world-1
    JAX params, as tests/test_load_hf.py writes them."""
    lp = p.layers
    d, hq, hkv = cfg.head_dim, cfg.num_q_heads, cfg.num_kv_heads
    t = {"model.embed_tokens.weight": p.embed,
         "model.norm.weight": p.final_ln, "lm_head.weight": p.lm_head[0].T}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        qkv = lp.w_qkv[i, 0]
        t.update({
            pre + "input_layernorm.weight": lp.input_ln[i],
            pre + "post_attention_layernorm.weight": lp.post_attn_ln[i],
            pre + "self_attn.q_proj.weight": qkv[:, :hq * d].T,
            pre + "self_attn.k_proj.weight": qkv[:, hq * d:(hq + hkv) * d].T,
            pre + "self_attn.v_proj.weight": qkv[:, (hq + hkv) * d:].T,
            pre + "self_attn.o_proj.weight": lp.w_o[i, 0].T,
            pre + "self_attn.q_norm.weight": lp.q_norm[i],
            pre + "self_attn.k_norm.weight": lp.k_norm[i],
            pre + "mlp.gate_proj.weight": lp.w_gate[i, 0].T,
            pre + "mlp.up_proj.weight": lp.w_up[i, 0].T,
            pre + "mlp.down_proj.weight": lp.w_down[i, 0].T,
        })
    return {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}


def test_shard_params_matches_jax_load_hf_sharding(tmp_path):
    """One synthetic checkpoint written locally, loaded by the JAX
    load_hf at mesh 1 and mesh 4: the port's shard_params of the first
    equals the second bitwise (the JAX package's own sharding rule)."""
    from safetensors.numpy import save_file

    cfg = JaxModelConfig.tiny(**CFG4)
    mesh1 = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    mesh4 = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    src = jax.tree.map(np.asarray, jax_init_params(cfg, mesh1, seed=6))
    save_file(_params_to_hf(cfg, src),
              os.path.join(tmp_path, "model.safetensors"))
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen3ForCausalLM"]}, f)
    p1 = jax.tree.map(np.asarray, load_hf(str(tmp_path), mesh1, cfg))
    p4 = jax.tree.map(np.asarray, load_hf(str(tmp_path), mesh4, cfg))
    got = shard_params(params_from_jax(p1, "cpu"), 4)
    _assert_params_equal(got, p4)
    with pytest.raises(ValueError, match="already"):
        shard_params(got, 2)


# ---------- world 4 with the JAX defaults: dist prefill, ar decode ----------


@pytest.fixture(scope="module")
def engines4_default():
    """Both Engines with their default modes on the same weights."""
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG4), mesh, max_len=64,
                     donate_cache=False)
    np_params = jax.tree.map(np.asarray, jeng.params)
    eng = Engine(ModelConfig.tiny(**CFG4), device="cpu", max_len=64, world=4,
                 params=params_from_jax(np_params, "cpu"))
    assert (jeng.prefill_mode, jeng.decode_mode) == ("dist", "ar")
    assert (eng.prefill_mode, eng.decode_mode) == ("dist", "ar")
    return jeng, eng, np_params


def test_world4_default_modes_prefill_and_decode_match_jax(engines4_default):
    """A `dist` prefill of 8 x 40 = 320 rows (80 a rank: ag_gemm on QKV
    and gate|up, gemm_rs on O and down, the JAX kernels in interpret
    mode), then three `ar` decode steps, each step's logits against the
    JAX Engine's; the caches agree in the JAX layout."""
    from triton_dist_tpu.lang.core import pallas_call_count

    jeng, eng, _ = engines4_default
    ids = np.random.default_rng(10).integers(0, 256, (8, 40)).astype(np.int32)
    before = pallas_call_count()
    jl, jcache = jeng.prefill(jnp.asarray(ids))
    assert pallas_call_count() > before, "the JAX kernels did not run"
    tl, tcache = eng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jeng.decode_step(jnp.asarray(tok), jcache)
        tl, tcache = eng.decode_step(tok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    k, v = tcache.jax_layout()
    live = ids.shape[1] + 3
    np.testing.assert_allclose(k[:, :, :live].numpy(),
                               np.asarray(jcache.k)[:, :, :live], atol=1e-5)
    np.testing.assert_allclose(v[:, :, :live].numpy(),
                               np.asarray(jcache.v)[:, :, :live], atol=1e-5)


def test_world4_default_modes_serve_greedy_tokens_match_jax(
        engines4_default):
    jeng, eng, _ = engines4_default
    ids = np.random.default_rng(11).integers(0, 256, (2, 8)).astype(np.int32)
    want = np.asarray(jeng.serve(jnp.asarray(ids), 4))
    assert eng.serve(ids, 4).tolist() == want.tolist()


def test_world4_xla_prefill_matches_jax(engines4_default):
    """The `xla` mode (torch ops where the JAX package leaves the
    collectives and dots to XLA) against the JAX `xla` prefill, and
    against the `dist` prefill of the same weights."""
    jeng, eng, p = engines4_default
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jx = JaxEngine(JaxModelConfig.tiny(**CFG4), mesh, prefill_mode="xla",
                   params=jeng.params, max_len=64, donate_cache=False)
    ex = Engine(ModelConfig.tiny(**CFG4), device="cpu", max_len=64, world=4,
                prefill_mode="xla", params=eng.params)
    ids = np.random.default_rng(12).integers(0, 256, (4, 10)).astype(np.int32)
    jl, _ = jx.prefill(jnp.asarray(ids))
    tl, _ = ex.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    dl, _ = eng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), rtol=0,
                               atol=LOGIT_ATOL)


# ---------- the MoE model (Qwen3MoE), tiny, world 4 ----------

MOE4 = dict(max_positions=64)  # 16 q / 8 kv heads, 4 experts of 64, top-2
MOE_FIELDS = ("w_qkv", "w_o", "w_gate_up", "w_down", "w_router", "input_ln",
              "post_attn_ln", "q_norm", "k_norm")


def _assert_moe_params_equal(got, want):
    for name in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    for name in MOE_FIELDS:
        np.testing.assert_array_equal(getattr(got.layers, name).numpy(),
                                      getattr(want.layers, name))
    assert got.layers.w_gate is None and got.layers.w_up is None


@pytest.fixture(scope="module")
def moe_engines4():
    """The JAX and the port's Engine on tiny_moe at world 4 with their
    default modes (dist prefill, ar decode), the JAX weights carried
    across."""
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny_moe(**MOE4), mesh, max_len=64,
                     donate_cache=False)
    np_params = jax.tree.map(np.asarray, jeng.params)
    eng = Engine(ModelConfig.tiny_moe(**MOE4), device="cpu", max_len=64,
                 world=4, params=params_from_jax(np_params, "cpu"))
    return jeng, eng, np_params


def test_moe_params_from_jax_round_trip_world4(moe_engines4):
    _, eng, p = moe_engines4
    assert eng.params.world_size == 4
    assert eng.params.layers.w_gate_up.shape == (2, 4, 4, 128, 2 * 16)
    assert eng.params.layers.w_down.shape == (2, 4, 4, 16, 128)
    _assert_moe_params_equal(eng.params, p)


def test_moe_init_params_shapes():
    p = init_params(ModelConfig.tiny_moe(), device="cpu", seed=2, world=4)
    assert p.layers.w_gate_up.shape == (2, 4, 4, 128, 32)
    assert p.layers.w_router.shape == (2, 128, 4)
    assert p.layers.w_gate is None
    with pytest.raises(ValueError, match="moe_intermediate_size"):
        init_params(ModelConfig.tiny_moe(moe_intermediate_size=66),
                    device="cpu", world=4)


def test_moe_default_modes_prefill_decode_and_serve_match_jax(moe_engines4):
    """A `dist` prefill of 8 x 12 = 96 rows (24 a rank: the ring AG and
    the ring RS around the MoE block, the JAX kernels in interpret mode),
    then three `ar` decode steps, each step's logits within 1e-4 of the
    JAX Engine's; Engine.serve's greedy tokens identical."""
    from triton_dist_tpu.lang.core import pallas_call_count

    jeng, eng, _ = moe_engines4
    ids = np.random.default_rng(20).integers(0, 256, (8, 12)).astype(np.int32)
    before = pallas_call_count()
    jl, jcache = jeng.prefill(jnp.asarray(ids))
    assert pallas_call_count() > before, "the JAX kernels did not run"
    tl, tcache = eng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jeng.decode_step(jnp.asarray(tok), jcache)
        tl, tcache = eng.decode_step(tok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    small = ids[:2, :8]
    want = np.asarray(jeng.serve(jnp.asarray(small), 4))
    assert eng.serve(small, 4).tolist() == want.tolist()


@pytest.mark.parametrize("mode", ["xla", "fused"])
def test_moe_prefill_modes_match_jax(moe_engines4, mode):
    """The `xla` and the one-kernel `fused` prefill (attention `dist`,
    the MoE block capacity-packed through the grouped ag_gemm) against
    the JAX Engine in the same mode, within 1e-4, and against the port's
    own `dist` prefill."""
    jeng, eng, _ = moe_engines4
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jm = JaxEngine(JaxModelConfig.tiny_moe(**MOE4), mesh, prefill_mode=mode,
                   params=jeng.params, max_len=64, donate_cache=False)
    em = Engine(ModelConfig.tiny_moe(**MOE4), device="cpu", max_len=64,
                world=4, prefill_mode=mode, params=eng.params)
    ids = np.random.default_rng(21).integers(0, 256, (4, 8)).astype(np.int32)
    jl, _ = jm.prefill(jnp.asarray(ids))
    tl, _ = em.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    dl, _ = eng.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), rtol=0,
                               atol=LOGIT_ATOL)


def test_fused_mode_is_moe_only():
    """`fused` names the MoE pipeline: a dense config refuses it in the
    Engine and in forward, as the JAX planner does."""
    cfg = ModelConfig.tiny(**CFG4)
    with pytest.raises(ValueError, match="fused"):
        Engine(cfg, device="cpu", world=4, prefill_mode="fused")
    eng = Engine(cfg, device="cpu", world=4, max_len=64)
    with pytest.raises(ValueError, match="fused"):
        forward(cfg, eng.params, torch.zeros(1, 4, dtype=torch.long),
                eng.new_cache(1), mode="fused")
    Engine(ModelConfig.tiny_moe(**MOE4), device="cpu", world=4, max_len=64,
           prefill_mode="fused", decode_mode="fused")


def _moe_params_to_hf(cfg, p):
    """HF-layout tensors of world-1 JAX MoE params (Qwen3MoE names)."""
    lp = p.layers
    d, hq, hkv = cfg.head_dim, cfg.num_q_heads, cfg.num_kv_heads
    mi = cfg.moe_intermediate_size
    t = {"model.embed_tokens.weight": p.embed,
         "model.norm.weight": p.final_ln, "lm_head.weight": p.lm_head[0].T}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        qkv = lp.w_qkv[i, 0]
        t.update({
            pre + "input_layernorm.weight": lp.input_ln[i],
            pre + "post_attention_layernorm.weight": lp.post_attn_ln[i],
            pre + "self_attn.q_proj.weight": qkv[:, :hq * d].T,
            pre + "self_attn.k_proj.weight": qkv[:, hq * d:(hq + hkv) * d].T,
            pre + "self_attn.v_proj.weight": qkv[:, (hq + hkv) * d:].T,
            pre + "self_attn.o_proj.weight": lp.w_o[i, 0].T,
            pre + "self_attn.q_norm.weight": lp.q_norm[i],
            pre + "self_attn.k_norm.weight": lp.k_norm[i],
            pre + "mlp.gate.weight": lp.w_router[i].T,
        })
        for e in range(cfg.num_experts):
            ep = f"{pre}mlp.experts.{e}."
            gu = lp.w_gate_up[i, 0, e]
            t.update({ep + "gate_proj.weight": gu[:, :mi].T,
                      ep + "up_proj.weight": gu[:, mi:].T,
                      ep + "down_proj.weight": lp.w_down[i, 0, e].T})
    return {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}


def test_moe_shard_params_matches_jax_load_hf_sharding(tmp_path):
    """A synthetic Qwen3MoE checkpoint written locally, loaded by the JAX
    load_hf at mesh 1 and mesh 4: the port's shard_params of the first
    equals the second bitwise (per-rank [gate_r | up_r] per expert, the
    down projection split by rows, the router replicated)."""
    from safetensors.numpy import save_file

    cfg = JaxModelConfig.tiny_moe(**MOE4)
    mesh1 = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    mesh4 = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    src = jax.tree.map(np.asarray, jax_init_params(cfg, mesh1, seed=7))
    save_file(_moe_params_to_hf(cfg, src),
              os.path.join(tmp_path, "model.safetensors"))
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen3MoeForCausalLM"]}, f)
    p1 = jax.tree.map(np.asarray, load_hf(str(tmp_path), mesh1, cfg))
    p4 = jax.tree.map(np.asarray, load_hf(str(tmp_path), mesh4, cfg))
    got = shard_params(params_from_jax(p1, "cpu"), 4)
    _assert_moe_params_equal(got, p4)
    assert got.layers.w_down.is_contiguous()

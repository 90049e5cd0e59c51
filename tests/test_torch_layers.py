"""The port's layers (triton_dist_tpu_torch.layers) against the JAX
package's, on the same numpy inputs in f32 on the CPU. The tensor-
parallel blocks run at world 4: the JAX `ar` forms under shard_map on a
4-device mesh (collectives in interpret mode), the port's on the
virtual world (rank-stacked tensors, plain collectives on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers import attention as jax_attention
from triton_dist_tpu.layers import norm as jax_norm
from triton_dist_tpu.layers import rope as jax_rope
from triton_dist_tpu.layers import tp_attn as jax_tp_attn
from triton_dist_tpu.layers import tp_mlp as jax_tp_mlp
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.layers import (
    TPAttnParams,
    TPAttnSpec,
    TPMLPParams,
    apply_rope,
    gqa_attention,
    rms_norm,
    rope_table,
    tp_attn_fwd,
    tp_mlp_fwd,
)
from triton_dist_tpu_torch.layers.tp_attn import KVWrite, _scatter_kv
from triton_dist_tpu_torch.runtime import VirtualWorld

N = 4  # ranks of the tensor-parallel tests


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches_jax():
    """Same op sequence in f32: agreement to f32 rounding (1e-6)."""
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 5, 3, 64), _rand(rng, 64)
    want = np.asarray(jax_norm.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rope_matches_jax():
    """Tables and rotation in f32. cos/sin of angles up to ~64 rad: the
    two libraries' pow/cos/sin may differ in the last ulps, so 1e-5."""
    d, n = 32, 64
    cos, sin = rope_table(d, n, 1e6, device="cpu")
    jcos, jsin = jax_rope.rope_table(d, n, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, d)
    pos = rng.integers(0, n, (2, 7))
    want = np.asarray(jax_rope.apply_rope(jnp.asarray(x), jcos, jsin,
                                          jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), cos, sin, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 6])
def test_gqa_attention_with_cache_matches_jax(s):
    """S == 1 (decode, dense plain torch) and S > 1 (prefill into the
    cache, the flash-prefill path) over a cache with per-row kv_len and
    absolute q positions. 2e-5: the JAX dense chain and the port's plain
    version take the same f32 steps, up to the order of the sums."""
    rng = np.random.default_rng(2)
    b, t, hq, hkv, d = 3, 24, 8, 2, 16
    q = _rand(rng, b, s, hq, d)
    k, v = _rand(rng, b, t, hkv, d), _rand(rng, b, t, hkv, d)
    start = np.asarray([0, 5, 17])
    qpos = start[:, None] + np.arange(s)[None]
    kv_len = start + s
    want = np.asarray(jax_attention.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(qpos), kv_len=jnp.asarray(kv_len)))
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True,
                        q_positions=torch.from_numpy(qpos),
                        kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_gqa_attention_no_cache_matches_jax():
    """Plain causal prefill with no cache (q_offset form)."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 2, 9, 4, 16), _rand(rng, 2, 9, 2, 16),
               _rand(rng, 2, 9, 2, 16))
    want = np.asarray(jax_attention.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_scatter_kv_drops_rows_past_the_horizon():
    """A row whose position lies past T is dropped, as the JAX scatter
    drops out-of-bounds updates; the others land at their positions."""
    cache = torch.zeros(2, 6, 1, 2)
    kv = torch.arange(1, 9, dtype=torch.float32).reshape(2, 2, 1, 2)
    pos = torch.tensor([[1, 2], [5, 6]])
    _scatter_kv(cache, kv, KVWrite.at(pos, 6))
    assert torch.equal(cache[0, 1:3], kv[0])
    assert torch.equal(cache[1, 5], kv[1, 0])
    assert int((cache != 0).sum()) == 6


def _mesh4():
    return make_mesh(mesh_shape=(N,), axis_names=("tp",))


@pytest.mark.parametrize("m", [8, 264], ids=["one_shot_ar", "gemm_rs_ag"])
def test_tp_mlp_ar_world4_matches_jax(m):
    """Gate/up per rank, silu_mul, gemm_ar on down, in both gemm_ar
    regimes; every rank's replica against the JAX block's output."""
    rng = np.random.default_rng(4)
    h, i_l = 32, 16
    x = _rand(rng, m, h)
    wg, wu = _rand(rng, N, h, i_l, scale=0.2), _rand(rng, N, h, i_l, scale=0.2)
    wd = _rand(rng, N, i_l, h, scale=0.2)

    def per_rank(x, wg, wu, wd):
        return jax_tp_mlp.tp_mlp_ar_fwd(
            x, jax_tp_mlp.TPMLPParams(wg[0], wu[0], wd[0]), axis="tp")

    want = np.asarray(jax.jit(jax.shard_map(
        per_rank, mesh=_mesh4(), in_specs=(P(), P("tp"), P("tp"), P("tp")),
        out_specs=P(), check_vma=False))(x, wg, wu, wd))
    got = tp_mlp_fwd(torch.from_numpy(x).expand(N, m, h),
                     TPMLPParams(*(torch.from_numpy(w) for w in (wg, wu, wd))),
                     VirtualWorld(N, "cpu"), mode="ar")
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0, atol=1e-5)


def test_tp_attn_ar_world4_matches_jax():
    """Per-rank QKV, qk-norm, rope, attention over the rank's kv heads
    with a cache (ranks as extra batch rows), gemm_ar on O; the output of
    every rank and the cache, in the JAX layout, against the JAX block."""
    rng = np.random.default_rng(5)
    b, s, t, h, d = 2, 6, 16, 64, 16
    hq_l, hkv_l = 2, 1  # per rank: 8 q heads, 4 kv heads in all
    x = _rand(rng, b * s, h)
    w_qkv = _rand(rng, N, h, (hq_l + 2 * hkv_l) * d, scale=0.2)
    w_o = _rand(rng, N, hq_l * d, h, scale=0.2)
    qn, kn = 1 + _rand(rng, d, scale=0.1), 1 + _rand(rng, d, scale=0.1)
    k0 = _rand(rng, b, t, N * hkv_l, d)
    v0 = _rand(rng, b, t, N * hkv_l, d)
    start = np.asarray([0, 5])
    pos = start[:, None] + np.arange(s)[None]
    kv_len = start + s
    cos, sin = jax_rope.rope_table(d, t, 1e6)
    spec = TPAttnSpec(hq_l, hkv_l, d)

    def per_rank(x, wq, wo, k, v):
        return jax_tp_attn.tp_attn_ar_fwd(
            x, jax_tp_attn.TPAttnParams(wq[0], wo[0], jnp.asarray(qn),
                                        jnp.asarray(kn)),
            jax_tp_attn.TPAttnSpec(*spec), cos, sin, jnp.asarray(pos), b,
            axis="tp", kv_cache=(k, v), kv_len=jnp.asarray(kv_len))

    heads = P(None, None, "tp")
    want, (wk, wv) = jax.jit(jax.shard_map(
        per_rank, mesh=_mesh4(), in_specs=(P(), P("tp"), P("tp"), heads,
                                           heads),
        out_specs=(P(), (heads, heads)), check_vma=False))(x, w_qkv, w_o,
                                                           k0, v0)

    def rank_rows(c):  # (B, T, N*hkv_l, D) -> (N*B, T, hkv_l, D)
        c = torch.from_numpy(np.array(c)).reshape(b, t, N, hkv_l, d)
        return c.permute(2, 0, 1, 3, 4).reshape(N * b, t, hkv_l, d)

    kc, vc = rank_rows(k0), rank_rows(v0)
    rank_pos = torch.from_numpy(pos).repeat(N, 1)
    tcos, tsin = rope_table(d, t, 1e6, device="cpu")
    got = tp_attn_fwd(
        torch.from_numpy(x).expand(N, b * s, h),
        TPAttnParams(torch.from_numpy(w_qkv), torch.from_numpy(w_o),
                     torch.from_numpy(qn), torch.from_numpy(kn)),
        spec, tcos, tsin, rank_pos, b, VirtualWorld(N, "cpu"),
        kv_cache=(kc, vc), kv_len=torch.from_numpy(kv_len).repeat(N),
        kv_write=KVWrite.at(rank_pos, t), mode="ar")
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                   rtol=0, atol=2e-5)
    for mine, theirs in ((kc, wk), (vc, wv)):
        np.testing.assert_allclose(mine.numpy(),
                                   rank_rows(np.asarray(theirs)).numpy(),
                                   rtol=0, atol=1e-5)


# ---------- the sequence-sharded modes: dist and xla ----------


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_tp_mlp_seq_sharded_world4_matches_jax(mode):
    """x sharded over the ranks by rows; dist: ag_gemm(silu_pair,
    arrival) -> gemm_rs(arrival); xla: all-gather, dots, psum_scatter.
    Against the JAX block of the same mode (its kernels in interpret
    mode for dist), 1e-5."""
    rng = np.random.default_rng(6)
    m, h, i_l = 16, 32, 16
    x = _rand(rng, m, h)
    wg, wu = _rand(rng, N, h, i_l, scale=0.2), _rand(rng, N, h, i_l, scale=0.2)
    wd = _rand(rng, N, i_l, h, scale=0.2)

    def per_rank(x, wg, wu, wd):
        return jax_tp_mlp.MODES[mode](
            x, jax_tp_mlp.TPMLPParams(wg[0], wu[0], wd[0]), axis="tp")

    before = pallas_call_count()
    want = np.asarray(jax.jit(jax.shard_map(
        per_rank, mesh=_mesh4(), in_specs=(P("tp"),) * 4,
        out_specs=P("tp"), check_vma=False))(x, wg, wu, wd))
    assert (pallas_call_count() > before) == (mode == "dist")
    got = tp_mlp_fwd(torch.from_numpy(x).reshape(N, m // N, h),
                     TPMLPParams(*(torch.from_numpy(w) for w in (wg, wu, wd))),
                     VirtualWorld(N, "cpu"), mode=mode)
    assert got.shape == (N, m // N, h)
    np.testing.assert_allclose(got.numpy().reshape(m, h), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_tp_attn_seq_sharded_world4_matches_jax(mode):
    """x sharded by rows; dist: ag_gemm QKV (rank order) -> attention
    over every rank's heads with a cache -> gemm_rs O; xla: the same on
    torch ops. Output and cache (JAX layout) against the JAX block of
    the same mode, 2e-5 (cache 1e-5), as the `ar` test."""
    rng = np.random.default_rng(7)
    b, s, t, h, d = 2, 6, 16, 64, 16
    hq_l, hkv_l = 2, 1
    x = _rand(rng, b * s, h)
    w_qkv = _rand(rng, N, h, (hq_l + 2 * hkv_l) * d, scale=0.2)
    w_o = _rand(rng, N, hq_l * d, h, scale=0.2)
    qn, kn = 1 + _rand(rng, d, scale=0.1), 1 + _rand(rng, d, scale=0.1)
    k0 = _rand(rng, b, t, N * hkv_l, d)
    v0 = _rand(rng, b, t, N * hkv_l, d)
    start = np.asarray([0, 5])
    pos = start[:, None] + np.arange(s)[None]
    kv_len = start + s
    cos, sin = jax_rope.rope_table(d, t, 1e6)
    spec = TPAttnSpec(hq_l, hkv_l, d)

    def per_rank(x, wq, wo, k, v):
        return jax_tp_attn.MODES[mode](
            x, jax_tp_attn.TPAttnParams(wq[0], wo[0], jnp.asarray(qn),
                                        jnp.asarray(kn)),
            jax_tp_attn.TPAttnSpec(*spec), cos, sin, jnp.asarray(pos), b,
            axis="tp", kv_cache=(k, v), kv_len=jnp.asarray(kv_len))

    heads = P(None, None, "tp")
    before = pallas_call_count()
    want, (wk, wv) = jax.jit(jax.shard_map(
        per_rank, mesh=_mesh4(), in_specs=(P("tp"), P("tp"), P("tp"), heads,
                                           heads),
        out_specs=(P("tp"), (heads, heads)), check_vma=False))(x, w_qkv, w_o,
                                                               k0, v0)
    if mode == "dist":
        assert pallas_call_count() > before, "the JAX kernels did not run"

    def rank_rows(c):  # (B, T, N*hkv_l, D) -> (N*B, T, hkv_l, D)
        c = torch.from_numpy(np.array(c)).reshape(b, t, N, hkv_l, d)
        return c.permute(2, 0, 1, 3, 4).reshape(N * b, t, hkv_l, d)

    kc, vc = rank_rows(k0), rank_rows(v0)
    rank_pos = torch.from_numpy(pos).repeat(N, 1)
    tcos, tsin = rope_table(d, t, 1e6, device="cpu")
    got = tp_attn_fwd(
        torch.from_numpy(x).reshape(N, b * s // N, h),
        TPAttnParams(torch.from_numpy(w_qkv), torch.from_numpy(w_o),
                     torch.from_numpy(qn), torch.from_numpy(kn)),
        spec, tcos, tsin, rank_pos, b, VirtualWorld(N, "cpu"),
        kv_cache=(kc, vc), kv_len=torch.from_numpy(kv_len).repeat(N),
        kv_write=KVWrite.at(rank_pos, t), mode=mode)
    np.testing.assert_allclose(got.numpy().reshape(b * s, h),
                               np.asarray(want), rtol=0, atol=2e-5)
    for mine, theirs in ((kc, wk), (vc, wv)):
        np.testing.assert_allclose(mine.numpy(),
                                   rank_rows(np.asarray(theirs)).numpy(),
                                   rtol=0, atol=1e-5)

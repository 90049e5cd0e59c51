"""The port's layers (triton_dist_tpu_torch.layers) against the JAX
package's, on the same numpy inputs in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.layers import attention as jax_attention
from triton_dist_tpu.layers import norm as jax_norm
from triton_dist_tpu.layers import rope as jax_rope
from triton_dist_tpu_torch.layers import (
    apply_rope,
    gqa_attention,
    rms_norm,
    rope_table,
)
from triton_dist_tpu_torch.layers.tp_attn import KVWrite, _scatter_kv


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
    cos, sin = rope_table(d, n, 1e6)
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

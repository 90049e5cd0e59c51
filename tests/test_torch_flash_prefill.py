"""The port's local flash prefill (triton_dist_tpu_torch.kernels.
flash_prefill) against the JAX package's `flash_prefill_local`.

On the CPU the port's wrapper runs its plain version (dense masked
softmax in f32); the JAX kernel runs in interpret mode, as
tests/test_flash_prefill.py runs it. Same numpy inputs go to both.
Tolerance rtol = atol = 2e-5, the JAX test's own: the kernel's online
softmax re-associates the reductions, so bit parity is not the target.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.flash_prefill import (
    flash_prefill_local as jax_flash_prefill_local,
)
from triton_dist_tpu_torch.kernels import flash_prefill as fp
from triton_dist_tpu_torch.kernels import (
    KERNELS,
    fit_block,
    flash_prefill_local,
    flash_prefill_plain,
    launches,
    reset_launches,
    supports_flash_prefill,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, s, t, hq, hkv, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


def _jax(q, k, v, **kw):
    fn = jax.jit(functools.partial(jax_flash_prefill_local, **kw))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(causal):
    """GQA G=2, kv_len mid-block / empty / full, offset q_positions
    (the serve prefill-into-cache form), several KV blocks."""
    b, s, t, hq, hkv, d = 3, 16, 64, 4, 2, 16
    q, k, v = _inputs(0, b, s, t, hq, hkv, d)
    kv_len = np.asarray([37, 0, 64], np.int32)
    qpos = np.tile(np.arange(s, dtype=np.int32)[None] + 7, (b, 1))
    want = _jax(q, k, v, q_positions=jnp.asarray(qpos),
                kv_len=jnp.asarray(kv_len), causal=causal, block=16)
    got = flash_prefill_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              q_positions=torch.from_numpy(qpos),
                              kv_len=torch.from_numpy(kv_len), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kv_len == 0 row has no live key: exactly 0, never NaN
    assert np.all(got[1].numpy() == 0.0)


def test_plain_matches_jax_kernel_ragged_t():
    """T not a multiple of the JAX block: the JAX kernel pads, the port's
    kernel masks the ragged edge; same function."""
    b, s, t, hq, hkv, d = 1, 8, 23, 2, 1, 16
    q, k, v = _inputs(1, b, s, t, hq, hkv, d)
    want = _jax(q, k, v, block=8)
    got = flash_prefill_local(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    """On a CPU tensor the wrapper computes the plain version (no kernel
    exists there) and its launch count does not move."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 5, 9, 4, 2, 16))
    kv_len = torch.tensor([9, 3])
    reset_launches()
    got = flash_prefill_local(q, k, v, q_offset=4, kv_len=kv_len)
    want = flash_prefill_plain(q, k, v, q_offset=4, kv_len=kv_len)
    assert torch.equal(got, want)
    assert set(launches().values()) == {0}
    assert KERNELS["flash_prefill_local"] is flash_prefill_local


def test_cuda_wrapper_raises_on_cpu_tensor():
    """The launcher never gives way to the plain version, and a refused
    launch counts nothing."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 8, 2, 1, 64))
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fp._launch(q, k, v, None, 0, None, True, None)
    assert set(launches().values()) == {0}


def test_supported_shapes():
    assert supports_flash_prefill(32, 8, 128)
    assert supports_flash_prefill(4, 4, 64)
    assert not supports_flash_prefill(32, 8, 96)
    assert not supports_flash_prefill(6, 4, 128)
    assert fit_block(1000) == 64 == fit_block(7)

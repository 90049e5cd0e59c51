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


@pytest.mark.parametrize("shape,fold,splits", [
    # the main path's shapes: bf16, D = 128, G = 4
    ((4, 64, 1024, 32, 8, 128), "wgmma", 2),  # world-1 serve step: 64 tiles
    ((1, 2048, 2048, 32, 8, 128), "wgmma", 1),  # long prefill: 512 tiles
    ((16, 64, 1024, 8, 2, 128), "wgmma", 2),  # world-4 scheduler step rows
    ((4, 128, 1024, 32, 8, 128), "wgmma", 1),  # engine prefill: 128 tiles
    ((1, 64, 1024, 32, 8, 128), "wgmma", 4),  # one request's step: the cap
    ((2, 33, 95, 3, 3, 128), "wgmma", 2),  # G = 1, ragged: T's 2 tiles
    ((1, 8, 16, 128, 1, 128), "wgmma", 1),  # G = 128, T's one tile
    # every other call keeps the mma.sync fold
    ((4, 64, 1024, 32, 8, 64), "mma", 1),  # D = 64
    ((3, 16, 64, 6, 2, 128), "mma", 1),  # G = 3 does not divide 128
    ((1, 8, 16, 256, 1, 128), "mma", 1),  # G = 256: past one box
])
def test_fp_plan_routes_and_splits(shape, fold, splits):
    """_fp_plan: the wgmma fold for bf16 at D = 128 with a GQA group
    dividing 128, the mma.sync fold otherwise (and for f32); the split
    count keeps one work item (row tile x split) an SM of 132, within
    _MAX_SPLITS and T's key tiles."""
    b, s, t, hq, hkv, d = shape
    assert fp._fp_plan(b, s, t, hq, hkv, d, torch.bfloat16) == (fold,
                                                                 splits)
    assert fp._fp_plan(b, s, t, hq, hkv, d, torch.float32) == ("mma", 1)
    if fold == "wgmma":
        tiles = b * hkv * -(-s * (hq // hkv) // fp._WGMMA_ROWS)
        assert tiles * splits <= max(132, tiles)
        assert splits == fp._MAX_SPLITS or (splits + 1) * tiles > 132 \
            or splits == -(-t // fp._WGMMA_KEYS)


def test_positions_pass_int32_through_untouched():
    """The launcher's positions and lengths: int32 ones from the caller
    go to the kernel as they are (no torch op: the model makes them once
    a step); missing ones are made int32 (positions q_offset + [0, S),
    lengths T), and int64 ones converted."""
    q, k, _ = (torch.from_numpy(a) for a in _inputs(5, 2, 4, 9, 4, 2, 16))
    qpos = (torch.arange(4, dtype=torch.int32)[None] + 3).repeat(2, 1)
    kv_len = torch.tensor([9, 5], dtype=torch.int32)
    p32, l32 = fp._positions(q, k, qpos, 0, kv_len)
    assert p32.data_ptr() == qpos.data_ptr() and p32.dtype == torch.int32
    assert l32.data_ptr() == kv_len.data_ptr() and l32.dtype == torch.int32
    p, n = fp._positions(q, k, None, 5, None)
    assert p.dtype == n.dtype == torch.int32
    assert p.tolist() == [[5, 6, 7, 8]] * 2 and n.tolist() == [9, 9]
    p, n = fp._positions(q, k, qpos.long(), 0, kv_len.long())
    assert torch.equal(p, qpos) and torch.equal(n, kv_len)
    assert p.dtype == n.dtype == torch.int32


@pytest.mark.parametrize("shape,form", [
    # the SP main path: Qwen3-8B heads, 8192 and 1024 positions a rank
    ((8192, 32, 8, 128), "wgmma"), ((1024, 32, 8, 128), "wgmma"),
    ((64, 4, 4, 128), "wgmma"),  # G = 1, one key tile a rank
    # every other call keeps the mma.sync form
    ((100, 32, 8, 128), "mma"),  # S not a multiple of the 64-key tile
    ((8192, 32, 8, 64), "mma"),  # D = 64
    ((128, 6, 2, 128), "mma"),  # G = 3 does not divide 128
])
def test_sp_plan_routes_by_shape(shape, form):
    """_sp_plan: the TMA + wgmma form for bf16 at D = 128 with a GQA
    group dividing 128 and S a multiple of 64 (a key tile never
    straddles two ranks' segments); the mma.sync form otherwise, and
    always for f32."""
    s, hq, hkv, d = shape
    assert fp._sp_plan(s, hq, hkv, d, torch.bfloat16) == form
    assert fp._sp_plan(s, hq, hkv, d, torch.float32) == "mma"


@pytest.mark.parametrize("n,b,words", [(2, 1, 4), (2, 3, 8), (4, 4, 26),
                                       (8, 2, 30)])
def test_sp_flag_words_and_pool_key(n, b, words):
    """The SP pool: a delivery flag a (tensor, offset 1..n-1, row), then
    the claim and finished-block counters, a rank; one pool a (device,
    stream, n, B), shared by both forms whatever S, the heads and the
    dtype."""
    assert fp._sp_flag_words(n, b) == words == 2 * (n - 1) * b + 2
    a = torch.zeros(n, b, 128, 32, 128, dtype=torch.bfloat16)
    c = torch.zeros(n, b, 100, 4, 64)
    assert fp._sp_pool_key(a, 7) == (torch.device("cpu"), 7, n, b)
    assert fp._sp_pool_key(a, 7) == fp._sp_pool_key(c, 7)
    assert fp._sp_pool_key(a, 7) != fp._sp_pool_key(a, 8)
    assert fp._sp_pool_key(a, 7) != fp._sp_pool_key(
        torch.zeros(n, b + 1, 128, 32, 128), 7)


def test_build_starts_one_compiler_a_library(monkeypatch):
    """_build.build over chip_smoke.py's list (kernels.SOURCES, where one
    library serves several wrappers) starts one nvcc a library: two
    would write the same temporary file and race on its rename."""
    from triton_dist_tpu_torch import kernels
    from triton_dist_tpu_torch.kernels import _build

    started = []
    monkeypatch.setattr(_build, "_start_build",
                        lambda name: started.append(name))
    monkeypatch.setattr(_build, "_lib_path", lambda name: name)
    paths = _build.build(kernels.SOURCES.values())
    assert sorted(started) == sorted(set(kernels.SOURCES.values()))
    assert paths == started

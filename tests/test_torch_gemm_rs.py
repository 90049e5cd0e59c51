"""The pure parts of the port's gemm_rs kernel wrapper
(triton_dist_tpu_torch.kernels.gemm_reduce_scatter): the rule that picks
a call's tile body, the wgmma body's tile width, the persistent pools'
keys, and the straggler option on the CPU route (against the JAX
function at the same delay).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
(marker `cuda`) and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels.gemm_reduce_scatter import (
    GemmRsConfig,
    gemm_rs as jax_gemm_rs,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("case,body", [
    # the main path's form: bf16 in and out, m % 64 == 0, 2 <= n <= 8
    ((4, 128, 1024, 4096, BF, BF, False), "wgmma"),  # prefill O
    ((4, 128, 3072, 4096, BF, BF, False), "wgmma"),  # prefill down
    ((4, 64, 1024, 4096, BF, BF, False), "wgmma"),  # scheduler step O
    ((4, 64, 3072, 4096, BF, BF, False), "wgmma"),  # scheduler step down
    ((4, 128, 1024, 2048, BF, BF, False), "wgmma"),  # Qwen3-30B-A3B O
    ((2, 256, 1000, 1000, BF, BF, False), "wgmma"),  # K, N ragged
    ((8, 64, 64, 64, BF, BF, False), "wgmma"),  # the widest world
    # every other call keeps the mma.sync / FMA body
    ((4, 1, 3072, 4096, BF, BF, False), "mma"),  # a dist decode step
    ((4, 32, 1024, 2048, BF, BF, False), "mma"),  # the fused 4 x 32
    ((4, 96, 1024, 4096, BF, BF, False), "mma"),  # m not a box multiple
    ((4, 128, 1024, 4096, F32, F32, False), "mma"),
    ((4, 128, 1024, 4096, BF, F32, False), "mma"),  # f32 out
    ((4, 128, 1024, 4096, BF, F32, True), "wgmma"),  # the wire's partials
    ((1, 500, 12288, 4096, BF, BF, False), "mma"),  # n = 1, m % 64 != 0
    ((16, 64, 1024, 4096, BF, BF, False), "mma"),  # past the fold's ranks
    ((4, 128, 32, 4096, BF, BF, False), "mma"),  # K under one box
    ((4, 128, 1024, 40, BF, BF, False), "mma"),  # N under one box
    # force_kernel at n = 1 (row 6): the local product on the wgmma body
    ((1, 512, 12288, 4096, BF, BF, False), "wgmma"),
    ((1, 64, 1000, 1000, BF, BF, False), "wgmma"),  # K, N ragged
    # the wire's f32 partials: the wgmma body at the main form's shapes
    ((4, 128, 3072, 4096, BF, F32, True), "wgmma"),  # phase 4w's down
    ((2, 64, 1024, 512, BF, F32, True), "wgmma"),
    ((1, 512, 3072, 4096, BF, F32, True), "wgmma"),  # force_kernel, n = 1
    ((4, 1, 3072, 4096, BF, F32, True), "mma"),  # m = 1
    ((4, 37, 1024, 4096, BF, F32, True), "mma"),  # ragged m
    ((4, 128, 1024, 4096, F32, F32, True), "mma"),  # f32 in
    ((16, 64, 1024, 4096, BF, F32, True), "mma"),  # past 8 ranks
    ((4, 128, 1024, 40, BF, F32, True), "mma"),  # N under one box
])
def test_body_for_routes_the_main_path_to_wgmma(case, body):
    """_body_for: the wgmma body serves bf16 in and out at m a multiple
    of 64 (a prefill's 128 rows a rank, a scheduler step's 64,
    force_kernel's 512 rows at n = 1), K and N at least one 64-wide box,
    1 to 8 ranks, and the wire's f32 partials of bf16 inputs under the
    same shape rule; decode, the fused prefill's 32 rows, f32 in and the
    native fold's f32 out keep the mma.sync / FMA body."""
    n, m, k, nn, dtype, out, partials = case
    assert rs._body_for(n, m, k, nn, dtype, out, partials) == body


@pytest.mark.parametrize("M,N,n,want", [
    (512, 4096, 4, 256),  # prefill O and down: 64 tiles a rank, 2 waves
    (256, 4096, 4, 256),  # scheduler step: 32 tiles, one wave
    (512, 2048, 4, 256),  # Qwen3-30B-A3B O
    (256, 1536, 2, 128),  # one wave at every width: the narrowest
])
def test_wgmma_bn_minds_wave_quantisation(M, N, n, want):
    """_wgmma_bn: of the candidates, the one whose waves over each rank's
    sms // n blocks times a tile's time (its columns plus
    _WGMMA_FIXED_COLS) are the fewest, the widest on a tie; the main
    path's picks pinned."""
    got = rs._wgmma_bn(M, N, n)
    assert got == want
    per = 132 // n

    def cost(bn):
        tiles = -(-M // 128) * -(-N // bn)
        return -(-tiles // per) * (bn + rs._WGMMA_FIXED_COLS)

    assert got in rs._WGMMA_BN and cost(got) == min(
        cost(b) for b in rs._WGMMA_BN)
    assert got == max(b for b in rs._WGMMA_BN if cost(b) == cost(got))


def test_pool_keys_part_every_call_configuration():
    """The persistent slots and counters: one entry a (device, stream, n,
    m, N, input dtype, output dtype, body, tile width); calls that differ
    in any never share one (a bf16-in and an f32-in call with f32 out
    take tiles of different sizes, so counter pools of different sizes,
    gemm_rs_flag_count), and the pools are a _build.PoolCache of its
    size."""
    a = torch.zeros(4, 8, 16, dtype=BF)
    base = rs._pool_key(a, 7, 128, 4096, BF, "wgmma", 256)
    others = [rs._pool_key(a, 8, 128, 4096, BF, "wgmma", 256),
              rs._pool_key(torch.zeros(2, 8, 16, dtype=BF), 7, 128, 4096,
                           BF, "wgmma", 256),
              rs._pool_key(a, 7, 64, 4096, BF, "wgmma", 256),
              rs._pool_key(a, 7, 128, 2048, BF, "wgmma", 256),
              rs._pool_key(a, 7, 128, 4096, F32, "wgmma", 256),
              rs._pool_key(a, 7, 128, 4096, BF, "mma", 0),
              rs._pool_key(a, 7, 128, 4096, BF, "wgmma", 128)]
    assert len({base, *others}) == len(others) + 1
    f32_out = rs._pool_key(a, 7, 128, 4096, F32, "mma", 0)
    assert rs._pool_key(a.float(), 7, 128, 4096, F32, "mma", 0) != f32_out
    assert isinstance(rs._POOLS, _build.PoolCache)
    assert rs._POOLS.size == _build.POOL_ENTRIES


@pytest.mark.parametrize("a_order", ["rank", "arrival"])
def test_straggler_on_the_cpu_route_matches_jax(a_order):
    """straggler=(rank, nanos) (the JAX config's straggler_rank /
    straggler_ns) changes nothing on the CPU route: each delayed rank
    gives the undelayed result, within 1e-5 of the JAX gemm_rs run with
    the same delay (interpret mode, n = 4); a rank outside the world, a
    negative delay, or a delay on the wire form raise."""
    n, M, K, N = 4, 16, 32, 128
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, M, K)).astype(np.float32)
    b = (rng.standard_normal((n, K, N)) * 0.1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = rs.gemm_rs(ta, tb, a_order=a_order)
    for rank in range(n):
        assert torch.equal(rs.gemm_rs(ta, tb, a_order=a_order,
                                      straggler=(rank, 5_000_000)), want)
    cfg = GemmRsConfig(straggler_rank=1, straggler_ns=1000)
    before = pallas_call_count()
    fn = jax.jit(jax.shard_map(
        functools.partial(jax_gemm_rs, axis="tp", config=cfg,
                          a_order=a_order, force_kernel=True),
        mesh=make_mesh(mesh_shape=(n,), axis_names=("tp",)),
        in_specs=(P(None, "tp"), P("tp", None)), out_specs=P("tp"),
        check_vma=False))
    got = np.asarray(fn(jnp.asarray(np.concatenate(list(a), axis=1)),
                        jnp.asarray(b.reshape(n * K, N))))
    assert pallas_call_count() > before, "the JAX kernel did not run"
    np.testing.assert_allclose(got.reshape(n, M // n, N), want.numpy(),
                               rtol=0, atol=1e-5)
    for bad in ((4, 10), (-1, 10), (0, -1)):
        with pytest.raises(ValueError, match="straggler"):
            rs.gemm_rs(ta, tb, straggler=bad)
    with pytest.raises(ValueError, match="straggler"):
        rs.gemm_rs(ta, tb, wire_format="fp8", straggler=(0, 10))


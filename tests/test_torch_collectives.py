"""The port's collective kernels (triton_dist_tpu_torch.kernels:
one_shot_all_reduce, ring_all_gather, gemm_rs, gemm_ar) against the JAX
package's, and the build's header hashing.

On the CPU each wrapper runs its plain version. The JAX functions run
under `jax.shard_map` on a mesh of n in {2, 4} devices cut from the 12
virtual CPU devices, as tests/test_overlap_gemm.py runs them; with the
spare devices the real interpret-mode protocols run. The port's tensors
are rank-stacked: rank r's shard is [r]. Same numpy inputs for both.

Tolerances: AllReduce and AllGather bitwise (the port folds over ranks
0..n-1 with each add rounded to x.dtype, as the JAX body does: bitwise in
f32 and in bf16; a gather moves data only). gemm_rs 1e-5 in f32: the
JAX ring folds the partials in ring order, the port in rank order. The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import gemm_ar as jax_gemm_ar
from triton_dist_tpu.kernels import gemm_rs as jax_gemm_rs
from triton_dist_tpu.kernels.allgather import (
    ring_all_gather as jax_ring_all_gather,
)
from triton_dist_tpu.kernels.allreduce import (
    one_shot_all_reduce as jax_one_shot_all_reduce,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.kernels import (
    _build,
    gemm_ar,
    gemm_rs,
    gemm_rs_plain,
    launches,
    one_shot_all_reduce,
    reset_launches,
    ring_all_gather,
)
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather as ag
from triton_dist_tpu_torch.kernels import allreduce as ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.kernels import reduce_scatter as rsr
from triton_dist_tpu_torch.runtime import VirtualWorld
from triton_dist_tpu_torch.wire import WireFormat

RS_ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mesh(n):
    return make_mesh(mesh_shape=(n,), axis_names=("tp",))


def _jax_stacked(fn, n, *args, in_specs, out_specs=P("tp")):
    """fn per device under shard_map on an n-device mesh; the global
    result as numpy. Asserts that the JAX side ran its Pallas kernel
    (interpret mode), not an XLA-collective fallback."""
    before = pallas_call_count()
    out = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=_mesh(n), in_specs=in_specs, out_specs=out_specs,
        check_vma=False))(*args))
    assert pallas_call_count() > before, "the JAX kernel did not run"
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_one_shot_all_reduce_matches_jax_bitwise(n):
    m, w = 8, 128
    x = _rand(n, n, m, w)
    want = _jax_stacked(functools.partial(jax_one_shot_all_reduce,
                                          axis="tp"), n,
                        x.reshape(n * m, w), in_specs=P("tp"))
    got = one_shot_all_reduce(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().reshape(n * m, w), want)
    assert torch.equal(got, got[:1].expand_as(got))


@pytest.mark.parametrize("n", [2, 4])
def test_one_shot_all_reduce_bf16_matches_jax_bitwise(n):
    """bf16: the JAX body adds into an x.dtype accumulator, one rounding
    an add; the port's fold rounds at the same points."""
    m, w = 8, 128
    x = _rand(20 + n, n, m, w, scale=4.0)
    xb = torch.from_numpy(x).bfloat16()
    want = _jax_stacked(functools.partial(jax_one_shot_all_reduce,
                                          axis="tp"), n,
                        jnp.asarray(xb.float().numpy(), jnp.bfloat16)
                        .reshape(n * m, w), in_specs=P("tp"))
    got = one_shot_all_reduce(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().reshape(n * m, w),
                                  want.astype(np.float32))
    # past one add, the f32 sum rounded once differs: the test sees the
    # fold
    once = xb.float().sum(0).bfloat16()
    assert torch.equal(got[0], once) == (n == 2)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_all_gather_matches_jax_bitwise(n):
    m, w = 8, 128
    x = _rand(10 + n, n, m, w)
    # every rank's gathered copy, stacked: (n * n*m, w)
    want = _jax_stacked(functools.partial(jax_ring_all_gather, axis="tp"),
                        n, x.reshape(n * m, w), in_specs=P("tp"))
    got = ring_all_gather(torch.from_numpy(x))
    assert got.shape == (n, n * m, w)
    np.testing.assert_array_equal(got.numpy().reshape(n * n * m, w), want)


def _jax_gemm_rs(a, b, n):
    """a (n, M, K), b (n, K, N) rank-stacked -> JAX gemm_rs (n, M/n, N)."""
    _, m, k = a.shape
    a_cat = np.concatenate(list(a), axis=1)  # (M, n*K): rank r's K block
    b_cat = b.reshape(n * k, -1)
    out = _jax_stacked(functools.partial(jax_gemm_rs, axis="tp"), n, a_cat,
                       b_cat, in_specs=(P(None, "tp"), P("tp", None)))
    return out.reshape(n, m // n, -1)


@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_matches_jax(n):
    """The fold order differs (JAX: ring order; port: ranks 0..n-1), so
    agreement is to f32 rounding, 1e-5."""
    m, k, w = 16, 32, 128
    a, b = _rand(20 + n, n, m, k), _rand(30 + n, n, k, w, scale=0.1)
    want = _jax_gemm_rs(a, b, n)
    got = gemm_rs(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (n, m // n, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RS_ATOL)
    dense = np.einsum("rmk,rkn->mn", a.astype(np.float64), b)
    np.testing.assert_allclose(got.numpy().reshape(m, w), dense, atol=1e-5)


@pytest.mark.parametrize("m", [8, 264], ids=["one_shot_ar", "gemm_rs_ag"])
def test_gemm_ar_matches_jax_in_both_regimes(m):
    """M <= 256: local product + one-shot AR; M > 256 (divisible by n):
    gemm_rs + ring AG. n = 4."""
    n, k, w = 4, 16, 128
    a, b = _rand(m, n, m, k), _rand(m + 1, n, k, w, scale=0.1)
    a_cat = np.concatenate(list(a), axis=1)
    want = _jax_stacked(functools.partial(jax_gemm_ar, axis="tp"), n, a_cat,
                        b.reshape(n * k, w),
                        in_specs=(P(None, "tp"), P("tp", None)),
                        out_specs=P())
    got = gemm_ar(torch.from_numpy(a), torch.from_numpy(b),
                  VirtualWorld(n, "cpu"))
    assert got.shape == (n, m, w)
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0,
                                   atol=RS_ATOL)


def test_gemm_ar_world_one_is_the_local_product():
    a, b = _rand(1, 1, 5, 16), _rand(2, 1, 16, 24)
    got = gemm_ar(torch.from_numpy(a), torch.from_numpy(b),
                  VirtualWorld(1, "cpu"))
    assert torch.equal(got, torch.from_numpy(a) @ torch.from_numpy(b))


def test_gemm_rs_world_one():
    """n = 1: the local product; force_kernel takes the kernel's path,
    whose plain version on the CPU is the same product (one rank, one
    chunk)."""
    a, b = (torch.from_numpy(_rand(3, 1, 6, 16)),
            torch.from_numpy(_rand(4, 1, 16, 8)))
    local = gemm_rs(a, b)
    forced = gemm_rs(a, b, force_kernel=True)
    assert torch.equal(local, a @ b)
    torch.testing.assert_close(forced, local, rtol=0, atol=1e-6)


def test_gemm_rs_options_not_ported_raise():
    a, b = torch.zeros(2, 4, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="a_order"):
        gemm_rs(a, b, a_order="ring")
    with pytest.raises(ValueError, match="does not divide"):
        gemm_rs(a, b, wire_format=WireFormat("fp8", 3))
    assert torch.equal(gemm_rs(a, b, out_dtype=torch.bfloat16),
                       gemm_rs_plain(a, b, out_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="divisible"):
        gemm_rs(torch.zeros(2, 3, 8), b)


def test_plain_versions_fold_in_rank_order():
    """bf16 inputs: the sum is taken in rank order with each add rounded
    to bf16 (the JAX body's x.dtype accumulator), so every rank's copy
    has the same bits; gemm_rs rounds each partial to bf16 first, as its
    heap slots hold them."""
    x = torch.from_numpy(_rand(5, 4, 3, 16)).bfloat16()
    got = one_shot_all_reduce(x)
    want = x[0]
    for r in range(1, 4):
        want = (want.float() + x[r].float()).bfloat16()
    assert all(torch.equal(got[r], want) for r in range(4))
    a = torch.from_numpy(_rand(6, 2, 4, 16)).bfloat16()
    b = torch.from_numpy(_rand(7, 2, 16, 8)).bfloat16()
    part = [(a[r].float() @ b[r].float()).bfloat16() for r in range(2)]
    want = torch.stack([(part[0][2 * c:2 * c + 2].float()
                         + part[1][2 * c:2 * c + 2].float()).bfloat16()
                        for c in range(2)])
    assert torch.equal(gemm_rs_plain(a, b), want)


def test_cpu_wrappers_count_no_launch_and_launchers_refuse_cpu():
    """On a CPU tensor every wrapper takes its plain version and counts
    nothing; the launchers raise rather than give way to it."""
    reset_launches()
    x = torch.ones(2, 4, 8)
    one_shot_all_reduce(x)
    ring_all_gather(x)
    gemm_rs(x, torch.ones(2, 8, 8))
    assert set(launches().values()) == {0}
    for launch, args in ((ar._launch, (x,)), (ag._launch, (x,)),
                         (rs._launch, (x, torch.ones(2, 8, 8)))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(*args)
    assert set(launches().values()) == {0}


def test_virtual_world_heap_and_flags():
    w = VirtualWorld(4, "cpu")
    assert w.heap((3, 5), torch.bfloat16).shape == (4, 3, 5)
    f = w.flags(7)
    assert f.shape == (4, 7) and f.dtype == torch.int32 and not f.any()
    assert VirtualWorld.of(torch.zeros(2, 3)).n == 2
    with pytest.raises(ValueError):
        VirtualWorld(0, "cpu")


def test_library_name_hashes_every_header(tmp_path, monkeypatch):
    """A kernel's library is named by its .cu and every csrc/*.cuh: an
    edited shared header gives a new name (a rebuild), not a stale
    library."""
    (tmp_path / "k.cu").write_text('#include "shmem.cuh"\n')
    (tmp_path / "shmem.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (tmp_path / "shmem.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    (tmp_path / "other.cuh").write_text("// v2\n")
    third = _build._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "shmem.cuh"\n// edit\n')
    assert len({first, second, third, _build._lib_path("k")}) == 4


# chunks (elements a rank) of the native ring: the Qwen3-30B-A3B path's
# prefill, scheduler step, fused prefill and one decode row (rows of
# 2048); the collective library's (512 | 128 | 4, 4096) bf16 and (64,
# 4096) f32 shards over 4 ranks; the card tests' chunks; one element;
# a prime width
_RING_CHUNKS = [(128 * 2048, 2), (64 * 2048, 2), (32 * 2048, 2), (2048, 2),
                (128 * 4096, 2), (32 * 4096, 2), (4096, 2), (16 * 4096, 4),
                (40 * 1000, 2), (37 * 4096, 2), (3, 4), (1, 2), (1009, 4)]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("chunk,itemsize", _RING_CHUNKS)
@pytest.mark.parametrize("sms", [132, 114])
def test_ring_plan_covers_the_chunk_within_residency(n, chunk, itemsize,
                                                     sms):
    """The native ring's tiles: every element in exactly one tile, each
    tile a whole number of 16-byte words (so tiles start aligned where the
    chunk does), a thread's share of the slot within its register budget,
    and the tiles of all n ranks resident at once (_RING_PER_SM blocks an
    SM of `sms`)."""
    tile, tiles = rsr._ring_plan(chunk, itemsize, n, sms)
    assert tile in rsr._TILES and tile * itemsize % 16 == 0
    assert (tiles - 1) * tile < chunk <= tiles * tile
    cover = torch.zeros(tiles * tile, dtype=torch.int32)
    for t in range(tiles):
        cover[t * tile:(t + 1) * tile] += 1
    assert bool((cover[:chunk] == 1).all())
    assert tile // rsr._TILES[0] * 8 * itemsize <= rsr._THREAD_SHARE
    assert tiles * n <= rsr._RING_PER_SM * sms
    if tile > rsr._TILE:  # grown only because the smaller did not fit
        assert -(-chunk // (tile // 2)) * n > rsr._RING_PER_SM * sms


def test_ring_plan_forced_tiles():
    """The sweep's forced tiles: any of _TILES within a thread's share,
    nothing else."""
    assert rsr._ring_plan(128 * 2048, 2, 4, tile=8192) == (8192, 32)
    assert rsr._ring_plan(3, 4, 2, tile=4096) == (4096, 1)
    for tile, itemsize in ((8192, 4), (1024, 2), (3000, 2)):
        with pytest.raises(ValueError, match="tile"):
            rsr._ring_plan(4096, itemsize, 2, tile=tile)


def test_ring_pool_cache_keys_and_evicts_least_recently_used():
    """The persistent slots and flags: one entry a (kernel, device,
    stream, n, size, dtype, tiles), made once and then handed back; two
    streams, worlds, sizes, dtypes, tile counts or kernels never share
    one; past `size` entries the least recently used goes. Buffers
    stubbed by CPU tensors."""
    x = torch.zeros(4, 8)
    key = functools.partial(rsr._pool_key, "ring_reduce_scatter", x)
    base = key(7, 16, torch.bfloat16, 1)
    others = [key(8, 16, torch.bfloat16, 1), key(7, 32, torch.bfloat16, 1),
              key(7, 16, torch.float32, 1), key(7, 16, torch.bfloat16, 2),
              rsr._pool_key("ring_rs_wire", x, 7, 16, torch.bfloat16, 1),
              rsr._pool_key("ring_reduce_scatter", torch.zeros(2, 8), 7, 16,
                            torch.bfloat16, 1)]
    assert len({base, *others}) == len(others) + 1
    cache = _build.PoolCache(size=3)
    made = []

    def make(tag):
        def fn():
            made.append(tag)
            return torch.empty(4, 2, 16), torch.zeros(4, 3, dtype=torch.int32)
        return fn

    first = cache.get(base, make("a"))
    assert cache.get(base, make("again")) is first and made == ["a"]
    for tag, k in zip("bcd", others):
        cache.get(k, make(tag))
    # a was the least recently used: d evicted it
    assert list(cache.entries) == others[:3] and cache.made == 4
    cache.get(others[0], make("b again"))  # b is now the most recent
    cache.get(base, make("a again"))  # made anew; c goes
    assert list(cache.entries) == [others[2], others[0], base]
    assert made == ["a", "b", "c", "d", "a again"] and cache.made == 5
    assert rsr._POOLS.size == 8



# elements a rank of the one-shot AllReduce: a decode step's and a
# scheduler step's (4 | 256, 4096), the library's 256 KiB cap in bf16 and
# f32, the card tests' ragged sizes, one element
_AR_SIZES = [(4 * 4096, 2), (256 * 4096, 2), (128 * 1024, 2), (64 * 1024, 4),
             (256 * 4096, 4), (33 * 264, 2), (5 * 7, 4), (3 * 1000, 2),
             (1, 2), (4096 * 4096, 2)]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("e,itemsize", _AR_SIZES)
@pytest.mark.parametrize("sms", [132, 114])
def test_ar_plan_tiles_cover_within_residency(n, e, itemsize, sms):
    """The one-shot AllReduce's plan: every element in exactly one tile,
    each tile a power of two of 16-byte units within a thread block's
    register share, one block a tile up to the resident blocks a rank
    (the grid co-resident: _AR_PER_SM an SM over n ranks), the tile
    grown past the default only while the tiles did not fit, and a flag
    a tile plus an entry barrier a block."""
    tile, blocks, flags = ar._ar_plan(e, n, itemsize, sms)
    units = tile * itemsize // 16
    assert tile in ar._AR_TILES and tile * itemsize % 16 == 0
    assert units & (units - 1) == 0
    assert tile * itemsize <= ar._AR_TILE_BYTES
    tiles = -(-e // tile)
    assert (tiles - 1) * tile < e <= tiles * tile
    cap = ar._AR_PER_SM * sms // n
    assert 1 <= blocks <= min(tiles, cap) and n * blocks <= ar._AR_PER_SM * sms
    assert blocks == min(tiles, cap)
    assert flags == tiles + blocks
    if tile > ar._AR_TILE:  # grown only because the smaller did not fit
        assert -(-e // (tile // 2)) > cap


def test_ar_plan_main_path_shapes_and_forced_tiles():
    """The picks the sweep chose (tools/profile_allreduce.py): a decode
    step's (4, 4, 4096) bf16 in 2048-element tiles, one block each (8 a
    rank); a scheduler step's (4, 256, 4096) in 8192, 128 blocks a rank,
    all resident on 132 SMs. Forced tiles: any of _AR_TILES within the
    register share, nothing else."""
    assert ar._ar_plan(4 * 4096, 4, 2) == (2048, 8, 16)
    assert ar._ar_plan(256 * 4096, 4, 2) == (8192, 128, 256)
    assert ar._ar_plan(256 * 4096, 4, 2, tile=256) == (256, 132, 4096 + 132)
    assert ar._ar_plan(35, 2, 4, tile=4096) == (4096, 1, 2)
    for tile, itemsize in ((8192, 4), (128, 2), (3000, 2)):
        with pytest.raises(ValueError, match="tile"):
            ar._ar_plan(4096, 2, itemsize, tile=tile)


def test_ar_pool_cache_keys_and_evicts_least_recently_used():
    """The AllReduce's persistent workspace and flags: its own cache
    (not the rings'), at most _build.POOL_ENTRIES entries, one
    a (device, stream, n, E, dtype, tile, blocks); two streams, worlds,
    sizes, dtypes or plans never share one; past the size the least
    recently used goes. Buffers stubbed by CPU tensors."""
    assert ar._POOLS is not rsr._POOLS
    assert ar._POOLS.size == _build.POOL_ENTRIES
    x = torch.zeros(4, 4, 16, dtype=torch.bfloat16)
    base = ar._ar_pool_key(x, 7, 2048, 8)
    others = [ar._ar_pool_key(x, 8, 2048, 8),
              ar._ar_pool_key(x, 7, 1024, 8),
              ar._ar_pool_key(x, 7, 2048, 4),
              ar._ar_pool_key(x.float(), 7, 2048, 8),
              ar._ar_pool_key(torch.zeros(2, 8, 16), 7, 2048, 8),
              ar._ar_pool_key(torch.zeros(4, 4, 17), 7, 2048, 8)]
    assert len({base, *others}) == len(others) + 1
    cache = _build.PoolCache(size=2)
    made = []

    def make(tag):
        def fn():
            made.append(tag)
            return torch.empty(4, 4, 64), torch.zeros(4, 16, dtype=torch.int32)
        return fn

    first = cache.get(base, make("a"))
    assert cache.get(base, make("again")) is first and cache.made == 1
    cache.get(others[0], make("b"))
    cache.get(others[1], make("c"))  # a, the least recently used, goes
    assert list(cache.entries) == others[:2] and made == ["a", "b", "c"]
    cache.get(base, make("a again"))
    assert cache.made == 4 and list(cache.entries) == [others[1], base]

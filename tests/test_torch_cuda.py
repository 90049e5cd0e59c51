"""The port's CUDA kernels against their plain versions, on the card.

    python -m pytest -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA card and nvcc (the kernels build at first
use) and skips without one. The file imports torch, the port and the
numpy-only epsilon-band oracle (tests/torch_parity.py): every bf16 case
is also judged by its family's band (`band`), on top of its own
tolerance, and prints the report (`-s` shows it).
"""

import numpy as np
import pytest
import torch
import torch_parity

from triton_dist_tpu_torch.kernels import (
    ag_gemm,
    ag_gemm_plain,
    flash_prefill_local,
    flash_prefill_plain,
    gemm_rs,
    gemm_rs_plain,
    launches,
    one_shot_all_reduce,
    one_shot_all_reduce_plain,
    reset_launches,
    ring_all_gather,
    ring_all_gather_plain,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)
from triton_dist_tpu_torch.kernels import flash_decode as fd
from triton_dist_tpu_torch.kernels import flash_prefill as fp
from triton_dist_tpu_torch.kernels import grouped_gemm as gg
from triton_dist_tpu_torch.kernels import low_latency_allgather as llag


def _inputs(seed, b, s, t, hq, hkv, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


def band(want, got, kernel):
    """The epsilon band of `kernel` at want's dtype (bf16: 8 bf16 quanta
    of each element above 2^-12 of the largest), on top of a case's own
    tolerance; prints the report."""
    rep = torch_parity.check_epsilon(want.detach().float().cpu().numpy(),
                                     got.detach().float().cpu().numpy(),
                                     kernel, want.dtype)
    print(f"band {kernel} {rep['dtype']} {tuple(want.shape)}: "
          f"cos={rep['cos']:.3e} ulp={rep['ulp']} "
          f"(band {rep['band_cos']:.0e}, {rep['band_ulp']})")
    assert rep["ok"], f"outside the epsilon band: {rep}"
    return rep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_prefill_kernel_matches_plain(cuda, dtype, atol):
    """GQA G=4, kv_len mid-tile / empty / full, offset positions, T not
    a multiple of the tile, causal and not. bf16 atol 2e-2: the output
    is rounded to bf16 (8 bits of mantissa) in both, and the kernel
    rounds P to bf16 for the P.V product."""
    reset_launches()
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _inputs(4, 3, 16, 70, 8, 2, 128))
    kv_len = torch.tensor([37, 0, 70], device="cuda")
    qpos = (torch.arange(16, device="cuda")[None] + 7).expand(3, 16)
    for causal in (True, False):
        got = flash_prefill_local(q, k, v, q_positions=qpos.contiguous(),
                                  kv_len=kv_len, causal=causal)
        want = flash_prefill_plain(q, k, v, q_positions=qpos,
                                   kv_len=kv_len, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
        if dtype == torch.bfloat16:
            band(want, got, "flash_prefill")
        assert torch.all(got[1] == 0)
    assert launches()["flash_prefill_local"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collective_kernels_match_plain(cuda, n, dtype):
    """The virtual-world kernels against their plain versions: AllReduce
    and AllGather bitwise (every rank's AR copy alike), gemm_rs within
    one ulp of the output dtype on every rounded partial and on the
    output (f32: 1e-5 relative). Ragged sizes, not tile multiples."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 33, 264))).to("cuda",
                                                                dtype)
    a = torch.from_numpy(rng.standard_normal((n, 20 * n, 136))).to("cuda",
                                                                   dtype)
    b = (torch.from_numpy(rng.standard_normal((n, 136, 200))) * 0.05).to(
        "cuda", dtype)
    reset_launches()
    got = one_shot_all_reduce(x)
    assert torch.equal(got, one_shot_all_reduce_plain(x))
    assert torch.equal(got, got[:1].expand_as(got))
    # the JAX body's fold: ranks 0..n-1 in order, each add rounded to
    # x.dtype (torch adds bf16 in f32 and rounds, as XLA does)
    jax_order = x[0]
    for r in range(1, n):
        jax_order = jax_order + x[r]
    assert torch.equal(got, jax_order.expand_as(got))
    if dtype == torch.bfloat16:
        band(jax_order.expand_as(got), got, "one_shot_all_reduce")
    assert torch.equal(ring_all_gather(x), ring_all_gather_plain(x))
    got = gemm_rs(a, b)
    want = gemm_rs_plain(a, b)
    torch.cuda.synchronize()
    part = torch.matmul(a.float(), b.float()).abs().max().item()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    atol = ulp * (n * part + want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if dtype == torch.bfloat16:
        band(want, got, "gemm_rs")
    counts = launches()
    assert [counts[k] for k in ("one_shot_all_reduce", "ring_all_gather",
                                "gemm_rs")] == [1, 1, 1]


@pytest.mark.cuda
def test_gemm_rs_kernel_at_world_one(cuda):
    """force_kernel at n = 1: the same kernel with one rank (the JAX
    _local_mm_kernel's place), M = 1."""
    a = torch.ones((1, 1, 64), device="cuda", dtype=torch.bfloat16)
    b = torch.full((1, 64, 64), 0.5, device="cuda", dtype=torch.bfloat16)
    reset_launches()
    got = gemm_rs(a, b, force_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full_like(got, 32.0))
    band(torch.full_like(got, 32.0), got, "gemm_rs")
    assert launches()["gemm_rs"] == 1


def _ag_gemm_atol(a, bs, want):
    """Kernel and plain both accumulate in f32 and round once; the f32
    sums run in another order. bf16: one ulp (2^-7 relative) of the
    largest output, plus the f32 term; f32: 1e-5 relative to the
    products (for silu_pair, to gate times up)."""
    full = a.reshape(-1, a.shape[-1]).float()
    prods = [torch.matmul(full, w.float()).abs().max().item() for w in bs]
    scale = max(1.0, prods[0]) * (max(1.0, prods[1]) if len(bs) == 2 else 1)
    ulp = 2.0 ** -7 * want.float().abs().max().item()
    return (ulp if a.dtype == torch.bfloat16 else 0.0) + 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ag_gemm_kernel_matches_plain(cuda, n, dtype):
    """The fused AG+GEMM against its plain version: both C orders, plain
    and silu_pair, return_gathered (bitwise), m = 1 and a ragged m,
    N not a multiple of the tile; n = 1 with force_kernel."""
    rng = np.random.default_rng(10 + n)
    reset_launches()
    calls = 0
    for m, N in ((1, 200), (37, 136), (128, 264)):
        a = torch.from_numpy(rng.standard_normal((n, m, 128))).to(
            "cuda", dtype)
        bs = tuple((torch.from_numpy(rng.standard_normal((n, 128, N)))
                    * 0.1).to("cuda", dtype) for _ in range(2))
        for epilogue, b in ((None, bs[0]), ("silu_pair", bs)):
            for c_order in ("rank", "arrival"):
                got = ag_gemm(a, b, epilogue=epilogue, c_order=c_order,
                              force_kernel=True)
                want = ag_gemm_plain(a, b, epilogue, c_order)
                calls += 1
                torch.cuda.synchronize()
                atol = _ag_gemm_atol(a, bs[:1 + (epilogue is not None)], want)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
                if dtype == torch.bfloat16:
                    band(want, got, "ag_gemm")
        c, full = ag_gemm(a, bs[0], return_gathered=True, force_kernel=True)
        calls += 1
        assert torch.equal(full, ag_gemm_plain(a, bs[0],
                                               return_gathered=True)[1])
    assert launches()["ag_gemm"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_arrival_kernel_matches_plain(cuda, n):
    """A in ring-arrival order (as ag_gemm leaves the MLP's act): the
    kernel remaps the source block, within the gemm_rs atol; n = 4 tells
    a wrong slot that n = 2's self-inverse permutation hides."""
    rng = np.random.default_rng(20 + n)
    a = torch.from_numpy(rng.standard_normal((n, 24 * n, 136))).to(
        "cuda", torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal((n, 136, 200))) * 0.05).to(
        "cuda", torch.bfloat16)
    got = gemm_rs(a, b, a_order="arrival")
    want = gemm_rs_plain(a, b, "arrival")
    torch.cuda.synchronize()
    part = torch.matmul(a.float(), b.float()).abs().max().item()
    atol = 2.0 ** -7 * (n * part + want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    band(want, got, "gemm_rs")
    assert not torch.equal(want, gemm_rs_plain(a, b))


# (M, N) a rank of the one-shot AllReduce card checks: E ragged (not a
# multiple of 16 bytes), under one tile, a ragged multi-tile size, and a
# decode step's and a scheduler step's Qwen3-8B shapes
_AR_SHAPES = ((5, 7), (1, 100), (33, 263), (4, 4096), (256, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_shot_all_reduce_every_tile_bitwise(cuda, n, dtype):
    """The one-shot AllReduce against its plain version, bitwise (the JAX
    body's rank-order fold, each add rounded to x.dtype), every rank's
    copy alike: the plan's tile and every tile of the sweep forced
    (allreduce._launch(x, tile)), on ragged sizes, one under a tile and
    the main path's (4, 4096) and (256, 4096)."""
    from triton_dist_tpu_torch.kernels import allreduce as ar

    rng = np.random.default_rng(90 + n)
    tiles = [None] + [t for t in ar._AR_TILES
                      if t * dtype.itemsize <= ar._AR_TILE_BYTES]
    for m, w in _AR_SHAPES:
        x = torch.from_numpy(rng.standard_normal((n, m, w))).to("cuda",
                                                                dtype)
        want = one_shot_all_reduce_plain(x)
        for tile in tiles:
            got = ar._launch(x, tile)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, w, tile)
            assert torch.equal(got, got[:1].expand_as(got))
        if dtype == torch.bfloat16 and m == 256:
            band(want, got, "one_shot_all_reduce")


def _ar_pools_at_zero():
    from triton_dist_tpu_torch.kernels import allreduce as ar

    return all(not bool(flags.any()) for _, flags in ar._POOLS.entries.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_one_shot_all_reduce_back_to_back_leaves_pool_at_zero(cuda, n):
    """50 calls on one stream, alternating a decode step's and a
    scheduler step's shape and f32 / bf16, each bitwise its plain
    version: every launch finds its persistent flags at zero, which the
    previous one left there (each wait subtracts what it waited for).
    After them the pools read all zeros, and no call past the first of
    each configuration made a pool: a warm call allocates only its
    output."""
    from triton_dist_tpu_torch.kernels import allreduce as ar

    rng = np.random.default_rng(95 + n)
    xs = [torch.from_numpy(rng.standard_normal((n, m, 4096))).to("cuda", dt)
          for m in (4, 256) for dt in (torch.bfloat16, torch.float32)]
    wants = [one_shot_all_reduce_plain(x) for x in xs]
    made = None
    for i in range(50):
        got = one_shot_all_reduce(xs[i % 4])
        torch.cuda.synchronize()
        assert torch.equal(got, wants[i % 4]), i
        if i == 3:
            made = ar._POOLS.made
    assert ar._POOLS.made == made
    assert _ar_pools_at_zero()


# (m, K, N) of the wgmma body's card checks: a scheduler step's 64 rows a
# rank, a prefill's 128, and 256; Qwen3-8B QKV and gate|up widths, an N
# that no tile width divides, a K that is not a multiple of 64
_WGMMA_CASES = ((4096, 1536), (4096, 3072), (4096, 1000), (1000, 1536))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_ag_gemm_wgmma_body_matches_plain(cuda, n, m):
    """The TMA + wgmma body (the dense bf16 form at m % 64 == 0) against
    ag_gemm_plain within _ag_gemm_atol and the epsilon band: K 4096 and
    1000, N 1536, 3072 and 1000, both C orders, plain and silu_pair,
    bf16 and f32 out, and return_gathered (the gathered A bitwise); every
    launch took the wgmma body."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as ag

    rng = np.random.default_rng(100 + n + m)
    before = dict(ag.launches_by_body)
    calls = 0
    for k, nn in _WGMMA_CASES:
        a = torch.from_numpy(rng.standard_normal((n, m, k))).to(
            "cuda", torch.bfloat16)
        bs = tuple((torch.from_numpy(rng.standard_normal((n, k, nn)))
                    * 0.02).to("cuda", torch.bfloat16) for _ in range(2))
        for epilogue, b in ((None, bs[0]), ("silu_pair", bs)):
            for c_order in ("rank", "arrival"):
                for out in (torch.bfloat16, torch.float32):
                    got = ag_gemm(a, b, epilogue=epilogue, c_order=c_order,
                                  out_dtype=out)
                    want = ag_gemm_plain(a, b, epilogue, c_order,
                                         out_dtype=out)
                    calls += 1
                    torch.cuda.synchronize()
                    atol = _ag_gemm_atol(a, bs[:1 + (epilogue is not None)],
                                         want)
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=0, atol=atol)
                    if out == torch.bfloat16:
                        band(want, got, "ag_gemm")
        c, full = ag_gemm(a, bs[0], return_gathered=True)
        calls += 1
        assert torch.equal(full, ag_gemm_plain(a, bs[0],
                                               return_gathered=True)[1])
    assert ag.launches_by_body["wgmma"] - before["wgmma"] == calls
    assert ag.launches_by_body["mma"] == before["mma"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ag_gemm_delayed_rank_matches_plain(cuda, n):
    """Each rank in turn stalls 5 ms at its ring producers' entry
    (straggler, the JAX config's straggler_rank / straggler_ns): the
    other ranks' TMA loads of its chunks wait on the arrival counters and
    the async-proxy fence, so every result stays within the atol and the
    band of the plain version, QKV (rank order) and gate|up (silu_pair,
    arrival order) on the wgmma body, and a ragged m on the mma.sync
    body."""
    rng = np.random.default_rng(110 + n)
    for m, k, nn in ((128, 4096, 1536), (37, 512, 264)):
        a = torch.from_numpy(rng.standard_normal((n, m, k))).to(
            "cuda", torch.bfloat16)
        bs = tuple((torch.from_numpy(rng.standard_normal((n, k, nn)))
                    * 0.02).to("cuda", torch.bfloat16) for _ in range(2))
        for epilogue, b, c_order in ((None, bs[0], "rank"),
                                     ("silu_pair", bs, "arrival")):
            want = ag_gemm_plain(a, b, epilogue, c_order)
            atol = _ag_gemm_atol(a, bs[:1 + (epilogue is not None)], want)
            for rank in range(n):
                got = ag_gemm(a, b, epilogue=epilogue, c_order=c_order,
                              straggler=(rank, 5_000_000))
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
                band(want, got, "ag_gemm")


def _gemm_rs_atol(a, b, want):
    """Kernel and plain both round each rank's partial to bf16 and fold in
    rank order in f32; their f32 products differ in the order of the K
    sums: one bf16 ulp of every partial and of the output."""
    part = torch.matmul(a.float(), b.float()).abs().max().item()
    return 2.0 ** -7 * (a.shape[0] * part + want.float().abs().max().item())


def _band_cos(want, got, kernel):
    """The band's cosine; the ulp leg is reported, not held: each rank's
    partial is rounded to bf16 before the f32 fold, so one ulp of a
    partial is many ulps of an output that cancels (gemm_rs's mma.sync
    body shows the same ulp at these shapes)."""
    rep = torch_parity.check_epsilon(want.float().cpu().numpy(),
                                     got.float().cpu().numpy(), kernel,
                                     want.dtype)
    print(f"band {kernel} (cosine held) {tuple(want.shape)}: "
          f"cos={rep['cos']:.3e} ulp={rep['ulp']}")
    assert rep["cos"] <= rep["band_cos"], rep


# (K, N) of the gemm_rs wgmma body's card checks: Qwen3-8B's O and down
# projections a rank, Qwen3-30B-A3B's O, a K and an N that no tile divides
_RS_WGMMA_CASES = ((1024, 4096), (3072, 4096), (1024, 2048), (1000, 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_gemm_rs_wgmma_body_matches_plain(cuda, n, m):
    """The TMA + wgmma body (bf16 in and out at m % 64 == 0) against
    gemm_rs_plain within _gemm_rs_atol and the band's cosine: both A
    orders, every tile width forced; every launch took the wgmma body,
    and a forced mma.sync body still agrees."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs

    rng = np.random.default_rng(200 + n + m)
    before = dict(rs.launches_by_body)
    calls = 0
    for k, nn in _RS_WGMMA_CASES:
        a = torch.from_numpy(rng.standard_normal((n, n * m, k))).to(
            "cuda", torch.bfloat16)
        b = (torch.from_numpy(rng.standard_normal((n, k, nn))) * 0.02).to(
            "cuda", torch.bfloat16)
        for a_order in ("rank", "arrival"):
            want = gemm_rs_plain(a, b, a_order)
            atol = _gemm_rs_atol(a, b, want)
            for bn in (None, *rs._WGMMA_BN):
                got = rs._launch(a, b, a_order == "arrival", bn=bn)
                calls += 1
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
                _band_cos(want, got, "gemm_rs")
            got = rs._launch(a, b, a_order == "arrival", body="mma")
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)
    assert rs.launches_by_body["wgmma"] - before["wgmma"] == calls
    assert rs.launches_by_body["mma"] - before["mma"] == 2 * len(
        _RS_WGMMA_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_delayed_rank_matches_plain(cuda, n):
    """Each rank in turn stalls 5 ms on entry (straggler, the JAX config's
    straggler_rank / straggler_ns): the owners' folds wait on its partials,
    so every result stays within the atol and the band's cosine of the
    plain version, O (rank order) and down (arrival order) on the wgmma
    body, and a ragged m on the mma.sync body."""
    rng = np.random.default_rng(210 + n)
    for m, k, a_order in ((128, 1024, "rank"), (128, 3072, "arrival"),
                          (24, 136, "arrival")):
        a = torch.from_numpy(rng.standard_normal((n, n * m, k))).to(
            "cuda", torch.bfloat16)
        b = (torch.from_numpy(rng.standard_normal((n, k, 4096))) * 0.02).to(
            "cuda", torch.bfloat16)
        want = gemm_rs_plain(a, b, a_order)
        atol = _gemm_rs_atol(a, b, want)
        for rank in range(n):
            got = gemm_rs(a, b, a_order=a_order, straggler=(rank, 5_000_000))
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)
            _band_cos(want, got, "gemm_rs")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_back_to_back_leaves_counters_at_zero(cuda, n):
    """50 calls back to back on each body: every counter of the persistent
    pools reads zero after them, each result equals the first, and a warm
    call makes no pool (no memset, no allocation but its output)."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs

    rng = np.random.default_rng(220 + n)
    for m in (64, 24):  # the wgmma body, then the mma.sync body
        a = torch.from_numpy(rng.standard_normal((n, n * m, 1024))).to(
            "cuda", torch.bfloat16)
        b = (torch.from_numpy(rng.standard_normal((n, 1024, 4096)))
             * 0.02).to("cuda", torch.bfloat16)
        first = gemm_rs(a, b)
        made = rs._POOLS.made
        for _ in range(50):
            got = gemm_rs(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, first)
        assert rs._POOLS.made == made
        assert all(int(f.count_nonzero()) == 0
                   for _, f in rs._POOLS.entries.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_bf16_and_f32_inputs_keep_their_own_pools(cuda, n):
    """bf16 in with f32 out, then f32 in with f32 out, at one shape on one
    stream, each twice: the mma body's tiles (so its counters) differ by
    input dtype (128 x 128 bf16, 64 x 64 f32), so each call takes a pool
    of its own, sized by gemm_rs_flag_count for its input dtype; every
    result is within 1e-5 relative of the plain version and every counter
    reads zero after."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs

    m, k, nn = 128, 256, 1024
    rng = np.random.default_rng(230 + n)
    a16 = torch.from_numpy(rng.standard_normal((n, n * m, k))).to(
        "cuda", torch.bfloat16)
    b16 = (torch.from_numpy(rng.standard_normal((n, k, nn))) * 0.05).to(
        "cuda", torch.bfloat16)
    lib = _build.load("gemm_reduce_scatter", rs._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        for a, b in ((a16, b16), (a16.float(), b16.float())):
            got = gemm_rs(a, b, out_dtype=torch.float32)
            want = gemm_rs_plain(a, b, out_dtype=torch.float32)
            torch.cuda.synchronize()
            part = torch.matmul(a.float(), b.float()).abs().max().item()
            atol = 1e-5 * (n * part + want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=0, atol=atol)
            key = rs._pool_key(a, stream, m, nn, torch.float32, "mma", 0)
            _, flags = rs._POOLS.entries[key]
            assert flags.shape == (n, lib.gemm_rs_flag_count(
                m, nn, rs._DTYPE_CODE[a.dtype], 0))
    sizes = {rs._POOLS.entries[rs._pool_key(
        a, stream, m, nn, torch.float32, "mma", 0)][1].shape[1]
        for a in (a16, a16.float())}
    assert len(sizes) == 2
    assert all(int(f.count_nonzero()) == 0
               for _, f in rs._POOLS.entries.values())


# the local flash kernel's main-path shapes (label, B, S, T, Hq, Hkv,
# query starts): Qwen3-8B's world-1 serve step and engine prefill, the
# world-4 recorded scheduler step's rank rows, a long prefill cut to 1024
_FP_SHAPES = [("serve step", 4, 64, 1024, 32, 8, [960, 600, 200, 0]),
              ("engine prefill", 4, 128, 1024, 32, 8, [0, 0, 0, 0]),
              ("recorded step", 16, 64, 1024, 8, 2,
               [114, 311, 193, 262] * 4),
              ("long prefill", 1, 1024, 1024, 32, 8, [0]),
              ("G=1 ragged", 2, 33, 95, 3, 3, [50, 0])]


def _fp_case(seed, b, s, t, hq, hkv, starts):
    q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
               for x in _inputs(seed, b, s, t, hq, hkv, 128))
    st = torch.tensor(starts, device="cuda", dtype=torch.int32)
    qpos = (st[:, None] + torch.arange(s, device="cuda",
                                       dtype=torch.int32)).contiguous()
    return q, k, v, qpos, (st + s).clamp(max=t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FP_SHAPES, ids=[c[0] for c in _FP_SHAPES])
def test_flash_prefill_wgmma_fold_matches_plain(cuda, case):
    """The TMA + wgmma fold (bf16, D = 128) against flash_prefill_plain
    at the main path's shapes and a ragged one, every split count forced
    (split-KV combined in the launch), within 2e-2 and the epsilon band;
    the plan's own pick too, and every launch on the wgmma fold."""
    label, b, s, t, hq, hkv, starts = case
    q, k, v, qpos, kv_len = _fp_case(300 + s, b, s, t, hq, hkv, starts)
    want = flash_prefill_plain(q, k, v, q_positions=qpos, kv_len=kv_len)
    before = dict(fp.launches_by_body)
    for splits in (None, 1, 2, 3, 4):
        got = fp._launch(q, k, v, qpos, 0, kv_len, True, None,
                         body="wgmma", splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2)
        band(want, got, "flash_prefill")
    assert fp.launches_by_body["wgmma"] - before["wgmma"] == 5
    assert fp.launches_by_body["mma"] == before["mma"]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3])
def test_flash_prefill_wgmma_nan_tail_and_one_hot_v(cuda, splits):
    """Keys past kv_len hold NaN (a recycled cache page): TMA loads them,
    and the fold must neither let them into the scores nor into P V, so
    the result equals the finite cache's. A one-hot V (v[t, h, d] = 1
    where d = (t + h) mod 128) makes the output the softmax weights
    themselves, which pins the register layout of P as P V's A operand."""
    b, s, t, hq, hkv = 4, 64, 1024, 32, 8
    q, k, v, qpos, kv_len = _fp_case(310, b, s, t, hq, hkv,
                                     [960, 600, 200, 0])
    want = flash_prefill_plain(q, k, v, q_positions=qpos, kv_len=kv_len)
    k_nan, v_nan = k.clone(), v.clone()
    for i in range(b):
        k_nan[i, int(kv_len[i]):] = float("nan")
        v_nan[i, int(kv_len[i]):] = float("nan")
    got = fp._launch(q, k_nan, v_nan, qpos, 0, kv_len, True, None,
                     body="wgmma", splits=splits)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    tt = torch.arange(t, device="cuda")[:, None, None]
    hh = torch.arange(hkv, device="cuda")[None, :, None]
    dd = torch.arange(128, device="cuda")[None, None, :]
    onehot = (dd == (tt + hh) % 128).to(torch.bfloat16).expand(
        b, t, hkv, 128).contiguous()
    want = flash_prefill_plain(q, k, onehot, q_positions=qpos,
                               kv_len=kv_len)
    got = fp._launch(q, k, onehot, qpos, 0, kv_len, True, None,
                     body="wgmma", splits=splits)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    band(want, got, "flash_prefill")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype,accum", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16-acc-f32"])
def test_ring_reduce_scatter_kernel_matches_plain_bitwise(cuda, n, dtype,
                                                          accum):
    """The credit-flow ring against its plain version: bitwise (the same
    fold order, each add rounded to the accumulation dtype), at chunks of
    several tiles with a ragged last one, one of 3 elements (the
    element-wise path), the Qwen3-30B-A3B path chunks (64 and 128 rows
    of 2048) and a decode step's one row; n = 1 with force_kernel runs
    no ring step."""
    rng = np.random.default_rng(30 + n)
    reset_launches()
    calls = 0
    for m, w in ((40, 1000), (1, 3), (64, 2048), (128, 2048), (1, 2048)):
        x = torch.from_numpy(rng.standard_normal((n, n * m, w))).to(
            "cuda", dtype)
        got = ring_reduce_scatter(x, accum_dtype=accum, force_kernel=True)
        calls += 1
        want = ring_reduce_scatter_plain(x, accum)
        torch.cuda.synchronize()
        assert got.shape == (n, m, w) and got.dtype == dtype
        assert torch.equal(got, want), (m, w)
        if dtype == torch.bfloat16:
            band(want, got, "ring_reduce_scatter")
    assert launches()["ring_reduce_scatter"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype,accum", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16-acc-f32"])
def test_ring_reduce_scatter_every_tile_bitwise(cuda, n, dtype, accum):
    """Each tile the plan may take (2048, 4096, 8192 elements, as far as
    a thread's share of the slot allows), forced through the launcher,
    bitwise the plain version: a ragged chunk, a misaligned one (3
    elements) and a path chunk."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    rng = np.random.default_rng(60 + n)
    tiles = [t for t in rs._TILES if t // rs._TILES[0] * 8 * accum.itemsize
             <= rs._THREAD_SHARE]
    for m, w in ((40, 1000), (1, 3), (64, 2048)):
        x = torch.from_numpy(rng.standard_normal((n, n * m, w))).to(
            "cuda", dtype)
        want = ring_reduce_scatter_plain(x, accum)
        for tile in tiles:
            got = rs._launch(x, accum, tile=tile)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, w, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_ring_all_gather_kernel_matches_plain_bitwise(cuda, n, dtype):
    """The ring AllGather bitwise its plain version over 16-byte, 4-byte
    and 2-byte words (shards of 16k, 4k + 4 and 4k + 2 bytes), ragged and
    multi-tile sizes and the main path's (128, 4096) and (512, 2048); the
    C entry's tile count is the wrapper's plan."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather as agr

    rng = np.random.default_rng(90 + n)
    for m, w in ((1, 4096), (3, 1000), (5, 7), (128, 4096), (512, 2048),
                 (1, 3), (33, 264)):
        if dtype == torch.int8 and (m * w) % 2:
            continue
        x = torch.from_numpy(rng.standard_normal((n, m, w)) * 8).to(
            "cuda", dtype)
        got = ring_all_gather(x)
        torch.cuda.synchronize()
        assert torch.equal(got, ring_all_gather_plain(x)), (m, w)
    lib = _build.load("allgather", agr._SIGNATURES)
    for chunk in (2, 16384, 16386, 1 << 20):
        assert lib.ag_tile_count(chunk) == agr._ring_tiles(chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_all_gather_back_to_back_leaves_flags_at_zero(cuda, n):
    """50 ring AllGather calls on one stream, alternating two shapes,
    each bitwise its plain version: every launch finds its persistent
    flags at zero, which the previous one left there. After them the
    pools read all zeros and no call past the first of each shape made
    a pool."""
    from triton_dist_tpu_torch.kernels import allgather as agr

    rng = np.random.default_rng(95 + n)
    xs = [torch.from_numpy(rng.standard_normal((n, m, w))).to(
        "cuda", torch.bfloat16) for m, w in ((128, 4096), (37, 1000))]
    wants = [ring_all_gather_plain(x) for x in xs]
    made = None
    for i in range(50):
        got = ring_all_gather(xs[i % 2])
        torch.cuda.synchronize()
        assert torch.equal(got, wants[i % 2]), i
        if i == 1:
            made = agr._POOLS.made
    assert agr._POOLS.made == made
    assert all(not bool(f.any()) for f in agr._POOLS.entries.values())


def _pools_at_zero():
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    return all(not bool(flags.any())
               for _, flags in rs._POOLS.entries.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_reduce_scatter_back_to_back_leaves_flags_at_zero(cuda, n):
    """50 calls on one stream, alternating two shapes and the native ring
    (row 10) with the fp8 wire ring (row 11), each bitwise its plain
    version: every launch finds its persistent flags at zero, which the
    previous one left there. After them, the pools read all zeros and no
    call past the first of each configuration made a pool."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    rng = np.random.default_rng(70 + n)
    shapes = ((64, 2048), (37, 4096))
    xs = [torch.from_numpy(rng.standard_normal((n, n * m, w))).to(
        "cuda", torch.bfloat16) for m, w in shapes]
    native = [ring_reduce_scatter_plain(x) for x in xs]
    wired = [rs.ring_reduce_scatter_wire_plain(x, "fp8") for x in xs]
    made = None
    for i in range(50):
        x = xs[i % 2]
        if i // 2 % 2:
            got, want = rs.ring_reduce_scatter_wire(x, "fp8"), wired[i % 2]
        else:
            got, want = ring_reduce_scatter(x), native[i % 2]
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        if i == 3:
            made = rs._POOLS.made
    assert rs._POOLS.made == made
    assert _pools_at_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_reduce_scatter_delayed_rank_bitwise(cuda, n):
    """Each rank in turn stalls 5 ms on entry (the native launcher's
    _straggler, the wire ring's straggler): the fold does not follow
    arrival, so both rings stay bitwise their plain versions, and the
    flags come back to zero."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    rng = np.random.default_rng(80 + n)
    x = torch.from_numpy(rng.standard_normal((n, n * 64, 2048))).to(
        "cuda", torch.bfloat16)
    want = ring_reduce_scatter_plain(x)
    want_wire = rs.ring_reduce_scatter_wire_plain(x, "int8")
    for rank in range(n):
        got = rs._launch(x, x.dtype, _straggler=(rank, 5_000_000))
        got_wire = rs.ring_reduce_scatter_wire(
            x, "int8", straggler=(rank, 5_000_000))
        torch.cuda.synchronize()
        assert torch.equal(got, want), rank
        assert torch.equal(got_wire, want_wire), rank
    assert _pools_at_zero()


def _grouped_atol(full, ws, want):
    """ag_gemm's band for the grouped form: one bf16 ulp of the largest
    output plus 1e-5 of max|gate| x max|up| (of the product, without the
    pair) over every expert block."""
    prods = [torch.einsum("sepk,rekn->rsepn", full.float(),
                          w.float()).abs().max().item() for w in ws]
    ulp = 2.0 ** -7 * want.float().abs().max().item()
    return ulp + 1e-5 * max(1.0, prods[0]) * max(1.0, prods[-1] if len(
        ws) == 2 else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cap", [16, 64, 256])
def test_grouped_ag_gemm_kernel_matches_plain(cuda, n, cap):
    """The grouped form (bf16, silu_pair, both C orders) against its
    plain version, w_gate / w_up as views of one [gate | up] stack (rows
    2N apart, read in place); cap below, at and above the 128-row tile,
    so tiles never span two experts."""
    rng = np.random.default_rng(40 + n + cap)
    e, k, i_loc = 6, 256, 192
    a = torch.from_numpy(rng.standard_normal((n, e * cap, k))).to(
        "cuda", torch.bfloat16)
    gu = (torch.from_numpy(rng.standard_normal((n, e, k, 2 * i_loc)))
          * 0.05).to("cuda", torch.bfloat16)
    ws = (gu[..., :i_loc], gu[..., i_loc:])
    reset_launches()
    for c_order in ("arrival", "rank"):
        got = ag_gemm(a, ws, epilogue="silu_pair", c_order=c_order)
        want = ag_gemm_plain(a, ws, "silu_pair", c_order)
        torch.cuda.synchronize()
        full = a.reshape(n, e, cap, k)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_grouped_atol(full, ws, want))
        band(want, got, "ag_gemm")
    assert launches()["ag_gemm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cap", [16, 48, 64, 256])
def test_grouped_ag_gemm_counts_kernel_matches_plain(cuda, n, cap):
    """The expert-major grouped kernel with counts (the live rows of each
    (rank, expert) block, 0 and cap included) against the plain version
    with the same counts, both C orders, plain and silu_pair, bf16 and
    f32 out: within the atol and the band; the rows past counts are
    non-zero in A, and their C rows come out exactly zero. Every call
    took the grouped kernel."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as ag

    rng = np.random.default_rng(60 + n + cap)
    e, k, i_loc = 6, 256, 192
    a = torch.from_numpy(rng.standard_normal((n, e * cap, k))).to(
        "cuda", torch.bfloat16)
    gu = (torch.from_numpy(rng.standard_normal((n, e, k, 2 * i_loc)))
          * 0.05).to("cuda", torch.bfloat16)
    ws = (gu[..., :i_loc], gu[..., i_loc:])
    counts = torch.from_numpy(rng.integers(0, cap + 1, (n, e))).to(
        "cuda", torch.int32)
    counts[0, 0], counts[-1, -1] = 0, cap
    full = a.reshape(n, e, cap, k)
    before = dict(ag.launches_by_body)
    calls = 0
    for b, ep in ((ws[0], None), (ws, "silu_pair")):
        for c_order in ("arrival", "rank"):
            for out in (torch.bfloat16, torch.float32):
                kw = dict(epilogue=ep, c_order=c_order, counts=counts,
                          out_dtype=out)
                got = ag_gemm(a, b, **kw)
                want = ag_gemm_plain(a, b, **kw)
                calls += 1
                torch.cuda.synchronize()
                atol = _grouped_atol(full, ws if ep else ws[:1], want)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
                dead = ag._zero_dead_rows(torch.ones_like(got[..., :1]),
                                          counts, c_order == "arrival") == 0
                assert not bool(got[dead.expand_as(got)].any())
                if out == torch.bfloat16:
                    band(want, got, "ag_gemm")
    got_bodies = {k2: v - before[k2] for k2, v in ag.launches_by_body.items()}
    assert got_bodies == {"mma": 0, "wgmma": 0, "grouped": calls}


@pytest.mark.cuda
def test_grouped_ag_gemm_fused_prefill_like_inputs(cuda):
    """pack_by_expert's inputs at a cut of the fused prefill (n 4, E 32,
    cap 64 from 8 tokens a rank at top 8, K 512, I_loc 192): the kernel
    with the packs' counts, without them, and the old mma.sync body all
    within the atol of the plain version, in the band; with counts the
    call makes no host sync."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as ag
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    rng = np.random.default_rng(77)
    n, e, k, i_loc, m_tok, top = 4, 32, 512, 192, 8, 8
    packs = []
    for r in range(n):
        x = torch.from_numpy(rng.standard_normal((m_tok, k))).to(
            "cuda", torch.bfloat16)
        ids = torch.from_numpy(np.stack([rng.choice(e, top, replace=False)
                                         for _ in range(m_tok)])).to(
            "cuda", torch.int32)
        packs.append(mu.pack_by_expert(x, ids, e, m_tok * top))
    a = torch.stack([p.x for p in packs])
    counts = torch.stack([p.counts for p in packs])
    gu = (torch.from_numpy(rng.standard_normal((n, e, k, 2 * i_loc)))
          * 0.05).to("cuda", torch.bfloat16)
    ws = (gu[..., :i_loc], gu[..., i_loc:])
    want = ag_gemm_plain(a, ws, "silu_pair", "arrival")
    atol = _grouped_atol(a.reshape(n, e, -1, k), ws, want)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ag_gemm(a, ws, epilogue="silu_pair", c_order="arrival",
                      counts=counts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for c in (got, ag_gemm(a, ws, epilogue="silu_pair", c_order="arrival"),
              ag._launch(a, ws, True, False, body="mma"),
              ag._launch(a, ws, True, False, counts=counts, body="mma")):
        torch.cuda.synchronize()
        torch.testing.assert_close(c.float(), want.float(), rtol=0,
                                   atol=atol)
        band(want, c, "ag_gemm")


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [[5, 0, 7, 4], [0, 0, 16, 0], [3, 2, 1, 0]],
                         ids=["empty-middle", "one-group", "trailing-rows"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_gemm_card_route_matches_plain(cuda, gs, out_dtype):
    """torch._grouped_mm with the rank dim folded into the groups against
    the loop over experts: empty groups, one group, and rows past the
    last group (exactly zero on every rank, the last one included); x
    shared by the ranks, one per rank, and an unstacked weight; and
    (n, E) sizes, one row a rank (EP), with and without the sizes handed
    over on the host. Band: one bf16 ulp of the largest output plus 1e-5
    of it, and the epsilon band of the out dtype (an f32 out_dtype takes
    each expert's rows in f32: `_grouped_mm`'s bf16 result widened fell
    outside the f32 band)."""
    rng = np.random.default_rng(50 + sum(gs[:2]))
    n, t, k, nn = 4, 16, 64, 48
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    w = (torch.from_numpy(rng.standard_normal((n, 4, k, nn))) * 0.2).to(
        "cuda", torch.bfloat16)
    shared = torch.from_numpy(rng.standard_normal((t, k))).to(
        "cuda", torch.bfloat16)
    per_rank = torch.from_numpy(rng.standard_normal((n, t, k))).to(
        "cuda", torch.bfloat16)
    for x, ws in ((shared, w), (per_rank, w), (shared, w[1])):
        got = gg.grouped_gemm(x, ws, sizes, out_dtype=out_dtype)
        want = gg.grouped_gemm_plain(x, ws, sizes, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == out_dtype
        top = want.float().abs().max().item()
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=2.0 ** -7 * top + 1e-5 * max(1.0, top))
        band(want, got, "grouped_gemm")
        assert not got[..., sum(gs):, :].any()
    # sizes a rank: gs, reversed, none, rotated
    per = torch.tensor([gs, gs[::-1], [0] * 4, gs[1:] + gs[:1]],
                       dtype=torch.int32, device="cuda")
    want = gg.grouped_gemm_plain(per_rank, w, per, out_dtype=out_dtype)
    for host in (None, per.tolist()):
        got = gg.grouped_gemm(per_rank, w, per, out_dtype=out_dtype,
                              host_sizes=host)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == out_dtype
        top = want.float().abs().max().item()
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=2.0 ** -7 * top + 1e-5 * max(1.0, top))
        band(want, got, "grouped_gemm")
        for r, used in enumerate(per.sum(-1).tolist()):
            assert not got[r, used:].any()


@pytest.mark.cuda
def test_grouped_gemm_f32_out_skewed_routing_bounded_memory(cuda):
    """The f32-out route at the Qwen3-30B-A3B down product of a 4 x 128
    prefill at world 4 (4096 routed rows, 128 experts, K 192, N 2048),
    one expert taking 90% of the rows: against the loop over experts
    (one bf16 ulp of the largest output plus 1e-5 of it, and the f32
    band), and the memory the call allocates beyond its inputs within
    the output, _SCRATCH_BYTES and 32 MiB of indices (blocks padded to
    the hot expert for every expert would need 15.5 GB)."""
    n, e, k, nn, t, hot = 4, 128, 192, 2048, 4096, 37
    rng = np.random.default_rng(77)
    rest = rng.multinomial(t - 3686, [1 / (e - 1)] * (e - 1))
    sizes = torch.from_numpy(np.insert(rest, hot, 3686)).to("cuda",
                                                            torch.int32)
    x = torch.from_numpy(rng.standard_normal((t, k))).to("cuda",
                                                         torch.bfloat16)
    w = (torch.randn((n, e, k, nn), device="cuda") * 0.05).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = gg.grouped_gemm(x, w, sizes, out_dtype=torch.float32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = n * (t + 1) * nn * 4
    print(f"grouped_gemm f32 out, hot expert 3686 of {t} rows: peak "
          f"{peak / 2**20:.1f} MiB beyond the inputs (output "
          f"{out_bytes / 2**20:.1f} MiB, budget "
          f"{gg._SCRATCH_BYTES / 2**20:.0f} MiB)")
    assert peak <= out_bytes + gg._SCRATCH_BYTES + (32 << 20), peak
    want = gg.grouped_gemm_plain(x, w, sizes, out_dtype=torch.float32)
    torch.cuda.synchronize()
    top = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2.0 ** -7 * top + 1e-5 * max(1.0, top))
    band(want, got, "grouped_gemm")


# gemm_rs over a counter pool that was not zeroed: no tile counter can
# reach n, so the fold's bounded wait must trap; argv[1]: the body (0
# mma.sync, M 16; 1 wgmma, m 64, whose fold waits run on its producer
# warp)
_FAULT = r"""
import ctypes, sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
lib = _build.load("gemm_reduce_scatter", rs._SIGNATURES)
body = int(sys.argv[1])
n, M, K, N = 2, 128 if body else 16, 64, 128
bn = 128 if body else 0
a = torch.ones((n, M, K), device="cuda", dtype=torch.bfloat16)
b = torch.ones((n, K, N), device="cuda", dtype=torch.bfloat16)
heap = torch.empty((n, n, M // n, N), device="cuda", dtype=torch.bfloat16)
out = torch.empty((n, M // n, N), device="cuda", dtype=torch.bfloat16)
# a flag pool that was not zeroed: no tile counter can reach n
flags = torch.full((n, lib.gemm_rs_flag_count(M // n, N, 1, bn)), 7,
                   device="cuda", dtype=torch.int32)
grid = _build.GridInfo()
err = lib.gemm_rs_launch(a.data_ptr(), b.data_ptr(), heap.data_ptr(),
                         out.data_ptr(), flags.data_ptr(), n, M, K, N, 1, 1,
                         0, 0, body, bn, -1, 0, grid.ptr(),
                         torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""

# ag_gemm over a flag pool that was not zeroed: no arrival counter can
# equal the producer count, so the ring's step-1 wait must trap; argv[1]:
# the body (0 mma.sync, m 16; 1 wgmma, m 64, its tile counter at zero and
# the arrival counters far below it, so its producer thread's wait for a
# delivered step traps too; 2 the grouped kernel, E 2, cap 32, counts 5)
_AG_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
lib = _build.load("allgather_gemm", ag._SIGNATURES)
body = int(sys.argv[1])
n, m, K, N = 4, 64 if body else 16, 64, 64
a = torch.ones((n, m, K), device="cuda", dtype=torch.bfloat16)
b = torch.ones((n, K, N), device="cuda", dtype=torch.bfloat16)
ws = torch.empty((n, n * m, K), device="cuda", dtype=torch.bfloat16)
c = torch.empty((n, n * m, N), device="cuda", dtype=torch.bfloat16)
flags = torch.full((n, lib.ag_gemm_flag_count(n)), 7, device="cuda",
                   dtype=torch.int32)
if body:
    flags[:, 0] = 0
    flags[:, 1:] = -1000
grid = _build.GridInfo()
stream = torch.cuda.current_stream().cuda_stream
if body == 2:
    counts = torch.full((n, 2), 5, device="cuda", dtype=torch.int32)
    err = lib.ag_gemm_grouped_launch(
        a.data_ptr(), b.data_ptr(), b.data_ptr(), ws.data_ptr(),
        c.data_ptr(), flags.data_ptr(), counts.data_ptr(), n, m, K, N, 1, 1,
        0, 0, 2, N, K * N // 2, K * N, 1, 64, -1, 0, grid.ptr(), stream)
else:
    err = lib.ag_gemm_launch(a.data_ptr(), b.data_ptr(), b.data_ptr(),
                             ws.data_ptr(), c.data_ptr(), flags.data_ptr(),
                             n, m, K, N, 1, 1, 0, 0, body,
                             128 if body else 0, -1, 0, grid.ptr(), stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


# a ring AllGather whose persistent pool was left with a flag far below
# zero: rank 1 waits for exactly one arrival on it, which can never show,
# so its wait must trap
_RING_AG_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather as agr
lib = _build.load("allgather", agr._SIGNATURES)
n, chunk = 4, 1 << 16
x = torch.ones((n, chunk // 2), device="cuda", dtype=torch.bfloat16)
out = torch.empty((n, n, chunk // 2), device="cuda", dtype=torch.bfloat16)
flags = torch.zeros((n, (n - 2) * lib.ag_tile_count(chunk)), device="cuda",
                    dtype=torch.int32)
flags[1, 0] = -1000
grid = _build.GridInfo()
err = lib.ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(), n, chunk,
                    grid.ptr(), torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


# a one-shot AllReduce whose pool was left with a tile's arrival counter
# set (as a trapped launch leaves it): the wait is for exactly n - 1
# arrivals, so that tile's wait must trap
_AR_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allreduce as ar
lib = _build.load("allreduce", ar._SIGNATURES)
n, E = 4, 4 * 4096
x = torch.ones((n, E), device="cuda", dtype=torch.bfloat16)
ws = torch.empty((n, n, E), device="cuda", dtype=torch.bfloat16)
out = torch.empty_like(x)
tile, blocks, nf = ar._ar_plan(E, n, 2)
flags = torch.zeros((n, nf), device="cuda", dtype=torch.int32)
flags[1, 0] = 7
grid = _build.GridInfo()
err = lib.ar_launch(x.data_ptr(), ws.data_ptr(), out.data_ptr(),
                    flags.data_ptr(), n, E, tile, blocks, nf, 1, grid.ptr(),
                    torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


# a ring ReduceScatter whose credit can never arrive: the credit counters
# start far below zero, so the step-0 credit wait must trap
_RS_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import reduce_scatter as rs
lib = _build.load("reduce_scatter", rs._SIGNATURES)
n, E = 4, 4096
x = torch.ones((n, n * E), device="cuda", dtype=torch.bfloat16)
acc = torch.empty((n, 2, E), device="cuda", dtype=torch.bfloat16)
out = torch.empty((n, E), device="cuda", dtype=torch.bfloat16)
tile, tiles = rs._ring_plan(E, 2, n)
flags = torch.full((n, 3 * tiles), -1000, device="cuda", dtype=torch.int32)
grid = _build.GridInfo()
err = lib.rs_launch(x.data_ptr(), acc.data_ptr(), out.data_ptr(),
                    flags.data_ptr(), n, E, tile, 1, 1, -1, 0, grid.ptr(),
                    torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


# an LL context whose entry-barrier counter was left far below zero: the
# first call's barrier can never be met
_LL_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import low_latency_allgather as llag
n = 4
x = torch.ones((n, 8, 128), device="cuda")
ctx = llag.create_ll_ag_buffer((8, 128), torch.float32, n, device="cuda")
ctx.flags[:, -1] = -1000
llag.ll_all_gather(x, ctx, 0)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""

# SP flash prefill whose segment delivery flags start far below zero: no
# remote segment ever counts every pushing block, so rank 1's first
# remote fold must trap
_SP_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import flash_prefill as fp
n, B, S, Hq, Hkv, D = 2, 1, 64, 4, 2, 64
lib = _build.load("flash_prefill", fp._SIGNATURES)
q = torch.ones((n, B, S, Hq, D), device="cuda", dtype=torch.bfloat16)
k = torch.ones((n, B, S, Hkv, D), device="cuda", dtype=torch.bfloat16)
kv_len = torch.full((B,), n * S, device="cuda", dtype=torch.int32)
out = torch.empty_like(q)
kbuf = torch.empty((n, n - 1, B, S, Hkv, D), device="cuda",
                   dtype=torch.bfloat16)
flags = torch.zeros((n, lib.fp_sp_flag_words(n, B)), device="cuda",
                    dtype=torch.int32)
flags[:, :2 * (n - 1) * B] = -1000
grid = _build.GridInfo()
err = lib.fp_sp_launch(q.data_ptr(), k.data_ptr(), k.data_ptr(),
                       kv_len.data_ptr(), out.data_ptr(), kbuf.data_ptr(),
                       kbuf.data_ptr(), flags.data_ptr(), n, B, S, Hq, Hkv,
                       D, 1, 1, 0.125, 8, -1, 0, grid.ptr(),
                       torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


# an all-to-all whose delivery flags start far below zero: no segment
# ever counts every block of its source, so the first delivery wait must
# trap (argv: chunked, bulk body)
_A2A_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import all_to_all as a2a
chunked, bulk = int(sys.argv[1]), int(sys.argv[2])
n, q = 4, 2 if chunked else 1
lib = _build.load("all_to_all", a2a._SIGNATURES)
x = torch.ones((n, n, 8, 256), device="cuda", dtype=torch.bfloat16)
sp = torch.ones((n, n), device="cuda", dtype=torch.int32)
out, osp = torch.empty_like(x), torch.empty_like(sp)
seg = 8 * 256 * 2
word = a2a._word(seg, q, True, "bulk" if bulk else "reg")
flags = torch.full((n, a2a._flag_words(n, q)), -1000, device="cuda",
                   dtype=torch.int32)
grid = _build.GridInfo()
err = lib.a2a_launch(x.data_ptr(), out.data_ptr(), sp.data_ptr(),
                     osp.data_ptr(), flags.data_ptr(), n, seg // word, 1,
                     q, word, chunked, bulk, -1, 0, 2, grid.ptr(),
                     torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,script,args", [
    ("gemm_rs", _FAULT, ["0"]), ("ag_gemm", _AG_FAULT, ["0"]),
    ("ring_all_gather", _RING_AG_FAULT, []),
    ("one_shot_all_reduce", _AR_FAULT, []),
    ("ring_reduce_scatter", _RS_FAULT, []), ("ll_all_gather", _LL_FAULT, []),
    ("sp_flash_prefill", _SP_FAULT, []),
    ("all_to_all", _A2A_FAULT, ["0", "0"]),
    ("all_to_all_chunked", _A2A_FAULT, ["1", "0"]),
    ("all_to_all", _A2A_FAULT, ["0", "1"]),
    ("all_to_all_chunked", _A2A_FAULT, ["1", "1"])],
    ids=["gemm_rs", "ag_gemm-mma", "ring_all_gather", "one_shot_all_reduce",
         "ring_reduce_scatter", "ll_all_gather", "sp_flash_prefill",
         "all_to_all", "all_to_all_chunked", "all_to_all-bulk",
         "all_to_all_chunked-bulk"])
def test_protocol_fault_traps_instead_of_hanging(cuda, kernel, script, args):
    """A wait that can never be satisfied (flags left non-zero) ends in
    the bounded spin's printf and __trap(): the launch fails and the
    next synchronisation raises, within the spin bound, instead of
    hanging. Run in a child process, since the trap leaves its CUDA
    context unusable."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "raised:" in proc.stdout
    assert f"shmem wait timed out: kernel {kernel}, rank" in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("script,arg", [(_FAULT, "1"), (_AG_FAULT, "1"),
                                        (_AG_FAULT, "2")],
                         ids=["gemm_rs", "ag_gemm-wgmma", "ag_gemm-grouped"])
def test_gemm_rs_wgmma_protocol_fault_traps_without_a_word(cuda, script,
                                                           arg):
    """The wgmma bodies (gemm_rs's; ag_gemm's dense and grouped) over
    counters that were not zeroed: a bounded spin traps and the next
    synchronisation raises, within the spin bound. They print nothing: a
    call (printf) anywhere in a kernel that issues wgmma makes ptxas
    serialize its wgmma (C7510). Run in a child process, since the trap
    leaves its CUDA context unusable."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script, arg], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "raised:" in proc.stdout
    assert "timed out" not in proc.stdout


def _mega_branch_inputs(cm, world, B, H, I, hq, hkv, D, s_max, page, pos,
                        paged, dtype, seed):
    """Random weights, norms, rope table, KV pools, positions and page
    table for mega.builder.branch_graph, on the card."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to("cuda", dt)

    shapes = {"w_gu": (H, 2 * I), "w_dn": (I, H),
              "w_qkv": (H, (hq + 2 * hkv) * D), "w_o": (hq * D, H),
              "w_gu2": (H, 2 * I), "w_dn2": (I, H)}
    weights = {k: t(2, world, *s, scale=0.05) for k, s in shapes.items()}
    norms = 1.0 + t(7, cm.norm_width, scale=0.1, dt=torch.float32)
    rope = t(s_max + 1, D, scale=0.7, dt=torch.float32)
    maxp = s_max // page
    pages = B * maxp + 2
    k_pool = t(2, world * hkv, pages, page, D, scale=0.5)
    v_pool = t(2, world * hkv, pages, page, D, scale=0.5)
    if paged:
        perm = rng.permutation(pages - 2)[:B * maxp] + 1
        table = perm.reshape(B, maxp)
    else:
        table = np.arange(B * maxp).reshape(B, maxp)
    table = torch.as_tensor(table, dtype=torch.int32, device="cuda")
    pos = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    ws = cm.workspace("cuda")
    ws[:, 0, :, :H] = t(B, H)  # x
    return pos, table, ws, weights, norms, rope, k_pool, v_pool


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("dtype,ulps", [(torch.float32, None),
                                        (torch.bfloat16, 2)])
@pytest.mark.parametrize("batch,paged,D", [(4, False, 64), (3, True, 128),
                                           (9, False, 32), (2, True, 256)])
def test_mega_branches_match_plain(cuda, world, dtype, ulps, batch, paged,
                                   D):
    """Every megakernel branch (matmul with none / rms / silu prologue,
    rms_norm, silu_mul, add, allreduce_add, attention over a dense or a
    paged pool, the barrier at world 4) against run_plain on the same
    inputs, each branch's output in its own slot; one launch. Positions
    0, mid-page, page edges and s_max - 1; head_dim 32, 64, 128 and 256;
    batch 2, 3, 4 and 9 (the kernel's 16-row form). f32 within 1e-4
    (sums in another order); bf16 within two bf16 ulps of each output's
    largest value (2 * 2^-7 of it): the two round the same values to bf16
    at the same points after f32 sums taken in another order, so a
    rounding may differ by one ulp and carry into the next branch.
    bf16 is also judged by its epsilon band, teacher-forced: each queue
    row alone on the kernel from run_plain's workspace up to that row
    (chip_smoke.check_mega_rows, shared with chip_smoke.py phases 3 and
    4m), so a one-quantum fold-order difference of one branch does not
    reach the next branch's inputs; the band itself is unchanged."""
    from triton_dist_tpu_torch.mega.builder import branch_graph
    from triton_dist_tpu_torch.mega.kernel import compile_graph
    from triton_dist_tpu_torch.mega.scheduler import (
        schedule_graph,
        validate_schedule,
    )

    H, I, hq, hkv, s_max, page = 256, 512, 4, 2, 64, 16
    g = branch_graph(world, batch, H, I, hq, hkv, D, s_max,
                           page if paged else 0)
    sched = schedule_graph(g)
    validate_schedule(g, sched)
    cm = compile_graph(g, sched, dtype, blocks=132 // world, world=world)
    pos = [0, 7, 16, 63, 31, 1, 48, 15, 33][:batch]
    inp = _mega_branch_inputs(cm, world, batch, H, I, hq, hkv, D, s_max,
                              page if paged else s_max, pos, paged, dtype,
                              seed=world + batch)
    pos_t, table, ws, weights, norms, rope, kp, vp = inp
    want = cm.run_plain(pos_t, table, ws.clone(), weights, norms, rope, kp,
                        vp)
    ws0 = ws.clone()
    reset_launches()
    got = cm.run(pos_t, table, ws, weights, norms, rope, kp, vp)
    torch.cuda.synchronize()
    assert launches()["mega"] == 1
    for b in g.buffers:
        s = int(sched.buf_slot[b.id])
        w = want[:, s, :, :b.width].float()
        err = (got[:, s, :, :b.width].float() - w).abs().max().item()
        atol = 1e-4 if ulps is None else ulps * 2.0 ** -7 * w.abs().max()
        assert err <= atol, (b.name, s, err, atol)
    if dtype == torch.bfloat16:
        import chip_smoke

        _, _, _, (ulp, cos, op), outside = chip_smoke.check_mega_rows(
            cm, pos_t, table, ws0, weights, norms, rope, kp, vp)
        print(f"band mega rows teacher-forced: {outside} outside, worst "
              f"ulp {ulp} cos {cos:.3e} ({op})")


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_mega_decode_step_matches_plain(cuda, world):
    """A whole tiny bf16 Qwen3 decode step (slots reused by the
    happens-before plan) on the card, against run_plain on the recorded
    step inputs (every workspace slot within two bf16 ulps of its largest
    value), and one mega launch a step for decode_step and for each step
    of decode_resident."""
    from triton_dist_tpu_torch.mega import MegaQwen3

    from triton_dist_tpu_torch.models import ModelConfig

    cfg = ModelConfig.tiny(dtype="bfloat16", max_positions=64,
                           head_dim=64, num_q_heads=8, num_kv_heads=4)
    mega = MegaQwen3(cfg, world=world, batch=4, s_max=64, device="cuda")
    cache = mega.new_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    cache.length.copy_(torch.tensor([5, 0, 17, 40]))
    tok = torch.tensor([3, 7, 11, 200], device="cuda")
    recorded = []
    real = mega.cm.run

    def record(*a):
        recorded.append([x.clone() if isinstance(x, torch.Tensor) else x
                         for x in a])
        return real(*a)

    mega.cm.run = record
    reset_launches()
    logits, cache = mega.decode_step(tok, cache)
    torch.cuda.synchronize()
    assert launches()["mega"] == 1
    pos, table, ws, weights, norms, rope, kp, vp = recorded[0]
    want = mega.cm.run_plain(pos, table, ws.clone(), weights, norms, rope,
                             kp, vp)
    got = real(pos, table, ws, weights, norms, rope, kp, vp)
    torch.cuda.synchronize()
    for s in range(got.shape[1]):  # two bf16 ulps of each slot's largest
        w = want[:, s].float()
        err = (got[:, s].float() - w).abs().max().item()
        assert err <= 2 * 2.0 ** -7 * w.abs().max().item(), (s, err)
        band(want[:, s], got[:, s], "mega")
    assert torch.isfinite(logits).all()
    reset_launches()
    ids, _ = mega.decode_resident(logits.argmax(-1), cache, 3)
    torch.cuda.synchronize()
    assert launches()["mega"] == 3 and ids.shape == (4, 3)


# -- the SP path: the decode partial, the LL AllGather, SP flash prefill ----

# (Hq, Hkv, D): tiny, and Qwen3-8B's heads
SP_HEADS = [(4, 2, 64), (32, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", SP_HEADS, ids=["tiny", "qwen3-8b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_partial_kernel_matches_plain(cuda, heads, dtype):
    """The split-KV decode partial against its plain version: valid
    lengths empty, inside the first tile, mid-split, across splits and
    full, T not a multiple of the split (1100 keys: three 512-key splits,
    merged in the kernel); o and lse within 1e-5 (both f32 sums over the
    same bf16 or f32 inputs, in another order) and the f32 epsilon band;
    an empty row gives o = 0, lse = NEG_INF."""
    hq, hkv, d = heads
    rng = np.random.default_rng(hq + d)
    b, t = 6, 1100
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)
               for shape in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    valid = torch.tensor([0, 37, 300, 700, 1100, 1], device="cuda")
    reset_launches()
    o, lse = fd.flash_decode_partial_cuda(q, k, v, valid)
    want_o, want_lse = fd.flash_decode_partial(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, want_o, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=0, atol=1e-5)
    assert torch.all(o[0] == 0) and torch.all(lse[0] == fd.NEG_INF)
    band(want_o, o, "flash_decode_partial")
    band(want_lse[1:], lse[1:], "flash_decode_partial")
    assert launches()["flash_decode_partial"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("partial_impl", ["auto", "pallas"])
@pytest.mark.parametrize("heads", [(4, 2, 256), (32, 2, 128)],
                         ids=["head_dim-256", "group-width-1024+"])
def test_sp_flash_decode_unsupported_shape_raises(cuda, partial_impl,
                                                  heads):
    """A shape the decode partial kernel does not take (head_dim 256;
    G * D > 1024) raises through sp_flash_decode on the card, whichever
    kernel route is named: never the torch einsum in its place."""
    n, b, t_loc = 2, 2, 64
    hq, hkv, d = heads
    q = torch.zeros((n, b, hq, d), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((n, b, t_loc, hkv, d), device="cuda",
                    dtype=torch.bfloat16)
    kv_len = torch.tensor([3, 70], device="cuda")
    reset_launches()
    with pytest.raises(ValueError, match="unsupported shape"):
        fd.sp_flash_decode(q, k, k, kv_len, partial_impl=partial_impl)
    assert launches().get("flash_decode_partial", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape,dtype", [((4, 4224), torch.float32),
                                         ((3, 5), torch.float32),
                                         ((8, 136), torch.bfloat16)],
                         ids=["decode-payload", "ragged", "bf16"])
def test_ll_all_gather_kernel_matches_plain_bitwise(cuda, n, shape, dtype):
    """Five calls on one context (calls 2-4 rewrite slots an earlier call
    of their parity used): every gathered copy, the context's slots and
    its parity flags bitwise the plain version's on a twin context; one
    launch a call."""
    rng = np.random.default_rng(n + shape[0])
    ctx = llag.create_ll_ag_buffer(shape, dtype, n, device="cuda")
    twin = llag.create_ll_ag_buffer(shape, dtype, n, device="cuda")
    reset_launches()
    for i in range(5):
        x = torch.from_numpy(rng.standard_normal((n, *shape))).to("cuda",
                                                                 dtype)
        got, ctx = llag.ll_all_gather(x, ctx, i)
        want = llag.ll_all_gather_plain(x, twin, i)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert torch.equal(ctx.data, twin.data), i
        assert torch.equal(ctx.flags[:, :2 * n], twin.flags[:, :2 * n]), i
    assert launches()["ll_all_gather"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("heads", SP_HEADS, ids=["tiny", "qwen3-8b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sp_flash_prefill_kernel_matches_plain(cuda, n, heads, dtype):
    """SP flash prefill against flash_prefill_ref: a ragged batch (one
    row just under a shard boundary, one empty, one full), causal and
    not, S not a multiple of the tile; f32 within 2e-5, bf16 within two
    bf16 ulps of the largest output and inside the flash_prefill band.
    Then bitwise equal to itself with each rank delayed in turn
    (straggler, 2 ms): the fold order does not follow arrival."""
    hq, hkv, d = heads
    rng = np.random.default_rng(n * hq + d)
    b, s = 3, 100
    q = torch.from_numpy(rng.standard_normal((n, b, s, hq, d))).to(
        "cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((n, b, s, hkv, d))).to(
        "cuda", dtype) for _ in range(2))
    kv_len = torch.tensor([s - 3, 0, n * s], device="cuda")
    reset_launches()
    for causal in (True, False):
        got = fp.sp_flash_prefill(q, k, v, causal=causal, kv_len=kv_len)
        want = fp.flash_prefill_ref(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        else:
            atol = 2 * 2.0 ** -7 * want.float().abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)
            band(want, got, "flash_prefill")
        assert torch.all(got[:, 1] == 0)
    for rank in range(n):
        late = fp.sp_flash_prefill(q, k, v, causal=False, kv_len=kv_len,
                                   straggler=(rank, 2_000_000))
        torch.cuda.synchronize()
        assert torch.equal(late, got), rank
    assert launches()["sp_flash_prefill"] == 2 + n


# -- the MoE all-to-all and the EP layer (PERF.md rows 12-13) ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype,width", [
    (torch.bfloat16, 2176), (torch.float32, 2048), (torch.bfloat16, 3),
    (torch.int8, 40)], ids=["bf16-dispatch", "f32-combine", "bf16-ragged",
                            "int8"])
@pytest.mark.parametrize("splits_dims", [2, 3])
def test_a2a_kernels_match_plain_bitwise(cuda, n, dtype, width,
                                                splits_dims):
    """Both A2A kernels against the plain version, bitwise, payload and
    splits: the EP dispatch width (2176 bf16), the combine's f32, rows
    of 6 bytes (no 16-byte words) and int8 (the kernel moves bytes); the
    chunked kernel at q = 1, 2, 4 and with rank 0, then rank n - 1,
    delayed 5 ms; both kernels with each body forced and on one block a
    rank; one launch a call, and the flag pools at zero after them."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels.all_to_all import (
        all_to_all,
        all_to_all_chunked,
        all_to_all_plain,
    )

    rng = np.random.default_rng(n + width)
    c = 8
    x = torch.from_numpy(rng.standard_normal((n, n, c, width)) * 4).to(
        "cuda", dtype)
    shape = (n, n) if splits_dims == 2 else (n, n, 5)
    sp = torch.from_numpy(rng.integers(0, c + 1, shape)).to("cuda",
                                                            torch.int32)
    want, want_sp = all_to_all_plain(x, sp)
    assert torch.equal(want[1, 0], x[0, 1])
    reset_launches()
    runs = [all_to_all(x, sp)]
    runs += [all_to_all_chunked(x, sp, n_chunks=q) for q in (1, 2, 4)]
    runs += [all_to_all_chunked(x, sp, n_chunks=2, straggler=(r, 5_000_000))
             for r in (0, n - 1)]
    # each body forced (the bulk one where a q = 4 chunk takes 16-byte
    # words), one block a rank
    forced = [dict(body="reg"), dict(blocks=1)]
    if c * width * x.element_size() % 64 == 0:
        forced.append(dict(body="bulk"))
    for kw in forced:
        runs.append(a2a._launch("all_to_all", x, sp, 1, False, None, **kw))
        runs.append(a2a._launch("all_to_all_chunked", x, sp, 4, True,
                                (n - 1, 1_000_000), **kw))
    torch.cuda.synchronize()
    for got, got_sp in runs:
        assert torch.equal(got, want) and torch.equal(got_sp, want_sp)
        assert got_sp.shape == sp.shape
    assert launches()["all_to_all"] == 1 + len(forced)
    assert launches()["all_to_all_chunked"] == 5 + len(forced)
    with pytest.raises(ValueError, match="divide"):
        all_to_all_chunked(x, sp, n_chunks=3)
    assert not any(bool(f.any()) for f in a2a._POOLS.entries.values())


@pytest.mark.cuda
def test_a2a_pools_persist_back_to_back(cuda):
    """Both A2A kernels on one stream, 50 calls back to back, alternating
    the single-shot and the chunked kernel, q 1, 2, 4, four shapes (the
    EP dispatch and combine widths, a ragged bf16 row, 16-byte segments)
    and a straggler: each bitwise its plain version, every pool flag at
    zero after them, and no call past the first round made a pool."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    rng = np.random.default_rng(7)

    def case(n, c, width, dtype, s):
        x = torch.from_numpy(rng.standard_normal((n, n, c, width))).to(
            "cuda", dtype)
        shape = (n, n) if s is None else (n, n, s)
        return x, torch.from_numpy(rng.integers(0, c + 1, shape)).to(
            "cuda", torch.int32)

    shapes = [case(4, 8, 2176, torch.bfloat16, None),
              case(4, 16, 2048, torch.float32, 33),
              case(2, 8, 3, torch.bfloat16, 5), case(4, 4, 4, torch.int8, None)]
    calls = [(i, q) for i in range(len(shapes)) for q in (None, 1, 2, 4)]
    wants = [a2a.all_to_all_plain(x, sp) for x, sp in shapes]
    made = None
    for k in range(50):
        i, q = calls[k % len(calls)]
        x, sp = shapes[i]
        if q is None:
            got = a2a.all_to_all(x, sp)
        else:
            late = (k % x.shape[0], 200_000) if k % 3 == 0 else None
            got = a2a.all_to_all_chunked(x, sp, n_chunks=q, straggler=late)
        torch.cuda.synchronize()
        assert torch.equal(got[0], wants[i][0]), (k, i, q)
        assert torch.equal(got[1], wants[i][1]), (k, i, q)
        if k == len(calls) - 1:
            made = a2a._POOLS.made
    assert a2a._POOLS.made == made
    assert not any(bool(f.any()) for f in a2a._POOLS.entries.values())


def _ep_case(n, m, h, e, inter, dtype, seed=0):
    from triton_dist_tpu_torch.layers.ep_moe import EPMoEParams

    rng = np.random.default_rng(seed)

    def t(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            "cuda", dtype)

    x = t(n, m, h, scale=1.0)
    params = EPMoEParams(t(h, e, scale=0.3), t(n, e // n, h, 2 * inter,
                                              scale=0.05),
                         t(n, e // n, inter, h, scale=0.05))
    return x, params


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [None, 24])
def test_ep_moe_a2a_kernels_bitwise_plain_transports(cuda, capacity):
    """ep_moe_fwd on the card, bf16, n = 4, M 32, E 16, top-4: with the
    kernels, bitwise the same layer with the plain transports
    (sequential: the single-shot kernel against "ref"; overlap at q = 1,
    2, 4: the chunked kernel against "plain" and "ref"), bitwise over two
    calls (the combine adds in slot order, no atomics); overlap and
    sequential inside the bf16 band of each other, equal drops (a tight
    capacity of 24 drops pairs)."""
    from triton_dist_tpu_torch.layers.ep_moe import ep_moe_fwd

    x, p = _ep_case(4, 32, 256, 16, 64, torch.bfloat16)
    k = 4
    reset_launches()
    seq, d_seq = ep_moe_fwd(x, p, k, capacity=capacity, return_drops=True)
    assert launches()["all_to_all"] == 2
    again = ep_moe_fwd(x, p, k, capacity=capacity)
    ref, d_ref = ep_moe_fwd(x, p, k, capacity=capacity, return_drops=True,
                            _transport="ref")
    torch.cuda.synchronize()
    assert torch.equal(seq, again) and torch.equal(seq, ref)
    assert torch.equal(d_seq, d_ref)
    assert (int(d_seq.sum()) > 0) == (capacity is not None)
    for q in (1, 2, 4):
        reset_launches()
        ovl, d_ovl = ep_moe_fwd(x, p, k, capacity=capacity, overlap=True,
                                n_chunks=q, return_drops=True)
        assert launches()["all_to_all_chunked"] == 2
        for transport in ("plain", "ref"):
            other = ep_moe_fwd(x, p, k, capacity=capacity, overlap=True,
                               n_chunks=q, _transport=transport)
            assert torch.equal(ovl, other), (q, transport)
        assert torch.equal(d_ovl, d_seq)
        band(seq, ovl, "ep_moe")


@pytest.mark.cuda
def test_ep_moe_a2a_matches_tp_moe_dist_on_the_card(cuda):
    """The same layer's weights as TP-MoE (n, E, H, 2I/n) and re-laid for
    EP by ep_params_from_tp: EP (the A2A kernels) against the TP-MoE
    `dist` block (ring AG and ring RS kernels) on the same tokens, in
    f32, inside the f32 band: the two differ only in fold order there.
    In bf16 the TP block also rounds the gate|up product, each rank's
    partial output and each add of the ring RS to bf16, which EP does
    not (its products have f32 outputs, as the JAX EP FFN's): near-zero
    outputs then differ by more than the bf16 band's 8 quanta of
    themselves, so the bf16 report is printed, not judged."""
    from triton_dist_tpu_torch.layers.ep_moe import (
        ep_moe_fwd,
        ep_params_from_tp,
    )
    from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd
    from triton_dist_tpu_torch.runtime import VirtualWorld

    n, m, h, e, inter, k = 4, 32, 256, 16, 128, 4
    rng = np.random.default_rng(3)

    def t(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            "cuda", torch.float32)

    tp = TPMoEParams(t(h, e, scale=0.3), t(n, e, h, 2 * inter // n,
                                           scale=0.05),
                     t(n, e, inter // n, h, scale=0.05))
    x = t(n, m, h, scale=1.0)
    world = VirtualWorld(n, "cuda")
    reset_launches()
    want = tp_moe_fwd(x, tp, k, world, mode="dist")
    got = ep_moe_fwd(x, ep_params_from_tp(tp), k)
    torch.cuda.synchronize()
    assert launches()["all_to_all"] == 2
    band(want, got, "ep_moe")
    bf = TPMoEParams(*(w.bfloat16() for w in tp))
    xb = x.bfloat16()
    rep = torch_parity.check_epsilon(
        tp_moe_fwd(xb, bf, k, world, mode="dist").float().cpu().numpy(),
        ep_moe_fwd(xb, ep_params_from_tp(bf), k).float().cpu().numpy(),
        "ep_moe", torch.bfloat16)
    print(f"bf16 EP against TP-MoE dist (measured): cos={rep['cos']:.3e} "
          f"ulp={rep['ulp']} (band {rep['band_cos']:.0e}, "
          f"{rep['band_ulp']})")


# -- the collective library and the PP transport (PERF.md rows 8b, 14, 15) --


def _payload(rng, n, shape, dtype):
    """Seeded (n, *shape) values on the card; integer dtypes take random
    bytes, so every bit pattern travels."""
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, (n, *shape),
                                             dtype=np.uint8)).to("cuda")
    return torch.from_numpy(rng.standard_normal((n, *shape)) * 3).to(
        "cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_full_mesh_all_gather_kernel_matches_plain_bitwise(cuda, n, dtype):
    """The full-mesh AllGather against its plain version and the ring
    kernel, bitwise: M = 1, ragged widths, shards of an odd byte count
    (uint8, 7 bytes), 1 MiB of bf16 a rank, a zero-size shard (no
    launch); rank 0, then rank n - 1, delayed 5 ms; one launch a call."""
    from triton_dist_tpu_torch.kernels import (
        full_mesh_all_gather,
        full_mesh_all_gather_plain,
    )

    rng = np.random.default_rng(n)
    shapes = [(1, 4096), (3, 1000), (5, 7), (1, 7), (128, 4096)]
    reset_launches()
    calls = 0
    for shape in shapes:
        x = _payload(rng, n, shape, dtype)
        want = full_mesh_all_gather_plain(x)
        runs = [full_mesh_all_gather(x)]
        runs += [full_mesh_all_gather(x, straggler=(r, 5_000_000))
                 for r in (0, n - 1)]
        calls += 3
        torch.cuda.synchronize()
        for got in runs:
            assert torch.equal(got, want), shape
        if x[0].numel() * x.element_size() % 2 == 0:
            assert torch.equal(ring_all_gather(x), want)
    empty = _payload(rng, n, (0, 8), dtype)
    assert full_mesh_all_gather(empty).shape == (n, 0, 8)
    assert launches()["full_mesh_all_gather"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_p2p_send_kernel_matches_plain_bitwise(cuda, n, dtype):
    """p2p_send against its plain version, bitwise: every (src, dst)
    pair, src == dst included, a 4 MiB microbatch, a ragged (5, 7) and
    an odd byte count; p2p_read is the reverse send; the sender, then
    the receiver, delayed 5 ms."""
    from triton_dist_tpu_torch.kernels import (
        p2p_read,
        p2p_send,
        p2p_send_plain,
    )

    rng = np.random.default_rng(10 + n)
    reset_launches()
    calls = 0
    for shape in [(512, 4096 // n), (5, 7), (3,)]:
        x = _payload(rng, n, shape, dtype)
        for src in range(n):
            for dst in range(n):
                want = p2p_send_plain(x, src, dst)
                assert torch.equal(p2p_send(x, src, dst), want), (src, dst)
                calls += 1
        want = p2p_send_plain(x, n - 1, 0)
        runs = [p2p_read(x, 0, n - 1)]
        runs += [p2p_send(x, n - 1, 0, straggler=(r, 5_000_000))
                 for r in (n - 1, 0)]
        calls += 3
        torch.cuda.synchronize()
        for got in runs:
            assert torch.equal(got, want), shape
    assert launches()["p2p_send"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_ring_shift_kernel_matches_plain_bitwise(cuda, n, dtype):
    """ring_shift against torch.roll, bitwise, at shift 1 and -1 (the
    neighbour barrier, at n = 2 both signals to one peer), 3, n + 1, 0
    and n (a copy to self under the full barrier); rank 0, then rank
    n - 1, delayed 5 ms."""
    from triton_dist_tpu_torch.kernels import ring_shift, ring_shift_plain

    rng = np.random.default_rng(20 + n)
    reset_launches()
    calls = 0
    for shape in [(512, 4096 // n), (5, 7), (3,)]:
        x = _payload(rng, n, shape, dtype)
        for shift in (1, -1, 3, n + 1, 0, n):
            want = ring_shift_plain(x, shift)
            assert torch.equal(want, torch.roll(x, shift, 0))
            runs = [ring_shift(x, shift)]
            runs += [ring_shift(x, shift, straggler=(r, 5_000_000))
                     for r in (0, n - 1)] if shift in (1, 3) else []
            calls += len(runs)
            torch.cuda.synchronize()
            for got in runs:
                assert torch.equal(got, want), (shape, shift)
    assert launches()["ring_shift"] == calls


@pytest.mark.cuda
def test_pp_schedule_on_the_card_matches_sequential_layers(cuda):
    """pp_schedule_fwd over a tiny bf16 dense model's layers, four
    stages of one layer each, on the card: bitwise each microbatch run
    alone through the four layers (the same kernels on the same shapes
    in the same order), seven ring_shift launches."""
    from triton_dist_tpu_torch.layers import PPCommOp, pp_schedule_fwd
    from triton_dist_tpu_torch.models import (
        ModelConfig,
        layers_fwd,
        pp_stage_fn,
    )
    from triton_dist_tpu_torch.models.dense import init_params

    cfg = ModelConfig.tiny(num_layers=4, dtype="bfloat16", head_dim=64)
    params = init_params(cfg, device="cuda", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (4, 32), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    mbs = params.embed[ids]  # (4 microbatches, 32, H)
    reset_launches()
    got = pp_schedule_fwd(PPCommOp(4), pp_stage_fn(cfg, params, 4),
                          mbs.expand(4, *mbs.shape), 4)
    torch.cuda.synchronize()
    assert launches()["ring_shift"] == 7
    for i in range(4):
        want = layers_fwd(cfg, params, mbs[i], range(4))
        for r in range(4):
            assert torch.equal(got[r, i], want), (r, i)


# flags of the PP and collective-library kernels that no put ever
# satisfies: the delivery words start far below zero (the barrier word
# at zero), so the first wait for an arrival must trap
_P2P_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather as ag
from triton_dist_tpu_torch.kernels import p2p
kernel, n = sys.argv[1], 4
x = torch.ones((n, 8, 256), device="cuda", dtype=torch.bfloat16)
nbytes = 8 * 256 * 2
grid = _build.GridInfo()
st = torch.cuda.current_stream().cuda_stream
if kernel == "full_mesh_all_gather":
    lib = _build.load("allgather", ag._SIGNATURES)
    out = torch.empty((n, n * 8, 256), device="cuda", dtype=torch.bfloat16)
    flags = torch.full((n, lib.fm_ag_flag_words(n)), -1000, device="cuda",
                       dtype=torch.int32)
    flags[:, 0] = 0
    err = lib.fm_ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                           n, nbytes, -1, 0, 2, grid.ptr(), st)
else:
    lib = _build.load("p2p", p2p._SIGNATURES)
    out = torch.empty_like(x)
    flags = torch.full((n, lib.p2p_flag_words()), -1000, device="cuda",
                       dtype=torch.int32)
    flags[:, 0] = 0
    if kernel == "p2p_send":
        err = lib.p2p_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                             n, nbytes, 0, 3, -1, 0, 2, grid.ptr(), st)
    else:
        err = lib.ring_shift_launch(x.data_ptr(), out.data_ptr(),
                                    flags.data_ptr(), n, nbytes, 1, -1, 0, 2,
                                    grid.ptr(), st)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["full_mesh_all_gather", "p2p_send",
                                    "ring_shift"])
def test_p2p_protocol_fault_traps_instead_of_hanging(cuda, kernel):
    """A delivery wait that can never be met traps within the spin
    bound, as test_protocol_fault_traps_instead_of_hanging shows for the
    earlier kernels; in a child process."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _P2P_FAULT, kernel],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert f"shmem wait timed out: kernel {kernel}, rank" in proc.stdout


# -- the quantized wire ---------------------------------------------------------

_WIRE_FORMATS = ["fp8", "int8", ("int8", 128, False), ("fp8", None, True)]


def _wire_fmt(spec):
    from triton_dist_tpu_torch import wire

    return wire.WireFormat(*spec) if isinstance(spec, tuple) else \
        wire.resolve(spec)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", _WIRE_FORMATS,
                         ids=["fp8", "int8", "int8-b128", "fp8-checksum"])
def test_ring_rs_wire_kernel_matches_plain_bitwise(cuda, n, dtype, spec):
    """ring_rs_wire_kernel against its plain version, bitwise: rows of
    4096 (Qwen3-8B's hidden width), an odd row count (37 a chunk, tiles
    of 2 rows, the last one short), one row a chunk, an f32 fold written
    to bf16 and to f32; rank 0, then rank n - 1, delayed 5 ms (the fold
    does not follow arrival); one launch a call."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import (
        ring_reduce_scatter_wire,
        ring_reduce_scatter_wire_plain,
    )

    fmt = _wire_fmt(spec)
    rng = np.random.default_rng(140 + n)
    reset_launches()
    calls = 0
    for m, k in ((37, 4096), (1, 4096), (4, 384)):
        x = torch.from_numpy(rng.standard_normal((n, n * m, k))).to(
            "cuda", dtype)
        for out in (dtype, torch.float32):
            want = ring_reduce_scatter_wire_plain(x, fmt, out)
            runs = [ring_reduce_scatter_wire(x, fmt, out)]
            if n > 1 and out == dtype:
                runs += [ring_reduce_scatter_wire(
                    x, fmt, out, straggler=(r, 5_000_000))
                    for r in (0, n - 1)]
            calls += len(runs)
            torch.cuda.synchronize()
            for got in runs:
                assert got.shape == (n, m, k) and got.dtype == out
                assert torch.equal(got, want), (m, k, out)
        if n > 1:
            assert wire.cosine_drift(want, ring_reduce_scatter(x)) <= \
                wire.DEFAULT_ERROR_BUDGET
    assert launches()["ring_rs_wire"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_gather_family_wire_kernels_bitwise(cuda, n):
    """The ring and full-mesh AllGather and the LL AllGather (three calls
    on one context) moving wire images: bitwise the roundtrip of the
    shards and the same call on the CPU; the codec on the card bitwise
    the codec on the CPU."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import all_gather, AllGatherMethod

    rng = np.random.default_rng(150 + n)
    for spec in _WIRE_FORMATS:
        fmt = _wire_fmt(spec)
        x = torch.from_numpy(rng.standard_normal((n, 16, 4096))).to(
            "cuda", torch.bfloat16)
        rt = wire.roundtrip(x.reshape(n * 16, 4096), fmt)
        assert torch.equal(rt.cpu(), wire.roundtrip(
            x.cpu().reshape(n * 16, 4096), fmt))
        assert torch.equal(wire.pack(x[0], fmt).cpu(),
                           wire.pack(x[0].cpu(), fmt))
        for meth in ("ring_1d", "full_mesh"):
            got = all_gather(x, method=AllGatherMethod(meth),
                             wire_format=fmt)
            torch.cuda.synchronize()
            assert torch.equal(got, rt.expand(n, n * 16, 4096)), meth
        ctx = llag.create_ll_ag_buffer((4, 4096), torch.bfloat16, n,
                                       wire_format=fmt, device="cuda")
        for i in range(3):
            y = torch.from_numpy(rng.standard_normal((n, 4, 4096))).to(
                "cuda", torch.bfloat16)
            got, ctx = llag.ll_all_gather(y, ctx, i, wire_format=fmt)
            torch.cuda.synchronize()
            want = wire.roundtrip(y.reshape(n * 4, 4096), fmt).reshape(
                n, 4, 4096)
            assert torch.equal(got, want[None].expand(n, n, 4, 4096))


@pytest.mark.cuda
def test_wire_checksum_trips_on_the_card(cuda):
    """A flipped payload bit in a gathered checksum image raises
    WireIntegrityError at the consume edge."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.faults.errors import WireIntegrityError

    fmt = wire.WireFormat("int8", checksum=True)
    x = torch.randn(8, 4096, device="cuda", dtype=torch.bfloat16)
    img = wire.pack(x, fmt)
    img[5, 9] ^= 1
    with pytest.raises(WireIntegrityError) as e:
        wire.unpack(img, (4096,), fmt, x.dtype)
    assert e.value.rows == [5]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_gemm_rs_wire_kernels_match_plain(cuda, n, out):
    """gemm_rs on the wire: the partial-GEMM launch, then the wire ring.
    Teacher-forced, the ring's result is bitwise the plain fold of the
    kernel's own f32 partials; end to end it is within the epsilon band's
    cosine of the plain version (the partial GEMM's order may flip a
    quantization step at a hop: that element moves by one step, beyond
    the band's ulp bound, which is printed); the native
    out_dtype=float32 within 1e-5 relative. Arrival order too."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import (
        arrival_to_rank_order,
        gemm_rs_wire_plain,
        ring_reduce_scatter_wire_plain,
    )
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    rng = np.random.default_rng(160 + n)
    a = (torch.from_numpy(rng.standard_normal((n, 64 * n, 1024))) * 0.1).to(
        "cuda", torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal((n, 1024, 512))) * 0.05).to(
        "cuda", torch.bfloat16)
    reset_launches()
    for spec in ("fp8", "int8", ("int8", 128, False)):
        fmt = _wire_fmt(spec)
        for order in ("rank", "arrival"):
            got = gemm_rs(a, b, out_dtype=out, wire_format=fmt, a_order=order)
            partial = grs._launch(a, b, order == "arrival", torch.float32,
                                  partials=True)
            torch.cuda.synchronize()
            want_partial = torch.matmul(
                (arrival_to_rank_order(a) if order == "arrival" else
                 a).float(), b.float())
            torch.testing.assert_close(partial, want_partial, rtol=1e-5,
                                       atol=1e-5)
            assert torch.equal(got, ring_reduce_scatter_wire_plain(
                partial, fmt, out))
            # end to end: a flipped step moves one element by a whole
            # fp8 / int8 step, past the band's ulp bound; its cosine holds
            plain = gemm_rs_wire_plain(a, b, fmt, order, out)
            rep = torch_parity.check_epsilon(
                plain.float().cpu().numpy(), got.float().cpu().numpy(),
                "gemm_rs", out)
            print(f"band gemm_rs wire {spec} {order} {out}: cos="
                  f"{rep['cos']:.3e} ulp={rep['ulp']}")
            assert rep["cos"] <= rep["band_cos"]
    assert launches()["gemm_rs_wire"] == 2 * 6
    assert launches()["ring_rs_wire"] == 6
    got = gemm_rs(a, b, out_dtype=torch.float32)
    want = grs.gemm_rs_plain(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_ag_gemm_wire_kernel_matches_plain(cuda, n, kind):
    """ag_gemm on the wire (force_kernel at n = 1): C within the epsilon
    band of the plain version (A's dequantized tiles are bitwise the
    codec's roundtrip; the products differ in order), both orders, bf16
    and f32 out; return_gathered bitwise the roundtrip of A; m = 1 and a
    ragged row count; the native out_dtype=float32 too."""
    from triton_dist_tpu_torch import wire

    rng = np.random.default_rng(170 + n)
    reset_launches()
    calls = 0
    for m, k, nn in ((128, 1024, 384), (1, 512, 256), (37, 256, 128)):
        a = (torch.from_numpy(rng.standard_normal((n, m, k))) * 0.1).to(
            "cuda", torch.bfloat16)
        b = (torch.from_numpy(rng.standard_normal((n, k, nn))) * 0.05).to(
            "cuda", torch.bfloat16)
        for order in ("rank", "arrival"):
            for out in (torch.bfloat16, torch.float32):
                got, full = ag_gemm(a, b, return_gathered=True,
                                    force_kernel=True, c_order=order,
                                    out_dtype=out, wire_format=kind)
                calls += 1
                want = ag_gemm_plain(a, b, None, order, out_dtype=out,
                                     wire_format=kind)
                torch.cuda.synchronize()
                rt = wire.roundtrip(a.reshape(n * m, k), kind)
                assert torch.equal(full, rt.expand(n, n * m, k))
                if out == torch.bfloat16:
                    band(want, got, "ag_gemm")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
        got = ag_gemm(a, b, out_dtype=torch.float32, force_kernel=True)
        torch.testing.assert_close(got, ag_gemm_plain(
            a, b, out_dtype=torch.float32), rtol=1e-5, atol=1e-5)
    assert launches()["ag_gemm_wire"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_ep_moe_fp8_a2a_kernels_bitwise_plain_transports(cuda, overlap):
    """ep_moe_fwd on the fp8 wire: the all-to-all kernels move the uint8
    rows bitwise as the plain transport does (the same output and
    drops), and the fp8 wire is within the default budget of the bf16
    wire."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.layers.ep_moe import (
        EPMoEParams,
        ep_moe_fwd,
    )

    n, m, h, e, inter, k = 4, 32, 512, 16, 128, 4
    rng = np.random.default_rng(180)

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape)) * scale).to(
            "cuda", torch.bfloat16)

    params = EPMoEParams(t(h, e, scale=0.3), t(n, e // n, h, 2 * inter,
                                                scale=0.05),
                         t(n, e // n, inter, h, scale=0.05))
    x = t(n, m, h)
    kw = dict(overlap=overlap, n_chunks=2 if overlap else None,
              return_drops=True, payload_dtype=torch.float8_e4m3fn)
    reset_launches()
    got, drops = ep_moe_fwd(x, params, k, **kw)
    want, want_drops = ep_moe_fwd(x, params, k, _transport="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(drops, want_drops)
    name = "all_to_all_chunked" if overlap else "all_to_all"
    assert launches()[name] == 2
    full = ep_moe_fwd(x, params, k, overlap=overlap,
                      n_chunks=2 if overlap else None)
    assert wire.cosine_drift(got, full) <= wire.DEFAULT_ERROR_BUDGET


# a wire ring whose credit can never arrive: the credit counters start
# far below zero, so the step-0 credit wait must trap
_RS_WIRE_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import reduce_scatter as rs
lib = _build.load("reduce_scatter", rs._SIGNATURES)
n, m, K, kw = 4, 8, 1024, 1152
x = torch.ones((n, n * m, K), device="cuda", dtype=torch.bfloat16)
slots = torch.empty((n, 2, m, kw), device="cuda", dtype=torch.int8)
out = torch.empty((n, m, K), device="cuda", dtype=torch.bfloat16)
warps, rows, tiles = rs._wire_plan(m, K, K, n)
flags = torch.full((n, 3 * tiles), -1000, device="cuda", dtype=torch.int32)
grid = _build.GridInfo()
err = lib.rs_wire_launch(x.data_ptr(), slots.data_ptr(), out.data_ptr(),
                         flags.data_ptr(), n, m, K, 1, K, 1, 0, kw, warps,
                         rows, 1, 1, -1, 0, grid.ptr(),
                         torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""


@pytest.mark.cuda
def test_ring_rs_wire_protocol_fault_traps_instead_of_hanging(cuda):
    """A credit wait that can never be met traps within the spin bound,
    in a child process (the trap leaves its CUDA context unusable)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _RS_WIRE_FAULT], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "shmem wait timed out: kernel ring_rs_wire, rank" in proc.stdout

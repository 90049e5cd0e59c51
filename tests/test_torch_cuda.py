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
from triton_dist_tpu_torch.kernels.sample import seed_key


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 12288, 4096), (64, 1000, 1000)],
                         ids=["row-6", "ragged"])
def test_gemm_rs_world_one_takes_the_wgmma_body(cuda, shape):
    """force_kernel at n = 1 with m a multiple of 64 (row 6: the JAX
    _local_mm_kernel's place) runs the TMA + wgmma body, its tiles stored
    straight to the output: within _gemm_rs_atol and the band's cosine
    of gemm_rs_plain, at the plan's tile width and each one forced; no
    pool made; the mma.sync body forced still agrees."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs

    m, k, nn = shape
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.standard_normal((1, m, k))).to("cuda",
                                                            torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal((1, k, nn))) * 0.02).to(
        "cuda", torch.bfloat16)
    want = gemm_rs_plain(a, b)
    atol = _gemm_rs_atol(a, b, want)
    before, made = dict(rs.launches_by_body), rs._POOLS.made
    reset_launches()
    runs = [lambda: gemm_rs(a, b, force_kernel=True)]
    runs += [lambda bn=bn: rs._launch(a, b, bn=bn) for bn in rs._WGMMA_BN]
    for fn in runs:
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
        _band_cos(want, got, "gemm_rs")
    assert launches()["gemm_rs"] == len(runs)
    assert rs.launches_by_body["wgmma"] - before["wgmma"] == len(runs)
    assert rs._POOLS.made == made
    got = rs._launch(a, b, body="mma")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


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
@pytest.mark.parametrize("splits", [None, 2, 3, 4])
def test_flash_wgmma_verify_column_bitwise_sequential(cuda, splits):
    """Speculative decoding's bitwise property at the kernel: at Qwen3-8B's
    world-1 serve-step shape (4 x 64 rows, T 1024, 32 / 8 heads), a verify
    row's column j (positions p..p+63, kv_len p + 64) is bitwise column 0
    of the sequential step at position p + j (positions p+j..p+j+63,
    kv_len p + j + 64), its query and the keys the same, for j = 0..4 and
    rows whose row tiles' live ends cross a key tile within j = 0..4
    (their key-tile counts, and so the old contiguous split boundaries,
    differ between the two calls), every split count forced and the
    plan's. The split-KV items take their key tiles
    strided, a tile's split a function of its index alone (the design
    comment in csrc/flash_prefill.cu)."""
    b, s, t, hq, hkv = 4, 64, 1024, 32, 8
    q, k, v, _, _ = _fp_case(320, b, s, t, hq, hkv, [0] * b)
    extra = torch.from_numpy(_inputs(321, b, 8, t, hq, hkv, 128)[0]).to(
        "cuda", torch.bfloat16)
    q_ext = torch.cat([q, extra], 1)  # columns past the verify row's 64
    # a row tile holds 32 positions, so its live end is p + j + 32: for
    # p = 286, 606 and 925 it crosses a 64-key tile within j = 0..4
    start = torch.tensor([286, 606, 60, 925], device="cuda",
                         dtype=torch.int32)
    cols = torch.arange(s, device="cuda", dtype=torch.int32)

    def call(qq, p):
        return fp._launch(qq.contiguous(), k, v,
                          (p[:, None] + cols).contiguous(), 0,
                          (p + s).contiguous(), True, None, body="wgmma",
                          splits=splits)

    ver = call(q, start)
    for j in range(5):
        seq = call(q_ext[:, j:j + s], start + j)
        torch.cuda.synchronize()
        assert torch.equal(seq[:, 0], ver[:, j]), j


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
    (n, E) sizes, one row a rank (EP). Band: one bf16 ulp of the largest
    output plus 1e-5 of it, and the epsilon band of the out dtype (an f32
    out_dtype takes the grouped_gemm_f32 kernel: `_grouped_mm`'s bf16
    result widened fell outside the f32 band)."""
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
    got = gg.grouped_gemm(per_rank, w, per, out_dtype=out_dtype)
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
    the output and 2 MiB (the grouped_gemm_f32 kernel walks the groups
    in place; blocks padded to the hot expert for every expert would
    need 15.5 GB)."""
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
    out_bytes = n * t * nn * 4
    print(f"grouped_gemm f32 out, hot expert 3686 of {t} rows: peak "
          f"{peak / 2**20:.1f} MiB beyond the inputs (output "
          f"{out_bytes / 2**20:.1f} MiB)")
    assert peak <= out_bytes + (2 << 20), peak
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
# remote fold must trap (argv: "0" the mma.sync form at D = 64, which
# prints the wait; "1" the wgmma form at D = 128, which traps without a
# word)
_SP_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import flash_prefill as fp
wgmma = int(sys.argv[1])
n, B, S, Hq, Hkv, D = 2, 1, 64, 4, 2, 128 if wgmma else 64
lib = _build.load("flash_prefill", fp._SIGNATURES)
q = torch.ones((n, B, S, Hq, D), device="cuda", dtype=torch.bfloat16)
k = torch.ones((n, B, S, Hkv, D), device="cuda", dtype=torch.bfloat16)
kv_len = torch.full((B,), n * S, device="cuda", dtype=torch.int32)
out = torch.empty_like(q)
kbuf = torch.empty((n, n - 1, B, S, Hkv, D), device="cuda",
                   dtype=torch.bfloat16)
flags = torch.zeros((n, fp._sp_flag_words(n, B)), device="cuda",
                    dtype=torch.int32)
flags[:, :2 * (n - 1) * B] = -1000
grid = _build.GridInfo()
err = lib.fp_sp_launch(q.data_ptr(), k.data_ptr(), k.data_ptr(),
                       kv_len.data_ptr(), out.data_ptr(), kbuf.data_ptr(),
                       kbuf.data_ptr(), flags.data_ptr(), flags.shape[1], n,
                       B, S, Hq, Hkv, D, 1, 1, 0.125, wgmma, -1, 0,
                       grid.ptr(), torch.cuda.current_stream().cuda_stream)
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
    ("sp_flash_prefill", _SP_FAULT, ["0"]),
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
                                        (_AG_FAULT, "2"), (_SP_FAULT, "1")],
                         ids=["gemm_rs", "ag_gemm-wgmma", "ag_gemm-grouped",
                              "sp_flash_prefill-wgmma"])
def test_gemm_rs_wgmma_protocol_fault_traps_without_a_word(cuda, script,
                                                           arg):
    """The wgmma bodies (gemm_rs's; ag_gemm's dense and grouped; the SP
    flash prefill's, whose segment flags start far below zero) over
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
    sched = schedule_graph(g, blocks=132 // world)
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
    of decode_resident, run eagerly (`cuda_graph=False`; the captured
    step is test_mega_replay_bitwise_eager's)."""
    from triton_dist_tpu_torch.mega import MegaQwen3

    from triton_dist_tpu_torch.models import ModelConfig

    cfg = ModelConfig.tiny(dtype="bfloat16", max_positions=64,
                           head_dim=64, num_q_heads=8, num_kv_heads=4)
    mega = MegaQwen3(cfg, world=world, batch=4, s_max=64, device="cuda",
                     cuda_graph=False)
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


def _drop_hints(sched, tids):
    """The schedule with consumers `tids` made cold: their issuers' hint
    columns cleared, each listed in the plan's `cold`."""
    plan = sched.prefetch
    for tid in tids:
        issuer = sched.order[int(sched.pos[tid]) - 1]
        plan.issue_code[issuer] = plan.issue_layer[issuer] = 0
        plan.issue_slot[issuer] = plan.consume[tid] = 0
        plan.cold.append(tid)
    return sched


def _mega_case(g, world, dtype, depth, tiled, cold=0, seed=0, blocks=None):
    """Compile g at `depth` (None: auto_pf_depth, the arena's 2 slots)
    for `blocks` blocks a rank (an H100's share by default) with the
    gate|up-like weights tile-major (or not), `cold` of its fed consumers
    made cold, launch it once against run_plain on the same inputs; each
    output slot within 1e-4 (f32) or two bf16 ulps of its largest value,
    and the fed / cold rows of the queue the kernel read the plan's.
    Returns the compiled queue."""
    from triton_dist_tpu_torch.mega.core import MAX_PF_DEPTH
    from triton_dist_tpu_torch.mega.kernel import (
        compile_graph,
        tile_weight_major,
    )
    from triton_dist_tpu_torch.mega.scheduler import (
        schedule_graph,
        validate_schedule,
    )

    blocks = blocks or 132 // world
    sched = schedule_graph(g, pf_depth=depth, blocks=blocks)
    _drop_hints(sched, sched.prefetch.fed()[:cold])
    validate_schedule(g, sched)
    names = sorted({t.branch_key[1] for t in g.tasks if t.op == "matmul"})
    tiles = [n for n in names if "gu" in n] if tiled else []
    cm = compile_graph(g, sched, dtype, blocks=blocks, world=world,
                       tiled_weights=tuple(tiles))
    assert cm.pf_depth == (depth or MAX_PF_DEPTH)
    rowmajor = compile_graph(g, sched, dtype, blocks=blocks, world=world)
    rng = np.random.default_rng(seed)
    weights, plain_w = {}, {}
    for name in names:
        K, N = cm.w_geom[name][:2]
        w = torch.from_numpy(rng.standard_normal(
            (2, world, K, N)).astype(np.float32) * 0.05).to("cuda", dtype)
        plain_w[name] = w
        weights[name] = (tile_weight_major(w, cm.tile_cols(name))
                         if name in tiles else w)
    H = g.buffers[0].width
    norms = 1.0 + torch.from_numpy(rng.standard_normal(
        (7, cm.norm_width)).astype(np.float32) * 0.1).cuda()
    D, s_max = 64, 64
    rope = torch.from_numpy(rng.standard_normal((s_max + 1, D)).astype(
        np.float32) * 0.7).cuda()
    pool = torch.from_numpy(rng.standard_normal(
        (2, world * 2, cm.pb, s_max, D)).astype(np.float32) * 0.5).to(
        "cuda", dtype)
    table = torch.arange(cm.pb, dtype=torch.int32, device="cuda")[:, None]
    pos = torch.tensor([0, 7, 33, 63][:cm.pb], dtype=torch.int32,
                       device="cuda")
    ws = cm.workspace("cuda")
    ws[:, 0, :, :H] = torch.from_numpy(rng.standard_normal(
        (cm.pb, H)).astype(np.float32)).to("cuda", dtype)
    args = (pos, table, ws, weights, norms, rope, pool, pool)
    want = rowmajor.run_plain(pos, table, ws.clone(), plain_w, *args[4:])
    assert torch.equal(want, cm.run_plain(pos, table, ws.clone(), weights,
                                          *args[4:]))
    got = cm.run(*args)
    torch.cuda.synchronize()
    read = cm.queue_counts(cm.queue_on(ws.device).cpu().numpy())
    assert read == cm.plan_counts(), (read, cm.plan_counts())
    for s in range(got.shape[1]):
        w = want[:, s].float()
        err = (got[:, s].float() - w).abs().max().item()
        atol = (1e-4 if dtype == torch.float32
                else 2 * 2.0 ** -7 * w.abs().max().item() + 1e-6)
        assert err <= atol, (s, err, atol)
    return cm


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("depth", [1, None])
@pytest.mark.parametrize("tiled", [False, True])
def test_mega_prefetch_branches_match_plain(cuda, world, depth, tiled):
    """branch_graph (every branch, a matmul after each kind of row) on
    the prefetching kernel at arena depth 1 and auto (2), gate|up weights
    tile-major or row-major, two of its consumers made cold, the rest fed:
    bf16 within two ulps of run_plain, the fed / cold rows the plan's."""
    from triton_dist_tpu_torch.mega.builder import branch_graph

    g = branch_graph(world, 4, 256, 512, 4, 2, 64, 64)
    cm = _mega_case(g, world, torch.bfloat16, depth, tiled, cold=2,
                    seed=world)
    fed, cold = cm.plan_counts()
    assert fed >= 3 and cold == 2


def _matmul_chain(layers, world, h=2048, inter=4096):
    """2 * layers matmuls in one chain of edges, the first of them queue
    row 0 at world 1: rms + w_gu of x, then silu + w_dn of that, then
    the next layer's rms + w_gu of x again (an edge, not data, orders it
    after), each output in a slot of its own, so no rounding carries
    further than one product into the next. At these widths a tile
    streams 8 to 32 stages, past the ring's 6."""
    from triton_dist_tpu_torch.mega.builder import ModelBuilder

    mb = ModelBuilder(4, world=world)
    x = mb.buffer(h, "x", pinned=True)
    for layer in range(layers):
        gu = mb.make_rms_matmul("w_gu", layer % 2, x, h, 2 * inter,
                                layer % 2, 1e-6)
        mb.make_act_matmul("w_dn", layer % 2, gu, inter, h)
    g = mb.graph
    for a, b in zip(g.tasks, g.tasks[1:]):
        g._edge(a.id, b.id)
    for buf in g.buffers:
        g.pinned[buf.id] = True
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, None])
@pytest.mark.parametrize("tiled", [False, True])
def test_mega_prefetch_chain_reuses_every_slot(cuda, dtype, depth, tiled):
    """Ten matmuls back to back: the first opens cold (queue row 0), the
    others are fed, and every arena slot is filled and read again; at
    depth 1 each matmul reads the one slot and then refills it for the
    next (the issue after the row's own read)."""
    g = _matmul_chain(5, 1)
    cm = _mega_case(g, 1, dtype, depth, tiled)
    plan = cm.prefetch
    fed = plan.fed()
    assert plan.cold == [g.tasks[0].id] and len(fed) == 9
    slots = [int(plan.consume[t]) - 1 for t in fed]
    assert all(slots.count(s) >= 2 for s in range(plan.depth))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, None])
@pytest.mark.parametrize("tiled", [False, True])
def test_mega_prefetch_many_tiles_a_block(cuda, depth, tiled):
    """The chain on 5 blocks a rank, so each block takes several tiles of
    a matmul row: only its first is fed from the arena, the next tile's
    stages stream into the ring behind the current one's (the same row's
    next tile, then the next row's first), bf16 within two ulps of
    run_plain and the fed / cold rows the plan's."""
    g = _matmul_chain(5, 1, h=1024, inter=2048)
    cm = _mega_case(g, 1, torch.bfloat16, depth, tiled, blocks=5)
    assert all(int(r[7]) > 2 * cm.blocks for r in cm.queue)


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


# phase 4s's valid lengths a (rank, row) at its last decode step: world
# 4, batch 4, T_loc 8192, kv_len (32752, 24570, 16380, 8190) + 16
_SP_STEP_LENS = (8192, 8192, 8192, 8192, 8192, 8192, 8192, 14,
                 8192, 8192, 12, 0, 8192, 10, 0, 0)


def _decode_inputs(seed, b, t, heads, dtype=torch.bfloat16):
    hq, hkv, d = heads
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("lens,t", [
    ((0, 1, 37, 300, 700, 1100, 129, 16), 1100),
    (_SP_STEP_LENS, 8192),
    ((5, 0, 130, 1), 300),  # fewer live tiles than persistent groups
], ids=["ragged", "phase-4s", "short"])
def test_flash_decode_mma_body_matches_plain(cuda, lens, t):
    """The Hopper body (bf16, D = 128) at Qwen3-8B's heads: valid lengths
    0, 1, inside a tile, across tiles and splits, a full shard, T not a
    multiple of a tile (1100 keys); phase 4s's 16 (rank, row) lengths
    over 8192-key shards; fewer live tiles than groups. o and lse within
    1e-5 of the plain version and in the f32 epsilon band, an empty row
    o = 0 and lse = NEG_INF, a second call bitwise the first (the splits
    merge in split order, whoever finishes last), one "mma" launch a
    call."""
    before = dict(fd.launches_by_body)
    q, k, v = _decode_inputs(30 + len(lens), len(lens), t, (32, 8, 128))
    valid = torch.tensor(lens, device="cuda", dtype=torch.int32)
    o, lse = fd.flash_decode_partial_cuda(q, k, v, valid)
    want_o, want_lse = fd.flash_decode_partial(q, k, v, valid)
    again = fd.flash_decode_partial_cuda(q, k, v, valid)
    torch.cuda.synchronize()
    live = valid > 0
    torch.testing.assert_close(o, want_o, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse[live], want_lse[live], rtol=0, atol=1e-5)
    assert torch.all(o[~live] == 0)
    assert torch.all(lse[~live] == fd.NEG_INF)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    band(want_o, o, "flash_decode_partial")
    band(want_lse[live], lse[live], "flash_decode_partial")
    assert fd.launches_by_body["mma"] - before["mma"] == 2
    assert fd.launches_by_body["fma"] == before["fma"]


@pytest.mark.cuda
def test_flash_decode_bodies_by_form(cuda):
    """launches_by_body: bf16 at D = 128 takes the Hopper body, f32 and
    D = 64 the FMA body; the main path's wrapper call counts one launch
    either way."""
    before = dict(fd.launches_by_body)
    reset_launches()
    for heads, dtype in (((32, 8, 128), torch.bfloat16),
                         ((32, 8, 128), torch.float32),
                         ((4, 2, 64), torch.bfloat16)):
        q, k, v = _decode_inputs(7, 2, 100, heads, dtype)
        fd.flash_decode_partial_cuda(q, k, v, torch.tensor([50, 100]))
    torch.cuda.synchronize()
    got = {b: fd.launches_by_body[b] - before[b] for b in before}
    assert got == {"mma": 1, "fma": 2}, got
    assert launches()["flash_decode_partial"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("heads,dtype", [((32, 8, 128), torch.bfloat16),
                                         ((4, 2, 64), torch.float32)],
                         ids=["mma", "fma"])
def test_flash_decode_warm_calls_allocate_only_outputs(cuda, heads, dtype):
    """A warm call with int32 lengths on the card allocates o and lse and
    nothing else (the merge slots and counters persist in fd._POOLS, no
    memset); after 20 back-to-back calls every counter of every pool
    reads zero, no warm call made a pool, and the result is bitwise the
    first call's."""
    lens = (8192, 9, 0, 4000) if dtype == torch.bfloat16 else (9, 0, 400)
    t = max(lens)
    q, k, v = _decode_inputs(11, len(lens), t, heads, dtype)
    valid = torch.tensor(lens, device="cuda", dtype=torch.int32)
    first = fd.flash_decode_partial_cuda(q, k, v, valid)
    torch.cuda.synchronize()
    made = fd._POOLS.made
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(20):
        got = fd.flash_decode_partial_cuda(q, k, v, valid)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    assert allocs == 2 * 20, allocs
    assert fd._POOLS.made == made
    assert all(int(c.count_nonzero()) == 0
               for _, c in fd._POOLS.entries.values())
    assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])


@pytest.mark.cuda
def test_flash_decode_slots_match_the_work_plan(cuda):
    """The kernel's merge slots (fd_tc_part_floats) are the host plan's
    (work_plan) times a state's floats, on this card's SMs."""
    from triton_dist_tpu_torch.kernels import _build

    lib = _build.load("flash_decode", fd._SIGNATURES)
    hq, hkv, d, g = 32, 8, 128, 4
    sms = _build.card_sms(torch.device("cuda"))
    for lens, t in ((_SP_STEP_LENS, 8192), ((0, 1, 1100), 1100)):
        plan, slots = fd.work_plan(lens, t, hkv, sms)
        got = lib.fd_tc_part_floats(len(lens), hq, hkv, fd._groups(hkv, sms))
        assert got == slots * (g * d + 2 * g), (got, slots)


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
@pytest.mark.parametrize("fmt", [None, "fp8", "int8", ("int8", 128, False)],
                         ids=["native", "fp8", "int8", "int8-block128"])
def test_ll_all_gather_keeps_the_context_bitwise(cuda, n, fmt):
    """Ten calls on one context through the kernel at the wrapper's grid
    (a block a peer): every gathered copy bitwise x gathered, the
    context's slots and parity flags bitwise a plain twin's after each
    call. On a quantized wire the calls move the int8 images of the SP
    decode payload (the wrapper's pack) through the same kernel; the
    wrapper's own wire call then matches the roundtrip."""
    from triton_dist_tpu_torch import wire

    rng = np.random.default_rng(40 + n)
    shape = (4, 4224)
    f = None if fmt is None else _wire_fmt(fmt)
    ctx = llag.create_ll_ag_buffer(shape, torch.float32, n, wire_format=f,
                                   device="cuda")
    twin = llag.create_ll_ag_buffer(shape, torch.float32, n, wire_format=f,
                                    device="cuda")
    for call in range(10):
        x = _payload(rng, n, shape, torch.float32)
        if f is not None:
            x = wire.pack(x.reshape(-1, shape[-1]), f).reshape(
                n, shape[0], -1)
        got = llag._launch(x, ctx, call)
        llag.ll_all_gather_plain(x, twin, call)
        torch.cuda.synchronize()
        assert torch.equal(got, x[None].expand(n, *x.shape)), call
        assert torch.equal(ctx.data, twin.data), call
        assert torch.equal(ctx.flags[:, :2 * n], twin.flags[:, :2 * n]), call
    if f is not None:
        x = _payload(rng, n, shape, torch.float32)
        got, _ = llag.ll_all_gather(x, ctx, 10, wire_format=f)
        rt = wire.roundtrip(x.reshape(-1, shape[-1]), f).reshape(x.shape)
        assert torch.equal(got, rt[None].expand(n, *x.shape))


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


def _sp_case(seed, n, b, s, hq, hkv, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((n, b, s, hq, d))).to(
        "cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((n, b, s, hkv, d))).to(
        "cuda", dtype) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sp_flash_prefill_wgmma_form_matches_plain(cuda, n, causal):
    """The SP kernel's TMA + wgmma form (bf16, D = 128, Qwen3-8B's GQA
    group of 4, S a multiple of 64) against flash_prefill_ref: a ragged
    batch whose first row's kv_len ends inside a key tile of the last
    rank's segment, one row ending at a shard boundary, one empty. Keys
    past kv_len hold NaN (never live: neither in the scores nor in P V).
    Within two bf16 ulps of the largest output and inside the
    flash_prefill band; then bitwise itself with each rank's pushers
    delayed 2 ms in turn (the fold order does not follow arrival). Every
    launch takes the wgmma form."""
    hq, hkv, d, b, s = 32, 8, 128, 3, 128
    q, k, v = _sp_case(40 + n, n, b, s, hq, hkv, d)
    kv_len = torch.tensor([n * s - 37, s, 0], device="cuda",
                          dtype=torch.int32)
    assert fp._sp_plan(s, hq, hkv, d, q.dtype) == "wgmma"
    want = fp.flash_prefill_ref(q, k, v, causal=causal, kv_len=kv_len)
    pos = torch.arange(n * s, device="cuda").reshape(n, 1, s)
    dead = (pos >= kv_len.long()[None, :, None]).expand(n, b, s)
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[dead] = float("nan")
    v_nan[dead] = float("nan")
    before = dict(fp.sp_launches_by_body)
    got = fp.sp_flash_prefill(q, k_nan, v_nan, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    atol = 2 * 2.0 ** -7 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    band(want, got, "flash_prefill")
    assert torch.all(got[:, 2] == 0)
    for rank in range(n):
        late = fp.sp_flash_prefill(q, k_nan, v_nan, causal=causal,
                                   kv_len=kv_len, straggler=(rank, 2_000_000))
        torch.cuda.synchronize()
        assert torch.equal(late, got), rank
    assert fp.sp_launches_by_body["wgmma"] - before["wgmma"] == 1 + n
    assert fp.sp_launches_by_body["mma"] == before["mma"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sp_flash_prefill_pool_stays_zero_back_to_back(cuda, n):
    """Both SP forms over one persistent flag pool a (device, stream, n,
    B): the wgmma form (bf16, D = 128, S = 128), and the mma.sync form at
    a ragged S (100) and at D = 64, causal and not, one rank's pushers
    delayed every third call, 24 calls launched back to back with no
    synchronisation. Each result is bitwise its case's first run (the
    first runs held to flash_prefill_ref in the band); then every pool
    word reads zero, no call past the first made a pool, each launch took
    the form `_sp_plan` names, and the kernel refuses a pool row shorter
    than `_sp_flag_words`."""
    from triton_dist_tpu_torch.kernels import _build

    lib = _build.load("flash_prefill", fp._SIGNATURES)
    b = 2
    cases = []
    for i, (s, (hq, hkv, d)) in enumerate([(128, (32, 8, 128)),
                                          (100, (32, 8, 128)),
                                          (128, (4, 2, 64))]):
        q, k, v = _sp_case(60 + i, n, b, s, hq, hkv, d)
        kv_len = torch.tensor([n * s - 5, s + 3], device="cuda",
                              dtype=torch.int32)
        for causal in (True, False):
            first = fp.sp_flash_prefill(q, k, v, causal=causal,
                                        kv_len=kv_len)
            want = fp.flash_prefill_ref(q, k, v, causal=causal,
                                        kv_len=kv_len)
            torch.cuda.synchronize()
            band(want, first, "flash_prefill")
            cases.append((q, k, v, kv_len, causal, first,
                          fp._sp_plan(s, hq, hkv, d, q.dtype)))
    assert [c[-1] for c in cases] == ["wgmma"] * 2 + ["mma"] * 4
    made = fp._SP_POOLS.made
    before = dict(fp.sp_launches_by_body)
    runs = []
    for i in range(24):
        q, k, v, kv_len, causal, first, form = cases[i % len(cases)]
        late = (i // 3 % n, 1_000_000) if i % 3 == 2 else None
        runs.append((i, first, fp.sp_flash_prefill(
            q, k, v, causal=causal, kv_len=kv_len, straggler=late)))
    torch.cuda.synchronize()
    for i, first, got in runs:
        assert torch.equal(got, first), i
    assert fp._SP_POOLS.made == made
    for key, flags in fp._SP_POOLS.entries.items():
        assert flags.shape == (key[2], fp._sp_flag_words(key[2], key[3]))
        assert int(flags.count_nonzero()) == 0, key
    assert fp.sp_launches_by_body["wgmma"] - before["wgmma"] == 8
    assert fp.sp_launches_by_body["mma"] - before["mma"] == 16
    # a pool row one word short of _sp_flag_words is refused, not launched
    q, k, v, kv_len, causal, first, _ = cases[0]
    words = fp._sp_flag_words(n, b) - 1
    short = torch.zeros((n, words), device="cuda", dtype=torch.int32)
    out = torch.empty_like(q)
    s, hq, hkv, d = q.shape[2], q.shape[3], k.shape[3], q.shape[4]
    for wgmma in (1, 0):
        err = lib.fp_sp_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), out.data_ptr(), out.data_ptr(), short.data_ptr(),
            words, n, b, s, hq, hkv, d, 1, 1, 0.125, wgmma, -1, 0,
            _build.GridInfo().ptr(), _build.raw_stream(q.device))
        assert err != 0, wgmma


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
@pytest.mark.parametrize("n", [2, 3, 4])
def test_full_mesh_all_gather_back_to_back_leaves_the_pool_at_zero(cuda, n):
    """The full mesh's persistent delivery pool: 50 calls launched back to
    back with no synchronisation, in turn over a chunk that is not a
    multiple of 16 bytes (70 bytes), 1 MiB of bf16 a rank and 4 MiB (the largest grid: every pool word of a source), every
    fifth call with one rank delayed 2 ms (each rank in turn); then every
    result bitwise its plain version, every pool word at zero and no pool
    made after the first call."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather as ag

    rng = np.random.default_rng(40 + n)
    shapes = [(5, 7), (128, 4096), (512, 4096)]
    xs = [_payload(rng, n, shape, torch.bfloat16) for shape in shapes]
    assert ag._fm_blocks_for(n, 512 * 4096 * 2) == ag._FM_MAX_BLOCKS \
        or n < 4
    runs, made, grids = [], None, []
    for i in range(50):
        x = xs[i % len(xs)]
        late = (i // 5 % n, 2_000_000) if i % 5 == 4 else None
        grid = _build.GridInfo()
        runs.append((i, x, late, ag._launch_fm(x, late, grid=grid)))
        grids.append(grid.per_rank)
        if made is None:
            made = ag._FM_POOLS.made
    torch.cuda.synchronize()
    for i, x, late, got in runs:
        assert torch.equal(got, ag.full_mesh_all_gather_plain(x)), (
            i, tuple(x.shape), late)
    assert all(1 <= g <= ag._FM_MAX_BLOCKS for g in grids)
    assert ag._FM_POOLS.made == made
    for key, flags in ag._FM_POOLS.entries.items():
        assert flags.shape == (key[2], key[2] * ag._FM_MAX_BLOCKS)
        assert not bool(flags.any())


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
@pytest.mark.parametrize("body", [None, "reg", "bulk"],
                         ids=["wrapper", "reg", "bulk"])
def test_p2p_send_back_to_back_leaves_the_pool_at_zero(cuda, n, body):
    """p2p_send's persistent delivery pool: every (src, dst) pair, each
    with no rank and then each rank delayed 2 ms, over a payload that is
    not a multiple of 16 bytes (register body only), the 4 MiB PP
    handoff and 8 MiB a rank (the largest grid, capped at the pool's
    words), all launched back to back with no synchronisation between
    them; then every result bitwise its plain version, every pool word
    at zero and no pool made after the first call."""
    from triton_dist_tpu_torch.kernels import _build, p2p

    rng = np.random.default_rng(30 + n)
    shapes = [(512, 4096), (1024, 4096)]
    if body != "bulk":
        shapes.insert(0, (5, 7))
    runs, made = [], None
    for shape in shapes:
        x = _payload(rng, n, shape, torch.bfloat16)
        grid = _build.GridInfo()
        for src in range(n):
            for dst in range(n):
                for late in [None, *range(n)]:
                    straggler = None if late is None else (late, 2_000_000)
                    got = p2p._launch_p2p(x, src, dst, straggler, body=body,
                                          grid=grid)
                    runs.append((x, src, dst, late, got))
                    if made is None:
                        made = p2p._POOLS.made
        if shape[0] >= 512:  # 4 MiB a rank and more take every pool word
            assert p2p._blocks_for(x[0].numel() * 2) == p2p._MAX_BLOCKS
        assert 1 <= grid.per_rank <= p2p._MAX_BLOCKS
    torch.cuda.synchronize()
    for x, src, dst, late, got in runs:
        assert torch.equal(got, p2p.p2p_send_plain(x, src, dst)), (
            tuple(x.shape), src, dst, late)
    assert p2p._POOLS.made == made
    for flags in p2p._POOLS.entries.values():
        assert flags.shape[1] == p2p._MAX_BLOCKS
        assert not bool(flags.any())


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
# satisfies: the delivery words start far below zero (ring_shift's
# barrier word at zero; the pools of p2p_send and the full mesh have no
# barrier word, one delivery word a (source,) block), so the first wait
# for an arrival must trap
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
    flags = torch.full((n, n * ag._FM_MAX_BLOCKS), -1000, device="cuda",
                       dtype=torch.int32)
    err = lib.fm_ag_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                           ag._FM_MAX_BLOCKS, n, nbytes, -1, 0, 2,
                           grid.ptr(), st)
else:
    lib = _build.load("p2p", p2p._SIGNATURES)
    out = torch.empty_like(x)
    if kernel == "p2p_send":
        flags = torch.full((n, p2p._MAX_BLOCKS), -1000, device="cuda",
                           dtype=torch.int32)
        err = lib.p2p_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                             p2p._MAX_BLOCKS, n, nbytes, 0, 3, -1, 0, 2, 0,
                             grid.ptr(), st)
    else:
        flags = torch.full((n, lib.p2p_flag_words()), -1000, device="cuda",
                           dtype=torch.int32)
        flags[:, 0] = 0
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
    The partials come from the wgmma body (launches_by_body), within
    1e-5 of torch.matmul in f32; teacher-forced, the ring's result is
    bitwise the plain fold of the kernel's own f32 partials; end to end
    it is within the epsilon band's cosine of the plain version (the
    partial GEMM's order may flip a quantization step at a hop: that
    element moves by one step, beyond the band's ulp bound, which is
    printed); the native out_dtype=float32 within 1e-5 relative. Arrival
    order too."""
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
    before = dict(grs.launches_by_body)
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
    # every partial GEMM (m = 64 a rank, K 1024, N 512) took the wgmma body
    took = {k2: v - before[k2] for k2, v in grs.launches_by_body.items()
            if v != before[k2]}
    assert took == {"wgmma": 2 * 6}, took
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
    ragged row count; the native out_dtype=float32 too. m 128 and m 64
    at K 4096, N 1536 (phase 4w's QKV widths, more than one tile of BN)
    take the dequantizing wgmma body, m 1 and 37 the mma.sync body
    (launches_by_body); the mma.sync body forced on the wgmma cases'
    inputs is held to the same plain version."""
    from triton_dist_tpu_torch import wire
    from triton_dist_tpu_torch.kernels import allgather_gemm as ag

    rng = np.random.default_rng(170 + n)
    reset_launches()
    calls = 0
    for m, k, nn in ((128, 1024, 384), (64, 4096, 1536), (1, 512, 256),
                     (37, 256, 128)):
        a = (torch.from_numpy(rng.standard_normal((n, m, k))) * 0.1).to(
            "cuda", torch.bfloat16)
        b = (torch.from_numpy(rng.standard_normal((n, k, nn))) * 0.05).to(
            "cuda", torch.bfloat16)
        body = "mma" if m % 64 else "wgmma"
        for order in ("rank", "arrival"):
            for out in (torch.bfloat16, torch.float32):
                want = ag_gemm_plain(a, b, None, order, out_dtype=out,
                                     wire_format=kind)
                rt = wire.roundtrip(a.reshape(n * m, k), kind)
                runs = [lambda: ag_gemm(a, b, return_gathered=True,
                                        force_kernel=True, c_order=order,
                                        out_dtype=out, wire_format=kind)]
                if body == "wgmma":
                    runs.append(lambda: ag._launch_wire(
                        a, b, wire.resolve(kind), order == "arrival", True,
                        out, body="mma"))
                for i, run in enumerate(runs):
                    before = dict(ag.launches_by_body)
                    got, full = run()
                    calls += 1
                    torch.cuda.synchronize()
                    took = {k2: v - before[k2] for k2, v in
                            ag.launches_by_body.items() if v != before[k2]}
                    assert took == {body if i == 0 else "mma": 1}, (m, took)
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


# -- CUDA graphs of the steps (runtime/graphs.py) ---------------------------


def _graph_of(fn):
    from triton_dist_tpu_torch.runtime.graphs import StepGraph

    return StepGraph(lambda commit: fn(), "cuda")


@pytest.mark.cuda
def test_cooperative_launch_under_capture(cuda):
    """The world-4 collective kernels (cooperative launches, every block
    co-resident) and the GEMM kernels with flag pools, persistent or
    fresh a call, captured in one CUDA graph: each replay on new inputs
    copied into the static ones is bitwise the eager calls on them, and
    a replay counts the launches its capture recorded."""
    rng = np.random.default_rng(3)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            "cuda", torch.bfloat16)

    x, shard, big = rand(4, 4, 4096), rand(4, 128, 2048), rand(4, 512, 2048)
    a, w_qkv = rand(4, 64, 4096), rand(4, 4096, 1536, scale=0.02)
    o, w_o = rand(4, 256, 1024), rand(4, 1024, 4096, scale=0.02)

    def calls():
        return (one_shot_all_reduce(x), ring_all_gather(shard),
                ring_reduce_scatter(big), ag_gemm(a, w_qkv), gemm_rs(o, w_o))

    g = _graph_of(calls)
    for _ in range(3):
        for t in (x, shard, big, a, o):
            t.copy_(rand(*t.shape))
        reset_launches()
        got = g.replay()
        assert launches()["one_shot_all_reduce"] == 1
        assert launches()["ag_gemm"] == 1 and launches()["gemm_rs"] == 1
        want = calls()
        torch.cuda.synchronize()
        for gt, wt in zip(got, want):
            assert torch.equal(gt, wt)
        assert torch.equal(got[0], one_shot_all_reduce_plain(x))


@pytest.mark.cuda
def test_graph_outlives_pool_eviction(cuda):
    """A graph keeps the pool entries its capture took: after more than
    POOL_ENTRIES other one-shot AllReduce configurations evict its entry
    from the cache, its replays stay bitwise the plain fold."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allreduce as ar

    x = torch.randn(4, 4, 4096, device="cuda").bfloat16()
    g = _graph_of(lambda: one_shot_all_reduce(x))
    for m in range(1, _build.POOL_ENTRIES + 3):
        one_shot_all_reduce(torch.randn(4, m, 512, device="cuda").bfloat16())
    assert len(ar._POOLS.entries) == _build.POOL_ENTRIES
    for _ in range(3):
        x.copy_(torch.randn_like(x, dtype=torch.float32))
        got = g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, one_shot_all_reduce_plain(x))


def _tiny_bf16(moe=False):
    from triton_dist_tpu_torch.models import ModelConfig

    preset = ModelConfig.tiny_moe if moe else ModelConfig.tiny
    return preset(dtype="bfloat16", head_dim=128, num_q_heads=8,
                  num_kv_heads=4, max_positions=128)


def _engines(world, moe=False, **kw):
    """The same weights on a graph-replaying and an eager Engine."""
    from triton_dist_tpu_torch.models import Engine
    from triton_dist_tpu_torch.models.dense import init_params

    cfg = _tiny_bf16(moe)
    params = init_params(cfg, device="cuda", seed=4, world=world)
    return (Engine(cfg, device="cuda", params=params, world=world, **kw),
            Engine(cfg, device="cuda", params=params, world=world,
                   cuda_graph=False, **kw))


def _clone_cache(c):
    from triton_dist_tpu_torch.models import KVCache

    return KVCache(c.k.clone(), c.v.clone(), c.length.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("world,moe,mode", [
    (1, False, "ar"), (4, False, "ar"), (4, False, "dist"),
    (4, True, "ar"), (4, True, "dist")],
    ids=["dense-w1", "dense-w4-ar", "dense-w4-dist", "moe-w4-ar",
         "moe-w4-dist"])
def test_decode_replay_bitwise_eager(cuda, world, moe, mode):
    """decode_step and generate (greedy, then sampled by the JAX key
    chain) replayed from a captured step against the eager Engine from
    the same state: logits, tokens and the cache after bitwise;
    the cache's length advanced in place. Then a fresh cache of the same
    shape replays the same graphs (no capture), and the first cache,
    taken up again after it, goes on bitwise the eager one."""
    graph, eager = _engines(world, moe, decode_mode=mode)
    ids = torch.randint(0, 256, (4, 9), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    logits, c0 = eager.prefill(ids)
    tok = logits.argmax(-1)
    ca, cb = _clone_cache(c0), _clone_cache(c0)
    la, ca = graph.decode_step(tok, ca)
    lb, cb = eager.decode_step(tok, cb)
    assert torch.equal(la, lb) and ca.length.tolist() == [10] * 4
    ta, ca = graph.generate(la.argmax(-1), ca, 5)
    tb, cb = eager.generate(lb.argmax(-1), cb, 5)
    assert torch.equal(ta, tb)
    ta, ca = graph.generate(ta[:, -1], ca, 4, temperature=0.8,
                            key=seed_key(9))
    tb, cb = eager.generate(tb[:, -1], cb, 4, temperature=0.8,
                            key=seed_key(9))
    assert torch.equal(ta, tb)
    for x, y in ((ca.k, cb.k), (ca.v, cb.v), (ca.length, cb.length)):
        assert torch.equal(x, y)
    assert graph.decode_graphs.made == 2  # greedy, sampled
    cc, cd = _clone_cache(c0), _clone_cache(c0)
    tc, cc = graph.generate(tok, cc, 3)
    td, cd = eager.generate(tok, cd, 3)
    ta, ca = graph.generate(ta[:, -1], ca, 2)
    tb, cb = eager.generate(tb[:, -1], cb, 2)
    assert torch.equal(tc, td) and torch.equal(ta, tb)
    for x, y in ((ca.k, cb.k), (ca.v, cb.v), (ca.length, cb.length),
                 (cc.k, cd.k), (cc.v, cd.v), (cc.length, cd.length)):
        assert torch.equal(x, y)
    assert graph.decode_graphs.made == 2


@pytest.mark.cuda
@pytest.mark.parametrize("world,moe,mode", [
    (1, False, "ar"), (4, False, "dist"), (4, True, "dist")],
    ids=["dense-w1", "dense-w4-dist", "moe-w4-dist"])
def test_serve_step_replay_bitwise_eager(cuda, world, moe, mode):
    """A Scheduler on the graph-replaying Engine and one on the eager
    Engine, the same requests (greedy and sampled): every request's
    tokens bitwise; a second Scheduler on the graph-replaying Engine (a
    fresh pool) the same tokens again, one capture for both runs."""
    from triton_dist_tpu_torch.serve import Scheduler

    graph, eager = _engines(world, moe, decode_mode=mode)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 45, 9, 33)]
    outs = []
    for eng in (graph, eager, graph):
        sch = Scheduler(eng, slots=4, chunk=16, page=16)
        reqs = [sch.submit(p, 6, temperature=0.7 if i % 2 else 0.0, seed=i)
                for i, p in enumerate(prompts)]
        sch.run()
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1] == outs[2]
    assert graph.serve_graphs.made == 1


@pytest.mark.cuda
@pytest.mark.parametrize("world,paged", [(1, False), (4, False), (1, True)])
def test_mega_replay_bitwise_eager(cuda, world, paged):
    """MegaQwen3.decode_step and decode_resident replayed from the
    captured step against the eager step from the same cache (dense, and
    paged with pages claimed on the way): logits, tokens and the cache
    (its length and allocator head advanced in place) bitwise; a fresh
    cache of the same shape replays the same graph, bitwise too."""
    from triton_dist_tpu_torch.mega import MegaQwen3
    from triton_dist_tpu_torch.models import ModelConfig
    from triton_dist_tpu_torch.models.dense import init_params

    cfg = ModelConfig.tiny(dtype="bfloat16", max_positions=64,
                           head_dim=64, num_q_heads=8, num_kv_heads=4)
    params = init_params(cfg, device="cuda", seed=5, world=world)
    kw = dict(world=world, batch=4, s_max=64, params=params, device="cuda")
    if paged:
        kw.update(paged=True, page_size=16)
    graph, eager = MegaQwen3(cfg, **kw), MegaQwen3(cfg, cuda_graph=False, **kw)
    cache = graph.new_paged_cache() if paged else graph.new_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    if paged:
        cache.table.copy_(torch.arange(16, device="cuda").reshape(4, 4))
        cache.next_free.fill_(16)
        cache = cache._replace(k=torch.cat([cache.k, cache.k], 2),
                               v=torch.cat([cache.v, cache.v], 2))
    cache.length.copy_(torch.tensor([5, 0, 16, 31]))
    ca = type(cache)(*(t.clone() for t in cache))
    cb = type(cache)(*(t.clone() for t in cache))
    tok = torch.tensor([3, 7, 11, 200], device="cuda")
    la, ca = graph.decode_step(tok, ca)
    lb, cb = eager.decode_step(tok, cb)
    assert torch.equal(la, lb)
    ia, ca = graph.decode_resident(la.argmax(-1), ca, 4)
    ib, cb = eager.decode_resident(lb.argmax(-1), cb, 4)
    assert torch.equal(ia, ib)
    for x, y in zip(ca, cb):
        assert torch.equal(x, y)
    assert ca.length.tolist() == [10, 5, 21, 36]
    cc = type(cache)(*(t.clone() for t in cache))
    cd = type(cache)(*(t.clone() for t in cache))
    ic, cc = graph.decode_resident(tok, cc, 3)
    id_, cd = eager.decode_resident(tok, cd, 3)
    assert torch.equal(ic, id_)
    for x, y in zip(cc, cd):
        assert torch.equal(x, y)
    assert graph.graphs.made == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode", "skew", "sizes-a-rank",
                                  "shared-x"])
def test_grouped_gemm_f32_kernel_matches_plain(cuda, case):
    """The hand grouped f32 kernel at the Qwen3-30B-A3B down product
    (E 128, K 192 a rank at world 4, N 2048): a decode step's 32 rows a
    rank (batch 4, top-8), a skewed routing with empty experts and rows
    past the last group, (n, E) sizes, one x for every rank; against the
    loop over experts within one bf16 ulp of the largest output plus
    1e-5 of it, and the f32 epsilon band; the tail rows zero; one launch,
    no host read (the sizes stay on the card)."""
    rng = np.random.default_rng(
        ["decode", "skew", "sizes-a-rank", "shared-x"].index(case))
    n, e, k, nn = 4, 128, 192, 2048
    t = 32 if case == "decode" else 700
    if case == "decode":
        sizes = np.bincount(rng.choice(e, t), minlength=e)
    elif case == "skew":
        sizes = np.zeros(e, np.int64)
        sizes[[3, 64, 127]] = [500, 1, 130]  # 631 of 700 rows
    else:
        sizes = np.stack([np.bincount(rng.choice(e, t - 17 * r), minlength=e)
                          for r in range(n)])
    sz = torch.from_numpy(sizes).to("cuda", torch.int32)
    x = torch.from_numpy(rng.standard_normal(
        (t, k) if case == "shared-x" else (n, t, k))).to("cuda",
                                                         torch.bfloat16)
    w = (torch.randn((n, e, k, nn), device="cuda") * 0.05).bfloat16()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gg.grouped_gemm_f32(x, w, sz)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = gg.grouped_gemm_plain(x, w, sz, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert launches()["grouped_gemm_f32"] == 1
    top = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2.0 ** -7 * top + 1e-5 * max(1.0, top))
    band(want, got, "grouped_gemm")
    used = np.broadcast_to(sizes, (n, e)).sum(-1)
    for r in range(n):
        assert not got[r, int(used[r]):].any()


@pytest.mark.cuda
def test_moe_replay_makes_no_host_sync(cuda):
    """A replay of the MoE decode step (world 4, `ar` and `dist`) under
    torch.cuda.set_sync_debug_mode("error"): no host sync anywhere on the
    step, the grouped f32 down product included."""
    for mode in ("ar", "dist"):
        graph, _ = _engines(4, moe=True, decode_mode=mode)
        ids = torch.randint(0, 256, (4, 8), device="cuda")
        logits, cache = graph.prefill(ids)
        tok = logits.argmax(-1)
        graph.generate(tok, cache, 1)  # the capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, cache = graph.generate(tok, cache, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert out.shape == (4, 3)


# ---------- the resident loop's kernels and window ----


@pytest.mark.cuda
@pytest.mark.parametrize("V,R", [(151936, 4), (1000, 6), (151936, 1),
                                 (300, 3), (7, 2), (5000, 200),
                                 (151936, 256), (151936, 20)])
def test_sample_slots_kernel_matches_plain(cuda, V, R):
    """sample_slots (csrc/sample.cu) against its plain version: tokens
    equal, the split's next keys and every sampled row's random bits
    bitwise (chip_smoke.check_sample_kernel: greedy and sampled rows, a
    key a row and one flat draw, split and not), rows split over 1 to
    264 blocks."""
    import chip_smoke

    assert chip_smoke.check_sample_kernel(V, R=R) == 3 * 4 * R


@pytest.mark.cuda
def test_sample_slots_ties_take_the_lowest_index(cuda):
    """Greedy rows whose largest value repeats across the blocks a row is
    split over: the lowest index wins, as the plain version's argmax."""
    from triton_dist_tpu_torch.kernels import sample as ks

    R, V = 4, 151936
    logits = torch.zeros((R, V), device="cuda")
    for r, at in enumerate(([0, V - 1], [5000, 90000, 140000],
                            [V - 2, V - 1], [77])):
        logits[r, at] = 2.0
    keys = torch.zeros((R, 2), dtype=torch.int32, device="cuda")
    temps = torch.zeros((R,), device="cuda")
    got = ks.sample_slots(logits, keys, temps)
    assert got.tolist() == [0, 5000, V - 2, 77]
    assert torch.equal(got.cpu(), ks.sample_slots_plain(
        logits.cpu(), keys.cpu(), temps.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("K,C,maxp", [(3, 4, 8), (4, 64, 16), (64, 2, 2)])
def test_ring_kernels_match_plain(cuda, K, C, maxp):
    """ring_boundary and ring_emit (csrc/ring.cu) bitwise their plain
    versions on 300 random window states (chip_smoke.check_ring_kernels:
    the boundary, the emit after it, the final boundary; the block and
    every step buffer), 64 slots included."""
    import chip_smoke
    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    cap, prompt_cap, window = 16, 24, 6
    geo = kring.WindowGeometry(K, C, maxp, window * K + cap, window, 4)
    rw = mring.ring_width(maxp, prompt_cap, C)
    assert chip_smoke.check_ring_kernels([], geo, cap, rw, 256,
                                         n_random=300) == 300


@pytest.mark.cuda
@pytest.mark.parametrize("K,C,maxp,spec_k", [(3, 6, 8, 4), (4, 64, 16, 4),
                                             (64, 8, 2, 7), (2, 2, 4, 1)])
def test_ring_kernels_spec_forms_match_plain(cuda, K, C, maxp, spec_k):
    """The speculative-decoding forms of ring_boundary and ring_emit
    (spec_k > 0: verify rows from staged records, a key a column, the
    accept / eos / budget epilogue and its records j outer, slot inner)
    bitwise their plain versions on 300 random window states whose slots
    hold fresh and stale verify records (chip_smoke.check_ring_kernels;
    the step's (K, C) tokens accept a draft where they echo the fed
    tokens), 64 slots included."""
    import chip_smoke
    from triton_dist_tpu_torch.kernels import ring as kring
    from triton_dist_tpu_torch.mega import ring as mring

    cap, prompt_cap, window = 16, 24, 6
    geo = kring.WindowGeometry(K, C, maxp, window * K * (1 + spec_k) + cap,
                               window, 4, spec_k)
    rw = mring.ring_width(maxp, prompt_cap, C)
    assert chip_smoke.check_ring_kernels([], geo, cap, rw, 256,
                                         n_random=300) == 300


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_spec_scheduler_bitwise_spec_off_on_card(cuda, world):
    """Scheduler(spec=SpecConfig(k=4)) on the card, host loop (the
    per-position step replayed) and resident windows of 4 (the kernels'
    spec forms in the window graph), against the eager spec-off host
    loop: every stream bitwise, greedy and sampled, drafts proposed and
    accepted, the pool whole; world 1 and 4 `ar`."""
    from triton_dist_tpu_torch.serve import Scheduler
    from triton_dist_tpu_torch.spec import SpecConfig

    graph, eager = _engines(world, decode_mode="ar")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 8, n).tolist() for n in (20, 45, 9, 33, 12)]
    outs = []
    for eng, kw in ((eager, {}), (graph, dict(spec=SpecConfig(k=4))),
                    (eager, dict(spec=SpecConfig(k=4))),
                    (graph, dict(spec=SpecConfig(k=4), resident=True,
                                 window=4))):
        sch = Scheduler(eng, slots=4, chunk=16, page=16, **kw)
        reqs = [sch.submit(p, 12, temperature=0.7 if i % 2 else 0.0, seed=i)
                for i, p in enumerate(prompts)]
        sch.run()
        outs.append([r.out_tokens for r in reqs])
        sch.pool.check()
        if "spec" in kw:
            assert sch.metrics()["spec_proposed"] > 0
    assert outs[0] == outs[1] == outs[2] == outs[3]


@pytest.mark.cuda
@pytest.mark.parametrize("world,mode", [(1, "ar"), (4, "ar"), (4, "dist")])
def test_resident_window_bitwise_host_loop(cuda, world, mode):
    """Scheduler(resident=True) on the graph-replaying Engine (a window of
    up to 4 steps a replay) and on the eager Engine (the same steps run
    eagerly), against the host loop: every request's tokens bitwise,
    greedy and sampled; one loop for two resident runs; one read a
    window."""
    from triton_dist_tpu_torch.serve import Scheduler

    graph, eager = _engines(world, decode_mode=mode)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 45, 9, 33, 12)]
    outs = []
    for eng, resident in ((eager, False), (graph, True), (eager, True),
                          (graph, True)):
        sch = Scheduler(eng, slots=4, chunk=16, page=16, resident=resident,
                        **({"window": 4} if resident else {}))
        reqs = [sch.submit(p, 6, temperature=0.7 if i % 2 else 0.0, seed=i)
                for i, p in enumerate(prompts)]
        sch.run()
        outs.append([r.out_tokens for r in reqs])
        if resident:
            assert sch.worker.n_reads == sch.worker.n_windows
    assert outs[0] == outs[1] == outs[2] == outs[3]
    loops = list(graph.resident_loops.values())
    assert len(loops) == 1 and loops[0].graphs


@pytest.mark.cuda
@pytest.mark.parametrize("world,mode", [(1, "ar"), (4, "ar")])
def test_prefix_hits_bitwise_cold_on_card(cuda, world, mode):
    """The prefix cache on the card: a shared 32-token prefix, request 0
    alone, then four more behind it (two sampled); the cache off on the
    eager and the graph-replaying Engine, then on (block 16) in the
    replayed host loop and in resident windows of 4: every stream bitwise
    the eager cold run's, each later request a hit of 32 tokens, the pool
    and trie invariants after each run."""
    from triton_dist_tpu_torch.serve import Scheduler

    graph, eager = _engines(world, decode_mode=mode)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 256, 32).tolist()
    prompts = [prefix + rng.integers(0, 256, n).tolist()
               for n in (5, 17, 9, 30, 1)]
    cache = dict(prefix_cache=True, prefix_block=16)
    outs = []
    for eng, kw in ((eager, {}), (graph, {}), (graph, cache),
                    (graph, dict(cache, resident=True, window=4))):
        sch = Scheduler(eng, slots=4, chunk=16, page=16, **kw)
        reqs = [sch.submit(prompts[0], 6)]
        sch.run()
        reqs += [sch.submit(p, 6, temperature=0.7 if i % 2 else 0.0, seed=i)
                 for i, p in enumerate(prompts[1:], 1)]
        sch.run()
        outs.append([r.out_tokens for r in reqs])
        sch.pool.check()
        if kw:
            sch.prefix.check()
            assert [r.prefix_len for r in reqs] == [0, 32, 32, 32, 32]
            assert sch.metrics()["prefix_hits"] == 4
    assert outs[0] == outs[1] == outs[2] == outs[3]


@pytest.mark.cuda
def test_donate_cache_false_replay_leaves_the_cache(cuda):
    """Fault 3.7 on the card: a graph-replaying Engine with
    donate_cache=False steps a copy, so one cache stepped twice from its
    state gives bitwise the same logits, and stays bitwise as it was
    (never a view of the graph's state)."""
    from triton_dist_tpu_torch.models import Engine

    graph, _ = _engines(1)
    keep = Engine(graph.cfg, device="cuda", params=graph.params,
                  donate_cache=False)
    ids = torch.randint(0, 256, (4, 9), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
    logits, cache = keep.prefill(ids)
    tok = logits.argmax(-1)
    snap = _clone_cache(cache)
    la, ca = keep.decode_step(tok, cache)
    lb, cb = keep.decode_step(tok, cache)
    assert torch.equal(la, lb) and keep.decode_graphs.made == 1
    for x, y in ((snap.k, cache.k), (snap.v, cache.v),
                 (snap.length, cache.length)):
        assert torch.equal(x, y)
    assert ca.length.tolist() == [10] * 4 and cb is not cache


@pytest.mark.cuda
def test_serve_key_chain_replay_bitwise_eager(cuda):
    """Engine.serve sampled by the JAX key chain (the decode graph splits
    the key on the card) against the eager Engine: tokens bitwise, two
    seeds."""
    graph, eager = _engines(1)
    ids = torch.randint(0, 256, (4, 9), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    for seed in (0, 7):
        a = graph.serve(ids, 6, temperature=0.8, seed=seed)
        b = eager.serve(ids, 6, temperature=0.8, seed=seed)
        assert torch.equal(a, b)


# -- the steps captured through graphs.compiled -----------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("world,moe,mode", [
    (1, False, "ar"), (4, False, "ar"), (4, False, "dist"),
    (4, True, "dist"), (4, True, "fused")],
    ids=["dense-w1", "dense-w4-ar", "dense-w4-dist", "moe-w4-dist",
         "moe-w4-fused"])
def test_prefill_replay_bitwise_eager(cuda, world, moe, mode):
    """Engine.prefill captured (its first call of a shape) and replayed
    against the eager Engine on the same prompts: logits and the cache
    (k, v, the new length) bitwise, on a fresh cache and as a second
    chunk onto a filled one; a second fresh cache of a known shape
    captures nothing (one graph a (batch, prompt length, cache shape));
    the prefill's cache goes on into generate bitwise the eager one, the
    prefill and decode graphs on one shared state."""
    graph, eager = _engines(world, moe, prefill_mode=mode)
    g = torch.Generator("cuda").manual_seed(6)
    ids = torch.randint(0, 256, (4, 16), device="cuda", generator=g)
    more = torch.randint(0, 256, (4, 8), device="cuda", generator=g)
    for round_ in range(3):  # capture, replay, replay on a fresh cache
        la, ca = graph.prefill(ids)
        lb, cb = eager.prefill(ids)
        assert torch.equal(la, lb), round_
        for x, y in ((ca.k, cb.k), (ca.v, cb.v), (ca.length, cb.length)):
            assert torch.equal(x, y), round_
        la, ca = graph.prefill(more, ca)
        lb, cb = eager.prefill(more, cb)
        assert torch.equal(la, lb) and torch.equal(ca.k, cb.k), round_
        assert ca.length.tolist() == [24] * 4
    assert graph.prefill_graphs.made == 2  # 4 x 16, then 4 x 8
    ta, ca = graph.generate(la.argmax(-1), ca, 4)
    tb, cb = eager.generate(lb.argmax(-1), cb, 4)
    assert torch.equal(ta, tb) and torch.equal(ca.v, cb.v)
    assert len(graph.cache_states) == 1


@pytest.mark.cuda
def test_prefill_donate_cache_false_replay_leaves_the_cache(cuda):
    """Fault 3.8 on the card: a graph-replaying Engine with
    donate_cache=False prefills a copy; prefill A on cache C, prefill B on
    C, decode on A's cache: C bitwise as it was, the decode's logits
    bitwise the eager Engine's on the same sequence."""
    from triton_dist_tpu_torch.models import Engine

    graph, eager = _engines(1)
    keep = Engine(graph.cfg, device="cuda", params=graph.params,
                  donate_cache=False)
    g = torch.Generator("cuda").manual_seed(8)
    a, b = (torch.randint(0, 256, (4, 9), device="cuda", generator=g)
            for _ in range(2))
    c = keep.new_cache(4)
    snap = _clone_cache(c)
    la, c1 = keep.prefill(a, c)
    keep.prefill(b, c)
    keep.prefill(b, c)  # the replay
    for x, y in ((snap.k, c.k), (snap.v, c.v), (snap.length, c.length)):
        assert torch.equal(x, y)
    got, _ = keep.decode_step(la.argmax(-1), c1)
    lb, cb = eager.prefill(a)
    want, _ = eager.decode_step(lb.argmax(-1), cb)
    assert torch.equal(got, want) and keep.prefill_graphs.made == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ll_all_gather_device_count_bitwise_plain(cuda, n):
    """The LL kernel with its call count an int32 device word, calls 0-5
    on one context: each gathered copy, the context's slots and flag
    words bitwise a plain twin fed the same tensor; the count is read,
    not changed; an int-count context in step with it bitwise too."""
    rows, cols = 4, 4224
    ctx, twin, ints = (llag.create_ll_ag_buffer((rows, cols), torch.float32,
                                                n, device="cuda")
                       for _ in range(3))
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    for k in range(6):
        x = torch.randn(n, rows, cols, device="cuda")
        reset_launches()
        got, _ = llag.ll_all_gather(x, ctx, count)
        assert launches()["ll_all_gather"] == 1
        want = llag.ll_all_gather_plain(x, twin, count)
        by_int, _ = llag.ll_all_gather(x, ints, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, by_int), k
        assert torch.equal(ctx.data, twin.data), k
        assert torch.equal(ctx.flags[:, :2 * n], twin.flags[:, :2 * n]), k
        assert torch.equal(ctx.flags, ints.flags), k
        assert count.item() == k
        count.add_(1)


def _sp_decode_case(n=4, b=2, t_loc=512, h=256, heads=(8, 2, 128)):
    from triton_dist_tpu_torch.layers import rope_table
    from triton_dist_tpu_torch.layers.sp_flash_decode import (
        SpDecodeParams,
        SpDecodeSpec,
    )

    hq, hkv, d = heads
    g = torch.Generator("cuda").manual_seed(11)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).bfloat16()

    params = SpDecodeParams(t(h, (hq + 2 * hkv) * d, scale=0.05),
                            t(hq * d, h, scale=0.05))
    cos, sin = rope_table(d, n * t_loc + 32, device="cuda")
    cache = (t(n, b, t_loc, hkv, d), t(n, b, t_loc, hkv, d))
    xs = t(12, b, h)
    return params, SpDecodeSpec(hq, hkv, d), cos, sin, cache, xs


@pytest.mark.cuda
def test_sp_decode_replay_bitwise_eager(cuda):
    """compiled_sp_decode_step: its first call eager (and captured), then
    replays, against the eager step on a copy of the same state, 12 steps
    at n = 4 (a kv_len near a shard's end, one mid-shard): every output,
    the cache, kv_len, the count and the LL context bitwise; after each
    replay the count reads step + 1 and the context's flags of that
    step's parity read the count (its call + 1). A second state of the
    same shape (a fresh context, count 0) replays the same graph."""
    from triton_dist_tpu_torch.kernels.flash_decode import (
        create_sp_decode_buf,
    )
    from triton_dist_tpu_torch.layers.sp_flash_decode import (
        compiled_sp_decode_step,
        sp_decode_step,
    )

    n = 4
    params, spec, cos, sin, cache, xs = _sp_decode_case(n)
    b, hq, d = xs.shape[1], spec.num_q_heads, spec.head_dim

    def state():
        return ([c.clone() for c in cache],
                torch.tensor([509, 1300], device="cuda"),
                create_sp_decode_buf(b, hq, d, n, device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"))

    step = compiled_sp_decode_step()
    for trial in range(2):
        (ka, va), la, xa, ca = state()
        (kb, vb), lb, xb, cb = state()
        for i in range(xs.shape[0]):
            x = xs[i].expand(n, *xs[i].shape)
            ya = step(x, params, spec, cos, sin, (ka, va), la, xa, ca)
            yb = sp_decode_step(x, params, spec, cos, sin, (kb, vb), lb, xb,
                                cb)
            torch.cuda.synchronize()
            assert torch.equal(ya, yb), (trial, i)
            assert ca.item() == i + 1 and cb.item() == i + 1
            p = i % 2
            assert bool(xa.flags[:, p * n:(p + 1) * n].eq(i + 1).all()), i
        for x, y in ((ka, kb), (va, vb), (la, lb), (xa.data, xb.data),
                     (xa.flags, xb.flags)):
            assert torch.equal(x, y), trial
    assert step.graphs.made == 1


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "overlap"])
def test_ep_layer_replay_bitwise_eager(cuda, overlap):
    """ep_moe_fwd through graphs.compiled (weights static), its first call
    eager and captured, then replays on new tokens copied into the
    graph's: output and drops bitwise the eager layer's, a tight
    capacity dropping pairs; a replay counts the A2A launches its capture
    recorded."""
    from triton_dist_tpu_torch.layers.ep_moe import ep_moe_fwd
    from triton_dist_tpu_torch.runtime.graphs import compiled

    x, p = _ep_case(4, 32, 256, 16, 64, torch.bfloat16)
    kw = dict(capacity=24, return_drops=True)
    if overlap:
        kw.update(overlap=True, n_chunks=2)
    layer = compiled(ep_moe_fwd, static=("params",))
    name = "all_to_all_chunked" if overlap else "all_to_all"
    for i in range(3):
        xi = x if i == 0 else torch.randn_like(x)
        reset_launches()
        got, drops = layer(xi, p, 4, **kw)
        assert launches()[name] == 2
        want, want_d = ep_moe_fwd(xi, p, 4, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(drops, want_d), i
        assert int(drops.sum()) > 0
    assert layer.graphs.made == 1


@pytest.mark.cuda
def test_pp_schedule_replay_bitwise_eager(cuda):
    """pp_schedule_fwd through graphs.compiled (comm and stage function
    static): the 7-tick schedule over a tiny bf16 model's 4 stages as one
    graph, its replays on new microbatches bitwise the eager schedule,
    seven ring_shift launches a replay (each with its fresh flag pool's
    memset recorded)."""
    from triton_dist_tpu_torch.layers import PPCommOp, pp_schedule_fwd
    from triton_dist_tpu_torch.models import ModelConfig, pp_stage_fn
    from triton_dist_tpu_torch.models.dense import init_params
    from triton_dist_tpu_torch.runtime.graphs import compiled

    cfg = ModelConfig.tiny(num_layers=4, dtype="bfloat16", head_dim=64)
    params = init_params(cfg, device="cuda", seed=0)
    comm, fn = PPCommOp(4), pp_stage_fn(cfg, params, 4)
    sched = compiled(pp_schedule_fwd, static=("comm", "stage_fn"))
    g = torch.Generator("cuda").manual_seed(2)
    for i in range(3):
        ids = torch.randint(0, cfg.vocab_size, (4, 32), device="cuda",
                            generator=g)
        mbs = params.embed[ids]
        x = mbs.expand(4, *mbs.shape)
        reset_launches()
        got = sched(comm, fn, x, 4)
        assert launches()["ring_shift"] == 7
        want = pp_schedule_fwd(comm, fn, x, 4)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
    assert sched.graphs.made == 1

"""The port's fused AllGather + GEMM (triton_dist_tpu_torch.kernels.
ag_gemm) and gemm_rs in arrival order against the JAX package's.

On the CPU each wrapper runs its plain version. The JAX functions run
under `jax.shard_map` on a mesh of n in {2, 4} devices cut from the 12
virtual CPU devices, their Pallas kernels in interpret mode (each test
asserts the JAX kernel ran). Same numpy inputs for both; the port's
tensors are rank-stacked (rank r's shard is [r]); the JAX C of rank r is
column block r of the global (n*m, n*N) output.

Tolerance 1e-5 in f32: the products and the silu run in f32 in both,
with sums in another order (K = 64, values ~1). The CUDA kernel itself
runs only on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import ag_gemm as jax_ag_gemm
from triton_dist_tpu.kernels import allgather_gemm as jax_allgather_gemm
from triton_dist_tpu.kernels import gemm_rs as jax_gemm_rs
from triton_dist_tpu.layers import tp_mlp as jax_tp_mlp
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.kernels import (
    ag_gemm,
    ag_gemm_plain,
    arrival_to_rank_order,
    gemm_rs,
    gemm_rs_plain,
    launches,
    reset_launches,
)
from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.kernels import allgather_gemm as ag

ATOL = 1e-5
M_LOC, K, N_LOC = 8, 64, 128


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax(fn, n, *args, in_specs, out_specs):
    """fn per device under shard_map on an n-device mesh; numpy results.
    Asserts that the JAX side ran its Pallas kernel (interpret mode)."""
    before = pallas_call_count()
    mesh = make_mesh(mesh_shape=(n,), axis_names=("tp",))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))(*args)
    assert pallas_call_count() > before, "the JAX kernel did not run"
    return jax.tree.map(np.asarray, out)


def _rank_blocks(c, n):
    """The JAX global (n*m, n*N) -> rank-stacked (n, n*m, N)."""
    return np.stack(np.split(c, n, axis=1))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c_order", ["rank", "arrival"])
@pytest.mark.parametrize("epilogue", [None, "silu_pair"])
def test_ag_gemm_matches_jax(n, c_order, epilogue):
    """Plain and silu_pair, both C orders, n = 2 and 4 (at n = 2 the
    arrival permutation is its own inverse; n = 4 tells a wrong slot)."""
    a = _rand(n, n, M_LOC, K)
    ws = [_rand(10 + n + h, n, K, N_LOC, scale=0.15) for h in range(2)]
    pair = epilogue == "silu_pair"

    def fn(a_s, *b_s):
        return jax_ag_gemm(a_s, tuple(b_s) if pair else b_s[0], axis="tp",
                           epilogue=epilogue, c_order=c_order,
                           force_kernel=True)

    wcat = [np.concatenate(list(w), axis=1) for w in ws]  # (K, n*N)
    want = _jax(fn, n, a.reshape(n * M_LOC, K), *wcat[:1 + pair],
                in_specs=(P("tp"),) + (P(None, "tp"),) * (1 + pair),
                out_specs=P(None, "tp"))
    assert jax_allgather_gemm.last_launch()["path"] == "pallas"
    b = tuple(torch.from_numpy(w) for w in ws)
    got = ag_gemm(torch.from_numpy(a), b if pair else b[0],
                  epilogue=epilogue, c_order=c_order)
    assert got.shape == (n, n * M_LOC, N_LOC)
    np.testing.assert_allclose(got.numpy(), _rank_blocks(want, n), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ag_gemm_return_gathered_matches_jax(n):
    a = _rand(20 + n, n, M_LOC, K)
    b = _rand(30 + n, n, K, N_LOC, scale=0.15)

    def fn(a_s, b_s):
        return jax_ag_gemm(a_s, b_s, axis="tp", return_gathered=True,
                           force_kernel=True)

    c, full = _jax(fn, n, a.reshape(n * M_LOC, K),
                   np.concatenate(list(b), axis=1),
                   in_specs=(P("tp"), P(None, "tp")),
                   out_specs=(P(None, "tp"), P()))
    got_c, got_full = ag_gemm(torch.from_numpy(a), torch.from_numpy(b),
                              return_gathered=True)
    np.testing.assert_allclose(got_c.numpy(), _rank_blocks(c, n), rtol=0,
                               atol=ATOL)
    for r in range(n):  # the gathered A moves data only: bitwise
        np.testing.assert_array_equal(got_full[r].numpy(), full)


@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_arrival_matches_jax(n):
    """A in arrival order: gemm_rs reads chunk c of rank r from block
    (r - c) mod n. Against the JAX kernel on the same arrival-order A,
    and against the rank-order call on the permuted A."""
    m, k_loc, w = 16, 32, 128
    a = _rand(40 + n, n, m, k_loc)
    b = _rand(50 + n, n, k_loc, w, scale=0.1)

    def fn(a_s, b_s):
        return jax_gemm_rs(a_s, b_s, axis="tp", a_order="arrival",
                           force_kernel=True)

    want = _jax(fn, n, np.concatenate(list(a), axis=1),
                b.reshape(n * k_loc, w),
                in_specs=(P(None, "tp"), P("tp", None)), out_specs=P("tp"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = gemm_rs(ta, tb, a_order="arrival")
    np.testing.assert_allclose(got.numpy(), want.reshape(n, m // n, w),
                               rtol=0, atol=ATOL)
    assert torch.equal(got, gemm_rs(arrival_to_rank_order(ta), tb))
    assert torch.equal(gemm_rs_plain(ta, tb, "arrival"), got)


def test_ag_gemm_gemm_rs_chain_matches_jax_tp_mlp_dist():
    """ag_gemm(silu_pair, arrival) -> gemm_rs(arrival), the `dist` MLP,
    against the JAX tp_mlp_dist_fwd at n = 4."""
    n, h, i_l = 4, 64, 32
    x = _rand(60, n, M_LOC, h)
    wg, wu = _rand(61, n, h, i_l, scale=0.2), _rand(62, n, h, i_l, scale=0.2)
    wd = _rand(63, n, i_l, h, scale=0.2)

    def fn(x_s, wg_s, wu_s, wd_s):
        return jax_tp_mlp.tp_mlp_dist_fwd(
            x_s, jax_tp_mlp.TPMLPParams(wg_s[0], wu_s[0], wd_s[0]),
            axis="tp")

    want = _jax(fn, n, x.reshape(n * M_LOC, h), wg, wu, wd,
                in_specs=(P("tp"),) * 4, out_specs=P("tp"))
    act = ag_gemm(torch.from_numpy(x),
                  (torch.from_numpy(wg), torch.from_numpy(wu)),
                  epilogue="silu_pair", c_order="arrival")
    got = gemm_rs(act, torch.from_numpy(wd), a_order="arrival")
    np.testing.assert_allclose(got.numpy().reshape(n * M_LOC, h), want,
                               rtol=0, atol=ATOL)


def test_arrival_order_is_its_own_inverse():
    """Row block s of rank r holds chunk (r - s) mod n; applying the
    permutation twice gives the rank order back."""
    n, m = 4, 2
    c = torch.arange(n)[:, None].expand(n, n * m) * 10 + (
        torch.arange(n * m) // m)[None]  # rank * 10 + chunk
    arr = arrival_to_rank_order(c)
    for r in range(n):
        assert arr[r].reshape(n, m)[:, 0].tolist() == [
            r * 10 + (r - s) % n for s in range(n)]
    assert torch.equal(arrival_to_rank_order(arr), c)


def test_ag_gemm_world_one():
    """n = 1: a local product (gate and up through silu_mul for the
    pair); force_kernel takes the kernel's path, whose plain version on
    the CPU computes the same function."""
    a = torch.from_numpy(_rand(70, 1, 5, 16))
    wg, wu = (torch.from_numpy(_rand(71 + i, 1, 16, 8)) for i in range(2))
    assert torch.equal(ag_gemm(a, wg), a @ wg)
    _, full = ag_gemm(a, wg, return_gathered=True)
    assert torch.equal(full, a)
    pair = ag_gemm(a, (wg, wu), epilogue="silu_pair")
    torch.testing.assert_close(pair, ag.silu_mul(a @ wg, a @ wu), rtol=0,
                               atol=1e-6)
    for kw in (dict(b=wg), dict(b=(wg, wu), epilogue="silu_pair")):
        torch.testing.assert_close(ag_gemm(a, force_kernel=True, **kw),
                                   ag_gemm(a, **kw), rtol=0, atol=1e-6)


def test_ag_gemm_plain_is_the_gathered_product():
    n, m = 3, 2
    a = torch.from_numpy(_rand(80, n, m, 16)).bfloat16()
    b = torch.from_numpy(_rand(81, n, 16, 8)).bfloat16()
    full = a.reshape(n * m, 16).float()
    want = torch.stack([(full @ b[r].float()).bfloat16() for r in range(n)])
    assert torch.equal(ag_gemm_plain(a, b), want)
    assert torch.equal(ag_gemm(a, b), want)


def test_ag_gemm_refusals_and_cpu_launcher():
    """What the JAX function refuses raises (the quantized wire needs K a
    multiple of 128); out_dtype rounds the f32 product once; the launcher
    refuses a CPU tensor rather than give way; CPU calls count no
    launch."""
    a, b = torch.zeros(2, 4, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="lane-aligned K"):
        ag_gemm(a, b, wire_format="fp8")
    assert torch.equal(ag_gemm(a, b, out_dtype=torch.bfloat16),
                       ag_gemm_plain(a, b).bfloat16())
    with pytest.raises(ValueError, match="equal blocks"):
        ag_gemm(a, torch.zeros(2, 3, 8, 8))  # grouped: 4 rows, 3 experts
    with pytest.raises(ValueError, match="silu_pair"):
        ag_gemm(a, b, epilogue="silu_pair")
    with pytest.raises(ValueError, match="gathered"):
        ag_gemm(a, (b, b), epilogue="silu_pair", return_gathered=True)
    with pytest.raises(ValueError, match="c_order"):
        ag_gemm(a, b, c_order="ring")
    reset_launches()
    ag_gemm(a, b)
    assert launches()["ag_gemm"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ag._launch(a, (b,), False, False)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,body", [
    # the main path's form: dense, native wire, bf16, m % 64 == 0
    ((4, 128, 4096, 1536, 1, None, None), "wgmma"),  # prefill QKV
    ((4, 128, 4096, 3072, 2, None, None), "wgmma"),  # prefill gate|up
    ((4, 64, 4096, 1536, 1, None, None), "wgmma"),  # scheduler step QKV
    ((4, 64, 4096, 3072, 2, None, None), "wgmma"),  # scheduler gate|up
    ((1, 256, 1000, 1000, 1, None, None), "wgmma"),  # K, N ragged
    ((4, 128, 2048, 1280, 1, None, None), "wgmma"),  # Qwen3-30B-A3B QKV
    # every other call keeps the mma.sync body
    ((4, 1, 4096, 1536, 1, None, None), "mma"),  # a dist decode step
    ((4, 37, 4096, 1536, 1, None, None), "mma"),  # ragged m
    ((4, 96, 4096, 1536, 1, None, None), "mma"),  # m not a box multiple
    ((4, 128, 4096, 1536, 1, None, "f32"), "mma"),
    ((4, 128, 4096, 1536, 1, 8, "f32"), "mma"),  # grouped f32 (FMA)
    ((4, 128, 4096, 1536, 1, None, "fp8"), "mma"),  # the wire
    ((4, 128, 32, 1536, 1, None, None), "mma"),  # K under one box
    ((4, 128, 4096, 40, 1, None, None), "mma"),  # N under one box
    # the grouped form in bf16 with counts ("live") takes the
    # expert-major kernel, any cap; without counts the mma.sync body
    ((4, 128, 4096, 1536, 1, 8, "live"), "grouped"),  # cap 16
    ((4, 4 * 48, 256, 192, 2, 4, "live"), "grouped"),  # silu_pair, cap 48
    ((2, 3 * 256, 128, 64, 2, 3, "live"), "grouped"),  # cap 256, N one box
    ((4, 4 * 48, 256, 192, 2, 4, None), "mma"),  # every row live
    ((9, 64, 128, 192, 2, 4, "live"), "mma"),  # past 8 ranks
    ((4, 64, 32, 192, 2, 4, "live"), "mma"),  # K under one box
    ((4, 64, 128, 40, 2, 4, "live"), "mma"),  # N under one box
])
def test_body_for_routes_the_main_path_to_wgmma(case, body):
    """_body_for: the wgmma body serves the dense bf16 native-wire form
    at m a multiple of 64 (a prefill's 128 rows a rank, a scheduler
    step's 64), K and N at least one 64-wide box; the grouped bf16 form
    with counts (the fused MoE up-projection) the expert-major kernel at
    n <= 8, K and N at least one box; wire, f32, ragged or small m, and
    the grouped form without counts keep the mma.sync (or FMA) body."""
    n, m, k, nn, halves, experts, kind = case
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    a = torch.zeros(n, m, k, dtype=dtype)
    shape = (n, experts, k, nn) if experts else (n, k, nn)
    bs = tuple(torch.zeros(*shape, dtype=dtype) for _ in range(halves))
    fmt = wire.resolve("fp8" if kind == "fp8" else None)
    assert ag._body_for(a, bs, fmt, experts is not None,
                        kind == "live") == body


@pytest.mark.parametrize("M,N,n,pair,want", [
    (512, 1536, 4, False, 192),  # prefill QKV: 128 tiles, one wave
    (512, 3072, 4, True, 128),  # prefill gate|up
    (256, 1536, 4, False, 128),  # scheduler step QKV
    (256, 3072, 4, True, 128),  # scheduler step gate|up
    (512, 1280, 4, False, 192),  # Qwen3-30B-A3B QKV: 28 tiles a rank
])
def test_wgmma_bn_minds_wave_quantisation(M, N, n, pair, want):
    """_wgmma_bn: of the candidates, the one whose waves over each rank's
    sms // n blocks times a tile's time (its accumulator columns plus
    _WGMMA_FIXED_COLS) are the fewest, the widest on a tie; the main
    path's picks pinned (the fastest of the sweep at each)."""
    got = ag._wgmma_bn(M, N, n, pair)
    assert got == want
    per = 132 // n

    def cost(bn):
        tiles = -(-M // 128) * -(-N // bn)
        return -(-tiles // per) * (bn * (2 if pair else 1)
                                   + ag._WGMMA_FIXED_COLS)

    cands = ag._WGMMA_BN_PAIR if pair else ag._WGMMA_BN
    assert got in cands and cost(got) == min(cost(b) for b in cands)
    assert got == max(b for b in cands if cost(b) == cost(got))


def test_ag_gemm_straggler_on_the_cpu_route():
    """straggler=(rank, nanos) (the JAX config's straggler_rank /
    straggler_ns) changes nothing on the CPU route; a rank outside the
    world or a negative delay raises as all_to_all's do, and so does a
    straggler on the wire form, whose ring takes none."""
    a = torch.from_numpy(_rand(90, 4, 8, 16))
    b = torch.from_numpy(_rand(91, 4, 16, 24))
    want = ag_gemm(a, b)
    for rank in range(4):
        assert torch.equal(ag_gemm(a, b, straggler=(rank, 5_000_000)), want)
    for bad in ((4, 10), (-1, 10), (0, -1)):
        with pytest.raises(ValueError, match="straggler"):
            ag_gemm(a, b, straggler=bad)
    with pytest.raises(ValueError, match="straggler"):
        ag_gemm(torch.zeros(2, 4, 128), torch.zeros(2, 128, 8),
                wire_format="fp8", straggler=(0, 10))

"""The port's MoE modules (triton_dist_tpu_torch.kernels.moe_utils,
grouped_gemm, reduce_scatter, the grouped form of allgather_gemm, and
layers.tp_moe) against the JAX package's, on the same seeded numpy
inputs.

On the CPU each kernel wrapper runs its plain version. The JAX
collectives run under `jax.shard_map` on a mesh of n in {2, 4} devices
cut from the 12 virtual CPU devices, their Pallas kernels in interpret
mode (each test asserts the JAX kernel ran, not an XLA fallback). The
port's tensors are rank-stacked: rank r's shard is [r].

Tolerances, each stated where it is used: integer routing outputs
equal; f32 routing weights and combines within 1e-6 (softmax and sums
in another order); grouped products within 1e-5 (f32 sums over K in
another order); the ring ReduceScatter bitwise (the same fold, the same
roundings, in f32 and bf16). The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import allgather_gemm as jax_allgather_gemm
from triton_dist_tpu.kernels import moe_utils as jmu
from triton_dist_tpu.kernels.allgather_gemm import ag_gemm as jax_ag_gemm
from triton_dist_tpu.kernels.grouped_gemm import grouped_gemm as jax_gg
from triton_dist_tpu.kernels.reduce_scatter import (
    reduce_scatter as jax_reduce_scatter,
)
from triton_dist_tpu.kernels.reduce_scatter import (
    ring_reduce_scatter as jax_ring_reduce_scatter,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.layers import tp_moe as jax_tp_moe
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.kernels import (
    ag_gemm,
    ag_gemm_plain,
    launches,
    reset_launches,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.kernels import grouped_gemm as gg
from triton_dist_tpu_torch.kernels import moe_utils as mu
from triton_dist_tpu_torch.kernels import reduce_scatter as rs
from triton_dist_tpu_torch.kernels.allgather_group_gemm import capacity_rows
from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd
from triton_dist_tpu_torch.runtime import VirtualWorld

F32_ATOL = 1e-6   # routing weights, combines: f32 in another order
GEMM_ATOL = 1e-5  # f32 products over K <= 128 in another order


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mesh(n):
    return make_mesh(mesh_shape=(n,), axis_names=("tp",))


def _jax(fn, n, *args, in_specs, out_specs=P("tp"), kernel=True):
    """fn per device under shard_map on an n-device mesh; numpy results.
    With kernel=True, asserts that the JAX side ran a Pallas kernel
    (interpret mode), not an XLA-collective fallback."""
    before = pallas_call_count()
    out = jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))(*args)
    if kernel:
        assert pallas_call_count() > before, "the JAX kernel did not run"
    return jax.tree.map(np.asarray, out)


# ---------- routing utilities ----------


def _ids(seed, m, k, e):
    """A routing table whose rows pick k distinct experts, skewed so
    that some experts get no token."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(e - 1, k, replace=False)
                     for _ in range(m)]).astype(np.int32)


def test_topk_routing_matches_jax():
    """Integer ids equal; f32 weights within 1e-6."""
    logits = _rand(1, 24, 16)
    jw, ji = jmu.topk_routing(jnp.asarray(logits), 4)
    tw, ti = mu.topk_routing(torch.from_numpy(logits), 4)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=F32_ATOL)
    # leading rank dims route each rank's rows alike
    bw, bi = mu.topk_routing(torch.from_numpy(logits).reshape(2, 12, 16), 4)
    assert torch.equal(bi.reshape(24, 4), ti)


def test_silu_mul_and_histogram_match_jax():
    h = _rand(2, 6, 2 * 8)
    np.testing.assert_allclose(mu.silu_mul(torch.from_numpy(h)).numpy(),
                               np.asarray(jmu.silu_mul(jnp.asarray(h))),
                               rtol=0, atol=F32_ATOL)
    ids = _ids(3, 20, 3, 8)
    np.testing.assert_array_equal(
        mu.expert_histogram(torch.from_numpy(ids), 8).numpy(),
        np.asarray(jmu.expert_histogram(jnp.asarray(ids), 8)))


def test_sort_by_expert_matches_jax():
    """Every field of the stable sort equal, an unused expert included."""
    ids = _ids(4, 16, 2, 6)
    want = jmu.sort_by_expert(jnp.asarray(ids), 6)
    got = mu.sort_by_expert(torch.from_numpy(ids), 6)
    assert int(got.group_sizes[5]) == 0
    for name in ("sort_idx", "token_idx", "group_sizes", "unsort_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("capacity", [32, 3])
def test_pack_by_expert_matches_jax(capacity):
    """Exact capacity (no drop) and a capacity that drops rows: the
    packed rows bitwise, slot map, counts and drops equal."""
    m, k, e, h = 16, 2, 6, 8
    x, ids = _rand(5, m, h), _ids(6, m, k, e)
    want = jmu.pack_by_expert(jnp.asarray(x), jnp.asarray(ids), e, capacity)
    got = mu.pack_by_expert(torch.from_numpy(x), torch.from_numpy(ids), e,
                            capacity)
    for name in ("x", "slot_of", "counts", "drops"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (int(got.drops) > 0) == (capacity < m * k)


def test_combine_topk_matches_jax():
    """Within 1e-6: an f32 weighted sum over k in another order; leading
    rank dims combine each rank's rows alike."""
    m, k, e, h = 10, 3, 5, 16
    ids = _ids(7, m, k, e)
    wts = np.random.default_rng(8).random((m, k)).astype(np.float32)
    y = _rand(9, m * k, h)
    want = jmu.combine_topk(jnp.asarray(y),
                            jmu.sort_by_expert(jnp.asarray(ids), e),
                            jnp.asarray(wts))
    sort = mu.sort_by_expert(torch.from_numpy(ids), e)
    got = mu.combine_topk(torch.from_numpy(y), sort, torch.from_numpy(wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    two = mu.combine_topk(torch.from_numpy(np.stack([y, 2 * y])), sort,
                          torch.from_numpy(wts))
    torch.testing.assert_close(two[1], 2 * got, rtol=0, atol=F32_ATOL)


# ---------- grouped GEMM ----------


@pytest.mark.parametrize("gs", [[5, 0, 7, 4], [0, 0, 16, 0], [3, 2, 1, 0]],
                         ids=["empty-middle", "one-group", "trailing-rows"])
def test_grouped_gemm_plain_matches_jax(gs):
    """Empty groups, one group, and rows past the last group (zero), the
    JAX ragged_dot within 1e-5; the rank-stacked call equals each
    rank's own call."""
    t, k, nn = 16, 32, 24
    x, w = _rand(10, t, k), _rand(11, 4, k, nn, scale=0.2)
    sizes = np.asarray(gs, np.int32)
    want = np.asarray(jax_gg(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(sizes)))
    got = gg.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GEMM_ATOL)
    assert not got[sum(gs):].any()
    ws = torch.from_numpy(np.stack([w, -w]))
    both = gg.grouped_gemm(torch.from_numpy(x), ws, torch.from_numpy(sizes),
                           out_dtype=torch.float32)
    assert both.shape == (2, t, nn)
    assert torch.equal(both[0], got) and torch.equal(both[1], -got)


def test_expert_chunks_stay_under_the_scratch_budget(monkeypatch):
    """The f32-out card route's expert ranges: consecutive, each padded
    to its own largest group and under the budget, a hot expert alone,
    ranges without rows left out."""
    monkeypatch.setattr(gg, "_SCRATCH_BYTES", 100)
    chunks = gg._expert_chunks([1, 2, 0, 40, 3, 3, 0, 0], row_bytes=2)
    assert chunks == [(0, 3, 2), (3, 4, 40), (4, 8, 3)]
    assert gg._expert_chunks([0, 0, 0], row_bytes=2) == []
    assert gg._expert_chunks([], row_bytes=2) == []


@pytest.mark.parametrize("budget_rows,calls", [
    (60, [2, 2, 1, 1, 3, 3]),  # chunks (0-1, 2, 3-5), a rank at a time
    (1000, [12])],             # one chunk: all ranks in one product
    ids=["three-chunks", "one-chunk"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared-x",
                                                        "per-rank-x"])
def test_expert_rows_matches_plain_under_skew(monkeypatch, shared,
                                              budget_rows, calls):
    """The f32-out card route's gather, chunking and scatter, on the CPU:
    one expert takes most rows, a budget that splits the experts into
    three chunks or keeps them in one, rows past the last group zero;
    within 1e-5 of the loop over experts. `torch.bmm(out_dtype=float32)`
    has no CPU kernel, so the test stands in for it with the f32 product
    of the widened operands (the same values, f32 accumulation)."""
    n, t, k, nn = 2, 60, 32, 24
    sizes = torch.tensor([1, 0, 50, 2, 3, 0])
    x = torch.from_numpy(_rand(12, *((t, k) if shared else (n, t, k))))
    w = torch.from_numpy(_rand(13, n, 6, k, nn, scale=0.2))
    x, w = x.bfloat16(), w.bfloat16()
    bmm, seen = torch.bmm, []

    def bmm_f32(a, b, out_dtype=None):
        assert out_dtype == torch.float32
        seen.append(a.shape[0])
        return bmm(a.float(), b.float())

    monkeypatch.setattr(torch, "bmm", bmm_f32)
    monkeypatch.setattr(gg, "_SCRATCH_BYTES",
                        budget_rows * n * (k * 2 + nn * 4))
    got = gg._expert_rows(x, w, sizes, torch.float32)
    want = gg.grouped_gemm_plain(x, w, sizes, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, t, nn)
    torch.testing.assert_close(got, want, rtol=0, atol=GEMM_ATOL)
    assert not got[:, 56:].any()
    assert seen == calls


# ---------- the ring ReduceScatter (PERF.md row 10) ----------


def _jax_ring_rs(x, n, accum_dtype=None):
    """x (n, n*m, W) rank-stacked numpy -> the JAX ring kernel's
    (n, m, W)."""
    m = x.shape[1] // n
    fn = functools.partial(jax_ring_reduce_scatter, axis="tp",
                           accum_dtype=accum_dtype)
    out = _jax(fn, n, jnp.asarray(x.reshape(n * n * m, -1)),
               in_specs=P("tp"))
    return out.reshape(n, m, -1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype,accum", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "float32")],
    ids=["f32", "bf16", "bf16-acc-f32"])
def test_ring_reduce_scatter_matches_jax_bitwise(n, dtype, accum):
    """The fold around the ring, each add rounded to the accumulation
    dtype: bitwise equal to the JAX Pallas kernel (interpret mode)."""
    m, w = 8, 128
    x32 = _rand(20 + n, n, n * m, w)
    jx = jnp.asarray(x32).astype(dtype)
    want = _jax_ring_rs(np.asarray(jx), n,
                        accum and jnp.dtype(accum))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    got = ring_reduce_scatter(tx, accum_dtype=accum and getattr(torch, accum))
    assert got.dtype == tx.dtype and got.shape == (n, m, w)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want).astype(
                                      jnp.float32)))
    if dtype == "bfloat16" and accum is None and n == 4:
        # bf16 accumulation really rounds at each add: not the f32 fold
        assert not torch.equal(got, ring_reduce_scatter_plain(
            tx, torch.float32))


def test_ring_reduce_scatter_fold_order():
    """Rank c's chunk c is ((x[c+1] + x[c+2]) + ...) + x[c], in bf16."""
    n, m = 3, 2
    x = torch.from_numpy(_rand(30, n, n * m, 4)).bfloat16()
    got = ring_reduce_scatter_plain(x)
    for c in range(n):
        part = [x[r, c * m:(c + 1) * m] for r in range(n)]
        acc = part[(c + 1) % n]
        for j in range(2, n + 1):
            acc = acc + part[(c + j) % n]
        assert torch.equal(got[c], acc)


def test_ring_reduce_scatter_world_one_and_refusals():
    """n = 1: the input unless force_kernel (no ring step, the value
    through the accumulation dtype); a quantized wire with an
    accumulation dtype other than f32 raises, as in JAX; the launcher
    refuses a CPU tensor; CPU calls count nothing."""
    x = torch.from_numpy(_rand(31, 1, 4, 8))
    assert ring_reduce_scatter(x) is x
    assert torch.equal(ring_reduce_scatter(x, force_kernel=True), x)
    with pytest.raises(ValueError, match="accumulates in f32"):
        ring_reduce_scatter(x, accum_dtype=torch.bfloat16, wire_format="fp8")
    with pytest.raises(ValueError, match="divisible"):
        ring_reduce_scatter(torch.zeros(2, 3, 4))
    reset_launches()
    ring_reduce_scatter(torch.zeros(2, 4, 8))
    assert launches()["ring_reduce_scatter"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        rs._launch(torch.zeros(2, 4, 8), torch.float32)


@pytest.mark.parametrize("rows,ring", [(1024, True), (1025, False)],
                         ids=["4MiB-ring", "above-xla"])
def test_reduce_scatter_auto_routing_matches_jax(rows, ring, monkeypatch):
    """Auto takes the ring for a chunk of at most 4 MiB and XLA above it,
    in both packages: a (rows, 1024) f32 chunk at n = 2 is exactly 4 MiB
    at 1024 rows. The JAX side is traced (eval_shape), its Pallas count
    telling the route; the port's by a wrapped ring."""
    n, w = 2, 1024
    before = pallas_call_count()
    jax.eval_shape(jax.shard_map(
        functools.partial(jax_reduce_scatter, axis="tp"), mesh=_mesh(n),
        in_specs=P("tp"), out_specs=P("tp"), check_vma=False),
        jax.ShapeDtypeStruct((n * n * rows, w), jnp.float32))
    assert (pallas_call_count() > before) == ring
    calls = []
    real = rs.ring_reduce_scatter
    monkeypatch.setattr(rs, "ring_reduce_scatter",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.zeros(n, n * rows, w)
    x[1, 0, 0] = 1.0
    out = rs.reduce_scatter(x)
    assert bool(calls) == ring
    assert out.shape == (n, rows, w) and float(out[0, 0, 0]) == 1.0
    monkeypatch.undo()
    assert torch.equal(rs.reduce_scatter(
        x, method=rs.ReduceScatterMethod.XLA), out)


# ---------- the grouped AllGather + GEMM (PERF.md row 4, grouped) ----------

E, CAP, K, I_LOC = 4, 16, 64, 128


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c_order", ["arrival", "rank"])
def test_grouped_ag_gemm_matches_jax(n, c_order):
    """Grouped silu_pair (the fused MoE gate|up), w_gate / w_up as views
    of one [gate | up] stack, against the JAX kernel (force_kernel,
    interpret mode) within 1e-5."""
    a = _rand(40 + n, n, E * CAP, K)
    gu = _rand(41 + n, n, E, K, 2 * I_LOC, scale=0.15)

    def fn(a_s, g_s, u_s):
        return jax_ag_gemm(a_s, (g_s[0], u_s[0]), axis="tp",
                           epilogue="silu_pair", c_order=c_order,
                           force_kernel=True)

    want = _jax(fn, n, a.reshape(n * E * CAP, K), gu[..., :I_LOC],
                gu[..., I_LOC:], in_specs=(P("tp"),) * 3)
    assert jax_allgather_gemm.last_launch()["path"] == "pallas"
    t = torch.from_numpy(gu)
    got = ag_gemm(torch.from_numpy(a), (t[..., :I_LOC], t[..., I_LOC:]),
                  epilogue="silu_pair", c_order=c_order)
    assert got.shape == (n, n * E * CAP, I_LOC)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), rtol=0,
                               atol=GEMM_ATOL)


def test_grouped_ag_gemm_plain_product_form():
    """Without the epilogue (n = 4, rank order): chunk c's block e times
    b[r][e], the JAX kernel within 1e-5; the pair at n = 1 unforced is
    the local grouped product."""
    n = 4
    a = _rand(50, n, E * CAP, K)
    b = _rand(51, n, E, K, I_LOC, scale=0.15)
    want = _jax(lambda a_s, b_s: jax_ag_gemm(a_s, b_s[0], axis="tp",
                                             force_kernel=True),
                n, a.reshape(n * E * CAP, K), b, in_specs=(P("tp"),) * 2)
    got = ag_gemm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), rtol=0,
                               atol=GEMM_ATOL)
    blocks = a.reshape(n, E, CAP, K)
    r, c, e = 2, 3, 1
    np.testing.assert_allclose(
        got.numpy()[r].reshape(n, E, CAP, I_LOC)[c, e],
        blocks[c, e] @ b[r, e], rtol=0, atol=GEMM_ATOL)
    one = torch.from_numpy(a[:1])
    pair = tuple(torch.from_numpy(_rand(52 + i, 1, E, K, I_LOC, scale=0.15))
                 for i in range(2))
    torch.testing.assert_close(
        ag_gemm(one, pair, epilogue="silu_pair"),
        ag_gemm_plain(one, pair, "silu_pair"), rtol=0, atol=0)


def test_capacity_rule_matches_jax():
    """cap = m_tok * k (lossless) by default, rounded up to 16 rows for
    bf16 and 8 for f32 (the JAX min_tile), clamped to m_tok * k."""
    assert capacity_rows(32, 8, torch.bfloat16) == 256
    assert capacity_rows(3, 2, torch.float32) == 8
    assert capacity_rows(3, 2, torch.bfloat16) == 16
    assert capacity_rows(10, 2, torch.float32, capacity=3) == 8


def test_grouped_ag_gemm_refusals():
    a = torch.zeros(2, 9, 8)
    with pytest.raises(ValueError, match="equal blocks"):
        ag_gemm(a, torch.zeros(2, 4, 8, 8))
    with pytest.raises(ValueError, match="expected"):
        ag_gemm(a, torch.zeros(2, 4, 7, 8))


def _packed(n, m_tok, k, e, h, seed, capacity=None):
    """Every rank's tokens packed by expert (pack_by_expert), as the
    fused up-projection packs them: a (n, E * cap, H) and the packs'
    counts (n, E) int32."""
    x = _rand(seed, n, m_tok, h)
    ids = np.stack([_ids(seed + 1 + r, m_tok, k, e) for r in range(n)])
    cap = capacity_rows(m_tok, k, torch.float32, capacity)
    packs = [mu.pack_by_expert(torch.from_numpy(x[r]),
                               torch.from_numpy(ids[r]), e, cap)
             for r in range(n)]
    return (torch.stack([p.x for p in packs]),
            torch.stack([p.counts for p in packs]), cap)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c_order", ["arrival", "rank"])
def test_grouped_ag_gemm_counts_on_packed_inputs_match_jax(n, c_order):
    """On pack_by_expert's inputs the rows past counts are zero rows, so
    ag_gemm (and ag_gemm_plain) with counts equals the call without
    bitwise, and both the JAX grouped kernel (interpret mode) within
    1e-5: the live-row contract leaves the function unchanged."""
    a, counts, cap = _packed(n, 6, 2, E, K, seed=70 + n)
    assert int(counts.min()) == 0  # an expert no token reached
    gu = torch.from_numpy(_rand(71 + n, n, E, K, 2 * I_LOC, scale=0.15))
    ws = (gu[..., :I_LOC], gu[..., I_LOC:])
    kw = dict(epilogue="silu_pair", c_order=c_order)
    got = ag_gemm(a, ws, counts=counts, **kw)
    assert torch.equal(got, ag_gemm(a, ws, **kw))
    assert torch.equal(ag_gemm_plain(a, ws, counts=counts, **kw), got)

    def fn(a_s, g_s, u_s):
        return jax_ag_gemm(a_s, (g_s[0], u_s[0]), axis="tp",
                           epilogue="silu_pair", c_order=c_order,
                           force_kernel=True)

    want = _jax(fn, n, a.numpy().reshape(n * E * cap, K),
                ws[0].contiguous().numpy(), ws[1].contiguous().numpy(),
                in_specs=(P("tp"),) * 3)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), rtol=0,
                               atol=GEMM_ATOL)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("c_order", ["arrival", "rank"])
def test_grouped_ag_gemm_counts_zero_the_rows_past_them(pair, c_order):
    """Rows past counts (here non-zero in A) are taken as zero: their C
    rows come out zero, in either C order, while every live row equals
    the call without counts bitwise; counts of 0 and of cap included.
    The mma.sync body's zeroing (_zero_dead_rows in arrival order) is
    the rank-order zeroing seen through the arrival permutation."""
    n, e, cap = 4, 3, 16
    a = torch.from_numpy(_rand(80, n, e * cap, K)) + 1.0
    w = tuple(torch.from_numpy(_rand(81 + h, n, e, K, I_LOC, scale=0.15))
              for h in range(2))
    b = w if pair else w[0]
    counts = torch.tensor([[0, 16, 5], [16, 0, 1], [7, 7, 0], [16, 16, 16]],
                          dtype=torch.int32)
    kw = dict(epilogue="silu_pair" if pair else None, c_order=c_order)
    got = ag_gemm(a, b, counts=counts, **kw)
    full = ag_gemm(a, b, **kw)
    rank = ag._zero_dead_rows(torch.ones(n, n * e * cap, 1), counts)
    live = rank if c_order == "rank" else ag.arrival_to_rank_order(rank)
    assert torch.equal(ag._zero_dead_rows(torch.ones_like(rank), counts,
                                          c_order == "arrival"), live)
    assert int(live.sum()) == n * int(counts.sum())
    assert torch.equal(got, torch.where(live.bool(), full, 0.0))
    assert not bool(full[~live.bool().expand_as(full)].eq(0).all())
    one = ag_gemm(a[:1], tuple(x[:1] for x in w) if pair else w[0][:1],
                  counts=counts[:1], **kw)  # n = 1: the local product
    assert torch.equal(one, ag_gemm_plain(a[:1], tuple(x[:1] for x in w)
                                          if pair else w[0][:1],
                                          counts=counts[:1], **kw))


def test_grouped_ag_gemm_counts_refusals():
    """counts: the grouped form only, not with return_gathered, an int32
    (n, E) tensor on a's device, within [0, cap] (checked on the CPU; on
    the card the kernel clamps, reading nothing back)."""
    n, e, cap = 2, 3, 8
    a = torch.zeros(n, e * cap, K)
    w = torch.zeros(n, e, K, 16)
    good = torch.full((n, e), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="grouped form"):
        ag_gemm(a, torch.zeros(n, K, 16), counts=good)
    with pytest.raises(ValueError, match="return_gathered"):
        ag_gemm(a, w, counts=good, return_gathered=True)
    for bad in (good.long(), good[:, :2], good.float(), [[4] * e] * n):
        with pytest.raises(ValueError, match="int32 tensor"):
            ag_gemm(a, w, counts=bad)
    for bad in (cap + 1, -1):
        with pytest.raises(ValueError, match="outside"):
            ag_gemm(a, w, counts=torch.full((n, e), bad, dtype=torch.int32))
        with pytest.raises(ValueError, match="outside"):
            ag_gemm_plain(a, w, counts=torch.full((n, e), bad,
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="dense ag_gemm form only"):
        ag_gemm(a, w, counts=good, wire_format="fp8")
    assert ag_gemm(a, w, counts=good).shape == (n, n * e * cap, 16)


def test_grouped_bn_and_the_fused_path_passes_counts(monkeypatch):
    """_grouped_bn: of 64 and 128, the width whose tiles a row times
    (columns + _WGMMA_FIXED_COLS) are the fewest, the widest on a tie
    (the fused prefill's I_loc 192 takes 128). And fused_ag_moe_up hands
    the grouped ag_gemm its packs' counts (the rows of each block that
    are live)."""
    assert [ag._grouped_bn(nn) for nn in (64, 128, 192, 256, 200, 40)] == [
        64, 128, 128, 128, 128, 64]
    for nn in (64, 192, 320, 1000):
        cost = {bn: -(-nn // bn) * (bn + ag._WGMMA_FIXED_COLS)
                for bn in ag._GROUPED_BN}
        assert cost[ag._grouped_bn(nn)] == min(cost.values())
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg

    seen = []
    real = ag.ag_gemm

    def spy(*args, **kw):
        seen.append(kw.get("counts"))
        return real(*args, **kw)

    monkeypatch.setattr(agg._ag, "ag_gemm", spy)
    n, m_tok, k = 2, 5, 2
    x = torch.from_numpy(_rand(90, n, m_tok, K))
    ids = torch.from_numpy(np.stack([_ids(91 + r, m_tok, k, E)
                                     for r in range(n)]))
    gu = torch.from_numpy(_rand(92, n, E, K, 2 * I_LOC, scale=0.15))
    act, meta = agg.fused_ag_moe_up(x, ids, torch.ones(n, m_tok, k),
                                    gu[..., :I_LOC], gu[..., I_LOC:])
    cap = capacity_rows(m_tok, k, torch.float32)
    want = torch.stack([mu.pack_by_expert(x[r], ids[r], E, cap).counts
                        for r in range(n)])
    assert len(seen) == 1 and torch.equal(seen[0], want)
    assert act.shape == (n, n, E, cap, I_LOC)


# ---------- the TP-MoE block, all four lowerings ----------


def _moe_case(n, seed=60, m=32, h=64, inter=128, e=4, k=2):
    """Full expert weights and their per-rank [gate_r | up_r] / row
    shards, as the JAX test_moe.py builds them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, h)) * 0.1).astype(np.float32)
    w_router = (rng.standard_normal((h, e)) * 0.1).astype(np.float32)
    w_gate, w_up = ((rng.standard_normal((e, h, inter)) * 0.1).astype(
        np.float32) for _ in range(2))
    w_down = (rng.standard_normal((e, inter, h)) * 0.1).astype(np.float32)
    il = inter // n
    gu = np.stack([np.concatenate([w_gate[:, :, r * il:(r + 1) * il],
                                   w_up[:, :, r * il:(r + 1) * il]], axis=2)
                   for r in range(n)])
    dn = np.stack([w_down[:, r * il:(r + 1) * il] for r in range(n)])
    return x, w_router, w_gate, w_up, w_down, gu, dn, k


def _dense_moe_ref(x, w_router, w_gate, w_up, w_down, top_k):
    """The dense oracle of tests/test_moe.py: every token through its
    top-k experts one by one, in numpy f32."""
    logits = x @ w_router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)[:, :top_k]
    out = np.zeros_like(x)
    for i in range(x.shape[0]):
        wsum = probs[i, order[i]].sum()
        for eid in order[i]:
            g, u = x[i] @ w_gate[eid], x[i] @ w_up[eid]
            act = g / (1 + np.exp(-g)) * u
            out[i] += (probs[i, eid] / wsum) * (act @ w_down[eid])
    return out


@pytest.mark.parametrize("mode", ["dist", "xla", "ar", "fused"])
def test_tp_moe_matches_jax_and_dense_oracle(mode):
    """tp_moe_fwd at n = 4 against the JAX tp_moe_{mode}_fwd (its ring
    kernels in interpret mode for dist and fused) within 1e-5, and
    against the dense oracle within 1e-5 (f32 sums in another order)."""
    n = 4
    x, w_router, w_gate, w_up, w_down, gu, dn, k = _moe_case(n)
    m, h = x.shape
    rep = mode == "ar"

    def fn(xs, gu_s, dn_s):
        params = jax_tp_moe.TPMoEParams(jnp.asarray(w_router), gu_s[0],
                                        dn_s[0])
        return jax_tp_moe.MODES[mode](xs, params, k, axis="tp")

    want = _jax(fn, n, x, gu, dn,
                in_specs=(P() if rep else P("tp"), P("tp"), P("tp")),
                out_specs=P() if rep else P("tp"),
                kernel=mode in ("dist", "fused"))
    params = TPMoEParams(torch.from_numpy(w_router), torch.from_numpy(gu),
                         torch.from_numpy(dn))
    tx = torch.from_numpy(x)
    tx = tx.expand(n, m, h) if rep else tx.reshape(n, m // n, h)
    got = tp_moe_fwd(tx, params, k, VirtualWorld(n, "cpu"), mode=mode)
    got = got[0] if rep else got.reshape(m, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GEMM_ATOL)
    np.testing.assert_allclose(
        got.numpy(), _dense_moe_ref(x, w_router, w_gate, w_up, w_down, k),
        rtol=0, atol=GEMM_ATOL)


def test_tp_moe_fused_drops_with_small_capacity():
    """A capacity below the exact one drops (token, choice) rows and
    counts them, as the JAX fused lowering does; the default drops
    none."""
    n = 4
    # 32 tokens a rank, 64 choices over 4 experts: capacity 1 (8 rows,
    # the f32 tile) must drop some
    x, w_router, _, _, _, gu, dn, k = _moe_case(n, seed=61, m=128)
    params = TPMoEParams(torch.from_numpy(w_router), torch.from_numpy(gu),
                         torch.from_numpy(dn))
    tx = torch.from_numpy(x).reshape(n, -1, x.shape[1])
    world = VirtualWorld(n, "cpu")
    _, drops = tp_moe_fwd(tx, params, k, world, mode="fused",
                          return_drops=True)
    assert drops.tolist() == [0] * n
    _, drops = tp_moe_fwd(tx, params, k, world, mode="fused", capacity=1,
                          return_drops=True)

    def fn(xs, gu_s, dn_s):
        p = jax_tp_moe.TPMoEParams(jnp.asarray(w_router), gu_s[0], dn_s[0])
        return jax_tp_moe.tp_moe_fused_fwd(xs, p, k, axis="tp", capacity=1,
                                           return_drops=True)[1][None]

    want = _jax(fn, n, x, gu, dn, in_specs=(P("tp"),) * 3, kernel=False)
    assert drops.tolist() == want.tolist() and sum(want) > 0

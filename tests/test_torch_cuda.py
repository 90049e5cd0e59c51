"""The port's CUDA kernels against their plain versions, on the card.

    python -m pytest -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA card and nvcc (the kernels build at first
use) and skips without one. The file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

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
from triton_dist_tpu_torch.kernels import grouped_gemm as gg


def _inputs(seed, b, s, t, hq, hkv, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


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
    assert torch.equal(ring_all_gather(x), ring_all_gather_plain(x))
    got = gemm_rs(a, b)
    want = gemm_rs_plain(a, b)
    torch.cuda.synchronize()
    part = torch.matmul(a.float(), b.float()).abs().max().item()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    atol = ulp * (n * part + want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
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
    assert not torch.equal(want, gemm_rs_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype,accum", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16-acc-f32"])
def test_ring_reduce_scatter_kernel_matches_plain_bitwise(cuda, n, dtype,
                                                          accum):
    """The credit-flow ring against its plain version: bitwise (the same
    fold order, each add rounded to the accumulation dtype), at chunks of
    several tiles with a ragged last one, and one of 3 elements; n = 1
    with force_kernel runs no ring step."""
    rng = np.random.default_rng(30 + n)
    reset_launches()
    calls = 0
    for m, w in ((40, 1000), (1, 3), (64, 2048)):
        x = torch.from_numpy(rng.standard_normal((n, n * m, w))).to(
            "cuda", dtype)
        got = ring_reduce_scatter(x, accum_dtype=accum, force_kernel=True)
        calls += 1
        want = ring_reduce_scatter_plain(x, accum)
        torch.cuda.synchronize()
        assert got.shape == (n, m, w) and got.dtype == dtype
        assert torch.equal(got, want), (m, w)
    assert launches()["ring_reduce_scatter"] == calls


def _grouped_atol(full, ws, want):
    """ag_gemm's band for the grouped form: one bf16 ulp of the largest
    output plus 1e-5 of max|gate| x max|up| over every expert block."""
    prods = [torch.einsum("sepk,rekn->rsepn", full.float(),
                          w.float()).abs().max().item() for w in ws]
    ulp = 2.0 ** -7 * want.float().abs().max().item()
    return ulp + 1e-5 * max(1.0, prods[0]) * max(1.0, prods[1])


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
    assert launches()["ag_gemm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [[5, 0, 7, 4], [0, 0, 16, 0], [3, 2, 1, 0]],
                         ids=["empty-middle", "one-group", "trailing-rows"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_gemm_card_route_matches_plain(cuda, gs, out_dtype):
    """torch._grouped_mm with the rank dim folded into the groups against
    the loop over experts: empty groups, one group, and rows past the
    last group (exactly zero on every rank, the last one included); x
    shared by the ranks, one per rank, and an unstacked weight. Band: one
    bf16 ulp of the largest output (every product is rounded to bf16,
    for an f32 out_dtype too) plus 1e-5 of it."""
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
        assert not got[..., sum(gs):, :].any()


_FAULT = r"""
import ctypes, sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
lib = _build.load("gemm_reduce_scatter", rs._SIGNATURES)
n, M, K, N = 2, 16, 64, 64
a = torch.ones((n, M, K), device="cuda", dtype=torch.bfloat16)
b = torch.ones((n, K, N), device="cuda", dtype=torch.bfloat16)
heap = torch.empty((n, n, M // n, N), device="cuda", dtype=torch.bfloat16)
out = torch.empty((n, M // n, N), device="cuda", dtype=torch.bfloat16)
# a flag pool that was not zeroed: no tile counter can reach n
flags = torch.full((n, lib.gemm_rs_flag_count(M // n, N, 1)), 7,
                   device="cuda", dtype=torch.int32)
grid = _build.GridInfo()
err = lib.gemm_rs_launch(a.data_ptr(), b.data_ptr(), heap.data_ptr(),
                         out.data_ptr(), flags.data_ptr(), n, M, K, N, 1, 0,
                         grid.ptr(), torch.cuda.current_stream().cuda_stream)
assert err == 0, err
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
sys.exit(0)
"""

# ag_gemm over a flag pool that was not zeroed: no arrival counter can
# equal the producer count, so the ring's step-1 wait must trap
_AG_FAULT = r"""
import sys, torch
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
lib = _build.load("allgather_gemm", ag._SIGNATURES)
n, m, K, N = 4, 16, 64, 64
a = torch.ones((n, m, K), device="cuda", dtype=torch.bfloat16)
b = torch.ones((n, K, N), device="cuda", dtype=torch.bfloat16)
ws = torch.empty((n, n * m, K), device="cuda", dtype=torch.bfloat16)
c = torch.empty((n, n * m, N), device="cuda", dtype=torch.bfloat16)
flags = torch.full((n, lib.ag_gemm_flag_count(n)), 7, device="cuda",
                   dtype=torch.int32)
grid = _build.GridInfo()
err = lib.ag_gemm_launch(a.data_ptr(), b.data_ptr(), b.data_ptr(),
                         ws.data_ptr(), c.data_ptr(), flags.data_ptr(), n, m,
                         K, N, 1, 0, 0, grid.ptr(),
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
flags = torch.full((n, 3 * lib.rs_tile_count(E, 1024)), -1000,
                   device="cuda", dtype=torch.int32)
grid = _build.GridInfo()
err = lib.rs_launch(x.data_ptr(), acc.data_ptr(), out.data_ptr(),
                    flags.data_ptr(), n, E, 1024, 1, 1, grid.ptr(),
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
@pytest.mark.parametrize("kernel,script", [
    ("gemm_rs", _FAULT), ("ag_gemm", _AG_FAULT),
    ("ring_reduce_scatter", _RS_FAULT)])
def test_protocol_fault_traps_instead_of_hanging(cuda, kernel, script):
    """A wait that can never be satisfied (flags left non-zero) ends in
    the bounded spin's printf and __trap(): the launch fails and the
    next synchronisation raises, within the spin bound, instead of
    hanging. Run in a child process, since the trap leaves its CUDA
    context unusable."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "raised:" in proc.stdout
    assert f"shmem wait timed out: kernel {kernel}, rank" in proc.stdout


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
    rounding may differ by one ulp and carry into the next branch."""
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
    assert torch.isfinite(logits).all()
    reset_launches()
    ids, _ = mega.decode_resident(logits.argmax(-1), cache, 3)
    torch.cuda.synchronize()
    assert launches()["mega"] == 3 and ids.shape == (4, 3)

"""What the port's captured steps rest on, held on the CPU against the JAX
package: the fixed-shape KV write against the JAX scatter, the prefill,
decode and serve steps free of host reads (dense at world 1 and 4, MoE
at world 4), and the SP decode step with a device call count, the EP
layer and the PP schedule likewise, the capturable decode step run
eagerly against the JAX Engine's
`generate` (its `lax.fori_loop`), the megakernel step's warm-up call,
the grouped f32 product on device group sizes against the JAX
`grouped_gemm` (`lax.ragged_dot`), the binding of a caller's state
to a graph's (`Resident`), and `graphs.compiled` (the CPU calls the step
function; a replay's outputs: the caller's state, copies of the rest).

Tiny f32 configs; the JAX side as the existing tests run it (world n on
the virtual CPU mesh, interpret-mode Pallas). On the card the same
functions run inside CUDA graphs (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from triton_dist_tpu.kernels.grouped_gemm import grouped_gemm as jax_gg
from triton_dist_tpu.layers.tp_attn import _scatter_kv as jax_scatter_kv
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch.kernels import grouped_gemm as gg
from triton_dist_tpu_torch.layers.tp_attn import KVWrite, _scatter_kv
from triton_dist_tpu_torch.mega import qwen3 as mega_qwen3
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax
from triton_dist_tpu_torch.models.dense import init_params
from triton_dist_tpu_torch.kernels.sample import sample_slots
from triton_dist_tpu_torch.models.engine import _serve_forward
from triton_dist_tpu_torch.layers import PPCommOp, pp_schedule_fwd
from triton_dist_tpu_torch.layers import sp_flash_decode as spl
from triton_dist_tpu_torch.layers.ep_moe import EPMoEParams, ep_moe_fwd
from triton_dist_tpu_torch.kernels.flash_decode import create_sp_decode_buf
from triton_dist_tpu_torch.layers.rope import rope_table
from triton_dist_tpu_torch.models.dense import pp_stage_fn
from triton_dist_tpu_torch.runtime import graphs
from triton_dist_tpu_torch.runtime.graphs import Resident
from triton_dist_tpu_torch.serve.kv_pool import KVPool

LOGIT_ATOL = 1e-4
CFG4 = dict(max_positions=64)


# ---------- (a) the fixed-shape KV write ----------


@pytest.mark.parametrize("starts,s,t", [
    ([3, 7], 1, 8),         # decode: every row below T
    ([6, 0, 2], 4, 8),      # a chunk straddling the horizon
    ([8, 17, 5], 3, 8),     # rows wholly past T (at T and far past)
    ([0, 3], 8, 8),         # a chunk as long as the horizon
], ids=["decode", "straddle", "past", "chunk-eq-horizon"])
def test_kv_write_matches_jax_scatter(starts, s, t):
    """Rows at positions below T land there, rows at or past T are
    dropped (the JAX scatter's out-of-bounds rule): the cache, filled
    with random values first, equals the JAX scatter's bitwise."""
    rng = np.random.default_rng(len(starts) * 10 + s)
    b, h, d = len(starts), 2, 4
    cache = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kv = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = (np.asarray(starts)[:, None] + np.arange(s)[None]).astype(np.int32)
    want = np.asarray(jax_scatter_kv(jnp.asarray(cache), jnp.asarray(kv),
                                     jnp.asarray(pos)))
    got = torch.from_numpy(cache.copy())
    write = KVWrite.at(torch.from_numpy(pos).long(), t)
    assert write.dst.shape == write.keep.shape == (b * s,)
    assert len(set(write.dst.tolist())) == b * s  # no two rows share a cell
    _scatter_kv(got, torch.from_numpy(kv), write)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_write_refuses_a_step_longer_than_the_horizon():
    with pytest.raises(ValueError, match="horizon"):
        KVWrite.at(torch.zeros((1, 9), dtype=torch.long), 8)


# ---------- (b) no host read on the steps ----------

_HOST_READS = ("nonzero", "item", "tolist", "cpu", "numpy", "__bool__",
               "__int__", "__float__")


def _forbid_host_reads(monkeypatch):
    for name in _HOST_READS:
        def refuse(*a, _name=name, **kw):
            raise AssertionError(f"host read on the step: Tensor.{_name}")
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("moe,world,mode", [
    (False, 1, "ar"), (False, 4, "ar"), (False, 4, "dist"),
    (True, 4, "ar"), (True, 4, "dist")],
    ids=["dense-w1", "dense-w4-ar", "dense-w4-dist", "moe-w4-ar",
         "moe-w4-dist"])
def test_steps_make_no_host_read(monkeypatch, moe, world, mode):
    """A prefill (the Engine's, in `mode`: a fresh cache, then a second
    chunk on it), one decode step (the Engine's, and the capturable step
    function a graph records) and one serve step (dense view, forward,
    last logits, pool scatter, then `sample_slots`, greedy and keyed
    rows) with Tensor.nonzero / item / tolist /
    cpu / numpy and the bool / int / float conversions made to raise: a
    CUDA graph can hold the step only if nothing on it reads the card."""
    cfg = (ModelConfig.tiny_moe(max_positions=64) if moe
           else ModelConfig.tiny(**CFG4))
    eng = Engine(cfg, device="cpu", world=world, max_len=32,
                 prefill_mode=mode, decode_mode=mode,
                 params=init_params(cfg, "cpu", seed=3, world=world))
    ids = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 5)))
    _forbid_host_reads(monkeypatch)
    logits, cache = eng.prefill(ids)
    _, chunked = eng.prefill(ids[:, :4], eng.prefill(ids[:, :1])[1])
    monkeypatch.undo()
    assert chunked.length.tolist() == [5] * 4
    tok = logits.argmax(-1)
    pool = KVPool(eng, slots=4, page=8)
    table = torch.as_tensor(np.arange(1, 17).reshape(4, 4))
    lengths = torch.tensor([0, 3, 9, 30])
    n_valid = torch.tensor([4, 1, 2, 0])
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 4)))
    step = eng._decode_fn(cache, tok.clone())
    _forbid_host_reads(monkeypatch)
    eng.decode_step(tok, cache)
    step(False)
    step(True)
    keys = torch.tensor([[0, 0], [3, -7], [0, 0], [11, 12]],
                        dtype=torch.int32)
    temps = torch.tensor([0.0, 0.8, 0.0, 1.1])
    last = _serve_forward(cfg, mode, 4, 4, 8, 32, eng.params, tokens,
                          pool.k, pool.v, table, lengths, n_valid)
    tok = sample_slots(last, keys, temps)
    monkeypatch.undo()
    assert last.shape == (4, cfg.vocab_size) and tok.shape == (4,)
    assert torch.isfinite(last).all()


def _sp_step_case():
    """The SP decode step's arguments, world 4, a device call count."""
    n, b, h, hq, hkv, d, t_loc = 4, 2, 32, 4, 2, 16, 8
    g = torch.Generator().manual_seed(5)
    params = spl.SpDecodeParams(
        torch.randn(h, (hq + 2 * hkv) * d, generator=g) * 0.1,
        torch.randn(hq * d, h, generator=g) * 0.1)
    cos, sin = rope_table(d, n * t_loc + 4, device="cpu")
    cache = tuple(torch.randn(n, b, t_loc, hkv, d, generator=g)
                  for _ in range(2))
    return (torch.randn(n, b, h, generator=g), params,
            spl.SpDecodeSpec(hq, hkv, d), cos, sin, cache,
            torch.tensor([9, 30]), create_sp_decode_buf(b, hq, d, n, "cpu"),
            torch.zeros(1, dtype=torch.int32))


def _ep_case(overlap):
    n, m, h, e, inter, k = 4, 6, 16, 8, 8, 2
    g = torch.Generator().manual_seed(7)
    params = EPMoEParams(torch.randn(h, e, generator=g),
                         torch.randn(n, e // n, h, 2 * inter, generator=g),
                         torch.randn(n, e // n, inter, h, generator=g))
    x = torch.randn(n, m, h, generator=g)
    kw = dict(overlap=True, n_chunks=2) if overlap else {}
    return lambda: ep_moe_fwd(x, params, k, return_drops=True, **kw)


@pytest.mark.parametrize("step", ["sp-decode", "ep-sequential",
                                  "ep-overlap", "pp-schedule"])
def test_sp_ep_pp_steps_make_no_host_read(monkeypatch, step):
    """The other steps a graph captures, with the host reads of
    test_steps_make_no_host_read made to raise: the SP decode step with
    its LL call count a device tensor (two steps; the count and kv_len
    advanced on the device), `ep_moe_fwd` sequential and overlap (q 2),
    and `pp_schedule_fwd` over a tiny model's layers at 4 stages. Each
    gives what it gives with host reads allowed."""
    if step == "sp-decode":
        def run():
            a = _sp_step_case()
            ys = [spl.sp_decode_step(*a) for _ in range(2)]
            return ys, a[6], a[8], a[7].flags
    elif step.startswith("ep"):
        run = _ep_case(step == "ep-overlap")
    else:
        cfg = ModelConfig.tiny(num_layers=4, max_positions=64)
        params = init_params(cfg, "cpu", seed=4)
        fn = pp_stage_fn(cfg, params, 4)
        x = torch.randn(1, 3, 5, cfg.hidden_size).expand(4, 3, 5, -1)

        def run():
            return pp_schedule_fwd(PPCommOp(4), fn, x, 3)
    want = run()
    _forbid_host_reads(monkeypatch)
    got = run()
    monkeypatch.undo()
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert torch.equal(a, b)
    if step == "sp-decode":
        assert got[1].tolist() == [11, 32] and got[2].tolist() == [2]


# ---------- (c) the capturable step against the JAX fori_loop ----------


@pytest.fixture(scope="module")
def engines4_default():
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG4), mesh, max_len=64,
                     donate_cache=False)
    np_params = jax.tree.map(np.asarray, jeng.params)
    eng = Engine(ModelConfig.tiny(**CFG4), device="cpu", max_len=64,
                 world=4, params=params_from_jax(np_params, "cpu"))
    return jeng, eng


@pytest.mark.parametrize("route", ["step-function", "generate"])
def test_capturable_step_matches_jax_generate(engines4_default, route):
    """The decode step a CUDA graph records (`Engine._decode_fn`), run
    eagerly at world 4 (`ar`): called step by step after a warm-up call
    (commit=False), and through `Engine.generate`, whose eager route
    calls it. Its greedy tokens are bitwise the JAX Engine's `generate`
    (one `lax.fori_loop`), the final cache length the JAX cache's; step
    by step each step's logits are within 1e-4 of the JAX decode step's
    on the same tokens, and the warm-up leaves the length and the token
    as they were."""
    jeng, eng = engines4_default
    steps = 5
    ids = np.random.default_rng(4).integers(0, 256, (4, 9)).astype(np.int32)
    jl, jcache = jeng.prefill(jnp.asarray(ids))
    tl, cache = eng.prefill(ids)
    tok0 = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    want, jgen = jeng.generate(jnp.asarray(tok0), jcache, steps)
    want = np.asarray(want)

    tok = torch.from_numpy(tok0).long()
    if route == "generate":
        out, got_cache = eng.generate(tok, cache, steps)
        assert got_cache is cache
        assert out.tolist() == want.tolist()
        assert tok.tolist() == tok0.tolist()  # the caller's token is kept
    else:
        step = eng._decode_fn(cache, tok)
        length0 = cache.length.clone()
        step(False)
        assert torch.equal(cache.length, length0)
        assert tok.tolist() == tok0.tolist()
        jtok, got = jnp.asarray(tok0), []
        for i in range(steps):
            logits, _ = step(True)
            jlog, jcache = jeng.decode_step(jtok, jcache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                       rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"step {i}")
            got.append(tok.tolist())
            jtok = jnp.asarray(want[:, i])
        assert np.asarray(got).T.tolist() == want.tolist()
    assert cache.length.tolist() == np.asarray(jgen.length).tolist()
    assert cache.length.tolist() == [9 + steps] * 4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mega_warmup_step_leaves_the_cache(paged):
    """A graph's warm-up runs the megakernel step with commit=False
    (`MegaQwen3._step_fn`): it leaves the cache's length, and a paged
    cache's allocator head, as they were and feeds no token back, so
    the steps after it are bitwise decode_resident's from the same
    cache without one (tokens and every cache tensor)."""
    cfg = ModelConfig.tiny(max_positions=64)
    params = init_params(cfg, "cpu", seed=6)
    eng = Engine(cfg, device="cpu", params=params, max_len=64,
                 prefill_mode="xla")
    kw = dict(paged=True, page_size=8, total_pages=14) if paged else {}
    mega = mega_qwen3.MegaQwen3(cfg, batch=2, s_max=64, params=params,
                                device="cpu", **kw)
    logits, cache = eng.prefill(np.random.default_rng(6).integers(
        0, 256, (2, 7)))
    a = (mega.paged_cache_from_dense(cache) if paged
         else mega_qwen3.MegaKVCache.from_dense(cache, s_max=64))
    b = type(a)(*(t.clone() for t in a))
    tok = logits.argmax(-1)
    want, a = mega.decode_resident(tok, a, 3)
    t2 = tok.clone()
    step = mega._step_fn(b, t2)
    heads = [b.length.clone()] + ([b.next_free.clone()] if paged else [])
    step(False)
    assert b.length.tolist() == [7, 7] and torch.equal(t2, tok)
    assert torch.equal(heads[0], b.length)
    assert not paged or torch.equal(heads[1], b.next_free)
    got, b = mega.decode_resident(t2, b, 3)
    assert torch.equal(want, got)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------- (d) the grouped f32 product on device group sizes ----------


@pytest.mark.parametrize("sizes", [
    [[40, 0, 1, 0, 2, 0]],                         # skew, empty experts
    [[0, 0, 0, 0, 0, 30]],                         # one expert, tail rows
    [[5, 5, 0, 9, 0, 1], [0, 12, 12, 0, 0, 0],
     [1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]],     # sizes a rank
    [[3, 0, 0, 5, 0, 1], [0, 2, 0, 0, 0, 9],
     [0, 0, 0, 0, 4, 0], [6, 0, 0, 0, 0, 0]],     # EP: 3/4 of rows past
], ids=["skew-empty", "one-expert", "sizes-a-rank", "ep-null-tail"])
def test_grouped_f32_matches_jax_ragged_dot(sizes):
    """grouped_gemm_f32 (its plain version on the CPU) with bf16 operands
    and an f32 result, the group sizes a tensor read on the device,
    against the JAX grouped_gemm (`lax.ragged_dot`, f32 accumulation)
    rank by rank: inside the f32 epsilon band, rows past each rank's
    last group zero; a shared x (every rank's rows alike) too."""
    n, t, k, nn = 4, 48, 32, 40
    e = len(sizes[0])
    rng = np.random.default_rng(sum(map(sum, sizes)))
    x = rng.standard_normal((n, t, k)).astype(np.float32)
    w = (rng.standard_normal((n, e, k, nn)) * 0.2).astype(np.float32)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    sz = np.asarray(sizes if len(sizes) > 1 else sizes[0], np.int32)
    per_rank = np.broadcast_to(sz, (n, e))
    for xs in (xb, xb[0]):
        got = gg.grouped_gemm_f32(xs, wb, torch.from_numpy(sz))
        assert got.dtype == torch.float32 and got.shape == (n, t, nn)
        for r in range(n):
            xr = xs if xs.dim() == 2 else xs[r]
            want = np.asarray(jax_gg(
                jnp.asarray(xr.float().numpy(), jnp.bfloat16),
                jnp.asarray(wb[r].float().numpy(), jnp.bfloat16),
                jnp.asarray(per_rank[r]), out_dtype=jnp.float32))
            rep = torch_parity.check_epsilon(want, got[r].numpy(),
                                             "grouped_gemm", np.float32)
            assert rep["ok"], (r, rep)
            used = int(per_rank[r].sum())
            assert not got[r, used:].any()


def test_grouped_f32_plan():
    """The kernel's walkers a (rank, N tile): about 8 blocks a SM over
    the grid, never more than a rank's row tiles can be, at least one."""
    assert gg._plan(32, 128, 2048, 4, 132) == 17  # decode: 16 N tiles x 4
    assert gg._plan(4096, 128, 2048, 4, 132) == 17
    assert gg._plan(16, 2, 128, 1, 132) == 3  # ceil(16/64) + 2 tiles
    assert gg._plan(1, 1, 8, 1, 1) == 2


# ---------- (e) a caller's state bound to a graph's ----------


def test_resident_bind_copies_once_then_shares():
    """A caller's tensor is copied into the graph's state once and then is
    a view of it: what the graph writes the caller reads, and binding it
    again copies nothing."""
    a = torch.arange(6.0).reshape(2, 3)
    r = Resident([a])
    s = r.tensors[0]
    assert not s.any()
    r.bind([a])
    assert a.data_ptr() == s.data_ptr() and torch.equal(s, torch.arange(
        6.0).reshape(2, 3))
    s.add_(1)  # a replay's in-place write
    assert torch.equal(a, torch.arange(1.0, 7.0).reshape(2, 3))
    a.mul_(2)  # the caller's write lands in the graph's state
    r.bind([a])
    assert torch.equal(s, torch.arange(1.0, 7.0).reshape(2, 3) * 2)


def test_resident_second_caller_leaves_the_first_its_value():
    """A second caller's tensor takes the slot: the first keeps the value
    it held, in memory of its own, and neither sees the other's writes;
    binding the first again copies its value back in."""
    a, b = torch.ones(4), torch.full((4,), 5.0)
    r = Resident([a])
    r.bind([a])
    r.tensors[0].add_(1)
    r.bind([b])
    s = r.tensors[0]
    assert b.data_ptr() == s.data_ptr() and a.data_ptr() != s.data_ptr()
    assert torch.equal(a, torch.full((4,), 2.0))
    s.add_(1)
    assert torch.equal(b, torch.full((4,), 6.0))
    assert torch.equal(a, torch.full((4,), 2.0))
    r.bind([a])
    assert torch.equal(s, torch.full((4,), 2.0))
    assert torch.equal(b, torch.full((4,), 6.0))


def test_resident_refuses_another_shape():
    r = Resident([torch.zeros(2, 3)])
    with pytest.raises(ValueError, match="state 0"):
        r.bind([torch.zeros(3, 2)])
    with pytest.raises(ValueError, match="state 0"):
        r.bind([torch.zeros(2, 3, dtype=torch.float64)])


# ---------- (f) graphs.compiled ----------


def _toy_step(x, state, scale, table):
    """A step of all three kinds of argument: it adds x * scale to its
    state in place and returns (a state tensor, a fresh one)."""
    acc, count = state
    acc.add_(x * scale + table)
    count.add_(1)
    return acc, acc.sum(), [count]


def test_compiled_calls_the_step_on_the_cpu():
    """On the CPU (and with cuda_graph False) a compiled step is its
    function: the same results, the state updated in place, no graph."""
    step = graphs.compiled(_toy_step, state=("state",), static=("table",))
    acc, count = torch.zeros(3), torch.zeros(1, dtype=torch.int32)
    table = torch.ones(3)
    for i in range(3):
        a, total, (c,) = step(torch.arange(3.0), (acc, count), 2.0, table)
        assert a is acc and c is count
    assert acc.tolist() == [3.0, 9.0, 15.0] and count.tolist() == [3]
    assert total.item() == 27.0 and step.graphs.made == 0
    off = graphs.compiled(_toy_step, state=("state",), static=("table",),
                          cuda_graph=False)
    off(torch.ones(3), (acc, count), 1.0, table=table)
    assert count.tolist() == [4] and off.graphs.made == 0


def test_compiled_refuses_what_it_cannot_key():
    """A name that is not an argument raises at once; an input that is
    neither a tensor nor hashable raises before any call (name it
    static); a state argument must hold tensors."""
    with pytest.raises(ValueError, match="not arguments"):
        graphs.compiled(_toy_step, state=("cache",))
    step = graphs.compiled(_toy_step, state=("state",))
    acc, count = torch.zeros(3), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="table"):
        step(torch.ones(3), (acc, count), 1.0, {"not": "hashable"})
    step = graphs.compiled(_toy_step, state=("state", "scale"))
    with pytest.raises(TypeError, match="scale"):
        step(torch.ones(3), (acc, count), 1.0, torch.ones(3))
    assert count.tolist() == [0]


def test_compiled_replay_returns_the_callers_state_and_copies():
    """What a replay hands back (`graphs._returned`): an output that is
    one of the graph's state tensors comes back as the caller's tensor
    bound to it, through tuples, lists, named tuples and dataclasses (an
    LL context); any other tensor as a copy that the next replay does
    not touch; other values as they are."""
    state = [torch.zeros(4), torch.ones(2)]
    mine = [torch.zeros(4), torch.ones(2)]
    other = torch.arange(3.0)
    ctx = create_sp_decode_buf(1, 1, 8, 2, "cpu")
    ctx2 = create_sp_decode_buf(1, 1, 8, 2, "cpu")
    st = [state[0], state[1], ctx.data, ctx.flags]
    ours = [mine[0], mine[1], ctx2.data, ctx2.flags]
    out = graphs._returned(
        (state[0], [other, 7], spl.SpDecodeSpec(1, 2, 3), ctx, state[1][:1]),
        st, ours)
    assert out[0] is mine[0] and out[3].data is ctx2.data
    assert out[3].flags is ctx2.flags and out[2] == (1, 2, 3)
    copied = out[1][0]
    assert torch.equal(copied, other) and copied.data_ptr() != \
        other.data_ptr() and out[1][1] == 7
    other.add_(1)  # the next replay rewrites the graph's buffer
    assert copied.tolist() == [0.0, 1.0, 2.0]
    # a view of a state tensor that is not the tensor itself: a copy
    assert out[4].data_ptr() != state[1].data_ptr()

"""The port's expert-parallel MoE path against the JAX package's: the MoE
all-to-all and its chunked form (kernels/all_to_all.py), the EP dispatch,
expert FFN and combine, sequential and chunk-pipelined (kernels/
ep_a2a.py), `chunk_group_sizes` (kernels/moe_utils.py), the EP layer
(layers/ep_moe.py), the weights carried across, and the slice whole: a
tiny MoE model's layer routed, dispatched, run and combined at n = 4.

Inputs come from a numpy seed at tiny widths (M 8 tokens a rank, H 64,
so a payload row of 128 columns, E 8 or 16, top-2, I 32). The JAX
functions run as their own tests run them (tests/test_p2p_a2a.py,
tests/test_moe.py): under `jax.shard_map` on n in {2, 4} of the 12
virtual CPU devices, Pallas in interpret mode, and the tests assert with
`pallas_call_count` that the JAX kernel ran. On the CPU the port's
kernel wrappers run their plain versions; its tensors are rank-stacked
(rank r at [r], a JAX per-device (n, C, ...) buffer at [r] of (n, n, C,
...)). Tolerances: the transports and every integer bitwise; the combine
scatter bitwise (the port adds a row's contributions in the slot order
of JAX's sequential scatter); f32 products within 1e-5; the dense oracle
within 2e-3, the JAX test's own.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels.all_to_all import all_to_all as jax_a2a
from triton_dist_tpu.kernels.all_to_all import (
    all_to_all_chunked as jax_a2a_chunked,
)
from triton_dist_tpu.kernels.moe_utils import (
    chunk_group_sizes as jax_chunk_group_sizes,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.layers.ep_moe import EPMoEParams as JaxEPMoEParams
from triton_dist_tpu.layers.ep_moe import ep_moe_fwd as jax_ep_moe_fwd
from triton_dist_tpu.layers.ep_moe import ep_moe_ref as jax_ep_moe_ref
from triton_dist_tpu.models.config import ModelConfig as JaxModelConfig
from triton_dist_tpu.models.dense import init_params as jax_init_params
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.kernels.all_to_all import (
    all_to_all,
    all_to_all_chunked,
    all_to_all_plain,
)
from triton_dist_tpu_torch.kernels.moe_utils import chunk_group_sizes
from triton_dist_tpu_torch.layers.ep_moe import (
    ep_moe_fwd,
    ep_moe_ref,
    ep_params_from_jax,
    ep_params_from_tp,
)
from triton_dist_tpu_torch.layers.tp_moe import TPMoEParams, tp_moe_fwd
from triton_dist_tpu_torch.models.dense import params_from_jax, shard_params
from triton_dist_tpu_torch.runtime import VirtualWorld

jep = importlib.import_module("triton_dist_tpu.kernels.ep_a2a")

GEMM_ATOL = 1e-5  # f32 products over K <= 64 in another order
REF_ATOL = 2e-3   # the JAX test's tolerance against the dense oracle
M, H, INTER, K = 8, 64, 32, 2


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    """numpy (f32, int or ml_dtypes bf16) -> torch, bf16 kept bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    """torch -> numpy f32 / int for comparisons (bf16 exactly widened)."""
    return (t.float() if t.is_floating_point() else t).numpy()


def _jax(fn, n, *args, in_specs, out_specs=P("tp"), kernel=True):
    """fn per device under shard_map on an n-device mesh, numpy results;
    with kernel, asserts that a Pallas kernel ran (interpret mode)."""
    before = pallas_call_count()
    mesh = make_mesh(mesh_shape=(n,), axis_names=("tp",))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))(*args)
    if kernel:
        assert pallas_call_count() > before, "the JAX kernel did not run"
    return jax.tree.map(np.asarray, out)


def _stacked(a, n):
    """A JAX global (n * d0, ...) array -> rank-stacked (n, d0, ...)."""
    a = np.asarray(a)
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


# -- the all-to-all (rows 12-13) -------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_to_all_matches_jax(n, dtype):
    """The port's all_to_all and all_to_all_chunked (q = 1, 2, 4) against
    the JAX all_to_all and all_to_all_chunked (Pallas, interpret) and
    each other: bitwise, payload and splits; splits (n,) a rank in f32,
    (n, S) in bf16. A q that does not divide C raises on both sides."""
    c, w = 4, 128
    x = jnp.asarray(_rand(n, n * n, c, w), dtype)
    rng = np.random.default_rng(n)
    sp_shape = (n * n,) if dtype == "float32" else (n * n, 3)
    sp = jnp.asarray(rng.integers(0, c + 1, sp_shape), jnp.int32)
    specs = dict(in_specs=(P("tp"), P("tp")), out_specs=(P("tp"), P("tp")))
    want, want_sp = _jax(lambda a, s: jax_a2a(a, s, "tp"), n, x, sp, **specs)
    xt = _t(_stacked(x, n))
    spt = _t(_stacked(sp, n))
    want, want_sp = _stacked(want, n), _stacked(want_sp, n)
    kernels.reset_launches()
    got = [all_to_all(xt, spt), all_to_all_plain(xt, spt)]
    for q in (1, 2, 4):
        jq = _jax(lambda a, s, q=q: jax_a2a_chunked(a, s, "tp", n_chunks=q),
                  n, x, sp, **specs)
        np.testing.assert_array_equal(_stacked(jq[0], n).astype(np.float32),
                                      want.astype(np.float32))
        np.testing.assert_array_equal(_stacked(jq[1], n), want_sp)
        got.append(all_to_all_chunked(xt, spt, n_chunks=q))
    for out, out_sp in got:
        assert out.dtype == xt.dtype and out_sp.shape == spt.shape
        np.testing.assert_array_equal(_np(out), want.astype(np.float32))
        np.testing.assert_array_equal(_np(out_sp), want_sp)
    assert kernels.launches()["all_to_all"] == 0  # plain on the CPU
    with pytest.raises(ValueError, match="divide"):
        all_to_all_chunked(xt, spt, n_chunks=3)
    with pytest.raises(ValueError, match="divide"):
        _jax(lambda a, s: jax_a2a_chunked(a, s, "tp", n_chunks=3), n, x,
             sp, kernel=False, **specs)


def test_all_to_all_world_one_returns_input():
    """At n = 1 both forms return the input (splits as int32) and launch
    nothing, as the JAX functions do."""
    x = torch.arange(24.0).reshape(1, 1, 4, 6)
    sp = torch.tensor([[3]], dtype=torch.int64)
    for fn in (all_to_all, lambda a, s: all_to_all_chunked(a, s, 2)):
        out, out_sp = fn(x, sp)
        assert out is x and out_sp.dtype == torch.int32
        assert out_sp.tolist() == [[3]]


@pytest.mark.parametrize("n,seg,q,aligned,body,word", [
    (4, 8 * 4352, 1, True, "reg", 16),  # M 1 dispatch
    (4, 8 * 8192, 1, True, "reg", 16),  # M 1 combine
    (4, 1024 * 4352, 1, True, "bulk", 16),  # M 128
    (4, 1024 * 4352, 4, True, "bulk", 16),
    (4, 1024 * 8192, 1, True, "bulk", 16),
    (4, 1024 * 2176, 2, True, "bulk", 16),  # fp8 wire, q 2
    (2, 48, 4, True, "reg", 1),  # rows of 6 bytes, q 4
    (4, 8 * 4352, 1, False, "reg", 1),  # unaligned x
    (4, 16, 1, True, "reg", 16)])  # the protocol's floor
def test_a2a_plan_flag_words_and_pool_key(n, seg, q, aligned, body, word):
    """The A2A launch plan, pure: 16-byte words when the chunk and the
    pointers allow them, else bytes, for either body that takes them;
    the bulk body from 1 MiB a rank's chunk in 16-byte words (the EP
    prefill's), the register body below (its decode). The flag pool: n *
    q words a rank, keyed by (device, stream, n, q), so two streams,
    worlds or chunk counts never share one. A CPU call runs the plain
    version and makes no pool."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    assert a2a._body_for(n, seg, q, aligned) == body
    assert a2a._word(seg, q, aligned, body) == word
    assert a2a._word(seg, q, aligned) == word
    chunk_bytes = seg // q
    assert body == ("bulk" if aligned and chunk_bytes % 16 == 0
                    and n * chunk_bytes >= 1 << 20 else "reg")
    assert a2a._flag_words(n, q) == n * q
    x = torch.zeros(n, n, 2, 8)
    key = a2a._pool_key(x, 7, q)
    assert key == (x.device, 7, n, q)
    assert key not in {a2a._pool_key(x, 8, q), a2a._pool_key(x, 7, q + 1),
                       a2a._pool_key(torch.zeros(n + 1, n + 1, 2), 7, q)}
    assert isinstance(a2a._POOLS, _build.PoolCache)
    made = a2a._POOLS.made
    sp = torch.ones(n, n, dtype=torch.int64)
    for out in (all_to_all(x, sp), all_to_all_chunked(x, sp, n_chunks=2)):
        assert torch.equal(out[0], all_to_all_plain(x, sp)[0])
    assert a2a._POOLS.made == made


def test_a2a_wrapper_refusals():
    """What the wrappers refuse, on the CPU: shapes that are not (n, n,
    C, ...) and splits that are not (n, n[, S]); a q that does not divide
    C; the kernel launch on a CPU tensor; a straggler outside the world;
    the bulk body on a chunk that takes no 16-byte words, and a body the
    kernel does not have."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    x = torch.zeros(4, 4, 6, 3)
    sp = torch.zeros(4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="rank-stacked"):
        all_to_all(torch.zeros(4, 3, 6, 3), sp)
    with pytest.raises(ValueError, match="splits"):
        all_to_all(x, torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="splits"):
        all_to_all_chunked(x, torch.zeros(4, 4, 2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="divide"):
        all_to_all_chunked(x, sp, n_chunks=4)
    with pytest.raises(ValueError, match="CUDA"):
        a2a._launch("all_to_all", x, sp, 1, False, None)
    with pytest.raises(ValueError, match="straggler"):
        a2a._build.straggler_args((4, 0), 4)
    with pytest.raises(ValueError, match="bulk"):
        a2a._word(72, 1, True, "bulk")
    with pytest.raises(ValueError, match="body"):
        a2a._word(64, 1, True, "tma")


def test_chunk_group_sizes_matches_jax():
    """Every chunk's (..., E+1) sizes equal the JAX function's, with a
    leading rank dim on the port's side."""
    counts = np.random.default_rng(3).integers(0, 5, (2, 3, 4)).astype(
        np.int32)
    cap = 16
    for rows in (4, 8, 16):
        for lo in range(0, cap, rows):
            got = chunk_group_sizes(torch.from_numpy(counts), cap, lo, rows)
            assert got.dtype == torch.int32 and got.shape == (2, 3, 5)
            for r in range(2):
                want = np.asarray(jax_chunk_group_sizes(
                    jnp.asarray(counts[r]), cap, lo, rows))
                np.testing.assert_array_equal(got[r].numpy(), want)


# -- dispatch, FFN, combine ---------------------------------------------


def _routing(n, e, seed, m=M, k=K):
    """Distinct experts a token and positive weights, as numpy (n*m, k)."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(rng.random((n * m, e)), axis=1)[:, :k].astype(np.int32)
    w = rng.random((n * m, k)).astype(np.float32) + 0.1
    return ids, w / w.sum(1, keepdims=True)


_DISPATCH_FIELDS = ("x", "local_expert", "valid", "counts", "send_src_row",
                    "send_weight", "send_valid", "send_counts")
_CHUNK_FIELDS = ("x", "expert_counts", "valid", "counts", "send_src_row",
                 "send_weight", "send_valid", "send_counts")


def _jax_dispatch(n, e, cap, x, ids, w, chunked, q=1):
    """The JAX dispatch (sequential or chunked) under shard_map: its
    fields rank-stacked, drops (n,)."""
    fields = _CHUNK_FIELDS if chunked else _DISPATCH_FIELDS

    def per_rank(xs, i, ws):
        if chunked:
            d = jep.ep_dispatch_chunked(xs, i, ws, e, cap, "tp", n_chunks=q)
        else:
            d = jep.ep_dispatch(xs, i, ws, e, cap, "tp")
        return tuple(getattr(d, f) for f in fields) + (d.drops.reshape(1),)

    out = _jax(per_rank, n, x, ids, w, in_specs=(P("tp"),) * 3,
               out_specs=(P("tp"),) * (len(fields) + 1))
    got = {f: _stacked(a, n) for f, a in zip(fields, out)}
    got["drops"] = out[-1]
    return got


def _port_inputs(n, x, ids, w):
    return (_t(_stacked(x, n)), _t(_stacked(ids, n)),
            torch.from_numpy(_stacked(w, n)))


@pytest.mark.parametrize("n,e,cap,dtype", [
    (2, 8, M * K, "float32"), (4, 16, 5, "float32"),
    (4, 8, M * K, "bfloat16")], ids=["n2-lossless", "n4-tight", "n4-bf16"])
def test_ep_dispatch_combine_match_jax(n, e, cap, dtype):
    """ep_dispatch, ep_expert_ffn and ep_combine on the same routing
    against the JAX functions (JAX FFN and combine fed the JAX dispatch,
    the port's fed its own): every field of the dispatch equal (the
    payload bitwise), the FFN within 1e-5, the combine scatter alone
    bitwise on the same inputs, the layer's combine within 1e-5."""
    x = jnp.asarray(_rand(1, n * M, H), dtype)
    ids, w = _routing(n, e, 2)
    gu = _rand(3, e, H, 2 * INTER, scale=0.2)
    dn = _rand(4, e, INTER, H, scale=0.2)
    want = _jax_dispatch(n, e, cap, x, ids, w, chunked=False)
    xt, it, wt = _port_inputs(n, x, ids, w)
    disp = ep_a2a.ep_dispatch(xt, it, wt, e, cap)
    for f in _DISPATCH_FIELDS:
        got = _np(getattr(disp, f))
        np.testing.assert_array_equal(got, want[f].astype(got.dtype),
                                      err_msg=f)
    np.testing.assert_array_equal(disp.drops.numpy(), want["drops"])
    assert (cap < M * K) == bool(want["drops"].sum() > 0)

    # the FFN and the combine scatter, JAX's per rank on its dispatch
    jdisp = [jep.EPDispatch(**{f: jnp.asarray(want[f][r]) for f in
                               _DISPATCH_FIELDS}, drops=jnp.int32(0))
             for r in range(n)]
    gu_t = _t(gu.reshape(n, e // n, H, 2 * INTER)).to(xt.dtype)
    dn_t = _t(dn.reshape(n, e // n, INTER, H)).to(xt.dtype)
    jy = np.stack([np.asarray(jax.jit(jep.ep_expert_ffn)(
        jdisp[r], jnp.asarray(gu_t[r].float().numpy(), dtype),
        jnp.asarray(dn_t[r].float().numpy(), dtype))) for r in range(n)])
    y = ep_a2a.ep_expert_ffn(disp, gu_t, dn_t)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=GEMM_ATOL)

    back = _rand(5, n, n, cap, H)
    back *= np.asarray([[d.send_valid for d in jdisp]]).reshape(
        n, n, cap, 1)
    js = np.stack([np.asarray(jax.jit(
        jep._combine_scatter, static_argnums=(2, 3))(
            jnp.asarray(back[r]), jdisp[r], M, jnp.float32))
        for r in range(n)])
    got = ep_a2a._combine_scatter(torch.from_numpy(back), disp, M, K,
                                  torch.float32)
    np.testing.assert_array_equal(got.numpy(), js)

    def combine(ys, *fields):
        d = jep.EPDispatch(*fields, drops=jnp.int32(0))
        return jep.ep_combine(ys, d, M, jnp.float32, "tp")

    jout = _jax(combine, n, jy.reshape(n * n, cap, H),
                *(want[f].reshape(n * n, *want[f].shape[2:])
                  for f in _DISPATCH_FIELDS),
                in_specs=(P("tp"),) * (1 + len(_DISPATCH_FIELDS)))
    out = ep_a2a.ep_combine(y, disp, M, K, torch.float32)
    np.testing.assert_allclose(out.numpy(), _stacked(jout, n), rtol=0,
                               atol=GEMM_ATOL)


@pytest.mark.parametrize("n,q", [(2, 2), (4, 4)])
def test_ep_chunked_pipeline_matches_jax(n, q):
    """ep_dispatch_chunked (every field equal, the payload bitwise),
    ep_expert_ffn_chunked (within 1e-5 of JAX's on the same dispatch)
    and ep_combine_chunked (within 1e-5), at a tight capacity."""
    e, cap = 8, 8
    x = jnp.asarray(_rand(6, n * M, H))
    ids, w = _routing(n, e, 7)
    gu = _rand(8, e, H, 2 * INTER, scale=0.2)
    dn = _rand(9, e, INTER, H, scale=0.2)
    want = _jax_dispatch(n, e, cap, x, ids, w, chunked=True, q=q)
    xt, it, wt = _port_inputs(n, x, ids, w)
    disp = ep_a2a.ep_dispatch_chunked(xt, it, wt, e, cap, n_chunks=q)
    for f in _CHUNK_FIELDS:
        np.testing.assert_array_equal(_np(getattr(disp, f)), want[f],
                                      err_msg=f)
    np.testing.assert_array_equal(disp.drops.numpy(), want["drops"])
    gu_t = torch.from_numpy(gu.reshape(n, e // n, H, 2 * INTER))
    dn_t = torch.from_numpy(dn.reshape(n, e // n, INTER, H))
    jdisp = [jep.EPChunkDispatch(**{f: jnp.asarray(want[f][r]) for f in
                                    _CHUNK_FIELDS}, drops=jnp.int32(0))
             for r in range(n)]
    jy = np.stack([np.asarray(jep.ep_expert_ffn_chunked(
        jdisp[r], jnp.asarray(gu_t[r].numpy()), jnp.asarray(dn_t[r].numpy()),
        n_chunks=q)) for r in range(n)])
    y = ep_a2a.ep_expert_ffn_chunked(disp, gu_t, dn_t, n_chunks=q)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=GEMM_ATOL)

    def combine(ys, *fields):
        d = jep.EPChunkDispatch(*fields, drops=jnp.int32(0))
        return jep.ep_combine_chunked(ys, d, M, jnp.float32, "tp",
                                      n_chunks=q)

    jout = _jax(combine, n, jy.reshape(n * n, cap, H),
                *(want[f].reshape(n * n, *want[f].shape[2:])
                  for f in _CHUNK_FIELDS),
                in_specs=(P("tp"),) * (1 + len(_CHUNK_FIELDS)))
    out = ep_a2a.ep_combine_chunked(y, disp, M, K, torch.float32,
                                    n_chunks=q)
    np.testing.assert_allclose(out.numpy(), _stacked(jout, n), rtol=0,
                               atol=GEMM_ATOL)


# -- the layer ---------------------------------------------------------


def _layer_case(n, e, seed):
    x = _rand(seed, n * M, H)
    w_router = _rand(seed + 1, H, e, scale=0.3)
    gu = _rand(seed + 2, e, H, 2 * INTER, scale=0.2)
    dn = _rand(seed + 3, e, INTER, H, scale=0.2)
    return x, w_router, gu, dn


def _jax_layer(n, x, w_router, gu, dn, ref=False, **kw):
    """The JAX ep_moe_fwd (with drops) or ep_moe_ref under shard_map."""
    def per_rank(xs, g, d):
        params = JaxEPMoEParams(jnp.asarray(w_router), g, d)
        if ref:
            return jax_ep_moe_ref(xs, params, K, axis="tp")
        y, drops = jax_ep_moe_fwd(xs, params, K, axis="tp",
                                  return_drops=True, **kw)
        return y, drops.reshape(1)

    return _jax(per_rank, n, x, gu, dn, in_specs=(P("tp"),) * 3,
                out_specs=P("tp") if ref else (P("tp"), P("tp")),
                kernel=not ref)


@pytest.mark.parametrize("n,e,capacity", [(2, 8, None), (4, 16, None),
                                          (4, 8, 4)],
                         ids=["n2", "n4", "n4-tight"])
def test_ep_moe_fwd_matches_jax(n, e, capacity):
    """ep_moe_fwd sequential and overlap (n_chunks 2) against the JAX
    layer's two paths: outputs within 1e-5, drops equal (nonzero at the
    tight capacity); the overlap path bitwise the same path over the
    single-shot transport (`_transport="plain"`, the JAX pin) and the
    plain one ("ref"); ep_moe_ref within 2e-3 of JAX's dense oracle and
    of the layer (lossless)."""
    x, w_router, gu, dn = _layer_case(n, e, 10 + n)
    params = ep_params_from_jax(w_router, gu, dn, n, device="cpu")
    xt = _t(_stacked(x, n))
    for overlap in (False, True):
        kw = dict(capacity=capacity, overlap=overlap,
                  n_chunks=2 if overlap else None)
        want, want_drops = _jax_layer(n, x, w_router, gu, dn, **kw)
        got, drops = ep_moe_fwd(xt, params, K, return_drops=True, **kw)
        np.testing.assert_allclose(got.numpy(), _stacked(want, n), rtol=0,
                                   atol=GEMM_ATOL)
        np.testing.assert_array_equal(drops.numpy(), want_drops)
        assert bool(want_drops.sum() > 0) == (capacity is not None)
    for transport in ("plain", "ref"):
        assert torch.equal(got, ep_moe_fwd(xt, params, K, capacity=capacity,
                                           overlap=True, n_chunks=2,
                                           _transport=transport))
    if capacity is None:
        ref = ep_moe_ref(xt, params, K)
        jref = _jax_layer(n, x, w_router, gu, dn, ref=True)
        np.testing.assert_allclose(ref.numpy(), _stacked(jref, n), rtol=0,
                                   atol=REF_ATOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=REF_ATOL)


def test_ep_moe_fwd_raises_what_is_not_ported():
    """The planner's chunk count (plan/) raises, and a payload_dtype not
    one byte wide, as in JAX; a chunk count fits down to a divisor of
    the capacity."""
    x, w_router, gu, dn = _layer_case(2, 8, 20)
    params = ep_params_from_jax(w_router, gu, dn, 2, device="cpu")
    xt = torch.from_numpy(_stacked(x, 2))
    with pytest.raises(NotImplementedError, match="plan/"):
        ep_moe_fwd(xt, params, K, overlap=True)
    with pytest.raises(ValueError, match="1-byte dtype"):
        ep_moe_fwd(xt, params, K, payload_dtype=torch.bfloat16)
    assert ep_a2a.fit_chunks(4, 6) == 3 and ep_a2a.fit_chunks(8, 5) == 5
    assert ep_a2a.EpMoeConfig(capacity_factor=0.5).fit_capacity(8, 2) == 8
    a = ep_moe_fwd(xt, params, K, capacity=6, overlap=True, n_chunks=4)
    b = ep_moe_fwd(xt, params, K, capacity=6, overlap=True, n_chunks=3)
    assert torch.equal(a, b)


def test_ep_params_from_jax_is_the_expert_split():
    """Rank r holds experts [r E/n, (r+1) E/n), as P(axis) gives each JAX
    device; bitwise."""
    _, w_router, gu, dn = _layer_case(4, 16, 30)
    p = ep_params_from_jax(w_router, gu, dn, 4, device="cpu")
    for r in range(4):
        np.testing.assert_array_equal(p.w_gate_up[r].numpy(),
                                      gu[4 * r:4 * r + 4])
        np.testing.assert_array_equal(p.w_down[r].numpy(),
                                      dn[4 * r:4 * r + 4])
    np.testing.assert_array_equal(p.w_router.numpy(), w_router)


def test_ep_entry_points_default_to_the_card():
    """Without device="cpu" ep_params_from_jax puts the weights on the
    card, so ep_moe_fwd on them takes the kernels: here that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, w_router, gu, dn = _layer_case(2, 8, 31)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ep_params_from_jax(w_router, gu, dn, 2)


def _jax_moe_layer(e=8):
    """A tiny JAX MoE model's parameters at mesh 1 (numpy): H 64, E e,
    top-2, expert FFN 32; and the port's copy, sharded for 4 ranks."""
    cfg = JaxModelConfig.tiny_moe(hidden_size=H, num_experts=e,
                                  num_experts_per_tok=K,
                                  moe_intermediate_size=INTER)
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jp = jax.tree.map(np.asarray, jax_init_params(cfg, mesh, seed=4))
    return jp, shard_params(params_from_jax(jp, device="cpu"), 4)


def test_ep_params_from_tp_makes_ep_equal_tp_moe_dist():
    """One layer of a tiny MoE model, sharded for TP-MoE at world 4 by
    shard_params and re-laid for EP by ep_params_from_tp: the whole
    experts of the world-1 weights, bitwise, and EP equals the TP-MoE
    `dist` block on the same tokens within 1e-5."""
    jp, p4 = _jax_moe_layer()
    lay = p4.layers.layer(0)
    tp = TPMoEParams(lay.w_router, lay.w_gate_up, lay.w_down)
    ep = ep_params_from_tp(tp)
    gu1 = jp.layers.w_gate_up[0, 0]  # (E, H, 2I) as [gate | up]
    dn1 = jp.layers.w_down[0, 0]
    want = ep_params_from_jax(jp.layers.w_router[0], gu1, dn1, 4,
                              device="cpu")
    for a, b in zip(ep, want):
        assert torch.equal(a, b)
    x = torch.from_numpy(_rand(40, 4, M, H))
    y_tp = tp_moe_fwd(x, tp, K, VirtualWorld(4, "cpu"), mode="dist")
    y_ep = ep_moe_fwd(x, ep, K)
    np.testing.assert_allclose(y_ep.numpy(), y_tp.numpy(), rtol=0,
                               atol=GEMM_ATOL)


def test_ep_slice_whole_matches_jax():
    """The slice whole at n = 4 on one tiny MoE model's layer: the JAX
    layer's own weights through the JAX ep_moe_fwd (route, dispatch, FFN,
    combine; sequential and overlap at n_chunks 2, Pallas in interpret
    mode) against the port's ep_moe_fwd on the same weights carried
    across (params_from_jax, shard_params, ep_params_from_tp), within
    1e-5; drops equal."""
    jp, p4 = _jax_moe_layer(e=16)
    lay = p4.layers.layer(0)
    ep = ep_params_from_tp(TPMoEParams(lay.w_router, lay.w_gate_up,
                                       lay.w_down))
    x = _rand(41, 4 * M, H)
    xt = torch.from_numpy(_stacked(x, 4))
    for kw in (dict(), dict(overlap=True, n_chunks=2, capacity=8)):
        want, want_drops = _jax_layer(
            4, x, jp.layers.w_router[0], jp.layers.w_gate_up[0, 0],
            jp.layers.w_down[0, 0], **kw)
        got, drops = ep_moe_fwd(xt, ep, K, return_drops=True, **kw)
        np.testing.assert_allclose(got.numpy(), _stacked(want, 4), rtol=0,
                                   atol=GEMM_ATOL)
        np.testing.assert_array_equal(drops.numpy(), want_drops)


# -- grouped_gemm with group sizes a rank (the EP FFN's) ---------------------


def test_grouped_gemm_sizes_a_rank(monkeypatch):
    """grouped_gemm with (n, E) group sizes, one row a rank: the plain
    loop against each rank's own (E,) call, bitwise; the f32-out card
    route (`_expert_rows`, on the CPU with the f32 product standing in
    for `torch.bmm(out_dtype=float32)`) within 1e-5 of the loop, with
    and without the sizes handed over on the host; rows past a rank's
    last group zero."""
    from triton_dist_tpu_torch.kernels import grouped_gemm as gg

    n, t, k, nn = 3, 40, 32, 24
    sizes = torch.tensor([[5, 0, 20, 3], [0, 0, 0, 0], [12, 12, 12, 4]])
    x = torch.from_numpy(_rand(50, n, t, k)).bfloat16()
    w = torch.from_numpy(_rand(51, n, 4, k, nn, scale=0.2)).bfloat16()
    want = gg.grouped_gemm_plain(x, w, sizes, out_dtype=torch.float32)
    for r in range(n):
        assert torch.equal(want[r], gg.grouped_gemm_plain(
            x[r], w[r], sizes[r], out_dtype=torch.float32))
    assert not want[0, 28:].any() and not want[1].any()
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: bmm(
        a.float(), b.float()))
    for host in (None, sizes.tolist()):
        got = gg._expert_rows(x, w, sizes, torch.float32, host_sizes=host)
        torch.testing.assert_close(got, want, rtol=0, atol=GEMM_ATOL)

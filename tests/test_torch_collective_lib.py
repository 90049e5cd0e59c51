"""The port's collective library (triton_dist_tpu_torch.kernels:
full_mesh_all_gather, all_gather, all_reduce, the three *_op host
entries, p2p_send / p2p_read and ring_shift) against the JAX package's.

On the CPU each kernel wrapper runs its plain version. The JAX functions
run under `jax.shard_map` on a mesh of n in {2, 4} of the 12 virtual CPU
devices, as tests/test_torch_collectives.py runs them; with the spare
devices the real interpret-mode protocols run (the full-mesh test
asserts its kernel ran; p2p_send takes the JAX package's own fallback
where its interpreter cannot run rank-divergent puts). The port's
tensors are rank-stacked: rank r's shard is [r]. Same numpy inputs for
both.

Tolerances: data movement bitwise; the one-shot and two-shot
AllReduce bitwise in f32 and bf16 (both fold as the JAX kernels do);
the XLA AllReduce 1e-6 (lax.psum's order against the port's rank-order
f32 fold). Auto's routes are compared where they do not depend on a
chip. The CUDA kernels run only on the card: tests/test_torch_cuda.py
and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import triton_dist_tpu.kernels.allgather as jax_ag
import triton_dist_tpu.kernels.allreduce as jax_ar
from triton_dist_tpu.kernels.p2p import p2p_read as jax_p2p_read
from triton_dist_tpu.kernels.p2p import p2p_send as jax_p2p_send
from triton_dist_tpu.kernels.p2p import ring_shift as jax_ring_shift
from triton_dist_tpu.kernels.reduce_scatter import (
    reduce_scatter_op as jax_reduce_scatter_op,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import allgather as ag
from triton_dist_tpu_torch.kernels import allreduce as ar

XLA_AR_ATOL = 1e-6


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mesh(n, axis="tp"):
    return make_mesh(mesh_shape=(n,), axis_names=(axis,))


def _jax_run(fn, n, x, axis="tp", out_specs=None):
    """fn per device under shard_map on an n-device mesh, x sharded on
    its leading dim; the global result as numpy."""
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=_mesh(n, axis), in_specs=P(axis),
        out_specs=P(axis) if out_specs is None else out_specs,
        check_vma=False))(x))


def _pair(x, dtype):
    """The same values as a torch tensor and a JAX-ready numpy / jnp
    array (bf16 values cross exactly)."""
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.bfloat16()
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return t, x


def _np(t):
    return t.float().numpy()


# -- AllGather --------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_mesh_all_gather_matches_jax_bitwise(n, dtype):
    m, w = 8, 128
    xt, xj = _pair(_rand(40 + n, n, m, w), dtype)
    before = pallas_call_count()
    want = _jax_run(functools.partial(jax_ag.full_mesh_all_gather,
                                      axis="tp"), n,
                    xj.reshape(n * m, w))
    assert pallas_call_count() > before, "the JAX kernel did not run"
    got = kernels.full_mesh_all_gather(xt)
    assert got.shape == (n, n * m, w) and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got).reshape(n * n * m, w),
                                  np.asarray(want, np.float32))
    assert torch.equal(got, kernels.full_mesh_all_gather_plain(xt))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["full_mesh", "ring_1d", "xla", "auto"])
def test_all_gather_every_method_matches_jax_bitwise(n, method):
    m, w = 4, 128
    x = _rand(50 + n, n, m, w)
    want = _jax_run(functools.partial(
        jax_ag.all_gather, axis="tp",
        method=jax_ag.AllGatherMethod(method)), n, x.reshape(n * m, w))
    got = kernels.all_gather(torch.from_numpy(x),
                             method=kernels.AllGatherMethod(method))
    np.testing.assert_array_equal(got.numpy().reshape(n * n * m, w), want)


def _traced_ag_route(monkeypatch, n, rows, w):
    """Which kernel the JAX all_gather(Auto) traces for a (rows, w) bf16
    shard, and which the port's calls: ('full_mesh' | 'ring_1d') each."""
    seen = {}
    for mod, key in ((jax_ag, "jax"), (ag, "port")):
        for name, route in (("full_mesh_all_gather", "full_mesh"),
                            ("ring_all_gather", "ring_1d")):
            real = getattr(mod, name)

            def rec(*a, _real=real, _key=key, _route=route, **kw):
                seen[_key] = _route
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, rec)
    jax.eval_shape(jax.shard_map(
        functools.partial(jax_ag.all_gather, axis="tp"), mesh=_mesh(n),
        in_specs=P("tp"), out_specs=P("tp"), check_vma=False),
        jax.ShapeDtypeStruct((n * rows, w), jnp.bfloat16))
    ag.all_gather(torch.zeros((n, rows, w), dtype=torch.bfloat16))
    return seen


@pytest.mark.parametrize("rows,route", [(128, "full_mesh"),
                                        (129, "ring_1d")])
def test_all_gather_auto_route_matches_jax(monkeypatch, rows, route):
    """Auto measures a rank's shard: (128, 4096) bf16 is exactly 1 MiB
    and goes full mesh, one row more goes the ring, in both libraries."""
    seen = _traced_ag_route(monkeypatch, 4, rows, 4096)
    assert seen == {"jax": route, "port": route}
    nbytes = rows * 4096 * 2
    assert (kernels.choose_allgather_method(nbytes).value
            == jax_ag.choose_allgather_method(nbytes).value == route)


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_op_matches_jax_bitwise(n):
    m, w = 8, 128
    x = _rand(60 + n, n * m, w)
    want = np.asarray(jax_ag.all_gather_op(jnp.asarray(x), _mesh(n), "tp"))
    got = kernels.all_gather_op(torch.from_numpy(x).reshape(n, m, w))
    assert got.shape == (n * m, w)
    np.testing.assert_array_equal(got.numpy(), want)


# -- AllReduce --------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
def test_all_reduce_kernel_methods_match_jax_bitwise(n, dtype, method):
    """OneShot folds in rank order, TwoShot is the ring RS's fold then
    the ring AG, each add rounded to x.dtype, in the JAX kernels and the
    port alike."""
    m, w = 8, 128
    xt, xj = _pair(_rand(70 + n, n, m, w, scale=4.0), dtype)
    want = _jax_run(functools.partial(
        jax_ar.all_reduce, axis="tp",
        method=jax_ar.AllReduceMethod(method)), n, xj.reshape(n * m, w))
    got = kernels.all_reduce(xt, method=kernels.AllReduceMethod(method))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got).reshape(n * m, w),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_xla_matches_jax(n):
    m, w = 8, 128
    x = _rand(80 + n, n, m, w)
    want = _jax_run(functools.partial(jax_ar.all_reduce, axis="tp",
                                      method=jax_ar.AllReduceMethod.XLA), n,
                    x.reshape(n * m, w))
    got = kernels.all_reduce(torch.from_numpy(x),
                             method=kernels.AllReduceMethod.XLA)
    np.testing.assert_allclose(got.numpy().reshape(n * m, w), want,
                               rtol=0, atol=XLA_AR_ATOL)
    assert torch.equal(got, got[:1].expand_as(got))


def _traced_ar_route(monkeypatch, n, rows, w):
    """The method each library's all_reduce(Auto) takes for a (rows, w)
    bf16 tensor a rank: 'one_shot', 'two_shot' or 'xla' (neither)."""
    seen = {}
    for mod, key in ((jax_ar, "jax"), (ar, "port")):
        for name, route in (("one_shot_all_reduce", "one_shot"),
                            ("two_shot_all_reduce", "two_shot")):
            real = getattr(mod, name)

            def rec(*a, _real=real, _key=key, _route=route, **kw):
                seen[_key] = _route
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, rec)
    jax.eval_shape(jax.shard_map(
        functools.partial(jax_ar.all_reduce, axis="tp"), mesh=_mesh(n),
        in_specs=P("tp"), out_specs=P("tp"), check_vma=False),
        jax.ShapeDtypeStruct((n * rows, w), jnp.bfloat16))
    ar.all_reduce(torch.zeros((n, rows, w), dtype=torch.bfloat16))
    return {k: seen.get(k, "xla") for k in ("jax", "port")}


@pytest.mark.parametrize("rows,route", [
    (31, "one_shot"),   # 31 % 4 != 0, 248 KiB: under the cap
    (33, "xla"),        # 33 % 4 != 0, 264 KiB: over the cap
    (36, "two_shot"),   # divisible, 288 KiB: over the cap
    (512, "two_shot"),
], ids=["ragged-small", "ragged-large", "over-cap", "prefill"])
def test_all_reduce_auto_route_matches_jax(monkeypatch, rows, route):
    """The chip-independent parts of the Auto rule, (rows, 4096) bf16 a
    rank at n = 4: a leading dim not divisible by n takes OneShot up to
    256 KiB and XLA above; a divisible one above the cap TwoShot."""
    assert _traced_ar_route(monkeypatch, 4, rows, 4096) == {
        "jax": route, "port": route}


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_auto_below_the_cap_uses_the_measured_crossover(n):
    """Below the cap the port asks its card-measured crossover (JAX asks
    its TPU perf model): one-shot up to it, two-shot above; the
    crossover is never above the cap."""
    cross = ar._ONE_SHOT_CROSSOVER_BYTES
    assert cross <= ar._ONE_SHOT_MAX_BYTES
    assert ar.choose_allreduce_method(4096, n).value == "one_shot"
    assert ar.choose_allreduce_method(cross, n).value == "one_shot"
    assert ar.choose_allreduce_method(cross + 1, n).value == "two_shot"
    cap = ar._ONE_SHOT_MAX_BYTES
    assert ar.choose_allreduce_method(cap, n, divisible=False).value == \
        "one_shot"
    assert ar.choose_allreduce_method(cap + 1, n, divisible=False).value == \
        "xla"


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_op_matches_jax(n):
    """The host entry over the stacked contributions, OneShot and
    TwoShot bitwise."""
    m, w = 8, 128
    x = _rand(90 + n, n, m, w)
    for method in ("one_shot", "two_shot"):
        want = np.asarray(jax_ar.all_reduce_op(
            jnp.asarray(x), _mesh(n), "tp",
            method=jax_ar.AllReduceMethod(method)))
        got = kernels.all_reduce_op(torch.from_numpy(x),
                                    method=kernels.AllReduceMethod(method))
        assert got.shape == (m, w)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 4])
def test_reduce_scatter_op_matches_jax_bitwise(n):
    m, w = 4, 128
    x = _rand(100 + n, n, n * m, w)
    want = np.asarray(jax_reduce_scatter_op(jnp.asarray(x), _mesh(n), "tp"))
    got = kernels.reduce_scatter_op(torch.from_numpy(x))
    assert got.shape == (n * m, w)
    np.testing.assert_array_equal(got.numpy(), want)


# -- point to point ---------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(0, 3), (2, 1), (2, 2)])
def test_p2p_send_matches_jax_bitwise(src, dst):
    n, m, w = 4, 8, 128
    x = _rand(src * 10 + dst, n, m, w)
    want = _jax_run(functools.partial(jax_p2p_send, src_rank=src,
                                      dst_rank=dst, axis="pp"), n,
                    x.reshape(n * m, w), axis="pp")
    got = kernels.p2p_send(torch.from_numpy(x), src, dst)
    np.testing.assert_array_equal(got.numpy().reshape(n * m, w), want)
    assert torch.equal(got[dst], torch.from_numpy(x[src]))


def test_p2p_read_matches_jax_bitwise():
    n, m, w = 4, 8, 128
    x = _rand(7, n, m, w)
    want = _jax_run(functools.partial(jax_p2p_read, reader_rank=3,
                                      owner_rank=1, axis="pp"), n,
                    x.reshape(n * m, w), axis="pp")
    got = kernels.p2p_read(torch.from_numpy(x), 3, 1)
    np.testing.assert_array_equal(got.numpy().reshape(n * m, w), want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shift", [1, -1, 3, "n+1"])
def test_ring_shift_matches_jax_bitwise(n, shift):
    shift = n + 1 if shift == "n+1" else shift
    m, w = 8, 128
    x = _rand(110 + n + shift % 7, n, m, w)
    want = _jax_run(functools.partial(jax_ring_shift, shift=shift,
                                      axis="pp"), n,
                    x.reshape(n * m, w), axis="pp")
    got = kernels.ring_shift(torch.from_numpy(x), shift)
    np.testing.assert_array_equal(got.numpy().reshape(n * m, w), want)


def test_p2p_world_one_returns_the_input():
    x = torch.ones(1, 3, 8)
    assert kernels.p2p_send(x, 0, 0) is x
    assert kernels.ring_shift(x, 5) is x
    assert kernels.full_mesh_all_gather(x) is x
    with pytest.raises(ValueError, match="outside the world"):
        kernels.p2p_send(torch.ones(4, 3), 0, 4)


# -- out of scope -----------------------------------------------------------


@pytest.mark.parametrize("call,item", [
    (lambda x: kernels.all_gather(x, axis=("dcn", "tp")), "item 15"),
    (lambda x: kernels.all_gather(x, method=kernels.AllGatherMethod.Ring2D),
     "item 15"),
    (lambda x: kernels.all_reduce(x, wire_format="auto"), "item 7"),
    (lambda x: kernels.all_reduce(x, error_budget=1e-3), "item 7"),
    (lambda x: kernels.all_reduce(x, axis=("dcn", "tp")), "item 15"),
    (lambda x: kernels.all_reduce_op(x, fallback="xla"), "item 8"),
], ids=["ag-axes", "ag-ring2d", "ar-auto-wire", "ar-budget", "ar-axes",
        "ar-op-fallback"])
def test_out_of_scope_options_raise(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call(torch.ones(4, 8, 16))


def test_all_reduce_op_rejects_an_unknown_fallback():
    with pytest.raises(ValueError, match="unknown fallback"):
        kernels.all_reduce_op(torch.ones(4, 8, 16), fallback="nccl")

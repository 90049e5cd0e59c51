"""The port's sequence-parallel attention path against the JAX package's:
the decode partial and combine (kernels/flash_decode.py), the
low-latency AllGather (kernels/low_latency_allgather.py), the SP decode
layer (layers/sp_flash_decode.py), ring attention (kernels/
sp_attention.py), SP flash prefill (kernels/flash_prefill.py), the
weights' carry-over, and the slice whole: SP prefill -> cache -> decode.

Inputs come from a numpy seed, in f32, at tiny widths (Hq 4, Hkv 2,
D 16). The JAX functions run as their own tests run them: under
`jax.shard_map` on n of the 12 virtual CPU devices, with the spare
devices the real interpret-mode protocols, and the tests assert with
`pallas_call_count` that the JAX kernel ran. On the CPU the port's
kernel wrappers run their plain versions; the port's tensors are
rank-stacked (rank r at [r]). Tolerance 2e-5 (f32 sums in another
order) unless stated; the LL AllGather is data movement, bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels.flash_decode import (
    create_sp_decode_buf as jax_create_sp_decode_buf,
)
from triton_dist_tpu.kernels.flash_decode import (
    flash_decode_combine as jax_combine,
)
from triton_dist_tpu.kernels.flash_decode import (
    flash_decode_partial as jax_partial,
)
from triton_dist_tpu.kernels.flash_decode import (
    flash_decode_partial_pallas as jax_partial_pallas,
)
from triton_dist_tpu.kernels.flash_decode import (
    sp_flash_decode as jax_sp_flash_decode,
)
from triton_dist_tpu.kernels.flash_prefill import (
    flash_prefill_ref as jax_flash_prefill_ref,
)
from triton_dist_tpu.kernels.flash_prefill import (
    sp_flash_prefill as jax_sp_flash_prefill,
)
from triton_dist_tpu.kernels.low_latency_allgather import (
    create_ll_ag_buffer as jax_create_ll_ag_buffer,
)
from triton_dist_tpu.kernels.low_latency_allgather import (
    ll_all_gather as jax_ll_all_gather,
)
from triton_dist_tpu.kernels.sp_attention import (
    ring_attention as jax_ring_attention,
)
from triton_dist_tpu.kernels.sp_attention import (
    ring_attention_ref as jax_ring_attention_ref,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.layers import SpDecodeParams as JaxSpDecodeParams
from triton_dist_tpu.layers import apply_rope as jax_apply_rope
from triton_dist_tpu.layers import rms_norm as jax_rms_norm
from triton_dist_tpu.layers import rope_table as jax_rope_table
from triton_dist_tpu.layers import sp_decode_attn_fwd as jax_sp_decode
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch.kernels import flash_decode as fd
from triton_dist_tpu_torch.kernels import flash_prefill as fp
from triton_dist_tpu_torch.kernels import low_latency_allgather as llag
from triton_dist_tpu_torch.kernels import sp_attention as spa
from triton_dist_tpu_torch.layers import apply_rope, rms_norm, rope_table
from triton_dist_tpu_torch.layers import sp_flash_decode as spl

ATOL = 2e-5
HQ, HKV, D = 4, 2, 16


def _rand(seed, *shape, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, n, *args, in_specs, out_specs, kernel=True):
    """fn per device under shard_map on an n-device mesh, the global
    result(s) as numpy; with kernel, asserts that a Pallas kernel ran
    (interpret mode), not an XLA fallback."""
    before = pallas_call_count()
    mesh = make_mesh(mesh_shape=(n,), axis_names=("tp",))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))(*args)
    if kernel:
        assert pallas_call_count() > before, "the JAX kernel did not run"
    return jax.tree.map(np.asarray, out)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _stack(x, n):
    """A global (B, n*S, ...) array -> rank-stacked (n, B, S, ...)."""
    b = x.shape[0]
    return np.ascontiguousarray(
        x.reshape(b, n, x.shape[1] // n, *x.shape[2:]).swapaxes(0, 1))


# -- the decode partial and combine ----------------------------------------


def test_flash_decode_partial_matches_jax():
    """The plain partial and the kernel's wrapper (its plain version on
    the CPU) against the JAX XLA partial and the Pallas one (chunk 16):
    valid lengths mid-page, 0 and full; an empty row is o = 0, lse =
    NEG_INF exactly."""
    b, t = 3, 64
    q, k, v = (_rand(1, b, HQ, D), _rand(2, b, t, HKV, D),
               _rand(3, b, t, HKV, D))
    valid = np.array([37, 0, 64], np.int32)
    o_x, lse_x = jax.jit(jax_partial)(q, k, v, valid)
    before = pallas_call_count()
    o_p, lse_p = jax.jit(functools.partial(jax_partial_pallas, chunk=16))(
        q, k, v, valid)
    assert pallas_call_count() > before
    kernels.reset_launches()
    for fn in (fd.flash_decode_partial, fd.flash_decode_partial_cuda):
        o, lse = fn(_t(q), _t(k), _t(v), _t(valid))
        for want_o, want_lse in ((o_x, lse_x), (o_p, lse_p)):
            _close(o, want_o)
            _close(lse, want_lse)
        assert torch.all(o[1] == 0) and torch.all(lse[1] == fd.NEG_INF)
    assert kernels.launches()["flash_decode_partial"] == 0  # plain on CPU


def test_flash_decode_combine_matches_jax():
    n, b = 4, 2
    o = _rand(4, n, b, HQ, D)
    lse = _rand(5, n, b, HQ, scale=3.0)
    lse[2, 0] = -1e30  # an empty shard
    lse[:, 1, 0] = -1e30  # a head with no valid key on any rank
    want = np.asarray(jax_combine(o, lse))
    got = fd.flash_decode_combine(_t(o), _t(lse))
    _close(got, want)
    assert fd.partials_buf_shape(b, HQ, D) == (b, 128)


# -- the low-latency AllGather -----------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ll_all_gather_matches_jax_bitwise(n):
    """Three calls on one context (the third reuses parity 0's slots):
    every gathered copy and the context's slots bitwise the JAX kernel's,
    the parity flags at call_count + 1."""
    calls, rows, cols = 3, 8, 16
    xs = _rand(10 + n, calls, n * rows, cols)

    def per_device(x):
        buf = jax_create_ll_ag_buffer(x.shape[1:], x.dtype, n)
        outs = []
        for i in range(calls):
            out, buf = jax_ll_all_gather(x[i], buf, i, "tp")
            outs.append(out)
        return jnp.stack(outs)[None], buf[None]

    want, want_buf = _jax(per_device, n, xs, in_specs=P(None, "tp"),
                          out_specs=(P("tp"), P("tp")))
    ctx = llag.create_ll_ag_buffer((rows, cols), torch.float32, n,
                                   device="cpu")
    for i in range(calls):
        x = _t(xs[i].reshape(n, rows, cols))
        got, ctx = llag.ll_all_gather(x, ctx, i)
        assert got.shape == (n, n, rows, cols)
        np.testing.assert_array_equal(got.numpy(), want[:, i])
        assert torch.equal(got, x[None].expand(n, *x.shape))
    np.testing.assert_array_equal(ctx.data.numpy(), want_buf)
    assert ctx.flags[:, :n].eq(3).all() and ctx.flags[:, n:2 * n].eq(2).all()
    with pytest.raises(ValueError, match="does not fit"):
        llag.ll_all_gather(x, ctx, 3, wire_format="fp8")


# -- sp_flash_decode and the SP decode layer --------------------------------


def test_sp_flash_decode_matches_jax():
    """n = 4, three steps: the JAX function with and without its LL
    context; the port's with (the LL AllGather's plain version) and
    without (a torch copy) agree bitwise with each other."""
    n, b, t_max, steps = 4, 2, 64, 3
    kv_len = np.array([37, 64], np.int32)
    qs = _rand(20, steps, b, HQ, D)
    k, v = _rand(21, b, t_max, HKV, D), _rand(22, b, t_max, HKV, D)

    def per_device(use_ll, q_all, ks, vs):
        buf = jax_create_sp_decode_buf(b, HQ, D, n) if use_ll else None
        outs = []
        for i in range(steps):
            if use_ll:
                y, buf = jax_sp_flash_decode(q_all[i], ks, vs, kv_len, "tp",
                                             ll_buf=buf, call_count=i)
            else:
                y = jax_sp_flash_decode(q_all[i], ks, vs, kv_len, "tp")
            outs.append(y)
        return jnp.stack(outs)

    ks, vs = _t(_stack(k, n)), _t(_stack(v, n))
    ctx = fd.create_sp_decode_buf(b, HQ, D, n, device="cpu")
    for use_ll in (True, False):
        want = _jax(functools.partial(per_device, use_ll), n, qs, k, v,
                    in_specs=(P(), P(None, "tp"), P(None, "tp")),
                    out_specs=P(), kernel=use_ll)
        for i in range(steps):
            q = _t(np.broadcast_to(qs[i], (n, b, HQ, D)))
            got, ctx = fd.sp_flash_decode(q, ks, vs, _t(kv_len), ll_buf=ctx,
                                          call_count=i)
            plain = fd.sp_flash_decode(q, ks, vs, _t(kv_len))
            assert torch.equal(got, plain)
            for r in range(n):
                _close(got[r], want[i])


def _sp_params(seed, h, dtype=np.float32):
    return JaxSpDecodeParams(
        w_qkv=_rand(seed, h, (HQ + 2 * HKV) * D, scale=0.1).astype(dtype),
        w_o=_rand(seed + 1, HQ * D, h, scale=0.1).astype(dtype),
        q_norm=(1 + _rand(seed + 2, D, scale=0.1)).astype(dtype),
        k_norm=(1 + _rand(seed + 3, D, scale=0.1)).astype(dtype))


def test_sp_decode_layer_matches_jax():
    """Steps that move a row's write from rank to rank (row 0: positions
    9-12, rank 2 -> 3), q/k-norm, the LL context threaded through; row 1
    writes at T_max on the last step, which is dropped. The outputs and
    every rank's cache shard against the JAX layer."""
    n, b, h, t_max, steps = 4, 2, 32, 16, 4
    start = np.array([9, 13], np.int32)
    jp = _sp_params(30, h)
    xs = _rand(34, steps, b, h, scale=0.5)
    cos, sin = jax_rope_table(D, t_max + 1)
    spec = spl.SpDecodeSpec(HQ, HKV, D)

    def per_device(x_all, kc, vc):
        buf = jax_create_sp_decode_buf(b, HQ, D, n)
        cache, outs = (kc, vc), []
        for i in range(steps):
            y, cache, buf = jax_sp_decode(
                x_all[i], jp, spec, cos, sin, cache, start + i, axis="tp",
                ll_buf=buf, call_count=i)
            outs.append(y)
        return jnp.stack(outs), cache[0], cache[1]

    kc0 = _rand(35, b, t_max, HKV, D)
    vc0 = _rand(36, b, t_max, HKV, D)
    want, want_k, want_v = _jax(
        per_device, n, xs, kc0, vc0,
        in_specs=(P(), P(None, "tp"), P(None, "tp")),
        out_specs=(P(), P(None, "tp"), P(None, "tp")))
    params = spl.sp_params_from_jax(jp, device="cpu")
    tcos, tsin = rope_table(D, t_max + 1, device="cpu")
    cache = (_t(_stack(kc0, n)), _t(_stack(vc0, n)))
    ctx = fd.create_sp_decode_buf(b, HQ, D, n, device="cpu")
    for i in range(steps):
        x = _t(np.broadcast_to(xs[i], (n, b, h)))
        y, cache, ctx = spl.sp_decode_attn_fwd(
            x, params, spec, tcos, tsin, cache, _t(start + i), ll_buf=ctx,
            call_count=i)
        for r in range(n):
            _close(y[r], want[i])
    _close(cache[0], _stack(want_k, n))
    _close(cache[1], _stack(want_v, n))
    # row 0 wrote positions 9-12; row 1 wrote 13-15, and its write at
    # T_max = 16 was dropped
    moved = (cache[0] != _t(_stack(kc0, n))).flatten(3).any(-1)
    assert moved[:, 0].sum() == 4 and moved[:, 1].sum() == 3


def test_sp_cache_write_drops_past_t_max():
    n, b, t_loc = 2, 3, 4
    cache = torch.zeros((n, b, t_loc, HKV, D))
    new = torch.ones((n, b, HKV, D))
    spl.sp_cache_write(cache, new, torch.tensor([0, 5, 8]))
    assert cache[0, 0, 0].eq(1).all() and cache[1, 1, 1].eq(1).all()
    assert cache.sum() == 2 * HKV * D  # position 8 = T_max: dropped


def test_sp_params_carry_over_bitwise():
    import ml_dtypes

    from triton_dist_tpu_torch.models import ModelConfig
    from triton_dist_tpu_torch.models.dense import init_params

    for dtype in (np.float32, ml_dtypes.bfloat16):
        jp = _sp_params(40, 32, dtype)
        tp = spl.sp_params_from_jax(jp, device="cpu")
        for name in spl.SpDecodeParams._fields:
            a = np.asarray(getattr(jp, name))
            got = getattr(tp, name)
            assert got.shape == a.shape
            assert np.array_equal(got.float().numpy(), a.astype(np.float32))
    cfg = ModelConfig.tiny(dtype="float32", num_layers=2)
    dense = init_params(cfg, device="cpu", seed=0)
    sp = spl.sp_params_from_dense(dense, layer=1)
    assert torch.equal(sp.w_qkv, dense.layers.w_qkv[1, 0])
    assert torch.equal(sp.w_o, dense.layers.w_o[1, 0])
    assert torch.equal(sp.q_norm, dense.layers.q_norm[1])


# -- ring attention and SP flash prefill ------------------------------------


def _prefill_inputs(seed, n, b, s_loc):
    s = n * s_loc
    return (_rand(seed, b, s, HQ, D), _rand(seed + 1, b, s, HKV, D),
            _rand(seed + 2, b, s, HKV, D))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(n, causal):
    b, s_loc = 2, 8
    q, k, v = _prefill_inputs(50 + n, n, b, s_loc)
    kv_len = np.array([n * s_loc - 3, 5], np.int32)
    specs = dict(in_specs=(P(None, "tp"),) * 3, out_specs=P(None, "tp"),
                 kernel=False)
    want = _jax(functools.partial(jax_ring_attention, axis="tp",
                                  causal=causal, kv_len=kv_len), n, q, k, v,
                **specs)
    want_ref = _jax(functools.partial(jax_ring_attention_ref, axis="tp",
                                      causal=causal, kv_len=kv_len), n, q, k,
                    v, **specs)
    args = [_t(_stack(a, n)) for a in (q, k, v)]
    got = spa.ring_attention(*args, causal=causal, kv_len=_t(kv_len))
    got_ref = spa.ring_attention_ref(*args, causal=causal, kv_len=_t(kv_len))
    _close(got, _stack(want, n))
    _close(got_ref, _stack(want_ref, n))


@pytest.mark.parametrize("n", [2, 4])
def test_sp_flash_prefill_matches_jax(n):
    """The port's SP prefill (its plain version on the CPU) against the
    JAX kernel (the real per-segment protocol) and JAX flash_prefill_ref:
    varlen, GQA, causal, pages of 8; the impl switch; a subset of rows by
    q_positions equals those rows of the whole."""
    b, s_loc = 2, 16
    q, k, v = _prefill_inputs(60 + n, n, b, s_loc)
    kv_len = np.array([n * s_loc - 3, s_loc + 5], np.int32)
    specs = dict(in_specs=(P(None, "tp"),) * 3, out_specs=P(None, "tp"))
    want = _jax(functools.partial(jax_sp_flash_prefill, axis="tp",
                                  kv_len=kv_len, block=8), n, q, k, v,
                **specs)
    want_ref = _jax(functools.partial(jax_flash_prefill_ref, axis="tp",
                                      kv_len=kv_len, block=8), n, q, k, v,
                    kernel=False, **specs)
    np.testing.assert_array_equal(want, want_ref)
    args = [_t(_stack(a, n)) for a in (q, k, v)]
    kl = _t(kv_len)
    got = fp.sp_flash_prefill(*args, kv_len=kl, block=8)
    _close(got, _stack(want, n))
    assert torch.equal(fp.sp_flash_prefill(*args, kv_len=kl),
                       fp.sp_prefill_attention(*args, kv_len=kl,
                                               impl="flash"))
    _close(fp.sp_prefill_attention(*args, kv_len=kl, impl="ring"), got)
    with pytest.raises(NotImplementedError, match="choose_sp_prefill_impl"):
        fp.sp_prefill_attention(*args, kv_len=kl)
    rows = torch.tensor([0, 5, s_loc - 1])
    pos = (torch.arange(n)[:, None] * s_loc + rows).expand(b, n, 3)
    sub = fp.flash_prefill_ref(args[0][:, :, rows], args[1], args[2],
                               kv_len=kl, block=8,
                               q_positions=pos.transpose(0, 1))
    _close(sub, got[:, :, rows])


def test_sp_flash_prefill_world_one_is_the_local_kernel():
    q, k, v = _prefill_inputs(70, 1, 2, 8)
    args = [_t(a[None]) for a in (q, k, v)]
    kernels.reset_launches()
    got = fp.sp_flash_prefill(*args)
    want = fp.flash_prefill_plain(*(a[0] for a in args))
    assert torch.equal(got[0], want)
    assert got.shape == args[0].shape


# -- the slice whole ---------------------------------------------------------


def test_sp_slice_whole_matches_jax():
    """n = 4: the SP prefill layer (QKV product, q/k-norm, rope,
    sp_flash_prefill, O product) over a ragged batch whose cache is each
    rank's K/V segment, then 4 SP decode steps with an LL context (row 0
    fills the cache to its last position, row 1 crosses from rank 1 to
    rank 2); the port against the same composition of JAX functions."""
    n, b, h, s_loc, steps = 4, 2, 32, 8, 4
    t_max = n * s_loc
    kv_len = np.array([t_max - 4, 2 * s_loc - 2], np.int32)
    jp = _sp_params(80, h)
    x = _rand(84, b, t_max, h, scale=0.5)
    xs = _rand(85, steps, b, h, scale=0.5)
    cos, sin = jax_rope_table(D, t_max)
    spec = spl.SpDecodeSpec(HQ, HKV, D)

    def per_device(x_loc, x_all):
        me = jax.lax.axis_index("tp")
        qkv = jnp.dot(x_loc, jp.w_qkv)
        q, k, v = jnp.split(qkv, [HQ * D, (HQ + HKV) * D], axis=-1)
        q = jax_rms_norm(q.reshape(b, s_loc, HQ, D), jp.q_norm)
        k = jax_rms_norm(k.reshape(b, s_loc, HKV, D), jp.k_norm)
        v = v.reshape(b, s_loc, HKV, D)
        pos = jnp.broadcast_to(me * s_loc + jnp.arange(s_loc), (b, s_loc))
        q = jax_apply_rope(q, cos, sin, pos)
        k = jax_apply_rope(k, cos, sin, pos)
        att = jax_sp_flash_prefill(q, k, v, "tp", kv_len=kv_len)
        y = jnp.dot(att.reshape(b, s_loc, HQ * D), jp.w_o)
        buf = jax_create_sp_decode_buf(b, HQ, D, n)
        cache, outs = (k, v), []
        for i in range(steps):
            yd, cache, buf = jax_sp_decode(
                x_all[i], jp, spec, cos, sin, cache, kv_len + i, axis="tp",
                ll_buf=buf, call_count=i)
            outs.append(yd)
        return y, jnp.stack(outs), cache[0]

    want_y, want_dec, want_k = _jax(
        per_device, n, x, xs, in_specs=(P(None, "tp"), P()),
        out_specs=(P(None, "tp"), P(), P(None, "tp")))

    params = spl.sp_params_from_jax(jp, device="cpu")
    tcos, tsin = rope_table(D, t_max, device="cpu")
    xt = _t(_stack(x, n))  # (n, B, S, H)
    qkv = torch.matmul(xt, params.w_qkv)
    q, k, v = torch.split(qkv, [HQ * D, HKV * D, HKV * D], dim=-1)
    q = rms_norm(q.reshape(n, b, s_loc, HQ, D), params.q_norm)
    k = rms_norm(k.reshape(n, b, s_loc, HKV, D), params.k_norm)
    v = v.reshape(n, b, s_loc, HKV, D).contiguous()
    pos = (torch.arange(n)[:, None] * s_loc
           + torch.arange(s_loc))[:, None].expand(n, b, s_loc)
    q = apply_rope(q, tcos, tsin, pos)
    k = apply_rope(k, tcos, tsin, pos).contiguous()
    att = fp.sp_prefill_attention(q, k, v, kv_len=_t(kv_len), impl="flash")
    y = torch.matmul(att.reshape(n, b, s_loc, HQ * D), params.w_o)
    _close(y, _stack(want_y, n))
    cache = (k, v)
    ctx = fd.create_sp_decode_buf(b, HQ, D, n, device="cpu")
    for i in range(steps):
        xd = _t(np.broadcast_to(xs[i], (n, b, h)))
        yd, cache, ctx = spl.sp_decode_attn_fwd(
            xd, params, spec, tcos, tsin, cache, _t(kv_len + i), ll_buf=ctx,
            call_count=i)
        for r in range(n):
            _close(yd[r], want_dec[i])
    _close(cache[0], _stack(want_k, n))


def test_sp_entry_points_default_to_the_card():
    """Without device="cpu" the contexts are made on the card: here that
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fd.create_sp_decode_buf(2, HQ, D, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llag.create_ll_ag_buffer((2, 8), torch.float32, 2)

"""The port's sequence-parallel attention path against the JAX package's:
the decode partial and combine (kernels/flash_decode.py), the
low-latency AllGather (kernels/low_latency_allgather.py; its call count
an int or a device tensor), the SP decode layer (layers/sp_flash_decode.py;
its self-advancing step against the JAX layer under jit with a traced
count), ring attention (kernels/
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


# -- the decode partial's Hopper body: its rule, work plan and pools --------

# phase 4s's 16 (rank, row) valid lengths at its last decode step, and a
# ragged set: empty, 1, inside a tile, across tiles, T not a multiple
_DECODE_LENS = [((8192,) * 7 + (14, 8192, 8192, 12, 0, 8192, 10, 0, 0),
                 8192),
                ((0, 1, 37, 300, 700, 1100, 129, 16), 1100)]


@pytest.mark.parametrize("dtype,d,g,body", [
    (torch.bfloat16, 128, 4, "mma"),  # Qwen3-8B: the main path's form
    (torch.bfloat16, 128, 8, "mma"),  # the widest group, G * D = 1024
    (torch.bfloat16, 128, 1, "mma"),
    (torch.float32, 128, 4, "fma"),  # f32 keeps the CUDA-core body
    (torch.bfloat16, 64, 2, "fma"),  # D = 64 too
    (torch.float32, 64, 2, "fma"),
])
def test_decode_body_for_routes_bf16_d128_to_mma(dtype, d, g, body):
    """_body_for: the TMA + tensor-core body serves bf16 at D = 128 (G <=
    8); f32 and D = 64 keep the FMA body, as the prefill kernels route."""
    assert fd._body_for(dtype, d, g) == body


@pytest.mark.parametrize("lens,t", _DECODE_LENS, ids=["phase-4s", "ragged"])
@pytest.mark.parametrize("hkv,sms", [(8, 132), (2, 132), (8, 8)],
                         ids=["qwen3-8b", "hkv-2", "one-group"])
def test_decode_work_plan_covers_each_live_key_once(lens, t, hkv, sms):
    """work_plan: each (row, kv head)'s pieces cover the row's live keys
    [0, len) exactly once, split j after split j - 1 in key order and in
    group order, every piece agrees on the split count, slots are
    distinct and below the plan's count, and a dead row has no piece."""
    plan, slots = fd.work_plan(lens, t, hkv, sms)
    assert len(plan) == sms // hkv * hkv
    by_seg = {}
    for block, pieces in enumerate(plan):
        for p in pieces:
            assert block % hkv == p.head
            by_seg.setdefault((p.row, p.head), []).append((block, p))
    for b in range(len(lens)):
        live = min(max(lens[b], 0), t)
        for h in range(hkv):
            got = sorted(by_seg.get((b, h), []), key=lambda bp: bp[1].split)
            assert [p.split for _, p in got] == list(range(len(got)))
            assert all(p.splits == len(got) for _, p in got)
            assert [bl for bl, _ in got] == sorted(bl for bl, _ in got)
            edges = [0] + [p.k1 for _, p in got]
            assert [p.k0 for _, p in got] == edges[:-1]
            assert edges[-1] == live and all(p.k0 < p.k1 for _, p in got)
    every = [p.slot for ps in plan for p in ps]
    assert len(set(every)) == len(every) and max(every) < slots


def test_decode_work_plan_balances_the_groups():
    """At phase 4s's lengths: 128 blocks in 16 groups of 8 (a block a kv
    head) whose shares of the live tiles differ by at most one 128-key
    tile; a row spans at most 3 groups, so a merge reads at most 3
    slots."""
    lens, t = _DECODE_LENS[0]
    plan, slots = fd.work_plan(lens, t, 8, 132)
    assert len(plan) == 128 and slots == (16 + 16) * 8
    tiles = [sum(-(-(p.k1 - p.k0) // 128) for p in ps) for ps in plan]
    assert max(tiles) - min(tiles) <= 1
    assert max(p.splits for ps in plan for p in ps) <= 3


@pytest.mark.parametrize("lens,t", _DECODE_LENS, ids=["phase-4s", "ragged"])
def test_decode_plan_merge_matches_the_partial(lens, t):
    """The kernel's arithmetic on the host, in f32: each piece's
    unnormalised (acc, m, l) over its keys, merged in split order as the
    last block merges them, gives flash_decode_partial's o and lse
    (1e-5); an empty row o = 0, lse = NEG_INF."""
    hq, hkv, d = 32, 8, 16
    g = hq // hkv
    rows = len(lens)
    q, k, v = (_t(_rand(60 + i, *shape)) for i, shape in enumerate(
        ((rows, hq, d), (rows, t, hkv, d), (rows, t, hkv, d))))
    want_o, want_lse = fd.flash_decode_partial(q, k, v, torch.tensor(lens))
    plan, _ = fd.work_plan(lens, t, hkv, 132)
    parts = {}
    for p in (p for pieces in plan for p in pieces):
        qq = q[p.row, p.head * g:(p.head + 1) * g] * d ** -0.5
        sc = qq @ k[p.row, p.k0:p.k1, p.head].T  # (G, keys)
        m = sc.amax(-1)
        e = torch.exp(sc - m[:, None])
        parts.setdefault((p.row, p.head), []).append(
            (p.split, e @ v[p.row, p.k0:p.k1, p.head], m, e.sum(-1)))
    o = torch.zeros(rows, hq, d)
    lse = torch.full((rows, hq), fd.NEG_INF)
    for (b, h), ps in parts.items():
        ps.sort(key=lambda x: x[0])
        big_m = torch.stack([m for _, _, m, _ in ps]).amax(0)
        acc, den = 0.0, 0.0
        for _, a, m, l_ in ps:
            f = torch.exp(m - big_m)
            acc, den = acc + a * f[:, None], den + l_ * f
        o[b, h * g:(h + 1) * g] = acc / den[:, None]
        lse[b, h * g:(h + 1) * g] = big_m + torch.log(den)
    _close(o, want_o)
    _close(lse, want_lse)


def test_decode_pool_keys_part_every_call_configuration():
    """The merge slots and counters: one pool entry a (device, stream,
    shape, dtype, body); calls that differ in any never share one, the
    same call maps to the same key, and the pools are a
    _build.PoolCache."""
    from triton_dist_tpu_torch.kernels import _build

    q = torch.zeros(16, 32, 128, dtype=torch.bfloat16)
    base = fd._pool_key(q, 7, 8192, 8, "mma")
    assert base == fd._pool_key(q.clone(), 7, 8192, 8, "mma")
    others = [fd._pool_key(q, 8, 8192, 8, "mma"),
              fd._pool_key(q[:8], 7, 8192, 8, "mma"),
              fd._pool_key(q[:, :16], 7, 8192, 8, "mma"),
              fd._pool_key(q.float(), 7, 8192, 8, "mma"),
              fd._pool_key(q, 7, 4096, 8, "mma"),
              fd._pool_key(q, 7, 8192, 4, "mma"),
              fd._pool_key(q, 7, 8192, 8, "fma")]
    assert len({base, *others}) == len(others) + 1
    assert isinstance(fd._POOLS, _build.PoolCache)


def test_flash_decode_partial_at_qwen3_heads_matches_jax():
    """At Qwen3-8B's heads (32, 8, 128) and ragged lengths (0, 1, inside
    a chunk, across chunks, full; T = 48, three of the JAX kernel's
    16-key chunks and under one of the Hopper body's 128-key tiles): the
    port's wrapper (its plain version on the CPU) against the JAX Pallas
    partial in interpret mode and the XLA one."""
    b, t, hq, hkv, d = 5, 48, 32, 8, 128
    q, k, v = (_rand(21, b, hq, d), _rand(22, b, t, hkv, d),
               _rand(23, b, t, hkv, d))
    valid = np.array([0, 1, 9, 33, 48], np.int32)
    o_x, lse_x = jax.jit(jax_partial)(q, k, v, valid)
    before = pallas_call_count()
    o_p, lse_p = jax.jit(functools.partial(jax_partial_pallas, chunk=16))(
        q, k, v, valid)
    assert pallas_call_count() > before
    o, lse = fd.flash_decode_partial_cuda(_t(q), _t(k), _t(v), _t(valid))
    for want_o, want_lse in ((o_p, lse_p), (o_x, lse_x)):
        _close(o, want_o)
        _close(lse[1:], want_lse[1:])
    assert torch.all(o[0] == 0) and torch.all(lse[0] == fd.NEG_INF)


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


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ll_all_gather_context_after_each_of_eight_calls(n):
    """The protocol's state, which the kernel is held to on the card:
    after call k on one context, parity k % 2's slots hold call k's
    payloads in every rank's partition and its flags read k + 1, the
    other parity still holds call k - 1's (zero before any), and the
    barrier's word is untouched; a negative call index is refused."""
    rows, cols = 3, 5
    ctx = llag.create_ll_ag_buffer((rows, cols), torch.float32, n,
                                   device="cpu")
    xs = [_t(_rand(30 + k, n, rows, cols)) for k in range(8)]
    for k, x in enumerate(xs):
        got, ctx = llag.ll_all_gather(x, ctx, k)
        assert torch.equal(got, x[None].expand(n, *x.shape))
        p, q = k % 2, 1 - k % 2
        assert torch.equal(ctx.data[:, p], x[None].expand(n, *x.shape))
        assert ctx.flags[:, p * n:(p + 1) * n].eq(k + 1).all()
        before = xs[k - 1] if k else torch.zeros_like(x)
        assert torch.equal(ctx.data[:, q], before[None].expand(n, *x.shape))
        assert ctx.flags[:, q * n:(q + 1) * n].eq(k).all()
        assert ctx.flags[:, 2 * n].eq(0).all()
    with pytest.raises(ValueError, match="call_count"):
        llag.ll_all_gather(xs[0], ctx, -1)


@pytest.mark.parametrize("wire_format", [None, "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_ll_all_gather_device_count_is_bitwise_the_int_form(n, wire_format):
    """The call count as an int32 tensor of one element (JAX's traced
    call_count), calls 0-5 on one context: every gathered copy, the
    context's slots and every flag word bitwise the same calls with an
    int count on a twin context, on the native and the fp8 wire. A
    count tensor of another dtype, size or device is refused."""
    rows, cols = 3, 8
    twins = [llag.create_ll_ag_buffer((rows, cols), torch.float32, n,
                                      wire_format=wire_format, device="cpu")
             for _ in range(2)]
    for k in range(6):
        x = _t(_rand(70 + k, n, rows, cols))
        want, _ = llag.ll_all_gather(x, twins[0], k, wire_format=wire_format)
        count = torch.tensor([k], dtype=torch.int32)
        got, _ = llag.ll_all_gather(x, twins[1], count,
                                    wire_format=wire_format)
        assert torch.equal(got, want), k
        assert torch.equal(twins[1].data, twins[0].data), k
        assert torch.equal(twins[1].flags, twins[0].flags), k
        assert count.tolist() == [k]
    for bad in (torch.tensor([0]), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="call_count"):
            llag.ll_all_gather(x, twins[1], bad, wire_format=wire_format)


def test_sp_decode_step_device_count_matches_jax_fori_loop():
    """sp_decode_step over 5 steps at n = 4, its LL call count an int32
    device tensor that the step advances with kv_len (through
    `compiled_sp_decode_step`, which on the CPU calls the step), against
    the JAX layer under jax.jit with call_count traced through a
    `lax.fori_loop` (interpret-mode kernels): every step's output and
    every rank's cache shard within 2e-5, the count ending at 5 and
    kv_len at its start + 5, the context bitwise the int-count layer's
    after the same steps."""
    n, b, h, t_max, steps = 4, 2, 32, 16, 5
    start = np.array([9, 2], np.int32)
    jp = _sp_params(40, h)
    xs = _rand(44, steps, b, h, scale=0.5)
    cos, sin = jax_rope_table(D, t_max + 1)
    spec = spl.SpDecodeSpec(HQ, HKV, D)

    def per_device(x_all, kc, vc):
        def body(i, carry):
            cache, buf, outs = carry
            y, cache, buf = jax_sp_decode(
                x_all[i], jp, spec, cos, sin, cache, start + i, axis="tp",
                ll_buf=buf, call_count=i)
            return cache, buf, outs.at[i].set(y)

        carry = ((kc, vc), jax_create_sp_decode_buf(b, HQ, D, n),
                 jnp.zeros((steps, b, h), jnp.float32))
        (k_out, v_out), _, outs = jax.lax.fori_loop(0, steps, body, carry)
        return outs, k_out, v_out

    kc0 = _rand(45, b, t_max, HKV, D)
    vc0 = _rand(46, b, t_max, HKV, D)
    want, want_k, want_v = _jax(
        per_device, n, xs, kc0, vc0,
        in_specs=(P(), P(None, "tp"), P(None, "tp")),
        out_specs=(P(), P(None, "tp"), P(None, "tp")))
    params = spl.sp_params_from_jax(jp, device="cpu")
    tcos, tsin = rope_table(D, t_max + 1, device="cpu")
    step = spl.compiled_sp_decode_step()
    cache = (_t(_stack(kc0, n)), _t(_stack(vc0, n)))
    twin = tuple(c.clone() for c in cache)
    ctx = fd.create_sp_decode_buf(b, HQ, D, n, device="cpu")
    ctx_int = fd.create_sp_decode_buf(b, HQ, D, n, device="cpu")
    kv_len = _t(start).long()
    count = torch.zeros(1, dtype=torch.int32)
    for i in range(steps):
        x = _t(np.broadcast_to(xs[i], (n, b, h)))
        y = step(x, params, spec, tcos, tsin, cache, kv_len, ctx, count)
        y_int, twin, ctx_int = spl.sp_decode_attn_fwd(
            x, params, spec, tcos, tsin, twin, _t(start + i),
            ll_buf=ctx_int, call_count=i)
        assert torch.equal(y, y_int), i
        for r in range(n):
            _close(y[r], want[i])
    assert count.tolist() == [steps]
    assert kv_len.tolist() == (start + steps).tolist()
    _close(cache[0], _stack(want_k, n))
    _close(cache[1], _stack(want_v, n))
    assert torch.equal(ctx.data, ctx_int.data)
    assert torch.equal(ctx.flags, ctx_int.flags)
    assert step.graphs.made == 0


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

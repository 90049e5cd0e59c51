"""The port's resident serving loop (Engine.make_resident_loop, the
injection ring, ResidentWorker, Scheduler(resident=True)), its sampling by
the JAX key stream (kernels/sample.py), fault 3.7's donate_cache and
fault 3.8's (the prefill's),
against the JAX package on the CPU.

Tiny f32 config (tests/test_serve_resident.py's: 4 q / 2 kv heads, 64
positions, GEO slots 3, chunk 4, page 8), the JAX weights carried over.
Tolerances, stated per test: the ring's buffers, the keys, the random
bits, the uniforms, the consumed records and the slot state are integer
or bit-cast data and are held bitwise; greedy tokens are held equal (the
tiny model's logits are far apart, as tests/test_torch_serve.py notes);
sampled tokens are held equal (the Gumbel noise goes through torch's log
rather than XLA's, an ulp apart at most, which moves no token of these
draws); logits within 1e-4 (LOGIT_ATOL, f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from triton_dist_tpu.mega import ring as jring
from triton_dist_tpu.mega.qwen3 import MegaQwen3 as JaxMegaQwen3
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu.serve import Scheduler as JaxScheduler
from triton_dist_tpu.serve.worker import sampling_key as jax_sampling_key
from triton_dist_tpu_torch.faults.errors import DeadlineExceeded
from triton_dist_tpu_torch.kernels import ring as kring
from triton_dist_tpu_torch.kernels import sample as ks
from triton_dist_tpu_torch.mega import MegaQwen3, PagedMegaKVCache
from triton_dist_tpu_torch.mega import ring as pring
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.serve import (
    KVPool,
    ResidentWorker,
    Scheduler,
    sampling_key,
)

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=64)
GEO = dict(slots=3, chunk=4, page=8)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG), mesh, decode_mode="ar",
                     max_len=64, donate_cache=False)
    eng = Engine(ModelConfig.tiny(**CFG), device="cpu", max_len=64,
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jeng.params),
                                        device="cpu"))
    return jeng, eng


@pytest.fixture(scope="module")
def prompts(engines):
    rng = np.random.default_rng(7)
    v = engines[1].cfg.vocab_size
    return [list(map(int, rng.integers(0, v, n))) for n in (12, 10, 9)]


def _tokens(sch, prompts, gen, **kw):
    reqs = [sch.submit(p, gen, **{k: (v[i] if isinstance(v, list) else v)
                                  for k, v in kw.items()})
            for i, p in enumerate(prompts)]
    sch.run()
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_host(engines, prompts):
    """The JAX host-loop Scheduler's tokens, greedy and sampled."""
    jeng = engines[0]
    return {
        "greedy8": _tokens(JaxScheduler(jeng, **GEO), prompts, 8),
        "sampled6": _tokens(JaxScheduler(jeng, **GEO), prompts, 6,
                            temperature=0.9, seed=[51, 52, 53]),
    }


# ---------- the injection ring (host producer and output decode) ----------


def _both_rings(**kw):
    return jring.InjectionRing(**kw), pring.InjectionRing(**kw)


def _same(jr, pr):
    np.testing.assert_array_equal(jr.buf, pr.buf)
    assert (jr.published, jr.consumed, jr.version, jr.can_claim(),
            jr.pending()) == (pr.published, pr.consumed, pr.version,
                              pr.can_claim(), pr.pending())


def test_ring_seq_visibility_overflow_and_pins_bitwise_jax():
    """The JAX ring test's sequence (tests/test_serve_resident.py:62):
    after each operation the buffer, counters and version are bitwise
    JAX's; both overflow the same way, pinned rows included."""
    jr, pr = _both_rings(cap=2, max_pages=4, prompt_cap=8, chunk=4)
    for r in (jr, pr):
        r.admit(0, [1, 2, 3], 4, 0.7, 9, None, req_id=11,
                table_row=np.arange(1, 5))
    _same(jr, pr)
    assert pr.buf[0, pring.IR_SEQ] == 1
    for r in (jr, pr):
        r.retire(1, req_id=12)
    _same(jr, pr)
    for r in (jr, pr):
        with pytest.raises(RuntimeError, match="overflow"):
            r.admit(2, [1], 1, 0.0, 0, None, req_id=13,
                    table_row=np.zeros(4))
        r.ack(2)
        assert not r.can_claim()
        with pytest.raises(RuntimeError, match="pinned"):
            r.admit(2, [1], 1, 0.0, 0, None, req_id=13,
                    table_row=np.zeros(4))
        r.unpin(11)
        r.admit(2, [5, 6], 3, 1.5, -4, 6, req_id=13, table_row=np.zeros(4),
                at_step=3)
    _same(jr, pr)


def test_ring_version_tracks_mutations_bitwise_jax():
    jr, pr = _both_rings(cap=4, max_pages=2, prompt_cap=4, chunk=2)
    for r in (jr, pr):
        v0 = r.version
        r.admit(0, [1], 1, 0.0, 0, None, req_id=1, table_row=np.zeros(2))
        r.retire(0, req_id=1)
        r.ack(2)
        r.unpin(1)
        assert r.version == v0 + 2  # ack / unpin touch no buffer
        r.abandon()
        assert r.version == v0 + 3
    _same(jr, pr)


def test_ring_abandon_publishes_without_commit():
    """An abandoned head record: pending, seq 0; head_abandoned says so in
    both packages, head_visible says no."""
    jr, pr = _both_rings(cap=4, max_pages=2, prompt_cap=4, chunk=2)
    for r in (jr, pr):
        r.abandon()
    _same(jr, pr)
    want = bool(jring.head_abandoned(jnp.asarray(jr.buf),
                                     jnp.int32(jr.published), jnp.int32(0)))
    ring = torch.from_numpy(pr.buf)
    assert want and pring.head_abandoned(ring, pr.published, 0)
    assert not pring.head_visible(ring, pr.published, 0, 100)


def test_out_ring_decode_strictness_and_summary():
    buf = np.zeros((4, pring.OR_WIDTH), np.int32)
    buf[0] = [1, 0, 5, 42, pring.FLAG_EMIT, 0, 9, 0]
    buf[1] = [2, 1, 6, -1, pring.FLAG_RETIRED, pring.REASON_HOST, 7, 0]
    got = pring.decode_out_ring(buf, 2)
    want = jring.decode_out_ring(buf, 2)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert got[0].emitted and not got[0].retired and got[1].retired
    assert pring.summarize_records(got) == jring.summarize_records(want)
    buf[1, pring.OR_SEQ] = 7  # a gap
    with pytest.raises(ValueError, match="seq"):
        pring.decode_out_ring(buf, 2)


# ---------- the key stream ----------


@settings(max_examples=60, deadline=None)
@given(seed=st.one_of(st.integers(0, 2**31 - 1),
                      st.integers(2**31, 2**62),
                      st.integers(-2**31, -1)),
       index=st.integers(0, 2**32 - 1))
def test_sampling_key_bitwise_jax(seed, index):
    """sampling_key(seed, i) is bitwise jax.random.fold_in(PRNGKey(seed),
    i) (and the JAX package's sampling_key), seeds past 2^31 and
    negative ones included."""
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), index))
    got = sampling_key(seed, index)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_sampling_key(seed, index))


def test_split_chain_bitwise_jax():
    """split(key) is (fold_in(key, 0), fold_in(key, 1)) in JAX's
    partitionable threefry: the port's split and a chain of five are
    bitwise jax.random.split's."""
    jk = jax.random.PRNGKey(5)
    pk = ks.seed_key(5)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        pk, psub = ks.split(pk)
        np.testing.assert_array_equal(ks.key_words(pk), np.asarray(jk))
        np.testing.assert_array_equal(ks.key_words(psub), np.asarray(jsub))


@pytest.mark.parametrize("shape", [(1000,), (3, 257)])
def test_random_bits_and_uniforms_bitwise_jax(shape):
    """The plain sampler's random bits and uniforms in [tiny, 1) are
    bitwise jax.random.bits / uniform (its Gumbel's input): a (V,) draw,
    and an (R, V) draw as the flat rows of one key."""
    tiny = np.finfo(np.float32).tiny
    for seed, idx in ((0, 0), (41, 3), (2**31 + 5, 77)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
        words = np.asarray(jk)
        keys = torch.from_numpy(ks.as_int32(np.tile(words, (shape[0], 1))))
        n = shape[-1]
        base = (torch.arange(shape[0]) * n if len(shape) == 2 else 0)
        bits = ks.random_bits(keys[: 1 if len(shape) == 1 else None], n,
                              base)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(bits.numpy().reshape(shape),
                                      want.astype(np.int64))
        u = ks.uniforms(bits).numpy().reshape(shape)
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                           minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))


def test_sample_slots_tokens_equal_jax_categorical():
    """sample_slots (the plain version, the wrapper's CPU route) against
    the JAX serve step's rule, vmap(categorical)(keys, logits / max(T,
    1e-6)) where T > 0 else argmax, on one key a row; and in the flat
    form against one categorical over (R, V) under one key (Engine.serve's
    draw): tokens equal over 40 draws each."""
    rng = np.random.default_rng(3)
    R, V = 4, 1000
    for trial in range(40):
        logits = (rng.standard_normal((R, V)) * 3).astype(np.float32)
        temps = np.array([0.9, 0.0, 1.3, 0.5], np.float32)
        keys = np.stack([sampling_key(trial, i) for i in range(R)])
        jl = jnp.asarray(logits)
        temp = jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
        sampled = jax.vmap(jax.random.categorical)(jnp.asarray(keys),
                                                   jl / temp)
        want = np.where(temps > 0, np.asarray(sampled),
                        np.asarray(jnp.argmax(jl, -1)))
        got = ks.sample_slots(torch.from_numpy(logits),
                              torch.from_numpy(ks.as_int32(keys)),
                              torch.from_numpy(temps))
        assert got.tolist() == want.tolist(), trial
        key = sampling_key(trial, 99)
        t = float(temps[0])
        flat = ks.sample_slots(
            torch.from_numpy(logits),
            torch.from_numpy(ks.as_int32(np.tile(key, (R, 1)))),
            torch.full((R,), t), flat=True)
        fwant = jax.random.categorical(jnp.asarray(key), jl / t)
        assert flat.tolist() == np.asarray(fwant).tolist(), trial


def test_sample_slots_split_writes_the_next_key():
    """With key_next the rows sample under split(key)[1] and key_next gets
    split(key)[0], bitwise."""
    logits = torch.randn(2, 300, generator=torch.Generator().manual_seed(0))
    key = sampling_key(4, 2)
    rows = torch.from_numpy(ks.as_int32(np.tile(key, (2, 1))))
    nxt = torch.zeros((2, 2), dtype=torch.int32)
    temps = torch.full((2,), 0.8)
    got = ks.sample_slots(logits, rows, temps, flat=True, key_next=nxt)
    k0, k1 = ks.split(tuple(int(x) for x in key))
    np.testing.assert_array_equal(nxt.numpy().view(np.uint32),
                                  np.tile(ks.key_words(k0), (2, 1)))
    want = ks.sample_slots(
        logits, torch.from_numpy(ks.as_int32(np.tile(ks.key_words(k1),
                                                     (2, 1)))),
        temps, flat=True)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("rows,v,parts", [
    (4, 151936, 66), (1, 151936, 264), (64, 151936, 5), (300, 151936, 1),
    (4, 300, 2), (2, 7, 1)])
def test_sample_kernel_splits_rows_over_the_sms(rows, v, parts):
    """The kernel's plan: a row over enough blocks that the grid covers
    the H100's 132 SMs twice, at most one a 256 elements, at least one."""
    assert ks._parts(rows, v, 132) == parts


# ---------- the step boundary: device_consume / slot_plan ----------


def _random_ring_state(rng, cap=6, K=3, maxp=4, prompt_cap=12, chunk=4):
    """A ring with admissions (half of them a prefix-cache hit: IR_PREFIX
    a multiple of the chunk below the prompt length), retirements
    (matching and stale), verify records, a no-op, at_step gates and an
    uncommitted tail; and slot states in the loop's own domain."""
    width = pring.ring_width(maxp, prompt_cap, chunk)
    ring = np.zeros((cap, width), np.int32)
    consumed = int(rng.integers(0, 20))
    published = consumed + int(rng.integers(0, cap + 1))
    ss = np.zeros((K, pring.SS_WIDTH), np.int32)
    for s in range(K):
        plen = int(rng.integers(1, prompt_cap + 1))
        ss[s] = 0
        ss[s, pring.SS_ACTIVE] = rng.integers(0, 2)
        ss[s, pring.SS_PHASE] = rng.integers(0, 2)
        ss[s, pring.SS_PROMPT_LEN] = plen
        ss[s, pring.SS_POS] = (plen if ss[s, pring.SS_PHASE]
                               else rng.integers(0, plen))
        ss[s, pring.SS_MAX_NEW] = rng.integers(1, 9)
        ss[s, pring.SS_N_OUT] = rng.integers(0, 8)
        ss[s, pring.SS_TEMP_BITS] = np.float32(
            rng.choice([0.0, 0.7, 1.2])).view(np.int32)
        ss[s, pring.SS_SEED] = rng.integers(-2**31, 2**31 - 1)
        ss[s, pring.SS_EOS] = rng.integers(0, 5)
        ss[s, pring.SS_LAST_TOK] = rng.integers(0, 256)
        ss[s, pring.SS_REC] = rng.integers(0, cap)
        ss[s, pring.SS_REQID] = rng.integers(0, 6)
    for i in range(consumed - cap, published):
        if i < 0:
            continue
        r = ring[i % cap]
        r[:] = rng.integers(-50, 256, width)
        r[pring.IR_SEQ] = i + 1
        if i >= consumed and rng.random() < 0.15:
            r[pring.IR_SEQ] = 0  # torn
        r[pring.IR_KIND] = rng.choice([0, 1, 1, 2, 2, 3])
        r[pring.IR_SLOT] = rng.integers(0, K)
        r[pring.IR_AT_STEP] = rng.integers(0, 6)
        plen = int(rng.integers(1, prompt_cap + 1))
        r[pring.IR_PROMPT_LEN] = plen
        r[pring.IR_PREFIX] = (chunk * rng.integers(0, (plen - 1) // chunk + 1)
                              if rng.random() < 0.5 else 0)
        r[pring.IR_REQID] = rng.integers(0, 6)
        r[pring.IR_NOUT] = rng.integers(0, 8)
        r[pring.IR_SPEC_K] = rng.integers(1, 3)
        r[pring.IR_TEMP_BITS] = np.float32(
            rng.choice([0.0, 0.9])).view(np.int32)
    table = rng.integers(0, 9, (K, maxp)).astype(np.int32)
    lengths = rng.integers(0, 30, K).astype(np.int32)
    return ring, published, consumed, ss, table, lengths


@pytest.mark.parametrize("seed", range(8))
def test_device_consume_and_slot_plan_bitwise_jax(seed):
    """On random rings and slot states: the port's device_consume
    (consumed, slot state, table, lengths, retired) and slot_plan
    (tokens, n_valid, temps, keys, emits) bitwise the JAX functions at
    several device steps."""
    rng = np.random.default_rng(seed)
    ring, pub, con, ss, tb, ln = _random_ring_state(rng)
    for step in (0, 2, 5):
        want = jring.device_consume(
            jnp.asarray(ring), jnp.int32(pub), jnp.int32(con),
            jnp.int32(step), jnp.asarray(ss), jnp.asarray(tb),
            jnp.asarray(ln))
        got = pring.device_consume(
            torch.from_numpy(ring), pub, con, step, torch.from_numpy(ss),
            torch.from_numpy(tb), torch.from_numpy(ln))
        assert got[0] == int(want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ss2 = np.asarray(want[1])
        jplan = jring.slot_plan(jnp.asarray(ring), jnp.asarray(ss2), 4, 4)
        pplan = pring.slot_plan(torch.from_numpy(ring),
                                torch.from_numpy(ss2.copy()), 4, 4)
        for name, g, w in zip(("tokens", "n_valid", "temps", "keys",
                               "emits"), pplan, jplan):
            w = np.asarray(w)
            g = g.numpy()
            if name == "temps":
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=name)


def test_ring_boundary_plain_prefix_admissions_bitwise_jax():
    """Admissions with a prefix (InjectionRing.admit(prefix=) at 0, 4 and
    8 of 9-12 token prompts) through the plain ring_boundary: the slot
    state, table and lengths it writes into the block, and the step's
    tokens, n_valid, temps, keys and emits, bitwise JAX device_consume
    then slot_plan on the same ring; each slot's position and length
    start at its prefix and its first chunk is the prompt from there."""
    C, maxp, K = 4, 4, 3
    ring = pring.InjectionRing(8, maxp, 16, C)
    jr = jring.InjectionRing(8, maxp, 16, C)
    prompts = [list(range(10, 22)), list(range(30, 39)), list(range(50, 61))]
    for slot, (p, prefix) in enumerate(zip(prompts, (8, 0, 4))):
        for r in (ring, jr):
            r.admit(slot, p, 3, 0.5 * slot, 40 + slot, None, req_id=slot + 1,
                    table_row=np.arange(1, maxp + 1) + maxp * slot,
                    prefix=prefix)
    np.testing.assert_array_equal(ring.buf, jr.buf)
    geo = kring.WindowGeometry(K, C, maxp, 16, 4, 8)
    blk = geo.new_block("cpu")
    blk[kring.H_PUBLISHED] = ring.published
    blk[kring.H_LIVE] = 1
    bufs = kring.StepBuffers.create(geo, "cpu")
    kring.ring_boundary(torch.from_numpy(ring.buf), blk, geo, bufs)
    _, ss, tb, ln, _ = geo.views(blk)
    zero = jnp.zeros((K,), jnp.int32)
    con, jss, jtb, jln, _ = jring.device_consume(
        jnp.asarray(jr.buf), jnp.int32(jr.published), jnp.int32(0),
        jnp.int32(0), jnp.zeros((K, pring.SS_WIDTH), jnp.int32),
        jnp.zeros((K, maxp), jnp.int32), zero)
    assert int(blk[kring.H_CONSUMED]) == int(con) == 3
    for g, w in ((ss, jss), (tb, jtb), (ln, jln)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ln.tolist() == [8, 0, 4]
    assert ss[:, pring.SS_POS].tolist() == [8, 0, 4]
    plan = jring.slot_plan(jnp.asarray(jr.buf), jss, C, maxp)
    for name, g, w in zip(("tokens", "n_valid", "temps", "keys", "emits"),
                          (bufs.tokens, bufs.n_valid, bufs.temps, bufs.keys,
                           bufs.emits), plan):
        w = np.asarray(w)
        g = g.numpy()
        if name == "temps":
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert bufs.tokens[:, 0].tolist() == [18, 30, 54]
    assert bufs.emits.tolist() == [1, 0, 0]  # 12 - 8 = one chunk: emits


# ---------- the window against the JAX loop ----------


def _jax_window(jeng, ring, pub, con, step0, ss, tb, ln, pool_k, pool_v,
                window, ring_cap):
    fn = jeng.make_resident_loop(3, 4, 8, 8, window, ring_cap=ring_cap,
                                 prompt_cap=64)
    return fn(jeng.params, jnp.asarray(ring), jnp.int32(pub),
              jnp.int32(con), jnp.int32(step0), jnp.asarray(ss),
              jnp.asarray(tb), jnp.asarray(ln), pool_k, pool_v)


def test_window_bitwise_jax_loop(engines, prompts):
    """Whole windows of the port's loop (the plain boundary, forward,
    sampler and epilogue) against the JAX resident loop on the same ring
    and state: admissions at steps 0 and 2, a sampled request, a
    retirement gated into the window, windows of 3 then 16 steps
    (the second exits early): consumed, executed, slot state, table,
    lengths and every output record bitwise."""
    jeng, eng = engines
    ring = pring.InjectionRing(16, 8, 64, 4)
    tables = [np.arange(1, 9), np.arange(9, 17), np.arange(17, 25)]
    ring.admit(0, prompts[0], 5, 0.0, 0, None, req_id=1,
               table_row=tables[0])
    ring.admit(1, prompts[1], 6, 0.8, 21, None, req_id=2,
               table_row=tables[1], at_step=2)
    ring.admit(2, prompts[2], 20, 0.0, 0, None, req_id=3,
               table_row=tables[2])
    ring.retire(2, req_id=3, at_step=6)
    pool_shape = (eng.cfg.num_layers, eng.cfg.num_kv_heads, 25, 8,
                  eng.cfg.head_dim)
    pk, pv = torch.zeros(pool_shape), torch.zeros(pool_shape)
    jpk, jpv = jnp.zeros(pool_shape), jnp.zeros(pool_shape)
    ss = np.zeros((3, pring.SS_WIDTH), np.int32)
    tb = np.zeros((3, 8), np.int32)
    ln = np.zeros((3,), np.int32)
    con, step0 = 0, 0
    for window in (3, 16):
        loop = eng.make_resident_loop(3, 4, 8, 8, window, ring_cap=16,
                                      prompt_cap=64)
        got = loop(torch.from_numpy(ring.buf), ring.published, con, step0,
                   ss, tb, ln, pk, pv)
        (jcon, jexe, jss, jtb, jln, jpk, jpv, jout, jcount,
         jstarved) = _jax_window(jeng, ring.buf, ring.published, con,
                                 step0, ss, tb, ln, jpk, jpv, window, 16)
        assert (got.consumed, got.executed, got.out_count, got.starved) == (
            int(jcon), int(jexe), int(jcount), bool(jstarved))
        for g, w in ((got.slot_state, jss), (got.table, jtb),
                     (got.lengths, jln)):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got.out_ring,
                                      np.asarray(jout)[:got.out_count])
        np.testing.assert_allclose(pk[:, :, 1:].numpy(),
                                   np.asarray(jpk)[:, :, 1:], atol=1e-5)
        ss, tb, ln = got.slot_state, got.table, got.lengths
        con, step0 = got.consumed, step0 + got.executed
    assert got.executed < 16  # the second window exited early


# ---------- the resident Scheduler ----------


def test_resident_greedy_bitwise_jax_host_loop(engines, prompts, jax_host):
    """Three requests through the port's resident Scheduler (windows of
    2): every request's tokens are the JAX host-loop Scheduler's."""
    sch = Scheduler(engines[1], resident=True, window=2, **GEO)
    assert _tokens(sch, prompts, 8) == jax_host["greedy8"]
    sch.pool.check()
    assert sch.pool.used_pages() == 0
    m = sch.metrics()
    assert m["resident_windows"] >= 1 and m["resident_steps"] >= 8
    assert m["ring_depth"] == 0
    assert m["steps"] == m["resident_steps"]


def test_resident_sampled_equals_jax(engines, prompts, jax_host):
    """Sampled (T 0.9, seeds 51-53): the resident Scheduler's tokens equal
    the JAX host-loop Scheduler's, and the seeds diverge."""
    sch = Scheduler(engines[1], resident=True, window=8, **GEO)
    got = _tokens(sch, prompts, 6, temperature=0.9, seed=[51, 52, 53])
    assert got == jax_host["sampled6"]
    assert len({tuple(t) for t in got}) > 1


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_resident_bitwise_port_host_loop(engines, prompts, temperature):
    """The resident Scheduler against the port's own host loop, greedy
    and sampled, windows of 1, 3 and 16: tokens bitwise."""
    eng = engines[1]
    kw = dict(temperature=temperature, seed=[5, 6, 7])
    host = _tokens(Scheduler(eng, **GEO), prompts, 7, **kw)
    for window in (1, 3, 16):
        sch = Scheduler(eng, resident=True, window=window, **GEO)
        assert _tokens(sch, prompts, 7, **kw) == host, window


def test_resident_eos_bitwise_jax_and_host_loop(engines, prompts, jax_host):
    """Each request stops at an eos its greedy stream emits early (the
    token at index 1, 4, 2): the resident Scheduler (windows of 8, sized
    to the token budgets, so it runs dead steps past the retirements)
    gives the JAX host-loop Scheduler's tokens and the port's host
    loop's, bitwise, each the no-eos stream cut at its first eos."""
    jeng, eng = engines
    eos = [t[j] for t, j in zip(jax_host["greedy8"], (1, 4, 2))]
    want = [t[:t.index(e) + 1] for t, e in zip(jax_host["greedy8"], eos)]
    assert _tokens(JaxScheduler(jeng, **GEO), prompts, 8, eos_id=eos) == want
    assert _tokens(Scheduler(eng, **GEO), prompts, 8, eos_id=eos) == want
    sch = Scheduler(eng, resident=True, window=8, **GEO)
    assert _tokens(sch, prompts, 8, eos_id=eos) == want
    w = sch.worker
    assert sum(k * v for k, v in w.windows_by_steps.items()) > w.n_steps
    sch.pool.check()
    assert sch.pool.used_pages() == 0


def test_staggered_admission_and_midwindow_retirement(engines, prompts,
                                                      jax_host):
    """Worker level, one window of 12: slot 1's admission gated to device
    step 4 (published after slot 2's, records are consumed in order),
    slot 2 retired by a host record gated to step 6. Slots 0 and 1 emit
    the JAX host loop's tokens (slot 1's first emission after step 6);
    slot 2's emitted prefix is the host loop's and its retirement comes
    back with REASON_HOST."""
    eng = engines[1]
    pool = KVPool(eng, GEO["slots"], GEO["page"])
    w = ResidentWorker(eng, pool, GEO["chunk"], window=12)
    for slot, at in ((0, 0), (2, 0), (1, 4)):
        p = prompts[slot]
        pool.admit(slot, len(p))
        assert pool.ensure(slot, len(p) + 8)
        w.admit(slot, p, 8, 0.0, 0, None, req_id=slot, at_step=at)
    w.retire(2, req_id=2, at_step=6)
    recs = w.run_window()
    while any(w.slot_state[:, pring.SS_ACTIVE]):
        recs += w.run_window()
    toks = {0: [], 1: [], 2: []}
    first = {}
    for r in recs:
        if r.emitted:
            toks[r.req_id].append(r.token)
            first.setdefault(r.req_id, r.step)
    assert toks[0] == jax_host["greedy8"][0]
    assert toks[1] == jax_host["greedy8"][1]
    assert 0 < len(toks[2]) < 8
    assert toks[2] == jax_host["greedy8"][2][:len(toks[2])]
    host_rt = [r for r in recs if r.retired and r.req_id == 2]
    assert [r.reason for r in host_rt] == [pring.REASON_HOST]
    assert first[1] >= 6 > first[0]
    assert w.n_reads == w.n_windows  # one read a window


def test_prefill_bitwise_under_ring_wrap_churn(engines):
    """A 40-token prompt prefilling 4 tokens a window (window 1) while 8
    short requests wrap a cap-4 ring twice over: the pinned admission row
    is never overwritten, and every request's tokens are the JAX host
    loop's."""
    jeng, eng = engines
    rng = np.random.default_rng(23)
    long_p = list(map(int, rng.integers(0, 256, 40)))
    shorts = [list(map(int, rng.integers(0, 256, 5))) for _ in range(8)]
    all_p = [long_p] + shorts
    want = _tokens(JaxScheduler(jeng, **GEO), all_p, 3)
    sch = Scheduler(eng, resident=True, window=1, ring_cap=4, **GEO)
    assert _tokens(sch, all_p, 3) == want
    sch.pool.check()
    assert sch.pool.used_pages() == 0
    assert sch.worker.ring._pins == {}


def test_abandoned_ring_raises_and_loses_no_token(engines, prompts,
                                                  jax_host):
    """A torn record at the ring's head (InjectionRing.abandon) while a
    request decodes: the window raises DeadlineExceeded instead of
    hanging, after folding in the tokens it emitted, which are the host
    loop's prefix; the trip names the ring's cursor."""
    sch = Scheduler(engines[1], resident=True, window=3, **GEO)
    req = sch.submit(prompts[0], 8)
    sch.step()
    sch.worker.ring.abandon()
    with pytest.raises(DeadlineExceeded) as ei:
        sch.run()
    assert ei.value.trips and ei.value.trips[0]["site"] == "inject"
    assert 0 < len(req.out_tokens) <= 8
    assert req.out_tokens == jax_host["greedy8"][0][:len(req.out_tokens)]


def test_stuck_windows_raise(engines, prompts):
    """A record gated to a step the device never reaches, nothing active:
    each window polls its budget and exits with no progress, and the
    third such window raises DeadlineExceeded."""
    eng = engines[1]
    pool = KVPool(eng, GEO["slots"], GEO["page"])
    w = ResidentWorker(eng, pool, GEO["chunk"], window=4,
                       max_stuck_windows=3)
    pool.admit(0, 12)
    w.admit(0, prompts[0], 4, 0.0, 0, None, req_id=0, at_step=10**6)
    assert w.run_window() == [] and w.run_window() == []
    with pytest.raises(DeadlineExceeded, match="no progress"):
        w.run_window()
    assert w.n_steps == 0


def test_resident_auto_and_window_without_resident_raise(engines):
    with pytest.raises(NotImplementedError, match="item 7"):
        Scheduler(engines[1], resident="auto", **GEO)
    with pytest.raises(ValueError, match="resident"):
        Scheduler(engines[1], window=4, **GEO)


# ---------- KVPool.as_mega_cache ----------


def _dense_from_mega(k, table, lengths):
    """Each sequence's valid prefix through a paged cache's own table."""
    page = k.shape[3]
    return [np.stack([k[:, :, table[b, i // page], i % page]
                      for i in range(n)], axis=2) if n else None
            for b, n in enumerate(lengths)]


def test_as_mega_cache_bitwise_jax_export_under_churn(engines, prompts):
    """A pool of 4 pages under eviction churn, the port's and the JAX
    Scheduler stepped alike: at every step the export's table, lengths and
    allocator head are bitwise JAX's as_mega_cache, its k / v within 1e-5
    of JAX's (f32, the two frameworks' sums), and the sequences read
    through its own table are bitwise the port's paged_cache_from_dense
    of the pool's dense view."""
    jeng, eng = engines
    sch = Scheduler(eng, total_pages=4, **GEO)
    jsch = JaxScheduler(jeng, total_pages=4, **GEO)
    for s in (sch, jsch):
        for p in prompts:
            s.submit(p, 12)
    checked = 0
    for _ in range(60):
        a, b = sch.step(), jsch.step()
        assert a == b
        if not a and sch.queue.peek() is None:
            break
        if not sch.active:
            continue
        pc, jpc = sch.pool.as_mega_cache(), jsch.pool.as_mega_cache()
        for g, w in ((pc.table, jpc.table), (pc.length, jpc.length),
                     (pc.next_free, jpc.next_free)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(pc.k.numpy(), np.asarray(jpc.k),
                                   atol=1e-5)
        lens = pc.length.tolist()
        dense = KVCache.dense_view(sch.pool.k, sch.pool.v,
                                   torch.as_tensor(sch.pool.table),
                                   torch.as_tensor(sch.pool.lengths))
        ref = PagedMegaKVCache.from_dense(dense, sch.pool.page,
                                          1 + sch.pool.capacity,
                                          sch.pool.max_pages)
        for g, w in zip(_dense_from_mega(pc.k.numpy(), pc.table.numpy(),
                                         lens),
                        _dense_from_mega(ref.k.numpy(), ref.table.numpy(),
                                         lens)):
            if g is not None:
                np.testing.assert_array_equal(g, w)
        checked += 1
    assert sch.metrics()["evicted"] > 0 and checked >= 5


def test_mega_decode_over_export_bitwise_and_resident_export(engines,
                                                             prompts):
    """MegaQwen3's paged decode (its plain route) over the pool's export:
    three decode_step calls and one decode_resident of three steps give
    the same tokens and the same pools, bitwise, and with
    donate_cache=False the export (the pool itself) is left as it was.
    The resident Scheduler's export mid-flight reads the device lengths
    back through the pool."""
    _, eng = engines
    sch = Scheduler(eng, slots=2, chunk=4, page=8)
    reqs = [sch.submit(p, 20) for p in prompts[:2]]
    for _ in range(6):
        sch.step()
    assert all(r.state.name == "DECODE" for r in reqs)
    mega = MegaQwen3(eng.cfg, batch=2, s_max=sch.pool.t_max,
                     params=eng.params, device="cpu", paged=True,
                     page_size=sch.pool.page,
                     total_pages=1 + sch.pool.capacity, donate_cache=False)
    tok = torch.tensor([r.out_tokens[-1] for r in reqs])
    before = [t.clone() for t in sch.pool.as_mega_cache()]
    c, t, seq = sch.pool.as_mega_cache(), tok, []
    for _ in range(3):
        lg, c = mega.decode_step(t, c)
        t = lg.argmax(-1)
        seq.append(t.tolist())
    out, c2 = mega.decode_resident(tok, sch.pool.as_mega_cache(), steps=3)
    assert out.T.tolist() == seq
    assert torch.equal(c.k, c2.k) and torch.equal(c.length, c2.length)
    for x, y in zip(before, sch.pool.as_mega_cache()):
        assert torch.equal(x, y)

    rsch = Scheduler(eng, resident=True, window=2, **GEO)
    for p in prompts:
        rsch.submit(p, 8)
    rsch.step()
    rsch.step()
    pc = rsch.pool.as_mega_cache()
    assert pc.length.tolist() == rsch.worker._lengths.tolist()
    assert sum(pc.length.tolist()) > 0
    rsch.run()


# ---------- fault 3.7: donate_cache ----------


def test_donate_cache_false_steps_a_copy_like_jax(engines, prompts):
    """donate_cache=False (fault 3.7): one cache stepped twice from the
    same state gives the same logits, in both packages and across them
    (within LOGIT_ATOL), the cache passed in stays bitwise as it was, and
    the returned cache is advanced; generate likewise. With
    donate_cache=True the step advances the cache it was given."""
    jeng, eng = engines
    keep = Engine(eng.cfg, device="cpu", max_len=64, params=eng.params,
                  donate_cache=False)
    ids = np.asarray([prompts[0][:9], prompts[1][:9]], np.int32)
    jl, jcache = jeng.prefill(jnp.asarray(ids))
    logits, cache = keep.prefill(ids)
    tok = logits.argmax(-1)
    snap = [t.clone() for t in (cache.k, cache.v, cache.length)]
    la, ca = keep.decode_step(tok, cache)
    lb, cb = keep.decode_step(tok, cache)
    assert torch.equal(la, lb) and ca is not cache and cb is not cache
    for x, y in zip(snap, (cache.k, cache.v, cache.length)):
        assert torch.equal(x, y)
    assert ca.length.tolist() == [10, 10]
    jtok = jnp.asarray(tok.numpy().astype(np.int32))
    ja, _ = jeng.decode_step(jtok, jcache)
    jb, _ = jeng.decode_step(jtok, jcache)
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))
    np.testing.assert_allclose(la.numpy(), np.asarray(ja), atol=LOGIT_ATOL)
    ids_a, _ = keep.generate(tok, cache, 3)
    ids_b, _ = keep.generate(tok, cache, 3)
    assert torch.equal(ids_a, ids_b)
    for x, y in zip(snap, (cache.k, cache.v, cache.length)):
        assert torch.equal(x, y)
    donate = Engine(eng.cfg, device="cpu", max_len=64, params=eng.params)
    _, c2 = donate.decode_step(tok, cache)
    assert c2 is cache and cache.length.tolist() == [10, 10]


def test_prefill_donate_cache_false_keeps_the_cache_like_jax(engines,
                                                             prompts):
    """Fault 3.8: Engine(donate_cache=False).prefill writes a copy of the
    cache passed in, as the JAX Engine(donate_cache=False) returns a new
    cache. Prefill prompt A on cache C (giving C1), prefill prompt B on C,
    then decode one step on C1: C stays bitwise as it was, and the step's
    logits are within LOGIT_ATOL of the JAX Engine's on the same
    sequence. With donate_cache=True the prefill writes into C."""
    jeng, eng = engines
    keep = Engine(eng.cfg, device="cpu", max_len=64, params=eng.params,
                  donate_cache=False)
    ids_a = np.asarray([prompts[0][:6], prompts[1][:6]], np.int32)
    ids_b = np.asarray([prompts[2][:6], prompts[0][3:9]], np.int32)
    jc = jeng.new_cache(2)
    jla, jc1 = jeng.prefill(jnp.asarray(ids_a), jc)
    jeng.prefill(jnp.asarray(ids_b), jc)
    c = keep.new_cache(2)
    snap = [t.clone() for t in (c.k, c.v, c.length)]
    la, c1 = keep.prefill(ids_a, c)
    keep.prefill(ids_b, c)
    for x, y in zip(snap, (c.k, c.v, c.length)):
        assert torch.equal(x, y)
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), atol=LOGIT_ATOL)
    tok = la.argmax(-1)
    jl, _ = jeng.decode_step(jnp.asarray(tok.numpy().astype(np.int32)), jc1)
    lg, c2 = keep.decode_step(tok, c1)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert c1.length.tolist() == [6, 6] and c2.length.tolist() == [7, 7]
    donate = Engine(eng.cfg, device="cpu", max_len=64, params=eng.params)
    _, c3 = donate.prefill(ids_a, c)
    assert c3.k is c.k and not torch.equal(c.k, snap[0])


def test_mega_donate_cache_false_like_jax(engines):
    """MegaQwen3(donate_cache=False) against the JAX one built the same
    way: a paged cache stepped twice from one state gives the same
    logits in each (and across, LOGIT_ATOL) and is left as it was."""
    jeng, eng = engines
    cfg = eng.cfg
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jm = JaxMegaQwen3(JaxModelConfig.tiny(**CFG), mesh, batch=2, s_max=64,
                      params=jeng.params, donate_cache=False)
    pm = MegaQwen3(cfg, batch=2, s_max=64, params=eng.params, device="cpu",
                   donate_cache=False)
    ids = np.random.default_rng(2).integers(0, 256, (2, 6))
    _, dense = eng.prefill(ids)
    jl, jd = jeng.prefill(jnp.asarray(ids.astype(np.int32)))
    from triton_dist_tpu.mega.qwen3 import MegaKVCache as JaxMegaKVCache
    from triton_dist_tpu_torch.mega import MegaKVCache

    cache = MegaKVCache.from_dense(dense, 64)
    jcache = JaxMegaKVCache.from_dense(jd, 64)
    tok = torch.tensor([3, 7])
    snap = [t.clone() for t in cache]
    la, _ = pm.decode_step(tok, cache)
    lb, _ = pm.decode_step(tok, cache)
    assert torch.equal(la, lb)
    for x, y in zip(snap, cache):
        assert torch.equal(x, y)
    ja, _ = jm.decode_step(jnp.asarray([3, 7], jnp.int32), jcache)
    np.testing.assert_allclose(la.numpy(), np.asarray(ja), atol=LOGIT_ATOL)


# ---------- Engine.serve's key chain ----------


def test_serve_sampled_equals_jax_key_chain(engines, prompts):
    """Engine.serve at T 0.8 follows the JAX PRNGKey / split chain: its
    tokens equal the JAX Engine.serve's for three seeds; greedy equal
    too."""
    jeng, eng = engines
    ids = np.asarray([p[:9] for p in prompts], np.int32)
    for seed in (0, 5, 2**31 + 3):
        want = np.asarray(jeng.serve(jnp.asarray(ids), 5, temperature=0.8,
                                     seed=seed))
        got = eng.serve(ids, 5, temperature=0.8, seed=seed)
        assert got.tolist() == want.tolist(), seed
    want = np.asarray(jeng.serve(jnp.asarray(ids), 4))
    assert eng.serve(ids, 4).tolist() == want.tolist()


# ---------- the resident loop at world 4 ----------


@pytest.mark.parametrize("mode", ["ar", "dist"])
def test_world4_resident_bitwise_port_host_loop(mode):
    """World 4 on the virtual world (`ar` and `dist` steps): the resident
    Scheduler's tokens bitwise the port's host loop's, greedy and
    sampled."""
    cfg = ModelConfig.tiny(max_positions=32)
    eng = Engine(cfg, device="cpu", max_len=32, world=4, decode_mode=mode)
    rng = np.random.default_rng(6)
    ps = [list(map(int, rng.integers(0, 256, n))) for n in (6, 9)]
    geo = dict(slots=2, chunk=4, page=8)
    kw = dict(temperature=[0.0, 0.7], seed=[1, 2])
    host = _tokens(Scheduler(eng, **geo), ps, 4, **kw)
    sch = Scheduler(eng, resident=True, window=4, **geo)
    assert _tokens(sch, ps, 4, **kw) == host


def test_window_geometry_layout():
    """The state block's layout: header, slot state, table, lengths, out
    ring, contiguous and in that order."""
    geo = kring.WindowGeometry(3, 4, 8, 20, 4, 8)
    blk = torch.arange(geo.words, dtype=torch.int32)
    hdr, ss, tb, ln, out = geo.views(blk)
    assert hdr.shape == (16,) and ss.shape == (3, 16) and tb.shape == (3, 8)
    assert ln.shape == (3,) and out.shape == (20, 8)
    assert int(ss[0, 0]) == 16 and int(out[-1, -1]) == geo.words - 1
    assert geo.out_at == 16 + 48 + 24 + 3


def test_dropped_engine_frees_without_a_collection(engines, prompts):
    """An Engine and its resident loop hold no reference cycle: once the
    caller drops them, they are freed at once, with the cyclic collector
    off (a cycle would keep their graphs until a collection, which may
    come inside another graph's capture and lose it)."""
    import gc
    import weakref

    eng = Engine(engines[1].cfg, device="cpu", max_len=64,
                 params=engines[1].params)
    sch = Scheduler(eng, resident=True, window=4, **GEO)
    _tokens(sch, prompts[:1], 3)
    refs = [weakref.ref(eng), weakref.ref(sch.worker._fn)]
    gc.disable()
    try:
        del eng, sch
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()

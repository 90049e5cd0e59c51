"""The port's speculative decoding (triton_dist_tpu_torch/spec/, the
per-position serve step, the verify record and `slot_plan_spec`, the
spec-capable resident loop and `Scheduler(spec=)`), against the JAX
package on the CPU.

Tiny f32 config and geometry of tests/test_spec.py (4 q / 2 kv heads, 128
positions; slots 3, chunk 6, page 8; one spec width k = 4; 16 tokens a
request), prompts from np.random.default_rng(3), the JAX weights carried
over. Tolerances, stated per test: drafts, caps, accepted tokens, keys,
ring rows, slot plans, slot states, lengths and output records are
integer or bit-cast data and are held bitwise; greedy and sampled tokens
are held equal (as tests/test_torch_resident.py argues: the tiny model's
logits are far apart, the sampler's bits are JAX's, and the Gumbel noise
goes through torch's log, an ulp from XLA's at most, which moves no token
of these draws); logits within 1e-4 (f32 sums in another order); the
spec counters and step counts equal JAX's; and every spec stream is held
equal to the port's own spec-off stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.mega import ring as jring
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu.serve import KVPool as JaxKVPool
from triton_dist_tpu.serve import Scheduler as JaxScheduler
from triton_dist_tpu.serve.worker import sampling_key as jax_sampling_key
from triton_dist_tpu.spec import NgramDraft as JaxNgramDraft
from triton_dist_tpu.spec import SpecConfig as JaxSpecConfig
from triton_dist_tpu.spec import accept_tokens as jax_accept_tokens
from triton_dist_tpu.spec.verify import draft_cap as jax_draft_cap
from triton_dist_tpu.spec.verify import verify_keys as jax_verify_keys
from triton_dist_tpu_torch.kernels import ring as kring
from triton_dist_tpu_torch.mega import ring as pring
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax
from triton_dist_tpu_torch.serve import KVPool, Scheduler, sampling_key
from triton_dist_tpu_torch.spec import (
    Draft,
    NgramDraft,
    SpecConfig,
    accept_tokens,
    draft_cap,
    verify_keys,
)

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=128)
GEO = dict(slots=3, chunk=6, page=8)
K = 4
GEN = 16
LOGIT_ATOL = 1e-4
SEEDS = [41, 42, 43]


@pytest.fixture(scope="module")
def engines():
    mesh = make_mesh(mesh_shape=(1,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(**CFG), mesh, decode_mode="ar",
                     max_len=128, donate_cache=False)
    eng = Engine(ModelConfig.tiny(**CFG), device="cpu", max_len=128,
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jeng.params),
                                        device="cpu"))
    return jeng, eng


@pytest.fixture(scope="module")
def prompts(engines):
    rng = np.random.default_rng(3)
    v = engines[1].cfg.vocab_size
    return [list(map(int, rng.integers(0, v, 10))) for _ in range(3)]


def _run(sch, prompts, temperature=0.0, eos=None, gen=GEN):
    reqs = [sch.submit(p, gen, temperature=temperature, seed=SEEDS[i],
                       eos_id=eos)
            for i, p in enumerate(prompts)]
    sch.run()
    return [r.out_tokens for r in reqs], reqs


def _spec():
    return SpecConfig(k=K, draft=NgramDraft())


def _jspec():
    return JaxSpecConfig(k=K, draft=JaxNgramDraft())


def _numbers(sch, reqs):
    """What the two Schedulers must agree on: the spec counters, the
    device steps, and each request's verify and device steps."""
    m = sch.metrics()
    return dict(proposed=m["spec_proposed"], accepted=m["spec_accepted"],
                rate=m["spec_accept_rate"], k_live=m["spec_k_live"],
                device_steps=sch.worker.n_steps,
                spec_steps=[r.n_spec_steps for r in reqs],
                req_steps=[r.n_device_steps for r in reqs])


# the JAX Scheduler's runs, once a module: host loop, resident windows of 4
# (streams) and of 1 (the host loop's verify cadence: counters too)
MODES = {"host": {}, "resident4": dict(resident=True, window=4),
         "resident1": dict(resident=True, window=1)}


@pytest.fixture(scope="module")
def jax_runs(engines, prompts):
    jeng = engines[0]
    out = {}
    for mode, kw in MODES.items():
        for temp in (0.0, 0.9):
            sch = JaxScheduler(jeng, spec=_jspec(), **GEO, **kw)
            streams, reqs = _run(sch, prompts, temp)
            out[mode, temp] = (streams, _numbers(sch, reqs))
    return out


@pytest.fixture(scope="module")
def spec_off(engines, prompts):
    """The port's spec-off host-loop streams, greedy and sampled."""
    return {t: _run(Scheduler(engines[1], **GEO), prompts, t)[0]
            for t in (0.0, 0.9)}


# ---------- draft, cap, accept rule, keys ----------


def test_ngram_draft_equals_jax_on_seeded_histories():
    """NgramDraft(n, min_n).propose(history, k) equal to JAX's on 300
    seeded histories over a small vocabulary (so that grams repeat), for
    every k in 0..5 and gram sizes (3, 1), (2, 1), (4, 2)."""
    rng = np.random.default_rng(11)
    for n, min_n in ((3, 1), (2, 1), (4, 2)):
        ours, theirs = NgramDraft(n, min_n), JaxNgramDraft(n, min_n)
        for _ in range(100):
            hist = rng.integers(0, 6, rng.integers(0, 30)).tolist()
            for k in range(6):
                assert ours.propose(hist, k) == theirs.propose(hist, k), (
                    n, min_n, hist, k)
    assert isinstance(ours, Draft)


def test_ngram_draft_units():
    """The JAX unit cases (tests/test_spec.py:68-93) on the port."""
    d = NgramDraft(n=3)
    assert d.propose([1, 2, 3, 4, 2, 3], 2) == [4, 2]
    assert d.propose([1, 2, 3, 4, 2, 3], 5) == [4, 2, 3]
    assert d.propose([7, 8, 1, 7, 8, 2, 7, 8], 1) == [2]
    assert d.propose([5, 7, 8, 9, 1, 5, 7, 8], 1) == [9]
    assert d.propose([], 4) == [] and d.propose([1], 4) == []
    assert d.propose([1, 2, 3], 0) == [] and d.propose([1, 2, 3], 4) == []
    with pytest.raises(ValueError):
        NgramDraft(n=1, min_n=2)


def test_draft_cap_and_accept_tokens_equal_jax():
    """draft_cap over a grid of (k, chunk, history, n_out, max_new,
    t_max) and accept_tokens over seeded rows (eos and budget cuts
    included) equal to JAX's."""
    for k in (0, 2, 4, 8):
        for chunk in (1, 4, 6):
            for hist in (5, 20, 125, 128):
                for n_out in (0, 3, 9):
                    for max_new in (1, 10, 16):
                        args = (k, chunk, hist, n_out, max_new, 128)
                        assert draft_cap(*args) == jax_draft_cap(*args)
    rng = np.random.default_rng(12)
    for _ in range(400):
        kd = int(rng.integers(0, 5))
        row = rng.integers(0, 4, kd + 1).tolist()
        drafts = [t if rng.random() < 0.7 else int(rng.integers(0, 4))
                  for t in row[:kd]]
        eos = None if rng.random() < 0.5 else int(rng.integers(0, 4))
        budget = None if rng.random() < 0.5 else int(rng.integers(0, 6))
        assert accept_tokens(drafts, row, eos, budget) == jax_accept_tokens(
            drafts, row, eos, budget)
    assert accept_tokens([5, 6, 9], [5, 6, 7]) == [5, 6, 7]
    assert accept_tokens([5, 6], [5, 6, 7], eos_id=6) == [5, 6]
    assert accept_tokens([5, 6], [5, 6, 7], max_emit=2) == [5, 6]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 12345])
def test_verify_keys_bitwise_jax(seed):
    """verify_keys with the port's sampling_key bitwise the JAX
    verify_keys with the JAX sampling_key: (cols, 2) uint32, zero past
    the row's width."""
    for n_out, width, cols in ((0, 1, 6), (5, 5, 6), (13, 3, 4)):
        got = verify_keys(sampling_key, seed, n_out, width, cols)
        want = jax_verify_keys(jax_sampling_key, seed, n_out, width, cols)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


# ---------- the per-position serve step ----------


def test_per_pos_serve_step_equals_jax(engines):
    """One per-position step on the same pools: slot 0 a verify row [last,
    4 drafts], slot 1 a one-token decode row (sampled), slot 2 a
    completing prefill chunk (sampled), the keys from verify_keys. Tokens
    (K, C) equal JAX's, last logits within 1e-4, the K/V the step wrote
    into the pools within 1e-5, and the keys the port derives bitwise
    JAX's."""
    jeng, eng = engines
    kw = dict(slots=3, page=8, total_pages=12)
    jp, pp = JaxKVPool(jeng, **kw), KVPool(eng, **kw)
    for pool in (jp, pp):
        for slot, n in ((0, 17), (1, 9), (2, 12)):
            pool.admit(slot, n)
            pool.ensure(slot, n + 6)
    lengths = np.array([17, 9, 6])
    pp.lengths[:] = lengths
    jp.lengths = lengths.astype(jp.lengths.dtype)
    rng = np.random.default_rng(4)
    k = rng.standard_normal(tuple(pp.k.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(pp.v.shape)).astype(np.float32)
    pp.k.copy_(torch.from_numpy(k))
    pp.v.copy_(torch.from_numpy(v))
    jp.k, jp.v = jnp.asarray(k), jnp.asarray(v)
    C = 6
    tokens = np.zeros((3, C), np.int32)
    tokens[0, :5] = [7, 11, 7, 11, 7]
    tokens[1, 0] = 19
    tokens[2, :] = [3, 4, 5, 6, 8, 9]
    n_valid = np.array([5, 1, 6], np.int32)
    temps = np.array([0.0, 0.9, 0.7], np.float32)
    keys = np.zeros((3, C, 2), np.uint32)
    keys[0] = verify_keys(sampling_key, 5, 3, 5, C)
    keys[1] = verify_keys(sampling_key, 6, 2, 1, C)
    keys[2, 5:] = verify_keys(sampling_key, 8, 0, 1, 1)
    jkeys = np.zeros_like(keys)
    jkeys[0] = jax_verify_keys(jax_sampling_key, 5, 3, 5, C)
    jkeys[1] = jax_verify_keys(jax_sampling_key, 6, 2, 1, C)
    jkeys[2, 5:] = jax_verify_keys(jax_sampling_key, 8, 0, 1, 1)
    np.testing.assert_array_equal(keys, jkeys)
    fn = eng.make_serve_step(3, C, 8, pp.max_pages, per_pos=True)
    tok, last = fn(tokens, pp.k, pp.v, pp.table, pp.lengths, n_valid, temps,
                   keys)
    jfn = jeng.make_serve_step(3, C, 8, jp.max_pages, per_pos=True)
    jtok, jlast, jk, jv = jfn(jeng.params, jnp.asarray(tokens), jp.k, jp.v,
                              jnp.asarray(jp.table), jnp.asarray(jp.lengths),
                              jnp.asarray(n_valid), jnp.asarray(temps),
                              jnp.asarray(jkeys))
    assert tuple(tok.shape) == (3, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(pp.k[:, :, 1:].numpy(),
                               np.asarray(jk)[:, :, 1:], atol=1e-5)
    np.testing.assert_allclose(pp.v[:, :, 1:].numpy(),
                               np.asarray(jv)[:, :, 1:], atol=1e-5)


# ---------- the verify record and slot_plan_spec ----------


def test_injection_ring_verify_records_bitwise_jax():
    """admit / verify / retire in the same order on both rings: the
    buffer, the pins (a verify row pinned by ("spec", seq)), the counts
    and the backpressure bitwise; unpinning the verify rows frees them."""
    jr = jring.InjectionRing(6, 4, 16, 4)
    pr = pring.InjectionRing(6, 4, 16, 4)
    for r in (jr, pr):
        r.admit(0, list(range(1, 9)), 5, 0.5, 3, None, req_id=1,
                table_row=np.arange(1, 5))
    pins = []
    for args in ((0, 1, 2, [9, 8, 7]), (1, 4, 0, [5]),
                 (2, 6, 7, [1, 2, 3, 4])):
        jp = jr.verify(*args, at_step=3)
        pins.append(pr.verify(*args, at_step=3))
        assert pins[-1] == jp
    for r in (jr, pr):
        r.retire(0, req_id=1)
    np.testing.assert_array_equal(pr.buf, jr.buf)
    assert pr._pins == jr._pins
    assert (pr.published, pr.version, pr.can_claim(), pr.pending()) == (
        jr.published, jr.version, jr.can_claim(), jr.pending())
    for r in (jr, pr):
        r.ack(5)
    assert pr.can_claim() == jr.can_claim()
    for pin in pins:
        pr.unpin(pin)
        jr.unpin(pin)
    pr.unpin(1)
    jr.unpin(1)
    assert pr.can_claim() and jr.can_claim()
    with pytest.raises(ValueError):
        pr.verify(0, 1, 0, [])


def _spec_state(rng, C=6, maxp=4, cap=8, K=8):
    """A random ring of admissions and verify records and a slot state
    whose decoding slots point at verify rows: fresh (seq, kind, req_id
    and n_out all match), or stale by one of them (wrong n_out, a row
    overwritten by a later seq or an admission, another req_id), and
    staged counts above k and above the budget."""
    prompt_cap = 16
    rw = pring.ring_width(maxp, prompt_cap, C)
    ring = rng.integers(-5, 300, (cap, rw)).astype(np.int32)
    for i in range(cap):
        r = ring[i]
        r[pring.IR_SEQ] = i + 1
        r[pring.IR_KIND] = rng.choice([pring.KIND_ADMIT] + [
            pring.KIND_VERIFY] * 3)
        r[pring.IR_REQID] = rng.integers(0, 4)
        r[pring.IR_NOUT] = rng.integers(0, 8)
        r[pring.IR_SPEC_K] = rng.integers(1, 7)
    ss = np.zeros((K, pring.SS_WIDTH), np.int32)
    for s in range(K):
        plen = int(rng.integers(1, prompt_cap + 1))
        ss[s, pring.SS_ACTIVE] = rng.random() < 0.85
        ss[s, pring.SS_PHASE] = rng.random() < 0.75
        ss[s, pring.SS_PROMPT_LEN] = plen
        ss[s, pring.SS_POS] = (plen if ss[s, pring.SS_PHASE]
                               else rng.integers(0, plen))
        ss[s, pring.SS_TEMP_BITS] = np.float32(
            rng.choice([0.0, 0.8])).view(np.int32)
        ss[s, pring.SS_SEED] = rng.integers(-2**31, 2**31 - 1)
        ss[s, pring.SS_LAST_TOK] = rng.integers(0, 300)
        ss[s, pring.SS_REC] = rng.integers(0, cap)
        row = int(rng.integers(0, cap))
        r = ring[row]
        ss[s, pring.SS_SPEC_REC] = row
        ss[s, pring.SS_SPEC_SEQ] = r[pring.IR_SEQ]
        ss[s, pring.SS_SPEC_K] = r[pring.IR_SPEC_K] * (rng.random() < 0.9)
        ss[s, pring.SS_REQID] = r[pring.IR_REQID]
        ss[s, pring.SS_N_OUT] = r[pring.IR_NOUT]
        stale = rng.integers(0, 7)
        if stale == 1:
            ss[s, pring.SS_N_OUT] += 1
        elif stale == 2:
            ss[s, pring.SS_SPEC_SEQ] += cap  # the row was overwritten
        elif stale == 3:
            ss[s, pring.SS_REQID] += 1
        # a budget from spent to a few past the drafts
        ss[s, pring.SS_MAX_NEW] = ss[s, pring.SS_N_OUT] + rng.integers(0, 8)
    return ring, ss


@pytest.mark.parametrize("seed", range(6))
def test_slot_plan_spec_bitwise_jax(seed):
    """slot_plan_spec (tokens, n_valid, temps, keys, emits, kd) bitwise
    the JAX function on random rings and slot states with fresh and stale
    verify records, at k 4 and 2, chunk 6 and 3; a fresh record on a
    decoding slot is a verify row and a stale one a one-token row."""
    rng = np.random.default_rng(seed)
    verified = plain = 0
    for C, k_max in ((6, 4), (6, 2), (3, 4)):
        ring, ss = _spec_state(rng, C=C)
        want = jring.slot_plan_spec(jnp.asarray(ring), jnp.asarray(ss), C, 4,
                                    k_max)
        got = pring.slot_plan_spec(torch.from_numpy(ring),
                                   torch.from_numpy(ss), C, 4, k_max)
        for name, g, w in zip(("tokens", "n_valid", "temps", "keys",
                               "emits", "kd"), got, want):
            g, w = g.numpy(), np.asarray(w)
            if name == "temps":
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=name)
        decoding = (ss[:, pring.SS_ACTIVE] > 0) & (ss[:, pring.SS_PHASE] > 0)
        kd = got[5].numpy()
        verified += int((kd > 0).sum())
        plain += int((decoding & (kd == 0)).sum())
    assert verified > 0 and plain > 0


def test_ring_spec_step_buffers_and_refusal():
    """The spec step's buffers (the plain forms of ring_boundary and
    ring_emit are held to the JAX loop by test_spec_window_bitwise_jax_loop):
    keys (K, C, 2) a column, kd (K,), the plain loop's keys (K, 2); a
    spec_k >= chunk refused by the wrappers' check."""
    geo = kring.WindowGeometry(3, 6, 4, 40, 4, 8, spec_k=4)
    bufs = kring.StepBuffers.create(geo, "cpu")
    assert tuple(bufs.keys.shape) == (3, 6, 2)
    assert tuple(bufs.kd.shape) == (3,)
    plain = kring.StepBuffers.create(geo._replace(spec_k=0), "cpu")
    assert tuple(plain.keys.shape) == (3, 2)
    with pytest.raises(ValueError, match="spec_k"):
        kring._check(geo._replace(spec_k=6), None, geo.new_block("cpu"),
                     kring.StepBuffers.create(geo._replace(spec_k=5),
                                              "cpu"))


# ---------- the spec-capable resident window ----------


def _jax_window(jeng, ring, pub, con, step0, ss, tb, ln, pk, pv, window):
    fn = jeng.make_resident_loop(3, 6, 8, 16, window, ring_cap=16,
                                 prompt_cap=128, spec_k=K)
    return fn(jeng.params, jnp.asarray(ring), jnp.int32(pub), jnp.int32(con),
              jnp.int32(step0), jnp.asarray(ss), jnp.asarray(tb),
              jnp.asarray(ln), pk, pv)


def test_spec_window_bitwise_jax_loop(engines, prompts):
    """Windows of the port's spec loop (spec_k 4: the plain boundary and
    emit spec forms, the forward, the column sampler) against the JAX
    spec loop on the same ring and state: three admissions (one sampled,
    one with an eos), a window of 4, then verify records drafted by
    NgramDraft from each decoding slot's history (plus a stale one at the
    wrong n_out and one for another request), then windows of 3 and 16.
    Consumed, executed, slot state, table, lengths and every output
    record bitwise; some records are FLAG_SPEC and some verify accepted."""
    jeng, eng = engines
    ring = pring.InjectionRing(16, 16, 128, 6)
    tables = [np.arange(1, 17), np.arange(17, 33), np.arange(33, 49)]
    ring.admit(0, prompts[0], 14, 0.0, 0, None, req_id=1,
               table_row=tables[0])
    ring.admit(1, prompts[1], 12, 0.8, 21, None, req_id=2,
               table_row=tables[1])
    ring.admit(2, prompts[2], 20, 0.0, 0, 170, req_id=3,
               table_row=tables[2])
    shape = (eng.cfg.num_layers, eng.cfg.num_kv_heads, 49, 8,
             eng.cfg.head_dim)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    jpk, jpv = jnp.zeros(shape), jnp.zeros(shape)
    ss = np.zeros((3, pring.SS_WIDTH), np.int32)
    tb = np.zeros((3, 16), np.int32)
    ln = np.zeros((3,), np.int32)
    con, step0 = 0, 0
    hist = {1: list(prompts[0]), 2: list(prompts[1]), 3: list(prompts[2])}
    records = []
    for i, window in enumerate((4, 3, 16)):
        if i == 1:
            draft = NgramDraft()
            for slot in range(3):
                rid = int(ss[slot, pring.SS_REQID])
                n_out = int(ss[slot, pring.SS_N_OUT])
                d = draft.propose(hist[rid], K) or [hist[rid][-1]]
                if ss[slot, pring.SS_ACTIVE] and ss[slot, pring.SS_PHASE]:
                    ring.verify(slot, rid, n_out, d[:K])
            ring.verify(0, 1, 99, [1, 2])   # stale: wrong n_out
            ring.verify(1, 7, int(ss[1, pring.SS_N_OUT]), [3])  # other id
        loop = eng.make_resident_loop(3, 6, 8, 16, window, ring_cap=16,
                                      prompt_cap=128, spec_k=K)
        got = loop(torch.from_numpy(ring.buf), ring.published, con, step0,
                   ss, tb, ln, pk, pv)
        (jcon, jexe, jss, jtb, jln, jpk, jpv, jout, jcount,
         jstarved) = _jax_window(jeng, ring.buf, ring.published, con, step0,
                                 ss, tb, ln, jpk, jpv, window)
        assert (got.consumed, got.executed, got.out_count, got.starved) == (
            int(jcon), int(jexe), int(jcount), bool(jstarved))
        for g, w in ((got.slot_state, jss), (got.table, jtb),
                     (got.lengths, jln)):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got.out_ring,
                                      np.asarray(jout)[:got.out_count])
        np.testing.assert_allclose(pk[:, :, 1:].numpy(),
                                   np.asarray(jpk)[:, :, 1:], atol=1e-5)
        recs = pring.decode_out_ring(got.out_ring, got.out_count)
        for r in recs:
            if r.emitted:
                hist[r.req_id].append(r.token)
        records += recs
        ring.ack(got.consumed)
        ss, tb, ln = got.slot_state, got.table, got.lengths
        con, step0 = got.consumed, step0 + got.executed
    spec = [r for r in records if r.spec]
    assert spec and any(r.spec_k > 0 for r in spec)
    assert len(spec) > sum(r.spec_k > 0 for r in spec)  # some accepted
    assert got.executed < 16  # the last window exited early


def test_resident_loop_spec_geometry(engines):
    """spec_k joins the loop's key: spec_k 0 and 4 are two loops, the
    spec one's output ring W K (1 + spec_k) + ring_cap rows; spec_k >=
    chunk is refused."""
    eng = engines[1]
    a = eng.make_resident_loop(3, 6, 8, 16, 4, ring_cap=16, prompt_cap=128)
    b = eng.make_resident_loop(3, 6, 8, 16, 4, ring_cap=16, prompt_cap=128,
                               spec_k=K)
    assert a is not b and a.geo.spec_k == 0 and b.geo.spec_k == K
    assert a.geo.out_cap == 4 * 3 + 16
    assert b.geo.out_cap == 4 * 3 * (1 + K) + 16
    with pytest.raises(ValueError, match="spec_k"):
        eng.make_resident_loop(3, 6, 8, 16, 4, ring_cap=16, prompt_cap=128,
                               spec_k=6)


# ---------- the Scheduler ----------


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_streams_equal_jax_and_spec_off(engines, prompts, jax_runs,
                                             spec_off, mode, temperature):
    """Scheduler(spec=SpecConfig(k=4)), host loop and resident (windows of
    4 and 1), greedy and sampled (T 0.9, seeds 41-43): every stream equal
    to the JAX spec Scheduler's and to the port's spec-off stream; the
    pool's invariants hold and every page is back."""
    sch = Scheduler(engines[1], spec=_spec(), **GEO, **MODES[mode])
    got, _ = _run(sch, prompts, temperature)
    assert got == jax_runs[mode, temperature][0]
    assert got == spec_off[temperature]
    sch.pool.check()
    assert sch.pool.used_pages() == 0


@pytest.mark.parametrize("mode", ["host", "resident1"])
def test_spec_counters_equal_jax(engines, prompts, jax_runs, mode):
    """The spec counters (proposed, accepted, the rate, the live k), the
    device steps and each request's verify and device steps equal the
    JAX Scheduler's, greedy and sampled, in the host loop and in windows
    of 1 (the host loop's cadence); greedy drafts are accepted and save
    device steps against the spec-off run."""
    for temperature in (0.0, 0.9):
        sch = Scheduler(engines[1], spec=_spec(), **GEO, **MODES[mode])
        _, reqs = _run(sch, prompts, temperature)
        got = _numbers(sch, reqs)
        assert got == jax_runs[mode, temperature][1], temperature
        if temperature == 0.0:
            assert got["proposed"] > 0 and got["accepted"] > 0
            assert 0 < got["rate"] <= 1 and got["k_live"] == K
            off = Scheduler(engines[1], **GEO, **MODES[mode])
            _run(off, prompts)
            assert sch.worker.n_steps < off.worker.n_steps
    if mode == "host":
        assert sch.metrics()["steps"] == sch.worker.n_steps


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_steps_account_for_every_token(engines, prompts, mode):
    """Each request's decode steps (its device steps past its prefill
    chunks) emit GEN - 1 tokens: one a step plus what its verify steps
    accepted, so the accepted drafts summed over the requests are the
    spec_accepted counter (resident: the drain's FLAG_SPEC groups, one
    device step each); at most n_spec_steps * k proposed."""
    sch = Scheduler(engines[1], spec=_spec(), **GEO, **MODES[mode])
    _, reqs = _run(sch, prompts)
    m = sch.metrics()
    decode = [r.n_device_steps - r.n_prefill_chunks for r in reqs]
    assert sum(GEN - 1 - d for d in decode) == m["spec_accepted"] > 0
    assert 0 < m["spec_proposed"] <= K * sum(r.n_spec_steps for r in reqs)


def test_spec_eos_mid_verify(engines, prompts, spec_off):
    """An eos inside an accepted prefix cuts the stream where sequential
    decode stops (host loop and resident): the spec-off stream up to its
    first eos, finish reason eos, the pool whole."""
    base = spec_off[0.0][0]
    eos = base[8]
    idx = base.index(eos)
    for kw in ({}, dict(resident=True, window=4)):
        sch = Scheduler(engines[1], spec=_spec(), **GEO, **kw)
        req = sch.submit(prompts[0], GEN, eos_id=eos)
        sch.run()
        assert req.out_tokens == base[:idx + 1], kw
        assert req.finish_reason == "eos"
        sch.pool.check()


def test_spec_with_eviction_bitwise(engines, prompts, spec_off):
    """Spec under page pressure (total_pages 7): verify rows grow pages
    like decode rows, requests are evicted and re-prefilled, and every
    stream is still the spec-off one."""
    sch = Scheduler(engines[1], spec=_spec(), total_pages=7, **GEO)
    got, reqs = _run(sch, prompts)
    assert sum(r.n_evictions for r in reqs) > 0
    assert got == spec_off[0.0]
    sch.pool.check()


@pytest.mark.parametrize("resident", [False, True])
def test_spec_with_prefix_cache(engines, resident):
    """Spec beside the prefix cache (block 8), two waves sharing an
    8-token prefix: the wave-2 requests hit, and every stream, greedy and
    sampled, equals the spec-off run without the cache."""
    rng = np.random.default_rng(9)
    v = engines[1].cfg.vocab_size
    shared = rng.integers(0, v, 8).tolist()
    ps = [shared + rng.integers(0, v, n).tolist() for n in (3, 5, 2)]

    def waves(sch):
        out = [sch.submit(ps[0], 12)]
        sch.run()
        out += [sch.submit(p, 12, temperature=0.9 * (i == 1), seed=i)
                for i, p in enumerate(ps[1:], 1)]
        sch.run()
        return [r.out_tokens for r in out]

    want = waves(Scheduler(engines[1], **GEO))
    kw = dict(resident=True, window=4) if resident else {}
    sch = Scheduler(engines[1], spec=_spec(), prefix_cache=True,
                    prefix_block=8, **GEO, **kw)
    assert waves(sch) == want
    assert sch.metrics()["prefix_hits"] == 2
    sch.pool.check()
    sch.prefix.check()


def test_world4_ar_spec_equals_spec_off():
    """World 4 on the virtual world, `ar` steps: the spec Scheduler's
    streams, host loop and resident (windows of 4), greedy and sampled,
    equal to the port's spec-off host loop's."""
    cfg = ModelConfig.tiny(max_positions=64)
    eng = Engine(cfg, device="cpu", max_len=64, world=4, decode_mode="ar")
    rng = np.random.default_rng(6)
    ps = [rng.integers(0, 8, n).tolist() for n in (6, 9)]
    geo = dict(slots=2, chunk=4, page=8)

    def run(sch):
        reqs = [sch.submit(p, 10, temperature=t, seed=i)
                for i, (p, t) in enumerate(zip(ps, (0.0, 0.7)))]
        sch.run()
        return [r.out_tokens for r in reqs]

    want = run(Scheduler(eng, **geo))
    spec = SpecConfig(k=3)
    host = Scheduler(eng, spec=spec, **geo)
    assert run(host) == want
    assert host.metrics()["spec_proposed"] > 0
    assert run(Scheduler(eng, spec=spec, resident=True, window=4,
                         **geo)) == want


def test_spec_refusals_and_metrics_keys(engines):
    """SpecConfig(adaptive=True) names ROADMAP item 7; k + 1 > chunk
    asserts; a per-position worker refuses `step` and a plain one
    `step_spec`; a loop without spec_k refuses a verify record; k = 0 is
    off; the spec keys are in metrics() with spec off (spec_k_live 0)."""
    eng = engines[1]
    with pytest.raises(NotImplementedError, match="item 7"):
        Scheduler(eng, spec=SpecConfig(k=K, adaptive=True), **GEO)
    with pytest.raises(AssertionError, match="k\\+1 <= chunk"):
        Scheduler(eng, spec=SpecConfig(k=8), **GEO)
    sch = Scheduler(eng, spec=_spec(), **GEO)
    with pytest.raises(AssertionError, match="step_spec"):
        sch.worker.step(np.zeros((3, 6), np.int32), np.zeros((3,), np.int32),
                        np.zeros((3,), np.float32),
                        np.zeros((3, 2), np.uint32))
    off = Scheduler(eng, spec=SpecConfig(k=0), **GEO)
    assert off.spec is None and not off.worker.per_pos
    with pytest.raises(AssertionError, match="per_pos"):
        off.worker.step_spec(np.zeros((3, 6), np.int32),
                             np.zeros((3,), np.int32),
                             np.zeros((3,), np.float32),
                             np.zeros((3, 6, 2), np.uint32))
    m = off.metrics()
    assert (m["spec_proposed"], m["spec_accepted"], m["spec_accept_rate"],
            m["spec_k_live"]) == (0, 0, 0.0, 0)
    res = Scheduler(eng, resident=True, window=2, **GEO)
    with pytest.raises(AssertionError, match="spec_k"):
        res.worker.inject_verify(0, 1, 0, [1])
    with pytest.raises(ValueError):
        SpecConfig(k=-1)

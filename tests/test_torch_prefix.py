"""The port's prefix cache (serve/prefix.py), the KVPool's refcount /
share / copy-on-write plane and the Scheduler's prefix admission, host
loop and resident loop, against the JAX package on the CPU.

Tiny f32 config and geometry of tests/test_prefix.py (4 q / 2 kv heads,
64 positions; slots 3, chunk 4, page 8, trie block 8), prompts from
np.random.default_rng(7), the JAX weights carried over. Tolerances,
stated per test: the pools' bookkeeping (tables, lengths, refcounts,
free lists, external holds), the trie's match results, block counts and
reclaim victims are integer data and are held equal; page rows moved by
`cow`, `export_pages` and `install` are held bitwise; greedy and sampled
tokens are held equal (as tests/test_torch_resident.py argues: the tiny
model's logits are far apart, the sampler's bits are JAX's); and a hit's
tokens are held equal to its cold run's in the port itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu.serve import KVPool as JaxKVPool
from triton_dist_tpu.serve import PoolExhausted as JaxPoolExhausted
from triton_dist_tpu.serve import PrefixCache as JaxPrefixCache
from triton_dist_tpu.serve import Scheduler as JaxScheduler
from triton_dist_tpu_torch.mega import ring as pring
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax
from triton_dist_tpu_torch.serve import (
    KVPool,
    PoolExhausted,
    PrefixCache,
    RequestState,
    Scheduler,
)

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=64)
GEO = dict(slots=3, chunk=4, page=8)
BLOCK = 8  # trie block == page: every prompt of >= 9 tokens can hit
GEN = 6


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
    # >= BLOCK + 1 tokens each, so that every prompt can hit a full block
    return [list(map(int, rng.integers(0, v, n))) for n in (12, 11, 9)]


def _both_pools(engines, **kw):
    return JaxKVPool(engines[0], **kw), KVPool(engines[1], **kw)


def _same_pool(jp, pp, what=""):
    """The two pools' bookkeeping equal, and both pass their check()."""
    np.testing.assert_array_equal(pp.table, jp.table, err_msg=what)
    np.testing.assert_array_equal(pp.lengths, jp.lengths, err_msg=what)
    np.testing.assert_array_equal(pp._refs, jp._refs, err_msg=what)
    assert pp._free == jp._free, what
    assert pp._pages == jp._pages, what
    assert pp._ext == jp._ext, what
    assert (pp.free_pages(), pp.used_pages(), pp.shared_pages()) == (
        jp.free_pages(), jp.used_pages(), jp.shared_pages()), what
    jp.check()
    pp.check()


def _both(jp, pp, op, *args):
    """op on both pools: the same result or the same exception type."""
    out = []
    for pool in (jp, pp):
        try:
            out.append(("ok", getattr(pool, op)(*args)))
        except (PoolExhausted, JaxPoolExhausted, AssertionError) as err:
            out.append((type(err).__name__, None))
    (jk, jr), (pk, pr) = out
    assert jk == pk, f"{op}{args}: JAX {jk}, port {pk}"
    assert jr == pr, f"{op}{args}: JAX {jr}, port {pr}"
    _same_pool(jp, pp, f"after {op}{args}")
    return pr


def _fill_pages(jp, pp, seed):
    """The same random rows in every page of both pools."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(tuple(pp.k.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(pp.v.shape)).astype(np.float32)
    jp.k, jp.v = jnp.asarray(k), jnp.asarray(v)
    pp.k.copy_(torch.from_numpy(k))
    pp.v.copy_(torch.from_numpy(v))


# ---------- KVPool refcount / share / cow (tests/test_prefix.py:63-136) ----


def test_pool_ref_unref_keeps_pages_alive_like_jax(engines):
    jp, pp = _both_pools(engines, slots=2, page=8, total_pages=4)
    _both(jp, pp, "admit", 0, 16)
    held = list(pp._pages[0])
    _both(jp, pp, "ref_pages", held)
    _both(jp, pp, "release", 0)
    assert pp.free_pages() == 2  # the holds keep the donor's pages
    assert all(pp.refcount(p) == 1 for p in held)
    assert _both(jp, pp, "unref_pages", held) == 2
    assert pp.free_pages() == 4
    _both(jp, pp, "unref_pages", held)  # no hold left: both refuse


def test_pool_share_admits_over_held_pages_like_jax(engines):
    jp, pp = _both_pools(engines, slots=2, page=8, total_pages=4)
    _both(jp, pp, "admit", 0, 16)
    held = list(pp._pages[0])
    _both(jp, pp, "ref_pages", held)
    _both(jp, pp, "release", 0)
    _both(jp, pp, "share", 1, held, 20)  # 2 shared + 1 fresh
    assert pp.lengths[1] == 16  # the shared coverage
    assert list(pp.table[1, :3]) == held + [pp._pages[1][2]]
    assert all(pp.refcount(p) == 2 for p in held)
    _both(jp, pp, "release", 1)
    assert all(pp.refcount(p) == 1 for p in held)  # the cache still holds
    _both(jp, pp, "share", 0, [pp._free[0]], 8)  # an unheld page: refused


def test_pool_share_is_all_or_nothing_like_jax(engines):
    jp, pp = _both_pools(engines, slots=2, page=8, total_pages=2)
    _both(jp, pp, "admit", 0, 16)
    held = list(pp._pages[0])
    _both(jp, pp, "ref_pages", held)
    _both(jp, pp, "release", 0)
    _both(jp, pp, "share", 1, held, 16)  # exact fit, no fresh page
    _both(jp, pp, "release", 1)
    _both(jp, pp, "share", 1, held, 24)  # 1 fresh needed, 0 free
    assert pp._pages[1] is None  # nothing half-claimed
    assert all(pp.refcount(p) == 1 for p in held)


def test_pool_cow_copies_shared_page_bitwise_like_jax(engines):
    """cow on both pools: the bookkeeping equal after each op, the copy's
    rows bitwise the original's and bitwise JAX's copy; the write lands
    in the pool's own tensors (the graphs hold them)."""
    jp, pp = _both_pools(engines, slots=2, page=8, total_pages=4)
    _fill_pages(jp, pp, 3)
    k_id, v_id = id(pp.k), id(pp.v)
    ptr = pp.k.data_ptr()
    _both(jp, pp, "admit", 0, 8)
    (pg,) = pp._pages[0]
    assert _both(jp, pp, "cow", 0, 0) == pg  # exclusive: a no-op
    _both(jp, pp, "ref_pages", [pg])
    new = _both(jp, pp, "cow", 0, 0)
    assert new != pg and pp.table[0, 0] == new
    assert pp.refcount(pg) == 1 and pp.refcount(new) == 1
    assert (id(pp.k), id(pp.v), pp.k.data_ptr()) == (k_id, v_id, ptr)
    for got, want in ((pp.k, jp.k), (pp.v, jp.v)):
        np.testing.assert_array_equal(got[:, :, new].numpy(),
                                      got[:, :, pg].numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _both(jp, pp, "release", 0)
    _both(jp, pp, "unref_pages", [pg])
    # no free page for the copy: PoolExhausted on both, nothing moved
    _both(jp, pp, "admit", 0, 32)
    _both(jp, pp, "ref_pages", [pp._pages[0][1]])
    _both(jp, pp, "cow", 0, 1)


def test_pool_check_catches_refcount_drift(engines):
    pool = KVPool(engines[1], slots=2, page=8, total_pages=4)
    pool.admit(0, 8)
    pool._refs[pool._pages[0][0]] += 1  # a phantom holder
    with pytest.raises(AssertionError, match="refcount drift"):
        pool.check()


def test_pool_double_free_still_asserts(engines):
    pool = KVPool(engines[1], slots=2, page=8, total_pages=4)
    pool.admit(0, 8)
    pool.release(0)
    with pytest.raises(AssertionError, match="double free"):
        pool.release(0)


def test_pool_export_install_to_dense_bitwise_jax(engines):
    """export_pages bitwise JAX's on the same pages, install of that
    image into both pools bitwise (and all or nothing: a wrong page count
    raises before any state moves), to_dense bitwise JAX's dense view."""
    jp, pp = _both_pools(engines, slots=3, page=8, total_pages=8)
    _fill_pages(jp, pp, 4)
    _both(jp, pp, "admit", 0, 20)
    _both(jp, pp, "admit", 1, 9)
    pp.lengths[:2] = jp.lengths[:2] = (20, 9)
    for n in (None, 8, 17):
        for got, want in zip(pp.export_pages(0, n), jp.export_pages(0, n)):
            np.testing.assert_array_equal(got, np.asarray(want))
    kimg, vimg = pp.export_pages(0, 20)
    k_before = pp.k.clone()
    for pool in (jp, pp):
        with pytest.raises(AssertionError):
            pool.install(2, kimg[:, :, :2], vimg[:, :, :2], 20)
    _same_pool(jp, pp, "a refused install")
    assert torch.equal(pp.k, k_before)
    jp.install(2, kimg, vimg, 20)
    pp.install(2, kimg, vimg, 20)
    _same_pool(jp, pp, "install")
    for got, want in zip(pp.export_pages(2), (kimg, vimg)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pp.k.numpy(), np.asarray(jp.k))
    dense = pp.to_dense()
    want = jp.to_dense()
    for got, w in zip(dense.jax_layout(), (want.k, want.v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    np.testing.assert_array_equal(dense.length.numpy(),
                                  np.asarray(want.length))


def test_pool_export_install_roundtrip_bf16(engines):
    """bf16 pages leave export_pages as their int16 bits and come back
    bitwise through install."""
    eng = Engine(ModelConfig.tiny(**CFG, dtype="bfloat16"), device="cpu",
                 max_len=64)
    pool = KVPool(eng, slots=2, page=8, total_pages=6)
    pool.k.copy_(torch.randn(pool.k.shape))
    pool.admit(0, 17)
    kimg, vimg = pool.export_pages(0)
    assert kimg.dtype == np.int16 and kimg.shape[2] == 3
    pool.install(1, kimg, vimg, 17)
    assert torch.equal(pool.k[:, :, pool._pages[1]],
                       pool.k[:, :, pool._pages[0]])
    pool.check()


# ---------- the trie (tests/test_prefix.py:157-230) ----------


def _both_caches(engines, total_pages=12):
    jp, pp = _both_pools(engines, slots=3, page=8, total_pages=total_pages)
    return jp, pp, JaxPrefixCache(jp, block=BLOCK), PrefixCache(pp,
                                                                block=BLOCK)


def _same_cache(jc, pc):
    assert pc.n_blocks() == jc.n_blocks()
    assert sorted(pc.held_pages()) == sorted(jc.held_pages())
    assert (pc.hits, pc.misses, pc.tokens_reused) == (
        jc.hits, jc.misses, jc.tokens_reused)
    jc.check()
    pc.check()
    _same_pool(jc.pool, pc.pool)


def _cache_op(jc, pc, op, *args):
    got = getattr(pc, op)(*args)
    want = getattr(jc, op)(*args)
    assert got == want, f"{op}: port {got}, JAX {want}"
    _same_cache(jc, pc)
    return got


def _fill_slot(jp, pp, slot, n_tokens):
    jp.admit(slot, n_tokens)
    pp.admit(slot, n_tokens)
    np.testing.assert_array_equal(pp.table[slot], jp.table[slot])
    return pp.table[slot]


def test_trie_match_insert_roundtrip_like_jax(engines):
    jp, pp, jc, pc = _both_caches(engines)
    toks = list(range(20))
    row = _fill_slot(jp, pp, 0, 20)  # 3 pages
    assert _cache_op(jc, pc, "match", toks) == (0, [])
    assert _cache_op(jc, pc, "insert", toks, row) == 2  # two full blocks
    assert _cache_op(jc, pc, "match", toks) == (16, list(row[:2]))
    # a prompt sharing only the first block matches one block
    assert _cache_op(jc, pc, "match", toks[:8] + [99, 98, 97]) == (
        8, [int(row[0])])
    # the match is capped at len - 1: 16 tokens use one block
    assert _cache_op(jc, pc, "match", toks[:16])[0] == 8


def test_trie_insert_dedups_and_lru_reclaim_like_jax(engines):
    jp, pp, jc, pc = _both_caches(engines)
    row0 = _fill_slot(jp, pp, 0, 9)
    row1 = _fill_slot(jp, pp, 1, 9)
    a = [1] * 8 + [2]
    b = [3] * 8 + [4]
    _cache_op(jc, pc, "insert", a, row0)
    _cache_op(jc, pc, "insert", b, row1)
    assert _cache_op(jc, pc, "insert", a, row0) == 0  # dedup
    b_page = int(row1[0])
    for pool in (jp, pp):
        pool.release(0)
        pool.release(1)
    _cache_op(jc, pc, "match", b)  # bump b's LRU stamp
    assert _cache_op(jc, pc, "reclaim", 1) == 1
    # the victim was a, not b, on both
    assert _cache_op(jc, pc, "match", b)[0] == 8
    assert _cache_op(jc, pc, "match", a)[0] == 0
    assert pc.held_pages() == [b_page]


def test_trie_drop_shared_block_refused_like_jax(engines):
    """Force-dropping a node whose pages a live slot reads is refused on
    both (assert), and pressure reclaim skips it until the reader goes."""
    jp, pp, jc, pc = _both_caches(engines)
    row0 = _fill_slot(jp, pp, 0, 9)
    a = [1] * 8 + [2]
    _cache_op(jc, pc, "insert", a, row0)
    for pool in (jp, pp):
        pool.release(0)
    n, pages = _cache_op(jc, pc, "match", a + [5])
    for pool in (jp, pp):
        pool.share(2, pages, 10)
    _same_cache(jc, pc)
    for cache in (jc, pc):
        (node,) = list(cache._iter_leaves())
        with pytest.raises(AssertionError, match="refusing to evict"):
            cache._drop(node)
    assert _cache_op(jc, pc, "reclaim", 8) == 0  # nothing unshared
    for pool in (jp, pp):
        pool.release(2)
    assert _cache_op(jc, pc, "reclaim", 8) == 1  # reader gone: droppable


def test_trie_max_blocks_bounds_and_reclaims_like_jax(engines):
    jp, pp, jc, pc = _both_caches(engines, total_pages=12)
    jc.max_blocks = pc.max_blocks = 2
    for slot, first in enumerate((1, 2, 3)):
        row = _fill_slot(jp, pp, slot, 9)
        _cache_op(jc, pc, "insert", [first] * 8 + [0], row)
        for pool in (jp, pp):
            pool.release(slot)
    assert pc.n_blocks() == 2  # the LRU block was reclaimed to fit
    assert _cache_op(jc, pc, "match", [1] * 8 + [0])[0] == 0
    _cache_op(jc, pc, "clear")
    assert pc.n_blocks() == 0 and pp.free_pages() == 12


# ---------- the Scheduler: hot streams bitwise cold, against JAX ----------


def _sampling(sampled, seed0):
    return (dict(temperature=0.9, seed=[seed0 + i for i in range(3)])
            if sampled else {})


def _submit(sch, prompts, gen, **kw):
    return [sch.submit(p, gen, **{k: (v[i] if isinstance(v, list) else v)
                                  for k, v in kw.items()})
            for i, p in enumerate(prompts)]


def _two_batches(sch, prompts, gen=GEN, **kw):
    """The prompts once (cold: they fill the cache), then again (hot)."""
    first = _submit(sch, prompts, gen, **kw)
    sch.run()
    hot = _submit(sch, prompts, gen, **kw)
    sch.run()
    return first, hot


def _summary(sch, first, hot):
    m = sch.metrics()
    return dict(
        cold=[r.out_tokens for r in first], hot=[r.out_tokens for r in hot],
        prefix_len=[r.prefix_len for r in first + hot],
        hits=m["prefix_hits"], misses=m["prefix_misses"],
        pages_shared=m["prefix_pages_shared"], blocks=m["prefix_blocks"],
        device_steps=sch.worker.n_steps)


@pytest.fixture(scope="module")
def jax_runs(engines, prompts):
    """The JAX Scheduler with the prefix cache, host loop and resident
    loop (windows of 4), greedy and sampled (T 0.9, seeds 50-52)."""
    jeng = engines[0]
    out = {}
    for mode, kw in (("host", {}), ("resident", dict(resident=True,
                                                     window=4))):
        for sampled in (False, True):
            sch = JaxScheduler(jeng, prefix_cache=True, prefix_block=BLOCK,
                               **GEO, **kw)
            out[(mode, sampled)] = _summary(
                sch, *_two_batches(sch, prompts, **_sampling(sampled, 50)))
    return out


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_prefix_hot_cold_equal_jax(engines, prompts, jax_runs, resident,
                                   sampled):
    """The port's Scheduler with the cache, host loop and resident
    (windows of 4), greedy and sampled: each hot stream equal to its
    cold stream and to the JAX Scheduler's, every hot request a hit of
    at least one block, and prefix_len, hits, misses, pages shared,
    blocks and the device steps run (a resident hit's prefill starts
    past its prefix on the device too) the JAX Scheduler's in the same
    mode. Pool and trie invariants after the run."""
    eng = engines[1]
    kw = dict(resident=True, window=4) if resident else {}
    sch = Scheduler(eng, prefix_cache=True, prefix_block=BLOCK, **GEO, **kw)
    got = _summary(sch, *_two_batches(sch, prompts,
                                      **_sampling(sampled, 50)))
    assert got["hot"] == got["cold"]
    assert all(n >= BLOCK for n in got["prefix_len"][3:])
    assert got == jax_runs[("resident" if resident else "host", sampled)]
    sch.pool.check()
    sch.prefix.check()
    assert sch.pool.used_pages() == 0


def test_prefix_hot_equals_port_cold_without_cache(engines, prompts):
    """A hit's tokens are its cold run's with the cache off, host loop
    and resident (windows of 1 and 3), greedy and sampled."""
    eng = engines[1]
    for sampled in (False, True):
        kw = _sampling(sampled, 70)
        cold = Scheduler(eng, **GEO)
        reqs = _submit(cold, prompts, GEN, **kw)
        cold.run()
        want = [r.out_tokens for r in reqs]
        assert cold.metrics()["prefix_hits"] == 0
        assert cold.metrics()["prefix_blocks"] == 0
        for extra in ({}, dict(resident=True, window=1),
                      dict(resident=True, window=3)):
            sch = Scheduler(eng, prefix_cache=True, prefix_block=BLOCK,
                            **GEO, **extra)
            first, hot = _two_batches(sch, prompts, **kw)
            assert [r.out_tokens for r in hot] == want, (sampled, extra)
            assert [r.out_tokens for r in first] == want
            assert sch.metrics()["prefix_hits"] == len(prompts)


def test_prefix_hit_survives_donor_eviction(engines, prompts):
    """The cache's holds outlive the donor (tests/test_prefix.py:299):
    with a 5-page pool the donor's growth evicts the younger request;
    the same prompt admitted afterwards hits and streams its cold run's
    tokens (the port's and the JAX Scheduler's)."""
    jeng, eng = engines
    cold = Scheduler(eng, **GEO)
    want = _submit(cold, prompts[:1], GEN)[0]
    cold.run()
    jcold = JaxScheduler(jeng, **GEO)
    jwant = jcold.submit(prompts[0], GEN)
    jcold.run()
    assert want.out_tokens == jwant.out_tokens
    sch = Scheduler(eng, total_pages=5, prefix_cache=True,
                    prefix_block=BLOCK, **GEO)
    donor = sch.submit(prompts[0], max_new_tokens=14)
    second = sch.submit(prompts[1], max_new_tokens=10)
    sch.run()
    assert donor.n_evictions + second.n_evictions > 0, (
        "the pool was not tight enough to evict")
    hot = sch.submit(prompts[0], max_new_tokens=GEN)
    sch.run()
    assert hot.prefix_len >= BLOCK
    assert hot.out_tokens == want.out_tokens
    sch.pool.check()
    sch.prefix.check()


def test_prefix_eviction_resets_prefix_len(engines, prompts):
    """An evicted hit requeues with prefix_len 0 (JAX scheduler.py:1570)
    and matches the trie again at its re-admission."""
    sch = Scheduler(engines[1], total_pages=5, prefix_cache=True,
                    prefix_block=BLOCK, **GEO)
    sch.submit(prompts[0], 1)
    sch.run()
    hit = sch.submit(prompts[0], 2)
    sch._admit()
    assert hit.prefix_len == BLOCK
    sch._evict(hit, site="growth")
    assert hit.prefix_len == 0 and hit.pos == 0
    sch.run()
    assert hit.state is RequestState.FINISHED and hit.prefix_len == BLOCK
    sch.pool.check()
    sch.prefix.check()


def test_prefix_pressure_reclaims_cache_before_eviction(engines, prompts):
    """Pool pressure drains unshared cached blocks before it evicts a live
    request (tests/test_prefix.py:320), on the port and on JAX alike:
    the same blocks survive, and nothing is evicted."""
    jeng, eng = engines
    out = []
    for make in (Scheduler, JaxScheduler):
        sch = make(jeng if make is JaxScheduler else eng, total_pages=6,
                   prefix_cache=True, prefix_block=BLOCK, **GEO)
        for p in prompts:  # fill the cache; the requests finish
            sch.submit(p, max_new_tokens=2)
        sch.run()
        blocks_before = sch.prefix.n_blocks()
        assert blocks_before >= 2
        big = sch.submit(prompts[0] + prompts[1], max_new_tokens=12)
        sch.run()
        assert big.state.value == "finished"
        assert 0 in [sch.prefix.match(p)[0] for p in prompts[1:]]
        assert sch.metrics()["evicted"] == 0
        sch.pool.check()
        sch.prefix.check()
        out.append((big.out_tokens, sorted(sch.prefix.held_pages()),
                    sch.prefix.n_blocks(), [sch.prefix.match(p)[0]
                                            for p in prompts]))
    assert out[0] == out[1]


@pytest.mark.parametrize("resident", [False, True])
def test_prefix_hit_prefills_fewer_chunks(engines, prompts, resident):
    """A hit's n_prefill_chunks is its cold run's less the chunks of its
    prefix: ceil((len - prefix_len) / chunk) (the resident drain credits
    that; the host loop counts its steps). This takes the place of
    tests/test_prefix.py:344's ledger check."""
    kw = dict(resident=True, window=4) if resident else {}
    sch = Scheduler(engines[1], prefix_cache=True, prefix_block=BLOCK,
                    **GEO, **kw)
    first, hot = _two_batches(sch, prompts, gen=3)
    C = GEO["chunk"]
    for c, h in zip(first, hot):
        assert c.n_prefill_chunks == -(-len(c.prompt) // C)
        assert h.n_prefill_chunks == -(-(len(h.prompt) - h.prefix_len) // C)
        assert h.n_prefill_chunks < c.n_prefill_chunks


def test_resident_window_foresees_the_hit(engines, prompts):
    """_resident_steps sizes a window by the chunks past the hit: a
    pending hit admission of h tokens past a prefix of m foresees
    ceil((h - m) / C) + max_new - 1 steps, not the whole prompt's."""
    sch = Scheduler(engines[1], resident=True, window=16, prefix_cache=True,
                    prefix_block=BLOCK, **GEO)
    sch.submit(prompts[0], 2)
    sch.run()
    hot = sch.submit(prompts[0], 2)
    sch._admit_resident()
    assert hot.prefix_len == BLOCK
    C = GEO["chunk"]
    need = -(-(len(prompts[0]) - BLOCK) // C) + 2 - 1  # 2 steps
    assert sch._resident_steps() == 2 == need
    sch.run()
    assert hot.state is RequestState.FINISHED


# ---------- refusals ----------


def test_prefix_refusals(engines):
    eng = engines[1]
    with pytest.raises(NotImplementedError, match="item 7"):
        Scheduler(eng, prefix_cache=True, **GEO)
    pool = KVPool(eng, GEO["slots"], GEO["page"])
    with pytest.raises(ValueError, match="own pool"):
        Scheduler(eng, prefix_cache=PrefixCache(pool, block=BLOCK), **GEO)
    with pytest.raises(AssertionError, match="multiple of the pool page"):
        PrefixCache(pool, block=12)
    ring = pring.InjectionRing(4, 8, 64, 4)
    for prefix in (5, 6, -1):
        with pytest.raises(ValueError, match="prefix"):
            ring.admit(0, [1, 2, 3, 4, 5], 2, 0.0, 0, None, req_id=1,
                       table_row=np.arange(8), prefix=prefix)
    assert ring.published == 0
    ring.admit(0, [1, 2, 3, 4, 5], 2, 0.0, 0, None, req_id=1,
               table_row=np.arange(8), prefix=4)
    assert ring.buf[0, pring.IR_PREFIX] == 4


def test_injection_ring_prefix_record_bitwise_jax():
    """An admission record with a prefix: the port's ring buffer bitwise
    the JAX ring's."""
    from triton_dist_tpu.mega import ring as jring

    jr = jring.InjectionRing(cap=4, max_pages=4, prompt_cap=16, chunk=4)
    pr = pring.InjectionRing(cap=4, max_pages=4, prompt_cap=16, chunk=4)
    for r in (jr, pr):
        r.admit(1, list(range(3, 15)), 5, 0.7, 9, 2, req_id=7,
                table_row=np.arange(1, 5), prefix=8)
        r.admit(2, list(range(9)), 3, 0.0, 1, None, req_id=8,
                table_row=np.arange(5, 9), at_step=2, prefix=0)
    np.testing.assert_array_equal(pr.buf, jr.buf)
    assert (pr.published, pr.version) == (jr.published, jr.version)

"""The port's serving plane (triton_dist_tpu_torch.serve) against its own
sequential Engine.serve and against the JAX package's Scheduler.

Tiny f32 config on the CPU with the JAX weights carried across, at world
1 and at world 4 (the JAX Engine on a 4-device mesh in the `ar` mode,
the port's on the virtual world, each pool holding every rank's kv
heads). Greedy
tokens are compared for equality: both packages keep the same cast
points, and the tiny model's logits are far enough apart that f32
rounding in another order does not move an argmax."""

import jax
import numpy as np
import pytest

from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxModelConfig
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu.serve import Scheduler as JaxScheduler
from triton_dist_tpu_torch.models import Engine, ModelConfig, params_from_jax
from triton_dist_tpu_torch.serve import (
    KVPool,
    PoolExhausted,
    RequestState,
    Scheduler,
    pages_for,
    sampling_key,
)

CFG = dict(num_q_heads=4, num_kv_heads=2, max_positions=64)
GEO = dict(slots=3, chunk=4, page=8)
GEN = 5


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
def prompts():
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(0, 256, n))) for n in (12, 5, 9, 7)]


def _staggered(sch, prompts, **kw):
    """Two requests up front, the rest arriving one step apart."""
    reqs = [sch.submit(p, GEN, **kw) for p in prompts[:2]]
    for p in prompts[2:]:
        sch.step()
        reqs.append(sch.submit(p, GEN, **kw))
    sch.run()
    return reqs


def _sequential(eng, prompts):
    return [eng.serve(np.asarray([p]), GEN, **GEO)[0].tolist()
            for p in prompts]


def test_scheduler_matches_sequential_and_jax(engines, prompts):
    """Staggered requests of different lengths: the port's in-flight
    batching gives each request the tokens of a sequential run at the
    same geometry, and the JAX Scheduler's tokens."""
    jeng, eng = engines
    sch = Scheduler(eng, **GEO)
    got = [r.out_tokens for r in _staggered(sch, prompts)]
    assert got == _sequential(eng, prompts)
    jsch = JaxScheduler(jeng, **GEO)
    want = [r.out_tokens for r in _staggered(jsch, prompts)]
    assert got == want
    m = sch.metrics()
    assert m["n"] == len(prompts) and m["tokens_out"] == GEN * len(prompts)
    assert m["pool_used_pages"] == 0
    sch.pool.check()


@pytest.fixture(scope="module")
def engines4():
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(max_positions=32), mesh,
                     prefill_mode="ar", decode_mode="ar", max_len=32,
                     donate_cache=False)
    eng = Engine(ModelConfig.tiny(max_positions=32), device="cpu",
                 max_len=32, world=4, prefill_mode="ar",
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jeng.params),
                                        device="cpu"))
    return jeng, eng


def test_world4_scheduler_matches_sequential_and_jax(engines4):
    """As tests/test_serve.py's distributed serve: two requests through
    the Scheduler at world 4 give the port's sequential serve tokens and
    the JAX Scheduler's on its 4-device engine."""
    jeng, eng = engines4
    rng = np.random.default_rng(2)
    ps = [list(map(int, rng.integers(0, 256, n))) for n in (6, 9)]
    geo = dict(slots=2, chunk=4, page=8)
    sch = Scheduler(eng, **geo)
    reqs = [sch.submit(p, max_new_tokens=4) for p in ps]
    sch.run()
    got = [r.out_tokens for r in reqs]
    assert got == [eng.serve(np.asarray([p]), 4, **geo)[0].tolist()
                   for p in ps]
    assert sch.pool.k.shape[1] == 8  # every rank's 2 kv heads
    jsch = JaxScheduler(jeng, **geo)
    jreqs = [jsch.submit(p, max_new_tokens=4) for p in ps]
    jsch.run()
    assert got == [r.out_tokens for r in jreqs]
    sch.pool.check()


def test_eviction_keeps_tokens(engines, prompts):
    """A pool too small for all requests at once: requests are evicted,
    requeue, re-prefill their history and still emit the sequential
    tokens."""
    _, eng = engines
    sch = Scheduler(eng, **GEO, total_pages=4)
    reqs = [sch.submit(p, 12) for p in prompts]
    sch.run()
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert sch.metrics()["evicted"] > 0
    assert sum(r.n_evictions for r in reqs) > 0
    want = [eng.serve(np.asarray([p]), 12, **GEO)[0].tolist()
            for p in prompts]
    assert [r.out_tokens for r in reqs] == want
    sch.pool.check()


def test_sampled_tokens_invariant_to_slot_placement(engines, prompts):
    """Temperature > 0: each token is drawn under the key of (request
    seed, token index), fold_in(PRNGKey(seed), index), so a request
    samples the same tokens alone in slot 0 and behind other requests in
    another slot."""
    _, eng = engines
    target = prompts[2]
    alone = Scheduler(eng, **GEO)
    r0 = alone.submit(target, GEN, temperature=0.9, seed=11)
    alone.run()
    crowded = Scheduler(eng, **GEO)
    for p in prompts[:2]:
        crowded.submit(p, GEN, temperature=0.7, seed=3)
    crowded.step()
    r1 = crowded.submit(target, GEN, temperature=0.9, seed=11)
    crowded.run()
    assert r1.slot == -1 and r0.out_tokens == r1.out_tokens
    assert sampling_key(11, 0).tolist() != sampling_key(11, 1).tolist()


def test_pool_allocator(engines):
    _, eng = engines
    assert [pages_for(n, 8) for n in (1, 8, 9, 16, 17)] == [1, 1, 2, 2, 3]
    pool = KVPool(eng, slots=3, page=8, total_pages=5)
    pool.admit(0, 17)
    pool.admit(1, 5)
    assert pool.used_pages() == 4 and pool.free_pages() == 1
    assert pool.table[0, :3].tolist() == [1, 2, 3]
    assert pool.ensure(1, 9) and not pool.ensure(1, 17)
    with pytest.raises(PoolExhausted):
        pool.admit(2, 1)
    pool.check()
    pool.release(0)
    assert pool.free_pages() == 3 and pool.table[0].tolist() == [0] * 8
    pool.check()


def test_world4_dist_scheduler_matches_sequential_and_jax():
    """decode_mode="dist": every serve step is a sequence-sharded forward
    of slots*chunk = 8 rows, 2 a rank (ag_gemm on QKV and gate|up,
    gemm_rs on O and down). Two requests through the port's Scheduler
    give its sequential serve tokens and the JAX Scheduler's on its
    4-device engine in the same mode (its kernels in interpret mode)."""
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny(max_positions=32), mesh,
                     decode_mode="dist", max_len=32, donate_cache=False)
    eng = Engine(ModelConfig.tiny(max_positions=32), device="cpu",
                 max_len=32, world=4, decode_mode="dist",
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jeng.params),
                                        device="cpu"))
    rng = np.random.default_rng(3)
    ps = [list(map(int, rng.integers(0, 256, n))) for n in (6, 3)]
    geo = dict(slots=2, chunk=4, page=8)
    sch = Scheduler(eng, **geo)
    reqs = [sch.submit(p, max_new_tokens=2) for p in ps]
    sch.run()
    got = [r.out_tokens for r in reqs]
    assert got == [eng.serve(np.asarray([p]), 2, **geo)[0].tolist()
                   for p in ps]
    jsch = JaxScheduler(jeng, **geo)
    jreqs = [jsch.submit(p, max_new_tokens=2) for p in ps]
    jsch.run()
    assert got == [r.out_tokens for r in jreqs]
    sch.pool.check()


def test_world4_moe_dist_scheduler_matches_sequential_and_jax():
    """Qwen3MoE (tiny_moe) at world 4 with decode_mode="dist": every
    serve step is a sequence-sharded forward of slots*chunk = 8 rows, the
    MoE block between the ring AG and the ring RS. Two requests through
    the port's Scheduler give its sequential serve tokens and the JAX
    Scheduler's on its 4-device engine in the same mode."""
    mesh = make_mesh(mesh_shape=(4,), axis_names=("tp",))
    jeng = JaxEngine(JaxModelConfig.tiny_moe(max_positions=32), mesh,
                     decode_mode="dist", max_len=32, donate_cache=False)
    eng = Engine(ModelConfig.tiny_moe(max_positions=32), device="cpu",
                 max_len=32, world=4, decode_mode="dist",
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jeng.params),
                                        device="cpu"))
    rng = np.random.default_rng(4)
    ps = [list(map(int, rng.integers(0, 256, n))) for n in (6, 3)]
    geo = dict(slots=2, chunk=4, page=8)
    sch = Scheduler(eng, **geo)
    reqs = [sch.submit(p, max_new_tokens=3) for p in ps]
    sch.run()
    got = [r.out_tokens for r in reqs]
    assert got == [eng.serve(np.asarray([p]), 3, **geo)[0].tolist()
                   for p in ps]
    jsch = JaxScheduler(jeng, **geo)
    jreqs = [jsch.submit(p, max_new_tokens=3) for p in ps]
    jsch.run()
    assert got == [r.out_tokens for r in jreqs]
    sch.pool.check()

"""The port's quantized wire (triton_dist_tpu_torch.wire and the
`wire_format=` / `payload_dtype=` forms of its collectives) against the
JAX package's (triton_dist_tpu.wire, tests/test_wire.py).

Inputs come from a numpy seed at tiny widths. The JAX collectives run as
tests/test_wire.py runs them: under `jax.shard_map` on n in {2, 4} of
the 12 virtual CPU devices, interpret-mode Pallas, one jit a test shared
across formats (interpret compile time dominates), and the tests assert
with `pallas_call_count` that the JAX kernel ran. On the CPU the port's
kernel wrappers run their plain versions; its tensors are rank-stacked
(rank r at [r]).

The scale division. The codec defines a row's scale as amax / FMAX, an
IEEE division: the JAX codec run eagerly, the port and its CUDA kernels
all divide. Under jit XLA's algebraic simplifier folds a division by a
constant into a multiplication by its reciprocal, which moves about 70%
of the fp8 row scales by one ulp (test_jit_folds_the_scale_division
records it). So the JAX programs here route FMAX through an optimization
barrier (the `_ieee_scale_division` fixture): the division stays a
division, and the jitted JAX functions compute the codec's definition.
Nothing in the JAX package changes.

Tolerances: the codec image (quantize, dequantize, encode_rows,
decode_rows, pack, unpack, roundtrip, verify_rows), the simulations, the
gather family's results and the EP fp8 payload bitwise; collective_drift
within 1e-12; the ReduceScatter and AllReduce wire bitwise their
simulations and, against the JAX kernels, within JAX's own cosine bound
(1e-6, tests/test_wire.py: the interpret-mode kernel fuses decode,
multiply and add differently, so bitwise does not carry across); the
ag_gemm / gemm_rs wire and the native out_dtype=float32 within 1e-5 (f32
products in another order), a bf16 output within 1e-5 plus one bf16 ulp
(2^-7 relative: the f32 values differ by the order of the sums, and
their one rounding to bf16 may fall either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import triton_dist_tpu.kernels.allgather as jax_ag
import triton_dist_tpu.kernels.allreduce as jax_ar
from triton_dist_tpu import wire as jw
from triton_dist_tpu.wire import codec as jcodec
from triton_dist_tpu.kernels.allgather_gemm import AgGemmConfig
from triton_dist_tpu.kernels.allgather_gemm import ag_gemm as jax_ag_gemm
from triton_dist_tpu.kernels.ep_a2a import _pack_by_dest as jax_pack
from triton_dist_tpu.kernels.gemm_reduce_scatter import GemmRsConfig
from triton_dist_tpu.kernels.gemm_reduce_scatter import gemm_rs as jax_gemm_rs
from triton_dist_tpu.kernels.gemm_reduce_scatter import last_regime
from triton_dist_tpu.kernels.low_latency_allgather import (
    create_ll_ag_buffer as jax_ll_buffer,
)
from triton_dist_tpu.kernels.low_latency_allgather import (
    ll_all_gather as jax_ll_all_gather,
)
from triton_dist_tpu.kernels.reduce_scatter import (
    ring_reduce_scatter as jax_ring_rs,
)
from triton_dist_tpu.lang.core import pallas_call_count
from triton_dist_tpu.runtime import make_mesh
from triton_dist_tpu_torch import kernels
from triton_dist_tpu_torch import wire
from triton_dist_tpu_torch.faults.errors import WireIntegrityError
from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.kernels import low_latency_allgather as llag
from triton_dist_tpu_torch.kernels import reduce_scatter as rsm

GEMM_ATOL = 1e-5   # f32 products in another order
BF16_RTOL = 2.0 ** -7  # a bf16 output: one ulp of its own rounding more
KERNEL_COS = 1e-6  # JAX's bound of its wire kernels against the simulation
FORMATS = ("fp8", "int8", wire.WireFormat("int8", 32, True))
JAX_FORMATS = ("fp8", "int8", jw.WireFormat("int8", 32, True))


_JAX_FMAX = jcodec._fmax


@pytest.fixture(autouse=True)
def _ieee_scale_division(monkeypatch):
    """The JAX codec's FMAX behind an optimization barrier, so that jit
    keeps amax / FMAX a division (module docstring)."""
    monkeypatch.setattr(jcodec, "_fmax", lambda f: jax.lax.optimization_barrier(
        jnp.float32(_JAX_FMAX(f))))


def test_jit_folds_the_scale_division(monkeypatch):
    """Why the fixture exists: under jit, without the barrier, XLA
    multiplies by 1 / 448 and some fp8 scales leave the codec's (the
    eager JAX codec's and the port's) by one ulp; with it they agree."""
    x = jnp.asarray(np.random.default_rng(74).standard_normal(
        (64, 128)).astype(np.float32), jnp.bfloat16)
    want = wire.quantize(torch.from_numpy(np.asarray(x, np.float32)),
                         "fp8")[1].numpy()
    barrier = np.asarray(jax.jit(lambda a: jw.quantize(a, "fp8")[1])(x))
    np.testing.assert_array_equal(barrier, want)
    monkeypatch.setattr(jcodec, "_fmax", _JAX_FMAX)
    folded = np.asarray(jax.jit(lambda a: jw.quantize(a, "fp8")[1])(x))
    np.testing.assert_array_equal(np.asarray(jw.quantize(x, "fp8")[1]), want)
    diff = folded != want
    assert diff.any()
    np.testing.assert_array_less(np.abs(folded[diff].view(np.int32)
                                        - want[diff].view(np.int32)), 2)


def _mesh(n):
    return make_mesh(mesh_shape=(n,), axis_names=("tp",))


def _jax(fn, n, *args, in_specs=P("tp"), out_specs=P("tp"), kernel=True):
    """fn per device under shard_map on an n-device mesh, numpy results;
    with kernel, asserts that a Pallas kernel ran (interpret mode)."""
    before = pallas_call_count()
    out = jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))(*args)
    if kernel:
        assert pallas_call_count() > before, "the JAX kernel did not run"
    return jax.tree.map(np.asarray, out)


def _pair(x, dtype):
    """The same values as a torch tensor and a jnp array (bf16 values
    cross exactly)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _bits(a):
    """An array's raw bytes, for bitwise comparison (bf16 / fp8 views)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 else (
            a.view(torch.int16 if a.element_size() == 2 else torch.int32)
            .numpy())
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _codec_rows(seed):
    """(16, 256) rows with the edge cases: an all-zero row (the scale
    floor), a row whose amax is one element, exact int8 half-way ties
    (x / s = k + 0.5), and large and small magnitudes."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, 256)) * 3).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, 77] = -2.5
    x[2] = np.arange(256, dtype=np.float32) * 0.5 - 63.5  # ties at int8
    x[2, 0] = 127.0                                       # s = 1
    x[3] = 0.5
    x[3, 5] = 127.0
    x[4] *= 1e-30
    x[5] *= 1e20
    return x


def _formats(kind):
    return [(wire.WireFormat(kind, b, c), jw.WireFormat(kind, b, c))
            for b in (None, 32, 128) for c in (False, True)]


# -- codec ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_codec_bitwise_jax(dtype, kind):
    """Every codec function, every block (None, 32, 128) with and without
    the checksum, bitwise the JAX codec: payload, scales, image, decode,
    pack / unpack of a 3-D array, roundtrip and the checksum verdict."""
    t, j = _pair(_codec_rows(1), dtype)
    for tf, jf in _formats(kind):
        q, s = wire.quantize(t, tf)
        jq, js = jw.quantize(j, jf)
        assert q.dtype == wire.payload_dtype(tf)
        _assert_bits(q, np.asarray(jq))
        _assert_bits(s, np.asarray(js))
        _assert_bits(wire.dequantize(q, s, tf, torch.float32),
                     np.asarray(jw.dequantize(jq, js, jf, jnp.float32)))
        img = wire.encode_rows(t, tf)
        jimg = np.asarray(jw.encode_rows(j, jf))
        assert img.dtype == torch.int8 and img.shape == (16, wire.wire_cols(
            256, tf))
        _assert_bits(img, jimg)
        for out in (torch.float32, torch.bfloat16):
            jout = getattr(jnp, str(out).split(".")[1])
            _assert_bits(wire.decode_rows(img, 256, tf, out),
                         np.asarray(jw.decode_rows(jnp.asarray(jimg), 256, jf,
                                                   jout)))
        t3, j3 = t.reshape(16, 4, 64), j.reshape(16, 4, 64)
        packed = wire.pack(t3, tf)
        _assert_bits(packed, np.asarray(jw.pack(j3, jf)))
        _assert_bits(wire.unpack(packed, (4, 64), tf, t.dtype),
                     np.asarray(jw.unpack(jw.pack(j3, jf), (4, 64), jf,
                                          j.dtype)))
        _assert_bits(wire.roundtrip(t3, tf), np.asarray(jw.roundtrip(j3, jf)))
        if tf.checksum:
            ok = wire.verify_rows(img, 256, tf)
            assert ok.all() and ok.shape == (16,)
            np.testing.assert_array_equal(
                ok.numpy(), np.asarray(jw.verify_rows(jnp.asarray(jimg), 256,
                                                      jf)))


def test_codec_ties_round_half_to_even():
    """int8: x / s = k + 0.5 rounds to the even neighbour, as jnp.round;
    an all-zero row keeps the SCALE_EPS scale and a zero payload."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 0.0, 126.5]])
    q, s = wire.quantize(x, "int8")
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 0, 126]]
    q, s = wire.quantize(torch.zeros(2, 128), "fp8")
    assert (s == np.float32(wire.SCALE_EPS)).all()
    assert (q.view(torch.uint8) == 0).all()


def test_wire_image_arithmetic():
    assert wire.wire_cols(128, "fp8") == 256  # 128 payload + 4 scale pad
    assert wire.wire_cols(124, "fp8") == 128
    assert wire.wire_cols(124, wire.WireFormat("fp8", checksum=True)) == 256
    assert wire.wire_cols(512, wire.WireFormat("int8", 128)) == 640
    assert wire.n_blocks(512, wire.WireFormat("int8", 128)) == 4
    assert wire.n_blocks(100, "fp8") == 1
    assert wire.wire_row_bytes(512, None, torch.bfloat16) == 1024
    assert wire.wire_row_bytes(512, "fp8", torch.bfloat16) == 640
    for h, fmt in ((128, "fp8"), (4096, "int8"), (4096, wire.WireFormat(
            "int8", 128, True)), (1000, wire.WireFormat("fp8", 8, True))):
        jf = fmt if isinstance(fmt, str) else jw.WireFormat(
            fmt.kind, fmt.block, fmt.checksum)
        assert wire.wire_cols(h, fmt) == jw.wire_cols(h, jf)
        assert wire.n_blocks(h, fmt) == jw.n_blocks(h, jf)
    assert wire.payload_dtype("fp8") == torch.float8_e4m3fn
    assert wire.payload_dtype(wire.INT8) == torch.int8
    assert wire.resolve(None) is wire.NATIVE and wire.resolve("int8") == \
        wire.INT8
    assert wire.is_native("native") and not wire.is_native(wire.FP8)
    assert (wire.FP8_MAX, wire.INT8_MAX, wire.SCALE_EPS, wire.SCALE_BYTES,
            wire.CHECKSUM_BYTES, wire.LANE) == (
        jw.FP8_MAX, jw.INT8_MAX, jw.SCALE_EPS, jw.SCALE_BYTES,
        jw.CHECKSUM_BYTES, jw.LANE)


@pytest.mark.parametrize("call,err,match", [
    (lambda: wire.WireFormat("fp4"), ValueError, "unknown wire format"),
    (lambda: wire.WireFormat("int8", 0), ValueError, "positive"),
    (lambda: wire.WireFormat("native", checksum=True), ValueError,
     "native format"),
    (lambda: wire.resolve(8), TypeError, "wire_format"),
    (lambda: wire.n_blocks(100, wire.WireFormat("fp8", 32)), ValueError,
     "does not divide"),
    (lambda: wire.wire_cols(128, "native"), ValueError, "no packed image"),
    (lambda: wire.payload_dtype(None), ValueError, "no quantized"),
    (lambda: wire.quantize(torch.ones(2, 8), None), ValueError,
     "not quantized"),
    (lambda: wire.pack(torch.ones(8), "fp8"), ValueError, ">=2D"),
    (lambda: wire.verify_rows(torch.zeros(2, 256, dtype=torch.int8), 128,
                              "fp8"), ValueError, "carries no checksum"),
    (lambda: wire.unpack_checked(torch.ones(2, 8), (8,), None, torch.float32),
     ValueError, "no checksum to check"),
], ids=["kind", "block", "native-checksum", "type", "block-divides",
        "native-cols", "native-dtype", "native-quantize", "pack-1d",
        "verify-no-checksum", "checked-native"])
def test_codec_errors(call, err, match):
    with pytest.raises(err, match=match):
        call()


def test_native_is_passthrough():
    x = torch.ones(4, 128, dtype=torch.bfloat16)
    assert wire.pack(x, None) is x
    assert wire.unpack(x, (128,), "native", x.dtype) is x
    assert wire.roundtrip(x, None) is x


@pytest.mark.parametrize("where", ["payload", "scale"])
def test_unpack_raises_on_a_flipped_bit(where):
    """A checksum format's consume edge names the corrupted row: one
    flipped payload bit, or one flipped scale bit."""
    fmt = wire.WireFormat("fp8", checksum=True)
    x = torch.from_numpy(_codec_rows(2)[6:14])
    img = wire.pack(x, fmt)
    col = 17 if where == "payload" else 256 + 2
    bad = img.clone()
    bad[3, col] ^= 4
    assert wire.verify_rows(bad, 256, fmt).tolist() == [
        r != 3 for r in range(8)]
    for fn in (wire.unpack, wire.unpack_checked):
        with pytest.raises(WireIntegrityError, match="1 row") as e:
            fn(bad, (256,), fmt, torch.float32)
        assert e.value.rows == [3]
    assert torch.equal(wire.unpack_checked(img, (256,), fmt, torch.float32),
                       wire.roundtrip(x, fmt))


# -- numerics ------------------------------------------------------------------


def test_drift_measures_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 64)).astype(np.float32)
    b = a + rng.standard_normal((8, 64)).astype(np.float32) * 1e-3
    b[0, 0] = -a[0, 0]
    for x, y in ((a, b), (a, a), (np.zeros(4), np.zeros(4)),
                 (np.zeros(4), np.ones(4))):
        assert wire.cosine_drift(torch.from_numpy(x), y) == \
            jw.cosine_drift(x, y)
        assert wire.max_ulp_f32(x, torch.from_numpy(y)) == \
            jw.max_ulp_f32(x, y)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simulations_bitwise_jax(n, dtype):
    t, j = _pair(np.random.default_rng(n).standard_normal(
        (n, n * 4, 128)).astype(np.float32), dtype)
    for tf, jf in zip(FORMATS + ("native",), JAX_FORMATS + ("native",)):
        _assert_bits(wire.simulate_ring_rs(t, tf, n),
                     np.asarray(jw.simulate_ring_rs(j, jf, n)))
        _assert_bits(wire.simulate_allreduce(t, tf, n),
                     np.asarray(jw.simulate_allreduce(j, jf, n)))


def test_collective_drift_matches_jax():
    """Every collective and format within 1e-12 of the JAX harness; the
    native wire drifts by exactly 0 ulp; every pair inside the default
    budget at n = 8 and the drift monotone in the block size."""
    for coll in wire.COLLECTIVES:
        for fmt in ("fp8", "int8", None):
            got = wire.collective_drift(coll, fmt, n=4, shape=(16, 128))
            want = jw.collective_drift(coll, fmt, n=4, shape=(16, 128))
            assert abs(got["cos"] - want["cos"]) <= 1e-12, (coll, fmt)
            if fmt is None:
                assert got["ulp"] == 0, coll
            else:
                d8 = wire.collective_drift(coll, fmt, n=8, shape=(16, 128))
                assert 0 <= d8["cos"] <= wire.DEFAULT_ERROR_BUDGET
    assert wire.DEFAULT_ERROR_BUDGET == jw.DEFAULT_ERROR_BUDGET
    assert wire.COLLECTIVES == jw.numerics.COLLECTIVES
    for kind in ("fp8", "int8"):
        drifts = wire.drift_monotone_in_block(kind, h=512)
        assert drifts == jw.drift_monotone_in_block(kind, h=512)
        assert drifts[0] <= drifts[1] <= drifts[2] and drifts[2] > 0
        assert wire.codec_drift(kind) == jw.codec_drift(kind)
    table = wire.drift_table(n=2, shape=(8, 128))
    assert set(table) == {(c, k) for c in wire.COLLECTIVES
                          for k in ("fp8", "int8")}
    with pytest.raises(ValueError, match="divide"):
        wire.collective_drift("reduce_scatter", "fp8", n=3, shape=(16, 128))
    with pytest.raises(ValueError, match="unknown collective"):
        wire.collective_drift("broadcast", "fp8")


# -- the ring ReduceScatter on the wire (row 11) -------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rs_wire_matches_simulation_and_jax_kernel(n, dtype):
    """ring_reduce_scatter(wire_format=) for fp8, int8 and int8 block 32
    with the checksum: bitwise the JAX simulation (its plain version is
    the kernel's fold), and within JAX's cosine bound of the JAX Pallas
    kernel (interpret mode, one jit for the three formats); the max ulp
    is printed."""
    m, k = 4, 128
    t, j = _pair(np.random.default_rng(60 + n).standard_normal(
        (n, n * m, k)).astype(np.float32), dtype)
    outs = _jax(lambda xs: tuple(jax_ring_rs(xs[0], "tp", wire_format=f)
                                 for f in JAX_FORMATS), n, j,
                out_specs=(P("tp"),) * 3)
    for tf, jf, o in zip(FORMATS, JAX_FORMATS, outs):
        got = kernels.ring_reduce_scatter(t, wire_format=tf)
        assert got.shape == (n, m, k) and got.dtype == t.dtype
        assert torch.equal(got, kernels.ring_reduce_scatter_wire_plain(t, tf))
        _assert_bits(got, np.asarray(jw.simulate_ring_rs(j, jf, n).astype(
            j.dtype)))
        want = np.asarray(o, np.float32).reshape(n, m, k)
        cos = wire.cosine_drift(got, want)
        print(f"rs wire n={n} {dtype} {tf}: cos {cos:.3e} ulp "
              f"{wire.max_ulp_f32(got, want)}")
        assert cos <= KERNEL_COS
        native = kernels.ring_reduce_scatter(t)
        assert wire.cosine_drift(got, native) <= wire.DEFAULT_ERROR_BUDGET


def test_rs_wire_entry_points_and_refusals():
    """reduce_scatter and reduce_scatter_op take the wire ring whatever
    the method; a conflicting accum_dtype raises as in JAX; n = 1 passes
    the input through; a 1-D shard raises; out_dtype rounds the f32 fold
    once."""
    n = 4
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, n * 2, 2, 64)).astype(np.float32))
    want = kernels.ring_reduce_scatter_wire_plain(x, "int8")
    assert want.shape == (n, 2, 2, 64)
    for method in kernels.ReduceScatterMethod:
        assert torch.equal(rsm.reduce_scatter(
            x, method=method, wire_format="int8"), want)
    assert torch.equal(kernels.reduce_scatter_op(x, wire_format="int8"),
                       want.reshape(n * 2, 2, 64))
    assert torch.equal(
        kernels.ring_reduce_scatter_wire(x, "int8", out_dtype=torch.bfloat16),
        want.bfloat16())
    with pytest.raises(ValueError, match="accumulates in f32"):
        kernels.ring_reduce_scatter(x, accum_dtype=torch.bfloat16,
                                    wire_format="fp8")
    with pytest.raises(ValueError, match=">=2D"):
        kernels.ring_reduce_scatter(torch.ones(n, n * 2), wire_format="fp8")
    with pytest.raises(ValueError, match="does not divide"):
        kernels.ring_reduce_scatter(x, wire_format=wire.WireFormat("fp8",
                                                                   100))
    one = x[:1, :2]
    assert kernels.ring_reduce_scatter(one, wire_format="fp8") is one
    assert torch.equal(kernels.ring_reduce_scatter(one, wire_format="fp8",
                                                   force_kernel=True), one)


# -- the gather family on the wire --------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ag_wire_bitwise_jax(n):
    """Ring, full mesh and the XLA arm on fp8, int8 and int8 block 32
    with the checksum, and all_gather_op: every rank's gathered copy is
    bitwise the JAX gather (one jit), which is the roundtrip of the
    shards."""
    m, w = 4, 128
    t, j = _pair(np.random.default_rng(70 + n).standard_normal(
        (n, m, w)).astype(np.float32), "bfloat16")
    methods = ("ring_1d", "full_mesh", "xla")

    def fn(s):
        return tuple(jax_ag.all_gather(s, "tp",
                                       method=jax_ag.AllGatherMethod(meth),
                                       wire_format=f)
                     for f in JAX_FORMATS for meth in methods)

    outs = iter(_jax(fn, n, j.reshape(n * m, w),
                     out_specs=(P(),) * (3 * len(methods))))
    for tf in FORMATS:
        rt = wire.roundtrip(t.reshape(n * m, w), tf)
        for meth in methods:
            want = next(outs)
            got = kernels.all_gather(t, method=kernels.AllGatherMethod(meth),
                                     wire_format=tf)
            assert got.shape == (n, n * m, w)
            for r in range(n):
                _assert_bits(got[r], want)
                assert torch.equal(got[r], rt)
        assert torch.equal(kernels.ring_all_gather(t, wire_format=tf),
                           kernels.full_mesh_all_gather(t, wire_format=tf))
        assert torch.equal(kernels.all_gather_op(t, wire_format=tf), rt)
    assert torch.equal(kernels.all_gather(t[:1], wire_format="fp8")[0],
                       wire.roundtrip(t[0], "fp8"))


@pytest.mark.parametrize("n", [2, 4])
def test_ll_wire_three_calls_bitwise_jax(n):
    """Three LL calls on one wire context (parity slot reuse): each is
    bitwise the JAX gather, and the context's int8 slots are the JAX
    context's; a native context does not fit a wire call."""
    rows, cols = 4, 128
    xs = [np.random.default_rng(80 + n + i).standard_normal(
        (n * rows, cols)).astype(np.float32) for i in range(3)]

    def fn(a, b, c):
        buf = jax_ll_buffer(a.shape, a.dtype, n, wire_format="fp8")
        outs = []
        for i, s in enumerate((a, b, c)):
            o, buf = jax_ll_all_gather(s, buf, i, "tp", wire_format="fp8")
            outs.append(o)
        return tuple(outs) + (buf,)

    res = _jax(fn, n, *[jnp.asarray(x, jnp.bfloat16) for x in xs],
               in_specs=(P("tp"),) * 3, out_specs=(P(None, "tp"),) * 3 + (
                   P("tp"),))
    ctx = llag.create_ll_ag_buffer((rows, cols), torch.bfloat16, n,
                                   wire_format="fp8", device="cpu")
    assert ctx.data.shape == (n, 2, n, rows, 256) and \
        ctx.data.dtype == torch.int8
    for i, x in enumerate(xs):
        t = torch.from_numpy(x).bfloat16().reshape(n, rows, cols)
        got, ctx = llag.ll_all_gather(t, ctx, i, wire_format="fp8")
        assert got.shape == (n, n, rows, cols)
        # JAX out[j, r] is rank r's slot j; the port's got[r, j]
        want = np.asarray(res[i]).reshape(n, n, rows, cols).transpose(
            1, 0, 2, 3)
        _assert_bits(got, want)
        rt = wire.roundtrip(t.reshape(n * rows, cols), "fp8").reshape(
            n, rows, cols)
        assert torch.equal(got, rt[None].expand(n, n, rows, cols))
    np.testing.assert_array_equal(
        ctx.data.numpy(), np.asarray(res[3]).reshape(ctx.data.shape))
    native = llag.create_ll_ag_buffer((rows, cols), torch.bfloat16, n,
                                      device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        llag.ll_all_gather(t, native, 3, wire_format="fp8")
    with pytest.raises(ValueError, match="does not fit"):
        llag.ll_all_gather(t, ctx, 3)
    one = t[:1]
    got, _ = llag.ll_all_gather(one, llag.create_ll_ag_buffer(
        (rows, cols), torch.bfloat16, 1, wire_format="int8", device="cpu"),
        0, wire_format="int8")
    assert torch.equal(got[0, 0], wire.roundtrip(one[0], "int8"))


# -- the two-shot AllReduce on the wire ---------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_shot_ar_wire_bitwise_simulation(n, dtype):
    """two_shot_all_reduce, all_reduce (any method: a quantized wire
    forces TwoShot) and all_reduce_op on fp8, int8 and int8 block 32 with
    the checksum: every rank's copy bitwise the JAX simulate_allreduce;
    within the budget of the native fold."""
    m, k = 2, 128
    t, j = _pair(np.random.default_rng(90 + n).standard_normal(
        (n, n * m, k)).astype(np.float32), dtype)
    for tf, jf in zip(FORMATS, JAX_FORMATS):
        want = np.asarray(jw.simulate_allreduce(j, jf, n))
        got = kernels.two_shot_all_reduce(t, wire_format=tf)
        assert got.shape == t.shape and got.dtype == t.dtype
        for r in range(n):
            _assert_bits(got[r], want)
        for method in kernels.AllReduceMethod:
            assert torch.equal(kernels.all_reduce(t, method=method,
                                                  wire_format=tf), got)
        assert torch.equal(kernels.all_reduce_op(t, wire_format=tf), got[0])
        assert wire.cosine_drift(got, kernels.all_reduce(t)) <= \
            wire.DEFAULT_ERROR_BUDGET


def test_two_shot_ar_wire_against_jax_kernels():
    """At n = 2 the JAX two-shot wire AllReduce (the wire ring RS and the
    wire ring AG, interpret mode, one jit for fp8 and int8) is within
    JAX's cosine bound of the port."""
    n, m, k = 2, 4, 128
    t, j = _pair(np.random.default_rng(95).standard_normal(
        (n, n * m, k)).astype(np.float32), "bfloat16")
    outs = _jax(lambda xs: tuple(jax_ar.two_shot_all_reduce(
        xs[0], "tp", wire_format=f) for f in ("fp8", "int8")), n, j,
        out_specs=(P("tp"),) * 2)
    for fmt, o in zip(("fp8", "int8"), outs):
        got = kernels.two_shot_all_reduce(t, wire_format=fmt)
        want = np.asarray(o, np.float32).reshape(n, n * m, k)
        cos = wire.cosine_drift(got, want)
        print(f"two-shot wire {fmt}: cos {cos:.3e} ulp "
              f"{wire.max_ulp_f32(got, want)}")
        assert cos <= KERNEL_COS


def test_ar_wire_refusals():
    """A quantized wire needs a leading dim divisible by n (the two-shot
    construct, a loud ValueError as in JAX); "auto" and error_budget
    need the perf model (ROADMAP item 7)."""
    x = torch.ones(4, 6, 128)
    with pytest.raises(ValueError, match="divisible"):
        kernels.all_reduce(x, wire_format="fp8")
    for call in (lambda: kernels.all_reduce(x, wire_format="auto"),
                 lambda: kernels.all_reduce_op(x, wire_format="auto"),
                 lambda: kernels.all_reduce(x, error_budget=0.0),
                 lambda: kernels.two_shot_all_reduce(x, wire_format="auto")):
        with pytest.raises(NotImplementedError, match="item 7"):
            call()
    one = torch.from_numpy(_codec_rows(4)[None, :8])
    assert torch.equal(kernels.all_reduce(one, wire_format="int8")[0],
                       wire.roundtrip(one[0], "int8"))


# -- gemm_rs and ag_gemm on the wire, and out_dtype ----------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("budget,regime", [(32 << 20, "resident"),
                                           (16 << 10, "streamed")])
def test_gemm_rs_wire_matches_jax(n, budget, regime):
    """gemm_rs(wire_format=) against the JAX kernel in both ring regimes
    (fp8 with f32 out, int8 with bf16 out; force_kernel, interpret
    mode): within 1e-5; gemm_rs_wire is the wire fold of the f32
    partials (bitwise its plain version)."""
    m, k, nn = 8 * n, 128, 128
    rng = np.random.default_rng(100 + n)
    a = (rng.standard_normal((n * m, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((n * k, nn)) * 0.1).astype(np.float32)
    ta, ja = _pair(a, "bfloat16")
    tb, jb = _pair(b, "bfloat16")
    cfg = GemmRsConfig(tile_m=8, tile_n=128, vmem_budget=budget)
    cases = (("fp8", jnp.float32, torch.float32),
             ("int8", jnp.bfloat16, torch.bfloat16))
    outs = _jax(lambda aa, bb: tuple(jax_gemm_rs(
        aa, bb, "tp", config=cfg, force_kernel=True, wire_format=f,
        out_dtype=jo) for f, jo, _ in cases), n, ja, jb,
        in_specs=(P("tp"), P("tp")), out_specs=(P("tp"),) * 2)
    assert last_regime() == regime
    ta, tb = ta.reshape(n, m, k), tb.reshape(n, k, nn)
    for (fmt, _, to), o in zip(cases, outs):
        got = kernels.gemm_rs(ta, tb, out_dtype=to, wire_format=fmt)
        assert got.shape == (n, m // n, nn) and got.dtype == to
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(o, np.float32).reshape(
                n, m // n, nn), atol=GEMM_ATOL,
            rtol=BF16_RTOL if to == torch.bfloat16 else 0)
        assert torch.equal(got, kernels.gemm_rs_wire_plain(ta, tb, fmt,
                                                           out_dtype=to))
        partial = torch.matmul(ta.float(), tb.float())
        assert torch.equal(got, kernels.ring_reduce_scatter_wire_plain(
            partial, fmt, to))


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_ag_gemm_wire_matches_jax(kind):
    """ag_gemm(wire_format=) at n = 4 in both C orders, with
    return_gathered, against the JAX kernel (force_kernel, interpret
    mode, one jit): C within 1e-5, the gathered A bitwise the JAX
    decoded workspace (the roundtrip of A); n = 1 is the local product
    of the roundtrip."""
    n, m, k, nn = 4, 8, 256, 128
    rng = np.random.default_rng(110)
    ta, ja = _pair((rng.standard_normal((n * m, k)) * 0.1).astype(
        np.float32), "bfloat16")
    tb, jb = _pair((rng.standard_normal((n * k, nn)) * 0.1).astype(
        np.float32), "bfloat16")
    cfg = AgGemmConfig(tile_m=8, tile_n=128, tile_k=128,
                       vmem_budget=64 << 20)

    def fn(aa, bb):
        c, full = jax_ag_gemm(aa, bb, "tp", config=cfg, force_kernel=True,
                              return_gathered=True, wire_format=kind)
        arr = jax_ag_gemm(aa, bb, "tp", config=cfg, force_kernel=True,
                          c_order="arrival", wire_format=kind,
                          out_dtype=jnp.float32)
        return c, full, arr

    c, full, arr = _jax(fn, n, ja, jb, in_specs=(P("tp"), P("tp")),
                        out_specs=(P("tp"),) * 3)
    ta, tb = ta.reshape(n, m, k), tb.reshape(n, k, nn)
    got, gathered = kernels.ag_gemm(ta, tb, return_gathered=True,
                                    wire_format=kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        c, np.float32).reshape(n, n * m, nn), rtol=BF16_RTOL,
        atol=GEMM_ATOL)
    _assert_bits(gathered, np.asarray(full).reshape(n, n * m, k))
    rt = wire.roundtrip(ta.reshape(n * m, k), kind)
    assert torch.equal(gathered, rt.expand(n, n * m, k))
    got_arr = kernels.ag_gemm(ta, tb, c_order="arrival", wire_format=kind,
                              out_dtype=torch.float32)
    assert got_arr.dtype == torch.float32
    np.testing.assert_allclose(got_arr.numpy(), np.asarray(arr).reshape(
        n, n * m, nn), rtol=0, atol=GEMM_ATOL)
    assert torch.equal(got, kernels.ag_gemm_wire(ta, tb, kind))
    one = kernels.ag_gemm(ta[:1], tb[:1], wire_format=kind)
    assert torch.equal(one, torch.matmul(wire.roundtrip(ta[0], kind),
                                         tb[0])[None])


def test_ag_gemm_wire_rejects_unsupported_forms():
    """The JAX refusals: silu_pair, grouped, a blocked format and K not
    a multiple of 128."""
    a, b = torch.ones(2, 8, 128), torch.ones(2, 128, 64)
    with pytest.raises(ValueError, match="dense ag_gemm form"):
        kernels.ag_gemm(a, (b, b), epilogue="silu_pair", wire_format="fp8")
    with pytest.raises(ValueError, match="dense ag_gemm form"):
        kernels.ag_gemm(a, torch.ones(2, 2, 128, 64), wire_format="int8")
    with pytest.raises(ValueError, match="per-row scales"):
        kernels.ag_gemm(a, b, wire_format=wire.WireFormat("int8", 32))
    with pytest.raises(ValueError, match="lane-aligned K"):
        kernels.ag_gemm(torch.ones(2, 8, 64), torch.ones(2, 64, 64),
                        wire_format="fp8")
    with pytest.raises(ValueError, match="quantized wire format"):
        kernels.ag_gemm_wire(a, b, None)


@pytest.mark.parametrize("n", [2, 4])
def test_native_out_dtype_float32_matches_jax(n):
    """The native wire's out_dtype=float32 of bf16 inputs: gemm_rs (the
    f32-accumulation ring) and ag_gemm (the f32 accumulators rounded to
    f32) within 1e-5 of JAX."""
    m, k, nn = 8, 128, 128
    rng = np.random.default_rng(120 + n)
    ta, ja = _pair((rng.standard_normal((n * n * m, k)) * 0.1).astype(
        np.float32), "bfloat16")
    tb, jb = _pair((rng.standard_normal((n * k, nn)) * 0.1).astype(
        np.float32), "bfloat16")
    rs, ag = _jax(lambda aa, bb: (
        jax_gemm_rs(aa, bb, "tp", out_dtype=jnp.float32),
        jax_ag_gemm(aa, bb, "tp", out_dtype=jnp.float32)), n, ja, jb,
        in_specs=(P("tp"), P("tp")), out_specs=(P("tp"), P("tp")),
        kernel=False)
    ta, tb = ta.reshape(n, n * m, k), tb.reshape(n, k, nn)
    got = kernels.gemm_rs(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, m, nn)
    np.testing.assert_allclose(got.numpy(), np.asarray(rs).reshape(
        n, m, nn), rtol=0, atol=GEMM_ATOL)
    got = kernels.ag_gemm(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ag).reshape(
        n, n * n * m, nn), rtol=0, atol=GEMM_ATOL)


# -- the EP dispatch on the fp8 wire -------------------------------------------


def test_ep_fp8_pack_bitwise_jax():
    """The fp8 pack (per-row quantize, the scale and the expert id
    bitcast after the payload, zeros to round_up(H + 8, 128)) is byte
    for byte the JAX pack, rank by rank, plain and expert-sorted."""
    n, m, h, k, epr, cap = 2, 16, 120, 2, 2, 32
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((n, m, h)) * 0.5).astype(np.float32)
    ids = rng.integers(0, n * epr, (n, m, k)).astype(np.int32)
    w = rng.random((n, m, k)).astype(np.float32)
    tx, jx = _pair(x, "bfloat16")
    for sort in (False, True):
        pk = ep_a2a._pack_by_dest(tx, torch.from_numpy(ids),
                                  torch.from_numpy(w), n, epr, cap,
                                  torch.float8_e4m3fn, expert_sorted=sort)
        assert pk.send_x.dtype == torch.uint8
        assert pk.send_x.shape == (n, n, cap, 128)
        for r in range(n):
            jp = jax_pack(jx[r], jnp.asarray(ids[r]), jnp.asarray(w[r]), n,
                          epr, cap, payload_dtype=jnp.float8_e4m3fn,
                          expert_sorted=sort)
            np.testing.assert_array_equal(
                pk.send_x[r].numpy(), np.asarray(jp.send_x).view(np.uint8))
            np.testing.assert_array_equal(pk.src_rows[r].numpy(),
                                          np.asarray(jp.src_rows))
    tokens, expert = ep_a2a._decode_payload(pk.send_x, h, torch.bfloat16)
    assert tokens.dtype == torch.bfloat16 and tokens.shape == (n, n, cap, h)
    q, s = wire.quantize(tx, wire.FP8)
    rows = pk.src_rows.long()
    valid = pk.valid
    want = wire.dequantize(q, s, wire.FP8, torch.bfloat16)
    for r in range(n):
        sel = want[r][rows[r][valid[r]]]
        assert torch.equal(tokens[r][valid[r]], sel)


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential",
                                                        "overlap"])
def test_ep_moe_fwd_fp8_matches_jax(overlap):
    """ep_moe_fwd(payload_dtype=float8_e4m3fn) on a tiny model's layer at
    n = 4 (bf16 tokens), sequential and overlap (n_chunks 2), against
    the JAX layer: within one bf16 ulp of the output's scale (2^-8 x
    max |y|, the f32 products in another order before the last
    rounding); the fp8 wire within the default budget of the bf16 wire."""
    from test_torch_ep import INTER, K, _jax_layer, _stacked
    from triton_dist_tpu_torch.layers.ep_moe import (
        ep_moe_fwd,
        ep_params_from_jax,
    )

    n, e, mm, h = 4, 8, 8, 64
    rng = np.random.default_rng(130)
    x = rng.standard_normal((n * mm, h)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w_router = (rng.standard_normal((h, e)) * 0.3).astype(np.float32)
    gu = (rng.standard_normal((e, h, 2 * INTER)) * 0.2).astype(np.float32)
    dn = (rng.standard_normal((e, INTER, h)) * 0.2).astype(np.float32)
    kw = dict(overlap=overlap, n_chunks=2 if overlap else None)
    want, want_drops = _jax_layer(n, jnp.asarray(x, jnp.bfloat16), w_router,
                                  gu, dn, payload_dtype=jnp.float8_e4m3fn,
                                  **kw)
    params = ep_params_from_jax(w_router, gu, dn, n, device="cpu")
    xt = torch.from_numpy(_stacked(x, n).copy()).bfloat16()
    got, drops = ep_moe_fwd(xt, params, K, return_drops=True,
                            payload_dtype=torch.float8_e4m3fn, **kw)
    want = _stacked(np.asarray(want, np.float32), n)
    atol = 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(drops.numpy(), want_drops)
    full = ep_moe_fwd(xt, params, K, **kw)
    assert wire.cosine_drift(got, full) <= wire.DEFAULT_ERROR_BUDGET
    assert torch.equal(got, ep_moe_fwd(
        xt, params, K, payload_dtype=torch.float8_e4m3fn, _transport="ref",
        **kw))


def test_ep_payload_dtype_not_one_byte_raises():
    x = torch.ones(2, 4, 64)
    ids = torch.zeros(2, 4, 2, dtype=torch.int32)
    w = torch.ones(2, 4, 2)
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="1-byte dtype"):
            ep_a2a.ep_dispatch(x, ids, w, 4, 8, payload_dtype=dt)
    with pytest.raises(ValueError, match="e4m3"):
        ep_a2a.ep_dispatch(x, ids, w, 4, 8, payload_dtype=torch.int8)


def test_wire_entry_points_count_no_launch_on_the_cpu():
    kernels.reset_launches()
    x = torch.ones(2, 4, 128)
    kernels.ring_reduce_scatter(x, wire_format="fp8")
    kernels.all_gather(x, wire_format="int8")
    kernels.gemm_rs(x, torch.ones(2, 128, 64), wire_format="fp8")
    kernels.ag_gemm(x, torch.ones(2, 128, 64), wire_format="fp8")
    assert set(kernels.launches().values()) == {0}
    for name in ("ring_rs_wire", "gemm_rs_wire", "ag_gemm_wire"):
        assert name in kernels.KERNELS and name in kernels.SOURCES


def test_jax_wire_module_names_are_ported():
    """Every public name of triton_dist_tpu.wire has its counterpart."""
    names = {n for n in dir(jw) if not n.startswith("_")}
    assert names - {"annotations"} <= {n for n in dir(wire)}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("m,k,blk", [
    (128, 4096, 4096), (1, 4096, 4096), (128, 4096, 128), (1, 4096, 128),
    (16, 4096, 4096), (37, 4096, 4096), (4, 384, 384), (8, 1024, 1024),
    (32, 4096, 32), (1, 1, 1), (3, 1009, 1009), (2, 48 * 1024, 48 * 1024),
    (5, 8192, 16), (4, 4104, 4104)])
def test_wire_ring_plan_covers_the_rows_within_residency(n, m, k, blk):
    """The wire ring's row plan: every row in exactly one tile; in the
    register form (k and the scale block multiples of 16, 16-byte row
    starts) one row a group of 1, 2, 4 or 8 warps, a thread's share at
    most _WIRE_UNITS units, and the tiles of all n ranks resident
    (_WIRE_PER_SM blocks an SM of 132); else the staged form, as many
    tiles as one block an SM keeps resident. The path shapes (the 4c and
    4w (512 | 4, 4096) and the 30B (128, 2048) rows a rank) take the
    register form."""
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import reduce_scatter as rsr

    warps, rows, tiles = rsr._wire_plan(m, k, blk, n)
    assert (tiles - 1) * rows < m <= tiles * rows
    unit = rsr._WIRE_UNIT
    if warps:
        assert k % unit == 0 and blk % unit == 0 and k * 2 % 16 == 0
        assert warps in (1, 2, 4, 8) and rows == 8 // warps
        assert -(-k // unit) <= rsr._WIRE_UNITS * 32 * warps
        assert tiles * n <= rsr._WIRE_PER_SM * _build.SMS
    else:
        assert k % unit or blk % unit or k > unit * rsr._WIRE_UNITS * 256
        assert tiles * n <= _build.SMS
    if k in (2048, 4096) and blk % unit == 0:
        assert warps


"""Drift harness of the quantized-wire collectives — port of
triton_dist_tpu.wire.numerics.

For each (collective, format) it replays the fold order the kernel runs
(per-hop decode, add, re-encode for the reduction rings; one encode a
shard for the gather family) in plain torch on rank-stacked data, and
reports the drift against the same fold over the native wire:

  cosine_drift  1 - cosine similarity in f64 (what DEFAULT_ERROR_BUDGET
                bounds);
  max_ulp_f32   the worst element's ulp distance as f32 (0 iff the two
                are bit-identical as f32).

The simulations are also the oracles of the quantized kernels:
`simulate_ring_rs` is the fold of `ring_reduce_scatter(wire_format=)`
and of `gemm_rs(wire_format=)` on its f32 partials, `simulate_allreduce`
that of the two-shot AllReduce on the wire.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from triton_dist_tpu_torch.wire import codec

# The JAX default cosine-drift budget: admits fp8 / int8 at the drift of
# every collective at n <= 8 with ~3x headroom (wire/numerics.py there).
DEFAULT_ERROR_BUDGET = 5e-3

COLLECTIVES = (
    "allgather",
    "low_latency_allgather",
    "reduce_scatter",
    "allreduce",
    "allgather_gemm",
    "gemm_reduce_scatter",
)


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float64).ravel()


def cosine_drift(a, b) -> float:
    """1 - cosine similarity of the flattened f64 views (0 = parallel);
    two zero vectors drift 0, one zero vector 1."""
    af, bf = _np64(a), _np64(b)
    na, nb = float(np.linalg.norm(af)), float(np.linalg.norm(bf))
    if na == 0.0 or nb == 0.0:
        return 0.0 if na == nb else 1.0
    return float(1.0 - np.dot(af, bf) / (na * nb))


def max_ulp_f32(a, b) -> int:
    """Worst-element ulp distance between a and b viewed as f32 (0 iff
    bit-identical as f32; sign-aware through the monotone int map)."""
    def ints(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().float().cpu().numpy()
        i = np.asarray(t, np.float32).ravel().view(np.int32).astype(np.int64)
        return np.where(i < 0, np.int64(-(2**31)) - i - 1, i)

    ai, bi = ints(a), ints(b)
    return int(np.max(np.abs(ai - bi))) if ai.size else 0


def _drift(q, f) -> Dict[str, float]:
    return {"cos": cosine_drift(q, f), "ulp": max_ulp_f32(q, f)}


def _normal(rng, shape, dtype, scale=None) -> torch.Tensor:
    x = rng.standard_normal(shape)
    if scale is not None:
        x = x * scale
    return torch.from_numpy(x).to(dtype)


def codec_drift(fmt, shape=(64, 512), dtype=torch.bfloat16,
                seed=0) -> Dict[str, float]:
    """Drift of one encode / decode roundtrip against the tensor."""
    x = _normal(np.random.default_rng(seed), shape, dtype)
    return _drift(codec.roundtrip(x, fmt).float(), x.float())


def _chunk(x: torch.Tensor, c: int, n: int) -> torch.Tensor:
    m = x.shape[0] // n
    return x[c * m:(c + 1) * m].float()


def simulate_ring_rs(stacked: torch.Tensor, fmt, n: int) -> torch.Tensor:
    """The ring ReduceScatter's fold in the kernels' order. Chunk c
    starts at rank c + 1 and is decoded, added and re-encoded at c + 2,
    ..., c; the final arrival (at rank c) is decode + add without a
    re-encode. stacked: (n, n*m, K) per-rank contributions. Returns the
    (n, m, K) f32 result, chunk c at [c]. The native format is the plain
    f32 fold in the same order."""
    f = codec.resolve(fmt)
    out = []
    for c in range(n):
        order = [(c + 1 + j) % n for j in range(n)]
        val = _chunk(stacked[order[0]], c, n)
        for r in order[1:]:
            if f.kind != "native":
                val = codec.decode_rows(codec.encode_rows(val, f),
                                        val.shape[-1], f, torch.float32)
            val = val + _chunk(stacked[r], c, n)
        out.append(val)
    return torch.stack(out)


def simulate_allreduce(stacked: torch.Tensor, fmt, n: int) -> torch.Tensor:
    """Two-shot AllReduce: the RS fold, in the input dtype (as the RS
    leg hands it on), then one roundtrip of each reduced chunk (the AG
    leg encodes once and forwards bytes). (n*m, K) in the input dtype,
    chunk-major."""
    f = codec.resolve(fmt)
    rs = simulate_ring_rs(stacked, f, n).to(stacked.dtype)
    if f.kind == "native":
        return rs.reshape(-1, rs.shape[-1])
    return torch.stack([codec.roundtrip(rs[c], f) for c in range(n)]
                       ).reshape(-1, rs.shape[-1])


def collective_drift(collective: str, fmt, n: int = 8, shape=(64, 512),
                     dtype=torch.bfloat16, seed=0) -> Dict[str, float]:
    """Drift of one (collective, format) against its native-wire fold,
    on rank-stacked data; `shape` is a rank's (rows, K), rows divisible
    by n for the reduction family."""
    rng = np.random.default_rng(seed)
    f = codec.resolve(fmt)
    if collective in ("allgather", "low_latency_allgather"):
        x = _normal(rng, shape, dtype)
        return _drift(codec.roundtrip(x, f).float(), x.float())
    if collective == "allgather_gemm":
        k = shape[1]
        a = _normal(rng, shape, dtype, 0.1)
        b = _normal(rng, (k, 128), dtype, 0.1)
        q = codec.roundtrip(a, f).float() @ b.float()
        r = a.float() @ b.float()
        return _drift(q, r)
    if collective in ("reduce_scatter", "allreduce",
                      "gemm_reduce_scatter"):
        if shape[0] % n:
            raise ValueError(f"rows {shape[0]} must divide by n={n}")
        stacked = _normal(rng, (n,) + tuple(shape), dtype)
        sim = (simulate_allreduce if collective == "allreduce"
               else simulate_ring_rs)
        return _drift(sim(stacked, f, n), sim(stacked, "native", n))
    raise ValueError(f"unknown collective {collective!r} "
                     f"(one of {COLLECTIVES})")


def drift_table(n: int = 8, shape=(64, 512), dtype=torch.bfloat16,
                formats=("fp8", "int8"), seed=0):
    """{(collective, format kind): drift} over every collective."""
    out = {}
    for coll in COLLECTIVES:
        for fmt in formats:
            out[(coll, codec.resolve(fmt).kind)] = collective_drift(
                coll, fmt, n=n, shape=shape, dtype=dtype, seed=seed)
    return out


def drift_monotone_in_block(fmt_kind: str = "fp8", h: int = 512,
                            blocks=(32, 128, None), rows: int = 64,
                            seed: int = 0):
    """Cosine drift a scale-block size, smallest block first (None, the
    whole row, is the coarsest): non-decreasing in the block."""
    return [
        codec_drift(codec.WireFormat(fmt_kind, b), shape=(rows, h),
                    seed=seed)["cos"]
        for b in blocks
    ]

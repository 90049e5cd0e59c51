"""The epsilon-band oracle for the port's tests, numpy only.

A copy of `triton_dist_tpu/verify/epsilon.py` (`_BANDS`,
`_DTYPE_FALLBACK`, `_ULP_FLOOR_REL`, `drift`, `check_epsilon`) and of
the two measures it takes from `triton_dist_tpu/wire/numerics.py`
(`cosine_drift`, `max_ulp_f32`). The JAX module cannot be imported
without JAX (numerics.py imports `jax.numpy`), and the card host that
runs `tests/test_torch_cuda.py` has no JAX; this copy has no import but
numpy. `tests/test_torch_parity.py` pins it to the original on the CPU:
the same table, the same report on the same inputs.

A band judges a result against its reference element by element: the
cosine drift of the flattened f64 views, and the worst ulp distance of
the f32 views after elements below 2^-12 of the reference's largest
magnitude in BOTH tensors are flushed to zero. bf16 allows 8 bf16
quanta (8 << 16 f32 ulps) of an element itself, f32 2^20 f32 ulps. The
port's card tests apply it on top of their own tolerances.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EpsilonBand:
    cos: float  # cosine drift of the flattened f64 views
    ulp: int    # max per-element ulp distance of the f32 views

    def admits(self, drift: dict) -> bool:
        return drift["cos"] <= self.cos and drift["ulp"] <= self.ulp


_BANDS = {
    ("ag_gemm", "bfloat16"): EpsilonBand(cos=5e-4, ulp=8 << 16),
    ("ag_gemm", "float32"): EpsilonBand(cos=1e-6, ulp=1 << 20),
    ("gemm_rs", "bfloat16"): EpsilonBand(cos=5e-4, ulp=8 << 16),
    ("gemm_rs", "float32"): EpsilonBand(cos=1e-6, ulp=1 << 20),
    ("flash_prefill", "bfloat16"): EpsilonBand(cos=5e-4, ulp=8 << 16),
    ("flash_prefill", "float32"): EpsilonBand(cos=1e-6, ulp=1 << 20),
}
_DTYPE_FALLBACK = {
    "bfloat16": EpsilonBand(cos=5e-4, ulp=8 << 16),
    "float32": EpsilonBand(cos=1e-6, ulp=1 << 20),
}
_ULP_FLOOR_REL = 2.0 ** -12


def cosine_drift(a, b) -> float:
    """1 - cosine similarity of the flattened f64 views (0 = parallel).
    Degenerate zero vectors count as no drift only when both are."""
    af = np.asarray(a, np.float64).ravel()
    bf = np.asarray(b, np.float64).ravel()
    na, nb = float(np.linalg.norm(af)), float(np.linalg.norm(bf))
    if na == 0.0 or nb == 0.0:
        return 0.0 if na == nb else 1.0
    return float(1.0 - np.dot(af, bf) / (na * nb))


def max_ulp_f32(a, b) -> int:
    """Worst-element ulp distance between a and b viewed as f32 (0 iff
    bit-identical as f32; sign-aware via the usual monotone int map)."""
    ai = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai - 1, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi - 1, bi)
    return int(np.max(np.abs(ai - bi))) if ai.size else 0


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype; a torch dtype (torch.bfloat16) by its
    name, so callers need not convert."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else \
        np.dtype(dtype).name


def band_for(kernel: str, dtype) -> EpsilonBand:
    name = _dtype_name(dtype)
    band = _BANDS.get((kernel, name)) or _DTYPE_FALLBACK.get(name)
    if band is None:
        raise KeyError(f"no epsilon band for ({kernel!r}, {name!r})")
    return band


def drift(ref, got) -> dict:
    """{"cos", "ulp"} between a reference and a result (numpy arrays or
    anything np.asarray takes; the caller converts bf16 to f32)."""
    a = np.asarray(ref)
    b = np.asarray(got)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    af = a.astype(np.float32)
    bf = b.astype(np.float32)
    floor = float(np.max(np.abs(af))) * _ULP_FLOOR_REL if af.size else 0.0
    noise = (np.abs(af) < floor) & (np.abs(bf) < floor)
    return {
        "cos": float(cosine_drift(a, b)),
        "ulp": int(max_ulp_f32(np.where(noise, np.float32(0), af),
                               np.where(noise, np.float32(0), bf))),
    }


def check_epsilon(ref, got, kernel: str, dtype=None) -> dict:
    """Measure drift and judge it against the family band. Returns
    {"ok", "cos", "ulp", "band_cos", "band_ulp", "kernel", "dtype"}."""
    dtype = np.asarray(ref).dtype if dtype is None else dtype
    band = band_for(kernel, dtype)
    d = drift(ref, got)
    return {
        "ok": band.admits(d),
        "cos": d["cos"],
        "ulp": d["ulp"],
        "band_cos": band.cos,
        "band_ulp": band.ulp,
        "kernel": kernel,
        "dtype": _dtype_name(dtype),
    }

"""tests/torch_parity.py, the numpy-only copy of the epsilon-band oracle
that the port's card tests apply, pinned to the JAX package's original
(`triton_dist_tpu/verify/epsilon.py`, `wire/numerics.py`): the same
band table, floor and fallback, and the same report on seeded inputs
of both polarities (a reassociated sum inside every band, a dropped K
block outside), in f32 and bf16.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch
import torch_parity

from triton_dist_tpu.verify import epsilon
from triton_dist_tpu.wire import numerics

BF16 = ml_dtypes.bfloat16
FAMILIES = ("ag_gemm", "gemm_rs", "flash_prefill", "flash_decode_partial")


def _as_dict(table):
    return {k: dataclasses.asdict(v) for k, v in table.items()}


def test_tables_equal_the_jax_module():
    assert _as_dict(torch_parity._BANDS) == _as_dict(epsilon._BANDS)
    assert _as_dict(torch_parity._DTYPE_FALLBACK) == _as_dict(
        epsilon._DTYPE_FALLBACK)
    assert torch_parity._ULP_FLOOR_REL == epsilon._ULP_FLOOR_REL


def _matmuls(dtype, drop: bool, seed: int):
    """A (64, 256) x (256, 128) product summed in one f32 dot (the
    reference) and either split in two K halves (a reassociation) or
    with the second K half dropped (a wrong result), both rounded to
    dtype."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((64, 256)) * 0.1).astype(dtype).astype(
        np.float32)
    b = (rng.standard_normal((256, 128)) * 0.1).astype(dtype).astype(
        np.float32)
    one = a @ b
    lo = a[:, :128] @ b[:128]
    got = lo if drop else lo + a[:, 128:] @ b[128:]
    return one.astype(dtype), got.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("drop", [False, True], ids=["reassoc", "dropped"])
def test_report_equals_the_jax_module(dtype, drop):
    for seed in (3, 4):
        ref, got = _matmuls(dtype, drop, seed)
        for family in FAMILIES:
            mine = torch_parity.check_epsilon(ref, got, family)
            theirs = epsilon.check_epsilon(ref, got, family)
            assert mine == theirs
            assert mine["ok"] is not drop, mine
    assert torch_parity.cosine_drift(ref, got) == numerics.cosine_drift(
        ref, got)
    assert torch_parity.max_ulp_f32(ref, got) == numerics.max_ulp_f32(
        ref, got)


def test_torch_dtypes():
    """A torch dtype names the band as numpy's does: the bf16 band admits
    a one-quantum difference of every element, not a sign flip."""
    ref, _ = _matmuls(BF16, False, 5)
    want = torch.from_numpy(ref.astype(np.float32)).to(torch.bfloat16)
    bumped = want.view(torch.int16).add(1).view(torch.bfloat16)
    rep = torch_parity.check_epsilon(want.float().numpy(),
                                     bumped.float().numpy(), "flash_prefill",
                                     torch.bfloat16)
    assert rep["ok"] and rep["dtype"] == "bfloat16"
    assert rep["ulp"] == 1 << 16
    assert not torch_parity.check_epsilon(
        want.float().numpy(), -want.float().numpy(), "flash_prefill",
        torch.bfloat16)["ok"]
    with pytest.raises(KeyError):
        torch_parity.band_for("flash_prefill", torch.int8)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_parity.drift(np.zeros((2, 2)), np.zeros((2, 3)))

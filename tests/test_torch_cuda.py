"""The port's CUDA kernels against their plain versions, on the card.

    python -m pytest -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA card and nvcc (the kernels build at first
use) and skips without one. The file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels import (
    flash_prefill_local,
    flash_prefill_plain,
    launches,
    reset_launches,
)


def _inputs(seed, b, s, t, hq, hkv, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_prefill_kernel_matches_plain(cuda, dtype, atol):
    """GQA G=4, kv_len mid-tile / empty / full, offset positions, T not
    a multiple of the tile, causal and not. bf16 atol 2e-2: the output
    is rounded to bf16 (8 bits of mantissa) in both, and the kernel
    rounds P to bf16 for the P.V product."""
    reset_launches()
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _inputs(4, 3, 16, 70, 8, 2, 128))
    kv_len = torch.tensor([37, 0, 70], device="cuda")
    qpos = (torch.arange(16, device="cuda")[None] + 7).expand(3, 16)
    for causal in (True, False):
        got = flash_prefill_local(q, k, v, q_positions=qpos.contiguous(),
                                  kv_len=kv_len, causal=causal)
        want = flash_prefill_plain(q, k, v, q_positions=qpos,
                                   kv_len=kv_len, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
        assert torch.all(got[1] == 0)
    assert launches() == {"flash_prefill_local": 2}

"""Device selection — the device half of triton_dist_tpu.runtime.init.

The JAX package builds a named mesh over whatever backend JAX found.
The port runs on one CUDA card: every entry point takes a `device`
argument, defaults to "cuda", and raises when CUDA is absent instead of
carrying on on the CPU. Tests pass device="cpu" explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# kernels of the JAX package that a world > 1 port needs and this
# package does not have yet (ROADMAP.md, queue 2)
_MISSING_COLLECTIVES = (
    "ag_gemm (_ag_gemm_kernel)",
    "gemm_rs (_gemm_rs_kernel, _gemm_rs_kernel_streamed)",
    "one_shot_all_reduce (_one_shot_ar_kernel)",
    "ring_all_gather (_ring_ag_kernel)",
    "ring_reduce_scatter (_ring_rs_kernel)",
)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch device an entry point runs on: "cuda" unless the caller
    names another. A CUDA device without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_world(world: int) -> None:
    """The port runs at world 1 only; say which kernels are missing."""
    if world != 1:
        raise NotImplementedError(
            f"world={world}: tensor parallelism needs the collective "
            "kernels still to be ported: " + ", ".join(_MISSING_COLLECTIVES))

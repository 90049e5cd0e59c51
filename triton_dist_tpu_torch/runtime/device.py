"""Device selection — the device half of triton_dist_tpu.runtime.init.

The JAX package builds a named mesh over whatever backend JAX found.
The port runs on one CUDA card: every entry point takes a `device`
argument, defaults to "cuda", and raises when CUDA is absent instead of
carrying on on the CPU. Tests pass device="cpu" explicitly. Ranks are a
virtual world on that device (runtime/symm_mem.py).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_MODES = ("xla", "dist", "ar")


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


def check_modes(world: int, prefill_mode: str, decode_mode: str) -> None:
    """The JAX Engine's modes: at world 1 all three are the same
    computation; at world > 1 the port runs "ar" and names what the
    sequence-sharded modes still need."""
    for kind, mode in (("prefill", prefill_mode), ("decode", decode_mode)):
        if mode not in _MODES:
            raise ValueError(f"{kind}_mode={mode!r}: one of {_MODES}")
        if world > 1 and mode != "ar":
            raise NotImplementedError(
                f"world={world}, {kind}_mode={mode!r}: the sequence-sharded "
                "legs are not ported yet (ag_gemm (_ag_gemm_kernel) with "
                "its silu_pair epilogue, gemm_rs(a_order='arrival'), the "
                "token all-gather and reduce-scatter); use mode 'ar'")

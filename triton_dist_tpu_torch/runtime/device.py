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

MODES = ("xla", "dist", "ar", "fused")


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


def check_modes(prefill_mode: str, decode_mode: str,
                moe: bool = False) -> None:
    """The JAX Engine's mode strings, each one of MODES at any world (at
    world 1 all of them are the same computation). "fused" is the MoE
    one-kernel pipeline: a dense model refuses it, as the JAX planner
    does (planner.py:538-540)."""
    for kind, mode in (("prefill", prefill_mode), ("decode", decode_mode)):
        if mode not in MODES:
            raise ValueError(f"{kind}_mode={mode!r}: one of {MODES}")
        if mode == "fused" and not moe:
            raise ValueError(f"{kind}_mode='fused' is the MoE one-kernel "
                             "pipeline; the model is dense")

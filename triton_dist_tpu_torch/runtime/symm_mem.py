"""The virtual world — the port's counterpart of triton_dist_tpu's mesh
and symmetric memory (runtime/init.py's world and rank, runtime/
symm_mem.py's symmetric heap).

The JAX package runs every multi-rank protocol on a mesh of devices (a
virtual 12-device CPU mesh in its tests). The port runs n ranks on one
card, the same way: a rank is an index, not a process.

  heap(shape, dtype)  one allocation with a leading rank dimension,
                      (n, *shape): [r] is rank r's partition, and a put
                      is a store into a peer's partition;
  flags(count)        an int32 (n, count) pool of signal flags, zeroed on
                      the current stream (stream-ordered), so every
                      kernel launch starts from fresh flags, as the TPU
                      kernels' semaphores are kernel-local.

One launch runs all n ranks' programs (csrc/shmem.cuh). Rank-stacked
tensors carry the rank as their leading dim: the activations (n, M, H),
the weights (L, n, ...), the KV cache's rows. World 1 is the same object
with n = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class VirtualWorld:
    n: int
    device: torch.device

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"world size {self.n} must be at least 1")
        object.__setattr__(self, "device", torch.device(self.device))

    def heap(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        """A symmetric allocation: (n, *shape), uninitialised; [r] is
        rank r's partition."""
        return torch.empty((self.n, *shape), dtype=dtype, device=self.device)

    def flags(self, count: int) -> torch.Tensor:
        """A zeroed int32 (n, count) flag pool, one row per rank."""
        return torch.zeros((self.n, count), dtype=torch.int32,
                           device=self.device)

    @staticmethod
    def of(x: torch.Tensor) -> "VirtualWorld":
        """The world of a rank-stacked tensor: its leading dim, its
        device."""
        return VirtualWorld(x.shape[0], x.device)

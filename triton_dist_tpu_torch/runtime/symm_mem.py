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
  context(shape, dtype, flag_words)
                      a persistent allocation threaded through calls: a
                      symmetric data array (n, *shape) and an int32
                      (n, flag_words) flag array, both zeroed once, when
                      the context is made, and by no launch. A protocol
                      that carries state from one launch to the next
                      lives here: the low-latency AllGather's parity
                      slots and its (parity, source) flags, which call k
                      sets to k + 1 and waits on by value, so nothing is
                      reset between calls (kernels/low_latency_
                      allgather.py). A flag pool from flags() could not
                      carry that: it starts at zero every launch.

The decode megakernel's AllReduce mailbox is one heap((AR tasks, n, B,
W)): each AR task of a step has its own slot of n source ranks in every
rank's partition (72 x 4 x 4 x 4096 bf16 = 9.4 MB a rank for Qwen3-8B at
world 4), and its arrival counters are flags. A launch never reuses a
slot and the next launch is stream-ordered after it, so the JAX kernel's
parity double-buffering and its flow control are not needed.

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

    def context(self, shape: Sequence[int], dtype: torch.dtype,
                flag_words: int) -> "SymmetricContext":
        """A persistent context: data (n, *shape) and flags (n,
        flag_words) int32, zeroed here once and never by a launch."""
        return SymmetricContext(
            data=torch.zeros((self.n, *shape), dtype=dtype,
                             device=self.device),
            flags=torch.zeros((self.n, flag_words), dtype=torch.int32,
                              device=self.device))

    @staticmethod
    def of(x: torch.Tensor) -> "VirtualWorld":
        """The world of a rank-stacked tensor: its leading dim, its
        device."""
        return VirtualWorld(x.shape[0], x.device)


@dataclasses.dataclass
class SymmetricContext:
    """State that persists across launches (VirtualWorld.context): data
    [r] and flags [r] are rank r's partitions. Kernels update both in
    place; the caller threads the object through its calls."""

    data: torch.Tensor
    flags: torch.Tensor

"""Point-to-point transfers — port of triton_dist_tpu.kernels.p2p
(`p2p_send` with the Pallas kernel `_p2p_kernel`, `p2p_read`, and
`ring_shift` with its inner kernel), the transport of the PP layer
(layers/p2p.py).

Rank-stacked over the virtual world (runtime/symm_mem.py): x (n, ...)
holds rank r's buffer at [r], and so does the result. Two kernels, each
with two implementations of one contract:

  p2p_send — the CUDA kernel (csrc/p2p.cu, `p2p_kernel`): rank src's x
      lands in rank dst's output, every other rank passes its own x
      through (src == dst: every rank passes through). p2p_read(x,
      reader, owner) is the same launch with src = owner, dst = reader.
  ring_shift — the CUDA kernel (`ring_shift_kernel`): every rank's x
      lands in rank (r + shift) mod n's output, the PP stage handoff;
      its prologue is a neighbour barrier when |shift| = 1, else a full
      one, as in JAX.
  p2p_send_plain, ring_shift_plain — the same in plain torch (a clone
      with one slice copied; `torch.roll` along the rank dim).

Each wrapper launches its kernel on a CUDA tensor, or raises; on a CPU
tensor it computes the plain version (no kernel exists there).
`straggler=(rank, nanos)` stalls that rank's blocks after the barrier
(the card only; the result is the same). Data movement only: kernel,
plain version and the JAX functions agree bitwise, whatever the dtype.
At n = 1 each returns x, as the JAX functions do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

# bytes a block copies at least: a decode-sized buffer takes a few blocks
# a rank, a prefill microbatch as many as the card holds
_BLOCK_BYTES = 32 << 10
_SIGNATURES = {
    "p2p_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
    "ring_shift_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "p2p_flag_words": (ctypes.c_int, []),
    "p2p_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_ranks(x: torch.Tensor, *ranks: int) -> None:
    if x.dim() < 1:
        raise ValueError("p2p needs a rank-stacked (n, ...) buffer")
    n = x.shape[0]
    for r in ranks:
        if not 0 <= r < n:
            raise ValueError(f"rank {r} is outside the world of {n}")


def p2p_send_plain(x: torch.Tensor, src_rank: int,
                   dst_rank: int) -> torch.Tensor:
    """Every rank's own x, except dst's, which holds src's."""
    _check_ranks(x, src_rank, dst_rank)
    if x.shape[0] == 1:
        return x
    out = x.clone()
    out[dst_rank] = x[src_rank]
    return out


@_build.counted("p2p_send")
def p2p_send(x: torch.Tensor, src_rank: int, dst_rank: int,
             straggler: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (n, ...) -> (n, ...), rank src's buffer sent to rank dst: the
    CUDA kernel on a CUDA tensor (launched or raising, never replaced),
    the plain version on a CPU tensor; at n = 1 the input."""
    _check_ranks(x, src_rank, dst_rank)
    if x.shape[0] == 1:
        return x
    if x.device.type == "cpu":
        return p2p_send_plain(x, src_rank, dst_rank)
    return _launch("p2p_send", x, straggler, src_rank, dst_rank)


def p2p_read(x: torch.Tensor, reader_rank: int, owner_rank: int,
             straggler: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The owner's buffer pulled into the reader: p2p_send in reverse."""
    return p2p_send(x, owner_rank, reader_rank, straggler=straggler)


def ring_shift_plain(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rank r's buffer at rank (r + shift) mod n."""
    _check_ranks(x)
    if x.shape[0] == 1:
        return x
    return torch.roll(x, shift, 0)


@_build.counted("ring_shift")
def ring_shift(x: torch.Tensor, shift: int = 1,
               straggler: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (n, ...) -> (n, ...), every rank's buffer `shift` ranks right:
    the CUDA kernel on a CUDA tensor (launched or raising, never
    replaced), the plain version on a CPU tensor; at n = 1 the input."""
    _check_ranks(x)
    if not -2**31 < shift < 2**31:
        raise ValueError(f"shift {shift} does not fit the kernel's int32")
    if x.shape[0] == 1:
        return x
    if x.device.type == "cpu":
        return ring_shift_plain(x, shift)
    return _launch("ring_shift", x, straggler, shift)


def _launch(name: str, x: torch.Tensor, straggler, *args) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    rank, nanos = straggler if straggler is not None else (-1, 0)
    if straggler is not None and not (0 <= rank < n and nanos >= 0):
        raise ValueError(f"straggler {straggler}: (rank in [0, {n}), "
                         "nanos >= 0)")
    out = torch.empty_like(x)
    nbytes = x[0].numel() * x.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("p2p", _SIGNATURES)
    flags = VirtualWorld.of(x).flags(lib.p2p_flag_words())
    want = max(1, -(-nbytes // _BLOCK_BYTES))
    launch = lib.p2p_launch if name == "p2p_send" else lib.ring_shift_launch
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(), n,
                     nbytes, *args, rank, nanos, want, grid.ptr(),
                     torch.cuda.current_stream().cuda_stream)
    _build.check(name, err, lib.p2p_error_string, grid)
    _build.count_launch(name)
    return out

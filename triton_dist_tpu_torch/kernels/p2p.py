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
`straggler=(rank, nanos)` stalls that rank's blocks before their sends
(ring_shift: after its barrier; the card only; the result is the same).
Data movement only: kernel, plain version and the JAX functions agree
bitwise, whatever the dtype. At n = 1 each returns x, as the JAX
functions do.

On the card p2p_send takes its delivery words from `_POOLS` (a
`_build.PoolCache` keyed by (device, stream, n), _MAX_BLOCKS words a
rank, zeroed once when made): word `_flag_word(dst, b)` gets one add
from src's block b and is cleared by dst's block b, its only waiter, so
each launch leaves the pool at zero and a warm call allocates only its
output. `_blocks_for` sets the blocks a rank and `_body_for` the copy
(register, or bulk through shared memory). ring_shift still takes a
fresh zeroed flag pool a launch (its kernel barriers and counts in it).
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
# p2p_send's blocks a rank at most, and so its delivery words a rank: the
# PP handoff's 4 MiB a rank takes all of them
_MAX_BLOCKS = 128
_BODIES = ("reg", "bulk")
_SIGNATURES = {
    "p2p_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "ring_shift_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "p2p_flag_words": (ctypes.c_int, []),
    "p2p_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# p2p_send's persistent delivery words, an entry a (device, stream, n):
# every launch leaves them at zero
_POOLS = _build.PoolCache()


def _blocks_for(nbytes: int) -> int:
    """p2p_send's blocks a rank for nbytes a rank: one a _BLOCK_BYTES,
    at most _MAX_BLOCKS (launch_world may cap them further at what the
    card holds)."""
    return min(_MAX_BLOCKS, max(1, -(-nbytes // _BLOCK_BYTES)))


def _pool_key(x: torch.Tensor, stream: int) -> tuple:
    """A delivery pool's key: two calls share words only on one device
    and one stream (launches on a stream run one after another), at one
    world size. Every pool has _MAX_BLOCKS words a rank, whatever the
    payload, so no warm call makes one."""
    return (x.device, stream, x.shape[0])


def _flag_word(dst: int, block: int) -> int:
    """The pool word (flat, row-major over (n, _MAX_BLOCKS)) that src's
    block `block` adds to and dst's block `block` waits on and clears."""
    return dst * _MAX_BLOCKS + block


def _body_for(nbytes: int, aligned: bool) -> str:
    """p2p_send's body for nbytes a rank: the bulk copy wherever the
    bytes and the pointers are 16-byte aligned (on an H100 it beat the
    register copy by 23% at the PP handoff's 4 MiB a rank and by 21% at
    16 bytes, tools/profile_p2p_ll.py, PERF.md), else the register copy,
    which also moves bytes."""
    return "bulk" if aligned and nbytes % 16 == 0 else "reg"


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
    return _launch_p2p(x, src_rank, dst_rank, straggler)


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
    return _launch_ring_shift(x, straggler, shift)


def _check_launch(name: str, x: torch.Tensor,
                  straggler) -> Tuple[int, int, int]:
    """A launch's refusals; returns (bytes a rank, straggler rank,
    nanos)."""
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rank, nanos = _build.straggler_args(straggler, x.shape[0])
    return x.numel() // x.shape[0] * x.element_size(), rank, nanos


def _buffers(x: torch.Tensor):
    """A p2p_send call's output, its delivery pool and the stream:
    everything the launch needs but the launch."""
    stream = _build.raw_stream(x.device)
    flags = _POOLS.get(_pool_key(x, stream), lambda: VirtualWorld.of(
        x).flags(_MAX_BLOCKS))
    return torch.empty_like(x), flags, stream


def _launch_p2p(x: torch.Tensor, src: int, dst: int, straggler,
                body: Optional[str] = None,
                grid: Optional[_build.GridInfo] = None) -> torch.Tensor:
    """Launch p2p_kernel. Test and measurement hooks: body ("reg" or
    "bulk") forces one, grid receives the grid launched."""
    nbytes, rank, nanos = _check_launch("p2p_send", x, straggler)
    if nbytes == 0:
        return torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0
    body = body or _body_for(nbytes, aligned)
    if body not in _BODIES:
        raise ValueError(f"body {body!r}: one of {_BODIES}")
    out, flags, stream = _buffers(x)
    lib = _build.load("p2p", _SIGNATURES)
    grid = _build.GridInfo() if grid is None else grid
    with _build.on_device(x.device):
        err = lib.p2p_launch(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                             _MAX_BLOCKS, x.shape[0], nbytes, src, dst, rank,
                             nanos, _blocks_for(nbytes),
                             int(body == "bulk"), grid.ptr(), stream)
    _build.check("p2p_send", err, lib.p2p_error_string, grid)
    _build.count_launch("p2p_send")
    return out


def _launch_ring_shift(x: torch.Tensor, straggler,
                       shift: int) -> torch.Tensor:
    """Launch ring_shift_kernel over a fresh zeroed flag pool."""
    nbytes, rank, nanos = _check_launch("ring_shift", x, straggler)
    out = torch.empty_like(x)
    if nbytes == 0:
        return out
    n = x.shape[0]
    lib = _build.load("p2p", _SIGNATURES)
    flags = VirtualWorld.of(x).flags(lib.p2p_flag_words())
    want = max(1, -(-nbytes // _BLOCK_BYTES))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.ring_shift_launch(x.data_ptr(), out.data_ptr(),
                                    flags.data_ptr(), n, nbytes, shift,
                                    rank, nanos, want, grid.ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check("ring_shift", err, lib.p2p_error_string, grid)
    _build.count_launch("ring_shift")
    return out

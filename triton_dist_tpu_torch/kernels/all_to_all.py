"""The MoE all-to-all — port of triton_dist_tpu.kernels.all_to_all
(`all_to_all` with the Pallas kernel `_a2a_kernel`, `fast_all_to_all`,
`all_to_all_ref`, and `all_to_all_chunked` with `_a2a_chunked_kernel`),
the transport of the EP dispatch and combine (kernels/ep_a2a.py).

Rank-stacked over the virtual world (runtime/symm_mem.py): x (n, n, C,
...) holds at [r, i] the segment rank r sends to rank i; splits (n, n)
or (n, n, S) int32 the metadata row beside each segment. The result
holds rank r's receive buffer at [r]: out[r, j] = x[j, r], and the
splits moved alike. Three implementations of one contract:

  all_to_all — the single-shot CUDA kernel (csrc/all_to_all.cu,
      `a2a_kernel`). Launches on a CUDA tensor, or raises; on a CPU
      tensor it computes the plain version.
  all_to_all_chunked — the chunked CUDA kernel (`a2a_chunked_kernel`):
      the same bytes, each segment's C rows in `n_chunks` chunks, each
      chunk on its own [ring step, chunk] delivery flag, chunk-major
      waits; `straggler=(rank, nanos)` stalls that rank before its
      sends. C % n_chunks != 0 raises the JAX ValueError.
  all_to_all_plain — the JAX `all_to_all_ref` (`lax.all_to_all` over
      the leading dim) in plain torch: one copy a destination rank.

Data movement only, whole static segments (rows past a segment's count
included): the three agree bitwise, whatever the dtype (the EP payload
is bf16 on dispatch and f32 on combine), and with the JAX functions.
At n = 1 each returns its input with the splits as int32 and launches
nothing, as the JAX functions do.

On the card both kernels take their delivery flags from `_POOLS` (a
`_build.PoolCache` keyed by (device, stream, n, q), `_flag_words(n, q)`
words a rank, zeroed once when made); each launch leaves them at zero,
so a warm call allocates only its two outputs. `_word` picks the bytes
a word moves and `_body_for` the kernel body: the register copy, or
from 1 MiB a rank's chunk the bulk copy through shared memory; the
kernel's entry cuts each destination's chunk into the tiles its blocks
share (csrc/all_to_all.cu `plan`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_BODIES = ("reg", "bulk")
# a rank's chunk (over its n destinations) from which the bulk body takes
# it. On an H100, on the EP prefill's chunks (4.5-34 MB a rank) the bulk
# copy was 3-8% faster than the register copy at the dispatch in 2 or 4
# chunks and within 1.5% otherwise; on the decode exchange's 0.14 MB the
# register copy was as fast, and up to 10% faster in the chunked kernel
# (tools/profile_a2a.py, PERF.md).
_BULK_MIN_BYTES = 1 << 20
_SIGNATURES = {
    "a2a_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "a2a_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# the kernels' persistent delivery flags, an entry a (device, stream, n,
# q): every launch leaves them at zero
_POOLS = _build.PoolCache()


def _flag_words(n: int, q: int) -> int:
    """Delivery flags a rank: one a (source, chunk); the single-shot
    kernel is q = 1. No splits flag: the segment flags publish the
    splits rows too."""
    return n * q


def _pool_key(x: torch.Tensor, stream: int, q: int) -> tuple:
    """A flag pool's key: two calls share flags only on one device and
    one stream (launches on a stream run one after another), at one
    world size and one chunk count. The single-shot kernel and the
    chunked one at q = 1 share a pool: both leave it at zero."""
    return (x.device, stream, x.shape[0], q)


def _body_for(n: int, seg: int, q: int, aligned: bool) -> str:
    """The kernel body for n segments of `seg` bytes a rank in q chunks:
    the bulk copy where a rank's chunk (n * seg / q bytes) reaches
    _BULK_MIN_BYTES in 16-byte words, else the register copy."""
    chunk = seg // q
    if aligned and chunk % 16 == 0 and n * chunk >= _BULK_MIN_BYTES:
        return "bulk"
    return "reg"


def _word(seg: int, q: int, aligned: bool, body: str = "reg") -> int:
    """The bytes of the word the kernel moves, for segments of `seg`
    bytes in q chunks: 16 when the chunk and the pointers allow them
    (`aligned`), else 1 (the bulk body needs 16)."""
    if body not in _BODIES:
        raise ValueError(f"body {body!r}: one of {_BODIES}")
    chunk = seg // q
    word = 16 if aligned and chunk % 16 == 0 else 1
    if body == "bulk" and word != 16:
        raise ValueError(f"the bulk body moves 16-byte words: a chunk of "
                         f"{chunk} bytes")
    return word


def _check(x: torch.Tensor, splits: torch.Tensor) -> None:
    n = x.shape[0]
    if x.dim() < 3 or x.shape[1] != n:
        raise ValueError(f"all_to_all needs rank-stacked (n, n, C, ...) "
                         f"segments, got shape {tuple(x.shape)}")
    if splits.shape[:2] != (n, n) or splits.dim() > 3:
        raise ValueError(f"splits {tuple(splits.shape)}: (n, n) or (n, n, "
                         f"S) with n = {n}")


def all_to_all_plain(x: torch.Tensor,
                     splits: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """out[r, j] = x[j, r], and the splits alike (as int32): rank r's
    receive buffer gathered from every source, one copy a rank."""
    _check(x, splits)
    n = x.shape[0]
    sp = splits.to(torch.int32)
    return (torch.stack([x[:, r] for r in range(n)]),
            torch.stack([sp[:, r] for r in range(n)]))


@_build.counted("all_to_all")
def all_to_all(x: torch.Tensor,
               splits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n, n, C, ...), splits (n, n[, S]) -> (out, out_splits), out[r,
    j] = x[j, r]: the CUDA kernel on a CUDA tensor (launched or raising,
    never replaced), the plain version on a CPU tensor; at n = 1 the
    input."""
    _check(x, splits)
    if x.shape[0] == 1:
        return x, splits.to(torch.int32)
    if x.device.type == "cpu":
        return all_to_all_plain(x, splits)
    return _launch("all_to_all", x, splits, 1, False, None)


def fast_all_to_all(x: torch.Tensor, splits: torch.Tensor):
    """The reference's public name for `all_to_all`."""
    return all_to_all(x, splits)


@_build.counted("all_to_all_chunked")
def all_to_all_chunked(x: torch.Tensor, splits: torch.Tensor,
                       n_chunks: int = 1,
                       straggler: Optional[Tuple[int, int]] = None):
    """all_to_all with each segment's C rows in `n_chunks` chunks, each
    on its own delivery flag: the same bytes. C % n_chunks must be 0.
    straggler: (rank, nanos), that rank's blocks stall before their
    sends (the card only; the output is the same)."""
    _check(x, splits)
    q = int(n_chunks)
    if q < 1 or x.shape[2] % q:
        raise ValueError(f"n_chunks={q} must be >= 1 and divide the "
                         f"capacity dim {x.shape[2]}")
    if x.shape[0] == 1:
        return x, splits.to(torch.int32)
    if x.device.type == "cpu":
        return all_to_all_plain(x, splits)
    return _launch("all_to_all_chunked", x, splits, q, True, straggler)


def _check_launch(x: torch.Tensor, straggler) -> Tuple[int, int, int]:
    """The launch's refusals; returns (segment bytes, straggler rank,
    nanos)."""
    if x.device.type != "cuda":
        raise ValueError(f"the all-to-all kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    rank, nanos = _build.straggler_args(straggler, n)
    seg = x.numel() // (n * n) * x.element_size()
    if seg == 0:
        raise ValueError(f"empty segments {tuple(x.shape)}")
    return seg, rank, nanos


def _splits(x: torch.Tensor, splits: torch.Tensor) -> torch.Tensor:
    """The splits as the kernel reads them: int32, contiguous, on x's
    device (the tensor itself when it already is)."""
    if (splits.dtype == torch.int32 and splits.device == x.device
            and splits.is_contiguous()):
        return splits
    return splits.to(device=x.device, dtype=torch.int32).contiguous()


def _buffers(x: torch.Tensor, sp: torch.Tensor, q: int):
    """A call's outputs, its flag pool and the stream: everything the
    launch needs but the launch."""
    # the raw handle: a Stream object costs microseconds a call
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    flags = _POOLS.get(_pool_key(x, stream, q), lambda: VirtualWorld.of(
        x).flags(_flag_words(x.shape[0], q)))
    return torch.empty_like(x), torch.empty_like(sp), flags, stream


def _launch(name: str, x: torch.Tensor, splits: torch.Tensor, q: int,
            chunked: bool, straggler, body: Optional[str] = None,
            blocks: int = 0,
            grid: Optional[_build.GridInfo] = None) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Launch the kernel. Test and measurement hooks: body ("reg" or
    "bulk") forces one, blocks sets the blocks a rank (0: a block a
    tile of a chunk), grid receives the grid launched."""
    seg, rank, nanos = _check_launch(x, straggler)
    sp = _splits(x, splits)
    n = x.shape[0]
    aligned = x.data_ptr() % 16 == 0
    body = body or _body_for(n, seg, q, aligned)
    word = _word(seg, q, aligned, body)
    out, out_sp, flags, stream = _buffers(x, sp, q)
    lib = _build.load("all_to_all", _SIGNATURES)
    grid = _build.GridInfo() if grid is None else grid
    # a device guard only where x is not on the current device
    with (contextlib.nullcontext()
          if x.device.index == torch.cuda.current_device()
          else torch.cuda.device(x.device)):
        err = lib.a2a_launch(x.data_ptr(), out.data_ptr(), sp.data_ptr(),
                             out_sp.data_ptr(), flags.data_ptr(), n,
                             seg // word, sp.numel() // (n * n), q, word,
                             int(chunked), int(body == "bulk"), rank, nanos,
                             blocks, grid.ptr(), stream)
    _build.check(name, err, lib.a2a_error_string, grid)
    _build.count_launch(name)
    return out, out_sp

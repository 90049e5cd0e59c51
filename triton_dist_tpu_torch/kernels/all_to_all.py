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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

# bytes a block copies at least: a decode step's exchange takes a few
# blocks a rank, a prefill's as many as the card holds
_BLOCK_BYTES = 32 << 10
_SIGNATURES = {
    "a2a_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
    "a2a_flag_words": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "a2a_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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


def _launch(name: str, x: torch.Tensor, splits: torch.Tensor, q: int,
            chunked: bool, straggler) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"the all-to-all kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    rank, nanos = straggler if straggler is not None else (-1, 0)
    if straggler is not None and not (0 <= rank < n and nanos >= 0):
        raise ValueError(f"straggler {straggler}: (rank in [0, {n}), "
                         "nanos >= 0)")
    world = VirtualWorld.of(x)
    sp = splits.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    out_sp = torch.empty_like(sp)
    seg = x[0, 0].numel() * x.element_size()
    seg_s = sp[0, 0].numel() * 4
    if seg == 0:
        raise ValueError(f"empty segments {tuple(x.shape)}")
    lib = _build.load("all_to_all", _SIGNATURES)
    flags = world.flags(lib.a2a_flag_words(n, q))
    want = max(1, -(-n * seg // _BLOCK_BYTES))
    grid = _build.GridInfo()
    with torch.cuda.device(x.device):
        err = lib.a2a_launch(x.data_ptr(), out.data_ptr(), sp.data_ptr(),
                             out_sp.data_ptr(), flags.data_ptr(), n, seg,
                             seg_s, q, int(chunked), rank, nanos, want,
                             grid.ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(name, err, lib.a2a_error_string, grid)
    _build.count_launch(name)
    return out, out_sp.reshape(splits.shape)

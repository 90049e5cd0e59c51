"""Token sampling by the JAX package's key stream: the threefry2x32 keys,
random bits and uniforms of `jax.random`, and the per-row sampler of
the serve step (`sample_slots`, csrc/sample.cu).

The JAX package samples a serve step's slots with XLA code,
`jax.random.categorical(key, logits / max(T, 1e-6))` under
`key = fold_in(PRNGKey(seed), n_out)` (triton_dist_tpu/models/engine.py
`_serve_step_math`, triton_dist_tpu/mega/ring.py `slot_plan`), and
`Engine.serve` / `generate` by the `PRNGKey(seed)` / `split` chain. With
jax_threefry_partitionable on (JAX's default), every piece is integer
threefry2x32 and bit casts (jax/_src/prng.py):

  PRNGKey(seed)      (0, seed mod 2^32)
  fold_in(key, d)    threefry2x32(key, (0, d)); split(key)[i] likewise
                     with d = i, so `key, sub = split(key)` is
                     (fold_in(key, 0), fold_in(key, 1))
  bits of element i  x0 ^ x1 of threefry2x32(key, (i >> 32, i mod 2^32)),
                     i the element's row-major index in the draw's shape
  uniform in [tiny, 1)  max(tiny, f + tiny), f = bitcast((bits >> 9) |
                     0x3F800000) - 1
  Gumbel             -log(-log(u))

so the port reproduces the keys, the bits and the uniforms bitwise; the
Gumbel noise goes through torch's log (or the card's logf), which may
differ from XLA's by an ulp, so a sampled token equals JAX's except at a
near-tie. `threefry2x32` takes Python ints, numpy int64 arrays or torch
int64 tensors holding 32-bit values.

`sample_slots(logits, keys, temps)` is the counted kernel wrapper: the
CUDA kernel on a CUDA tensor, `sample_slots_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import _build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash of the counter (x0, x1) under the key
    (k0, k1), all 32-bit values held in wider integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def seed_key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) of a Python int (JAX without x64)."""
    return 0, int(seed) & MASK


def fold_in(key, data: int) -> Tuple[int, int]:
    """jax.random.fold_in(key, data), data in [0, 2^32)."""
    if not 0 <= int(data) <= MASK:
        raise ValueError(f"fold_in data {data} outside [0, 2^32)")
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data))


def split(key) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """jax.random.split(key): (key, sub) = (split[0], split[1])."""
    return fold_in(key, 0), fold_in(key, 1)


def key_words(key) -> np.ndarray:
    """A key as JAX holds it: (2,) uint32."""
    return np.asarray([int(key[0]) & MASK, int(key[1]) & MASK], np.uint32)


def as_int32(keys: np.ndarray) -> np.ndarray:
    """(..., 2) uint32 key words as the int32 the kernels take."""
    return np.asarray(keys, np.uint32).view(np.int32)


def random_bits(keys: torch.Tensor, n: int, base=0) -> torch.Tensor:
    """The 32 random bits of elements [base, base + n) of a draw under
    each key: keys (R, 2) int (the words as int32 or int64), base an int
    or (R,) int64 -> (R, n) int64 in [0, 2^32)."""
    k = keys.to(torch.int64) & MASK
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    if isinstance(base, torch.Tensor):
        i = i + base.to(torch.int64)[:, None]
    else:
        i = i + int(base)
    x0, x1 = threefry2x32(k[:, 0:1], k[:, 1:2], i >> 32, i & MASK)
    return x0 ^ x1


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in [tiny, 1) of 32 random bits (bitwise)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def _split_words(keys: torch.Tensor):
    """(next (R, 2), sub (R, 2)) int64 words of split(key) a row."""
    k = keys.to(torch.int64) & MASK
    zero = torch.zeros_like(k[:, 0])
    nxt = torch.stack(threefry2x32(k[:, 0], k[:, 1], zero, zero), -1)
    sub = torch.stack(threefry2x32(k[:, 0], k[:, 1], zero, zero + 1), -1)
    return nxt, sub


def sample_slots_plain(logits: torch.Tensor, keys: torch.Tensor,
                       temps: torch.Tensor, flat: bool = False,
                       key_next: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The kernel's plain version: logits (R, V) f32, keys (R, 2) (the
    words as int32 or int64), temps (R,) f32 -> (R,) int64: the argmax of
    logits / max(T, 1e-6) + Gumbel where T > 0, else of logits. `flat`:
    row r draws elements [r V, (r + 1) V) of one (R, V) draw (one key
    shared by a batch), else its own (V,) draw. With `key_next` the rows
    sample under split(key)[1] and key_next (R, 2) int32 gets
    split(key)[0]."""
    R, V = logits.shape
    if key_next is not None:
        nxt, keys = _split_words(keys)
        key_next.copy_(nxt)  # the words wrap into int32
    base = (torch.arange(R, dtype=torch.int64, device=logits.device) * V
            if flat else 0)
    u = uniforms(random_bits(keys, V, base))
    g = -torch.log(-torch.log(u))
    t = temps.to(torch.float32)[:, None]
    sampled = torch.argmax(logits.float() / torch.clamp_min(t, 1e-6) + g,
                           dim=-1)
    greedy = torch.argmax(logits.float(), dim=-1)
    return torch.where(temps > 0, sampled, greedy)


_SIGNATURES = {
    "sample_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "sample_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


THREADS = 256  # csrc/sample.cu kThreads


def _parts(rows: int, v: int, sms: int = _build.SMS) -> int:
    """Blocks a row of `v` elements is split over: enough that the grid
    of `rows` rows covers the card's SMs twice, at most one a THREADS
    elements."""
    return max(1, min(-(-2 * sms // rows), -(-v // THREADS)))


@_build.counted("sample_slots")
def sample_slots(logits: torch.Tensor, keys: torch.Tensor,
                 temps: torch.Tensor, flat: bool = False,
                 key_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A token a row (`sample_slots_plain`'s contract): the CUDA kernel
    of csrc/sample.cu on a CUDA tensor (f32 logits with unit stride, keys
    (R, 2) int32, temps (R,) f32, key_next (R, 2) int32, or a raise), the
    plain version on a CPU tensor."""
    if logits.device.type == "cpu":
        return sample_slots_plain(logits, keys, temps, flat, key_next)
    return _launch(logits, keys, temps, flat, key_next)


def _launch(logits: torch.Tensor, keys: torch.Tensor, temps: torch.Tensor,
            flat: bool = False, key_next: Optional[torch.Tensor] = None,
            bits_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's launch; `bits_out` (R, V) int32, a check's hook, gets
    the sampled rows' random bits."""
    R, V = logits.shape
    dev = logits.device
    if logits.dtype != torch.float32 or logits.stride(1) != 1:
        raise ValueError("sample_slots takes f32 logits with unit stride, "
                         f"got {logits.dtype} strides {logits.stride()}")
    for name, t, dt, shape in (("keys", keys, torch.int32, (R, 2)),
                               ("temps", temps, torch.float32, (R,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"sample_slots: {name} must be a contiguous "
                             f"{dt} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if key_next is not None and (
            key_next.device != dev or key_next.dtype != torch.int32
            or tuple(key_next.shape) != (R, 2)
            or not key_next.is_contiguous()):
        raise ValueError("sample_slots: key_next must be a contiguous int32 "
                         f"({R}, 2) on {dev}")
    if bits_out is not None and (bits_out.device != dev
                                 or bits_out.dtype != torch.int32
                                 or tuple(bits_out.shape) != (R, V)
                                 or not bits_out.is_contiguous()):
        raise ValueError(f"sample_slots: bits_out must be a contiguous int32 "
                         f"({R}, {V}) on {dev}")
    if flat and R * V > MASK:
        raise ValueError(f"a flat draw of {R} x {V} elements passes 2^32")
    out = torch.empty((R,), dtype=torch.int64, device=dev)
    parts = _parts(R, V, _build.card_sms(dev))
    # the blocks' partial values and indices, and a zeroed counter a row
    ws = torch.zeros((R * (2 * parts + 1),), dtype=torch.int32, device=dev)
    lib = _build.load("sample", _SIGNATURES)
    with _build.on_device(dev):
        err = lib.sample_launch(
            logits.data_ptr(), logits.stride(0), keys.data_ptr(),
            temps.data_ptr(), out.data_ptr(),
            None if key_next is None else key_next.data_ptr(),
            None if bits_out is None else bits_out.data_ptr(),
            ws.data_ptr(), ws[R * parts:].data_ptr(),
            ws[2 * R * parts:].data_ptr(), R, V, parts, int(flat),
            int(key_next is not None), _build.raw_stream(dev))
    _build.check("sample_slots", err, lib.sample_error_string)
    _build.count_launch("sample_slots")
    return out

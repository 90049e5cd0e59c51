"""Block-scaled quantized-wire codec — port of triton_dist_tpu.wire.codec.

One quantization definition for every quantized collective of the port:

  WireFormat     "native" (pass-through: the payload bytes are the
                 tensor), "fp8" (e4m3) or "int8", each block-scaled
                 along the last axis with f32 scales (`block` None: one
                 scale a row), optionally with a per-row checksum word.
  quantize /     the (payload, scale) pair: s = max(amax / FMAX,
  dequantize     SCALE_EPS) a block, q = x / s rounded to the payload
                 type (fp8: nearest even; int8: round half to even,
                 clamped to +-127); decode is float(q) * s in f32,
                 rounded once to the output dtype.
  encode_rows /  the wire image: one int8 (rows, wire_cols) tensor,
  decode_rows    payload bytes, then the f32 scales bitcast little-
                 endian into 4 * n_blocks byte columns, then (checksum
                 formats) the int32 sum of the signed body bytes, then
                 zero padding to a multiple of LANE = 128.
  pack / unpack  host-level wrappers flattening trailing dims; unpack of
                 a checksum format raises WireIntegrityError on a row
                 whose checksum fails.

The image is byte for byte the JAX package's (tests/test_torch_wire.py
holds every function bitwise against it), and the CUDA kernels that
encode on the card (csrc/reduce_scatter.cu `ring_rs_wire_kernel`)
produce the same bytes. These are torch ops: on a CUDA tensor they run
on the card, as the JAX functions run at host level outside any kernel.

A known divergence that the image never meets: torch's conversion of
f32 to float8_e4m3fn saturates values beyond 464 to 448, where the JAX
package's (ml_dtypes) gives NaN (470.0 is byte 126 here, 127 there).
Below 464 the two agree, and the codec never converts a value above
448 * (1 + 2^-23): x / s with s = amax / 448.

Not ported: the fault plan's scheduled bit flips in encode_rows
(`_maybe_corrupt`) and the in-kernel integrity trip of a guard build
(ROADMAP item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

from triton_dist_tpu_torch.faults.errors import WireIntegrityError

# e4m3 finite max / int8 symmetric max
FP8_MAX = 448.0
INT8_MAX = 127.0
# scale floor: keeps all-zero blocks finite
SCALE_EPS = 1e-12
SCALE_BYTES = 4     # one f32 scale a block
CHECKSUM_BYTES = 4  # one int32 byte sum a row (checksum formats)
LANE = 128          # wire rows pad to a multiple of this many bytes

_KINDS = ("native", "fp8", "int8")


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One wire encoding: `kind` picks the payload dtype, `block` the
    scale granularity along the flattened last axis (None: one scale a
    row; an int must divide the row width), `checksum` a per-row byte
    sum after the scales that the consume edge verifies."""

    kind: str = "native"
    block: Optional[int] = None
    checksum: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown wire format kind {self.kind!r} (one of {_KINDS})")
        if self.block is not None and self.block <= 0:
            raise ValueError(f"wire block must be positive, got {self.block}")
        if self.checksum and self.kind == "native":
            raise ValueError(
                "checksum rides the wire image; the native format has "
                "none (move the tensor itself)")


NATIVE = WireFormat("native")
FP8 = WireFormat("fp8")
INT8 = WireFormat("int8")

WireFormatLike = Union[None, str, WireFormat]


def resolve(fmt: WireFormatLike) -> WireFormat:
    """None / str / WireFormat -> WireFormat (None and "native" are the
    pass-through format)."""
    if fmt is None:
        return NATIVE
    if isinstance(fmt, WireFormat):
        return fmt
    if isinstance(fmt, str):
        return WireFormat(fmt)
    raise TypeError(f"wire_format must be None/str/WireFormat, got "
                    f"{type(fmt).__name__}")


def is_native(fmt: WireFormatLike) -> bool:
    return resolve(fmt).kind == "native"


def payload_dtype(fmt: WireFormatLike) -> torch.dtype:
    f = resolve(fmt)
    if f.kind == "fp8":
        return torch.float8_e4m3fn
    if f.kind == "int8":
        return torch.int8
    raise ValueError("native wire has no quantized payload dtype")


def _fmax(fmt: WireFormat) -> float:
    return FP8_MAX if fmt.kind == "fp8" else INT8_MAX


def n_blocks(h: int, fmt: WireFormatLike) -> int:
    """Scale blocks a row of width h (block must divide h)."""
    f = resolve(fmt)
    if f.block is None:
        return 1
    if h % f.block:
        raise ValueError(
            f"wire block {f.block} does not divide row width {h}")
    return h // f.block


def wire_cols(h: int, fmt: WireFormatLike) -> int:
    """The wire image's row width (int8 columns) for a row of h
    elements: payload bytes + bitcast f32 scales (+ the checksum word),
    padded to LANE. The native format has no image (raises)."""
    f = resolve(fmt)
    if f.kind == "native":
        raise ValueError("native wire has no packed image; move the "
                         "tensor itself")
    used = h + SCALE_BYTES * n_blocks(h, f)
    if f.checksum:
        used += CHECKSUM_BYTES
    return -(-used // LANE) * LANE


def wire_row_bytes(h: int, fmt: WireFormatLike, dtype: torch.dtype) -> int:
    """Bytes one row of h elements occupies on the wire (native: the
    tensor's own bytes)."""
    f = resolve(fmt)
    if f.kind == "native":
        return h * dtype.itemsize
    return wire_cols(h, f)


def quantize(x: torch.Tensor, fmt: WireFormatLike):
    """Block-scaled quantization along the last axis -> (payload (...,
    H) in the format's dtype, scale (..., nb) f32)."""
    f = resolve(fmt)
    if f.kind == "native":
        raise ValueError("native wire is not quantized")
    h = x.shape[-1]
    nb = n_blocks(h, f)
    xf = x.float()
    xb = xf.reshape(*x.shape[:-1], nb, h // nb)
    amax = xb.abs().amax(dim=-1)                      # (..., nb)
    # divide by a tensor of FMAX, not by the Python float: torch's CUDA
    # division by a CPU scalar multiplies by its reciprocal, one ulp off
    # the IEEE quotient that the codec (and its CUDA kernels) define
    s = torch.clamp(amax / torch.full_like(amax, _fmax(f)), min=SCALE_EPS)
    scaled = (xb / s[..., None]).reshape(x.shape)
    if f.kind == "fp8":
        q = scaled.to(torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(
            torch.int8)
    return q, s


def dequantize(q: torch.Tensor, scale: torch.Tensor, fmt: WireFormatLike,
               out_dtype: torch.dtype) -> torch.Tensor:
    """(payload, scale) -> (..., H) in out_dtype: f32 multiply, one
    rounding last."""
    h = q.shape[-1]
    nb = scale.shape[-1]
    qf = q.float().reshape(*q.shape[:-1], nb, h // nb)
    return (qf * scale[..., None]).reshape(q.shape).to(out_dtype)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A (rows, c) tensor's bytes as (rows, c * itemsize) int8,
    little-endian."""
    return t.contiguous().view(torch.int8)


def _row_checksum(body: torch.Tensor) -> torch.Tensor:
    """Per-row int32 sum of the signed body bytes (a flipped bit moves
    exactly one byte, so the sum moves; not cryptographic)."""
    return body.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def encode_rows(x: torch.Tensor, fmt: WireFormatLike) -> torch.Tensor:
    """(rows, H) float -> (rows, wire_cols) int8 wire image."""
    f = resolve(fmt)
    q, s = quantize(x, f)
    m, h = x.shape
    parts = [_as_bytes(q), _as_bytes(s)]
    used = h + SCALE_BYTES * s.shape[-1]
    if f.checksum:
        parts.append(_as_bytes(_row_checksum(torch.cat(parts, -1))[:, None]))
        used += CHECKSUM_BYTES
    parts.append(torch.zeros((m, wire_cols(h, f) - used), dtype=torch.int8,
                             device=x.device))
    return torch.cat(parts, -1)


def _scales(w: torch.Tensor, h: int, nb: int) -> torch.Tensor:
    return w[:, h:h + SCALE_BYTES * nb].contiguous().view(torch.float32)


def decode_rows(w: torch.Tensor, h: int, fmt: WireFormatLike,
                out_dtype: torch.dtype) -> torch.Tensor:
    """(rows, wire_cols) int8 wire image -> (rows, h) in out_dtype."""
    f = resolve(fmt)
    nb = n_blocks(h, f)
    q = w[:, :h].contiguous()
    if f.kind == "fp8":
        q = q.view(torch.float8_e4m3fn)
    return dequantize(q, _scales(w, h, nb), f, out_dtype)


def verify_rows(w: torch.Tensor, h: int, fmt: WireFormatLike
                ) -> torch.Tensor:
    """Per-row verdict of a checksummed wire image: True where the byte
    sum of payload and scale columns equals the embedded word."""
    f = resolve(fmt)
    if not f.checksum:
        raise ValueError(
            f"wire format {f} carries no checksum (WireFormat("
            "checksum=True))")
    used = h + SCALE_BYTES * n_blocks(h, f)
    want = w[:, used:used + CHECKSUM_BYTES].contiguous().view(torch.int32)
    return _row_checksum(w[:, :used]) == want[:, 0]


def _integrity_check(w: torch.Tensor, h: int, f: WireFormat) -> None:
    """Raise WireIntegrityError naming the rows whose checksum fails (a
    host read of the verdict)."""
    ok = verify_rows(w, h, f)
    if not bool(ok.all()):
        bad = torch.nonzero(~ok).flatten().tolist()
        raise WireIntegrityError(
            f"wire image failed its checksum on {len(bad)} row(s) "
            f"{bad[:8]} (payload or scale stripe corrupted in flight)",
            rows=bad)


def unpack_checked(w: torch.Tensor, trailing_shape: Sequence[int],
                   fmt: WireFormatLike, out_dtype: torch.dtype
                   ) -> torch.Tensor:
    """`unpack` with a mandatory integrity check (checksum formats)."""
    f = resolve(fmt)
    if f.kind == "native":
        raise ValueError("native wire has no checksum to check")
    _integrity_check(w, math.prod(trailing_shape), f)
    return unpack(w, trailing_shape, f, out_dtype)


def pack(x: torch.Tensor, fmt: WireFormatLike) -> torch.Tensor:
    """Send edge: (rows, ...) -> wire image (rows, wire_cols) int8,
    trailing dims flattened. Native: x itself."""
    f = resolve(fmt)
    if f.kind == "native":
        return x
    if x.dim() < 2:
        raise ValueError(
            f"quantized wire needs >=2D per-device arrays, got "
            f"{tuple(x.shape)}")
    return encode_rows(x.reshape(x.shape[0], -1), f)


def unpack(w: torch.Tensor, trailing_shape: Sequence[int],
           fmt: WireFormatLike, out_dtype: torch.dtype) -> torch.Tensor:
    """Consume edge: wire image (rows, wire_cols) -> (rows,) +
    trailing_shape in out_dtype; a checksum format raises
    WireIntegrityError on a corrupted row. Native: w itself."""
    f = resolve(fmt)
    if f.kind == "native":
        return w
    h = math.prod(trailing_shape)
    if f.checksum:
        _integrity_check(w, h, f)
    out = decode_rows(w, h, f, out_dtype)
    return out.reshape(w.shape[0], *trailing_shape)


def roundtrip(x: torch.Tensor, fmt: WireFormatLike) -> torch.Tensor:
    """pack then unpack: the wire-fidelity reference of every quantized
    collective (a transport moves wire bytes and never changes them).
    Native: x itself."""
    f = resolve(fmt)
    if f.kind == "native":
        return x
    return unpack(pack(x, f), x.shape[1:], f, x.dtype)

"""The resident serving loop's step boundary and step epilogue — the
bookkeeping that the JAX package runs as XLA code inside its resident
`lax.while_loop` (triton_dist_tpu/models/engine.py `_build_resident_loop`:
the loop's cond, `boundary` over mega/ring.py `device_consume` and
`slot_plan`, and `run_step`'s epilogue), as two counted kernels
(csrc/ring.cu) so that a window of serve steps is one CUDA graph:

  ring_boundary(ring, blk, geo, bufs)   before each step: the loop's
      idle iterations (cond, record consumption, idle count) up to the
      first one with an active slot, whose inputs it writes into `bufs`;
      or, once the cond fails, the live word cleared and a dead step
      (n_valid 0 everywhere). With final=True, after the W steps: one
      more consumption and `starved`.
  ring_emit(tok, blk, geo, bufs)        after the step's sampling: eos
      and length finishes, lengths, slot state, output records, executed.

With geo.spec_k > 0 both take their speculative-decoding forms (the JAX
loop's `run_step_spec`, engine.py:551-660): the boundary writes
`slot_plan_spec`'s plan (a decoding slot with a fresh verify record
becomes the row [last, d_1..d_kd], every column keyed, kd into bufs.kd),
and the emit takes the step's (K, C) per-position tokens, keeps the
longest accepted prefix of each verify row and the model's next token,
cuts it at the eos and the budget, advances the length by what it emits
and writes up to spec_k + 1 records a slot (FLAG_SPEC, kd on the first).

`blk` is the window's int32 state block (`WindowGeometry` lays it out):
a header of counters, the slot state, the table, the lengths and the
output ring. `bufs` are the step's static inputs (`StepBuffers`): tokens,
n_valid, temps, keys, emits, kd and int64 copies of the table and lengths
for the forward. On a CUDA tensor each wrapper launches its kernel; on a CPU
tensor it runs its plain version, the same rules as torch ops over the
port's mega/ring.py (bitwise the JAX functions).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.mega import ring as mring

# header words of the window state block (csrc/ring.cu H_*)
H_PUBLISHED = 0    # records the host has published (input)
H_CONSUMED = 1     # records consumed (input, then the device's count)
H_STEP0 = 2        # the device step the window starts at (input)
H_EXECUTED = 3     # live steps run this window
H_IDLE = 4         # consecutive idle iterations (the poll budget's count)
H_LIVE = 5         # 1 until the loop's cond fails, then 0 (sticky)
H_STEP_LIVE = 6    # this step runs (ring_emit's gate)
H_OUT_COUNT = 7    # output records written
H_STARVED = 8      # the head record was published but never committed
HEADER_WORDS = 16


class WindowGeometry(NamedTuple):
    """The loop's shape: slots K, chunk C, the table's MAXP, the output
    ring's rows, the window W, the poll budget and the verify rows' draft
    cap spec_k (0: the plain loop); and the state block's layout: header
    | slot state (K, 16) | table (K, MAXP) | lengths (K,) | output ring
    (out_cap, 8), int32."""

    slots: int
    chunk: int
    max_pages: int
    out_cap: int
    window: int
    poll_budget: int
    spec_k: int = 0

    @property
    def ss_at(self) -> int:
        return HEADER_WORDS

    @property
    def table_at(self) -> int:
        return self.ss_at + self.slots * mring.SS_WIDTH

    @property
    def lengths_at(self) -> int:
        return self.table_at + self.slots * self.max_pages

    @property
    def out_at(self) -> int:
        """Words before the output ring: what the host writes a window."""
        return self.lengths_at + self.slots

    @property
    def words(self) -> int:
        return self.out_at + self.out_cap * mring.OR_WIDTH

    def views(self, blk: torch.Tensor):
        """(header, slot_state, table, lengths, out_ring) views of blk."""
        K = self.slots
        return (blk[:HEADER_WORDS],
                blk[self.ss_at:self.table_at].view(K, mring.SS_WIDTH),
                blk[self.table_at:self.lengths_at].view(K, self.max_pages),
                blk[self.lengths_at:self.out_at],
                blk[self.out_at:].view(self.out_cap, mring.OR_WIDTH))

    def new_block(self, device) -> torch.Tensor:
        return torch.zeros((self.words,), dtype=torch.int32, device=device)


class StepBuffers(NamedTuple):
    """A step's static inputs, written by ring_boundary: tokens (K, C),
    n_valid (K,), the table (K, MAXP) and lengths (K,) as int64 (the
    forward's), temps (K,) f32, keys (K, 2) int32 ((K, C, 2) with spec_k:
    a key a column), emits (K,) int32 and kd (K,) int32, the drafts each
    row verifies (0 without spec_k)."""

    tokens: torch.Tensor
    n_valid: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    temps: torch.Tensor
    keys: torch.Tensor
    emits: torch.Tensor
    kd: torch.Tensor

    @staticmethod
    def create(geo: WindowGeometry, device) -> "StepBuffers":
        K = geo.slots

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        return StepBuffers(z(K, geo.chunk), z(K), z(K, geo.max_pages), z(K),
                           z(K, dtype=torch.float32),
                           z(*_key_shape(geo), dtype=torch.int32),
                           z(K, dtype=torch.int32), z(K, dtype=torch.int32))


def _key_shape(geo: WindowGeometry):
    return ((geo.slots, geo.chunk, 2) if geo.spec_k
            else (geo.slots, 2))


def _scatter_out(hdr, out, step: int, mask, tokens, flags, reasons, reqids,
                 spares=None):
    """One output record per set slot of mask, in slot order, at the next
    dense seqs (the JAX loop's scatter_out)."""
    for s in torch.nonzero(mask).flatten().tolist():
        row = int(hdr[H_OUT_COUNT])
        if row >= out.shape[0]:
            return
        out[row] = torch.tensor(
            [row + 1, s, step, int(tokens[s]), int(flags[s]),
             int(reasons[s]), int(reqids[s]),
             0 if spares is None else int(spares[s])], dtype=out.dtype)
        hdr[H_OUT_COUNT] = row + 1


def _consume(ring, hdr, ss, tb, ln, out, step: int) -> int:
    """device_consume at `step` into the block, host retirements reported;
    returns the records consumed."""
    c0 = int(hdr[H_CONSUMED])
    c, ss2, tb2, ln2, rt = mring.device_consume(
        ring, int(hdr[H_PUBLISHED]), c0, step, ss, tb, ln)
    ss.copy_(ss2)
    tb.copy_(tb2)
    ln.copy_(ln2)
    K = ss.shape[0]
    _scatter_out(hdr, out, step, rt, [-1] * K, [mring.FLAG_RETIRED] * K,
                 [mring.REASON_HOST] * K, ss[:, mring.SS_REQID])
    hdr[H_CONSUMED] = c
    return c - c0


def _dead(bufs: StepBuffers) -> None:
    for t in (bufs.tokens, bufs.n_valid, bufs.temps, bufs.keys, bufs.emits,
              bufs.kd):
        t.zero_()


def ring_boundary_plain(ring: torch.Tensor, blk: torch.Tensor,
                        geo: WindowGeometry, bufs: StepBuffers,
                        final: bool = False) -> None:
    """The kernel's plain version (the module docstring), in place on blk
    and bufs."""
    hdr, ss, tb, ln, out = geo.views(blk)
    if final:
        _consume(ring, hdr, ss, tb, ln, out,
                 int(hdr[H_STEP0]) + int(hdr[H_EXECUTED]))
        hdr[H_STARVED] = int(mring.head_abandoned(
            ring, int(hdr[H_PUBLISHED]), int(hdr[H_CONSUMED])))
        return
    live = False
    while int(hdr[H_LIVE]):
        executed, idle = int(hdr[H_EXECUTED]), int(hdr[H_IDLE])
        pending = int(hdr[H_CONSUMED]) < int(hdr[H_PUBLISHED])
        if not (executed < geo.window and (
                bool((ss[:, mring.SS_ACTIVE] > 0).any())
                or (pending and idle < geo.poll_budget))):
            hdr[H_LIVE] = 0
            break
        took = _consume(ring, hdr, ss, tb, ln, out,
                        int(hdr[H_STEP0]) + executed)
        if bool((ss[:, mring.SS_ACTIVE] > 0).any()):
            hdr[H_IDLE] = 0
            live = True
            break
        hdr[H_IDLE] = 0 if took > 0 else idle + 1
    hdr[H_STEP_LIVE] = int(live)
    if not live:
        _dead(bufs)
        return
    if geo.spec_k:
        tokens, n_valid, temps, keys, emits, kd = mring.slot_plan_spec(
            ring, ss, geo.chunk, geo.max_pages, geo.spec_k)
        bufs.kd.copy_(kd)
    else:
        tokens, n_valid, temps, keys, emits = mring.slot_plan(
            ring, ss, geo.chunk, geo.max_pages)
    bufs.tokens.copy_(tokens)
    bufs.n_valid.copy_(n_valid)
    bufs.temps.copy_(temps)
    bufs.keys.copy_(keys)  # int64 words in [0, 2^32) wrap into int32
    bufs.emits.copy_(emits)
    bufs.table.copy_(tb)
    bufs.lengths.copy_(ln)


def ring_emit_plain(tok: torch.Tensor, blk: torch.Tensor,
                    geo: WindowGeometry, bufs: StepBuffers) -> None:
    """The kernel's plain version: the step epilogue (the module
    docstring), in place on blk, a no-op on a dead step."""
    hdr, ss, tb, ln, out = geo.views(blk)
    if not int(hdr[H_STEP_LIVE]):
        return
    if geo.spec_k:
        _emit_spec_plain(tok, hdr, ss, ln, out, geo, bufs)
        return
    step = int(hdr[H_STEP0]) + int(hdr[H_EXECUTED])
    n_valid = bufs.n_valid.to(torch.int32)
    emits = bufs.emits > 0
    t = tok.to(torch.int32)
    zero = torch.zeros_like(n_valid)
    ln += n_valid
    prefill = ss[:, mring.SS_PHASE] == 0
    new_pos = ss[:, mring.SS_POS] + torch.where(prefill, n_valid, zero)
    completing = (prefill & (new_pos >= ss[:, mring.SS_PROMPT_LEN])
                  & (ss[:, mring.SS_ACTIVE] > 0))
    n_out = ss[:, mring.SS_N_OUT] + emits.to(torch.int32)
    eos = ss[:, mring.SS_EOS]
    hit_eos = emits & (eos > 0) & (t == eos - 1)
    hit_len = emits & (n_out >= ss[:, mring.SS_MAX_NEW])
    finished = hit_eos | hit_len
    ss[:, mring.SS_POS] = new_pos
    ss[:, mring.SS_PHASE] = torch.where(completing, zero + 1,
                                        ss[:, mring.SS_PHASE])
    ss[:, mring.SS_N_OUT] = n_out
    ss[:, mring.SS_LAST_TOK] = torch.where(emits, t,
                                           ss[:, mring.SS_LAST_TOK])
    ss[:, mring.SS_ACTIVE] = torch.where(finished, zero,
                                         ss[:, mring.SS_ACTIVE])
    flags = (emits.to(torch.int32) * mring.FLAG_EMIT
             + finished.to(torch.int32) * mring.FLAG_RETIRED)
    reasons = torch.where(hit_eos, zero + mring.REASON_EOS,
                          torch.where(hit_len, zero + mring.REASON_LENGTH,
                                      zero))
    _scatter_out(hdr, out, step, emits, t, flags, reasons,
                 ss[:, mring.SS_REQID])
    hdr[H_EXECUTED] += 1


def _emit_spec_plain(tok, hdr, ss, ln, out, geo: WindowGeometry,
                     bufs: StepBuffers) -> None:
    """The spec form of the epilogue (JAX `run_step_spec`'s, rule for
    rule): tok (K, C) the step's per-position tokens. Each row's span of
    spec_k + 1 columns from base = n_valid - 1 - kd: o its tokens, d the
    fed tokens one column on; the accepted drafts are the leading
    o == d within kd, e = accepted + 1 on an emitting row, cut after an
    eos inside the span, then at the budget. Lengths advance by n_valid
    on prefill rows and by e on the rest; the last token is o[e - 1]; the
    staged record is cleared. The records go out j outer, slot inner."""
    step = int(hdr[H_STEP0]) + int(hdr[H_EXECUTED])
    K, C, k = geo.slots, geo.chunk, geo.spec_k
    i32 = torch.int32
    n_valid = bufs.n_valid.to(i32)
    emits = bufs.emits > 0
    kd = bufs.kd.to(i32)
    zero = torch.zeros_like(n_valid)
    prefill = ss[:, mring.SS_PHASE] == 0
    base = (n_valid - 1 - kd).clamp(min=0)
    span = torch.arange(k + 1, dtype=i32)
    cols = (base[:, None] + span[None, :]).clamp(0, C - 1).long()
    o = torch.gather(tok.to(i32).view(K, C), 1, cols)
    d = torch.gather(bufs.tokens.to(i32), 1, (cols + 1).clamp(0, C - 1))
    accept = ((o == d) & (span[None, :] < kd[:, None])).to(i32)
    acc = torch.cumprod(accept, 1).sum(1).to(i32)
    e = torch.where(emits, acc + 1, zero)
    eos = ss[:, mring.SS_EOS]
    hits = (eos[:, None] > 0) & (o == eos[:, None] - 1)
    hit_in = hits & (span[None, :] < e[:, None])
    first = torch.argmax(hit_in.to(i32), 1).to(i32) + 1
    e = torch.where(hit_in.any(1), first, e)
    rem = (ss[:, mring.SS_MAX_NEW] - ss[:, mring.SS_N_OUT]).clamp(min=0)
    e = torch.minimum(e, rem)
    hit_eos = (hits & (span[None, :] < e[:, None])).any(1)
    n_out = ss[:, mring.SS_N_OUT] + e
    hit_len = emits & (e > 0) & ~hit_eos & (n_out >= ss[:, mring.SS_MAX_NEW])
    finished = hit_eos | hit_len
    ln += torch.where(prefill, n_valid, e)
    last_tok = torch.gather(o, 1, (e - 1).clamp(min=0)[:, None].long())[:, 0]
    new_pos = ss[:, mring.SS_POS] + torch.where(prefill, n_valid, zero)
    completing = (prefill & (new_pos >= ss[:, mring.SS_PROMPT_LEN])
                  & (ss[:, mring.SS_ACTIVE] > 0))
    ss[:, mring.SS_POS] = new_pos
    ss[:, mring.SS_PHASE] = torch.where(completing, zero + 1,
                                        ss[:, mring.SS_PHASE])
    ss[:, mring.SS_N_OUT] = n_out
    ss[:, mring.SS_LAST_TOK] = torch.where(e > 0, last_tok,
                                           ss[:, mring.SS_LAST_TOK])
    ss[:, mring.SS_ACTIVE] = torch.where(finished, zero,
                                         ss[:, mring.SS_ACTIVE])
    ss[:, mring.SS_SPEC_K] = 0  # a staged record is verified once
    spec_row = (kd > 0).to(i32)
    for j in range(k + 1):
        m_j = (e > j).to(i32)
        is_last = e - 1 == j
        flags = (m_j * mring.FLAG_EMIT
                 + (is_last & finished).to(i32) * mring.FLAG_RETIRED
                 + m_j * spec_row * mring.FLAG_SPEC)
        reasons = torch.where(
            is_last & hit_eos, zero + mring.REASON_EOS,
            torch.where(is_last & hit_len, zero + mring.REASON_LENGTH, zero))
        spare = spec_row * (kd if j == 0 else zero)
        _scatter_out(hdr, out, step, m_j, o[:, j], flags, reasons,
                     ss[:, mring.SS_REQID], spare)
    hdr[H_EXECUTED] += 1


_SIGNATURES = {
    "ring_boundary_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "ring_emit_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "ring_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# the kernels' slot limit (a bit mask of two words for the retirements)
MAX_SLOTS = 64


def _check(geo: WindowGeometry, ring: torch.Tensor, blk: torch.Tensor,
           bufs: StepBuffers) -> None:
    dev = blk.device
    want = {"tokens": ((geo.slots, geo.chunk), torch.int64),
            "n_valid": ((geo.slots,), torch.int64),
            "table": ((geo.slots, geo.max_pages), torch.int64),
            "lengths": ((geo.slots,), torch.int64),
            "temps": ((geo.slots,), torch.float32),
            "keys": (_key_shape(geo), torch.int32),
            "emits": ((geo.slots,), torch.int32),
            "kd": ((geo.slots,), torch.int32)}
    for name, t in zip(StepBuffers._fields, bufs):
        shape, dt = want[name]
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"step buffer {name}: {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, want a "
                             f"contiguous {dt} {shape} on {dev}")
    if blk.dtype != torch.int32 or blk.shape != (geo.words,) \
            or not blk.is_contiguous():
        raise ValueError(f"state block {blk.dtype} {tuple(blk.shape)}, want "
                         f"int32 ({geo.words},)")
    if ring is not None and (ring.device != dev or ring.dtype != torch.int32
                             or ring.dim() != 2 or not ring.is_contiguous()):
        raise ValueError("the injection ring must be a contiguous int32 "
                         f"(cap, RW) tensor on {dev}")
    if not 1 <= geo.slots <= MAX_SLOTS:
        raise ValueError(f"{geo.slots} slots: the ring kernels take 1 to "
                         f"{MAX_SLOTS}")
    if not 0 <= geo.spec_k < geo.chunk:
        raise ValueError(f"spec_k {geo.spec_k}: a verify row needs spec_k "
                         f"+ 1 <= chunk {geo.chunk}")


@_build.counted("ring_boundary")
def ring_boundary(ring: torch.Tensor, blk: torch.Tensor,
                  geo: WindowGeometry, bufs: StepBuffers,
                  final: bool = False) -> None:
    """The step boundary (the module docstring): the CUDA kernel of
    csrc/ring.cu on a CUDA tensor, the plain version on a CPU tensor."""
    if blk.device.type == "cpu":
        ring_boundary_plain(ring, blk, geo, bufs, final)
        return
    _check(geo, ring, blk, bufs)
    dev = blk.device
    lib = _build.load("ring", _SIGNATURES)
    with _build.on_device(dev):
        err = lib.ring_boundary_launch(
            ring.data_ptr(), ring.shape[0], ring.shape[1], blk.data_ptr(),
            geo.slots, geo.max_pages, geo.out_cap, geo.chunk, geo.window,
            geo.poll_budget, geo.spec_k, int(final), bufs.tokens.data_ptr(),
            bufs.n_valid.data_ptr(), bufs.temps.data_ptr(),
            bufs.keys.data_ptr(), bufs.emits.data_ptr(), bufs.kd.data_ptr(),
            bufs.table.data_ptr(), bufs.lengths.data_ptr(),
            _build.raw_stream(dev))
    _build.check("ring_boundary", err, lib.ring_error_string)
    _build.count_launch("ring_boundary")


@_build.counted("ring_emit")
def ring_emit(tok: torch.Tensor, blk: torch.Tensor, geo: WindowGeometry,
              bufs: StepBuffers) -> None:
    """The step epilogue (the module docstring): the CUDA kernel of
    csrc/ring.cu on a CUDA tensor (tok (K,) int64, with spec_k the (K, C)
    per-position tokens), the plain version on a CPU tensor."""
    if blk.device.type == "cpu":
        ring_emit_plain(tok, blk, geo, bufs)
        return
    _check(geo, None, blk, bufs)
    dev = blk.device
    shape = (geo.slots, geo.chunk) if geo.spec_k else (geo.slots,)
    if tok.device != dev or tok.dtype != torch.int64 \
            or tuple(tok.shape) != shape or not tok.is_contiguous():
        raise ValueError(f"ring_emit: tok must be a contiguous int64 "
                         f"{shape} on {dev}")
    lib = _build.load("ring", _SIGNATURES)
    with _build.on_device(dev):
        err = lib.ring_emit_launch(
            tok.data_ptr(), blk.data_ptr(), geo.slots, geo.max_pages,
            geo.out_cap, geo.chunk, geo.spec_k, bufs.n_valid.data_ptr(),
            bufs.emits.data_ptr(), bufs.tokens.data_ptr(),
            bufs.kd.data_ptr(), _build.raw_stream(dev))
    _build.check("ring_emit", err, lib.ring_error_string)
    _build.count_launch("ring_emit")

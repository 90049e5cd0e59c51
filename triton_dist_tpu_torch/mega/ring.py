"""The work-injection ring of the resident serving loop — port of
triton_dist_tpu.mega.ring.

Two mirrored rings, as in the JAX package:

  injection ring  (cap, RW) int32, host-written admission / retirement
                  records, consumed at step boundaries in publication
                  order. A record is a fixed header, the slot's page-table
                  row (the host reserves every page the request can touch
                  at admission) and the prompt tokens, padded by one chunk.
  output ring     (out_cap, OW) int32, device-written completion records
                  (emitted tokens and retirement flags), drained by the
                  host after each window.

`IR_SEQ` is the field the host commits last: a record is visible only
when its seq equals consumed + 1, and a published but never committed
head record is an abandoned ring, which the loop reports as `starved`
instead of spinning. `IR_AT_STEP` gates a visible record on the device
step counter, so an admission can land inside a window.

The record and slot-state layouts below are the JAX module's, copied
(the port imports nothing of the JAX package). `InjectionRing` is the
host producer; `device_consume` and `slot_plan` are the step boundary's
plain versions as torch ops, bitwise the JAX functions on the same
int32 inputs (the CUDA kernels of kernels/ring.py take their place on
the card). Not ported: `InjectionRing.verify` and `slot_plan_spec`
(speculative decoding, ROADMAP item 5) and an admission prefix > 0
(the prefix cache, item 4): `admit` refuses one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from triton_dist_tpu_torch.kernels.sample import MASK, threefry2x32

# -- injection record header (int32 fields) ----------------------------------

IR_SEQ = 0         # 1-based publication seq; 0 = never written (the gate)
IR_KIND = 1        # KIND_* below
IR_SLOT = 2        # target slot lane
IR_AT_STEP = 3     # device step this record becomes consumable at
IR_PROMPT_LEN = 4  # admission: tokens to prefill (full history)
IR_MAX_NEW = 5     # admission: output-token budget
IR_TEMP_BITS = 6   # admission: f32 temperature bit pattern
IR_SEED = 7        # admission: sampling seed (per-request key stream)
IR_EOS = 8         # admission: eos_id + 1; 0 = no eos stop
IR_REQID = 9       # request id (echoed in output records)
IR_NOUT = 10       # verify: the n_out the drafts were proposed at
IR_SPEC_K = 11     # verify: number of staged draft tokens
IR_PREFIX = 12     # admission: prefix-cache hit length
IR_HEADER = 16     # header words reserved

KIND_NOOP = 0      # consumed, no effect
KIND_ADMIT = 1
KIND_RETIRE = 2
KIND_VERIFY = 3    # spec-verify records (staged on the slot, ROADMAP item 5)

# -- device-to-host output record (int32 fields) -----------------------------

OR_SEQ = 0         # 1-based, dense: the host drains in seq order
OR_SLOT = 1
OR_STEP = 2        # device step the record was written at
OR_TOKEN = 3       # emitted token (-1 on a token-less retirement)
OR_FLAGS = 4       # FLAG_* bits
OR_REASON = 5      # REASON_* on retirement rows
OR_REQID = 6
OR_SPEC_K = 7      # spec-verify steps' proposed count (0 here)
OR_WIDTH = 8

FLAG_EMIT = 1      # the record carries a sampled token
FLAG_RETIRED = 2   # the slot retired at this record
FLAG_SPEC = 4      # the token came out of a spec-verify step

REASON_EOS = 1
REASON_LENGTH = 2
REASON_HOST = 3    # host-injected retirement

# -- device slot-state row (K, SS_WIDTH) int32 -------------------------------

SS_ACTIVE = 0
SS_PHASE = 1       # 0 = prefill, 1 = decode
SS_POS = 2         # prefill progress (tokens already fed)
SS_PROMPT_LEN = 3
SS_MAX_NEW = 4
SS_N_OUT = 5       # tokens emitted so far (the sampling-key index)
SS_TEMP_BITS = 6
SS_SEED = 7
SS_EOS = 8         # eos_id + 1; 0 = none
SS_LAST_TOK = 9    # decode input (the previous emission)
SS_REC = 10        # ring row of the admission record (prompt source)
SS_REQID = 11
SS_SPEC_REC = 12   # a staged verify record's ring row
SS_SPEC_SEQ = 13   # its seq
SS_SPEC_K = 14     # its draft count; 0 = none
SS_WIDTH = 16


def ring_width(max_pages: int, prompt_cap: int, chunk: int) -> int:
    """Record width: header + page-table row + prompt region, the prompt
    region one chunk longer than the cap so a chunk read at the last
    prefill position never runs past the row."""
    return IR_HEADER + max_pages + prompt_cap + chunk


class OutRecord(NamedTuple):
    """One decoded output-ring record (host side)."""

    seq: int
    slot: int
    step: int
    token: int
    flags: int
    reason: int
    req_id: int
    spec_k: int = 0

    @property
    def emitted(self) -> bool:
        return bool(self.flags & FLAG_EMIT)

    @property
    def retired(self) -> bool:
        return bool(self.flags & FLAG_RETIRED)

    @property
    def spec(self) -> bool:
        return bool(self.flags & FLAG_SPEC)


def decode_out_ring(buf, count: int) -> List[OutRecord]:
    """Decode the first `count` output records; a seq that is not dense
    and 1-based raises (the device scatter broke)."""
    a = np.asarray(buf)
    if a.ndim != 2 or a.shape[1] != OR_WIDTH:
        raise ValueError(f"bad out ring {a.shape}")
    if not 0 <= count <= a.shape[0]:
        raise ValueError(f"out count {count} vs cap {a.shape[0]}")
    out = []
    for i in range(count):
        r = a[i]
        if int(r[OR_SEQ]) != i + 1:
            raise ValueError(
                f"output ring row {i} carries seq {int(r[OR_SEQ])} "
                f"(expected {i + 1}): device scatter drift")
        out.append(OutRecord(*(int(x) for x in r[:OR_WIDTH])))
    return out


def summarize_records(records) -> dict:
    """Per-request roll-up of drained output records:
    {req_id: {"emits", "first_step", "last_step", "retired", "reason"}}."""
    out: dict = {}
    for r in records:
        d = out.setdefault(r.req_id, {
            "emits": 0, "first_step": r.step, "last_step": r.step,
            "retired": False, "reason": 0})
        d["first_step"] = min(d["first_step"], r.step)
        d["last_step"] = max(d["last_step"], r.step)
        if r.emitted:
            d["emits"] += 1
        if r.retired:
            d["retired"] = True
            d["reason"] = r.reason
    return out


# -- host producer ------------------------------------------------------------


class InjectionRing:
    """Host producer of injection records (numpy). `published` counts
    committed records; the device's `consumed` comes back after each
    window (`ack`), and the producer refuses to overwrite a row that is
    unconsumed or pinned (a loud overflow).

    Every field of a row is written before its seq. An admission row is
    read for as long as its slot prefills (slot_plan streams the prompt
    chunks from it), long after the record was consumed: each admission
    pins its row (by req_id) until `unpin`, which the consumer calls once
    the request's first emission or retirement comes back. `version`
    counts the mutations of `buf` (the device copy's cache key)."""

    def __init__(self, cap: int, max_pages: int, prompt_cap: int,
                 chunk: int):
        if cap < 2 or max_pages < 1 or prompt_cap < 1:
            raise ValueError("ring needs cap >= 2, max_pages >= 1, "
                             "prompt_cap >= 1")
        self.cap = cap
        self.max_pages = max_pages
        self.prompt_cap = prompt_cap
        self.chunk = chunk
        self.width = ring_width(max_pages, prompt_cap, chunk)
        self.buf = np.zeros((cap, self.width), np.int32)
        self.published = 0
        self.consumed = 0
        self.version = 0
        self._pins: dict = {}  # req_id -> admission record seq (1-based)

    def pending(self) -> int:
        return self.published - self.consumed

    def _reclaimable(self) -> int:
        """Records whose rows may be overwritten: consumed and not pinned
        (rows recycle in FIFO order, so the oldest pin caps the mark)."""
        floor = self.consumed
        if self._pins:
            floor = min(floor, min(self._pins.values()) - 1)
        return floor

    def can_claim(self) -> bool:
        """Room for one more record (the producer's backpressure probe)."""
        return self.published - self._reclaimable() < self.cap

    def unpin(self, req_id: int) -> None:
        """Release an admission row: its prefill completed or it retired."""
        self._pins.pop(req_id, None)

    def _claim_row(self) -> int:
        if not self.can_claim():
            raise RuntimeError(
                f"injection ring overflow: {self.pending()} pending + "
                f"{len(self._pins)} pinned record(s) at cap {self.cap} "
                "(device not consuming, or a prefill still streaming "
                "from its admission row)")
        return self.published % self.cap

    def _commit(self, row: int) -> None:
        self.buf[row, IR_SEQ] = self.published + 1
        self.published += 1
        self.version += 1

    def admit(self, slot: int, prompt, max_new: int, temperature: float,
              seed: int, eos_id: Optional[int], req_id: int,
              table_row, at_step: int = 0, prefix: int = 0) -> None:
        prompt = np.asarray(prompt, np.int32)
        if not (prompt.ndim == 1 and 1 <= prompt.size <= self.prompt_cap):
            raise ValueError(f"prompt of {prompt.size} tokens vs cap "
                             f"{self.prompt_cap}")
        if prefix:
            raise NotImplementedError(
                "an admission prefix > 0 needs the prefix cache "
                "(ROADMAP item 4)")
        table_row = np.asarray(table_row, np.int32)
        if table_row.shape != (self.max_pages,):
            raise ValueError(f"table row {table_row.shape} != "
                             f"({self.max_pages},)")
        row = self._claim_row()
        r = self.buf[row]
        r[:] = 0
        r[IR_KIND] = KIND_ADMIT
        r[IR_SLOT] = slot
        r[IR_AT_STEP] = at_step
        r[IR_PROMPT_LEN] = prompt.size
        r[IR_MAX_NEW] = max_new
        r[IR_TEMP_BITS] = np.float32(temperature).view(np.int32)
        r[IR_SEED] = seed
        r[IR_EOS] = 0 if eos_id is None else eos_id + 1
        r[IR_REQID] = req_id
        r[IR_PREFIX] = prefix
        r[IR_HEADER:IR_HEADER + self.max_pages] = table_row
        r[IR_HEADER + self.max_pages:
          IR_HEADER + self.max_pages + prompt.size] = prompt
        self._commit(row)
        self._pins[req_id] = self.published  # this record's seq

    def retire(self, slot: int, req_id: int, at_step: int = 0) -> None:
        row = self._claim_row()
        r = self.buf[row]
        r[:] = 0
        r[IR_KIND] = KIND_RETIRE
        r[IR_SLOT] = slot
        r[IR_AT_STEP] = at_step
        r[IR_REQID] = req_id
        self._commit(row)

    def abandon(self) -> None:
        """Publish without committing the record (seq stays stale): the
        torn-write / crashed-producer fault. The loop must exit its
        bounded poll with `starved` set, never consume the row."""
        row = self._claim_row()
        self.buf[row, IR_SEQ] = 0
        self.published += 1
        self.version += 1

    def ack(self, consumed: int) -> None:
        """Fold the device's post-window consumed count back in."""
        if not self.consumed <= consumed <= self.published:
            raise ValueError(f"device consumed {consumed} outside "
                             f"[{self.consumed}, {self.published}]")
        self.consumed = consumed


# -- the step boundary's plain versions (torch ops) ---------------------------


def _i(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def head_visible(ring, published, consumed, step) -> bool:
    """Is the head record consumable now? (seq committed, at_step open.)"""
    published, consumed, step = _i(published), _i(consumed), _i(step)
    head = ring[consumed % ring.shape[0]]
    return (consumed < published and _i(head[IR_SEQ]) == consumed + 1
            and _i(head[IR_AT_STEP]) <= step)


def head_abandoned(ring, published, consumed) -> bool:
    """Pending but not committed: the head row's seq is not the next
    publication number (torn write / crashed producer)."""
    published, consumed = _i(published), _i(consumed)
    head = ring[consumed % ring.shape[0]]
    return consumed < published and _i(head[IR_SEQ]) != consumed + 1


def device_consume(ring: torch.Tensor, published, consumed, step,
                   slot_state: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor):
    """Consume every visible record at a step boundary (the JAX
    function's rules): ADMIT loads the slot row, installs the record's
    table row and starts the length at the record's prefix; RETIRE
    deactivates iff the record's req_id is the slot's (else a no-op);
    VERIFY stages the drafts iff the slot still serves that req_id at
    that n_out in decode. Returns (consumed, slot_state, table, lengths,
    retired (K,) int32), new tensors."""
    cap = ring.shape[0]
    max_pages = table.shape[1]
    ss, tb, ln = slot_state.clone(), table.clone(), lengths.clone()
    retired = torch.zeros((ss.shape[0],), dtype=torch.int32,
                          device=ss.device)
    consumed = _i(consumed)
    while head_visible(ring, published, consumed, step):
        rec_row = consumed % cap
        rec = ring[rec_row]
        slot = _i(rec[IR_SLOT])
        kind = _i(rec[IR_KIND])
        row = ss[slot]
        if kind == KIND_ADMIT:
            new = torch.zeros_like(row)
            for f, v in ((SS_ACTIVE, 1), (SS_POS, rec[IR_PREFIX]),
                         (SS_PROMPT_LEN, rec[IR_PROMPT_LEN]),
                         (SS_MAX_NEW, rec[IR_MAX_NEW]),
                         (SS_TEMP_BITS, rec[IR_TEMP_BITS]),
                         (SS_SEED, rec[IR_SEED]), (SS_EOS, rec[IR_EOS]),
                         (SS_REC, rec_row), (SS_REQID, rec[IR_REQID])):
                new[f] = v
            ss[slot] = new
            tb[slot] = rec[IR_HEADER:IR_HEADER + max_pages].to(tb.dtype)
            ln[slot] = rec[IR_PREFIX]
        elif (kind == KIND_RETIRE and _i(row[SS_ACTIVE]) > 0
              and _i(row[SS_REQID]) == _i(rec[IR_REQID])):
            ss[slot, SS_ACTIVE] = 0
            retired[slot] = 1
        elif (kind == KIND_VERIFY and _i(row[SS_ACTIVE]) > 0
              and _i(row[SS_PHASE]) == 1
              and _i(row[SS_REQID]) == _i(rec[IR_REQID])
              and _i(row[SS_N_OUT]) == _i(rec[IR_NOUT])):
            ss[slot, SS_SPEC_REC] = rec_row
            ss[slot, SS_SPEC_SEQ] = rec[IR_SEQ]
            ss[slot, SS_SPEC_K] = rec[IR_SPEC_K]
        consumed += 1
    return consumed, ss, tb, ln, retired


def slot_keys(seed: torch.Tensor, n_out: torch.Tensor) -> torch.Tensor:
    """fold_in(PRNGKey(seed), n_out) of int32 seeds and indices: (K, 2)
    int64 words in [0, 2^32) (the JAX derivation: PRNGKey of an int32 is
    (0, seed as uint32))."""
    s = seed.to(torch.int64) & MASK
    d = n_out.to(torch.int64) & MASK
    x0, x1 = threefry2x32(torch.zeros_like(s), s, torch.zeros_like(d), d)
    return torch.stack([x0, x1], -1)


def slot_plan(ring: torch.Tensor, slot_state: torch.Tensor, chunk: int,
              max_pages: int):
    """The step's per-slot inputs from the slot state, what the host-loop
    Scheduler builds each step (the JAX function's rules):

      tokens (K, C) int32  prefill chunk (streamed from the admission
                           record's prompt region) or [last_tok, 0, ...]
      n_valid (K,) int32   chunk fill / 1 / 0 (inactive)
      temps (K,) f32       the temperature on emitting rows, else 0
      keys (K, 2) int64    fold_in(PRNGKey(seed), n_out) words on
                           emitting rows, else 0
      emits (K,) bool      the row's sampled token is meaningful
    """
    ss = slot_state
    dev = ss.device
    prompt_base = IR_HEADER + max_pages
    width = ring.shape[1]
    active = ss[:, SS_ACTIVE] > 0
    prefill = ss[:, SS_PHASE] == 0
    pos = ss[:, SS_POS]
    plen = ss[:, SS_PROMPT_LEN]
    n_pref = torch.minimum(torch.full_like(pos, chunk), plen - pos)
    # dynamic_slice clamps its start so the chunk fits in the row
    start = (prompt_base + pos.long()).clamp(0, width - chunk)
    cols = torch.arange(chunk, device=dev)
    recs = ring[ss[:, SS_REC].long()]  # (K, RW)
    prow = torch.gather(recs, 1, start[:, None] + cols[None, :])
    drow = torch.zeros_like(prow)
    drow[:, 0] = ss[:, SS_LAST_TOK]
    tokens = torch.where(prefill[:, None], prow, drow)
    n = torch.where(prefill, n_pref, torch.ones_like(n_pref))
    n = torch.where(active, n, torch.zeros_like(n))
    tokens = torch.where(active[:, None] & (cols[None, :] < n[:, None]),
                         tokens, torch.zeros_like(tokens))
    emits = active & (~prefill | (pos + n_pref >= plen))
    temps = torch.where(emits, ss[:, SS_TEMP_BITS].view(torch.float32),
                        torch.zeros((), dtype=torch.float32, device=dev))
    keys = slot_keys(ss[:, SS_SEED], ss[:, SS_N_OUT])
    keys = torch.where(emits[:, None], keys, torch.zeros_like(keys))
    return (tokens.to(torch.int32), n.to(torch.int32), temps, keys, emits)

"""Speculative decoding on the paged serve plane — port of
triton_dist_tpu.spec.

A decode step of the fixed (slots, chunk) geometry pays for chunk
columns whether it feeds one token or k + 1, so a decoding slot can
carry k proposed tokens and be scored in the same step. `spec.draft`
proposes them (`NgramDraft`: prompt lookup over the request's own
history; `Draft` is the protocol), the per-position serve step
(`Engine.make_serve_step(..., per_pos=True)`) samples every column
under its own (seed, token index) key, and `spec.verify` keeps the
longest proposed prefix the model agrees with, plus the model's next
token. Column j's token is the one sequential decode would emit after
the row's first j + 1 tokens, so every emitted token is bitwise the
sequential stream's, greedy and sampled.

Wired through `serve.Scheduler(spec=SpecConfig(k))`: verify rows beside
prefill and decode rows in the host loop, and in the resident loop
KIND_VERIFY injection records (mega/ring.py) that the window's
`ring_boundary` turns into verify rows. k = 0 turns it off.
"""

from triton_dist_tpu_torch.spec.draft import Draft, NgramDraft  # noqa: F401
from triton_dist_tpu_torch.spec.verify import (  # noqa: F401
    SpecConfig,
    accept_tokens,
    draft_cap,
    verify_keys,
)

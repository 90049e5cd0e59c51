"""KVPool — port of triton_dist_tpu.serve.kv_pool (allocator core).

Shared paged KV storage over `slots` concurrency lanes of the serve
step. k/v are page pools in the layout (L, Hkv, P, page, D) on the
engine's device; the page table maps each slot's page grid onto pool
pages. Lifecycle: allocate-on-admit, grow-per-chunk (`ensure`),
free-on-finish and eviction (`release`).

Page 0 is reserved (the null page): unallocated table entries point at
it and the serve step routes padding-column KV writes to it, so a
garbage write never lands on another sequence's page. The allocator
hands out pages [1, P); `capacity` excludes page 0. Pages carry
refcounts (1 while a slot holds them, 0 on the free list); the JAX
version's sharing, copy-on-write and page export paths belong to the
prefix and migration planes, which are not ported. `as_mega_cache`
hands the pool to the megakernel's paged decode.

Bookkeeping (free list, page lists, table, lengths) is host numpy, read
by the scheduler every step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def pages_for(n_tokens: int, page: int) -> int:
    """ceil(n_tokens / page) — the page demand of a sequence."""
    return -(-n_tokens // page)


class PoolExhausted(RuntimeError):
    """No free pages (and the caller chose not to evict)."""


class KVPool:
    """Shared paged KV pool. total_pages counts allocatable pages (the
    null page is added on top); it defaults to full provisioning
    (slots * max_pages), and a smaller pool oversubscribes, with
    eviction as the pressure valve."""

    def __init__(self, engine, slots: int, page: int,
                 total_pages: Optional[int] = None):
        cfg = engine.cfg
        if engine.max_len % page:
            raise ValueError(f"page {page} must divide the engine horizon "
                             f"{engine.max_len}")
        self.slots = slots
        self.page = page
        self.max_pages = engine.max_len // page
        self.t_max = self.max_pages * page
        self.capacity = (total_pages if total_pages is not None
                         else slots * self.max_pages)
        if self.capacity < 1:
            raise ValueError("pool needs at least one page")
        shape = (cfg.num_layers, cfg.num_kv_heads, 1 + self.capacity, page,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=cfg.torch_dtype,
                             device=engine.device)
        self.v = torch.zeros_like(self.k)

        self.table = np.zeros((slots, self.max_pages), np.int64)
        self.lengths = np.zeros((slots,), np.int64)
        self._free: List[int] = list(range(self.capacity, 0, -1))  # pop=1 first
        self._pages: List[Optional[List[int]]] = [None] * slots  # None=free
        self._refs = np.zeros((1 + self.capacity,), np.int32)

    # -- queries --------------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self, slot: Optional[int] = None) -> int:
        if slot is not None:
            ps = self._pages[slot]
            return 0 if ps is None else len(ps)
        return sum(len(p) for p in self._pages if p is not None)

    def free_slot(self) -> Optional[int]:
        for s, p in enumerate(self._pages):
            if p is None:
                return s
        return None

    def check(self) -> None:
        """Allocator invariants: each held page is held once and has
        refcount 1, the free list is exactly the refcount-0 pages, every
        slot's table row matches its page list, and the null page is
        held nowhere."""
        held = [pg for ps in self._pages if ps is not None for pg in ps]
        assert 0 not in held and 0 not in self._free, (
            "null page leaked into the allocator")
        assert len(held) == len(set(held)), "page held by two slots"
        for s, ps in enumerate(self._pages):
            if ps is not None:
                assert list(self.table[s, :len(ps)]) == ps, (
                    f"slot {s} table drifted from its page list")
        assert len(self._free) == len(set(self._free)), (
            "page aliased within the free list")
        assert sorted(held + self._free) == list(
            range(1, self.capacity + 1)), "page leaked"
        assert all(self._refs[pg] == 1 for pg in held)
        assert all(self._refs[pg] == 0 for pg in self._free)

    # -- lifecycle ------------------------------------------------------

    def _alloc(self, need: int) -> List[int]:
        assert need <= len(self._free)
        new = [self._free.pop() for _ in range(need)]
        self._refs[new] = 1
        return new

    def admit(self, slot: int, n_tokens: int) -> None:
        """Claim `slot` and allocate pages for an n_tokens history, all
        or nothing (raises PoolExhausted)."""
        assert self._pages[slot] is None, f"slot {slot} already in use"
        need = max(pages_for(n_tokens, self.page), 1)
        assert need <= self.max_pages, (
            f"{n_tokens} tokens need {need} pages > table width "
            f"{self.max_pages}")
        if need > len(self._free):
            raise PoolExhausted(f"need {need} pages, {len(self._free)} free")
        self._pages[slot] = self._alloc(need)
        self.table[slot, :need] = self._pages[slot]
        self.lengths[slot] = 0

    def ensure(self, slot: int, upto_tokens: int) -> bool:
        """Grow `slot`'s pages to cover `upto_tokens`, all or nothing.
        False = exhausted; the scheduler then evicts or stalls the slot."""
        ps = self._pages[slot]
        assert ps is not None, f"slot {slot} is not admitted"
        need = pages_for(upto_tokens, self.page) - len(ps)
        if need <= 0:
            return True
        assert len(ps) + need <= self.max_pages, (
            f"slot {slot}: {upto_tokens} tokens exceed the "
            f"{self.max_pages}-page table")
        if need > len(self._free):
            return False
        new = self._alloc(need)
        self.table[slot, len(ps):len(ps) + need] = new
        ps.extend(new)
        return True

    def release(self, slot: int) -> None:
        """Free `slot` and its pages (free-on-finish / eviction)."""
        ps = self._pages[slot]
        assert ps is not None, f"double free of slot {slot}"
        for p in reversed(ps):
            self._refs[p] -= 1
            assert self._refs[p] == 0, f"over-release of page {p}"
            self._free.append(p)
        self._pages[slot] = None
        self.table[slot] = 0
        self.lengths[slot] = 0

    def as_mega_cache(self):
        """The pool as a mega.qwen3.PagedMegaKVCache (JAX kv_pool.py:378):
        the layouts are the same, so the megakernel's paged decode runs
        over serve-plane state. k / v are the pool's own tensors; the
        table and lengths are int32 copies on the pool's device; the
        megakernel's bump allocator resumes past the highest page held
        (it does not see pages freed back to this pool: an export is a
        decode handoff, not shared ownership)."""
        from triton_dist_tpu_torch.mega.qwen3 import PagedMegaKVCache

        dev = self.k.device
        high = max((max(ps) for ps in self._pages if ps), default=0)
        return PagedMegaKVCache(
            k=self.k, v=self.v,
            table=torch.as_tensor(self.table.astype(np.int32), device=dev),
            length=torch.as_tensor(self.lengths.astype(np.int32),
                                   device=dev),
            next_free=torch.tensor(high + 1, dtype=torch.int32, device=dev))

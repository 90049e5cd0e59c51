"""KVPool — port of triton_dist_tpu.serve.kv_pool.

Shared paged KV storage over `slots` concurrency lanes of the serve
step. k/v are page pools in the layout (L, Hkv, P, page, D) on the
engine's device; the page table maps each slot's page grid onto pool
pages. Lifecycle: allocate-on-admit, grow-per-chunk (`ensure`),
free-on-finish and eviction (`release`).

Page 0 is reserved (the null page): unallocated table entries point at
it and the serve step routes padding-column KV writes to it, so a
garbage write never lands on another sequence's page. The allocator
hands out pages [1, P); `capacity` excludes page 0.

Sharing (the prefix plane, serve/prefix.py): pages are refcounted. A
fresh page has refcount 1 (its slot); `ref_pages` lets an external
holder (the prefix cache) keep pages past their slot's lifetime, and
`share` admits a slot whose leading pages are another holder's. A
shared page is only read: the serve step writes at positions >=
lengths and a shared prefix ends on a page boundary at or below them;
`cow` gives a slot a private copy for a caller that breaks that.
`release` / `unref_pages` decrement, and a page returns to the free list
only at refcount 0. `check()` asserts that every page's refcount equals
its holders (slot-table occurrences plus external holds) and that the
free list is exactly the refcount-0 pages. `export_pages` / `install`
move a slot's pages as host numpy (the migration image), `to_dense`
gathers the pool into a dense KVCache and `as_mega_cache` hands it to
the megakernel's paged decode.

Bookkeeping (free list, page lists, table, lengths, refcounts) is host
numpy, read by the scheduler every step. `cow` and `install` write
`k` / `v` in place: the captured serve step and the resident loop's
graphs hold those tensors. Every entry point raises before it touches
any state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
        self.world = engine.world.n
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
        # refcount a page (index 0, the null page, stays 0): its holders,
        # slot-table occurrences plus external holds; 0 <=> free
        self._refs = np.zeros((1 + self.capacity,), np.int32)
        self._ext: Dict[int, int] = {}  # page -> external hold count

    # -- queries --------------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self, slot: Optional[int] = None) -> int:
        """Pages held by a slot (or all slots); a page shared by two slots
        counts once a holder (table occupancy; free_pages reads the
        distinct-page pressure)."""
        if slot is not None:
            ps = self._pages[slot]
            return 0 if ps is None else len(ps)
        return sum(len(p) for p in self._pages if p is not None)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def shared_pages(self) -> int:
        """Distinct pages with refcount > 1 (the sharing win)."""
        return int(np.sum(self._refs > 1))

    def free_slot(self) -> Optional[int]:
        for s, p in enumerate(self._pages):
            if p is None:
                return s
        return None

    def check(self) -> None:
        """Allocator invariants: every page's refcount equals its holder
        count (slot-table occurrences + external holds), the free list is
        exactly the refcount-0 pages (each once), a page appears at most
        once a slot, every slot's table row matches its page list, and
        the null page is held nowhere."""
        held = [pg for ps in self._pages if ps is not None for pg in ps]
        assert 0 not in held and 0 not in self._free, (
            "null page leaked into the allocator")
        assert 0 not in self._ext and all(
            v > 0 for v in self._ext.values()), (
            f"malformed external holds {self._ext}")
        for s, ps in enumerate(self._pages):
            if ps is not None:
                assert len(ps) == len(set(ps)), (
                    f"page aliased within slot {s}: {ps}")
                assert list(self.table[s, :len(ps)]) == ps, (
                    f"slot {s} table drifted from its page list")
        assert len(self._free) == len(set(self._free)), (
            "page aliased within the free list")
        holders = np.zeros_like(self._refs)
        for pg in held:
            holders[pg] += 1
        for pg, n in self._ext.items():
            holders[pg] += n
        assert np.array_equal(holders, self._refs), (
            "refcount drift: holders "
            f"{np.flatnonzero(holders != self._refs)}")
        free_set = set(self._free)
        for pg in range(1, self.capacity + 1):
            if self._refs[pg] == 0:
                assert pg in free_set, f"page {pg} leaked (ref 0, not free)"
            else:
                assert pg not in free_set, (
                    f"page {pg} aliased: refcount {self._refs[pg]} but on "
                    "the free list")

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

    def share(self, slot: int, shared: Sequence[int], n_tokens: int) -> None:
        """Claim `slot` with its leading pages shared from another holder
        (a prefix-cache hit): each page of `shared` is increfed into the
        slot's table, fresh pages cover the rest of an n_tokens history,
        and the slot's length starts at the shared coverage (len(shared)
        * page tokens of KV already live in those pages). All or nothing,
        as admit."""
        assert self._pages[slot] is None, f"slot {slot} already in use"
        shared = [int(p) for p in shared]
        assert all(1 <= p <= self.capacity and self._refs[p] >= 1
                   for p in shared), f"sharing unheld page(s) {shared}"
        assert len(shared) == len(set(shared)), f"aliased share {shared}"
        need_total = max(pages_for(n_tokens, self.page), 1, len(shared))
        assert need_total <= self.max_pages, (
            f"{n_tokens} tokens need {need_total} pages > table width "
            f"{self.max_pages}")
        fresh = need_total - len(shared)
        if fresh > len(self._free):
            raise PoolExhausted(f"need {fresh} fresh pages, "
                                f"{len(self._free)} free")
        self._refs[shared] += 1
        ps = shared + self._alloc(fresh)
        self._pages[slot] = ps
        self.table[slot, :len(ps)] = ps
        self.lengths[slot] = len(shared) * self.page

    def ref_pages(self, pages: Sequence[int]) -> None:
        """External hold (the prefix cache keeping pages): increfs each
        page so that release or eviction never frees it."""
        pages = [int(p) for p in pages]
        for p in pages:
            assert 1 <= p <= self.capacity and self._refs[p] >= 1, (
                f"external ref of unheld page {p}")
        for p in pages:
            self._refs[p] += 1
            self._ext[p] = self._ext.get(p, 0) + 1

    def unref_pages(self, pages: Sequence[int]) -> int:
        """Drop an external hold; pages reaching refcount 0 return to the
        free list. Returns the number of pages freed."""
        pages = [int(p) for p in pages]
        need: Dict[int, int] = {}
        for p in pages:
            need[p] = need.get(p, 0) + 1
        for p, n in need.items():
            assert self._ext.get(p, 0) >= n, (
                f"external unref of page {p} without a hold")
        freed = 0
        for p in pages:
            self._ext[p] -= 1
            if self._ext[p] == 0:
                del self._ext[p]
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def cow(self, slot: int, page_idx: int) -> int:
        """Copy-on-write: give `slot` a private copy of its `page_idx`-th
        page. A no-op (returns the page) when the slot is its only
        holder; else a fresh page gets the k/v rows (written in place),
        takes the original's place in the slot's table, and the slot's
        hold on the original drops. Returns the (possibly new) page id;
        raises PoolExhausted when no page is free for the copy."""
        ps = self._pages[slot]
        assert ps is not None, f"slot {slot} is not admitted"
        assert 0 <= page_idx < len(ps)
        old = ps[page_idx]
        if self._refs[old] == 1:
            return old
        if not self._free:
            raise PoolExhausted("no free page for the COW copy")
        (new,) = self._alloc(1)
        self.k[:, :, new] = self.k[:, :, old]
        self.v[:, :, new] = self.v[:, :, old]
        ps[page_idx] = new
        self.table[slot, page_idx] = new
        self._refs[old] -= 1
        return new

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
        """Free `slot`: drop its hold on every page (free-on-finish /
        eviction). Pages still held elsewhere (another slot, the prefix
        cache) survive; only refcount-0 pages return to the free list."""
        ps = self._pages[slot]
        assert ps is not None, f"double free of slot {slot}"
        for p in reversed(ps):
            self._refs[p] -= 1
            assert self._refs[p] >= 0, f"over-release of page {p}"
            if self._refs[p] == 0:
                self._free.append(p)
        self._pages[slot] = None
        self.table[slot] = 0
        self.lengths[slot] = 0

    # -- export ---------------------------------------------------------

    def export_pages(self, slot: int, n_tokens: Optional[int] = None):
        """`slot`'s live KV pages as host numpy (L, Hkv, n_pages, page, D),
        the migration image; `n_tokens` trims to the pages covering the
        first n_tokens positions (default: all of the slot's pages). A
        pure gather, bitwise; bf16 pages come back as their int16 bits
        (numpy has no bfloat16), which `install` takes back."""
        ps = self._pages[slot]
        assert ps is not None, f"slot {slot} is not admitted"
        if n_tokens is not None:
            ps = ps[:max(pages_for(n_tokens, self.page), 1)]
        idx = torch.as_tensor(ps, dtype=torch.int64, device=self.k.device)
        return (_to_numpy(self.k.index_select(2, idx)),
                _to_numpy(self.v.index_select(2, idx)))

    def install(self, slot: int, k_pages, v_pages, n_tokens: int) -> None:
        """Admit `slot` and install KV pages ((L, Hkv, n_pages, page, D),
        the export_pages layout) covering an n_tokens prefix, the
        destination half of a migration. The page count must be the admit
        demand; lengths starts at n_tokens. All or nothing: raises
        (PoolExhausted, AssertionError) before it touches any state. The
        pages are written into k / v in place."""
        need = max(pages_for(n_tokens, self.page), 1)
        assert k_pages.shape[2] == need and v_pages.shape[2] == need, (
            f"{n_tokens} tokens need {need} pages, image has "
            f"{k_pages.shape[2]}/{v_pages.shape[2]}")
        kp = _from_numpy(k_pages, self.k)
        vp = _from_numpy(v_pages, self.v)
        want = self.k.shape[:2] + (need,) + self.k.shape[3:]
        assert tuple(kp.shape) == tuple(want) == tuple(vp.shape), (
            f"image {tuple(kp.shape)} / {tuple(vp.shape)}, pool pages "
            f"{tuple(want)}")
        self.admit(slot, n_tokens)
        idx = torch.as_tensor(self._pages[slot], dtype=torch.int64,
                              device=self.k.device)
        self.k.index_copy_(2, idx, kp)
        self.v.index_copy_(2, idx, vp)
        self.lengths[slot] = n_tokens

    def to_dense(self):
        """A dense (L, n*B, T, Hkv/n, D) models.KVCache of the pool (a
        pure gather, bitwise; KVCache.jax_layout gives the JAX layout)."""
        from triton_dist_tpu_torch.models.kv_cache import KVCache

        dev = self.k.device
        return KVCache.dense_view(
            self.k, self.v, torch.as_tensor(self.table, device=dev),
            torch.as_tensor(self.lengths, device=dev), world=self.world)

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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 (which numpy lacks) as its int16 bits."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """An export image as a tensor of `like`'s dtype and device: int16
    bits as bf16 where `like` is bf16, else a cast."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)

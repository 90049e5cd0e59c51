"""PrefixCache — port of triton_dist_tpu.serve.prefix: a radix (trie)
index over KVPool pages.

Shared prompt prefixes (system prompts, few-shot templates, multi-turn
history) make most prefill work recompute KV that another request
already wrote. The cache indexes pool pages by their token content, so
that admission skips the prefill of a cached prefix:

  trie      nodes keyed by token blocks (`block` tokens, a multiple of
            the pool page, so that each node maps to whole pages); a path
            root -> node spells a prefix, the node holds the pool pages
            carrying that block's KV.
  sharing   the cache is an external page holder (KVPool.ref_pages):
            inserting a finished prefill's blocks increfs the slot's
            pages, no copy, and a hit admits the new slot over the same
            pages (KVPool.share). A shared prefix ends on a page boundary
            at or below the slot's length, and the serve step writes
            only at positions >= length, so shared pages are only read
            (KVPool.cow covers callers that break the alignment).
  eviction  `reclaim` drops the least recently hit leaf nodes whose pages
            nobody else holds (refcount == the cache's own hold). Dropping
            a node whose pages a live slot still reads is refused by
            assertion; reclaim skips such nodes.

Why a hit is bitwise its cold run: a serve step's row does not depend on
the batch around it, its slot or its chunk's alignment, so the KV a donor
request wrote for token block B is bitwise the KV the new request's own
prefill would write, and starting its prefill at the matched length over
the donor's pages gives the cold run's tokens. A match is capped at
len(prompt) - 1 tokens: the request prefills at least one token for its
first logits.

The choice of `block` by the perf model (JAX `choose_prefix_block`) is
not ported: the Scheduler takes it from the caller (ROADMAP item 7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "pages", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.pages = pages
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = 0


class PrefixCache:
    """Radix index over one KVPool. `block` (tokens per trie node)
    must be a multiple of the pool page; `max_blocks` bounds the trie
    (LRU reclaim keeps it there)."""

    def __init__(self, pool, block: Optional[int] = None,
                 max_blocks: int = 512):
        block = block or pool.page
        assert block % pool.page == 0, (
            f"block {block} must be a multiple of the pool page "
            f"{pool.page} (a node must map to whole pages)"
        )
        self.pool = pool
        self.block = block
        self.pages_per_block = block // pool.page
        self.max_blocks = max_blocks
        self._root = _Node((), [], None)
        self._clock = 0
        self._n_blocks = 0
        # host counters (the Scheduler counts a hit or miss at each admission)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    # -- queries --------------------------------------------------------

    def n_blocks(self) -> int:
        return self._n_blocks

    def held_pages(self) -> List[int]:
        out: List[int] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            out.extend(node.pages)
            stack.extend(node.children.values())
        return out

    def check(self) -> None:
        """Cache invariants: node count consistent, every held page
        carries an external hold in the pool (refcount >= 1), and no
        page is held by two nodes."""
        pages = self.held_pages()
        assert len(pages) == len(set(pages)), "page held by two nodes"
        assert len(pages) == self._n_blocks * self.pages_per_block
        for p in pages:
            assert self.pool._ext.get(p, 0) >= 1, (
                f"cached page {p} lost its external hold"
            )

    # -- match / insert -------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of `tokens`: (matched token count,
        the pool pages carrying it). Capped at len(tokens) - 1 so the
        admitted request still prefills >= 1 token (its first logits);
        bumps the LRU stamp on every node of the matched path. Pure
        lookup — the scheduler does hit/miss accounting at the
        admission that USES the match (a stalled admission retries the
        lookup every round)."""
        tokens = [int(t) for t in tokens]
        usable = (len(tokens) - 1) // self.block
        node = self._root
        pages: List[int] = []
        n = 0
        self._clock += 1
        for b in range(usable):
            key = tuple(tokens[b * self.block:(b + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            pages.extend(child.pages)
            n += self.block
            node = child
        return n, pages

    def insert(self, tokens: Sequence[int], table_row) -> int:
        """Index a freshly prefilled prompt: walk `tokens`' full
        blocks, creating nodes (increfing the slot's pages from
        `table_row`) where the trie has none. Returns the number of
        NEW blocks indexed. Over-capacity inserts reclaim LRU unshared
        leaves first and stop (skip the remainder) when nothing can be
        reclaimed — the cache never forces pool pressure."""
        tokens = [int(t) for t in tokens]
        node = self._root
        created = 0
        self._clock += 1
        ppb = self.pages_per_block
        for b in range(len(tokens) // self.block):
            key = tuple(tokens[b * self.block:(b + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                if self._n_blocks >= self.max_blocks \
                        and self._reclaim_blocks(1) == 0:
                    break
                pages = [int(p) for p in
                         table_row[b * ppb:(b + 1) * ppb]]
                assert 0 not in pages, (
                    f"prompt block {b} maps to the null page — "
                    "insert before the slot's pages exist?"
                )
                self.pool.ref_pages(pages)
                child = _Node(key, pages, node)
                node.children[key] = child
                self._n_blocks += 1
                created += 1
            child.stamp = self._clock
            node = child
        return created

    # -- eviction -------------------------------------------------------

    def _drop(self, node: _Node) -> int:
        """Drop one LEAF node, returning its pages to the pool.
        REFUSED (assert) when the pages are still shared with a live
        holder (refcount above the cache's own hold) — reclaiming a
        page a slot still reads would corrupt it; the evictor must
        pick an unshared victim."""
        assert node.parent is not None and not node.children, (
            "only leaf nodes are droppable"
        )
        for p in node.pages:
            assert self.pool.refcount(p) == self.pool._ext.get(p, 0), (
                f"refusing to evict shared page {p} "
                f"(refcount {self.pool.refcount(p)} > cache holds "
                f"{self.pool._ext.get(p, 0)}): a live slot still "
                "reads it"
            )
        freed = self.pool.unref_pages(node.pages)
        del node.parent.children[node.key]
        self._n_blocks -= 1
        return freed

    def _droppable(self, node: _Node) -> bool:
        return all(self.pool.refcount(p) == self.pool._ext.get(p, 0)
                   for p in node.pages)

    def _reclaim_blocks(self, n_blocks: int) -> int:
        dropped = 0
        while dropped < n_blocks:
            leaves = [nd for nd in self._iter_leaves()
                      if self._droppable(nd)]
            if not leaves:
                break
            self._drop(min(leaves, key=lambda nd: nd.stamp))
            dropped += 1
        return dropped

    def _iter_leaves(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def reclaim(self, n_pages: int) -> int:
        """Pool-pressure valve: drop least-recently-hit UNSHARED
        leaves until `n_pages` pages came free (or no droppable leaf
        remains). Returns pages freed. Shared leaves are skipped —
        their pages would not come free anyway, and _drop asserts the
        invariant."""
        freed = 0
        while freed < n_pages:
            leaves = [nd for nd in self._iter_leaves()
                      if self._droppable(nd)]
            if not leaves:
                break
            freed += self._drop(min(leaves, key=lambda nd: nd.stamp))
        return freed

    def clear(self) -> None:
        """Drop every droppable node (shared ones survive until their
        live readers finish)."""
        before = -1
        while before != self._n_blocks:
            before = self._n_blocks
            self._reclaim_blocks(self._n_blocks)

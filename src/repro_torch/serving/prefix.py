"""Prefix-sharing radix cache over the paged KV pool.

Pure Python, copied from ``repro/serving/prefix.py``: both packages index
the same pages in the same order, so their prefix schedules are identical.

Two requests with the same system prompt pay for the prefix twice in the
plain paged engine — once in KV pages, once in redundant chunked-prefill
compute. This module is the reuse layer (SGLang's RadixAttention idea
applied to our page pool): a trie over **page-aligned token prefixes**
where every node is one full page of tokens mapped to the physical page
holding its K/V.

* :meth:`RadixCache.insert` indexes a sequence's full pages (called on
  prefill completion for the prompt and again on retirement for the
  generated tokens, which is what makes multi-turn sessions warm). Each
  newly indexed page gets an ownerless +1 refcount via
  :meth:`~repro_torch.serving.pages.PageAllocator.share`, so it stays resident
  after its writer retires.
* :meth:`RadixCache.lookup` walks the trie for the longest indexed
  page-aligned prefix of a new prompt; the engine attaches the matched
  pages read-only into the request's block table and chunk-prefills only
  the uncached suffix.
* :meth:`RadixCache.evict` drops least-recently-used leaves whose pages
  nobody but the cache references (refcount 1) when the pool runs low —
  cached-but-idle prefixes never block a live admission.

Only full pages are indexed: a page is immutable once every position in
it is written (prompt pages before the decode region, and on retirement
everything the request wrote), so sharing is read-only by construction.
The divergence *inside* a page is the engine's job — it copies the page
before writing into it (copy-on-write, see
:class:`repro_torch.serving.paged.PagedEngine`).

The cache is also the engine's warm-restart path for fault tolerance:
a request evicted mid-decode (deadline reap or priority preemption)
has its prompt + generated-so-far tokens indexed *before* its pages are
freed — the ownerless cache refcount keeps those pages resident — so
when the preempted request requeues with its progress appended to the
prompt, admission matches the indexed prefix and re-prefills only the
final partial page instead of the whole extended prompt.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.pages import PageAllocator


class _Node:
    """One full page of tokens: ``key`` (page_size token ids) -> the
    physical ``page`` holding their K/V."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], last_used: int) -> None:
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


class RadixCache:
    """Radix/trie index of page-aligned prefixes over ``alloc``'s pages.

    The cache and the allocator it indexes share one lifetime (the
    engine builds both per run); eviction order is LRU by last
    lookup/insert touch."""

    def __init__(self, alloc: PageAllocator) -> None:
        self.alloc = alloc
        self.page_size = alloc.page_size
        self._root = _Node((), -1, None, 0)
        self._tick = 0
        self.evictions = 0           # pages evicted (refcount-1 LRU drops)

    # ------------------------------------------------------------ queries
    @property
    def num_pages(self) -> int:
        """Pages currently indexed (== trie nodes)."""
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def _chunks(self, tokens: Sequence[int]):
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        for i in range(len(toks) // ps):
            yield tuple(int(t) for t in toks[i * ps:(i + 1) * ps])

    # ------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest indexed page-aligned prefix of ``tokens``: returns
        ``(pages, matched_tokens)`` with ``pages`` the physical page ids
        in logical order and ``matched_tokens == len(pages) * page_size``.
        Touches the matched path (LRU)."""
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index every full page of ``tokens`` (whose K/V lives in
        ``pages``, the owner's block table in logical order). Existing
        nodes are kept (first writer wins — identical token content, so
        the physical copies are interchangeable); each *newly* indexed
        page gains an ownerless cache reference. Returns the number of
        pages newly indexed."""
        self._tick += 1
        node = self._root
        added = 0
        for i, key in enumerate(self._chunks(tokens)):
            child = node.children.get(key)
            if child is None:
                page = int(pages[i])
                child = _Node(key, page, node, self._tick)
                node.children[key] = child
                self.alloc.share([page])
                added += 1
            else:
                child.last_used = self._tick
            node = child
        return added

    # ------------------------------------------------------------- evict
    def _evictable_leaves(self, protect: FrozenSet[int]):
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif (child.page not in protect
                        and self.alloc.refcount(child.page) == 1):
                    out.append(child)
        return out

    def evict(self, need_pages: int,
              protect: FrozenSet[int] = frozenset()) -> int:
        """Free at least ``need_pages`` pages by dropping LRU leaves whose
        pages only the cache references (refcount 1). ``protect`` pins a
        just-looked-up match so eviction can never cannibalize the prefix
        it is making room for. Returns the number of pages freed (may be
        less than asked when nothing else is evictable)."""
        freed = 0
        while freed < need_pages:
            leaves = self._evictable_leaves(protect)
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            freed += len(self.alloc.release([victim.page]))
            self.evictions += 1
        return freed

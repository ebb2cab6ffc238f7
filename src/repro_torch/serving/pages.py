"""Paged KV-cache memory management: a global pool of fixed-size pages.

Pure Python, copied from ``repro/serving/pages.py``: both packages keep
the same allocator, so their paged schedules are identical.

The monolithic engines reserve one contiguous ``cache_span``-sized KV
region per slot, so KV memory is ``slots x cache_span`` tokens no matter
how long the admitted requests actually are. This module is the
vLLM-style alternative: the KV cache is a pool of ``num_pages`` pages of
``page_size`` tokens each, every request owns a *block table* (logical
page index -> physical page id), and admission is gated on free pages
rather than free slots' worth of span.

Pages are **reference counted**: the prefix cache
(``repro.serving.prefix``; a later slice of the port) lets several requests attach the same
physical page read-only (a shared system prompt's KV is stored once and
appears in N block tables), and lets retired requests' prefix pages stay
resident until evicted. ``allocate(owner, tokens, shared=...)`` attaches
already-issued pages at +1 refcount alongside freshly issued ones;
``share``/``release`` adjust refcounts without an owner (the cache's own
holds); ``free(owner)`` decrements and only returns pages whose refcount
reaches zero to the free list.

Only host-side bookkeeping lives here — the device-side pool tensors and
the block-table-driven attention are in :mod:`repro_torch.models.transformer`
and :mod:`repro_torch.kernels.ops`. The allocator is the source of
truth for the paper-facing memory metrics the benchmarks record:

* **occupancy**    — allocated pages / usable pages (Eq.-1-style
  allocation ratio applied to KV memory);
* **fragmentation** — 1 - live tokens / (allocated pages x page_size):
  the *internal* fragmentation of partially-filled last pages (paging's
  only waste; the monolithic layout instead wastes the whole unused tail
  of every span);
* **shared surplus** — logical block-table entries minus distinct
  physical pages under owners: how many pages prefix sharing turned
  from physical into merely logical (the concurrency multiplier).

Page 0 is reserved as the *null page*: retired decode slots and padded
block-table entries point at it, so masked lanes always gather valid
memory and a freed page can be handed to a new request without ever
being written through a stale table.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Sequence

NULL_PAGE = 0


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` KV entries (ceil division)."""
    if tokens <= 0:
        return 0
    return -(-tokens // page_size)


class PoolInvariantError(AssertionError):
    """Raised by :meth:`PageAllocator.check` on a broken pool invariant.

    An ``AssertionError`` subclass so existing ``pytest.raises`` /
    CI expectations keep matching, but raised explicitly — invariant
    checking must NOT silently no-op under ``python -O`` the way bare
    ``assert`` statements do."""


@dataclass
class PageAllocator:
    """Refcounting free-list allocator over a fixed pool of KV pages.

    ``num_pages`` counts the whole device pool *including* the reserved
    null page, so "equal memory budget" comparisons against a monolithic
    engine can equate ``num_pages * page_size`` with ``slots x span``
    directly. The free list is LIFO: the most recently retired request's
    pages are re-issued first (warm-cache reuse, and what the free-list
    reuse test pins down).
    """

    num_pages: int
    page_size: int
    reserved: int = 1               # page ids [0, reserved) never issued

    def __post_init__(self) -> None:
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages <= self.reserved:
            raise ValueError(
                f"num_pages {self.num_pages} leaves no usable pages after "
                f"reserving {self.reserved}")
        self._free: List[int] = list(
            range(self.num_pages - 1, self.reserved - 1, -1))
        # owner -> page ids; owners are any hashable key — plain rids for
        # decode-side holds, ("prefill", rid) tuples for the prefill
        # role's pre-handoff reservations (see repro_torch.serving.roles)
        self._owned: Dict[Hashable, List[int]] = {}
        self._refs: Dict[int, int] = {}             # page id -> refcount
        self.high_water = 0                         # peak pages in use
        self.failed_allocs = 0
        # pages temporarily withheld from allocation (fault injection /
        # external memory pressure): num_free shrinks but the pages stay
        # on the free list, so check() invariants are untouched
        self.pressure = 0
        # REPRO_DEBUG_POOL=1: re-verify the pool invariants on every
        # mutation, so a corruption raises at the faulting call site
        # instead of at the next explicit check() (env-gated — the
        # full-pool scan is O(pages) and would tax the decode hot path)
        self._audit = os.environ.get("REPRO_DEBUG_POOL") == "1"

    # ------------------------------------------------------------ queries
    @property
    def usable_pages(self) -> int:
        return self.num_pages - self.reserved

    @property
    def num_free(self) -> int:
        """Pages available to allocate — the free list minus any
        withheld under :attr:`pressure`."""
        return max(0, len(self._free) - self.pressure)

    @property
    def num_used(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def num_owners(self) -> int:
        return len(self._owned)

    @property
    def owned_pages(self) -> int:
        """Distinct pages still held by owners — nonzero after a drained
        run means the engine leaked (the chaos checks' leak metric;
        ownerless prefix-cache holds are intentionally not counted)."""
        return len({p for pages in self._owned.values() for p in pages})

    def pages_needed(self, tokens: int) -> int:
        return pages_needed(tokens, self.page_size)

    def can_fit(self, tokens: int, shared_pages: int = 0) -> bool:
        """Whether ``tokens`` KV entries fit, given that the first
        ``shared_pages`` pages are attached from the prefix cache rather
        than drawn from the free list."""
        return self.pages_needed(tokens) - shared_pages <= self.num_free

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    @property
    def occupancy(self) -> float:
        """Allocated fraction of the usable pool."""
        return self.num_used / max(self.usable_pages, 1)

    def fragmentation(self, live_tokens: int) -> float:
        """Internal fragmentation: allocated-but-unfilled token slots as a
        fraction of allocated capacity (0 when nothing is allocated;
        clamped at 0 when sharing makes logical tokens exceed physical
        capacity)."""
        cap = self.num_used * self.page_size
        if cap <= 0:
            return 0.0
        return max(0.0, 1.0 - live_tokens / cap)

    def shared_page_surplus(self) -> int:
        """Logical block-table entries minus distinct physical pages under
        owners — how many pages sharing deduplicated. 0 without sharing."""
        logical = 0
        distinct: set = set()
        for pages in self._owned.values():
            logical += len(pages)
            distinct.update(pages)
        return logical - len(distinct)

    # -------------------------------------------------------- allocation
    def allocate(self, owner: Hashable, tokens: int,
                 shared: Sequence[int] = ()) -> List[int]:
        """Reserve pages for ``tokens`` KV entries under ``owner`` (a
        request id). ``shared`` pages (a page-aligned cached prefix, in
        logical order) are attached at +1 refcount instead of being drawn
        from the free list; fresh pages fill the remainder, so the
        returned block table is ``list(shared) + fresh``. Raises
        MemoryError when the free list cannot cover the fresh remainder —
        callers gate admission on :meth:`can_fit` first."""
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds pages")
        shared = list(shared)
        total = self.pages_needed(tokens)
        if len(shared) > total:
            raise ValueError(
                f"owner {owner}: {len(shared)} shared pages exceed the "
                f"{total} pages needed for {tokens} tokens")
        for p in shared:
            if p not in self._refs:
                raise ValueError(
                    f"owner {owner}: shared page {p} is not issued")
        fresh_n = total - len(shared)
        if fresh_n > self.num_free:
            self.failed_allocs += 1
            raise MemoryError(
                f"owner {owner}: need {fresh_n} fresh pages "
                f"(+{len(shared)} shared), only {self.num_free} "
                f"of {self.usable_pages} free")
        fresh = [self._free.pop() for _ in range(fresh_n)]
        for p in shared:
            self._refs[p] += 1
        for p in fresh:
            self._refs[p] = 1
        self._owned[owner] = shared + fresh
        self.high_water = max(self.high_water, self.num_used)
        if self._audit:
            self.check()
        return list(shared + fresh)

    def share(self, pages: Sequence[int]) -> None:
        """Take an ownerless +1 reference on already-issued pages (the
        prefix cache's hold, which keeps indexed pages resident after
        their writer retires)."""
        pages = list(pages)
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"cannot share page {p}: not issued")
        for p in pages:
            self._refs[p] += 1
        if self._audit:
            self.check()

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list. Returns the pages actually freed."""
        freed: List[int] = []
        for p in pages:
            try:
                c = self._refs[p]
            except KeyError:
                raise ValueError(f"cannot release page {p}: not issued"
                                 ) from None
            if c <= 1:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
            else:
                self._refs[p] = c - 1
        if self._audit:
            self.check()     # free()/retire routes through here too
        return freed

    def free(self, owner: Hashable) -> List[int]:
        """Retire ``owner``: drop its reference on every page it holds.
        Only pages whose refcount reaches zero go back to the free list
        (shared prefix pages survive while the cache or another request
        still references them). Returns the pages actually freed."""
        try:
            pages = self._owned.pop(owner)
        except KeyError:
            raise ValueError(f"owner {owner} holds no pages "
                             "(double free?)") from None
        return self.release(pages)

    def owned(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def holds(self, owner: Hashable) -> bool:
        """Whether ``owner`` currently holds any pages — the dual-role
        ownership probe the P/D handoff invariants assert on."""
        return owner in self._owned

    def check(self) -> None:
        """Invariant check: every usable page is either on the free list
        or issued with refcount >= 1 (never both), refcounts cover every
        owner holding the page, and the null page is never issued.

        Raises :class:`PoolInvariantError` explicitly — these checks
        stay live under ``python -O`` (bare ``assert`` would vanish)."""
        def fail(msg: str) -> None:
            raise PoolInvariantError(msg)

        if len(set(self._free)) != len(self._free):
            fail(f"duplicate pages on the free list: {sorted(self._free)}")
        issued = set(self._refs)
        if issued & set(self._free):
            fail(f"pages both issued and free: "
                 f"{sorted(issued & set(self._free))}")
        universe = set(range(self.reserved, self.num_pages))
        if issued | set(self._free) != universe:
            fail("page leak: issued+free != usable range "
                 f"(missing {sorted(universe - issued - set(self._free))}, "
                 f"extra {sorted((issued | set(self._free)) - universe)})")
        holders: Dict[int, int] = {}
        for owner, pages in self._owned.items():
            if len(set(pages)) != len(pages):
                fail(f"owner {owner} holds duplicate pages: {pages}")
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        for p, c in self._refs.items():
            if c < 1:
                fail(f"issued page {p} has refcount {c} < 1")
            if c < holders.get(p, 0):
                fail(f"page {p}: refcount {c} < {holders[p]} owners "
                     "holding it")
        for p in holders:
            if p not in issued:
                fail(f"owned page {p} missing from the refcount table")
        if NULL_PAGE in issued or NULL_PAGE in self._free:
            fail("null page was issued")


@dataclass
class PoolStats:
    """Per-decode-step samples of the allocator state, aggregated for
    :class:`~repro_torch.serving.request.ServeReport`."""

    occupancy: List[float] = field(default_factory=list)
    fragmentation: List[float] = field(default_factory=list)
    pages_shared: List[int] = field(default_factory=list)

    def sample(self, alloc: PageAllocator, live_tokens: int) -> None:
        self.occupancy.append(alloc.occupancy)
        self.fragmentation.append(alloc.fragmentation(live_tokens))
        self.pages_shared.append(alloc.shared_page_surplus())

    @staticmethod
    def _mean(xs: Sequence[float]) -> float:
        return float(sum(xs) / len(xs)) if xs else 0.0

    @property
    def occupancy_mean(self) -> float:
        return self._mean(self.occupancy)

    @property
    def occupancy_peak(self) -> float:
        return float(max(self.occupancy, default=0.0))

    @property
    def fragmentation_mean(self) -> float:
        return self._mean(self.fragmentation)

    @property
    def fragmentation_peak(self) -> float:
        return float(max(self.fragmentation, default=0.0))

    @property
    def pages_shared_peak(self) -> int:
        return int(max(self.pages_shared, default=0))

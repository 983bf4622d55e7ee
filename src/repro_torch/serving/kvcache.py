"""Paged KV-cache management.

``BlockAllocator`` is the accounting layer the engine/toggle use for the
HBM watermark (§IV-C: "the multiplexing toggle records the status of each
worker, including monitoring the HBM watermark"). ``PagedKVStore`` is the
physical page pool consumed by the Pallas paged_attention kernel — pages
are allocated per request, the block table provides the indirection.

Two beyond-paper production mechanisms live here as well:

* **Tiered KV (HBM → host DRAM)** — ``PageAccountant`` optionally grows a
  second, host-DRAM tier behind the HBM pool. Watermark-crossing decodes
  *offload* their pages (``offload``/``restore``) instead of discarding
  them for a full re-prefill; the engine moves the bytes over the
  contended ``TransferEngine`` host link and the toggle prices the
  restore cost into its slack math (``Predictor.predict_restore``). A
  zero-size host tier is bit-exact with the evict+re-prefill accountant.
* **Cross-request prefix reuse** — ``PrefixIndex`` is a per-worker LRU of
  cached prompt prefixes (shared system prompts): requests carrying a
  matching ``prefix_key`` skip the cached span of prefill and borrow the
  cached pages under a refcount, so an entry can never be evicted out
  from under a mid-decode borrower (LLMServe-style prefix awareness with
  a hit-rate estimator feeding dispatch scores).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` (ceil-div) — THE page-rounding rule.
    Every admission gate and allocator must share it, or the scheduler
    admits what the pool then rejects."""
    return -(-max(int(tokens), 0) // max(int(page_size), 1))


class PageAccountant:
    """Counts-only page-granular KV accounting for scheduler admission.

    ``BlockAllocator`` below hands out physical page *ids* for the Pallas
    kernel's block tables; the scheduler does not need ids, only truthful
    arithmetic: how many pages a request pins (ceil of its token footprint),
    how many remain allocatable, and how much of the pool is internal
    fragmentation (allocated-but-unwritten page tails). The engine keeps one
    accountant per worker so the toggle's §IV-B admission checks gate on
    real allocatable pages rather than a token counter that ignores block
    rounding."""

    def __init__(self, total_pages: int, page_size: int,
                 host_pages: int = 0):
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self._pages: dict[int, int] = {}    # rid -> pages held (HBM)
        self._tokens: dict[int, int] = {}   # rid -> tokens covered (HBM)
        # Host-DRAM tier: same page arithmetic, second pool. 0 == disabled
        # and every tier method below degenerates to a no-op/False, keeping
        # the single-tier accountant bit-exact.
        self.host_total_pages = int(host_pages)
        self._host_pages: dict[int, int] = {}
        self._host_tokens: dict[int, int] = {}
        # maintained totals: admission checks read used/free pages on every
        # dispatch, which must not re-sum the per-rid dicts each time
        self._used = 0
        self._host_used = 0

    # ---------------------------------------------------------------- query
    @property
    def used_pages(self) -> int:
        return self._used

    @property
    def free_pages(self) -> int:
        return self.total_pages - self.used_pages

    @property
    def utilization(self) -> float:
        return self.used_pages / max(self.total_pages, 1)

    @property
    def host_used_pages(self) -> int:
        return self._host_used

    @property
    def host_free_pages(self) -> int:
        return self.host_total_pages - self.host_used_pages

    @property
    def fragmentation(self) -> float:
        """Fraction of *used* pool bytes that are allocated page tails no
        token occupies (0 when every page is exactly full)."""
        used_tok = self.used_pages * self.page_size
        if used_tok == 0:
            return 0.0
        return 1.0 - sum(self._tokens.values()) / used_tok

    def pages_for(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_fit(self, tokens: int, rid: Optional[int] = None) -> bool:
        held = self._pages.get(rid, 0) if rid is not None else 0
        return self.pages_for(tokens) - held <= self.free_pages

    # ------------------------------------------------------------- mutation
    def reserve(self, rid: int, tokens: int) -> bool:
        """Grow ``rid``'s allocation to cover ``tokens`` total. False (and
        no state change) when the pool cannot supply the growth."""
        tokens = max(int(tokens), 0)
        need = self.pages_for(tokens) - self._pages.get(rid, 0)
        if need > self.free_pages:
            return False
        grow = max(0, need)
        self._pages[rid] = self._pages.get(rid, 0) + grow
        self._used += grow
        self._tokens[rid] = max(self._tokens.get(rid, 0), tokens)
        return True

    def release(self, rid: int) -> int:
        """Free every page held by ``rid`` in BOTH tiers; returns the HBM
        page count (host pages, if any, are freed silently — a finished or
        restarted request must never leave residue in either pool)."""
        self._tokens.pop(rid, None)
        self._host_tokens.pop(rid, None)
        self._host_used -= self._host_pages.pop(rid, 0)
        pages = self._pages.pop(rid, 0)
        self._used -= pages
        return pages

    def held_pages(self, rid: int) -> int:
        return self._pages.get(rid, 0)

    def reset(self) -> None:
        self._pages.clear()
        self._tokens.clear()
        self._host_pages.clear()
        self._host_tokens.clear()
        self._used = 0
        self._host_used = 0

    # ------------------------------------------------------- host-DRAM tier
    def can_offload(self, rid: int) -> bool:
        """Would ``offload(rid)`` succeed right now?"""
        pages = self._pages.get(rid, 0)
        return (pages > 0 and self.host_total_pages > 0
                and pages + self._host_pages.get(rid, 0)
                <= self.host_free_pages + self._host_pages.get(rid, 0))

    def offload(self, rid: int) -> int:
        """Move ``rid``'s HBM pages into the host tier (accounting only —
        the engine moves the bytes over the host link). Returns the page
        count moved, 0 (no state change) if the host tier lacks room."""
        if not self.can_offload(rid):
            return 0
        pages = self._pages.pop(rid)
        tokens = self._tokens.pop(rid, 0)
        self._used -= pages
        self._host_used += pages
        self._host_pages[rid] = self._host_pages.get(rid, 0) + pages
        self._host_tokens[rid] = max(self._host_tokens.get(rid, 0), tokens)
        return pages

    def can_restore(self, rid: int) -> bool:
        return (self._host_pages.get(rid, 0) > 0
                and self._host_pages[rid] <= self.free_pages)

    def restore(self, rid: int) -> int:
        """Move ``rid``'s host-tier pages back into HBM. Returns the page
        count moved, 0 (no state change) if HBM cannot hold them."""
        if not self.can_restore(rid):
            return 0
        pages = self._host_pages.pop(rid)
        tokens = self._host_tokens.pop(rid, 0)
        self._host_used -= pages
        self._used += pages
        self._pages[rid] = self._pages.get(rid, 0) + pages
        self._tokens[rid] = max(self._tokens.get(rid, 0), tokens)
        return pages

    def host_held_pages(self, rid: int) -> int:
        return self._host_pages.get(rid, 0)


@dataclasses.dataclass
class CachedPrefix:
    """One shared-prompt span resident in a worker's HBM page pool.

    ``rid`` is a negative pseudo request-id the cache pins its pages under
    in the worker's ``PageAccountant`` (request rids are non-negative, so
    the namespaces never collide). ``refs`` counts borrowers currently
    decoding on top of this span — eviction is refused while refs > 0."""
    key: int
    tokens: int
    rid: int
    pages: int
    refs: int = 0
    last_use: int = 0


class PrefixIndex:
    """Per-worker LRU index of cached prompt prefixes.

    Counts-only, like ``PageAccountant``: entries pin pages under pseudo
    rids; the worker charges/releases the actual pool. Keeps both lifetime
    hit counters and an EWMA hit-rate estimator (the dispatch-score signal,
    in the spirit of LLMServe's prefix-awareness scorer)."""

    def __init__(self, max_pages: int, ewma_alpha: float = 0.05):
        self.max_pages = int(max_pages)
        self.ewma_alpha = float(ewma_alpha)
        self._entries: dict[int, CachedPrefix] = {}   # key -> entry
        self._seq = itertools.count(1)
        self._rids = itertools.count(1)
        self.lookups = 0
        self.hits = 0
        self.hit_ewma = 0.0
        # bumped on every change to the {key: tokens} content, so view
        # refreshes can skip rebuilding ``spans()`` when nothing moved
        self.version = 0

    # ---------------------------------------------------------------- query
    @property
    def used_pages(self) -> int:
        return sum(e.pages for e in self._entries.values())

    @property
    def hit_rate(self) -> float:
        """Lifetime hit rate (0 before any lookup)."""
        return self.hits / self.lookups if self.lookups else 0.0

    def peek(self, key: int) -> int:
        """Cached span (tokens) for ``key`` WITHOUT touching counters or
        LRU order — admission checks may probe repeatedly."""
        e = self._entries.get(key)
        return e.tokens if e is not None else 0

    def spans(self) -> dict[int, int]:
        """{key: tokens} snapshot for the WorkerView (dispatch scoring)."""
        return {k: e.tokens for k, e in self._entries.items()}

    # ------------------------------------------------------------- mutation
    def lookup(self, key: int) -> Optional[CachedPrefix]:
        """Counted lookup: bumps LRU recency and the hit-rate estimator."""
        self.lookups += 1
        e = self._entries.get(key)
        hit = 1.0 if e is not None else 0.0
        self.hit_ewma += self.ewma_alpha * (hit - self.hit_ewma)
        if e is not None:
            self.hits += 1
            e.last_use = next(self._seq)
        return e

    def insert(self, key: int, tokens: int, pages: int) -> CachedPrefix:
        """Register a new cached span; caller has already reserved
        ``pages`` in the pool under the returned entry's pseudo rid."""
        e = CachedPrefix(key=key, tokens=int(tokens), rid=-next(self._rids),
                         pages=int(pages), last_use=next(self._seq))
        self._entries[key] = e
        self.version += 1
        return e

    def unref(self, key: int) -> None:
        e = self._entries.get(key)
        if e is not None and e.refs > 0:
            e.refs -= 1

    def evict_lru(self) -> Optional[CachedPrefix]:
        """Pop the least-recently-used UNREFERENCED entry (caller frees its
        pages). Entries with live borrowers are never evicted — a borrower
        mid-decode must not have its prefix pages dangle."""
        victim = None
        for e in self._entries.values():
            if e.refs == 0 and (victim is None or e.last_use < victim.last_use):
                victim = e
        if victim is not None:
            del self._entries[victim.key]
            self.version += 1
        return victim

    def clear(self) -> list[CachedPrefix]:
        """Drop every entry (worker failure: HBM content is gone)."""
        dropped = list(self._entries.values())
        self._entries.clear()
        if dropped:
            self.version += 1
        return dropped


class BlockAllocator:
    """Free-list page allocator with watermark accounting."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, -1, -1))
        self.allocated: dict[int, list[int]] = {}   # rid -> pages

    # ---------------------------------------------------------------- query
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(self.n_blocks, 1)

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_fit(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self.free_blocks

    # ------------------------------------------------------------- mutation
    def allocate(self, rid: int, tokens: int) -> Optional[list[int]]:
        need = self.blocks_for(tokens) - len(self.allocated.get(rid, []))
        if need > len(self._free):
            return None
        pages = self.allocated.setdefault(rid, [])
        for _ in range(max(0, need)):
            pages.append(self._free.pop())
        return pages

    def extend(self, rid: int, new_total_tokens: int) -> bool:
        """Grow a request's allocation to cover ``new_total_tokens``."""
        return self.allocate(rid, new_total_tokens) is not None

    def release(self, rid: int) -> None:
        for p in self.allocated.pop(rid, []):
            self._free.append(p)

    def table(self, rid: int, max_pages: int) -> np.ndarray:
        pages = self.allocated.get(rid, [])
        t = np.full((max_pages,), -1, np.int32)
        t[: len(pages)] = pages[:max_pages]
        return t


"""Block-paged KV-cache pool: host-side page accounting for the engine (a
copy of ``repro/serve/kvpool.py``, which is numpy-only; the port keeps its
own).

A free-list allocator with per-page refcounts over ``n_pages`` pages of
``page_tokens`` cache rows each. Page id i addresses the same physical page
in every layer's pool tensor, so one page table (n_slots,
max_len // page_tokens) translates a slot's positions for the whole stack.
Only complete pages are ever shared (the prefix trie pins page-aligned runs,
a parked request keeps its run, the EncoderCache pins a source's cross
pages), so a shared page is read-only and sharing is pure refcounting: a
slot mapping a page holds one reference, the trie or the EncoderCache one
per page it pins, and a page returns to the free list when the last drops.
Invalid paged writes land on the pools' scratch page (index n_pages), which
this allocator never hands out.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class KVPool:
    """Refcounted free-list allocator over ``n_pages`` KV pages."""

    def __init__(self, n_pages: int, page_tokens: int,
                 family: str = "self_attn"):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive: {n_pages}")
        if page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive: {page_tokens}")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        # the ServableModel cache family this pool backs ("self_attn" or
        # "cross_attn"), for stats; the allocator itself ignores it
        self.family = family
        self.refcounts = np.zeros((n_pages,), np.int64)
        # LIFO free list: a just-freed page is reused first
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    def alloc(self) -> Optional[int]:
        """Take a free page (refcount 1), or None when the pool is empty."""
        if not self._free:
            return None
        pid = self._free.pop()
        assert self.refcounts[pid] == 0, f"free page {pid} had references"
        self.refcounts[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        """Add a reference to a live page (prefix-hit mapping, trie pin)."""
        if self.refcounts[pid] <= 0:
            raise ValueError(f"retain of unreferenced page {pid}")
        self.refcounts[pid] += 1

    def release(self, pid: int) -> None:
        """Drop one reference; the page returns to the free list at zero."""
        if self.refcounts[pid] <= 0:
            raise ValueError(f"release of unreferenced page {pid}")
        self.refcounts[pid] -= 1
        if self.refcounts[pid] == 0:
            self._free.append(pid)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def utilization(self) -> float:
        """Referenced fraction of the pool in [0, 1] (the telemetry gauge
        serve_pool_utilization samples it at scrape time)."""
        return (self.n_pages - len(self._free)) / self.n_pages

    def check(self) -> None:
        """Refcounts never negative; free list and referenced pages exactly
        partition the pool."""
        assert np.all(self.refcounts >= 0)
        assert len(set(self._free)) == len(self._free)
        assert int(np.sum(self.refcounts > 0)) + len(self._free) == self.n_pages
        assert all(self.refcounts[p] == 0 for p in self._free)

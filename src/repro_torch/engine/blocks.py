"""Host-side block accounting for the paged KV pool.

The device side is a shared page array per layer plus per-slot block
tables (``models/cache.init_paged_cache``); this module owns the
free-list over page ids.  Block 0 is the **null page** — reserved as the
scatter/gather target for dead slots and padded prefill tokens — so real
allocations hand out ids ``1..num_blocks-1``.

Ownership is **refcounted** (vLLM/SGLang-style prefix sharing): a block
freshly popped by :meth:`BlockPool.alloc` has refcount 1; every extra
owner — another request aliasing the same cached prefix, or the radix
prefix index pinning a block — calls :meth:`share`; :meth:`release`
decrements and returns the block to the free list only at refcount 0.
The PR 5 exclusive-ownership :meth:`free` survives as a deprecation
shim: it is exactly ``release`` on refcount-1 blocks and warns when a
caller "frees" a block that still has other owners.

The pool's occupancy is the scheduler signal: the engine exposes
``available``/``total`` through ``SchedulerView.free_blocks`` /
``total_blocks`` so admission and preemption can be memory-aware.
"""
from __future__ import annotations

import warnings
from collections import Counter
from typing import Dict, List


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` KV pages
    (id 0 reserved)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "null page)")
        self.num_blocks = num_blocks
        # LIFO free list: recently-freed (cache-warm) pages are reused first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def total(self) -> int:
        """Allocatable blocks (excludes the null page)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Blocks with at least one owner (refcount >= 1)."""
        return len(self._ref)

    @property
    def shared(self) -> int:
        """Blocks with more than one owner (refcount >= 2)."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, block_id: int) -> int:
        """Owners of ``block_id`` (0: free or foreign)."""
        return self._ref.get(block_id, 0)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` block ids at refcount 1; raises if the pool cannot
        cover them — callers must check ``available`` first (admission
        refusal)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV blocks: need {n}, {len(self._free)} free "
                f"of {self.total}")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def share(self, ids: List[int]) -> None:
        """Add one owner to each block (prefix aliasing / index pin).
        All ids must be live; validated before any refcount changes."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(f"cannot share block {i}: not allocated")
        for i in ids:
            self._ref[i] += 1

    def release(self, ids: List[int]) -> None:
        """Drop one owner per listed block; a block returns to the free
        list when its last owner releases it.  A block listed k times is
        released k times (its refcount must cover the multiplicity) —
        the whole call is validated before any state changes."""
        need = Counter(ids)
        for i, k in need.items():
            have = self._ref.get(i, 0)
            if have < k:
                raise ValueError(
                    f"cannot release block {i} x{k}: refcount {have} "
                    "(double free or foreign id)")
        for i in ids:
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                self._free.append(i)

    def free(self, ids: List[int]) -> None:
        """PR 5 exclusive-ownership API (deprecation shim).

        Exactly :meth:`release` for refcount-1 blocks — the fast path old
        callers hit.  The exclusive-pool invariants it used to assume are
        now validated *atomically*: duplicate ids in one call or a
        non-live id raise ``ValueError`` before any mutation (the old
        implementation appended to the free list as it walked, so a
        duplicate corrupted the free list mid-call).  Freeing a block
        other owners still hold is no longer a full free — it warns and
        decrements, like ``release``."""
        seen = set()
        for i in ids:
            if i in seen:
                raise ValueError(
                    f"block {i} listed twice in one free() call")
            seen.add(i)
            if i not in self._ref:
                raise ValueError(f"block {i} is not allocated "
                                 "(double free or foreign id)")
        if any(self._ref[i] > 1 for i in ids):
            warnings.warn(
                "BlockPool.free() on a shared block: exclusive ownership "
                "is gone (refcounted pages); the call decrements the "
                "refcount like release(). Call release() directly.",
                DeprecationWarning, stacklevel=2)
        self.release(ids)

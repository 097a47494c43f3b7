"""Radix prefix index over KV blocks (vLLM/SGLang-style prefix caching).

Maps token-id prefixes to cached KV pages at **block granularity**: a
trie node is one full block of ``block_size`` token ids (its key), and
holds the page id whose KV was computed for exactly those tokens at
those positions.  An arriving prompt walks the trie block by block;
every hit is a page the request can alias instead of re-prefilling
(:meth:`match` → ``BlockPool.share``), so prefill starts mid-sequence
and the scheduler prices only the *unique new* tokens.

The index is itself an owner of every cached block (it calls
``pool.share`` on insert and ``pool.release`` on evict), so cached
pages outlive the request that produced them: a sharer's preemption or
finish releases *its* reference, never the index's.  Blocks whose only
remaining owner is the index (refcount 1) are **reclaimable** — the
engine counts them as available to admission and evicts them LRU-wise
(leaves first, so the trie never orphans a descendant) when the free
list runs short.

Only full blocks are ever indexed, and matches are capped below the
prompt length (at least one token is always computed, so prefill
produces true last-token logits); divergent writes therefore land in
freshly allocated blocks and copy-on-write is a guard, not a hot path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "block", "children", "parent", "tick")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]):
        self.key = key                    # block_size token ids (None: root)
        self.block = block                # page id (-1: root)
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.tick = 0                     # LRU stamp (match/insert touch)


class RadixPrefixIndex:
    """Block-granular trie from token-id prefixes to cached page ids."""

    def __init__(self, pool, block_size: int):
        self.pool = pool
        self.block_size = int(block_size)
        self._root = _Node(None, -1, None)
        self._nodes = 0                   # cached blocks (excl. root)
        self._tick = 0
        # token-level counters for hit-rate reporting
        self.hit_tokens = 0
        self.lookup_tokens = 0

    def __len__(self) -> int:
        return self._nodes

    # ------------------------------------------------------------ lookup
    def _keys(self, tokens: Sequence[int], max_tokens: Optional[int]
              ) -> List[Tuple[int, ...]]:
        n = len(tokens)
        if max_tokens is not None:
            n = min(n, int(max_tokens))
        P = self.block_size
        return [tuple(int(t) for t in tokens[i:i + P])
                for i in range(0, n - P + 1, P)]

    def _walk(self, tokens: Sequence[int], max_tokens: Optional[int]
              ) -> List[_Node]:
        node, out = self._root, []
        for key in self._keys(tokens, max_tokens):
            nxt = node.children.get(key)
            if nxt is None:
                break
            out.append(nxt)
            node = nxt
        return out

    def probe(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None) -> int:
        """Longest cached block-aligned prefix of ``tokens`` (limited to
        the first ``max_tokens``), in tokens.  Read-only: no LRU touch,
        no refcount change — admission pricing uses this."""
        return len(self._walk(tokens, max_tokens)) * self.block_size

    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None) -> List[int]:
        """Page ids of the longest cached block-aligned prefix.  Touches
        the path for LRU.  The caller owns sharing: ``pool.share`` the
        returned ids *before* anything can evict them."""
        path = self._walk(tokens, max_tokens)
        self._tick += 1
        for nd in path:
            nd.tick = self._tick
        n = len(tokens) if max_tokens is None \
            else min(len(tokens), int(max_tokens))
        self.lookup_tokens += max(n, 0)
        self.hit_tokens += len(path) * self.block_size
        return [nd.block for nd in path]

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               max_tokens: Optional[int] = None) -> int:
        """Index ``tokens``' full blocks, backed by ``block_ids`` (the
        owner's pages, position-aligned: ``block_ids[d]`` holds tokens
        ``[d*P, (d+1)*P)``).  Each newly indexed block gains the index
        as an owner (``pool.share``); blocks whose key is already cached
        keep the existing page (same content — keys *are* the content),
        and the offered duplicate stays solely with the caller.  Returns
        the number of blocks newly indexed."""
        node, new = self._root, 0
        self._tick += 1
        for d, key in enumerate(self._keys(tokens, max_tokens)):
            nxt = node.children.get(key)
            if nxt is None:
                if d >= len(block_ids):
                    break
                self.pool.share([block_ids[d]])
                nxt = _Node(key, block_ids[d], node)
                node.children[key] = nxt
                self._nodes += 1
                new += 1
            nxt.tick = self._tick
            node = nxt
        return new

    # ------------------------------------------------------------ evict
    def reclaimable(self) -> int:
        """Cached blocks no request currently aliases (refcount 1: the
        index is the only owner) — memory admission may count these as
        free, since :meth:`evict` can hand them back."""
        return sum(1 for nd in self._iter() if self.pool.refcount(nd.block) == 1)

    def _iter(self):
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def evict(self, need: int) -> int:
        """Release up to ``need`` reclaimable blocks, least recently used
        leaves first (a freed leaf may expose its parent next, so deep
        cold chains unwind).  Blocks any request still aliases
        (refcount > 1) are never touched.  Returns the number evicted."""
        freed = 0
        while freed < need:
            victim = None
            for nd in self._iter():
                if nd.children:
                    continue
                if self.pool.refcount(nd.block) != 1:
                    continue
                if victim is None or nd.tick < victim.tick:
                    victim = nd
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.pool.release([victim.block])
            freed += 1
        return freed

    def clear(self) -> None:
        """Release every cached block and reset the trie (pool drain)."""
        for nd in self._iter():
            self.pool.release([nd.block])
        self._root = _Node(None, -1, None)
        self._nodes = 0

    @property
    def hit_rate(self) -> float:
        """Token-level prefix hit rate over all :meth:`match` calls."""
        return self.hit_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0

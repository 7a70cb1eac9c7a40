"""Refcounted prompt-prefix sharing over the paged KV pool.

Block tables already make a shared block *representable* — two requests
whose tables name the same pool block attend to the same K/V.  What
makes it *correct* is that a cache slot's K/V depends only on that
slot's token id and its RoPE position (``j - pad``): attention mixes
values at read time, never at write time.  So two rows laid out as
``[pad zero-slots][tokens...]`` with the same pad and the same leading
tokens have bit-identical K/V in their leading full blocks, and those
blocks can be shared outright — no copy-on-write machinery is needed
because the engine only ever shares FULL prompt blocks and every
subsequent write (decode appends, suffix prefill scatter) lands strictly
past them.

Lifecycle (all host-side, between device steps, like the free list):

- after a request's prefill, its fully-filled prompt blocks are
  *registered* under chained content keys; the cache takes one reference
  of its own per block, so the block outlives the request.
- at admission, the scheduler asks the engine for a *prefill plan*; a
  chain match claims the shared blocks (one reference per requester) and
  the engine skips the prefill chunks they cover entirely.
- ``FreeList.free`` is a decref: a block returns to the free list only
  when the last reference drops.  Blocks whose only reference is the
  cache's own are *reclaimable*: ``BlockPool.alloc`` evicts them LRU
  when the free list alone cannot satisfy a request, and
  ``BlockPool.num_free`` counts them as available — shared blocks never
  double-count against pool capacity.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def prefix_block_keys(
    tokens: np.ndarray, pad: int, block_size: int, n_blocks: int
) -> list[bytes]:
    """Chained content keys for the first ``n_blocks`` FULL blocks of a
    row laid out as ``[pad zero-slots][tokens...]``.

    Key ``i`` commits to ``(pad, block_size, tokens of blocks 0..i)``, so
    a match at depth ``i`` implies the whole prefix matches — sharing is
    prefix-only by construction and collisions across layouts are
    impossible.  ``pad`` is folded into the seed because slot positions
    (``j - pad``) shift the entire row's K/V.
    """
    content = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    h = hashlib.sha256(f"pad={pad};bs={block_size};".encode())
    keys: list[bytes] = []
    for i in range(n_blocks):
        if (i + 1) * block_size - pad > content.size:
            break  # partial block — never shareable
        # clamp BOTH bounds to >= 0: a block living entirely inside the
        # pad region hashes no tokens (its K/V is position-only), and a
        # negative hi would wrap the slice around to the prompt TAIL,
        # silently defeating prefix matching whenever pad > block_size
        lo = max(i * block_size - pad, 0)
        hi = max((i + 1) * block_size - pad, 0)
        h.update(content[lo:hi].tobytes())
        keys.append(h.digest())
    return keys


class PrefixCache:
    """key → pool block id registry with LRU reclaim.

    ``free_list`` is the owning allocator (FreeList interface with
    refcounts); every registered block carries ONE reference held by the
    cache itself, dropped when the entry is reclaimed or cleared.
    """

    def __init__(self, free_list) -> None:
        self.free_list = free_list
        # LRU order: oldest entry first (move_to_end on hit)
        self._entries: OrderedDict[bytes, int] = OrderedDict()
        self._key_by_block: dict[int, bytes] = {}
        # on_reclaim(key, block_id): called for each entry ``release`` is
        # about to drop, BEFORE its block returns to the free list — the
        # engine counts the eviction and, with the host tier attached,
        # spills the block's K/V (serve/host_tier.py).  None = reclaim
        # stays a pure free.
        self.on_reclaim = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_reclaimable(self) -> int:
        """Registered blocks whose ONLY reference is the cache's own —
        freeable on demand, so admission control may count them."""
        return sum(
            1 for blk in self._entries.values()
            if self.free_list.refcount(blk) == 1
        )

    # ------------------------------------------------------------------
    def match(self, keys: list[bytes]) -> list[int]:
        """Longest registered prefix of ``keys`` → block ids.  Pure
        lookup: no references move, no LRU touch."""
        out: list[int] = []
        for key in keys:
            blk = self._entries.get(key)
            if blk is None:
                break
            out.append(blk)
        return out

    def claim(self, keys: list[bytes]) -> list[int]:
        """Take one reference per matched block (the requester's) and
        LRU-touch the entries.  Callers pass keys already truncated to
        the prefix they can actually use; the claim stops at the first
        miss like ``match``."""
        ids = self.match(keys)
        if ids:
            self.free_list.incref(ids)
            for key in keys[: len(ids)]:
                self._entries.move_to_end(key)
        return ids

    def register(self, keys: list[bytes], block_ids: list[int]) -> int:
        """Insert ``key → block`` pairs after a prefill; the cache takes
        its own reference per NEW entry.  Keys already present are only
        LRU-touched (the registered twin stays canonical — the caller's
        block for that key IS the registered one on a claim hit).
        Returns the number of new entries."""
        added = 0
        for key, blk in zip(keys, block_ids):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            if blk in self._key_by_block:
                continue  # block already registered under another chain
            self.free_list.incref([blk])
            self._entries[key] = blk
            self._key_by_block[blk] = key
            added += 1
        return added

    # ------------------------------------------------------------------
    def release(self, n: int) -> int:
        """Drop up to ``n`` LRU entries whose block is cache-only
        (refcount 1), returning those blocks to the free list.  Entries
        still referenced by live requests are skipped — eviction can
        NEVER free a block a running request's table points at."""
        freed = 0
        if n <= 0:
            return 0
        for key in list(self._entries):
            blk = self._entries[key]
            if self.free_list.refcount(blk) != 1:
                continue
            if self.on_reclaim is not None:
                # observe (and possibly spill) the block BEFORE the id
                # frees — once on the free list it may be rewritten by
                # the very allocation that triggered this reclaim
                self.on_reclaim(key, blk)
            del self._entries[key]
            del self._key_by_block[blk]
            self.free_list.free([blk])
            freed += 1
            if freed >= n:
                break
        return freed

    def items(self) -> list[tuple[bytes, int]]:
        """Snapshot of the registered ``(key, block id)`` pairs, LRU order
        (oldest first) — what ``ServeEngine.spill_prefix_blocks`` walks
        to ship an engine's whole prefix set."""
        return list(self._entries.items())

    def clear(self) -> None:
        """Drop every entry and the cache's references (blocks still
        referenced by live requests stay allocated for them)."""
        for blk in self._entries.values():
            self.free_list.free([blk])
        self._entries.clear()
        self._key_by_block.clear()

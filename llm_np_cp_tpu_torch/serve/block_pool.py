"""Paged KV cache: fixed-size blocks in one preallocated slab per layer
(port of ``llm_np_cp_tpu/serve/block_pool.py``).

A contiguous ``KVCache`` reserves ``max_seq_len`` slots per request up
front — at serving concurrency most of that is empty tail.  The pool
instead preallocates ONE slab of ``num_blocks`` fixed-size blocks per
layer and hands requests blocks on demand through a free list; a
request's cache is its *block table* (list of block ids), so fragments
left by finished requests are reusable immediately and admission control
reduces to counting free blocks.

Layout (the contiguous cache's [L, B, S, K, D] with S factored into
pages):

    k, v: [num_layers, num_blocks, block_size, kv_heads, head_dim]

Block 0 is RESERVED as a scratch block and never allocated: inactive
slots and dead packing lanes of the engine's fixed-width batches point
at it, so a step can write unconditionally and garbage lands somewhere
harmless (no live table ever reads block 0).

int8 mode mirrors ``KVCache``'s quantized slabs: per-token-per-head
absmax scales (cache.quantize_kv layout) ride in parallel
``[L, NB, BS, K]`` float32 pages.

Under a tensor-parallel mesh (``ServeEngine(mesh_plan=...)``) each rank's
pool holds only its KV heads (``kv_heads``: ``[L, NB, BS, K_local, D]``
slabs and ``[L, NB, BS, K_local]`` scale pages, the head axis split over
"model" as ``parallel.sharding.paged_kv_specs`` says), while the free
list, the block ids and the prefix cache stay global: every rank makes
the same allocation decisions, so every rank's tables name the same
blocks, each holding this rank's head slice of their K/V.

The allocator is host-side Python (a free list); blocks are REFCOUNTED
so prompt-prefix blocks can be shared across requests
(serve/prefix_cache.py).  The pages are plain tensors that the engine's
steps update IN PLACE (``index_put_``) — the JAX package threads them
through donated jitted steps instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device


class FreeList:
    """LIFO free-list allocator over block ids ``1..num_blocks-1``, with
    per-block refcounts for prefix sharing.

    Block 0 is the reserved scratch block (see module docstring).  LIFO
    reuse keeps recently-freed blocks hot (their slab pages are most
    likely still in cache on real hardware).  ``alloc`` hands out blocks
    at refcount 1; ``incref`` adds a sharer; ``free`` is a DECREF — a
    block returns to the free list only when its last reference drops,
    so a shared prefix block survives any one request's finish or
    eviction.  Pure Python so scheduler policies are testable without
    any device tensors.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (1 reserved scratch), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}  # allocated block id → refcount

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._ref)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the reserved scratch block)."""
        return self.num_blocks - 1

    def refcount(self, block_id: int) -> int:
        """Current references on ``block_id`` (0 if free/unknown)."""
        return self._ref.get(block_id, 0)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` blocks at refcount 1, or None (and no change) if
        not enough free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def incref(self, ids: list[int]) -> None:
        """Add one reference per block (a new sharer of a prefix block).
        Only allocated blocks can gain references."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(f"incref on unallocated block id {i}")
        for i in ids:
            self._ref[i] += 1

    def free(self, ids: list[int]) -> None:
        """Drop one reference per block; blocks whose count hits zero
        return to the free list.  Releasing a block with no references
        is still a hard error (double free)."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(f"double free or foreign block id {i}")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                self._free.append(i)


class PagedKV(NamedTuple):
    """The pool's device pages.  Scales are None for float pools."""

    k: torch.Tensor  # [L, NB, BS, K, D]
    v: torch.Tensor  # [L, NB, BS, K, D]
    k_scale: torch.Tensor | None = None  # [L, NB, BS, K] f32 (int8 mode)
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


class BlockPool:
    """Free-list allocator + the device slabs it allocates from
    (allocated zeroed on ``device``; ``"cuda"`` raises without a card)."""

    def __init__(
        self,
        config: ModelConfig,
        num_blocks: int,
        block_size: int,
        dtype: torch.dtype = torch.bfloat16,
        enable_prefix_cache: bool = False,
        device: str | torch.device = "cuda",
        kv_heads: int | None = None,
    ) -> None:
        if block_size < 8 or block_size % 8:
            # the JAX package's decode kernels need it (Mosaic's
            # second-minor alignment); kept so both size pools alike
            raise ValueError(f"block_size must be a multiple of 8, got {block_size}")
        self.config = config
        self.block_size = block_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.free_list = FreeList(num_blocks)
        if enable_prefix_cache:
            from llm_np_cp_tpu_torch.serve.prefix_cache import PrefixCache

            self.prefix_cache: PrefixCache | None = PrefixCache(self.free_list)
        else:
            self.prefix_cache = None
        # the KV heads this rank's slabs hold (all of them off a mesh)
        self.kv_heads = kv_heads or config.num_key_value_heads
        shape = (
            config.num_hidden_layers,
            num_blocks,
            block_size,
            self.kv_heads,
            config.head_dim,
        )
        quantized = dtype == torch.int8

        def zeros(s: tuple[int, ...], dt: torch.dtype) -> torch.Tensor:
            return torch.zeros(s, dtype=dt, device=self.device)

        self.pages = PagedKV(
            k=zeros(shape, dtype),
            v=zeros(shape, dtype),
            k_scale=zeros(shape[:-1], torch.float32) if quantized else None,
            v_scale=zeros(shape[:-1], torch.float32) if quantized else None,
        )

    # -- accounting (delegates; the scheduler talks to these) ----------
    @property
    def num_blocks(self) -> int:
        return self.free_list.num_blocks

    @property
    def num_free(self) -> int:
        """Blocks available for allocation: the free list plus prefix-
        cache entries whose only reference is the cache's own (reclaimed
        on demand by ``alloc``) — shared blocks never double-count
        against pool capacity."""
        n = self.free_list.num_free
        if self.prefix_cache is not None:
            n += self.prefix_cache.n_reclaimable
        return n

    @property
    def capacity(self) -> int:
        return self.free_list.capacity

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently held by requests —
        the complement of ``num_free``, so cache-only (reclaimable)
        prefix blocks count as free here too."""
        return (self.capacity - self.num_free) / max(self.capacity, 1)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return -(-n_tokens // self.block_size)

    def stats(self) -> dict[str, int]:
        """Point-in-time accounting for tests and reports: raw free-list
        state plus the prefix-cache split (``cache_only`` blocks are held
        solely by the cache's own reference and are reclaimable on
        demand), ``request_held = allocated - cache_only``, and
        ``shard_stats``."""
        allocated = self.free_list.num_allocated
        cache_only = (
            self.prefix_cache.n_reclaimable
            if self.prefix_cache is not None else 0
        )
        out = {
            "capacity": self.capacity,
            "free": self.free_list.num_free,
            "allocated": allocated,
            "cache_only": cache_only,
            "request_held": allocated - cache_only,
        }
        out.update(self.shard_stats())
        return out

    def shard_stats(self) -> dict[str, int]:
        """Per-shard KV slab accounting (the ``/metrics`` scrape and the
        serve banner read it): ``kv_bytes_total``, the bytes of the whole
        logical slab (every KV head), ``kv_bytes_shard``, what this rank
        holds, and ``kv_shards``, the distinct shards the slab splits
        into (their ratio).  Off a mesh the shard is the whole slab.  Under
        tensor parallelism with the KV heads sharded there are ``model``
        shards; with them replicated each rank holds only the heads its
        query heads read, so the slab splits into as many distinct shards
        as that leaves (the JAX pool reports 1 there: its replicated slab
        is whole on every device).  Occupancy needs no per-shard variant:
        the free list is global."""
        if self.pages is None:  # a retired engine's pool released its pages
            return {"kv_bytes_total": 0, "kv_bytes_shard": 0, "kv_shards": 1}
        shard = int(sum(a.numel() * a.element_size() for a in self.pages if a is not None))
        # every page is linear in its head count
        total = shard // self.kv_heads * self.config.num_key_value_heads
        return {
            "kv_bytes_total": total,
            "kv_bytes_shard": shard,
            "kv_shards": max(round(total / shard), 1) if shard else 1,
        }

    def alloc(self, n: int) -> list[int] | None:
        if (
            self.prefix_cache is not None
            and n > self.free_list.num_free
        ):
            # evict LRU cache-only entries to cover the shortfall
            self.prefix_cache.release(n - self.free_list.num_free)
        return self.free_list.alloc(n)

    def free(self, ids: list[int]) -> None:
        self.free_list.free(ids)

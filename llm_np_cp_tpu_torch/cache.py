"""Static preallocated KV cache (port of ``llm_np_cp_tpu/cache.py``).

    k, v:   [num_layers, batch, max_seq, num_kv_heads, head_dim]
    valid:  [batch, max_seq] bool — written AND not a pad token
    offset: int32 tensor on the cache's device — tokens written so far:
            0-d (one count for every row, the JAX cache's ``length``
            scalar) or ``[B]`` per row (the JAX cache's vector
            ``length``, which speculative decoding broadcasts a scalar
            one to at its first round and rolls back row by row)
    length: Python int — the same count kept on the host; with a ``[B]``
            offset an upper bound over the rows still writing, which
            the host sets from what it has fetched (it never reads the
            offsets back)

The JAX cache is an immutable pytree that jit donates and rebinds; here
the slabs are updated IN PLACE (``update_layer`` writes into the layer's
slots, ``truncate`` clears the bitmap), so one allocation serves the
whole generation.  A step reads its write slots, positions and mask from
``offset`` and advances it in place, so the step never reads the count
back and a CUDA graph of it replays at the right slots; whoever advances
``offset`` advances ``length`` too, and the host-side checks (capacity,
the flash prefill's fresh cache, chunk offsets) read ``length`` alone.
A ``[B]`` offset gives each row its own write slots
(``offset[:, None] + arange(S)``), positions and mask, and ``truncate``
rolls each row back to its own length on the card.

int8 mode (``dtype=torch.int8``): per-token-per-head symmetric absmax/127
scales ``[L, B, S, K]`` float32 ride beside the 1-byte slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device

CAPACITY_ALIGN = 128


def align_capacity(n: int) -> int:
    """Round a requested capacity up to a multiple of 128 (the same
    contract as the JAX package, so both size caches identically)."""
    return -(-n // CAPACITY_ALIGN) * CAPACITY_ALIGN


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S_max, K, D]
    v: torch.Tensor  # [L, B, S_max, K, D]
    valid: torch.Tensor  # [B, S_max] bool
    length: int = 0
    k_scale: torch.Tensor | None = None  # [L, B, S_max, K] f32 (int8 mode)
    v_scale: torch.Tensor | None = None
    offset: torch.Tensor | None = None  # 0-d or [B] int32 on the slabs' device
    # the static-shape decode steps built over this cache (generate.py),
    # keyed by their static inputs: a CUDA graph replays this cache's
    # addresses, so it lives as long as the cache does
    steps: dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.offset is None:
            self.offset = torch.full((), self.length, dtype=torch.int32, device=self.k.device)

    def set_length(self, n: int) -> None:
        """Move both counts to ``n`` (the device one in place, every row
        of a ``[B]`` offset, no sync)."""
        self.length = n
        self.offset.fill_(n)

    @classmethod
    def init(
        cls,
        config: ModelConfig,
        batch_size: int,
        max_seq_len: int,
        dtype: torch.dtype = torch.bfloat16,
        *,
        device: str | torch.device = "cuda",
        kv_heads: int | None = None,
    ) -> "KVCache":
        """Allocate zeroed slabs with capacity ``max_seq_len`` on ``device``
        (callers that derive capacity from request shapes round it up with
        ``align_capacity`` first; ``init`` honours the exact value).
        ``kv_heads``: the KV heads a rank holds under a tensor-parallel
        mesh (``parallel.sharding.local_kv_heads``); default all."""
        dev = resolve_device(device)
        shape = (
            config.num_hidden_layers,
            batch_size,
            max_seq_len,
            kv_heads or config.num_key_value_heads,
            config.head_dim,
        )
        quantized = dtype == torch.int8
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            valid=torch.zeros((batch_size, max_seq_len), dtype=torch.bool, device=dev),
            length=0,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev) if quantized else None,
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev) if quantized else None,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]

    def positions(self) -> torch.Tensor:
        """Absolute position of every cache slot: ``[S_max]`` int32."""
        return torch.arange(self.max_seq_len, dtype=torch.int32, device=self.k.device)


def truncate(cache: KVCache, new_length: int | torch.Tensor) -> KVCache:
    """Logically roll the cache back, in place: slots at or past the new
    length are marked invalid and the offset moves back; the slabs are
    left as they are and later writes overwrite them.

    new_length: a host int (every row; ``length`` moves too), or a
    ``[B]`` device tensor for a cache with a per-row offset — each row
    keeps its own count, cleared on the card with no sync, and the host
    ``length`` stays where it was, an upper bound when no row grows."""
    if isinstance(new_length, int):
        cache.valid[:, new_length:] = False
        cache.set_length(new_length)
        return cache
    if cache.offset.ndim != 1 or new_length.shape != cache.offset.shape:
        raise ValueError(
            f"truncate to [B] lengths {tuple(new_length.shape)} needs a per-row "
            f"offset of that shape, got "
            f"{tuple(cache.offset.shape)}"
        )
    keep = torch.arange(cache.max_seq_len, device=cache.valid.device)[None, :] < new_length[:, None]
    cache.valid &= keep
    cache.offset.copy_(new_length)
    return cache


def cache_slots(offset: int | torch.Tensor, b: int, s_new: int, s_max: int,
                device: torch.device) -> torch.Tensor:
    """``[B, S_new]`` int64 cache slots of a write of ``s_new`` tokens at
    ``offset``: a host int (checked against the capacity ``s_max``), a
    0-d device tensor, or a ``[B]`` one, each row at its own offset
    (device offsets are never read back: their caller checks the
    capacity on its host bound).  A per-row slot past the capacity —
    only a row that has stopped writing gets there — is clamped to the
    last slot, whose contents that row never reads again."""
    arange = torch.arange(s_new, device=device)
    if isinstance(offset, torch.Tensor):
        if offset.ndim == 1:
            return torch.clamp_max(offset.long()[:, None] + arange, s_max - 1)
        base = offset.long()
    elif isinstance(offset, int):
        if offset < 0 or offset + s_new > s_max:
            raise ValueError(
                f"cache write [{offset}, {offset + s_new}) outside capacity {s_max}"
            )
        base = offset
    else:
        raise TypeError(f"the cache offset must be an int or a tensor, got {type(offset)}")
    return (base + arange).expand(b, s_new)


def write_slots(slab: torch.Tensor, new: torch.Tensor, slots: torch.Tensor) -> None:
    """``slab[b, slots[b, j]] = new[b, j]`` along the seq axis, IN PLACE
    (slab [B, S_max, ...], new [B, S_new, ...], slots [B, S_new])."""
    idx = slots.reshape(*slots.shape, *(1,) * (new.ndim - 2)).expand(new.shape)
    slab.scatter_(1, idx, new.to(slab.dtype))


def update_layer(
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new keys/values at ``offset`` along the seq axis, IN PLACE.

    k_layer/v_layer: [B, S_max, K, D]; k_new/v_new: [B, S_new, K, D];
    offset: a host int, a 0-d or ``[B]`` device tensor, or the
    ``[B, S_new]`` slots ``cache_slots`` made of one.  Unlike the JAX
    version (whose clamped dynamic_update_slice silently corrupts an
    overflowing write), an out-of-capacity host offset raises.  Returns
    the (updated) layer slabs.
    """
    slots = _slots(offset, k_new, k_layer)
    write_slots(k_layer, k_new, slots)
    write_slots(v_layer, v_new, slots)
    return k_layer, v_layer


def _slots(offset: int | torch.Tensor, k_new: torch.Tensor, k_layer: torch.Tensor) -> torch.Tensor:
    b, s_new = k_new.shape[:2]
    if isinstance(offset, torch.Tensor) and offset.shape == (b, s_new):
        return offset
    return cache_slots(offset, b, s_new, k_layer.shape[1], k_layer.device)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8: x [..., D] float →
    (int8 [..., D], f32 absmax/127 scale [...]).  A zero row keeps
    scale 0, so the slot reads back as exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 [..., D] × scale [...] → float [..., D], the product taken in
    ``dtype`` (as the JAX op does)."""
    return q.to(dtype) * scale[..., None].to(dtype)


def update_layer_quantized(
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    ks_layer: torch.Tensor,
    vs_layer: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``update_layer`` for the int8 cache: quantize the new tokens' K/V
    and write values and scales at ``offset``, IN PLACE."""
    slots = _slots(offset, k_new, k_layer)
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    write_slots(k_layer, kq, slots)
    write_slots(v_layer, vq, slots)
    write_slots(ks_layer, ks, slots)
    write_slots(vs_layer, vs, slots)
    return k_layer, v_layer, ks_layer, vs_layer

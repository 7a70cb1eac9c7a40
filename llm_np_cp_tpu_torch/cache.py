"""Static preallocated KV cache (port of ``llm_np_cp_tpu/cache.py``).

    k, v:  [num_layers, batch, max_seq, num_kv_heads, head_dim]
    valid: [batch, max_seq] bool — written AND not a pad token
    length: Python int — tokens written so far

The JAX cache is an immutable pytree that jit donates and rebinds; here
the slabs are updated IN PLACE (``update_layer`` writes into the layer's
slice, ``truncate`` clears the bitmap), so one allocation serves the
whole generation.  Only the scalar offset is ported: per-row ``[B]``
lengths belong to speculative decoding, which is a later slice.

int8 mode (``dtype=torch.int8``): per-token-per-head symmetric absmax/127
scales ``[L, B, S, K]`` float32 ride beside the 1-byte slabs.
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def init(
        cls,
        config: ModelConfig,
        batch_size: int,
        max_seq_len: int,
        dtype: torch.dtype = torch.bfloat16,
        *,
        device: str | torch.device = "cuda",
    ) -> "KVCache":
        """Allocate zeroed slabs with capacity ``max_seq_len`` on ``device``
        (callers that derive capacity from request shapes round it up with
        ``align_capacity`` first; ``init`` honours the exact value)."""
        dev = resolve_device(device)
        shape = (
            config.num_hidden_layers,
            batch_size,
            max_seq_len,
            config.num_key_value_heads,
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


def truncate(cache: KVCache, new_length: int) -> KVCache:
    """Logically roll the cache back to ``new_length`` tokens, in place:
    slots ≥ new_length are marked invalid and ``length`` moves back; the
    slabs are left as they are and later writes overwrite them."""
    if not isinstance(new_length, int):
        raise TypeError(
            "truncate takes a scalar int length; per-row [B] lengths are "
            "not ported yet"
        )
    cache.valid[:, new_length:] = False
    cache.length = new_length
    return cache


def _check_offset(offset: int, s_new: int, s_max: int) -> None:
    if not isinstance(offset, int):
        raise TypeError(
            "the cache offset must be a Python int; per-row [B] offsets "
            "are not ported yet"
        )
    if offset < 0 or offset + s_new > s_max:
        raise ValueError(
            f"cache write [{offset}, {offset + s_new}) outside capacity {s_max}"
        )


def update_layer(
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new keys/values at ``offset`` along the seq axis, IN PLACE.

    k_layer/v_layer: [B, S_max, K, D]; k_new/v_new: [B, S_new, K, D].
    Unlike the JAX version (whose clamped dynamic_update_slice silently
    corrupts an overflowing write), an out-of-capacity write raises.
    Returns the (updated) layer slabs.
    """
    _check_offset(offset, k_new.shape[1], k_layer.shape[1])
    s_new = k_new.shape[1]
    k_layer[:, offset:offset + s_new] = k_new.to(k_layer.dtype)
    v_layer[:, offset:offset + s_new] = v_new.to(v_layer.dtype)
    return k_layer, v_layer


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
    offset: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``update_layer`` for the int8 cache: quantize the new tokens' K/V
    and write values and scales at ``offset``, IN PLACE."""
    _check_offset(offset, k_new.shape[1], k_layer.shape[1])
    s_new = k_new.shape[1]
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    sl = slice(offset, offset + s_new)
    k_layer[:, sl] = kq
    v_layer[:, sl] = vq
    ks_layer[:, sl] = ks
    vs_layer[:, sl] = vs
    return k_layer, v_layer, ks_layer, vs_layer

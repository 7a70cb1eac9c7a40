"""Blockwise (flash) causal attention for prefill.

Port of ``llm_np_cp_tpu/ops/pallas/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu``: bfloat16 on the tensor cores (``mma.sync``
tiles, ``cp.async`` double-buffered K/V), float32 on the CUDA cores;
``flash_attention_plain`` is the same function in plain PyTorch (the CPU
path and the kernel's reference).

Self-attention only (Sq == Skv, positions 0..S-1): the prefill path.
GQA head grouping, causal masking, sliding window and attention-logit
softcapping.

``flash_plan`` picks the kernel's tiles; ``kv_band`` and ``tile_class``
mirror the kernel's band and per-warp tile classes, so the CPU tests can
hold them against a brute-force mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from llm_np_cp_tpu_torch.ops.attention import causal_mask, gqa_attention
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library

# a block's shared memory on the H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# bfloat16 tiles (BQ, BKV, warps) by head dim, the fastest of the tile
# sweeps in PERF.md: a warp owns BQ / warps q rows, one or two 16-row m
# tiles
_MMA_TILES = {64: (128, 64, 4), 128: (64, 64, 4), 256: (64, 32, 4)}
# float32 (the scalar kernel): BQ 64, 256 threads, BKV by head dim
_F32_BQ, _F32_WARPS = 64, 8
_F32_BKV = {64: 64, 128: 64, 256: 32}


class FlashPlan(NamedTuple):
    """The kernel's tiles for one (S, D, dtype): ``bq`` q rows and ``bkv``
    kv rows a tile, ``warps`` a block, ``smem_bytes`` of dynamic shared
    memory a block, ``q_tiles`` q tiles a (batch, head), and whether it is
    the tensor-core kernel (``mma``)."""

    bq: int
    bkv: int
    warps: int
    smem_bytes: int
    q_tiles: int
    mma: bool

    @property
    def warp_rows(self) -> int:
        """q rows a warp owns (the tensor-core kernel's unit of tile_class)."""
        return self.bq // self.warps

    def grid(self, b: int, h: int) -> tuple[int, int]:
        """The launch grid for batch ``b`` and ``h`` q heads: (B·H, q
        tiles) for the tensor-core kernel, so the heaviest q tile of every
        head goes first; (q tiles, B·H) for the scalar one."""
        return (b * h, self.q_tiles) if self.mma else (self.q_tiles, b * h)


@functools.lru_cache(maxsize=256)
def flash_plan(s: int, d: int, dtype: torch.dtype) -> FlashPlan:
    """The tiles ``csrc/flash_attention.cu`` runs for sequence length
    ``s``, head dim ``d`` and element type ``dtype``; raises for a head
    dim or type the kernel does not take.  The launcher refuses a plan
    that names no instantiated kernel."""
    code = _common.dtype_code("flash_attention", dtype)
    _common.check_head_dim("flash_attention", d)
    if code == 1:
        bq, bkv, warps = _MMA_TILES[d]
        smem = 2 * (bq * d + 4 * bkv * d)  # Q, then K and V in two buffers
    else:
        bq, bkv, warps = _F32_BQ, _F32_BKV[d], _F32_WARPS
        # Q and K padded to D + 1, V, and P padded to BKV + 1, all float32
        smem = 4 * (bq * (d + 1) + bkv * (d + 1) + bkv * d + bq * (bkv + 1))
    return FlashPlan(bq, bkv, warps, smem, -(-s // bq), code == 1)


def kv_band(q0: int, bq: int, bkv: int, s: int, window: int | None) -> tuple[int, int]:
    """The kv tiles [jmin, jmax] that the kernel loads for the q tile
    starting at row ``q0``: the JAX kernel's ``_kv_block_bounds``, its
    upper end cut at the last tile that holds a column below ``s``."""
    jmax = min(q0 + bq - 1, s - 1) // bkv
    if not window:
        return 0, jmax
    return max((q0 - window - bkv + 1) // bkv + 1, 0), jmax


def tile_class(r0: int, nrows: int, kv0: int, bkv: int, s: int, window: int | None) -> int:
    """What q rows [r0, r0 + nrows) see of kv columns [kv0, kv0 + bkv)
    under the causal (+ window) mask over positions 0..s-1, rows >= s not
    counting (they are never written): 0 nothing (the warp skips the
    tile), 1 part of it (element mask), 2 all of it (no mask).  The
    kernel's ``tile_class``, line for line."""
    window = window or 0
    if r0 >= s:
        return 0
    r_hi = min(r0 + nrows - 1, s - 1)
    c_hi = min(kv0 + bkv - 1, s - 1)
    if kv0 > r_hi or (window > 0 and r0 - c_hi >= window):
        return 0
    if kv0 + bkv - 1 <= r0 and kv0 + bkv <= s and (window <= 0 or r_hi - kv0 < window):
        return 2
    return 1


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float, logit_softcap: float | None = None, window: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``gqa_attention`` under a causal (+window)
    mask over positions 0..S-1."""
    pos = torch.arange(q.shape[1], device=q.device)
    mask = causal_mask(pos[None, :], pos, window=window)
    return gqa_attention(q, k, v, mask, scale=scale, logit_softcap=logit_softcap)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float, logit_softcap: float | None = None, window: int | None = None,
) -> torch.Tensor:
    """Causal self-attention: q [B, S, H, D], k/v [B, S, K, D] → [B, S, H, D].

    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel (float32 or bfloat16, head_dim 64/128/256) or raise.
    """
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if _common.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale=scale, logit_softcap=logit_softcap, window=window)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    plan = flash_plan(s, d, q.dtype)
    _common.check_contiguous("flash_attention", q=q, k=k, v=v)
    if plan.mma and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention: bfloat16 q, k and v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    err = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], d, float(scale), float(logit_softcap or 0.0),
        int(window or 0), _common.DTYPE_CODES[q.dtype], plan.bq, plan.bkv, plan.warps, plan.smem_bytes,
        _common.stream_ptr(q),
    )
    check(err, "flash_attention")
    _common.count(flash_attention, "launches")
    return out


flash_attention.launches = 0

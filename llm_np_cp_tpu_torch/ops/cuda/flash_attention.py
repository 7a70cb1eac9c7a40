"""Blockwise (flash) causal attention for prefill.

Port of ``llm_np_cp_tpu/ops/pallas/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu``; ``flash_attention_plain`` is the same
function in plain PyTorch (the CPU path and the kernel's reference).

Self-attention only (Sq == Skv, positions 0..S-1): the prefill path.
GQA head grouping, causal masking, sliding window and attention-logit
softcapping.
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.ops.attention import causal_mask, gqa_attention
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library


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
    code = _common.dtype_code("flash_attention", q.dtype)
    _common.check_head_dim("flash_attention", d)
    _common.check_contiguous("flash_attention", q=q, k=k, v=v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    err = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], d, float(scale), float(logit_softcap or 0.0),
        int(window or 0), code, _common.stream_ptr(q),
    )
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""Grouped-query attention (port of ``llm_np_cp_tpu/ops/attention.py``).

The plain path that the JAX package leaves to XLA: q is reshaped to
[B, S, K, G, D] and contracted against the K kv heads directly (no KV
repetition), scores and softmax in float32 with max-subtraction, and
boolean masks built from positions.  Products of low-precision inputs are
taken in float32 (the JAX einsums' ``preferred_element_type``).
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.ops.activations import softcap as _softcap

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    window: int | None = None,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Boolean attention predicate.

    q_positions: [B, Sq] absolute positions of the query tokens.
    kv_positions: [Skv] or [B, Skv] absolute positions of cache slots.
    window: if set, also require ``q_pos - kv_pos < window``.
    kv_valid: optional [B, Skv] validity of cache slots.

    Returns bool [B, Sq, Skv]; True = attend.
    """
    if kv_positions.ndim == 1:
        kv_positions = kv_positions[None, :]
    q = q_positions[:, :, None]
    kv = kv_positions[:, None, :]
    mask = kv <= q
    if window is not None:
        mask = mask & (q - kv < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: float,
    logit_softcap: float | None = None,
    return_weights: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention over grouped KV heads.

    q: [B, Sq, H, D]  (H = K * G query heads)
    k, v: [B, Skv, K, D]
    mask: bool, broadcastable to [B, Sq, Skv] (True = attend)

    Returns [B, Sq, H, D] in q.dtype (and the [B, H, Sq, Skv] weights
    when ``return_weights``).
    """
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d)

    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = _softcap(scores, logit_softcap)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)

    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(dim=-1, keepdim=True)

    out = torch.einsum(
        "bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float()
    )
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if return_weights:
        return out, probs.reshape(b, h, sq, skv)
    return out

"""Fused decode-step attention over the static KV cache slab.

Port of ``decode_attention`` in ``llm_np_cp_tpu/ops/pallas/decode_attention.py``
(the paged and ragged kernels of that file belong to the serve slice).
The kernel is ``csrc/decode_attention.cu``; ``decode_attention_plain`` is
the same function in plain PyTorch.

Mask-driven like the TPU kernel: the caller passes the same [B, S] bool
mask the plain path uses (cache validity, causality, sliding window,
ragged-batch pads), and only the kv blocks between each row's first and
last visible slot are read.  A row with nothing visible yields zeros.
The TPU kernel's block-size search and cache padding exist for Mosaic's
tiling rules and are not ported.
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.ops.attention import NEG_INF
from llm_np_cp_tpu_torch.ops.activations import softcap as _softcap
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library


def _check_int8(k, v, k_scale, v_scale) -> bool:
    quantized = k_scale is not None
    if (
        quantized != (k.dtype == torch.int8)
        or quantized != (v.dtype == torch.int8)
        or quantized != (v_scale is not None)
    ):
        raise ValueError(
            "int8 k AND v require both k_scale and v_scale (and vice "
            f"versa); got k={k.dtype}, v={v.dtype}, "
            f"k_scale={'set' if k_scale is not None else None}, "
            f"v_scale={'set' if v_scale is not None else None}"
        )
    return quantized


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: float32 scores,
    unnormalised p zeroed on masked slots, p rounded to the value dtype
    before the PV product, division by the float32 sum (zeros where it
    is 0).  An int8 cache is dequantised in q's dtype first."""
    b, _, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale[..., None].to(q.dtype)
        v = v.to(q.dtype) * v_scale[..., None].to(q.dtype)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if logit_softcap is not None:
        s = _softcap(s, logit_softcap)
    vis = mask[:, None, None, :]
    s = torch.where(vis, s, NEG_INF)
    p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """One-token GQA attention against the cache.

    q [B, 1, H, D], k/v [B, S, K, D], mask [B, S] bool (True = visible)
    → [B, 1, H, D].  int8 cache mode: k/v int8 with ``k_scale``/``v_scale``
    [B, S, K] float32 (``cache.quantize_kv`` layout).

    CPU tensors run ``decode_attention_plain``; CUDA tensors launch the
    kernel or raise.
    """
    quantized = _check_int8(k, v, k_scale, v_scale)
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"decode_attention is q_len=1 only, got {one}")
    _, s, kh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if mask.shape != (b, s) or mask.dtype != torch.bool:
        raise ValueError(f"decode_attention: mask must be bool [{b}, {s}], got {mask.dtype} {tuple(mask.shape)}")
    scales = (k_scale, v_scale) if quantized else ()
    if quantized and (k_scale.shape != (b, s, kh) or v_scale.shape != (b, s, kh)):
        raise ValueError(f"decode_attention: scales must be [{b}, {s}, {kh}]")
    if _common.on_cpu(q, k, v, mask, *scales):
        return decode_attention_plain(
            q, k, v, mask, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    code = _common.dtype_code("decode_attention", q.dtype)
    if not quantized and k.dtype != q.dtype:
        raise TypeError(f"decode_attention: k/v dtype {k.dtype} != q dtype {q.dtype}")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("decode_attention: int8 scales must be float32")
    _common.check_head_dim("decode_attention", d)
    if (h // kh) * d > 2048:
        raise ValueError(f"decode_attention: query group x head_dim {(h // kh) * d} > 2048")
    _common.check_contiguous("decode_attention", q=q, k=k, v=v, mask=mask)
    if quantized:
        _common.check_contiguous("decode_attention", k_scale=k_scale, v_scale=v_scale)
    out = torch.empty_like(q)
    err = library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        mask.data_ptr(), out.data_ptr(), b, s, h, kh, d, float(scale),
        float(logit_softcap or 0.0), code, int(quantized), _common.stream_ptr(q),
    )
    check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

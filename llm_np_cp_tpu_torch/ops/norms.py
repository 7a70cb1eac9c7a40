"""RMS normalization (port of ``llm_np_cp_tpu/ops/norms.py``).

``x * rsqrt(mean(x^2, -1) + eps) * weight`` with Gemma's ``(1 + w)``
parameterization under ``unit_offset``.  The reduction and rsqrt run in
float32 whatever the input dtype, and the result is cast back to it.
"""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
    unit_offset: bool = False,
) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if unit_offset:
        w = w + 1.0
    return (normed * w).to(dtype)

"""Activations and soft-capping (port of ``llm_np_cp_tpu/ops/activations.py``).

Tanh-approx GELU, SiLU, ReLU, the ``ACT2FN`` registry, and Gemma's soft
cap ``tanh(x/c)*c``.
"""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``gelu_pytorch_tanh``: 0.5x(1 + tanh(sqrt(2/pi)(x + 0.044715 x^3)))."""
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


ACT2FN = {
    "silu": silu,
    "gelu_pytorch_tanh": gelu_tanh,
    "relu": relu,
}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap`` — Gemma-2 logit/score capping."""
    return torch.tanh(x / cap) * cap

"""Rotary position embeddings (port of ``llm_np_cp_tpu/ops/rope.py``).

``inv_freq = base^(-2i/d)``, cos/sin built by duplicating the frequency
block along the last axis, rotation with the half-split ``rotate_half``
convention, and llama-3 rope scaling (smooth low/high frequency
interpolation).
"""

from __future__ import annotations

import math

import torch

from llm_np_cp_tpu_torch.config import ModelConfig


def _inv_freq(config: ModelConfig, device: torch.device) -> torch.Tensor:
    dim = config.head_dim
    inv_freq = 1.0 / (
        config.rope_theta
        ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    )
    if config.rope_scaling_type == "llama3":
        # high-frequency components unchanged, low-frequency components
        # divided by `factor`, linear ramp between the corner wavelengths
        factor = config.rope_scaling_factor
        low = config.rope_scaling_low_freq_factor
        high = config.rope_scaling_high_freq_factor
        orig = config.rope_scaling_original_max_position
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig / low
        high_wavelen = orig / high
        smooth = (orig / wavelen - low) / (high - low)
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        interp = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = torch.where(is_medium, interp, scaled)
    return inv_freq


def rope_cos_sin(
    positions: torch.Tensor, config: ModelConfig,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any leading shape) → [..., head_dim]."""
    inv_freq = _inv_freq(config, positions.device)
    freqs = positions.float()[..., None] * inv_freq  # [..., dim/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., dim]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate ``x``: [..., S, n_heads, head_dim] with cos/sin [..., S, head_dim].

    The arithmetic runs in the promoted dtype of ``x`` and the float32
    tables, and the result is cast back to ``x.dtype``, as in the JAX op.
    """
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return (x * cos + rotate_half(x) * sin).to(x.dtype)

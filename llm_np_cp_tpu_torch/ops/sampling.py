"""Token sampling (port of ``llm_np_cp_tpu/ops/sampling.py``).

Greedy argmax, min-p, top-k, top-p and the inverse-CDF draw over a
``[..., vocab]`` logits tensor.  Draws take a key (``random``: a ``[2]``
key over the whole tensor, or ``[N, 2]`` keys, one a row) and draw
``jax.random``'s bits, so a sampled token equals the JAX package's
wherever the logits agree.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from llm_np_cp_tpu_torch import random

NEG_INF = float(torch.finfo(torch.float32).min)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis → int32 token ids (first maximal index
    on ties, like ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def min_p_mask(logits: torch.Tensor, p_base: float) -> torch.Tensor:
    """Mask logits of tokens with prob < max_prob * p_base."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    keep = logp >= (logp.amax(dim=-1, keepdim=True) + math.log(p_base))
    return torch.where(keep, logits, NEG_INF)


def min_p(key: torch.Tensor, logits: torch.Tensor, p_base: float = 0.1,
          row0: int = 0) -> torch.Tensor:
    """One min-p draw per row: ``categorical`` over ``min_p_mask``."""
    return random.categorical(key, min_p_mask(logits, p_base), row0)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    k = min(max(k, 1), logits.shape[-1])  # HF-style clamp: k=0 / k>V are user input
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits >= kth, logits, NEG_INF)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest prefix of the sorted distribution with
    cumulative prob >= p (the top token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    keep_sorted[..., 0] = True
    threshold = torch.where(
        keep_sorted, sorted_logits, torch.inf
    ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, NEG_INF)


def sample_cdf(key: torch.Tensor, logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Inverse-CDF draw — the vectorized form of the reference's Python
    probability walk — with one uniform a row of ``logits [N, ..., V]``
    (``row0``: under one key, rows from row0 on of a larger draw, whose
    uniforms they take; keys a row take row0 = 0)."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = random.uniform(key, (row0 + logits.shape[0], *logits.shape[1:-1], 1))[row0:]
    return (cdf < u).sum(dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Static sampler spec.  ``__call__(key, logits)`` draws under ``key``
    (a ``[2]`` key, or ``[N, 2]`` keys for logits ``[N, V]``, on
    ``logits.device``; greedy takes None).

    kind: "greedy" | "min_p" | "cdf" | "top_k" | "top_p"
    """

    kind: str = "greedy"
    temperature: float = 1.0
    p_base: float = 0.1
    top_k: int = 50
    top_p: float = 0.9

    def __call__(self, key: torch.Tensor | None, logits: torch.Tensor,
                 row0: int = 0) -> torch.Tensor:
        """``row0``: under one key, ``logits [N, V]`` are the rows from
        row0 on of a larger batch (a data-parallel rank's rows), and draw
        that batch's bits."""
        logits = logits.float()
        if self.kind == "greedy":
            return greedy(logits)
        if self.kind == "cdf":
            if self.temperature != 1.0:
                logits = logits / self.temperature
            return sample_cdf(key, logits, row0)
        return random.categorical(key, self.filtered_logits(logits), row0)

    def filtered_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Post-filter logits whose softmax is this sampler's effective
        token distribution.  Greedy degenerates to a one-hot on the FIRST
        maximal index."""
        logits = logits.float()
        if self.kind == "greedy":
            idx = torch.argmax(logits, dim=-1, keepdim=True)
            iota = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(iota == idx, 0.0, NEG_INF)
        if self.temperature != 1.0:
            logits = logits / self.temperature
        if self.kind == "min_p":
            return min_p_mask(logits, self.p_base)
        if self.kind == "cdf":
            return logits
        if self.kind == "top_k":
            return top_k_mask(logits, self.top_k)
        if self.kind == "top_p":
            return top_p_mask(logits, self.top_p)
        raise ValueError(f"unknown sampler kind: {self.kind}")

"""Token sampling (port of ``llm_np_cp_tpu/ops/sampling.py``).

Greedy argmax, min-p, top-k, top-p and the inverse-CDF draw over a
``[..., vocab]`` logits tensor.  Draws use an explicit ``torch.Generator``
in place of a ``jax.random`` key: the two give different streams from
the same seed, so only greedy is token-identical to the JAX package and
the stochastic kinds match it in distribution (their filtered logits).
"""

from __future__ import annotations

import dataclasses
import math

import torch

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


def _categorical(gen: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=gen)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def sample_cdf(gen: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw — the vectorized form of the reference's Python
    probability walk."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = torch.rand(
        logits.shape[:-1] + (1,), generator=gen, device=logits.device,
        dtype=torch.float32,
    )
    return (cdf < u).sum(dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Static sampler spec.  ``__call__(gen, logits)`` draws with the
    ``torch.Generator`` ``gen`` (which must live on ``logits.device``).

    kind: "greedy" | "min_p" | "cdf" | "top_k" | "top_p"
    """

    kind: str = "greedy"
    temperature: float = 1.0
    p_base: float = 0.1
    top_k: int = 50
    top_p: float = 0.9

    def __call__(self, gen: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
        logits = logits.float()
        if self.kind == "greedy":
            return greedy(logits)
        if self.kind == "cdf":
            if self.temperature != 1.0:
                logits = logits / self.temperature
            return sample_cdf(gen, logits)
        return _categorical(gen, self.filtered_logits(logits))

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

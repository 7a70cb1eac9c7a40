"""Quantization quality: greedy divergence and logit error against the
float model (port of ``llm_np_cp_tpu/utils/quality.py``).

For each mode: how many greedy steps match the float baseline token for
token, and the mean / largest absolute logit difference teacher-forced
on the baseline's own continuation (both models score the same prefix,
so the token drift does not compound).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.generate import Generator
from llm_np_cp_tpu_torch.models.transformer import forward
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.quant import quantize_params

MODES = ("int8", "int8_a8", "int4", "int4_a8", "kv_int8")


def quant_quality(
    config: ModelConfig,
    params: dict[str, Any],
    mode: str,
    *,
    steps: int = 256,
    prompt_len: int = 16,
    seed: int = 0,
    base_dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    **generator_kw: Any,
) -> dict:
    """Compare one quantization mode against the float baseline.

    Returns ``divergence_step`` (index of the first greedy token that
    differs; ``steps`` when the whole continuation matches) and
    ``logit_mae`` / ``logit_max_abs_err`` (teacher-forced on the baseline
    continuation).  ``generator_kw`` goes to both ``Generator``s (the
    attention impls).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    sampler = Sampler(kind="greedy")
    base = Generator(params, config, sampler=sampler, cache_dtype=base_dtype, device=device,
                     **generator_kw)
    if mode == "kv_int8":
        qparams, cache_dtype = params, torch.int8
    else:
        qparams = quantize_params(
            params, bits=4 if mode.startswith("int4") else 8, act_quant=mode.endswith("_a8"))
        cache_dtype = base_dtype
    quant = Generator(qparams, config, sampler=sampler, cache_dtype=cache_dtype, device=device,
                      **generator_kw)

    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, config.vocab_size, (1, prompt_len))
    toks_b = base.generate(prompt, steps, seed=seed).tokens[0]
    toks_q = quant.generate(prompt, steps, seed=seed).tokens[0]
    mismatch = np.nonzero(toks_b != toks_q)[0]
    div_step = int(mismatch[0]) if mismatch.size else steps

    seq = torch.as_tensor(np.concatenate([prompt, toks_b[None, :]], axis=1), device=base.device)
    if mode == "kv_int8":
        # the KV cache exists only in cached decode: score the baseline
        # continuation through each generator's own cache
        delta = _cached_logit_delta(base, quant, seq, steps)
    else:
        # teacher-forced logits over prompt + baseline continuation
        logits_b, _ = forward(params, seq, config, None, device=base.device)
        logits_q, _ = forward(qparams, seq, config, None, device=base.device)
        delta = (logits_b.float() - logits_q.float()).abs().cpu().numpy()
    return {
        "mode": mode,
        "steps": steps,
        "divergence_step": div_step,
        "diverged": bool(mismatch.size),
        "logit_mae": round(float(delta.mean()), 6),
        "logit_max_abs_err": round(float(delta.max()), 4),
    }


def _cached_logit_delta(base: Generator, quant: Generator, seq: torch.Tensor,
                        steps: int) -> np.ndarray:
    """|Δlogits| between two generators' cached prefill over prefixes of
    ``seq`` ending at eight depths of the continuation."""
    deltas = []
    s = seq.shape[1]
    for end in np.linspace(max(2, s - steps), s, num=8, dtype=int):
        lb = _prefill_logits(base, seq[:, :end])
        lq = _prefill_logits(quant, seq[:, :end])
        deltas.append(np.abs(lb - lq))
    return np.concatenate(deltas, axis=None)


def _prefill_logits(gen: Generator, ids: torch.Tensor) -> np.ndarray:
    cache = gen._cache(ids.shape[0], ids.shape[1])
    _, _, logits = gen._prefill(gen.params, ids, cache, gen._key(0), None, None)
    return logits.float().cpu().numpy()

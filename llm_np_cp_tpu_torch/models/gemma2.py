"""Gemma-2 family binding.

Deltas vs Llama live in config flags consumed by ``models/transformer.py``
(SURVEY §2.7): unit-offset RMSNorm, 4-norm sandwich residual, embedding
scaling, GeGLU, final-logit + attention-logit softcapping, alternating
sliding/global attention.  The last two are implemented here even though the
reference drops them (gemma2_model.py applies neither — every layer is
global and scores are uncapped); ``ModelConfig.reference_parity()`` restores
the reference's simplified behavior for oracle comparisons.
"""

from __future__ import annotations

from llm_np_cp_tpu_torch.config import GEMMA_2_2B, GEMMA_2_9B, ModelConfig
from llm_np_cp_tpu_torch.models.llama import LAYER_KEY_MAP as _LLAMA_LAYER_KEY_MAP

# Gemma-2 checkpoints use llama-style keys plus the two extra per-layer
# norms; post_attention_layernorm moves to the attention-output slot
# (sandwich residual, gemma2_model.py:588-591).
LAYER_KEY_MAP: dict[str, tuple[str, bool]] = {
    **_LLAMA_LAYER_KEY_MAP,
    "post_attention_layernorm.weight": ("ln_attn_out", False),
    "pre_feedforward_layernorm.weight": ("ln_mlp_in", False),
    "post_feedforward_layernorm.weight": ("ln_mlp_out", False),
}

TOP_KEY_MAP: dict[str, tuple[str, bool]] = {
    "model.embed_tokens.weight": ("embed_tokens", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

CONFIGS: dict[str, ModelConfig] = {
    "google/gemma-2-2b": GEMMA_2_2B,
    "google/gemma-2-9b": GEMMA_2_9B,
}

"""Llama-3.x family binding.

The reference implements this family twice (CuPy: llama3.2_model.py, NumPy:
llama3.2_model_numpy.py, line-for-line twins — SURVEY §1).  Here the family
is a config preset plus HF checkpoint-name mapping; all math lives in
``models/transformer.py``.
"""

from __future__ import annotations

from llm_np_cp_tpu_torch.config import (
    LLAMA_3_1_8B,
    LLAMA_3_2_1B,
    LLAMA_3_2_3B,
    ModelConfig,
)

# HF checkpoint key → (param pytree path, transpose?) for one decoder layer.
# HF Linear weights are [out_features, in_features]
# (y = x @ W.T — llama3.2_model.py:116-136); we store (in, out), hence the
# transpose at load time.
LAYER_KEY_MAP: dict[str, tuple[str, bool]] = {
    "input_layernorm.weight": ("ln_attn_in", False),
    "self_attn.q_proj.weight": ("q_proj", True),
    "self_attn.k_proj.weight": ("k_proj", True),
    "self_attn.v_proj.weight": ("v_proj", True),
    "self_attn.o_proj.weight": ("o_proj", True),
    "post_attention_layernorm.weight": ("ln_mlp_in", False),
    "mlp.gate_proj.weight": ("gate_proj", True),
    "mlp.up_proj.weight": ("up_proj", True),
    "mlp.down_proj.weight": ("down_proj", True),
    # bias entries are consulted only when the config declares
    # attention_bias / mlp_bias (the loader's host buffers come from
    # param_shapes, which gates on those flags); 1-D, never transposed
    "self_attn.q_proj.bias": ("q_bias", False),
    "self_attn.k_proj.bias": ("k_bias", False),
    "self_attn.v_proj.bias": ("v_bias", False),
    "self_attn.o_proj.bias": ("o_bias", False),
    "mlp.gate_proj.bias": ("gate_bias", False),
    "mlp.up_proj.bias": ("up_bias", False),
    "mlp.down_proj.bias": ("down_bias", False),
}

TOP_KEY_MAP: dict[str, tuple[str, bool]] = {
    "model.embed_tokens.weight": ("embed_tokens", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

CONFIGS: dict[str, ModelConfig] = {
    "meta-llama/Llama-3.2-1B": LLAMA_3_2_1B,
    "meta-llama/Llama-3.2-3B": LLAMA_3_2_3B,
    "meta-llama/Llama-3.1-8B": LLAMA_3_1_8B,
}

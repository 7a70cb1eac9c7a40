"""Qwen-2 / Qwen-2.5 family binding (framework extension).

Not in the reference's scope (it implements Llama-3.2 and Gemma-2,
SURVEY §0); included because the architecture is exactly the llama
decoder with Q/K/V projection biases and an UNBIASED o_proj (HF
``Qwen2Attention``) — the bias pattern round 1 flagged as the
silent-wrongness class, now a first-class family.  Checkpoint keys match
the llama layout (``model.layers.N.self_attn.q_proj`` …), so the loader
reuses ``models.llama``'s key maps; the bias leaves are gated by
``ModelConfig.attention_bias`` / ``attention_out_bias`` via
``param_shapes``.  All math lives in ``models/transformer.py``.
"""

from __future__ import annotations

from llm_np_cp_tpu_torch.config import QWEN_2_5_0_5B, QWEN_2_5_1_5B, ModelConfig
from llm_np_cp_tpu_torch.models.llama import LAYER_KEY_MAP, TOP_KEY_MAP  # noqa: F401

CONFIGS: dict[str, ModelConfig] = {
    "Qwen/Qwen2.5-0.5B": QWEN_2_5_0_5B,
    "Qwen/Qwen2.5-1.5B": QWEN_2_5_1_5B,
}

"""Model configuration (the PyTorch port's own copy of
``llm_np_cp_tpu/config.py``; the port imports nothing of the JAX package).

The reference consumes a raw HF ``config.json`` through an ``AttributeDict``
with no validation or defaults (llama3.2_model.py:204-207, 1068-1073).  Here
the consumed key set (SURVEY §2.1) becomes an explicit frozen dataclass so a
config is a static, hashable value.  The JAX package's ``scan_unroll`` knob
(a layer-scan unroll factor for XLA) has no counterpart here: the port's
layer loop is a Python loop.

One dataclass covers both model families; the Gemma-2 deltas
(gemma2_model.py per SURVEY §2.7) are expressed as explicit fields rather
than a parallel class hierarchy:

- ``rms_norm_unit_offset``    — Gemma's (1 + w) RMSNorm parameterization
  (gemma2_model.py:334)
- ``sandwich_norms``          — 4 norms/layer with post-norms inside the
  residual (gemma2_model.py:588-591, 621-643)
- ``scale_embeddings``        — hidden *= sqrt(hidden_size) after lookup
  (gemma2_model.py:738-739)
- ``final_logit_softcapping`` — tanh soft cap on logits (gemma2_model.py:867-870)
- ``attn_logit_softcapping``  — soft cap on attention scores.  Present in the
  Gemma-2 config (gemma2_model.py:48) but NOT applied by the reference; we
  implement it correctly and expose ``reference_parity()`` to reproduce the
  reference's simplified behavior.
- ``sliding_window``          — local attention window, alternating
  local/global layers.  Also dropped by the reference (SURVEY §2.7).
- ``query_pre_attn_scalar``   — Gemma attention scale.  The reference
  computes it and then ignores it (gemma2_model.py:434 vs :541-543); we use
  it (identical for 2B/9B where it equals head_dim, correct for 27B).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description for a decoder-only transformer."""

    model_type: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    max_position_embeddings: int = 131072
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    # o_proj bias: None = follow attention_bias (HF Llama puts a bias on
    # all four attention projections); False = Qwen-2's pattern (Q/K/V
    # biased, o_proj not)
    attention_out_bias: bool | None = None
    mlp_bias: bool = False

    # --- RoPE scaling (llama-3 style). The reference ignores `rope_scaling`
    # entirely (SURVEY §2.2: "no llama-3 rope scaling"); we support it so
    # Llama-3.1/3.2 long-context positions are correct, and disable it in
    # reference-parity mode.
    rope_scaling_type: str | None = None  # None | "llama3"
    rope_scaling_factor: float = 8.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position: int = 8192

    # --- Gemma-2 deltas (SURVEY §2.7) ---
    rms_norm_unit_offset: bool = False
    sandwich_norms: bool = False
    scale_embeddings: bool = False
    final_logit_softcapping: float | None = None
    attn_logit_softcapping: float | None = None
    sliding_window: int | None = None
    # Layers with (layer_idx % 2 == 0) use the sliding window when
    # `sliding_window` is set; odd layers stay global (Gemma-2's hybrid
    # schedule, config key `cache_implementation: hybrid`, gemma2_model.py:104).
    query_pre_attn_scalar: float | None = None

    # --- Mixture-of-Experts (framework extension; neither reference family
    # is MoE — SURVEY §2.9 lists EP as N/A — but the framework supports
    # Mixtral-style sparse MLPs so expert parallelism has a real workload).
    num_local_experts: int | None = None
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0  # per-expert buffer = gs*k/E * this
    moe_group_size: int = 1024  # GShard token-group length (keeps dispatch linear in T)
    router_aux_loss_coef: float = 0.02

    def __post_init__(self) -> None:
        # Note: hidden_size need not equal heads*head_dim (Gemma-2-2B:
        # 2304 hidden, 8 heads of 256), so no divisibility constraint there.
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"num_attention_heads {self.num_attention_heads} not divisible "
                f"by num_key_value_heads {self.num_key_value_heads}"
            )

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_local_experts is not None

    @property
    def o_proj_bias(self) -> bool:
        if self.attention_out_bias is not None:
            return self.attention_out_bias
        return self.attention_bias

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def attn_scale(self) -> float:
        """Scale applied to q·k scores.

        Llama: 1/sqrt(head_dim) (llama3.2_model.py:467-469).  Gemma-2:
        query_pre_attn_scalar**-0.5 — the reference assigns this then ignores
        it (gemma2_model.py:434); we apply it.
        """
        if self.query_pre_attn_scalar is not None:
            return float(self.query_pre_attn_scalar) ** -0.5
        return float(self.head_dim) ** -0.5

    def layer_is_sliding(self, layer_idx: int) -> bool:
        return self.sliding_window is not None and layer_idx % 2 == 0

    # ------------------------------------------------------------------
    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "ModelConfig":
        """Build from a raw HF ``config.json`` mapping.

        Mirrors the key set the reference actually reads (SURVEY §2.1) plus
        the Gemma-2 keys it reads-but-drops (sliding_window,
        attn_logit_softcapping).
        """
        model_type = d.get("model_type", "llama")
        num_heads = d["num_attention_heads"]
        head_dim = d.get("head_dim") or d["hidden_size"] // num_heads
        kwargs: dict[str, Any] = dict(
            model_type=model_type,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=num_heads,
            num_key_value_heads=d.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            hidden_act=d.get("hidden_act", d.get("hidden_activation", "silu")),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            attention_bias=d.get("attention_bias", False),
            mlp_bias=d.get("mlp_bias", False),
        )
        if d.get("num_local_experts"):
            kwargs.update(
                num_local_experts=d["num_local_experts"],
                num_experts_per_tok=d.get("num_experts_per_tok", 2),
                router_aux_loss_coef=d.get("router_aux_loss_coef", 0.02),
            )
        rope_scaling = d.get("rope_scaling") or None
        if rope_scaling and rope_scaling.get("rope_type", rope_scaling.get("type")) == "llama3":
            kwargs.update(
                rope_scaling_type="llama3",
                rope_scaling_factor=rope_scaling.get("factor", 8.0),
                rope_scaling_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
                rope_scaling_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
                rope_scaling_original_max_position=rope_scaling.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        if model_type == "gemma2":
            kwargs.update(
                rms_norm_unit_offset=True,
                sandwich_norms=True,
                scale_embeddings=True,
                final_logit_softcapping=d.get("final_logit_softcapping"),
                attn_logit_softcapping=d.get("attn_logit_softcapping"),
                sliding_window=d.get("sliding_window"),
                query_pre_attn_scalar=d.get("query_pre_attn_scalar"),
                hidden_act=d.get("hidden_activation", d.get("hidden_act", "gelu_pytorch_tanh")),
            )
        if model_type == "qwen2":
            # Qwen-2/2.5: llama architecture with Q/K/V projection biases
            # and an unbiased o_proj (HF Qwen2Attention), untied head on
            # the larger sizes
            kwargs.update(
                attention_bias=True,
                attention_out_bias=False,
                tie_word_embeddings=d.get("tie_word_embeddings", False),
            )
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str | Path) -> "ModelConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))

    def reference_parity(self) -> "ModelConfig":
        """Variant reproducing the reference's *simplified* semantics.

        The reference drops attention-logit softcapping and sliding-window
        attention for Gemma-2 (SURVEY §2.7), divides scores by sqrt(head_dim)
        even when query_pre_attn_scalar differs, and ignores rope_scaling.
        Used for parity testing against the NumPy oracle in reference mode.
        """
        return dataclasses.replace(
            self,
            attn_logit_softcapping=None,
            sliding_window=None,
            query_pre_attn_scalar=None,
            rope_scaling_type=None,
        )


# ----------------------------------------------------------------------
# Presets: the model families the reference targets (SURVEY §0 table) plus
# the BASELINE.md configs 4-5 families.  Values match the published HF
# config.json for each model.
# ----------------------------------------------------------------------

LLAMA_3_2_1B = ModelConfig(
    model_type="llama",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_hidden_layers=16,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=64,
    max_position_embeddings=131072,
    rope_theta=500000.0,
    rms_norm_eps=1e-5,
    tie_word_embeddings=True,
    rope_scaling_type="llama3",
    rope_scaling_factor=32.0,
)

LLAMA_3_2_3B = dataclasses.replace(
    LLAMA_3_2_1B,
    hidden_size=3072,
    intermediate_size=8192,
    num_hidden_layers=28,
    num_attention_heads=24,
    num_key_value_heads=8,
    head_dim=128,
)

LLAMA_3_1_8B = dataclasses.replace(
    LLAMA_3_2_1B,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rope_scaling_factor=8.0,
    tie_word_embeddings=False,
)

GEMMA_2_2B = ModelConfig(
    model_type="gemma2",
    vocab_size=256000,
    hidden_size=2304,
    intermediate_size=9216,
    num_hidden_layers=26,
    num_attention_heads=8,
    num_key_value_heads=4,
    head_dim=256,
    max_position_embeddings=8192,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    hidden_act="gelu_pytorch_tanh",
    tie_word_embeddings=True,
    rms_norm_unit_offset=True,
    sandwich_norms=True,
    scale_embeddings=True,
    final_logit_softcapping=30.0,
    attn_logit_softcapping=50.0,
    sliding_window=4096,
    query_pre_attn_scalar=256.0,
)

GEMMA_2_9B = dataclasses.replace(
    GEMMA_2_2B,
    hidden_size=3584,
    intermediate_size=14336,
    num_hidden_layers=42,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=256,
)

# The one published Gemma-2 size where query_pre_attn_scalar (hidden /
# num_heads = 4608/32 = 144) differs from head_dim (128) — the scaling
# delta the reference computes and then ignores (gemma2_model.py:434 vs
# :541-543); we apply it, so this preset exercises the correct path.
GEMMA_2_27B = dataclasses.replace(
    GEMMA_2_2B,
    hidden_size=4608,
    intermediate_size=36864,
    num_hidden_layers=46,
    num_attention_heads=32,
    num_key_value_heads=16,
    head_dim=128,
    query_pre_attn_scalar=144.0,
)

QWEN_2_5_0_5B = ModelConfig(
    model_type="qwen2",
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_hidden_layers=24,
    num_attention_heads=14,
    num_key_value_heads=2,
    head_dim=64,
    max_position_embeddings=32768,
    rope_theta=1000000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    attention_bias=True,
    attention_out_bias=False,
)

QWEN_2_5_1_5B = dataclasses.replace(
    QWEN_2_5_0_5B,
    hidden_size=1536,
    intermediate_size=8960,
    num_hidden_layers=28,
    num_attention_heads=12,
    num_key_value_heads=2,
    head_dim=128,
)

PRESETS: dict[str, ModelConfig] = {
    "meta-llama/Llama-3.2-1B": LLAMA_3_2_1B,
    "meta-llama/Llama-3.2-3B": LLAMA_3_2_3B,
    "meta-llama/Llama-3.1-8B": LLAMA_3_1_8B,
    "google/gemma-2-2b": GEMMA_2_2B,
    "google/gemma-2-9b": GEMMA_2_9B,
    "google/gemma-2-27b": GEMMA_2_27B,
    "Qwen/Qwen2.5-0.5B": QWEN_2_5_0_5B,
    "Qwen/Qwen2.5-1.5B": QWEN_2_5_1_5B,
}


def tiny_config(model_type: str = "llama", **overrides: Any) -> ModelConfig:
    """Small config for tests: real structure, toy sizes."""
    base: dict[str, Any] = dict(
        model_type=model_type,
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=3,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        max_position_embeddings=512,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
    )
    if model_type == "gemma2":
        base.update(
            hidden_act="gelu_pytorch_tanh",
            rms_norm_unit_offset=True,
            sandwich_norms=True,
            scale_embeddings=True,
            final_logit_softcapping=30.0,
            attn_logit_softcapping=50.0,
            sliding_window=16,
            query_pre_attn_scalar=16.0,
        )
    if model_type == "qwen2":
        base.update(
            attention_bias=True,
            attention_out_bias=False,
            tie_word_embeddings=True,
        )
    base.update(overrides)
    return ModelConfig(**base)

"""Generic decoder-only transformer forward pass (port of
``llm_np_cp_tpu/models/transformer.py``).

Llama-3.x (pre-norm, SwiGLU, tied head), Gemma-2 (sandwich norms,
embedding scaling, GeGLU, attention and final-logit softcaps, alternating
sliding/global layers), Qwen-2 (Q/K/V biases) and Mixtral-style MoE
layers (``ops/moe.py``: top-k routed experts in place of the dense MLP)
through one function.

Layout is the JAX package's: params are a plain dict with per-layer
weights stacked on a leading ``[num_layers, ...]`` axis (layer ``i`` is a
view ``t[i]``), projections stored (in, out) so every matmul is
``x @ W``, activations [B, S, H*D] / [B, S, K, D].  The layer loop is a
Python loop in place of ``lax.scan``, the ``lax.cond`` on a sliding
layer is a Python branch on ``config.layer_is_sliding(i)``, and the KV
cache is written in place.  Weights may be quantized payloads
(``quant.quantize_params``: int8 / int4, weight-only or W8A8): every
projection goes through ``quant_einsum``.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from llm_np_cp_tpu_torch.cache import (
    KVCache,
    cache_slots,
    dequantize_kv,
    update_layer,
    update_layer_quantized,
)
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.ops.activations import ACT2FN, softcap
from llm_np_cp_tpu_torch.ops.attention import causal_mask, gqa_attention
from llm_np_cp_tpu_torch.ops.cuda.decode_attention import decode_attention
from llm_np_cp_tpu_torch.ops.cuda.flash_attention import flash_attention
from llm_np_cp_tpu_torch.ops.cuda.sample_epilogue import sample_epilogue
from llm_np_cp_tpu_torch.ops.moe import moe_mlp
from llm_np_cp_tpu_torch.ops.norms import rms_norm
from llm_np_cp_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from llm_np_cp_tpu_torch.quant import is_quantized, quant_einsum

Params = dict[str, Any]

ATTN_IMPLS = ("xla", "flash", "flash_decode")


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------

def param_shapes(config: ModelConfig) -> dict[str, Any]:
    """Shape spec of the parameter dict (stacked layers) — the JAX
    package's layout."""
    L = config.num_hidden_layers
    H = config.hidden_size
    D = config.head_dim
    NH = config.num_attention_heads
    NK = config.num_key_value_heads
    I = config.intermediate_size
    V = config.vocab_size
    layers: dict[str, tuple[int, ...]] = {
        "ln_attn_in": (L, H),
        "q_proj": (L, H, NH * D),
        "k_proj": (L, H, NK * D),
        "v_proj": (L, H, NK * D),
        "o_proj": (L, NH * D, H),
        "ln_mlp_in": (L, H),
    }
    if config.attention_bias:
        layers.update(q_bias=(L, NH * D), k_bias=(L, NK * D), v_bias=(L, NK * D))
    if config.o_proj_bias:
        layers.update(o_bias=(L, H))
    if config.mlp_bias:
        if config.is_moe:
            raise NotImplementedError("mlp_bias is not supported for MoE configs")
        layers.update(gate_bias=(L, I), up_bias=(L, I), down_bias=(L, H))
    if config.is_moe:
        E = config.num_local_experts
        layers.update(router=(L, H, E), gate_proj=(L, E, H, I), up_proj=(L, E, H, I),
                      down_proj=(L, E, I, H))
    else:
        layers.update(gate_proj=(L, H, I), up_proj=(L, H, I), down_proj=(L, I, H))
    if config.sandwich_norms:
        layers["ln_attn_out"] = (L, H)
        layers["ln_mlp_out"] = (L, H)
    spec: dict[str, Any] = {
        "embed_tokens": (V, H),
        "layers": layers,
        "final_norm": (H,),
    }
    if not config.tie_word_embeddings:
        spec["lm_head"] = (H, V)
    return spec


def init_params(
    seed: int, config: ModelConfig, dtype: torch.dtype = torch.bfloat16,
    *, device: str | torch.device = "cuda",
) -> Params:
    """Random small-scale init (tests and synthetic runs), drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``: norm
    gammas are ones (zeros under unit offset), every other leaf is
    N(0, 0.02^2).  The draws differ from ``jax.random``'s; tests that
    compare with the JAX package build one set of weights with numpy and
    convert it (``convert.params_from_jax``).  An expert stack
    ``[L, E, in, out]`` is drawn one layer at a time (at Mixtral-8x7B
    widths one float32 draw of it is a 15 GB temporary); every other
    leaf is one draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        if name.startswith("ln_") or name == "final_norm":
            fill = 0.0 if config.rms_norm_unit_offset else 1.0
            return torch.full(shape, fill, dtype=dtype, device=dev)
        if len(shape) == 4:  # [L, E, in, out]: one layer's float32 at a time
            out = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                out[i] = make(name, shape[1:])
            return out
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * 0.02).to(dtype)

    spec = param_shapes(config)
    params: Params = {}
    for name, shape in spec.items():
        if name == "layers":
            params["layers"] = {n: make(n, s) for n, s in shape.items()}
        else:
            params[name] = make(name, shape)
    return params


# ----------------------------------------------------------------------
# Forward pieces
# ----------------------------------------------------------------------

def compute_dtype(params: Params) -> torch.dtype:
    """Activation dtype: the norm gammas' dtype."""
    return params["final_norm"].dtype


def _project(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ W`` with float32 accumulation, rounded to x's dtype (cuBLAS
    accumulates bf16 products in float32, the JAX einsums'
    ``preferred_element_type``); a quantized ``W`` goes through
    ``quant_einsum``, whose float32 result is rescaled before the
    rounding."""
    if is_quantized(w):
        return quant_einsum("bsh,ho->bso", x, w).to(x.dtype)
    return (x @ w).to(x.dtype)


def layer_weights(layers: Params, i: int) -> Params:
    """Layer ``i``'s weights: views ``t[i]`` of the stacked leaves (a
    quantized leaf's payload and scale alike: ``[L, 1, out]`` scales
    become ``[1, out]``)."""
    return {
        name: {k: v[i] for k, v in t.items()} if isinstance(t, dict) else t[i]
        for name, t in layers.items()
    }


def embed_inputs(params: Params, input_ids: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(hidden) scaling in the
    weight dtype)."""
    dtype = compute_dtype(params)
    emb = params["embed_tokens"]
    if is_quantized(emb):  # int8 rows with per-row scales
        x = (emb["q"][input_ids].float() * emb["s"][input_ids]).to(dtype)
    else:
        x = emb[input_ids].to(dtype)
    if config.scale_embeddings:
        # sqrt(hidden) rounded to the weight dtype on the host: a scalar
        # operand, so the step copies nothing to the card
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=dtype).item()
    return x


def final_logits(
    params: Params, x: torch.Tensor, config: ModelConfig, *, last_only: bool = False
) -> torch.Tensor:
    """Final RMSNorm → (tied) lm_head → optional softcap → float32 logits."""
    x = rms_norm(
        x, params["final_norm"], eps=config.rms_norm_eps,
        unit_offset=config.rms_norm_unit_offset,
    )
    if last_only:
        x = x[:, -1:, :]
    if config.tie_word_embeddings:
        logits = quant_einsum("bsh,vh->bsv", x, params["embed_tokens"])
    else:
        logits = quant_einsum("bsh,hv->bsv", x, params["lm_head"])
    if config.final_logit_softcapping is not None:
        logits = softcap(logits, config.final_logit_softcapping)
    return logits


def head_quant_mode(params: Params, config: ModelConfig) -> str | None:
    """How the lm-head weight is stored: ``"float"`` (plain tensor),
    ``"int8"`` (a quant.py ``"q"`` payload, which the epilogue's int8
    variant streams) or None for payloads the epilogue does not take
    (``q4``/``qa`` heads keep the logits tail)."""
    w = params.get("embed_tokens") if config.tie_word_embeddings else params.get("lm_head")
    if w is None:
        return None
    if isinstance(w, dict):
        return "int8" if "q" in w and "s" in w else None
    return "float"


def epilogue_params(
    params: Params, config: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``(final-norm gamma, lm-head weight payload, [1, V] float32 scales
    or None)`` — the leaves the fused sampling epilogue streams: the
    embedding table ``[V, H]`` for tied heads (its per-row scales laid
    out per column), ``lm_head [H, V]`` otherwise.  Callers gate on
    ``head_quant_mode`` first."""
    w = params["embed_tokens"] if config.tie_word_embeddings else params["lm_head"]
    if isinstance(w, dict):
        return params["final_norm"], w["q"], w["s"].reshape(1, -1)
    return params["final_norm"], w, None


def sample_epilogue_tail(params: Params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Greedy-sample rows of PRE-final-norm hidden states ``x [N, H]``
    through the fused sampling epilogue → ``[N]`` int32 token ids."""
    gamma, w, w_scale = epilogue_params(params, config)
    return sample_epilogue(
        x.contiguous(), gamma, w, w_scale=w_scale,
        tied=config.tie_word_embeddings,
        eps=config.rms_norm_eps,
        unit_offset=config.rms_norm_unit_offset,
        logit_softcap=config.final_logit_softcapping,
    )


def epilogue_gate_error(params: Params, config: ModelConfig, sampler_kind: str) -> str | None:
    """None when the fused epilogue reproduces this (params, sampler)
    draw, else the reason it cannot.  No probe: on the card the kernel
    either launches or raises."""
    if sampler_kind != "greedy":
        return (f"sampler kind {sampler_kind!r} (only the greedy draw "
                "is reproduced by the streamed argmax)")
    if head_quant_mode(params, config) is None:
        return "unsupported lm-head payload (q4/qa heads keep the logits tail)"
    return None


def run_decoder_layer(
    w: Params,
    x: torch.Tensor,
    *,
    config: ModelConfig,
    act: Callable[[torch.Tensor], torch.Tensor],
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor | None = None,
    sliding: bool = False,
    attn_impl: str = "xla",
    kv_update: Callable | None = None,
    output_attentions: bool = False,
    attn_fn: Callable | None = None,
) -> tuple[torch.Tensor, tuple[Any, Any], torch.Tensor | None, torch.Tensor | None]:
    """One decoder block (pre-norm or Gemma sandwich-norm residual).

    w: one layer's weights (views into the stacked leaves).
    mask: [B, Sq, Skv] bool for this layer (the local mask on a sliding
        layer); unused by the flash path and by ``attn_fn``.
    kv_update: optional ``(k, v) -> (k_att, v_att)`` hook — the in-place
        cache write; None attends over the fresh K/V (cache-less mode).
    attn_fn: optional ``(q, k_att, v_att, sliding) -> attn`` override —
        the serving engine's block-table kernels plug in here (their
        visibility comes from per-row scalars, not a mask tensor).
    Returns ``(x_out, (k_att, v_att), attn_weights | None, moe_aux_loss)``:
    the MoE layer's float32 load-balancing loss, None on a dense layer
    (where the JAX package returns a zero: here a dense step launches
    nothing for it).
    """
    b, s = x.shape[:2]
    eps, unit = config.rms_norm_eps, config.rms_norm_unit_offset
    h = rms_norm(x, w["ln_attn_in"], eps=eps, unit_offset=unit)

    def proj_b(inp: torch.Tensor, name: str) -> torch.Tensor:
        y = _project(inp, w[name])
        bias = w.get(name.replace("_proj", "_bias"))
        return y + bias.to(y.dtype) if bias is not None else y

    q = proj_b(h, "q_proj").reshape(b, s, config.num_attention_heads, config.head_dim)
    k = proj_b(h, "k_proj").reshape(b, s, config.num_key_value_heads, config.head_dim)
    v = proj_b(h, "v_proj").reshape(b, s, config.num_key_value_heads, config.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    k_att, v_att = kv_update(k, v) if kv_update is not None else (k, v)

    attn_weights = None
    if attn_fn is not None:
        attn = attn_fn(q, k_att, v_att, sliding)
    elif attn_impl == "flash":
        # self-attention over the fresh K/V, positions 0..S-1
        attn = flash_attention(
            q, k, v, scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping,
            window=config.sliding_window if sliding else None,
        )
    elif attn_impl == "flash_decode" and s == 1:
        # an int8 cache arrives as (values, scales) pairs; the kernel
        # dequantizes in shared memory
        if isinstance(k_att, tuple):
            (k_vals, k_sc), (v_vals, v_sc) = k_att, v_att
        else:
            k_vals, k_sc, v_vals, v_sc = k_att, None, v_att, None
        attn = decode_attention(
            q, k_vals, v_vals, mask[:, 0].contiguous(),
            k_scale=k_sc, v_scale=v_sc,
            scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping,
        )
    else:
        attn = gqa_attention(
            q, k_att, v_att, mask,
            scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping,
            return_weights=output_attentions,
        )
        if output_attentions:
            attn, attn_weights = attn
    attn = _project(attn.reshape(b, s, -1), w["o_proj"])
    if "o_bias" in w:
        attn = attn + w["o_bias"].to(attn.dtype)
    if config.sandwich_norms:
        attn = rms_norm(attn, w["ln_attn_out"], eps=eps, unit_offset=unit)
    x = x + attn

    h = rms_norm(x, w["ln_mlp_in"], eps=eps, unit_offset=unit)
    if config.is_moe:
        mlp, moe_aux = moe_mlp(
            h, w["router"], w["gate_proj"], w["up_proj"], w["down_proj"],
            act=act, top_k=config.num_experts_per_tok,
            capacity_factor=config.moe_capacity_factor,
            group_size=config.moe_group_size,
        )
    else:
        moe_aux = None
        gate = act(proj_b(h, "gate_proj"))
        up = proj_b(h, "up_proj")
        mlp = proj_b(gate * up, "down_proj")
    if config.sandwich_norms:
        mlp = rms_norm(mlp, w["ln_mlp_out"], eps=eps, unit_offset=unit)
    x = x + mlp
    return x, (k_att, v_att), attn_weights, moe_aux


def _check_contracts(
    params: Params, config: ModelConfig, cache: KVCache | None, dev: torch.device,
    attn_impl: str, attn_mask: Any, pad_offsets: Any, output_attentions: bool,
) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if output_attentions and attn_impl != "xla":
        raise ValueError("output_attentions requires attn_impl='xla'")
    if params["final_norm"].device != dev:
        raise ValueError(
            f"params live on {params['final_norm'].device}, forward asked "
            f"for device={str(dev)!r}"
        )
    if attn_impl == "flash":
        if attn_mask is not None or pad_offsets is not None:
            # the kernel builds its causal mask from slot index alone: it
            # cannot see per-row validity/position shifts
            raise ValueError(
                "attn_impl='flash' does not support attn_mask/pad_offsets "
                "(ragged batches); use attn_impl='xla'"
            )
        if cache is not None and cache.length != 0:
            raise ValueError(
                f"attn_impl='flash' requires a fresh cache (length 0, got "
                f"{cache.length}): cached history is not visible to the kernel"
            )
    if cache is not None and not isinstance(cache.length, int):
        raise TypeError(
            "the cache's host length is an int; per-row [B] lengths live in its device offset"
        )


def forward(
    params: Params,
    input_ids: torch.Tensor,
    config: ModelConfig,
    cache: KVCache | None = None,
    *,
    positions: torch.Tensor | None = None,
    attn_mask: torch.Tensor | None = None,
    pad_offsets: torch.Tensor | None = None,
    logits_last_only: bool = False,
    output_hidden_states: bool = False,
    output_attentions: bool = False,
    output_router_losses: bool = False,
    attn_impl: str = "xla",
    skip_logits: bool = False,
    device: str | torch.device = "cuda",
) -> tuple:
    """Run the decoder (same contract as the JAX ``forward``).

    input_ids: [B, S] integer ids.
    cache: ``KVCache`` written IN PLACE (slabs and validity bitmap at
        the slots its device ``offset`` names; ``offset`` and the host
        ``length`` advance by S), or None for cache-less full recompute.
        A ``[B]`` offset writes, positions and masks each row at its own
        length (batched speculative decoding).  The step reads nothing
        back from the card: the capacity check uses the host ``length``
        (with a ``[B]`` offset, the host's bound over the rows still
        writing).
    positions: [B, S] absolute positions; default ``cache.offset + arange(S)``
        (per row for a ``[B]`` offset).
    attn_mask: optional [B, S] bool marking valid (non-pad) input tokens.
    pad_offsets: optional [B] per-row LEFT-padding amounts (ragged batch).
    logits_last_only: lm_head for the final position only.
    skip_logits: return the PRE-final-norm hidden states in the logits
        slot (the fused sampling epilogue consumes them).
    attn_impl: "xla" (the plain path), "flash" (the prefill kernel; fresh
        cache, no ragged input) or "flash_decode" (the decode kernel when
        S == 1, the plain path otherwise).
    output_router_losses: on an MoE config, put the layers' mean
        load-balancing loss in the aux dict as "moe_aux_loss".
    device: where ``params`` live; "cuda" (default) raises without a card.

    Returns (logits [B, S|1, V] float32, cache), plus an aux dict with
    "hidden_states" / "attentions" / "final_hidden_state" /
    "moe_aux_loss" when an output flag asks for one of them.
    """
    dev = resolve_device(device)
    _check_contracts(params, config, cache, dev, attn_impl, attn_mask,
                     pad_offsets, output_attentions)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = input_ids.shape
    if attn_mask is not None:
        attn_mask = torch.as_tensor(attn_mask, device=dev).bool()
    if pad_offsets is not None:
        pad_offsets = torch.as_tensor(pad_offsets, device=dev).long()

    if cache is not None and cache.length + s > cache.max_seq_len:
        raise ValueError(
            f"writing {s} tokens at offset {cache.length} exceeds KV-cache "
            f"capacity {cache.max_seq_len}"
        )
    # [B, S] cache slots of this call's tokens, from the device offset
    slots = (cache_slots(cache.offset, b, s, cache.max_seq_len, dev) if cache is not None
             else torch.arange(s, device=dev).expand(b, s))
    if positions is None:
        positions = slots
        if pad_offsets is not None:
            positions = torch.clamp_min(positions - pad_offsets[:, None], 0)
    else:
        positions = torch.as_tensor(positions, device=dev).long()

    x = embed_inputs(params, input_ids, config)
    cos, sin = rope_cos_sin(positions, config, dtype=torch.float32)

    if cache is not None:
        kv_positions = torch.arange(cache.max_seq_len, device=dev)
        if pad_offsets is not None:
            kv_positions = kv_positions[None, :] - pad_offsets[:, None]
        # the persisted bitmap keeps pad slots of earlier calls masked
        cache.valid.scatter_(1, slots, attn_mask if attn_mask is not None else True)
        kv_valid = cache.valid
    else:
        kv_positions = positions
        kv_valid = attn_mask.expand(b, s) if attn_mask is not None else None
    mask_global = causal_mask(positions, kv_positions, kv_valid=kv_valid)
    mask_local = (
        causal_mask(positions, kv_positions, window=config.sliding_window, kv_valid=kv_valid)
        if config.sliding_window is not None else mask_global
    )

    act = ACT2FN[config.hidden_act]
    lp = params["layers"]
    hidden_states, attentions, moe_aux = [], [], []
    for i in range(config.num_hidden_layers):
        w = layer_weights(lp, i)
        sliding = config.layer_is_sliding(i)
        kv_update = None
        if cache is not None and cache.quantized:

            def kv_update(k, v, i=i):
                kl, vl, ksl, vsl = update_layer_quantized(
                    cache.k[i], cache.v[i], cache.k_scale[i], cache.v_scale[i],
                    k, v, slots,
                )
                if attn_impl == "flash_decode" and k.shape[1] == 1:
                    return (kl, ksl), (vl, vsl)
                return dequantize_kv(kl, ksl, k.dtype), dequantize_kv(vl, vsl, v.dtype)

        elif cache is not None:

            def kv_update(k, v, i=i):
                return update_layer(cache.k[i], cache.v[i], k, v, slots)

        if output_hidden_states:
            hidden_states.append(x)
        x, _, attn_w, layer_aux = run_decoder_layer(
            w, x, config=config, act=act, cos=cos, sin=sin,
            mask=mask_local if sliding else mask_global, sliding=sliding,
            attn_impl=attn_impl, kv_update=kv_update,
            output_attentions=output_attentions,
        )
        if output_attentions:
            attentions.append(attn_w)
        moe_aux.append(layer_aux)

    if skip_logits:
        logits = x[:, -1:, :] if logits_last_only else x
    else:
        logits = final_logits(params, x, config, last_only=logits_last_only)
    if cache is not None:
        cache.offset.add_(s)
        cache.length += s

    aux: dict[str, torch.Tensor] = {}
    if config.is_moe and output_router_losses:
        aux["moe_aux_loss"] = torch.stack(moe_aux).mean()  # mean over layers
    if output_hidden_states:
        aux["hidden_states"] = torch.stack(hidden_states)  # [L, B, S, H]
        aux["final_hidden_state"] = rms_norm(
            x, params["final_norm"], eps=config.rms_norm_eps,
            unit_offset=config.rms_norm_unit_offset,
        )
    if output_attentions:
        aux["attentions"] = torch.stack(attentions)  # [L, B, H, Sq, Skv]
    if aux:
        return logits, cache, aux
    return logits, cache

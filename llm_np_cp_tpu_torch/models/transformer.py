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

Under a mesh (``forward(mesh=)``, ``parallel/sharding.py``) the params
are this rank's local shards and the forward issues the collectives that
GSPMD inserts in the JAX package: tensor parallelism over "model" (local
heads and MLP columns, an all-reduce after the row-parallel ``o_proj``
and ``down_proj`` with their biases added after it, a vocab-parallel
embedding and a column-parallel head whose logits are all-gathered),
data parallelism over "data" (the caller passes this rank's batch rows)
and, under ``attn_impl="ring"``, sequence parallelism over "seq".
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
from llm_np_cp_tpu_torch.parallel.collectives import all_gather, all_reduce, copy_to
from llm_np_cp_tpu_torch.parallel.ring_attention import check_ring_mesh, ring_attention_ctx
from llm_np_cp_tpu_torch.parallel.sharding import (
    MODEL_AXIS,
    MOE_TP_ITEM,
    SEQ_AXIS,
    Mesh,
    kv_heads_shardable,
)
from llm_np_cp_tpu_torch.quant import is_quantized, quant_einsum

Params = dict[str, Any]

ATTN_IMPLS = ("xla", "flash", "flash_decode", "ring")


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


def _tp(mesh: Mesh | None) -> int:
    """The mesh's "model" size (1 without a mesh)."""
    return mesh.size(MODEL_AXIS) if mesh is not None else 1


def _to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x``, replicated over "model", entering column-parallel work:
    its gradient is summed over "model" (``collectives.copy_to``; the
    identity, and no collective, off the gradient path)."""
    return copy_to(x, mesh, MODEL_AXIS) if _tp(mesh) > 1 else x


def _row_project(x: torch.Tensor, w: Any, mesh: Mesh | None) -> torch.Tensor:
    """``x @ W`` for a row-parallel projection (``o_proj``, ``down_proj``).
    Under tensor parallelism: this rank's float32 partial sum (its rows
    of W against its columns of x), all-reduced over "model" in float32,
    rounded to x's dtype once; the W8A8 modes quantize each row of x with
    the absmax over every rank's columns (an all-reduce of the row
    maxima), as one device would."""
    if _tp(mesh) == 1:
        return _project(x, w)

    def row_amax(amax: torch.Tensor) -> torch.Tensor:
        return all_reduce(amax, mesh, MODEL_AXIS, op="max")

    y = quant_einsum("bsh,ho->bso", x, w, row_amax=row_amax)
    return all_reduce(y, mesh, MODEL_AXIS).to(x.dtype)


def kv_head_select(config: ModelConfig, mesh: Mesh | None) -> slice | torch.Tensor | None:
    """Under tensor parallelism with replicated KV heads (their count not
    divisible by "model"), the KV heads this rank's query heads group
    onto: a slice when the local query heads split evenly over them, else
    one KV head index per local query head.  None when every rank attends
    its own KV heads (no mesh, model 1, or KV heads sharded)."""
    tp = _tp(mesh)
    if tp == 1 or kv_heads_shardable(config, mesh.plan):
        return None
    nh = config.num_attention_heads // tp
    g = config.num_query_groups
    heads = [(mesh.index(MODEL_AXIS) * nh + j) // g for j in range(nh)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if nh % n == 0 and all(heads.count(lo + i) == nh // n for i in range(n)):
        return slice(lo, lo + n)
    return torch.tensor(heads, device=mesh.device)


def _take_kv(t: Any, sel: slice | torch.Tensor | None, contiguous: bool = False) -> Any:
    """``t``'s KV heads ``sel`` (dim 2 of ``[B, S, K, D]`` values and of
    ``[B, S, K]`` int8 scales; a ``(values, scales)`` pair alike)."""
    if sel is None:
        return t
    if isinstance(t, tuple):
        return tuple(_take_kv(u, sel, contiguous) for u in t)
    out = t[:, :, sel] if isinstance(sel, slice) else t.index_select(2, sel)
    return out.contiguous() if contiguous else out


def layer_weights(layers: Params, i: int) -> Params:
    """Layer ``i``'s weights: views ``t[i]`` of the stacked leaves (a
    quantized leaf's payload and scale alike: ``[L, 1, out]`` scales
    become ``[1, out]``)."""
    return {
        name: {k: v[i] for k, v in t.items()} if isinstance(t, dict) else t[i]
        for name, t in layers.items()
    }


def embed_inputs(params: Params, input_ids: torch.Tensor, config: ModelConfig,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(hidden) scaling in the
    weight dtype).  Under tensor parallelism the table is this rank's
    vocab rows: ids outside them look up zeros, and an all-reduce over
    "model" sums the one row that hit."""
    dtype = compute_dtype(params)
    emb = params["embed_tokens"]
    tp = _tp(mesh)
    if tp > 1:
        v_loc = (emb["q"] if is_quantized(emb) else emb).shape[0]
        local = input_ids - mesh.index(MODEL_AXIS) * v_loc
        hit = (local >= 0) & (local < v_loc)
        input_ids = torch.where(hit, local, 0)
    if is_quantized(emb):  # int8 rows with per-row scales
        x = (emb["q"][input_ids].float() * emb["s"][input_ids]).to(dtype)
    else:
        x = emb[input_ids].to(dtype)
    if tp > 1:
        x = all_reduce(torch.where(hit[..., None], x, 0), mesh, MODEL_AXIS)
    if config.scale_embeddings:
        # sqrt(hidden) rounded to the weight dtype on the host: a scalar
        # operand, so the step copies nothing to the card
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=dtype).item()
    return x


def final_logits(
    params: Params, x: torch.Tensor, config: ModelConfig, *, last_only: bool = False,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Final RMSNorm → (tied) lm_head → optional softcap → float32 logits.
    Under tensor parallelism the head is this rank's vocab columns and
    the logits are all-gathered over "model"."""
    x = rms_norm(
        x, params["final_norm"], eps=config.rms_norm_eps,
        unit_offset=config.rms_norm_unit_offset,
    )
    if last_only:
        x = x[:, -1:, :]
    x = _to_model(x, mesh)
    if config.tie_word_embeddings:
        logits = quant_einsum("bsh,vh->bsv", x, params["embed_tokens"])
    else:
        logits = quant_einsum("bsh,hv->bsv", x, params["lm_head"])
    if config.final_logit_softcapping is not None:
        logits = softcap(logits, config.final_logit_softcapping)
    return all_gather(logits, mesh, MODEL_AXIS, dim=-1) if _tp(mesh) > 1 else logits


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


def sample_epilogue_tail(params: Params, x: torch.Tensor, config: ModelConfig,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """Greedy-sample rows of PRE-final-norm hidden states ``x [N, H]``
    through the fused sampling epilogue → ``[N]`` int32 token ids.

    Under tensor parallelism each rank runs the epilogue on its vocab
    shard (the tied embedding's rows or the head's columns), which also
    returns the shard's row maximum; the (maximum, global index) pairs
    are all-gathered over "model" and the largest wins, the lowest global
    index on a tie, as ``argmax`` over the gathered row picks."""
    gamma, w, w_scale = epilogue_params(params, config)
    tp = _tp(mesh)
    out = sample_epilogue(
        x.contiguous(), gamma, w, w_scale=w_scale,
        tied=config.tie_word_embeddings,
        eps=config.rms_norm_eps,
        unit_offset=config.rms_norm_unit_offset,
        logit_softcap=config.final_logit_softcapping,
        return_max=tp > 1,
    )
    if tp == 1:
        return out
    tok, best = out
    v_loc = w.shape[0] if config.tie_word_embeddings else w.shape[1]
    # float64 holds both the float32 maxima and the indices exactly
    pair = torch.stack([best.double(), tok.double() + mesh.index(MODEL_AXIS) * v_loc])
    pairs = all_gather(pair[None], mesh, MODEL_AXIS, dim=0)  # [tp, 2, N]
    win = pairs[:, 0].argmax(dim=0)  # the first shard on a tie: the lowest index
    return pairs[:, 1].gather(0, win[None])[0].to(torch.int32)


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
    mesh: Mesh | None = None,
    kv_sel: slice | torch.Tensor | None = None,
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
    mesh: under tensor parallelism ``w`` holds this rank's heads and MLP
        columns (the head counts follow the projections' widths), and the
        row-parallel ``o_proj`` / ``down_proj`` sums are all-reduced over
        "model"; ``attn_impl="ring"`` attends over the "seq" axis.
    kv_sel: the KV heads this rank attends with when they are replicated
        (``kv_head_select``); None otherwise.
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

    # head counts from the projections' widths: this rank's under a mesh.
    # Replicated KV heads (``kv_sel``): every rank projects them all and
    # attends with its own, so their gradient is summed over "model"
    # after the projection instead of before it
    hq = _to_model(h, mesh)
    q = proj_b(hq, "q_proj").reshape(b, s, -1, config.head_dim)
    hk = h if kv_sel is not None else hq
    k = proj_b(hk, "k_proj").reshape(b, s, -1, config.head_dim)
    v = proj_b(hk, "v_proj").reshape(b, s, -1, config.head_dim)
    if kv_sel is not None:
        k, v = _to_model(k, mesh), _to_model(v, mesh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    k_att, v_att = kv_update(k, v) if kv_update is not None else (k, v)
    window = config.sliding_window if sliding else None

    attn_weights = None
    if attn_fn is not None:
        attn = attn_fn(q, k_att, v_att, sliding)
    elif attn_impl == "flash":
        # self-attention over the fresh K/V, positions 0..S-1
        attn = flash_attention(
            q, _take_kv(k, kv_sel, True), _take_kv(v, kv_sel, True), scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping, window=window,
        )
    elif attn_impl == "ring":
        # this rank's block of the prompt against every seq rank's K/V
        attn = ring_attention_ctx(
            q, _take_kv(k, kv_sel), _take_kv(v, kv_sel), mesh=mesh,
            scale=config.attn_scale, logit_softcap=config.attn_logit_softcapping,
            window=window,
        )
    elif attn_impl == "flash_decode" and s == 1:
        # an int8 cache arrives as (values, scales) pairs; the kernel
        # dequantizes in shared memory
        kk, vv = _take_kv(k_att, kv_sel, True), _take_kv(v_att, kv_sel, True)
        if isinstance(kk, tuple):
            (k_vals, k_sc), (v_vals, v_sc) = kk, vv
        else:
            k_vals, k_sc, v_vals, v_sc = kk, None, vv, None
        attn = decode_attention(
            q, k_vals, v_vals, mask[:, 0].contiguous(),
            k_scale=k_sc, v_scale=v_sc,
            scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping,
        )
    else:
        attn = gqa_attention(
            q, _take_kv(k_att, kv_sel), _take_kv(v_att, kv_sel), mask,
            scale=config.attn_scale,
            logit_softcap=config.attn_logit_softcapping,
            return_weights=output_attentions,
        )
        if output_attentions:
            attn, attn_weights = attn
    attn = _row_project(attn.reshape(b, s, -1), w["o_proj"], mesh)
    if "o_bias" in w:  # after the reduce
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
        h = _to_model(h, mesh)
        gate = act(proj_b(h, "gate_proj"))
        up = proj_b(h, "up_proj")
        mlp = _row_project(gate * up, w["down_proj"], mesh)
        if "down_bias" in w:  # after the reduce
            mlp = mlp + w["down_bias"].to(mlp.dtype)
    if config.sandwich_norms:
        mlp = rms_norm(mlp, w["ln_mlp_out"], eps=eps, unit_offset=unit)
    x = x + mlp
    return x, (k_att, v_att), attn_weights, moe_aux


def _check_contracts(
    params: Params, config: ModelConfig, cache: KVCache | None, dev: torch.device,
    attn_impl: str, attn_mask: Any, pad_offsets: Any, output_attentions: bool,
    mesh: Mesh | None = None,
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
    if attn_impl in ("flash", "ring"):
        if attn_mask is not None or pad_offsets is not None:
            # these paths build their causal mask from slot index alone:
            # they cannot see per-row validity/position shifts
            raise ValueError(
                f"attn_impl={attn_impl!r} does not support attn_mask/pad_offsets "
                "(ragged batches); use attn_impl='xla'"
            )
        if cache is not None and cache.length != 0:
            raise ValueError(
                f"attn_impl={attn_impl!r} requires a fresh cache (length 0, got "
                f"{cache.length}): cached history is not visible to the kernel"
            )
    if attn_impl == "ring":
        check_ring_mesh(mesh)
    if mesh is not None and config.is_moe and _tp(mesh) > 1:
        raise NotImplementedError(MOE_TP_ITEM)
    if cache is not None and not isinstance(cache.length, int):
        raise TypeError(
            "the cache's host length is an int; per-row [B] lengths live in its device offset"
        )


def _seq_block(t: torch.Tensor, mesh: Mesh, step: int = 0) -> torch.Tensor:
    """This seq rank's block of ``t [B, S]`` padded up to a multiple of
    the "seq" size (pads continue ``t`` by ``step`` a slot: 0 for ids,
    1 for positions)."""
    n = mesh.size(SEQ_AXIS)
    s = t.shape[1]
    pad = -s % n
    if pad:
        tail = t[:, -1:] + step * torch.arange(1, pad + 1, device=t.device)
        t = torch.cat([t, tail if step else torch.zeros_like(tail)], dim=1)
    s_loc = t.shape[1] // n
    lo = mesh.index(SEQ_AXIS) * s_loc
    return t[:, lo:lo + s_loc]


def _seq_output(x: torch.Tensor, mesh: Mesh, s: int, last_only: bool) -> torch.Tensor:
    """The ring forward's hidden states back on every seq rank: the last
    real position's row (its owner's row, summed with the other ranks'
    zeros over "seq"), or every real position (all-gathered)."""
    s_loc = x.shape[1]
    if not last_only:
        return all_gather(x, mesh, SEQ_AXIS, dim=1)[:, :s]
    owner, j = divmod(s - 1, s_loc)
    row = x[:, j:j + 1]
    if mesh.index(SEQ_AXIS) != owner:
        row = torch.zeros_like(row)
    return all_reduce(row.contiguous(), mesh, SEQ_AXIS)


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
    mesh: Mesh | None = None,
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
        cache, no ragged input), "flash_decode" (the decode kernel when
        S == 1, the plain path otherwise) or "ring" (sequence-parallel
        ring attention over ``mesh``'s "seq" axis, size >= 2; fresh cache,
        no ragged input).  Under "ring" each seq rank runs its block of
        the prompt (padded up to a multiple of the axis) through every
        layer; the cache write all-gathers K/V along "seq", so every seq
        rank holds the whole cache and decode is the plain step; logits
        come back for every position, or for the last real token.
    output_router_losses: on an MoE config, put the layers' mean
        load-balancing loss in the aux dict as "moe_aux_loss".
    device: where ``params`` live; "cuda" (default) raises without a card.
    mesh: a ``parallel.sharding.Mesh``: ``params`` are this rank's
        shards (``shard_params``) on ``mesh.device`` (``device`` is not
        read), ``input_ids`` this rank's batch rows, and the forward runs
        tensor parallel over "model" and, under "ring", sequence parallel
        over "seq" (the JAX package reads the ambient mesh instead).

    Returns (logits [B, S|1, V] float32, cache), plus an aux dict with
    "hidden_states" / "attentions" / "final_hidden_state" /
    "moe_aux_loss" when an output flag asks for one of them.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    _check_contracts(params, config, cache, dev, attn_impl, attn_mask,
                     pad_offsets, output_attentions, mesh)
    ring = attn_impl == "ring"
    if ring and output_hidden_states:
        raise ValueError("output_hidden_states is not gathered under attn_impl='ring'")
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
    if ring:  # this seq rank's block of the (padded) prompt
        input_ids, positions = _seq_block(input_ids, mesh), _seq_block(positions, mesh, 1)

    x = embed_inputs(params, input_ids, config, mesh)
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
    mask_global = mask_local = None
    if not ring:  # the ring masks each block from its global positions
        mask_global = causal_mask(positions, kv_positions, kv_valid=kv_valid)
        mask_local = (
            causal_mask(positions, kv_positions, window=config.sliding_window,
                        kv_valid=kv_valid)
            if config.sliding_window is not None else mask_global
        )
    kv_sel = kv_head_select(config, mesh)

    def whole_seq(k, v):
        """Under "ring": every seq rank's K/V block, the real positions."""
        if not ring:
            return k, v
        kv = all_gather(torch.stack([k, v]), mesh, SEQ_AXIS, dim=2)[:, :, :s]
        return kv[0], kv[1]

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
                    *whole_seq(k, v), slots,
                )
                if attn_impl == "flash_decode" and k.shape[1] == 1:
                    return (kl, ksl), (vl, vsl)
                return dequantize_kv(kl, ksl, k.dtype), dequantize_kv(vl, vsl, v.dtype)

        elif cache is not None:

            def kv_update(k, v, i=i):
                return update_layer(cache.k[i], cache.v[i], *whole_seq(k, v), slots)

        if output_hidden_states:
            hidden_states.append(x)
        x, _, attn_w, layer_aux = run_decoder_layer(
            w, x, config=config, act=act, cos=cos, sin=sin,
            mask=mask_local if sliding else mask_global, sliding=sliding,
            attn_impl=attn_impl, kv_update=kv_update,
            output_attentions=output_attentions, mesh=mesh, kv_sel=kv_sel,
        )
        if output_attentions:
            attentions.append(attn_w)
        moe_aux.append(layer_aux)

    if ring:
        x = _seq_output(x, mesh, s, logits_last_only)
    if skip_logits:
        logits = x[:, -1:, :] if logits_last_only else x
    else:
        logits = final_logits(params, x, config, last_only=logits_last_only, mesh=mesh)
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

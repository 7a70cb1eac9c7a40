"""Weight quantization (port of ``llm_np_cp_tpu/quant.py``).

A quantized matrix is a dict in the original tensor's place in the param
dict, as in the JAX package: ``{"q": int8, "s": f32}`` (8-bit),
``{"q4": uint8 two nibbles per byte packed along the contraction axis,
"s": f32}`` (4-bit), and ``{"qa"|"q4a": ..., "s"}`` for the same payloads
consumed with dynamic per-row int8 activation quantization (W8A8 /
W4A8).  ``s`` keeps size 1 on the contraction axis:

- projections ``[L, in, out]`` → ``[L, 1, out]`` (layer ``i``: ``[1, out]``)
- embedding ``[V, H]`` → per-row ``[V, 1]`` (the tied head's output channel)
- untied ``lm_head [H, V]`` → ``[1, V]``

Symmetric, rounded half to even (``torch.round``, as ``jnp.round``):
``q = round(w / s)`` with ``s = max|w| / 127`` (``/ 7`` for int4) per
output channel.  Norm gammas and anything 1-D stay float.

The MoE experts' two specs (``gech,ehi->geci``, ``geci,eih->gech``)
contract every expert's slots against its own weights: one batched
product over the expert axis, or, in the W8A8 modes, one int8 product
per expert.

The products are library calls, as the JAX package leaves them to XLA:
``q``/``q4`` take ``x @ payload.to(x.dtype)`` with a float32 result and
then the scale; ``qa``/``q4a`` quantize each row of ``x`` to int8 and
take an int8 × int8 → int32 product (``torch._int_mm``), then the two
scales.  On the card the int32 product is cuBLAS's or an error: it never
becomes a float product.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Params = dict[str, Any]

# weights quantized along their contraction-input axis (per-output scales)
_QUANT_KEYS = {
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
}

_PAYLOAD_KEYS = ("q", "qa", "q4", "q4a")

# the einsum specs of the model: x [b, s, h] against a weight stored
# (in, out) (projections, untied head) or (out, in) (the tied head)
_SPECS = {"bsh,ho->bso": False, "bsh,hv->bsv": False, "bsh,vh->bsv": True}
# the MoE experts' specs: dispatched slots x [g, e, c, in] against the
# expert stack [e, in, out] (ops/moe.py)
_EXPERT_SPECS = ("gech,ehi->geci", "geci,eih->gech")

# torch._int_mm on CUDA takes more than 16 rows
_INT_MM_MIN_ROWS = 17


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and any(k in w for k in _PAYLOAD_KEYS) and "s" in w


def payload_key(w: dict) -> str:
    for k in _PAYLOAD_KEYS:
        if k in w:
            return k
    raise KeyError(f"not a quantized leaf: {list(w)}")


def payload(w: dict) -> torch.Tensor:
    """The quantized leaf's full-width integer payload (int4 unpacked)."""
    key = payload_key(w)
    if key in ("q4", "q4a"):
        return _unpack4(w[key])
    return w[key]


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``where(amax > 0, amax / qmax, 1)`` with a true float32 division
    (on CUDA, PyTorch divides by a Python scalar as a product with its
    reciprocal, which can round one ulp apart from the JAX package)."""
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))


def quantize_array(w: torch.Tensor, *, axis: int) -> dict[str, torch.Tensor]:
    """Symmetric int8 quantization of ``w`` along ``axis`` (the
    contraction axis): scales keep size 1 there."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    s = _scale(amax, 127.0)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_array4(w: torch.Tensor, *, axis: int = -2) -> dict[str, torch.Tensor]:
    """Symmetric int4: q in [-7, 7], stored offset-binary (q + 8) two
    values per uint8, packed along the contraction axis (``-2``, even)."""
    if axis != -2:
        raise NotImplementedError("int4 packing is along axis -2 only")
    if w.shape[-2] % 2:
        raise ValueError(f"contraction dim {w.shape[-2]} must be even for int4")
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    s = _scale(amax, 7.0)
    q = (torch.clamp(torch.round(w32 / s), -7, 7) + 8).to(torch.uint8)
    qr = q.reshape(*q.shape[:-2], q.shape[-2] // 2, 2, q.shape[-1])
    packed = qr[..., 0, :] | (qr[..., 1, :] << 4)
    return {"q4": packed, "s": s}


def _unpack4_pairs(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] → int8 [..., in/2, 2, out] (n=0 low nibble)."""
    q = torch.stack([p & 0xF, p >> 4], dim=-2)  # no host-made constant: capturable
    return q.to(torch.int8) - 8


def _unpack4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] → int8 [..., in, out] (row 2i = low nibble)."""
    u = _unpack4_pairs(p)
    return u.reshape(*p.shape[:-2], p.shape[-2] * 2, p.shape[-1])


def dequantize(w: Any, dtype: torch.dtype = torch.float32) -> Any:
    if not is_quantized(w):
        return w
    return (payload(w).float() * w["s"]).to(dtype)


def quantize_params(
    params: Params, *, embed: bool = True, bits: int = 8, act_quant: bool = False,
) -> Params:
    """Quantize every projection matrix (and the embedding / lm_head
    table) of a param dict, as the JAX ``quantize_params`` does.

    ``bits=4`` packs the projections two per byte; the embedding and
    lm_head stay int8 in every mode (the table serves the embed gather
    and the head, which sets the logits' quality).  ``act_quant=True``
    stores the projections as ``qa`` / ``q4a`` (dynamic int8 activations,
    int32 accumulation); the table keeps the weight-only ``q`` mode.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qproj = quantize_array4 if bits == 4 else quantize_array
    out = dict(params)
    layers = dict(params["layers"])
    for key in list(layers):
        if key in _QUANT_KEYS:
            w = _quantize_stack(qproj, layers[key])
            if act_quant:
                pk = "q" if "q" in w else "q4"
                w = {pk + "a": w.pop(pk), **w}
            layers[key] = w
    out["layers"] = layers
    if embed:
        out["embed_tokens"] = quantize_array(params["embed_tokens"], axis=-1)
    if "lm_head" in params:
        out["lm_head"] = quantize_array(params["lm_head"], axis=-2)
    return out


def _quantize_stack(qproj: Callable, w: torch.Tensor) -> dict[str, torch.Tensor]:
    """``qproj(w, axis=-2)`` of a layer stack ``[L, ..., in, out]``, one
    layer at a time into preallocated payloads (the numbers are the
    whole stack's: the scales are per column of each slice).  Its
    float32 temporaries are one layer's: at Mixtral-8x7B widths, a whole
    expert stack's float32 copies would be tens of GB."""
    first = qproj(w[0], axis=-2)
    out = {k: v.new_empty((w.shape[0], *v.shape)) for k, v in first.items()}
    for i in range(w.shape[0]):
        for k, v in (first if i == 0 else qproj(w[i], axis=-2)).items():
            out[k][i] = v
    return out


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` with a float32 result.  On the card a
    bf16 product keeps its float32 accumulators (``out_dtype``) and
    copies neither operand; on the CPU the product runs in float32,
    which is exact for bf16 inputs; so does a product on the gradient
    path (training), which autograd differentiates as plain float32
    products."""
    if (x.is_cuda and x.dtype != torch.float32 and w.dtype == x.dtype
            and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))):
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x [B, M, K] @ w [B, K, N]`` with a float32 result, as
    ``_mm_f32``: on the card a bf16 product keeps its float32
    accumulators and copies neither operand (a transposed view
    included)."""
    if x.is_cuda and x.dtype != torch.float32 and w.dtype == x.dtype:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K] @ [K, N]`` → int32, exact.  On the card cuBLAS takes
    more than 16 rows: a decode step's few rows are padded with zeros and
    the pad is sliced off."""
    m = xq.shape[0]
    if xq.is_cuda and m < _INT_MM_MIN_ROWS:
        pad = torch.zeros((_INT_MM_MIN_ROWS - m, xq.shape[1]), dtype=xq.dtype, device=xq.device)
        return torch._int_mm(torch.cat([xq, pad]), wq)[:m]
    return torch._int_mm(xq, wq)


def _act_quant(x: torch.Tensor, row_amax: Callable | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization of x's last axis → (int8, scale
    with size 1 on that axis).  ``row_amax`` maps the rows' maxima to the
    ones to scale by (a tensor-parallel projection's maxima over every
    rank's columns)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if row_amax is not None:
        amax = row_amax(amax)
    sx = _scale(amax, 127.0)
    return torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8), sx


def _expert_einsum(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``einsum("gec<in>,e<in><out>->gec<out>", x, w)`` with a float32
    result: x's slots ``[G, E, C, in]`` meet their expert's weight
    ``[E, in, out]`` (plain or a quantized dict whose scale is
    ``[E, 1, out]``).  int4 payloads unpack to ``[E, in/2, 2, out]``,
    whose pair axes merge as a view (the pair contraction, with no
    copy of the weight); the W8A8 modes quantize each slot's row over
    ``in`` (an empty slot has amax 0 and so scale 1) and take one int8
    product per expert."""
    g, e, c, k = x.shape
    xe = x.transpose(0, 1).reshape(e, g * c, k)  # a view when G == 1
    if not is_quantized(w):
        y = _bmm_f32(xe, w)
    else:
        key = payload_key(w)
        p = payload(w)  # int8 [E, in, out]
        if key in ("qa", "q4a"):
            xq, sx = _act_quant(xe)
            y = torch.stack([_int_mm(xq[j], p[j].contiguous()) for j in range(e)])
            y = y.float() * sx * w["s"]
        else:
            y = _bmm_f32(xe, p.to(x.dtype)) * w["s"]
    return y.reshape(e, g, c, -1).transpose(0, 1)


def quant_einsum(spec: str, x: torch.Tensor, w: Any,
                 row_amax: Callable | None = None) -> torch.Tensor:
    """``einsum(spec, x, w)`` with a float32 result, for the model's three
    specs (``bsh,ho->bso``, ``bsh,hv->bsv``, ``bsh,vh->bsv``) and the MoE
    experts' two (``gech,ehi->geci``, ``geci,eih->gech``), taking a
    plain tensor or a quantized dict for ``w``.  ``row_amax``: the W8A8
    modes' hook on the rows' absmax (``_act_quant``), for the dense
    specs."""
    spec = spec.replace(" ", "")
    if spec in _EXPERT_SPECS:
        return _expert_einsum(x, w)
    if spec not in _SPECS:
        raise NotImplementedError(f"quant_einsum: spec {spec!r} is not one the model uses")
    out_major = _SPECS[spec]
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    if not is_quantized(w):
        return _mm_f32(x2, w.T if out_major else w).reshape(*lead, -1)
    key = payload_key(w)
    p = payload(w)  # int8 [in, out] (or [out, in] when out_major)
    wt = p.T if out_major else p
    s = w["s"].reshape(-1)  # per output column
    if key in ("qa", "q4a"):
        xq, sx = _act_quant(x2, row_amax)
        if not wt.is_contiguous():
            wt = wt.contiguous()
        y = _int_mm(xq, wt).float() * sx * s
    else:
        y = _mm_f32(x2, wt.to(x.dtype)) * s
    return y.reshape(*lead, -1)


def param_bytes(params: Params) -> int:
    """Total bytes of a (possibly quantized) param dict."""
    total = 0
    for v in params.values():
        if isinstance(v, dict):
            total += param_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total

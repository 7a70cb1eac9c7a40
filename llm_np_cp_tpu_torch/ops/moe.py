"""Sparse Mixture-of-Experts MLP (port of ``llm_np_cp_tpu/ops/moe.py``).

Mixtral-style top-k routing in the GShard dispatch/combine form: routing
becomes two batched products against a one-hot dispatch tensor, so every
shape is static and the layer reads nothing back to the host (the
``Generator``'s decode step and the engine's ticks are captured CUDA
graphs).  Tokens are processed in groups of ``gs ≤ group_size``; each
expert owns ``C = ceil(gs · k / E · capacity_factor)`` slots per group,
filled in token order.  A route past an expert's capacity is dropped
(its combine weight is zero) and the token passes through the residual.

Semantics follow the JAX function line for line; where torch differs:

- **Ties.** ``lax.top_k`` puts the lower expert first on equal
  probabilities, ``torch.topk`` does not: the selection here is a
  stable descending sort (a row whose router logits all tie, such as a
  zero hidden row, picks experts ``0 .. k-1`` as in JAX).
- **One-hot.** ``jax.nn.one_hot(-1)`` is a zero row; the dispatch here
  compares the kept slot position with ``arange(C)`` (no range check,
  so no host read).
- **Router precision.** The router product runs in float32 as a plain
  float32 product; nothing here enables TF32 (a flipped top-k choice
  changes a token's output by a whole expert).

The dispatch, expert and combine products are large plain products
that the JAX package leaves to XLA: here they are batched library
products over the group or expert axis with a float32 result
(``quant._bmm_f32``, ``quant.quant_einsum``), and are not a port of
any kernel.

Each part of the layer runs under a ``torch.profiler.record_function``
range of its own (``moe.routing``, ``moe.positions``, ``moe.dispatch``,
``moe.experts``, ``moe.combine``), so a profile splits the layer's
device time by part; a range is a host marker only, recorded where a
step is captured and never replayed.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.profiler import record_function

from llm_np_cp_tpu_torch.quant import _bmm_f32, quant_einsum


def _group_split(t: int, group_size: int) -> int:
    """Largest divisor of t that is ≤ group_size (group length gs; G=t/gs)."""
    gs = min(t, group_size)
    while t % gs:
        gs -= 1
    return gs


def top_k_stable(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, a lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(
    x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Router of tokens ``x [T, H]`` → ``(probs [T, E], gates [T, E])``
    in float32: the softmax over the true float32 router logits, and
    the renormalised top-k probabilities scattered onto their experts
    (0 elsewhere)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k_stable(probs, top_k)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)  # renorm (Mixtral)
    gates = torch.zeros_like(probs).scatter(1, top_idx, top_vals)
    return probs, gates


def dispatch_mask(
    routed: torch.Tensor, gs: int, capacity: int, dtype: torch.dtype,
) -> torch.Tensor:
    """Routes ``routed [T, E]`` (bool) → the one-hot dispatch tensor
    ``[G, gs, E, C]``: a route takes its expert's next slot in token
    order within its group, and a route past the capacity leaves a zero
    row."""
    t, e = routed.shape
    routed_g = routed.reshape(t // gs, gs, e)
    position = torch.cumsum(routed_g.to(torch.int32), dim=1) - 1  # [G, gs, E]
    slot = torch.where(routed_g & (position < capacity), position, -1)
    c = torch.arange(capacity, dtype=slot.dtype, device=slot.device)
    return (slot[..., None] == c).to(dtype)


def moe_mlp(
    x: torch.Tensor,
    router_w: torch.Tensor,
    gate_w,
    up_w,
    down_w,
    *,
    act: Callable[[torch.Tensor], torch.Tensor],
    top_k: int,
    capacity_factor: float = 2.0,
    group_size: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts.

    x: [B, S, H]; router_w: [H, E]; gate_w/up_w: [E, H, I]; down_w:
    [E, I, H] (plain tensors or ``quant.py`` payloads).

    Returns ``(out [B, S, H], aux_loss scalar)``: aux_loss is the
    load-balancing loss ``E · Σ_e f_e · P_e`` over the full token set
    (pads included), float32.
    """
    b, s, h = x.shape
    e = router_w.shape[-1]
    t = b * s
    xt = x.reshape(t, h)
    with record_function("moe.routing"):
        probs, gates = route(xt, router_w, top_k=top_k)
        routed = gates > 0.0

    gs = _group_split(t, group_size)
    g = t // gs
    capacity = max(1, math.ceil(gs * top_k / e * capacity_factor))
    with record_function("moe.positions"):
        dispatch = dispatch_mask(routed, gs, capacity, x.dtype)  # [G, gs, E, C]

    with record_function("moe.dispatch"):
        # gtec,gth->gech: the one-hot's transpose against the group's tokens
        d2 = dispatch.reshape(g, gs, e * capacity)
        expert_in = _bmm_f32(d2.transpose(1, 2), xt.reshape(g, gs, h))
        expert_in = expert_in.to(x.dtype).reshape(g, e, capacity, h)
    with record_function("moe.experts"):
        gate_h = act(quant_einsum("gech,ehi->geci", expert_in, gate_w)).to(x.dtype)
        up_h = quant_einsum("gech,ehi->geci", expert_in, up_w).to(x.dtype)
        expert_out = quant_einsum("geci,eih->gech", gate_h * up_h, down_w).to(x.dtype)

    with record_function("moe.combine"):
        # gtec,gech->gth with the gates cast to x's dtype first
        combine = dispatch * gates.reshape(g, gs, e).to(x.dtype)[..., None]
        out = _bmm_f32(combine.reshape(g, gs, e * capacity),
                       expert_out.reshape(g, e * capacity, h)).to(x.dtype)

    route_frac = routed.float().mean(dim=0) / top_k  # [E]
    prob_frac = probs.mean(dim=0)  # [E]
    aux_loss = e * torch.sum(route_frac * prob_frac)
    return out.reshape(b, s, h), aux_loss

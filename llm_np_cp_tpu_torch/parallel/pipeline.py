"""GPipe pipeline parallelism over the "pipe" mesh axis (port of
``llm_np_cp_tpu/parallel/pipeline.py``).

The stacked layer weights ``[L, ...]`` are sharded on their leading axis
over P pipeline stages (``param_specs`` puts "pipe" there); each rank
holds its stage's ``L/P`` layers, cut over "model" as usual.  The batch
is split into M microbatches; at step t stage p runs microbatch t−p
through its layers, then the activations take one hop along the ring
(``collectives.ppermute``).  M + P − 1 steps drain the pipeline; the
last stage keeps the outputs, broadcast to every stage by a masked sum
over "pipe".  Embedding, final norm and lm_head run outside the
pipelined region, on every stage.

``torch.autograd`` differentiates the schedule (the ring shift's
gradient takes the reverse shift; the masked broadcast passes its
gradient through), so the pipelined loss gives exact GPipe gradients.
Two things the JAX package gets from tracing one program are kept by
construction here:

- every rank issues the same collectives in the same order, backward
  included: the stages differ only in the values of ``where``
  conditions (stage 0 takes its microbatch, the others the ring; the
  last stage's outputs are kept, the others' masked to zero), never in
  which ops run, so a ring value that a stage does not use still has
  its gradient shifted back to the rank that waits for it;
- the embedding's output enters the ring through
  ``collectives.copy_to`` over "pipe": only stage 0 reads it, and the
  summed gradient reaches the lookup on every stage, so a tied
  embedding's gradient (the lookup's plus every stage's identical head)
  is whole and equal on every stage.

Scope: training and the cache-less forward.  The MoE router's aux loss
is averaged over (layer, microbatch) pairs, the per-microbatch
statistic the JAX package uses.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.models.transformer import (
    embed_inputs,
    final_logits,
    kv_head_select,
    layer_weights,
    run_decoder_layer,
)
from llm_np_cp_tpu_torch.ops.activations import ACT2FN
from llm_np_cp_tpu_torch.ops.attention import causal_mask
from llm_np_cp_tpu_torch.ops.rope import rope_cos_sin
from llm_np_cp_tpu_torch.parallel.collectives import all_reduce, copy_to, ppermute
from llm_np_cp_tpu_torch.parallel.sharding import PIPE_AXIS, Mesh, MeshPlan

Params = dict[str, Any]


def _stage_schedule(
    layers: Params,
    x_mb: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask_global: torch.Tensor,
    mask_local: torch.Tensor,
    *,
    config: ModelConfig,
    mesh: Mesh,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """This stage's part of the schedule.

    layers: this stage's ``[L/P, ...]`` weights; x_mb: ``[M, mb, S, H]``
    microbatched embeddings (every stage has them; stage 0 reads them).
    Returns ``([M, mb, S, H] final hidden states, moe_aux scalar or
    None)``, both the same on every stage."""
    num_stages, idx = mesh.size(PIPE_AXIS), mesh.index(PIPE_AXIS)
    num_micro = x_mb.shape[0]
    per_stage = config.num_hidden_layers // num_stages
    act = ACT2FN[config.hidden_act]
    kv_sel = kv_head_select(config, mesh)
    dev = x_mb.device
    first = torch.tensor(idx == 0, device=dev)
    last = torch.tensor(idx == num_stages - 1, device=dev)
    never = torch.tensor(False, device=dev)

    def local_block(x: torch.Tensor) -> tuple[torch.Tensor, list]:
        aux = []
        for j in range(per_stage):
            sliding = config.layer_is_sliding(idx * per_stage + j)
            x, _, _, a = run_decoder_layer(
                layer_weights(layers, j), x, config=config, act=act, cos=cos, sin=sin,
                mask=mask_local if sliding else mask_global, sliding=sliding, mesh=mesh,
                kv_sel=kv_sel,
            )
            aux.append(a)
        return x, aux

    steps = num_micro + num_stages - 1
    ring = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(num_micro)]
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev) if config.is_moe else None
    for t in range(steps):
        # stage 0 ingests microbatch t; later stages take the ring input
        x_in = torch.where(first, x_mb[min(t, num_micro - 1)], ring)
        y, layer_aux = local_block(x_in)
        if config.is_moe:
            # stage p holds microbatch t−p; a bubble's routes are garbage
            real = torch.tensor(idx <= t < idx + num_micro, device=dev)
            aux_sum = aux_sum + torch.where(real, torch.stack(layer_aux).sum(), 0.0)
        # the last stage finishes microbatch t−(P−1) at step t
        done = t - (num_stages - 1)
        oi = min(max(done, 0), num_micro - 1)
        outs[oi] = torch.where(last if done >= 0 else never, y, outs[oi])
        if t < steps - 1:  # the last step's shift would feed no one
            ring = ppermute(y, mesh, PIPE_AXIS)
    out = torch.stack(outs)
    out = all_reduce(torch.where(last, out, 0.0), mesh, PIPE_AXIS)
    if aux_sum is None:
        return out, None
    return out, all_reduce(aux_sum, mesh, PIPE_AXIS) / (config.num_hidden_layers * num_micro)


def pp_forward(
    params: Params,
    input_ids: Any,
    config: ModelConfig,
    plan: MeshPlan,
    mesh: Mesh,
    *,
    num_microbatches: int,
    logits_last_only: bool = False,
    output_router_losses: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Cache-less forward with the layer stack pipelined over "pipe".

    params: this rank's shards (``shard_params`` under ``plan``);
    input_ids: this rank's rows [B, S] (its "data" block, as
    ``forward(mesh=)`` takes them); B must divide into
    ``num_microbatches`` equal microbatches.

    Returns logits [B, S, V] float32 (or [B, 1, V] when
    logits_last_only), equal to ``models.transformer.forward`` with no
    cache; with ``output_router_losses`` also the MoE aux-loss scalar
    (averaged per microbatch)."""
    num_stages = plan.pipe
    if config.num_hidden_layers % num_stages:
        raise ValueError(
            f"num_hidden_layers={config.num_hidden_layers} not divisible by "
            f"pipe={num_stages}"
        )
    b, s = input_ids.shape
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {num_microbatches}")
    mb = b // num_microbatches
    input_ids = torch.as_tensor(input_ids, device=mesh.device).long()

    x = copy_to(embed_inputs(params, input_ids, config, mesh), mesh, PIPE_AXIS)
    positions = torch.arange(s, device=mesh.device).expand(mb, s)
    cos, sin = rope_cos_sin(positions, config, dtype=torch.float32)
    mask_global = causal_mask(positions, positions)
    mask_local = (
        causal_mask(positions, positions, window=config.sliding_window)
        if config.sliding_window is not None else mask_global
    )
    out, moe_aux = _stage_schedule(
        params["layers"], x.reshape(num_microbatches, mb, s, x.shape[-1]), cos, sin,
        mask_global, mask_local, config=config, mesh=mesh,
    )
    hidden = out.reshape(b, s, x.shape[-1])
    logits = final_logits(params, hidden, config, last_only=logits_last_only, mesh=mesh)
    if output_router_losses:
        return logits, moe_aux
    return logits


def make_pp_loss_fn(
    config: ModelConfig, plan: MeshPlan, mesh: Mesh, *, num_microbatches: int
) -> Callable:
    """Pipelined causal-LM loss — ``train.causal_lm_loss``'s contract and
    math: ``loss_fn(params, batch, loss_mask=None)`` over the whole batch
    (this rank takes its "data" rows), the global loss on every rank,
    the MoE router aux loss with its per-microbatch semantics."""
    from llm_np_cp_tpu_torch.train import check_train_plan, data_rows, lm_loss

    check_train_plan(plan, config)

    def loss_fn(params: Params, batch: Any, loss_mask: Any = None) -> torch.Tensor:
        batch = data_rows(torch.as_tensor(batch, device=mesh.device).long(), mesh)
        if loss_mask is not None:
            loss_mask = data_rows(
                torch.as_tensor(loss_mask, device=mesh.device, dtype=torch.float32), mesh)
        inputs, targets = batch[:, :-1], batch[:, 1:]
        logits, moe_aux = pp_forward(
            params, inputs, config, plan, mesh,
            num_microbatches=num_microbatches, output_router_losses=True,
        )
        return lm_loss(logits, targets, config, loss_mask=loss_mask, moe_aux=moe_aux, mesh=mesh)

    return loss_fn


def make_pp_train_step(
    config: ModelConfig,
    optimizer: Any,
    plan: MeshPlan,
    mesh: Mesh,
    *,
    num_microbatches: int,
) -> Callable:
    """Pipelined ``step(params, opt_state, batch) → (params, opt_state,
    loss)``: gradients flow backward through the ring (exact GPipe), the
    optimizer updates each rank's shards in place."""
    from llm_np_cp_tpu_torch.train import make_step

    loss_fn = make_pp_loss_fn(config, plan, mesh, num_microbatches=num_microbatches)
    return make_step(loss_fn, optimizer, config, mesh)

"""Mesh + sharding specs over ``torch.distributed`` (port of
``llm_np_cp_tpu/parallel/sharding.py``).

The JAX module places a whole param pytree onto a ``Mesh`` with
NamedShardings and lets GSPMD insert the collectives.  Here every rank is
a process of its own: ``make_mesh`` builds a ``DeviceMesh`` (one process
group per named axis, in the JAX dim order ``(data, pipe, seq, expert,
model)``), ``shard_params`` cuts this rank's local shards out of a full
param dict, and the forward issues the collectives itself
(``collectives.py``, ``models.transformer.forward(mesh=)``).

Tensor-parallel layout (Megatron-style, as in the JAX package):
- q/k/v/gate/up projections: column-sharded (output features) on "model";
- o/down projections: row-sharded (input features) on "model", their
  partial sums all-reduced (the bias added after the reduce);
- embed: vocab rows on "model" (a masked lookup, then an all-reduce);
  the head (tied embedding or ``lm_head``'s columns) is column-parallel,
  its logits all-gathered over "model";
- KV heads on "model" when divisible, else replicated (Gemma-2's 4 KV
  heads on a wider mesh); each rank then attends with the KV heads its
  own query heads group onto;
- batch rows on "data"; the prompt's positions on "seq" under ring
  attention.

The spec functions return trees of ``P`` (a tuple of axis names or None
per dimension), entry for entry JAX's PartitionSpecs: ``param_specs``
follows ``param_shapes``, ``cache_specs`` and ``paged_kv_specs`` are
dicts keyed by the cache's fields.  JAX's ``to_shardings`` and
``shard_cache`` have no counterpart: nothing places a global array, and
the cache each rank allocates already has its local shape.
``cache_specs`` still says how the port lays out its cache: KV heads on
"model" when divisible, batch rows on "data"; after a ring prefill every
"seq" rank holds the whole cache (its K/V all-gathered along "seq"), so
decode is the single-block step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
# the mesh's dims, in the JAX package's order
MESH_AXES = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)

# what a multi-rank MoE forward waits for
MOE_TP_ITEM = ("MoE under a model axis > 1 (expert and tensor parallelism over ops/moe.py) "
               "is not ported yet (ROADMAP.md queue 1 item 8c)")


class P(tuple):
    """PartitionSpec counterpart: one mesh axis name (or None) per
    dimension; ``tuple(P(...)) == tuple(jax PartitionSpec(...))``."""

    def __new__(cls, *entries: str | None) -> "P":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Static parallelism plan: how many ways each mesh axis is split.

    data: batch sharding (DP); model: tensor parallelism (TP);
    seq: sequence/context parallelism for ring attention; pipe: pipeline
    parallelism over the stacked layer axis (training only); expert:
    expert parallelism for MoE configs.
    """

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq * self.pipe * self.expert

    def validate(self, config: ModelConfig) -> None:
        if self.model > 1:
            for dim, name in [
                (config.num_attention_heads, "num_attention_heads"),
                (config.intermediate_size, "intermediate_size"),
                (config.vocab_size, "vocab_size"),
            ]:
                if dim % self.model != 0:
                    raise ValueError(
                        f"{name}={dim} not divisible by model={self.model}"
                    )
        if self.pipe > 1 and config.num_hidden_layers % self.pipe != 0:
            raise ValueError(
                f"num_hidden_layers={config.num_hidden_layers} not divisible "
                f"by pipe={self.pipe}"
            )
        if self.expert > 1:
            if not config.is_moe:
                raise ValueError("expert>1 requires a MoE config")
            if config.num_local_experts % self.expert != 0:
                raise ValueError(
                    f"num_local_experts={config.num_local_experts} not "
                    f"divisible by expert={self.expert}"
                )


def parse_mesh_spec(text: str) -> MeshPlan:
    """CLI mesh syntax → MeshPlan: named axes ``data=2,pipe=2,model=2``
    (any of data/seq/model/pipe/expert) or the positional
    ``data,seq,model`` triple.  Raises SystemExit with a usage message on
    any malformed input (axis typos, non-integer values, wrong arity)."""
    axes = ("data", "seq", "model", "pipe", "expert")
    usage = (
        f"--mesh {text!r}: use named axes like data=2,pipe=2,model=2 "
        "(axes: data/seq/model/pipe/expert) or the positional "
        "data,seq,model triple"
    )
    kw = {}
    parts = [p for p in text.split(",") if p]
    try:
        if parts and all("=" in p for p in parts):
            for p in parts:
                name, _, val = p.partition("=")
                if name not in axes:
                    raise SystemExit(f"unknown mesh axis {name!r}; {usage}")
                kw[name] = int(val)
        elif len(parts) == 3 and not any("=" in p for p in parts):
            kw = dict(zip(("data", "seq", "model"), (int(p) for p in parts)))
        else:
            raise SystemExit(usage)
    except ValueError:
        raise SystemExit(usage) from None
    return MeshPlan(**kw)


# ----------------------------------------------------------------------
# The mesh: this rank's place in the plan and one group an axis
# ----------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh: the plan, the ``DeviceMesh`` (one
    process group a named axis), the device its tensors live on, the
    group backend and its coordinate on every axis."""

    plan: MeshPlan
    device_mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    backend: str
    coords: dict[str, int]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size (JAX's ``mesh.shape``)."""
        return {a: getattr(self.plan, a) for a in MESH_AXES}

    def size(self, axis: str) -> int:
        return getattr(self.plan, axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def device_count_error(plan: MeshPlan, device: str | torch.device | None,
                       backend: str | None) -> str | None:
    """JAX's ``make_mesh`` message when the plan needs more cards than
    there are, else None.  On the CPU every rank is a process; on CUDA
    each rank needs a card of its own, unless the caller places the ranks
    (``device=``) and names ``backend="gloo"``, which can hold several
    ranks on one card."""
    n = plan.num_devices
    dev_type = torch.device(device).type if device is not None else "cuda"
    if dev_type != "cuda" or (device is not None and backend == "gloo"):
        return None
    have = torch.cuda.device_count()
    return f"plan needs {n} devices, have {have}" if n > have else None


def make_mesh(plan: MeshPlan, *, device: str | torch.device | None = None,
              backend: str | None = None) -> Mesh:
    """This rank's ``Mesh`` over the running process group: a
    ``DeviceMesh`` of the plan's ``(data, pipe, seq, expert, model)``
    dims (``init_device_mesh``), each axis's group on ``backend``.

    device: where this rank's tensors live; default ``cuda:<local
        rank>`` (``LOCAL_RANK``, else the global rank).
    backend: default NCCL on CUDA, gloo on the CPU.  Several ranks share
        one card only when the caller passes both ``device=`` and
        ``backend="gloo"``; otherwise a plan that needs more cards than
        the host has raises JAX's ``plan needs N devices, have M``.

    The process group must have the plan's rank count (it is initialized
    from the environment, ``env://``, when it is not running yet).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    err = device_count_error(plan, device, backend)
    if err:
        raise ValueError(err)
    n = plan.num_devices
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n:
        raise ValueError(f"plan needs {n} ranks, the process group has {world}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dims = tuple(getattr(plan, a) for a in MESH_AXES)
    dm = init_device_mesh(dev.type, dims, mesh_dim_names=MESH_AXES,
                          backend_override={a: backend for a in MESH_AXES})
    coords = dict(zip(MESH_AXES, dm.get_coordinate()))
    return Mesh(plan=plan, device_mesh=dm, device=dev, backend=backend, coords=coords)


# ----------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------

def _kv_heads_shardable(config: ModelConfig, plan: MeshPlan) -> bool:
    return plan.model > 1 and config.num_key_value_heads % plan.model == 0


def kv_heads_shardable(config: ModelConfig, plan: MeshPlan) -> bool:
    """True when the KV heads can be tensor-parallel over "model"; the
    replicated fallback otherwise (Gemma-2's 4 KV heads on an 8-way
    mesh)."""
    return _kv_heads_shardable(config, plan)


def local_kv_heads(config: ModelConfig, mesh: Mesh | None) -> int:
    """The KV heads a rank's cache holds: its share over "model" when
    they shard, else all of them."""
    if mesh is not None and _kv_heads_shardable(config, mesh.plan):
        return config.num_key_value_heads // mesh.plan.model
    return config.num_key_value_heads


def normalize_specs(specs: Any) -> Any:
    """Strip trailing ``None`` entries from every ``P`` leaf (GSPMD's
    normalized spelling; kept so spec trees compare with JAX's)."""
    if isinstance(specs, P):
        entries = list(specs)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)
    if isinstance(specs, dict):
        return {k: normalize_specs(v) for k, v in specs.items()}
    return specs


def paged_kv_specs(config: ModelConfig, plan: MeshPlan, quantized: bool = False) -> dict:
    """Specs of the serving pool's ``PagedKV`` slabs ``[L, NB, BS, K, D]``
    (keyed by its fields): the KV-head axis on "model" when divisible,
    everything else unsharded; int8 scale pages ``[L, NB, BS, K]`` shard
    like the values minus D."""
    kv = MODEL_AXIS if _kv_heads_shardable(config, plan) else None
    scale = P(None, None, None, kv) if quantized else None
    return normalize_specs(dict(
        k=P(None, None, None, kv, None),
        v=P(None, None, None, kv, None),
        k_scale=scale,
        v_scale=scale,
    ))


def param_specs(config: ModelConfig, plan: MeshPlan) -> dict[str, Any]:
    """``P`` tree matching ``models.transformer.param_shapes``.  The
    leading layer axis is sharded over "pipe" only under pipeline
    parallelism."""
    m = MODEL_AXIS if plan.model > 1 else None
    kv = MODEL_AXIS if _kv_heads_shardable(config, plan) else None
    pp = PIPE_AXIS if plan.pipe > 1 else None
    layers = {
        "ln_attn_in": P(pp, None),
        "q_proj": P(pp, None, m),
        "k_proj": P(pp, None, kv),
        "v_proj": P(pp, None, kv),
        "o_proj": P(pp, m, None),
        "ln_mlp_in": P(pp, None),
        "gate_proj": P(pp, None, m),
        "up_proj": P(pp, None, m),
        "down_proj": P(pp, m, None),
    }
    if config.attention_bias:
        # biases follow their projection's output sharding; o_bias is added
        # after the row-parallel reduce, so it stays replicated
        layers["q_bias"] = P(pp, m)
        layers["k_bias"] = P(pp, kv)
        layers["v_bias"] = P(pp, kv)
        layers["o_bias"] = P(pp, None)
    if config.mlp_bias:
        layers["gate_bias"] = P(pp, m)
        layers["up_bias"] = P(pp, m)
        layers["down_bias"] = P(pp, None)
    if config.is_moe:
        ex = EXPERT_AXIS if plan.expert > 1 else None
        layers["router"] = P(pp, None, None)
        layers["gate_proj"] = P(pp, ex, None, m)
        layers["up_proj"] = P(pp, ex, None, m)
        layers["down_proj"] = P(pp, ex, m, None)
    if config.sandwich_norms:
        layers["ln_attn_out"] = P(pp, None)
        layers["ln_mlp_out"] = P(pp, None)
    specs: dict[str, Any] = {
        "embed_tokens": P(m, None),
        "layers": layers,
        "final_norm": P(None),
    }
    if not config.tie_word_embeddings:
        specs["lm_head"] = P(None, m)
    return specs


def cache_specs(config: ModelConfig, plan: MeshPlan, quantized: bool = False) -> dict:
    """KV cache layout ``[L, B, S, K, D]`` keyed by ``KVCache``'s fields:
    batch on data, KV heads on model (when divisible), seq on the seq
    axis.  The int8 cache's scales ``[L, B, S, K]`` shard like the
    values minus D.  (After a ring prefill the port's cache holds the
    whole sequence on every seq rank: see the module docstring.)"""
    d = DATA_AXIS if plan.data > 1 else None
    kv = MODEL_AXIS if _kv_heads_shardable(config, plan) else None
    s = SEQ_AXIS if plan.seq > 1 else None
    scale = P(None, d, s, kv) if quantized else None
    return dict(
        k=P(None, d, s, kv, None),
        v=P(None, d, s, kv, None),
        valid=P(d, s),
        length=P(),
        k_scale=scale,
        v_scale=scale,
    )


def batch_spec(plan: MeshPlan) -> P:
    return P(DATA_AXIS if plan.data > 1 else None, None)


def _scale_spec(spec: P, leaf: dict) -> P:
    """The spec of a quantized leaf's scale: the weight's spec with the
    contracted axes (size 1 in the scale, > 1 in the payload) cleared."""
    from llm_np_cp_tpu_torch.quant import payload_key

    q = leaf[payload_key(leaf)]
    s = leaf["s"]
    entries = list(spec) + [None] * (q.dim() - len(spec))
    return P(*[
        None if (s.shape[i] == 1 and q.shape[i] != 1) else entries[i]
        for i in range(q.dim())
    ])


# ----------------------------------------------------------------------
# Local shards
# ----------------------------------------------------------------------

def _cut(t: torch.Tensor, spec: P, plan: MeshPlan, coords: dict[str, int], name: str,
         packed: bool = False) -> torch.Tensor:
    """This coordinate's block of ``t`` under ``spec``: a contiguous copy
    when any dim is cut, ``t`` itself when none is.  ``packed``: an int4
    payload, two rows a byte along dim -2."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = getattr(plan, axis)
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            if packed and dim == t.dim() - 2:
                raise ValueError(
                    f"{name}: an int4 payload packs two rows a byte along the contraction "
                    f"axis: {2 * size} rows over {axis}={n} leave {2 * size / n:g} a shard, "
                    "not whole bytes")
            raise ValueError(f"{name}: dim {dim} of size {size} is not divisible by "
                             f"{axis}={n}")
        step = size // n
        out = out.narrow(dim, coords[axis] * step, step)
    return out if out is t else out.contiguous().clone()


def local_shards(params: Any, config: ModelConfig, plan: MeshPlan,
                 coords: dict[str, int]) -> Any:
    """The shards of ``params`` that the rank at ``coords`` (axis →
    index) holds: ``param_specs`` cut out of every leaf.  A quantized
    leaf's payload takes the weight's spec, its scale ``_scale_spec``."""
    from llm_np_cp_tpu_torch.quant import is_quantized, payload_key

    def place(spec: Any, leaf: Any, name: str) -> Any:
        if isinstance(spec, dict):  # the params' own leaves (the specs may name more)
            return {k: place(spec[k], leaf[k], k) for k in leaf}
        if is_quantized(leaf):
            pk = payload_key(leaf)
            return {
                pk: _cut(leaf[pk], spec, plan, coords, name, packed=pk in ("q4", "q4a")),
                "s": _cut(leaf["s"], _scale_spec(spec, leaf), plan, coords, name + ".s"),
            }
        return _cut(leaf, spec, plan, coords, name)

    return place(param_specs(config, plan), params, "params")


def gather_shards(local: Any, config: ModelConfig, mesh: Mesh) -> Any:
    """The inverse of ``local_shards``: the whole param tree from every
    rank's shards (a tree shaped like the params: their gradients or an
    optimizer moment alike), each cut dimension all-gathered over its
    axis.  Every rank must call it; every rank gets the whole tree, on
    the device of its shards."""
    from llm_np_cp_tpu_torch.parallel.collectives import all_gather
    from llm_np_cp_tpu_torch.quant import is_quantized, payload_key

    def whole(t: torch.Tensor, spec: P) -> torch.Tensor:
        for dim, axis in enumerate(spec):
            if axis is not None and mesh.size(axis) > 1:
                t = all_gather(t, mesh, axis, dim=dim)
        return t

    def join(spec: Any, leaf: Any) -> Any:
        if isinstance(spec, dict):
            return {k: join(spec[k], leaf[k]) for k in leaf}
        if is_quantized(leaf):
            pk = payload_key(leaf)
            return {pk: whole(leaf[pk], spec), "s": whole(leaf["s"], _scale_spec(spec, leaf))}
        return whole(leaf, spec)

    with torch.no_grad():
        return join(param_specs(config, mesh.plan), local)


def shard_params(params: Any, config: ModelConfig, plan: MeshPlan, mesh: Mesh) -> Any:
    """This rank's local shards of a full param dict, on ``mesh.device``:
    plain contiguous tensors cut by the rank's coordinate.  Quantized
    leaves (``{"q", "s"}``, int4 ``{"q4", "s"}``, the a8 modes) keep their
    payload and scale, cut alike, so int8 / int4 weights compose with
    the mesh."""
    plan.validate(config)
    if config.is_moe and plan.model > 1:
        raise NotImplementedError(MOE_TP_ITEM)
    local = local_shards(params, config, plan, mesh.coords)

    def to_dev(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        return t.to(mesh.device)

    return to_dev(local)

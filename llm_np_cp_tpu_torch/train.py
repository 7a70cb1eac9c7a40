"""Training (port of ``llm_np_cp_tpu/train.py``): the causal-LM loss, an
AdamW step equal to the JAX package's optax chain, and the training
command line, ``python -m llm_np_cp_tpu_torch.train``.

The loss runs ``models.transformer.forward`` (the plain ``"xla"``
attention path, as the JAX loss does: no kernel of the port has a
backward, and none of the JAX package's has one either) and
``torch.autograd`` differentiates it.  The optimizer is
``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))`` written
as foreach tensor ops under ``torch.no_grad()``: the clip divides by
the global norm when it is at least 1 (no epsilon, unlike
``torch.nn.utils.clip_grad_norm_``), Adam's moments are bias-corrected
with eps outside the square root, and weight decay 1e-4 applies to every
leaf, norms and embeddings included.  Its state is a plain tree
(``{"count": int, "mu": tree, "nu": tree}``, the trees shaped like the
params), so ``utils/checkpoint.py`` saves it as it is.

Under a mesh (``mesh=``, ``parallel/sharding.py``) the params are this
rank's shards and every rank passes the whole batch: each cuts its own
"data" rows.  The forward's collectives carry their gradients
(``parallel/collectives.py``), so every leaf replicated over an axis
comes out of the backward whole and identical on every rank of that
axis; the only reduction outside the graph is the gradient's mean over
"data".  The loss is the global mean (a masked loss all-reduces its
numerator and denominator), and the clip's global norm is the norm of
the global gradient (a leaf sharded over an axis sums its squares over
it; a replicated leaf counts once).  The GPipe schedule over "pipe" is
``parallel/pipeline.py``.

What differs from the JAX package: the step updates ``params`` and
``opt_state`` in place (PyTorch's optimizer idiom) and returns them;
``--platform`` and ``--virtual-devices`` give way to ``--device``;
``--mesh`` spawns its ranks (``parallel/launch.py``: gloo on the CPU,
NCCL on the card, a card a rank); ``--model`` is a preset or a local
checkpoint directory, and a preset's weights come from the port's
``init_params``, whose draws differ from ``jax.random``'s; the
tokenizer for ``--data`` is the caller's (``run(argv, tokenizer=)``).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable

import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.models.transformer import forward
from llm_np_cp_tpu_torch.parallel.collectives import all_reduce
from llm_np_cp_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MOE_TP_ITEM,
    Mesh,
    MeshPlan,
    param_specs,
)

Params = dict[str, Any]

# what a training mesh waits for (ROADMAP.md queue 1)
SEQ_TRAIN_ITEM = ("training under a 'seq' axis > 1 (the backward of ring attention) is not "
                  "ported yet (ROADMAP.md queue 1 item 10)")
EXPERT_TRAIN_ITEM = ("training a MoE config over an 'expert' or 'data' axis > 1 (expert "
                     "parallelism, and the router's whole-batch statistics across ranks) is "
                     "not ported yet (ROADMAP.md queue 1 item 11)")
# default_optimizer: optax.clip_by_global_norm(1.0), then optax.adamw's
# defaults (b1, b2, eps outside the square root, weight decay on every leaf)
CLIP_NORM = 1.0
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def check_train_plan(plan: MeshPlan, config: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a plan the training path does not
    run yet (after ``plan.validate``, whose errors are the JAX package's)."""
    if plan.seq > 1:
        raise NotImplementedError(SEQ_TRAIN_ITEM)
    if config.is_moe and (plan.expert > 1 or plan.data > 1):
        raise NotImplementedError(EXPERT_TRAIN_ITEM)
    if config.is_moe and plan.model > 1:
        raise NotImplementedError(MOE_TP_ITEM)


# ----------------------------------------------------------------------
# Param trees
# ----------------------------------------------------------------------

def tree_leaves(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` of every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in tree_leaves(v, prefix + (k,))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf (the dict structure kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_get(tree: Any, path: tuple[str, ...]) -> Any:
    """The leaf of ``tree`` at ``path`` (a ``tree_leaves`` path)."""
    for k in path:
        tree = tree[k]
    return tree


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------

def data_rows(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's block of ``t``'s rows over "data" (all of them
    without a mesh)."""
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return t
    n = t.shape[0] // mesh.size(DATA_AXIS)
    return t[mesh.index(DATA_AXIS) * n:(mesh.index(DATA_AXIS) + 1) * n]


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, config: ModelConfig, *,
            loss_mask: torch.Tensor | None = None, moe_aux: torch.Tensor | None = None,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Mean next-token NLL of float32 ``logits [b, s, V]`` against
    ``targets [b, s]`` (a masked mean under ``loss_mask``), plus
    ``router_aux_loss_coef ×`` ``moe_aux`` on a MoE config.

    Under "data" the rows are this rank's: the value is the global mean
    (the masked numerator and denominator all-reduced), and the gradient
    is this rank's share of it scaled so that the mean of the ranks'
    gradients is the global one."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    dp = mesh.size(DATA_AXIS) if mesh is not None else 1
    if loss_mask is not None:
        den = loss_mask.sum()
        if dp > 1:
            den = all_reduce(den, mesh, DATA_AXIS)
        local = dp * torch.sum(nll * loss_mask) / torch.clamp_min(den, 1.0)
    else:
        local = nll.mean()
    if config.is_moe:
        local = local + config.router_aux_loss_coef * moe_aux
    if dp == 1:
        return local
    value = all_reduce(local.detach().clone(), mesh, DATA_AXIS) / dp
    return local + (value - local.detach())


def causal_lm_loss(
    params: Params,
    batch: Any,
    config: ModelConfig,
    *,
    loss_mask: Any = None,
    mesh: Mesh | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Mean next-token cross-entropy.  batch: [B, S] integer ids;
    positions t < S-1 predict t+1.  loss_mask: optional [B, S-1]
    weighting.  MoE configs add ``router_aux_loss_coef ×`` the
    load-balancing loss.

    mesh: ``params`` are this rank's shards, ``batch`` (and
        ``loss_mask``) the whole batch, of which this rank takes its
        "data" rows; the value is the global loss on every rank.
    device: where ``params`` live without a mesh; "cuda" (default)
        raises without a card."""
    if mesh is not None:
        check_train_plan(mesh.plan, config)
    dev = mesh.device if mesh is not None else resolve_device(device)
    batch = data_rows(torch.as_tensor(batch, device=dev).long(), mesh)
    if loss_mask is not None:
        loss_mask = data_rows(torch.as_tensor(loss_mask, device=dev, dtype=torch.float32), mesh)
    inputs, targets = batch[:, :-1], batch[:, 1:]
    out = forward(params, inputs, config, output_router_losses=config.is_moe, device=dev,
                  mesh=mesh)
    moe_aux = out[2]["moe_aux_loss"] if config.is_moe else None
    return lm_loss(out[0], targets, config, loss_mask=loss_mask, moe_aux=moe_aux, mesh=mesh)


# ----------------------------------------------------------------------
# Optimizer
# ----------------------------------------------------------------------

def global_norm(grads: Params, mesh: Mesh | None = None,
                config: ModelConfig | None = None) -> torch.Tensor:
    """The L2 norm of the whole gradient (``optax.global_norm``), float32.
    Under a mesh ``grads`` are this rank's shards: each leaf's squared
    norm is summed over the axes ``param_specs`` shards it on, and a
    replicated leaf counts once."""
    leaves = tree_leaves(grads)
    norms = torch._foreach_norm([g.float() for _, g in leaves])
    if mesh is None:
        return torch.stack(norms).square().sum().sqrt()
    specs = dict(tree_leaves(param_specs(config, mesh.plan)))
    by_axes: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for (path, _), n in zip(leaves, norms):
        axes = tuple(a for a in specs[path] if a is not None and mesh.size(a) > 1)
        by_axes.setdefault(axes, []).append(n)
    total = None
    for axes, ns in by_axes.items():  # one order on every rank: the leaves'
        sq = torch.stack(ns).square().sum()
        for axis in axes:
            sq = all_reduce(sq, mesh, axis)
        total = sq if total is None else total + sq
    return total.sqrt()


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))``
    on torch tensors: ``init(params)`` → ``opt_state``;
    ``update(grads, opt_state, params)`` clips ``grads``, advances the
    moments and updates ``params``, all in place, and returns
    ``(params, opt_state)``."""

    def __init__(self, lr: float) -> None:
        self.lr = lr

    def init(self, params: Params) -> dict:
        zeros = lambda t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads: Params, opt_state: dict, params: Params, *,
               mesh: Mesh | None = None, config: ModelConfig | None = None) -> tuple:
        paths = [path for path, _ in tree_leaves(params)]
        p, g, mu, nu = ([tree_get(t, path) for path in paths]
                        for t in (params, grads, opt_state["mu"], opt_state["nu"]))
        norm = global_norm(grads, mesh, config)
        # clip_by_global_norm: t / norm * 1.0 where norm >= 1.0
        torch._foreach_div_(g, torch.where(norm < CLIP_NORM, torch.ones_like(norm), norm))
        count = opt_state["count"] + 1
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        # p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p), with one
        # temporary the size of the params (the denominator)
        denom = torch._foreach_div(nu, 1.0 - B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_mul_(p, 1.0 - self.lr * WEIGHT_DECAY)
        torch._foreach_addcdiv_(p, mu, denom, value=-self.lr / (1.0 - B1 ** count))
        opt_state["count"] = count
        return params, opt_state


def default_optimizer(lr: float = 1e-4) -> AdamW:
    return AdamW(lr)


def loss_and_grads(loss_fn: Callable, params: Params, batch: Any, *,
                   mesh: Mesh | None = None) -> tuple[torch.Tensor, Params]:
    """``(loss, grads)`` of ``loss_fn(params, batch)`` (``jax.value_and_grad``):
    the grads a tree shaped like ``params``, averaged over "data" under a
    mesh (the one reduction outside the graph)."""
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    if mesh is not None and mesh.size(DATA_AXIS) > 1:
        with torch.no_grad():
            grads = [all_reduce(g, mesh, DATA_AXIS) for g in grads]
            torch._foreach_div_(grads, mesh.size(DATA_AXIS))
    return loss.detach(), _unflatten(params, grads)


def make_step(loss_fn: Callable, optimizer: AdamW, config: ModelConfig,
              mesh: Mesh | None = None) -> Callable:
    """``step(params, opt_state, batch) → (params, opt_state, loss)`` over
    ``loss_fn(params, batch)``."""

    def step(params: Params, opt_state: dict, batch: Any):
        loss, grads = loss_and_grads(loss_fn, params, batch, mesh=mesh)
        params, opt_state = optimizer.update(grads, opt_state, params, mesh=mesh, config=config)
        return params, opt_state, loss

    return step


def make_train_step(config: ModelConfig, optimizer: AdamW, *, mesh: Mesh | None = None,
                    device: str | torch.device = "cuda") -> Callable:
    """``step(params, opt_state, batch) → (params, opt_state, loss)``:
    ``causal_lm_loss``'s gradients, then ``optimizer.update`` (in place).
    Under ``mesh`` the params are this rank's shards and ``batch`` the
    whole batch on every rank."""
    if mesh is not None:
        check_train_plan(mesh.plan, config)
    else:
        device = resolve_device(device)

    def loss_fn(params: Params, batch: Any) -> torch.Tensor:
        return causal_lm_loss(params, batch, config, mesh=mesh, device=device)

    return make_step(loss_fn, optimizer, config, mesh)


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m llm_np_cp_tpu_torch.train",
        description="Causal-LM training on the card (DP/TP/PP over spawned ranks).",
    )
    p.add_argument("--model", default="tiny",
                   help="preset (tiny, tiny_moe, llama1b, llama3b, gemma2_2b "
                        "— random init) or a local checkpoint dir")
    p.add_argument("--mesh", default="1,1,1",
                   help="named axes data=2,pipe=2,model=2 (any of data/seq/"
                        "model/pipe/expert) or positional data,seq,model")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--microbatches", type=int, default=2,
                   help="GPipe microbatches per step (pipe>1 only)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="f32",
                   help="parameter dtype (f32 default: optimizer math)")
    p.add_argument("--data", default=None,
                   help="UTF-8 text file tokenized with the caller's tokenizer "
                        "(checkpoint models only); default: synthetic tokens")
    p.add_argument("--layers", type=int, default=None,
                   help="override the preset's layer count (e.g. to make it "
                        "divisible by pipe)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save {params, opt_state, step} here after training")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def _resolve_model(args):
    """(tokenizer, params, config): a preset's random weights (no
    tokenizer), or a local checkpoint directory with the caller's
    tokenizer (``args.tokenizer``)."""
    from llm_np_cp_tpu_torch.config import GEMMA_2_2B, LLAMA_3_2_1B, LLAMA_3_2_3B, tiny_config
    from llm_np_cp_tpu_torch.models.transformer import init_params

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    tiny_kw = dict(num_hidden_layers=args.layers) if args.layers else {}
    presets = {
        "tiny": lambda: tiny_config("llama", **tiny_kw),
        "tiny_moe": lambda: tiny_config(
            "llama", num_local_experts=4, num_experts_per_tok=2, **tiny_kw
        ),
        "llama1b": lambda: LLAMA_3_2_1B,
        "llama3b": lambda: LLAMA_3_2_3B,
        "gemma2_2b": lambda: GEMMA_2_2B,
    }
    if args.model in presets:
        if args.layers and args.model not in ("tiny", "tiny_moe"):
            raise SystemExit("--layers applies to the tiny presets only")
        config = presets[args.model]()
        return None, init_params(args.seed, config, dtype, device=args.device), config
    if args.layers:
        raise SystemExit("--layers applies to the tiny presets only")
    from llm_np_cp_tpu_torch.utils.loading import load_model

    return load_model(args.model, dtype=dtype, device=args.device,
                      tokenizer=getattr(args, "tokenizer", None))


def _batches(args, tokenizer, vocab_size):
    """Yield [batch, seq_len] int32 numpy arrays forever (the JAX CLI's
    draws: the same text windows, or the same two synthetic batches)."""
    import numpy as np

    if args.data:
        if tokenizer is None:
            raise SystemExit("--data needs a checkpoint model (tokenizer)")
        text = open(args.data, encoding="utf-8").read()
        ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int32)
        need = args.batch * args.seq_len
        if ids.size < need:
            ids = np.tile(ids, need // ids.size + 1)
        off = 0
        while True:
            if off + need > ids.size:
                off = 0
            yield ids[off:off + need].reshape(args.batch, args.seq_len)
            off += need
    else:
        # a small FIXED corpus cycled forever, so a smoke run shows the
        # loss falling as the model memorizes it
        rng = np.random.default_rng(args.seed)
        corpus = [
            rng.integers(0, vocab_size, (args.batch, args.seq_len), dtype=np.int32)
            for _ in range(2)
        ]
        i = 0
        while True:
            yield corpus[i % len(corpus)]
            i += 1


def _train_loop(step: Callable, params: Params, opt_state: dict, batches: list, device,
                toks: int, echo: bool) -> tuple[list[float], Params, dict]:
    losses: list[float] = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, torch.as_tensor(batch, device=device))
        loss = float(loss)  # waits for the card: the step's wall time is real
        dt = time.perf_counter() - t0
        losses.append(loss)
        if echo:
            print(f"step {i:4d}  loss {loss:.4f}  {toks / dt:,.0f} tok/s", file=sys.stderr,
                  flush=True)
    return losses, params, opt_state


def _make_step(config: ModelConfig, opt: AdamW, plan: MeshPlan, mesh: Mesh | None,
               microbatches: int, device) -> Callable:
    if plan.pipe > 1:
        from llm_np_cp_tpu_torch.parallel.pipeline import make_pp_train_step

        return make_pp_train_step(config, opt, plan, mesh, num_microbatches=microbatches)
    return make_train_step(config, opt, mesh=mesh, device=device)


def _train_rank(rank: int, plan: MeshPlan, on_cuda: bool, params: Params, config: ModelConfig,
                batches: list, lr: float, microbatches: int, toks: int,
                checkpoint_dir: str | None, steps: int) -> list[float]:
    """One spawned rank of a ``--mesh`` run: its shards, the steps, and
    the gathered checkpoint (rank 0 writes it).  Returns its losses."""
    from llm_np_cp_tpu_torch.parallel.sharding import make_mesh, shard_params

    mesh = make_mesh(plan, device=None if on_cuda else "cpu")
    # the step updates its params in place: an uncut leaf must not stay
    # the shared-memory tensor every rank on this host was given
    local = tree_map(torch.clone, shard_params(params, config, plan, mesh))
    del params
    opt = default_optimizer(lr)
    opt_state = opt.init(local)
    step = _make_step(config, opt, plan, mesh, microbatches, mesh.device)
    losses, local, opt_state = _train_loop(step, local, opt_state, batches, mesh.device, toks,
                                           echo=rank == 0)
    if checkpoint_dir:
        from llm_np_cp_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(checkpoint_dir, {"params": local, "opt_state": opt_state, "step": steps},
                        mesh=mesh, config=config)
    return losses


def run(argv: list[str] | None = None, *, tokenizer: Any = None) -> list[float]:
    """Train for --steps steps; returns the per-step losses (each step's
    loss and tok/s also go to stderr).  ``tokenizer``: the caller's, for
    ``--data`` over a checkpoint directory."""
    from llm_np_cp_tpu_torch.parallel.sharding import device_count_error, parse_mesh_spec

    args = build_parser().parse_args(argv)
    args.tokenizer = tokenizer
    device = resolve_device(args.device)
    plan = parse_mesh_spec(args.mesh)
    tokenizer, params, config = _resolve_model(args)

    multi = plan.num_devices > 1
    if multi:
        plan.validate(config)
        check_train_plan(plan, config)
        if args.batch % max(plan.data, 1):
            raise SystemExit(
                f"--batch {args.batch} not divisible by data={plan.data}"
            )
        err = device_count_error(plan, None if device.type == "cuda" else "cpu", None)
        if err:
            raise ValueError(err)
    if plan.pipe > 1 and args.batch % args.microbatches:
        raise SystemExit(
            f"--batch {args.batch} not divisible by "
            f"--microbatches {args.microbatches}"
        )

    gen = _batches(args, tokenizer, config.vocab_size)
    batches = [next(gen) for _ in range(args.steps)]
    toks = args.batch * (args.seq_len - 1)
    if multi:
        from llm_np_cp_tpu_torch.parallel.launch import run_ranks

        host = tree_map(lambda t: t.cpu(), params)
        del params
        losses = run_ranks(_train_rank, plan.num_devices, plan, device.type == "cuda", host,
                           config, batches, args.lr, args.microbatches, toks,
                           args.checkpoint_dir, args.steps,
                           backend="nccl" if device.type == "cuda" else "gloo")[0]
    else:
        opt = default_optimizer(args.lr)
        opt_state = opt.init(params)
        step = make_train_step(config, opt, device=device)
        losses, params, opt_state = _train_loop(step, params, opt_state, batches, device, toks,
                                                echo=True)
        if args.checkpoint_dir:
            from llm_np_cp_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint_dir,
                            {"params": params, "opt_state": opt_state, "step": args.steps})
    if args.checkpoint_dir:
        print(f"saved checkpoint to {args.checkpoint_dir}", file=sys.stderr)
    return losses


if __name__ == "__main__":
    run()

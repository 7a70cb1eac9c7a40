"""Rank bodies of the mesh tests (``test_torch_sharding.py``,
``test_torch_ring_attention.py``, ``test_torch_serve_sharded.py``'s
``serve_case``, ``test_torch_cli.py``'s ``cli_in_rank``, and the
training tests' gradient, pipeline and checkpoint cases), and
``np_params``, the numpy weights those tests carry into both packages.

A spawned rank imports the module of the function it runs, so the rank
side lives here and imports torch, numpy and the port only — no JAX.
``run_cases(rank, cases)`` runs every case of one spawned group in
order and returns ``{name: result}`` (numpy arrays and Python values):
one spawn of ranks serves a whole test module at one world size.

A case is ``(name, kind, kwargs)``; each kind below builds its own mesh
(``make_mesh`` over the group, on the CPU) and returns what every rank
sees, whole-batch and whole-vocab: a data-parallel forward's rows and a
tensor-parallel cache's heads are all-gathered here, so the parent
compares one array with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def np_params(cfg, seed, scale=0.15):
    """Random float32 weights as numpy, in the layout both packages
    share (norm gammas near their identity)."""
    from llm_np_cp_tpu_torch.models.transformer import param_shapes

    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            base = 0.0 if cfg.rms_norm_unit_offset else 1.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
        for k, v in param_shapes(cfg).items()
    }


def _mesh(plan_kw: dict):
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, make_mesh

    return make_mesh(MeshPlan(**plan_kw), device="cpu")


def _rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows of ``t`` (its data block)."""
    from llm_np_cp_tpu_torch.parallel.sharding import DATA_AXIS

    dp = mesh.size(DATA_AXIS)
    n = t.shape[0] // dp
    return t[mesh.index(DATA_AXIS) * n:(mesh.index(DATA_AXIS) + 1) * n]


def _all_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``t`` (batch along ``dim``)."""
    from llm_np_cp_tpu_torch.parallel.collectives import all_gather
    from llm_np_cp_tpu_torch.parallel.sharding import DATA_AXIS

    return all_gather(t, mesh, DATA_AXIS, dim=dim)


def forward_case(mesh, params, cfg, ids, attn_impl="xla", quantize=None):
    """Cache-less forward logits over the whole batch (``quantize``:
    ``quantize_params`` keywords for the weights first)."""
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params
    from llm_np_cp_tpu_torch.quant import quantize_params

    if quantize is not None:
        params = quantize_params(params, **quantize)
    p = shard_params(params, cfg, mesh.plan, mesh)
    logits, _ = forward(p, _rows(mesh, torch.as_tensor(ids)), cfg, attn_impl=attn_impl,
                        mesh=mesh)
    return _all_rows(mesh, logits).numpy()


def cached_case(mesh, params, cfg, ids, steps, capacity, attn_impl="xla"):
    """Prefill ``ids`` into a fresh cache (``attn_impl``), then one
    forward a token of ``steps`` ``[B, n]``: every call's logits, and the
    cache's K/V after the prefill with the KV heads all-gathered over
    "model"."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.parallel.collectives import all_gather
    from llm_np_cp_tpu_torch.parallel.sharding import (
        MODEL_AXIS,
        kv_heads_shardable,
        local_kv_heads,
        shard_params,
    )

    p = shard_params(params, cfg, mesh.plan, mesh)
    ids = _rows(mesh, torch.as_tensor(ids))
    cache = KVCache.init(cfg, ids.shape[0], capacity, torch.float32, device="cpu",
                         kv_heads=local_kv_heads(cfg, mesh))
    logits, cache = forward(p, ids, cfg, cache, attn_impl=attn_impl, mesh=mesh)
    out = [logits]
    k, v = cache.k.clone(), cache.v.clone()
    if kv_heads_shardable(cfg, mesh.plan):
        k = all_gather(k, mesh, MODEL_AXIS, dim=3)
        v = all_gather(v, mesh, MODEL_AXIS, dim=3)
    for t in _rows(mesh, torch.as_tensor(steps)).T:
        logits, cache = forward(p, t[:, None], cfg, cache, mesh=mesh)
        out.append(logits)
    return dict(logits=[_all_rows(mesh, o).numpy() for o in out],
                k=_all_rows(mesh, k, dim=1).numpy(), v=_all_rows(mesh, v, dim=1).numpy(),
                length=cache.length)


def generate_case(mesh, params, cfg, prompts, new_tokens, sampler_kw, seed=0,
                  prefill_attn_impl="xla", decode_attn_impl="xla", quantize=None):
    """``Generator(mesh=)`` tokens for the whole batch (every rank's
    return value is the whole batch's), with the step counts."""
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params
    from llm_np_cp_tpu_torch.quant import quantize_params

    if quantize is not None:
        params = quantize_params(params, **quantize)
    gen = Generator(shard_params(params, cfg, mesh.plan, mesh), cfg,
                    sampler=Sampler(**sampler_kw), cache_dtype=torch.float32,
                    prefill_attn_impl=prefill_attn_impl, decode_attn_impl=decode_attn_impl,
                    device="cpu", mesh=mesh)
    res = gen.generate(np.asarray(prompts), new_tokens, seed=seed)
    return dict(tokens=res.tokens, counts=gen.compile_counts(),
                epilogue=gen.epilogue_impl)


def ring_case(mesh, q, k, v, **kw):
    """``ring_attention`` on global tensors."""
    from llm_np_cp_tpu_torch.parallel.ring_attention import ring_attention

    return ring_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          mesh=mesh, **kw).numpy()


# FakeTokenizer.decode: token id t is the character BASE + t
BASE = 0x4E00


class FakeTokenizer:
    """The CLI tests' tokenizer (the JAX CLI tests' encode and EOS, a
    lossless decode: one character a token id), importable by a rank."""

    eos_token_id = 199

    def __call__(self, text, return_tensors=None):
        ids = [(ord(c) % 250) + 1 for c in text][:8]
        return {"input_ids": np.asarray([ids], dtype=np.int32)}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(BASE + int(i)) for i in ids)


def cli_in_rank(rank: int, argvs: list[list[str]], params, cfg) -> list[tuple[str, str]]:
    """``cli.run(argv)`` of each of ``argvs`` in turn inside a rank of a
    running process group (as under torchrun: ``WORLD_SIZE`` set), over
    these weights: each run's returned text and what it wrote to
    stderr."""
    import contextlib
    import io
    import os

    from llm_np_cp_tpu_torch import cli

    os.environ["WORLD_SIZE"] = "set by the test's rank"
    cli._load = lambda args: (FakeTokenizer(), params, cfg)
    out = []
    for argv in argvs:
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            text = cli.run(argv)
        out.append((text, err.getvalue()))
    return out


def _serve_tokens(engines) -> dict:
    return {r.req_id: list(r.generated) for e in engines for r in e.scheduler.finished}


def serve_case(plan, params, cfg, engine_kw, trace=None, prompts=None, max_new=6,
               script="trace", diverge_rank=None):
    """A tensor-parallel ``ServeEngine(mesh_plan=plan)`` on this rank over
    the full numpy ``params`` (each rank cuts its own shards), on a
    ``TickClock``, and what it did: every finished request's tokens, the
    pool's stats and page shapes, ``mesh_desc``, ``compile_counts``, the
    graph captures, the collective counts and the block tables of the
    last dispatch.  ``script``: ``"trace"`` replays ``trace``;
    ``"submit"`` submits ``prompts`` (seed = index) and runs them out;
    ``"abort_recover"`` warms the engine, submits ``prompts``, ticks once,
    aborts request 1, ticks again, then rebuilds (``clone_fresh``) and
    recovers the survivors with their tokens so far; ``"diverge"``: as
    ``"submit"``, but rank ``diverge_rank`` submits its first prompt one
    token longer (what the tick digest must catch, as a message);
    ``"refusals"``: the messages of the calls a multi-rank engine refuses
    (a deadline, ``recover(deadline_at=)``, a realtime replay)."""
    import torch

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.convert import params_from_jax
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine
    from tick_clock import clocked

    kw = dict(engine_kw)
    kw["cache_dtype"] = getattr(torch, kw.pop("cache_dtype", "float32"))
    sampler = Sampler(**kw.pop("sampler", {"kind": "greedy"}))
    before = dict(graphs.TOTALS)
    eng = clocked(ServeEngine, params_from_jax(params, device="cpu"), cfg, sampler=sampler,
                  mesh_plan=plan, device="cpu", **kw)
    out = {}
    engines = [eng]
    if script == "trace":
        out["snapshot"] = eng.replay_trace(trace)
    elif script in ("submit", "diverge"):
        for j, p in enumerate(prompts):
            if script == "diverge" and j == 0 and torch.distributed.get_rank() == diverge_rank:
                p = list(p) + [1]
            eng.submit(p, max_new, seed=j)
        try:
            eng.run_until_complete()
        except RuntimeError as e:
            out["error"] = str(e)
    elif script == "abort_recover":
        eng.warmup([len(p) for p in prompts], max_new_tokens=max_new)
        live = [eng.submit(p, max_new, seed=j) for j, p in enumerate(prompts)]
        eng.step()
        out["aborted"] = eng.abort(live[1].req_id)
        eng.step()
        rebuilt = eng.clone_fresh()
        for r in (live[0], live[2]):
            if r.req_id in eng._requests:
                rebuilt.recover(r.prompt, r.max_new_tokens, request_id=r.req_id, seed=r.seed,
                                generated=list(r.generated))
        rebuilt.run_until_complete()
        engines.append(rebuilt)
        out["rebuilt_stats"] = rebuilt.pool.stats()
        out["rebuilt_desc"] = rebuilt.mesh_desc
    elif script == "refusals":
        calls = {
            "deadline_s": lambda: eng.submit(prompts[0], max_new, deadline_s=1.0),
            "deadline_at": lambda: eng.recover(prompts[0], max_new, request_id=7,
                                               deadline_at=1.0),
            "realtime": lambda: eng.replay_trace([], realtime=True),
        }
        out["refused"] = {}
        for what, call in calls.items():
            try:
                call()
            except NotImplementedError as e:
                out["refused"][what] = str(e)
    last = engines[-1]
    out.update(
        tokens=_serve_tokens(engines), stats=eng.pool.stats() if last is eng else None,
        shard_stats=last.pool.shard_stats(), mesh_desc=last.mesh_desc,
        counts=last.compile_counts(), mixed=last.mixed, epilogue=last.epilogue_impl,
        page_shapes=[None if a is None else tuple(a.shape) for a in last.pool.pages],
        captures=graphs.TOTALS["captures"] - before["captures"],
        eager_steps=[run.eager for run in last.graph_steps()],
        buckets=list(last.mixed_buckets), ticks=last._ticks,
    )
    return out


def serve_bench_in_rank(rank: int | None, argv: list[str], params, cfg) -> tuple[str, dict]:
    """``cli.run(argv)`` of a ``serve-bench`` inside a rank of a running
    process group (``WORLD_SIZE`` set; ``rank=None``: in this process,
    no group) over these weights: what it printed and every served
    request's tokens (the engines it built are recorded)."""
    import contextlib
    import io
    import os

    from llm_np_cp_tpu_torch import cli, serve

    built = []
    engine_cls = serve.ServeEngine

    def record(*a, **kw):
        built.append(engine_cls(*a, **kw))
        return built[-1]

    if rank is not None:
        os.environ["WORLD_SIZE"] = "set by the test's rank"
    load, cli._load = cli._load, lambda args: (None, params, cfg)
    serve.ServeEngine = record
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.run(argv)
    finally:
        serve.ServeEngine = engine_cls
        cli._load = load
    return out.getvalue(), _serve_tokens(built)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def train_grads_case(mesh, params, cfg, batch, loss_mask=None, microbatches=None):
    """The loss and the whole gradient on this rank: ``causal_lm_loss``
    (or, with ``microbatches``, the pipelined loss) over this rank's
    shards of the float32 ``params``, its gradients gathered over the
    mesh (``gather_shards``)."""
    from llm_np_cp_tpu_torch import train
    from llm_np_cp_tpu_torch.parallel.pipeline import make_pp_loss_fn
    from llm_np_cp_tpu_torch.parallel.sharding import gather_shards, shard_params

    local = shard_params(params, cfg, mesh.plan, mesh)
    if microbatches:
        pp_loss = make_pp_loss_fn(cfg, mesh.plan, mesh, num_microbatches=microbatches)

        def loss_fn(p, b):
            return pp_loss(p, b, loss_mask)
    else:
        def loss_fn(p, b):
            return train.causal_lm_loss(p, b, cfg, loss_mask=loss_mask, mesh=mesh)

    loss, grads = train.loss_and_grads(loss_fn, local, batch, mesh=mesh)
    return dict(loss=float(loss), grads=_numpy_tree(gather_shards(grads, cfg, mesh)),
                norm=float(train.global_norm(grads, mesh, cfg)))


def pp_forward_case(mesh, params, cfg, ids, microbatches):
    """``pp_forward`` logits over the whole batch."""
    from llm_np_cp_tpu_torch.parallel.pipeline import pp_forward
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params

    local = shard_params(params, cfg, mesh.plan, mesh)
    logits = pp_forward(local, _rows(mesh, torch.as_tensor(ids)), cfg, mesh.plan, mesh,
                        num_microbatches=microbatches)
    return _all_rows(mesh, logits).numpy()


def train_steps_case(mesh, params, cfg, batch, steps, lr, microbatches=None):
    """``steps`` train steps on this rank's shards (``make_train_step``,
    or the pipelined step with ``microbatches``): every step's loss."""
    from llm_np_cp_tpu_torch import train
    from llm_np_cp_tpu_torch.parallel.pipeline import make_pp_train_step
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params

    local = train.tree_map(torch.clone, shard_params(params, cfg, mesh.plan, mesh))
    opt = train.default_optimizer(lr)
    state = opt.init(local)
    if microbatches:
        step = make_pp_train_step(cfg, opt, mesh.plan, mesh, num_microbatches=microbatches)
    else:
        step = train.make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for _ in range(steps):
        local, state, loss = step(local, state, batch)
        losses.append(float(loss))
    return losses


def checkpoint_case(mesh, cfg, state_dir, out_dir):
    """Restore the single-rank checkpoint at ``state_dir`` onto this
    rank's shards (``like=`` a state of its shapes), then save it under
    the mesh to ``out_dir``: this rank's restored shards as numpy."""
    from llm_np_cp_tpu_torch import train
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params
    from llm_np_cp_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    fresh = shard_params(init_params(0, cfg, torch.float32, device="cpu"), cfg, mesh.plan, mesh)
    like = {"params": fresh, "opt_state": train.default_optimizer(1e-2).init(fresh), "step": 0}
    state = restore_checkpoint(state_dir, like=like, mesh=mesh, config=cfg)
    save_checkpoint(out_dir, state, mesh=mesh, config=cfg)
    return dict(params=_numpy_tree(state["params"]), mu=_numpy_tree(state["opt_state"]["mu"]),
                count=state["opt_state"]["count"], step=state["step"])


KINDS = {"forward": forward_case, "cached": cached_case, "generate": generate_case,
         "ring": ring_case, "serve": serve_case, "train_grads": train_grads_case,
         "pp_forward": pp_forward_case, "checkpoint": checkpoint_case,
         "train_steps": train_steps_case}
# kinds that take the plan (and build their own mesh) rather than a mesh
PLAN_KINDS = {"serve"}


def run_cases(rank: int, cases: list[tuple[str, str, dict]]) -> dict:
    """Every case in order on this rank: ``{name: result}``, with the
    collective counts each case issued under ``name + "/collectives"``."""
    from llm_np_cp_tpu_torch.parallel import collectives
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan

    out = {}
    for name, kind, kw in cases:
        kw = dict(kw)
        plan = kw.pop("plan")
        mesh = MeshPlan(**plan) if kind in PLAN_KINDS else _mesh(plan)
        collectives.reset_counts()
        out[name] = KINDS[kind](mesh, **kw)
        out[name + "/collectives"] = collectives.counts()
    return out

"""The port's GPipe pipeline (``llm_np_cp_tpu_torch.parallel.pipeline``)
against the JAX package's (``tests/test_pipeline.py``), on the CPU in
float32, on the same numpy-made weights.  The pipeline is a schedule,
not a model change: its forward equals the plain forward, and its loss
and gradients equal JAX's ``make_pp_loss_fn``.

The ranks are spawned gloo groups, once per world size for this module
(8: ``data=2,pipe=2,model=2`` and ``pipe=4,model=2``; 2: the MoE stages),
each running every case of its world (``mesh_ranks.run_cases``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import train as jtrain
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.parallel import pipeline as jpp
from llm_np_cp_tpu.parallel import sharding as jsh
from llm_np_cp_tpu_torch import train
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from llm_np_cp_tpu_torch.parallel.pipeline import pp_forward
from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan
from mesh_ranks import np_params, run_cases


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(model_type="llama", **kw):
    """``tests/test_pipeline.py``'s config (4 layers; tied embedding)."""
    return tiny_config(model_type, num_hidden_layers=4, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=8, hidden_size=32, intermediate_size=64,
                       **kw)


def moe_small():
    return small(num_local_experts=4, num_experts_per_tok=2)


def jcfg_of(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def ids(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# name → (config, plan, weights seed, case kind, its inputs)
FORWARD = {m: (lambda m=m: small(m), dict(data=2, model=2, pipe=2), 0) for m in
           ("llama", "gemma2")}
GRADS = (small, dict(pipe=4, model=2), 1, 4)  # make_pp_loss_fn over 4 microbatches
STEPS = (small, dict(data=2, pipe=2, model=2), 2, 2)  # make_pp_train_step, 2 microbatches
TRAIN_STEPS, TRAIN_LR = 5, 1e-2
MOE = {"moe_m1": 1, "moe_m2": 2}  # pipe=2 over 1 and 2 microbatches


def _tparams(cfg, seed):
    return params_from_jax(np_params(cfg, seed), device="cpu")


@pytest.fixture(scope="module")
def world8():
    cases = []
    for m, (make, plan, seed) in FORWARD.items():
        cfg = make()
        cases.append((f"fwd_{m}", "pp_forward", dict(
            plan=plan, params=_tparams(cfg, seed), cfg=cfg, ids=ids(cfg, (4, 12), 0),
            microbatches=2)))
    make, plan, seed, m = GRADS
    cfg = make()
    cases.append(("grads", "train_grads", dict(plan=plan, params=_tparams(cfg, seed), cfg=cfg,
                                               batch=ids(cfg, (4, 16), 1), microbatches=m)))
    make, plan, seed, m = STEPS
    cfg = make()
    cases.append(("steps", "train_steps", dict(
        plan=plan, params=_tparams(cfg, seed), cfg=cfg, batch=ids(cfg, (4, 16), 2),
        steps=TRAIN_STEPS, lr=TRAIN_LR, microbatches=m)))
    return run_ranks(run_cases, 8, cases)


@pytest.fixture(scope="module")
def world2():
    cfg = moe_small()
    cases = [(name, "train_grads", dict(plan=dict(pipe=2), params=_tparams(cfg, 7), cfg=cfg,
                                        batch=ids(cfg, (2, 16), 7), microbatches=m))
             for name, m in MOE.items()]
    return run_ranks(run_cases, 2, cases)


@pytest.mark.parametrize("model_type", list(FORWARD))
def test_pp_forward_matches_plain(world8, model_type):
    make, _, seed = FORWARD[model_type]
    cfg = make()
    ref, _ = jtf.forward(jax.tree.map(jnp.asarray, np_params(cfg, seed)),
                         jnp.asarray(ids(cfg, (4, 12), 0)), jcfg_of(cfg), None)
    for r in world8:
        np.testing.assert_allclose(r[f"fwd_{model_type}"], np.asarray(ref), atol=2e-4)


def test_pp_loss_and_grads_match_jax(world8):
    """PP over 4 stages x model 2, a tied embedding: the loss and every
    gathered gradient equal JAX's ``make_pp_loss_fn`` (rtol 1e-5, atol
    1e-4), on every rank; every rank issued the same collectives."""
    make, plan_kw, seed, m = GRADS
    cfg = make()
    assert cfg.tie_word_embeddings
    plan = jsh.MeshPlan(**plan_kw)
    mesh = jsh.make_mesh(plan)
    jp = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    batch = jnp.asarray(ids(cfg, (4, 16), 1))
    loss_fn = jpp.make_pp_loss_fn(jcfg_of(cfg), plan, mesh, num_microbatches=m)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jsh.shard_params(jp, jcfg_of(cfg), plan, mesh), batch)
    want = {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want_grads)}
    for r in world8:
        np.testing.assert_allclose(r["grads"]["loss"], float(want_loss), rtol=1e-5)
        got = dict(train.tree_leaves(r["grads"]["grads"]))
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-4,
                                       err_msg=str(path))
    counts = [r["grads/collectives"] for r in world8]
    assert all(c == counts[0] for c in counts), counts
    # 4 microbatches over 4 stages: 7 steps, 6 shifts forward and 6 back
    assert counts[0]["ppermute"]["calls"] == 12


def test_pp_train_step_runs_and_improves(world8):
    """``make_pp_train_step`` over data 2 x pipe 2 x model 2: every rank's
    losses equal, falling, and within 2e-4 of the JAX package's pipelined
    step on the same weights and batch."""
    make, plan_kw, seed, m = STEPS
    cfg = make()
    losses = [r["steps"] for r in world8]
    assert all(x == losses[0] for x in losses)
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]
    plan = jsh.MeshPlan(**plan_kw)
    mesh = jsh.make_mesh(plan)
    params = jsh.shard_params(jax.tree.map(jnp.asarray, np_params(cfg, seed)), jcfg_of(cfg),
                              plan, mesh)
    opt = jtrain.default_optimizer(TRAIN_LR)
    opt_state = opt.init(params)
    step = jpp.make_pp_train_step(jcfg_of(cfg), opt, plan, mesh, num_microbatches=m)
    batch = jax.device_put(jnp.asarray(ids(cfg, (4, 16), 2)),
                           jsh.to_shardings(mesh, jsh.batch_spec(plan)))
    want = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        want.append(float(loss))
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)


@pytest.mark.parametrize("name", list(MOE))
def test_pp_moe_loss_includes_router_aux(world2, name):
    """A MoE config over 2 stages: the loss includes the router aux loss
    averaged over (layer, microbatch) pairs, and it and every gradient
    equal JAX's pipelined ones; with one microbatch the loss is the
    full-batch ``causal_lm_loss`` (``tests/test_pipeline.py``'s
    relation)."""
    cfg, m = moe_small(), MOE[name]
    jcfg = jcfg_of(cfg)
    jp = jax.tree.map(jnp.asarray, np_params(cfg, 7))
    batch = jnp.asarray(ids(cfg, (2, 16), 7))
    plan = jsh.MeshPlan(pipe=2)
    mesh = jsh.make_mesh(plan)
    loss_fn = jpp.make_pp_loss_fn(jcfg, plan, mesh, num_microbatches=m)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jsh.shard_params(jp, jcfg, plan, mesh), batch)
    if m == 1:
        np.testing.assert_allclose(float(want_loss),
                                   float(jtrain.causal_lm_loss(jp, batch, jcfg)), rtol=1e-5)
    for r in world2:
        np.testing.assert_allclose(r[name]["loss"], float(want_loss), rtol=1e-5)
        got = dict(train.tree_leaves(r[name]["grads"]))
        for path, v in jax.tree_util.tree_leaves_with_path(want_grads):
            np.testing.assert_allclose(got[tuple(k.key for k in path)], np.asarray(v),
                                       rtol=1e-5, atol=1e-4, err_msg=str(path))


def test_pp_validates_divisibility():
    plan = MeshPlan(pipe=3)
    cfg = tiny_config("llama", num_hidden_layers=4)
    with pytest.raises(ValueError, match="not divisible"):
        plan.validate(cfg)
    with pytest.raises(ValueError, match="num_hidden_layers=4 not divisible by pipe=3"):
        pp_forward({}, np.zeros((4, 8), np.int32), cfg, plan, None, num_microbatches=2)
    with pytest.raises(ValueError, match="batch 4 not divisible by microbatches 3"):
        pp_forward({}, np.zeros((4, 8), np.int32), cfg, MeshPlan(pipe=2), None,
                   num_microbatches=3)

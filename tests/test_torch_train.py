"""The port's training path (``llm_np_cp_tpu_torch.train``) against the
JAX package's ``llm_np_cp_tpu.train``, on the CPU in float32, on the same
numpy-made weights (``mesh_ranks.np_params``, carried across with
``convert.params_from_jax``).

- ``causal_lm_loss`` and its gradients against
  ``jax.value_and_grad(causal_lm_loss)`` for tiny llama, gemma2 and a MoE
  config, plain and under a ``loss_mask``: loss rtol 1e-5, every leaf's
  gradient atol 1e-5;
- ``AdamW`` against ``optax.chain(clip_by_global_norm(1.0), adamw(lr))``
  on the same gradients, and three ``make_train_step`` steps against the
  JAX package's, with a global norm above 1 at one step and below 1 at
  another (the clip taken both ways);
- the gradients under a mesh (spawned gloo ranks, once per world size
  for this module; ``mesh_ranks.run_cases``): data 2 x model 2 plain and
  masked, model 4 over Gemma-2's replicated KV heads, each gathered leaf
  and the clip's global norm equal to the single-device JAX ones;
- the command line on both packages over the same weights (both
  ``_resolve_model``s replaced), single-rank and over a mesh, and the
  JAX CLI tests' own cases (``tests/test_train_cli.py``);
- the refusals: a "seq" axis, an "expert" axis, a missing card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import train as jtrain
from llm_np_cp_tpu_torch import train
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from mesh_ranks import np_params, run_cases


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
MESH_RTOL = 2e-4  # tests/test_train_cli.py's


def jcfg_of(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def pair(cfg, seed, scale=0.15):
    npp = np_params(cfg, seed, scale)
    return npp, params_from_jax(npp, device="cpu"), jax.tree.map(jnp.asarray, npp)


def by_path(jtree) -> dict:
    """A JAX tree's leaves keyed by their dict path (the port's
    ``tree_leaves`` paths)."""
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}


def assert_tree_close(got, want, atol, what=""):
    want = by_path(want)
    got = {path: (t.detach().numpy() if isinstance(t, torch.Tensor) else t)
           for path, t in train.tree_leaves(got)}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol,
                                   err_msg=f"{what} {'.'.join(path)}")


def ids(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


CONFIGS = {
    "llama": lambda: tiny_config("llama"),
    "gemma2": lambda: tiny_config("gemma2"),
    "tiny_moe": lambda: tiny_config("llama", num_local_experts=4, num_experts_per_tok=2),
}


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss_mask"])
@pytest.mark.parametrize("model", list(CONFIGS))
def test_loss_and_grads_match_jax(model, masked):
    cfg = CONFIGS[model]()
    _, tp, jp = pair(cfg, 0)
    batch = ids(cfg, (2, 12), 1)
    mask = ((np.random.default_rng(2).random((2, 11)) > 0.3).astype(np.float32)
            if masked else None)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.causal_lm_loss(p, jnp.asarray(batch), jcfg_of(cfg),
                                        loss_mask=None if mask is None else jnp.asarray(mask))
    ))(jp)
    loss, grads = train.loss_and_grads(
        lambda p, b: train.causal_lm_loss(p, b, cfg, loss_mask=mask, device="cpu"), tp, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert_tree_close(grads, want_grads, GRAD_ATOL, model)
    # the params come back as they went in: no gradient kept, none required
    assert all(not t.requires_grad and t.grad is None for _, t in train.tree_leaves(tp))


def _adam_state(js):
    return js[1][0]  # chain(clip, adamw): adamw's chain(scale_by_adam, ...)


def test_adamw_matches_optax_on_the_same_gradients():
    """The optimizer alone: the same gradients into both, three updates
    whose global norms are above 1, below 1 and above 1."""
    cfg = tiny_config("llama")
    npp, tp, jp = pair(cfg, 0)
    jopt, opt = jtrain.default_optimizer(1e-2), train.default_optimizer(1e-2)
    js, ts = jopt.init(jp), opt.init(tp)
    rng = np.random.default_rng(5)
    norms = []
    for scale in (1e-2, 1e-4, 5e-3):
        g = jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32),
                         npp)
        norms.append(float(optax.global_norm(g)))
        updates, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(params_from_jax(g, device="cpu"), ts, tp)
        assert_tree_close(tp, jp, PARAM_ATOL, "params")
        assert_tree_close(ts["mu"], _adam_state(js).mu, 1e-9, "mu")
        assert_tree_close(ts["nu"], _adam_state(js).nu, 1e-12, "nu")
        assert ts["count"] == int(_adam_state(js).count)
    assert norms[0] > 1 > norms[1] and norms[2] > 1, norms


def test_clip_has_no_epsilon():
    """A gradient of global norm exactly 2 is halved exactly (torch's
    ``clip_grad_norm_`` divides by norm + 1e-6)."""
    opt = train.default_optimizer(1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 1.0)}  # norm 2
    state = opt.init(p)
    opt.update(g, state, p)
    assert torch.equal(g["w"], torch.full((4,), 0.5))
    np.testing.assert_allclose(state["mu"]["w"].numpy(), 0.1 * 0.5)


def test_three_train_steps_match_jax():
    """Three ``make_train_step`` steps against the JAX package's: the
    losses within rtol 1e-5, the global norm above 1 at steps 1 and 3 and
    below 1 at step 2 (a larger batch), and the params within 1e-5.

    Adam's step lr · mu_hat / (sqrt(nu_hat) + eps) does not depend on the
    gradient's scale, so where a gradient is tiny (sqrt(nu_hat) near eps
    = 1e-8) the float32 difference between the two packages' gradients
    (a few 1e-9: their backward passes sum in other orders) moves the
    step by up to ~4e-5 at lr 1e-2.  Such elements, at most 0.1 % of a
    leaf (under 0.02 % here), are held to Adam's own bound, lr · (1 + wd)
    a step; every other element to 1e-5."""
    cfg = tiny_config("llama")
    _, tp, jp = pair(cfg, 0, scale=0.02)
    jcfg, lr = jcfg_of(cfg), 1e-2
    jopt, opt = jtrain.default_optimizer(lr), train.default_optimizer(lr)
    js, ts = jopt.init(jp), opt.init(tp)
    jstep, step = jtrain.make_train_step(jcfg, jopt), train.make_train_step(cfg, opt,
                                                                            device="cpu")
    rng = np.random.default_rng(3)
    norms = []
    for i, shape in enumerate([(2, 12), (16, 64), (2, 12)]):
        batch = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        g = jax.jit(jax.grad(lambda p: jtrain.causal_lm_loss(p, jnp.asarray(batch), jcfg)))(jp)
        norms.append(float(optax.global_norm(g)))
        jp, js, want = jstep(jp, js, jnp.asarray(batch))
        tp, ts, loss = step(tp, ts, batch)
        np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
        assert ts["count"] == int(_adam_state(js).count) == i + 1
        got = dict(train.tree_leaves(tp))
        for path, want_p in by_path(jp).items():
            diff = np.abs(got[path].numpy() - want_p)
            assert (diff > PARAM_ATOL).mean() <= 1e-3, (i, path, (diff > PARAM_ATOL).mean())
            assert diff.max() <= (i + 1) * lr * (1 + 1e-4), (i, path, diff.max())
    assert norms[0] > 1 > norms[1] and norms[2] > 1, norms


# ----------------------------------------------------------------------
# Gradients under a mesh (spawned gloo ranks)
# ----------------------------------------------------------------------

def shardable(model_type="llama"):
    return tiny_config(model_type, num_attention_heads=8, num_key_value_heads=4, head_dim=8,
                       hidden_size=64)


def gemma_replicated_kv():
    """Gemma-2's 2 KV heads under model=4: every rank projects both and
    attends with the one its query heads group onto."""
    return tiny_config("gemma2", num_attention_heads=8, num_key_value_heads=2, head_dim=8)


MESH_CASES = {
    "dp2_tp2": (shardable, dict(data=2, model=2), False),
    "dp2_tp2_mask": (shardable, dict(data=2, model=2), True),
    "dp4": (shardable, dict(data=4), False),
    "tp4_gemma_replicated_kv": (gemma_replicated_kv, dict(model=4), False),
}


def _mesh_inputs(name):
    make_cfg, plan, masked = MESH_CASES[name]
    cfg = make_cfg()
    npp = np_params(cfg, 11)
    batch = ids(cfg, (4, 16), 12)
    mask = (np.random.default_rng(13).random((4, 15)) > 0.3).astype(np.float32) \
        if masked else None
    return cfg, plan, npp, batch, mask


@pytest.fixture(scope="module")
def world4():
    cases = []
    for name in MESH_CASES:
        cfg, plan, npp, batch, mask = _mesh_inputs(name)
        cases.append((name, "train_grads", dict(plan=plan, params=params_from_jax(
            npp, device="cpu"), cfg=cfg, batch=batch, loss_mask=mask)))
    return run_ranks(run_cases, 4, cases)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_grads_match_single_device_jax(world4, name):
    """Every rank's loss is the global one, and its gradient (gathered
    over the mesh) and global norm equal the single-device JAX ones."""
    cfg, _, npp, batch, mask = _mesh_inputs(name)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.causal_lm_loss(p, jnp.asarray(batch), jcfg_of(cfg),
                                        loss_mask=None if mask is None else jnp.asarray(mask))
    ))(jax.tree.map(jnp.asarray, npp))
    for r in world4:
        np.testing.assert_allclose(r[name]["loss"], float(want_loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[name]["norm"], float(optax.global_norm(want_grads)),
                                   rtol=LOSS_RTOL)
    assert_tree_close(params_from_jax(world4[0][name]["grads"], device="cpu"), want_grads,
                      GRAD_ATOL, name)


def test_mesh_training_collectives(world4):
    """What a training step's loss and gradients issue under data 2 x
    model 2, from the plan alone: the forward's own all-reduces (the
    embedding's and two a layer, as inference issues them), one a
    ``copy_to`` in the backward (the q/k/v and MLP inputs of each layer
    and the head's input), the loss value over "data", the clip's
    squared norm over "model", and each gradient's mean over "data";
    all-gathers: the forward's logits, then ``gather_shards`` one a leaf
    cut over "model"."""
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, param_specs

    cfg = shardable()
    layers = cfg.num_hidden_layers
    specs = train.tree_leaves(param_specs(cfg, MeshPlan(data=2, model=2)))
    cut = sum("model" in spec for _, spec in specs)
    c = world4[0]["dp2_tp2/collectives"]
    assert c["all_reduce"]["calls"] == (1 + 2 * layers) + (2 * layers + 1) + 1 + 1 + len(specs), c
    assert c["all_gather"]["calls"] == 1 + cut, c
    assert c["ppermute"]["calls"] == 0, c


# ----------------------------------------------------------------------
# The command line
# ----------------------------------------------------------------------

def _patch_models(monkeypatch, cfg, npp):
    jcfg = jcfg_of(cfg)
    monkeypatch.setattr(jtrain, "_resolve_model",
                        lambda args: (None, jax.tree.map(jnp.asarray, npp), jcfg))
    monkeypatch.setattr(train, "_resolve_model",
                        lambda args: (None, params_from_jax(npp, device="cpu"), cfg))


CLI_CASES = {
    "single": ([], LOSS_RTOL),
    "data2_model2": (["--mesh=data=2,model=2"], MESH_RTOL),
    "data2_pipe2_model2": (["--mesh=data=2,pipe=2,model=2", "--microbatches=2"], MESH_RTOL),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_losses_match_jax(monkeypatch, case):
    """Both CLIs over the same weights: the same losses, one rank or a
    mesh (the port spawns the plan's gloo ranks)."""
    extra, rtol = CLI_CASES[case]
    cfg = tiny_config("llama", num_hidden_layers=4)
    _patch_models(monkeypatch, cfg, np_params(cfg, 7, scale=0.02))
    common = ["--steps=3", "--batch=4", "--seq-len=32", "--lr=1e-2", "--seed=1"]
    want = jtrain.run(common + extra)
    got = train.run(common + extra + ["--device=cpu"])
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_train_single_device_loss_decreases():
    losses = train.run(["--model=tiny", "--steps=8", "--batch=4", "--seq-len=32",
                        "--lr=1e-2", "--seed=0", "--device=cpu"])
    assert len(losses) == 8
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_train_checkpoint_roundtrip(tmp_path):
    from llm_np_cp_tpu_torch.utils.checkpoint import restore_checkpoint

    train.run(["--model=tiny", "--steps=2", "--batch=2", "--seq-len=16", "--device=cpu",
               f"--checkpoint-dir={tmp_path / 'ck'}"])
    state = restore_checkpoint(tmp_path / "ck")
    assert state["step"] == 2
    assert state["opt_state"]["count"] == 2
    assert "embed_tokens" in state["params"]


def test_train_from_checkpoint_dir_and_text(tmp_path):
    """Fine-tune an on-disk HF checkpoint on a text file with the
    caller's tokenizer: load → tokenize → train → save."""
    transformers = pytest.importorskip("transformers")

    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(tmp_path, safe_serialization=True)
    data = tmp_path / "corpus.txt"
    data.write_text("the quick brown fox jumps over the lazy dog " * 50)

    def tokenizer(text):  # bytes as ids, the port's tokenizer protocol
        return {"input_ids": list(text.encode())}

    losses = train.run([f"--model={tmp_path}", f"--data={data}", "--steps=6", "--batch=2",
                        "--seq-len=32", "--lr=1e-2", "--device=cpu"], tokenizer=tokenizer)
    assert losses[-1] < losses[0]
    with pytest.raises(SystemExit, match="--data needs a checkpoint model"):
        train.run(["--model=tiny", f"--data={data}", "--steps=1", "--device=cpu"])


# ----------------------------------------------------------------------
# Refusals
# ----------------------------------------------------------------------

REFUSALS = {
    "seq": (["--model=tiny", "--mesh=seq=2,model=2"], NotImplementedError,
            "'seq' axis .*queue 1 item 10"),
    "expert": (["--model=tiny_moe", "--mesh=data=2,expert=2,model=2"], NotImplementedError,
               "'expert' or 'data' .*queue 1 item 11"),
    "moe_data": (["--model=tiny_moe", "--mesh=data=2"], NotImplementedError,
                 "queue 1 item 11"),
    "moe_model": (["--model=tiny_moe", "--mesh=model=2"], NotImplementedError,
                  "queue 1 item 8c"),
    "expert_dense": (["--model=tiny", "--mesh=data=2,expert=2,model=2"], ValueError,
                     "expert>1 requires a MoE config"),
    "batch_data": (["--model=tiny", "--mesh=data=3", "--batch=4"], SystemExit,
                   "not divisible by data=3"),
    "batch_micro": (["--model=tiny", "--layers=4", "--mesh=pipe=2", "--batch=4",
                     "--microbatches=3"], SystemExit, "not divisible by --microbatches 3"),
    "layers_preset": (["--model=llama1b", "--layers=2"], SystemExit,
                      "--layers applies to the tiny presets only"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_refusals(case):
    argv, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        train.run(argv + ["--steps=1", "--device=cpu"])


@pytest.mark.parametrize("call", ["run", "loss", "step"])
def test_no_card_without_device_cpu_raises(call):
    """The entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tiny_config("llama")
    _, tp, _ = pair(cfg, 0)
    calls = {
        "run": lambda: train.run(["--model=tiny", "--steps=1"]),
        "loss": lambda: train.causal_lm_loss(tp, ids(cfg, (1, 4), 0), cfg),
        "step": lambda: train.make_train_step(cfg, train.default_optimizer()),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[call]()

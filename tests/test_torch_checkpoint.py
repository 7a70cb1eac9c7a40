"""The port's checkpoints (``llm_np_cp_tpu_torch.utils.checkpoint``: a
``torch.save`` file of global arrays, no Orbax) against the JAX
package's checkpoint tests (``tests/test_checkpoint_profiling.py``), on
the CPU.

- a round trip keeps every value and dtype, quantized payloads (int8,
  packed int4, W8A8) and their scales included;
- resuming from a checkpoint gives the same loss as continuing, exactly;
- a write replaces the checkpoint atomically, and a restore checks the
  target's shapes;
- on a mesh (one spawned group of 4 gloo ranks for this module,
  ``mesh_ranks.checkpoint_case``): a restore onto model=4 gives each rank
  the shard JAX's ``shard_params`` places at its coordinate, and the
  state saved under data 2 x model 2 (gathered, written by rank 0)
  equals the single-rank checkpoint it was restored from.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.parallel import sharding as jsh
from llm_np_cp_tpu_torch import train
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.parallel import sharding as tsh
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from llm_np_cp_tpu_torch.quant import quantize_params
from llm_np_cp_tpu_torch.utils.checkpoint import (
    STATE_FILE,
    restore_checkpoint,
    save_checkpoint,
)
from mesh_ranks import np_params, run_cases


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shardable():
    """Dims divisible by model=4 (the JAX checkpoint test's config)."""
    return tiny_config("llama", num_attention_heads=8, num_key_value_heads=4, head_dim=8,
                       hidden_size=64)


def assert_trees_equal(a, b):
    la, lb = train.tree_leaves(a), train.tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_config("llama", num_hidden_layers=2)
    params = params_from_jax(np_params(cfg, 0), device="cpu")
    params["final_norm"] = params["final_norm"].bfloat16()
    save_checkpoint(tmp_path / "ckpt", {"params": params, "step": 7})
    restored = restore_checkpoint(tmp_path / "ckpt")
    assert restored["step"] == 7
    assert_trees_equal(restored["params"], params)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [STATE_FILE]


@pytest.mark.parametrize("kwargs", [dict(bits=8), dict(bits=4), dict(bits=8, act_quant=True),
                                    dict(bits=4, act_quant=True)],
                         ids=["int8", "int4", "int8_a8", "int4_a8"])
def test_quantized_params_checkpoint_roundtrip(tmp_path, kwargs):
    """Quantized trees ({q|qa|q4|q4a, s} leaves) come back with their
    payloads' and scales' dtypes and values: quantize once, serve from
    the checkpoint."""
    cfg = tiny_config("llama")
    q = quantize_params(params_from_jax(np_params(cfg, 3), device="cpu"), **kwargs)
    save_checkpoint(tmp_path / "ck", {"params": q, "step": 7})
    back = restore_checkpoint(tmp_path / "ck")
    assert back["step"] == 7
    assert_trees_equal(back["params"], q)
    dtypes = {t.dtype for _, t in train.tree_leaves(back["params"])}
    assert torch.int8 in dtypes or torch.uint8 in dtypes


def test_checkpoint_resume_training(tmp_path):
    """Save mid-training, restore, continue: the resumed step's loss is
    the continued one's, exactly."""
    cfg = shardable()
    opt = train.default_optimizer(1e-3)
    step = train.make_train_step(cfg, opt, device="cpu")
    batch = np.random.default_rng(0).integers(0, 255, (2, 12)).astype(np.int32)
    params = params_from_jax(np_params(cfg, 0, scale=0.02), device="cpu")
    opt_state = opt.init(params)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, batch)
    save_checkpoint(tmp_path / "mid", {"params": params, "opt_state": opt_state})
    restored = restore_checkpoint(tmp_path / "mid",
                                  like={"params": params, "opt_state": opt_state})
    assert restored["opt_state"]["count"] == 2
    _, _, loss_c = step(params, opt_state, batch)
    _, _, loss_r = step(restored["params"], restored["opt_state"], batch)
    assert float(loss_r) == float(loss_c)


def test_write_replaces_atomically(tmp_path):
    """A second write replaces the first; a write that fails leaves the
    checkpoint that was there, and no temporary file."""
    path = tmp_path / "ck"
    save_checkpoint(path, {"step": 1, "x": torch.zeros(3)})
    save_checkpoint(path, {"step": 2, "x": torch.ones(3)})
    assert restore_checkpoint(path)["step"] == 2
    with pytest.raises(Exception):
        save_checkpoint(path, {"step": 3, "bad": lambda: None})  # not picklable
    back = restore_checkpoint(path)
    assert back["step"] == 2 and torch.equal(back["x"], torch.ones(3))
    assert sorted(p.name for p in path.iterdir()) == [STATE_FILE]


def test_restore_like_checks_shapes_and_casts(tmp_path):
    save_checkpoint(tmp_path / "ck", {"w": torch.arange(6, dtype=torch.float32)})
    back = restore_checkpoint(tmp_path / "ck", like={"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match=r"\(6,\) where the target has \(3,\)"):
        restore_checkpoint(tmp_path / "ck", like={"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(tmp_path / "ck", like={"v": torch.zeros(6)})


# ----------------------------------------------------------------------
# On a mesh
# ----------------------------------------------------------------------

MESH_PLANS = {"model4": dict(model=4), "data2_model2": dict(data=2, model=2)}


def _single_rank_state(tmp_path):
    """A single-rank state with nonzero moments, saved: one train step."""
    cfg = shardable()
    params = params_from_jax(np_params(cfg, 1, scale=0.05), device="cpu")
    opt = train.default_optimizer(1e-2)
    state = opt.init(params)
    batch = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    params, state, _ = train.make_train_step(cfg, opt, device="cpu")(params, state, batch)
    save_checkpoint(tmp_path / "single", {"params": params, "opt_state": state, "step": 1})
    return cfg, params


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    cfg, params = _single_rank_state(tmp)
    cases = [(name, "checkpoint", dict(plan=plan, cfg=cfg, state_dir=str(tmp / "single"),
                                       out_dir=str(tmp / name)))
             for name, plan in MESH_PLANS.items()]
    return tmp, cfg, params, run_ranks(run_cases, 4, cases)


def test_restore_onto_model4_gives_each_rank_its_jax_shard(mesh_runs):
    tmp, cfg, params, ranks = mesh_runs
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    jplan = jsh.MeshPlan(model=4)
    mesh = jsh.make_mesh(jplan)
    placed = jsh.shard_params(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params), jcfg,
                              jplan, mesh)
    devices = np.asarray(mesh.devices)
    got = {r: ranks[r]["model4"] for r in range(4)}
    checked = 0
    for path, arr in train.tree_leaves(placed):
        for shard in arr.addressable_shards:
            coord = dict(zip(tsh.MESH_AXES, (int(c) for c in
                                             np.argwhere(devices == shard.device)[0])))
            rank = coord["model"]  # the group's ranks in model order
            local = train.tree_get(got[rank]["params"], path)
            np.testing.assert_array_equal(local, np.asarray(shard.data), err_msg=str(path))
            checked += 1
    assert checked == 4 * len(train.tree_leaves(params))
    assert all(got[r]["count"] == 1 and got[r]["step"] == 1 for r in got)


def test_checkpoint_saved_on_a_mesh_equals_the_single_rank_one(mesh_runs):
    """The state each plan restored and saved again (gathered, rank 0
    writing) equals the single-rank checkpoint, leaf for leaf."""
    tmp = mesh_runs[0]
    single = restore_checkpoint(tmp / "single")
    for name in MESH_PLANS:
        assert_trees_equal(restore_checkpoint(tmp / name), single)

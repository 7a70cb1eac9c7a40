"""The port's own safetensors reader and ``load_params`` against the JAX
package's loader, on tiny checkpoints each test writes itself with
``safetensors.numpy`` (HF key names and [out, in] projection layout)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.utils import loading as jloading
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.utils import loading as tloading


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_checkpoint(cfg, seed, np_dtype=np.float32):
    """Random weights under HF key names, as the family key maps read them."""
    layer_map, top_map = tloading._key_maps(cfg)
    shapes = param_shapes(cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for hf_key, (name, transpose) in top_map.items():
        if name in shapes:
            shape = shapes[name][::-1] if transpose else shapes[name]
            out[hf_key] = rng.standard_normal(shape).astype(np_dtype)
    for i in range(cfg.num_hidden_layers):
        for suffix, (name, transpose) in layer_map.items():
            if name in shapes["layers"]:
                shape = shapes["layers"][name][1:]
                out[f"model.layers.{i}.{suffix}"] = rng.standard_normal(
                    shape[::-1] if transpose else shape).astype(np_dtype)
    out["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4, np.float32)
    return out


def _compare(tparams, jparams):
    tl = dict(tparams, **{f"layers.{k}": v for k, v in tparams.pop("layers").items()})
    jl = dict(jparams, **{f"layers.{k}": v for k, v in jparams.pop("layers").items()})
    assert tl.keys() == jl.keys()
    for k in tl:
        got = tl[k].float().numpy()
        want = np.asarray(jnp.asarray(jl[k], jnp.float32))
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("model_type", ["llama", "gemma2", "qwen2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_matches_jax_loader(tmp_path, model_type, dtype):
    cfg = tiny_config(model_type, tie_word_embeddings=model_type != "qwen2")
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    save_file(hf_checkpoint(cfg, 1, np_dtype), str(tmp_path / "model.safetensors"))
    tparams, tcfg = tloading.load_params(tmp_path, cfg, dtype=getattr(torch, dtype), device="cpu")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    jparams, _ = jloading.load_params(tmp_path, jcfg, dtype=getattr(jnp, dtype), use_native=False)
    assert tcfg is cfg
    assert tparams["embed_tokens"].dtype == getattr(torch, dtype)
    assert ("lm_head" in tparams) == (not cfg.tie_word_embeddings)
    _compare(tparams, jax.tree.map(np.asarray, jparams))


def test_sharded_checkpoint_with_config_json(tmp_path):
    cfg = tiny_config("llama")
    tensors = hf_checkpoint(cfg, 2)
    keys = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    weight_map = {}
    for fn, ks in shards.items():
        save_file({k: tensors[k] for k in ks}, str(tmp_path / fn))
        weight_map.update({k: fn for k in ks})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    hf = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 16, "max_position_embeddings": 512, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-6, "tie_word_embeddings": True}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert [p.name for p in tloading.shard_files(tmp_path)] == sorted(shards)
    tparams, tcfg = tloading.load_params(tmp_path, dtype=torch.float32, device="cpu")
    assert tcfg == cfg
    jparams, _ = jloading.load_params(tmp_path, dtype=jnp.float32, use_native=False)
    _compare(tparams, jax.tree.map(np.asarray, jparams))


def test_reader_matches_safetensors(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "i8": rng.integers(-100, 100, (2, 2, 2)).astype(np.int8),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "scalar": np.array(2.5, np.float32),
    }
    path = tmp_path / "x.safetensors"
    save_file(tensors, str(path), metadata={"format": "np"})
    f = tloading.SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(tensors)
    for k, want in tensors.items():
        got = f.get_tensor(k)
        assert tuple(got.shape) == want.shape
        if k == "bf16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_loader_errors(tmp_path):
    cfg = tiny_config("llama")
    tensors = hf_checkpoint(cfg, 4)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    save_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="incomplete.*layers.1"):
        tloading.load_params(tmp_path, cfg, device="cpu")
    biased = hf_checkpoint(cfg, 5)
    biased["model.layers.0.self_attn.q_proj.bias"] = np.zeros(64, np.float32)
    save_file(biased, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="bias"):
        tloading.load_params(tmp_path, cfg, device="cpu")
    wrong = hf_checkpoint(cfg, 6)
    wrong["model.norm.weight"] = np.zeros(63, np.float32)
    save_file(wrong, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="shape"):
        tloading.load_params(tmp_path, cfg, device="cpu")
    (tmp_path / "trunc.safetensors").write_bytes(b"\x10\x00")
    with pytest.raises(ValueError, match="truncated"):
        tloading.SafetensorsFile(tmp_path / "trunc.safetensors")
    with pytest.raises(FileNotFoundError):
        tloading.shard_files(tmp_path / "missing")

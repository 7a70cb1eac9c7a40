"""The port's decoder forward against the JAX ``forward``, on the CPU in
float32, for tiny llama, gemma2 and qwen2 on the same numpy-made weights.

Logits must agree within 1e-4 (float32 on both sides; only summation order
differs), with and without a cache, ragged, and through the kernel
impls (the JAX side runs its Pallas kernels in interpret mode, the port
the kernels' plain versions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.models import api as japi
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu_torch import cache as tcache
from llm_np_cp_tpu_torch.config import PRESETS, tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax, tensor_from_numpy
from llm_np_cp_tpu_torch.models import api as tapi
from llm_np_cp_tpu_torch.models import transformer as ttf

ATOL = 1e-4
MODELS = ["llama", "gemma2", "qwen2"]


def np_params(cfg, seed, scale=0.15):
    """Random float32 weights as numpy, in the layout both packages share."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            base = 0.0 if cfg.rms_norm_unit_offset else 1.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
        for k, v in ttf.param_shapes(cfg).items()
    }


def pair(model_type, seed=0, **overrides):
    cfg = tiny_config(model_type, **overrides)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def fwd(params, ids, cfg, cache=None, **kw):
    return ttf.forward(params, torch.as_tensor(ids), cfg, cache, device="cpu", **kw)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("model_type", MODELS + ["llama_untied"])
def test_param_shapes_match_jax(model_type):
    kw = {"tie_word_embeddings": False} if model_type == "llama_untied" else {}
    cfg = tiny_config(model_type.split("_")[0], **kw)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    assert ttf.param_shapes(cfg) == jtf.param_shapes(jcfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        ttf.param_shapes(dataclasses.replace(cfg, num_local_experts=4))


def test_init_params_is_seeded():
    cfg = tiny_config("gemma2")
    a = ttf.init_params(3, cfg, torch.float32, device="cpu")
    b = ttf.init_params(3, cfg, torch.float32, device="cpu")
    torch.testing.assert_close(a["layers"]["q_proj"], b["layers"]["q_proj"], rtol=0, atol=0)
    assert a["layers"]["q_proj"].shape == (3, 64, 64)
    assert (a["final_norm"] == 0).all()  # unit offset: 1 + w == 1
    assert abs(a["embed_tokens"].std().item() - 0.02) < 0.002
    c = ttf.init_params(3, cfg, torch.bfloat16, device="cpu")
    assert c["layers"]["up_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("model_type", MODELS)
def test_forward_cacheless_matches_jax(model_type):
    cfg, tp, jcfg, jp = pair(model_type, 1)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 23))
    got, none = fwd(tp, ids, cfg)
    want, _ = jtf.forward(jp, jnp.asarray(ids), jcfg)
    assert none is None and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("model_type", MODELS)
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_forward_cached_matches_jax_and_cacheless(model_type, cache_dtype):
    """Prefill then single-token steps: logits and cache slabs match the
    JAX forward; float caches also match the port's cache-less forward."""
    cfg, tp, jcfg, jp = pair(model_type, 3)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20))
    tc = tcache.KVCache.init(cfg, 2, 32, getattr(torch, cache_dtype), device="cpu")
    jc = jcache.KVCache.init(jcfg, 2, 32, dtype=getattr(jnp, cache_dtype))
    # int8: a float32 rounding difference can move a value across an int8
    # rounding boundary; one step is absmax/127 of the token-head row
    atol = ATOL if cache_dtype == "float32" else 1e-2
    full, _ = fwd(tp, ids, cfg)
    for lo, hi in ((0, 17), (17, 18), (18, 19), (19, 20)):
        got, tc = fwd(tp, ids[:, lo:hi], cfg, tc)
        want, jc = jtf.forward(jp, jnp.asarray(ids[:, lo:hi]), jcfg, jc)
        _close(got, want, atol)
        if cache_dtype == "float32":
            _close(got, full[:, lo:hi].numpy())
    assert tc.length == int(jc.length) == 20
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    if cache_dtype == "float32":
        _close(tc.k, jc.k, 1e-5)


@pytest.mark.parametrize("model_type", ["llama", "gemma2"])
def test_forward_ragged_matches_jax(model_type):
    cfg, tp, jcfg, jp = pair(model_type, 5)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (3, 19))
    pads = np.array([0, 7, 12])
    mask = np.arange(19)[None, :] >= pads[:, None]
    tc = tcache.KVCache.init(cfg, 3, 32, torch.float32, device="cpu")
    jc = jcache.KVCache.init(jcfg, 3, 32, dtype=jnp.float32)
    got, tc = fwd(tp, ids, cfg, tc, attn_mask=torch.from_numpy(mask),
                  pad_offsets=torch.from_numpy(pads))
    want, jc = jtf.forward(jp, jnp.asarray(ids), jcfg, jc, attn_mask=jnp.asarray(mask),
                           pad_offsets=jnp.asarray(pads))
    _close(got[mask], np.asarray(want)[mask])
    step = rng.integers(0, cfg.vocab_size, (3, 1))
    got, _ = fwd(tp, step, cfg, tc, pad_offsets=torch.from_numpy(pads),
                 attn_impl="flash_decode")
    want, _ = jtf.forward(jp, jnp.asarray(step), jcfg, jc, pad_offsets=jnp.asarray(pads),
                          attn_impl="flash_decode")
    _close(got, want)


@pytest.mark.parametrize("model_type", MODELS)
def test_kernel_impls_match_jax_kernels(model_type):
    """Flash prefill, then flash_decode steps, with the fused epilogue's
    hidden states: the port's plain versions against JAX's interpreted
    Pallas kernels, and against the port's own plain path."""
    cfg, tp, jcfg, jp = pair(model_type, 7)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 21))
    tc = tcache.KVCache.init(cfg, 2, 32, torch.float32, device="cpu")
    jc = jcache.KVCache.init(jcfg, 2, 32, dtype=jnp.float32)
    got, tc = fwd(tp, ids[:, :20], cfg, tc, attn_impl="flash")
    want, jc = jtf.forward(jp, jnp.asarray(ids[:, :20]), jcfg, jc, attn_impl="flash")
    _close(got, want)
    _close(got, fwd(tp, ids[:, :20], cfg)[0].numpy())
    hid, tc = fwd(tp, ids[:, 20:], cfg, tc, attn_impl="flash_decode", skip_logits=True,
                  logits_last_only=True)
    jhid, jc = jtf.forward(jp, jnp.asarray(ids[:, 20:]), jcfg, jc, attn_impl="flash_decode",
                           skip_logits=True, logits_last_only=True)
    _close(hid, jhid)
    tok = ttf.sample_epilogue_tail(tp, hid[:, -1], cfg)
    jtok = jtf.sample_epilogue_tail(jp, jhid[:, -1], jcfg)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    logits = ttf.final_logits(tp, hid, cfg)
    np.testing.assert_array_equal(tok.numpy(), logits[:, -1].argmax(-1).numpy())


def test_aux_outputs_and_causal_lm_match_jax():
    cfg, tp, jcfg, jp = pair("gemma2", 9)
    ids = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 9))
    labels = ids.copy()
    labels[0, :3] = -100
    tout = tapi.CausalLM(tp, cfg, device="cpu")(
        torch.from_numpy(ids), labels=torch.from_numpy(labels),
        output_hidden_states=True, output_attentions=True)
    jout = japi.CausalLM(jp, jcfg)(jnp.asarray(ids), labels=jnp.asarray(labels),
                                  output_hidden_states=True, output_attentions=True)
    for got, want in zip((tout[0], tout[1], tout[3], tout[4]), (jout[0], jout[1], jout[3], jout[4])):
        _close(got, want)
    assert tout[2] is None
    _, _, aux = fwd(tp, ids, cfg, output_hidden_states=True)
    _, _, jaux = jtf.forward(jp, jnp.asarray(ids), jcfg, output_hidden_states=True)
    _close(aux["final_hidden_state"], jaux["final_hidden_state"])
    m = tapi.CausalLM(tp, cfg, device="cpu")
    assert m.get_output_embeddings() is tp["embed_tokens"]
    assert "lm_head" not in m.get_decoder()


def test_forward_contracts():
    cfg, tp, _, _ = pair("llama", 11)
    ids = torch.zeros((1, 4), dtype=torch.long)
    c = tcache.KVCache.init(cfg, 1, 16, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        fwd(tp, ids, cfg, attn_impl="flash", attn_mask=torch.ones(1, 4, dtype=torch.bool))
    fwd(tp, ids, cfg, c)
    with pytest.raises(ValueError, match="fresh cache"):
        fwd(tp, ids, cfg, c, attn_impl="flash")
    with pytest.raises(ValueError, match="capacity"):
        fwd(tp, torch.zeros((1, 13), dtype=torch.long), cfg, c)
    with pytest.raises(ValueError, match="output_attentions"):
        fwd(tp, ids, cfg, attn_impl="flash", output_attentions=True)
    with pytest.raises(ValueError, match="attn_impl"):
        fwd(tp, ids, cfg, attn_impl="ring")
    with pytest.raises(ValueError, match="params live on"):
        ttf.forward(tp, ids, cfg, device="meta")
    with pytest.raises(NotImplementedError, match="quant"):
        q = dict(tp, layers=dict(tp["layers"], q_proj={"q": None, "s": None}))
        fwd(q, ids, cfg)
    c.length = torch.tensor([1])
    with pytest.raises(TypeError, match="per-row"):
        fwd(tp, ids, cfg, c)


def test_epilogue_gate():
    cfg, tp, _, _ = pair("qwen2", 12)
    assert ttf.head_quant_mode(tp, cfg) == "float"
    assert ttf.epilogue_gate_error(tp, cfg, "greedy") is None
    assert "greedy" in ttf.epilogue_gate_error(tp, cfg, "top_p")
    q = dict(tp, embed_tokens={"q": None, "s": None})
    assert ttf.head_quant_mode(q, cfg) is None
    assert ttf.epilogue_gate_error(q, cfg, "greedy") is not None


def test_convert_bf16_bit_exact():
    a = np.random.default_rng(13).standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    tree = params_from_jax({"a": a, "b": {"c": np.ones(3, np.float32)}}, device="cpu")
    assert tree["b"]["c"].dtype == torch.float32


def test_preset_param_count():
    """Llama-3.2-1B's published size, from the port's own shapes."""
    n = sum(
        int(np.prod(s)) for k, v in ttf.param_shapes(PRESETS["meta-llama/Llama-3.2-1B"]).items()
        for s in (v.values() if k == "layers" else [v])
    )
    assert n == 1_235_814_400

"""The port's ops, cache, sampling and config against the JAX package's,
on the CPU in float32, on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.ops import activations as jact
from llm_np_cp_tpu.ops import attention as jattn
from llm_np_cp_tpu.ops import norms as jnorms
from llm_np_cp_tpu.ops import rope as jrope
from llm_np_cp_tpu.ops import sampling as jsamp
from llm_np_cp_tpu_torch import cache as tcache
from llm_np_cp_tpu_torch import config as tconfig
from llm_np_cp_tpu_torch import random as trandom
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.ops import activations as tact
from llm_np_cp_tpu_torch.ops import attention as tattn
from llm_np_cp_tpu_torch.ops import norms as tnorms
from llm_np_cp_tpu_torch.ops import rope as trope
from llm_np_cp_tpu_torch.ops import sampling as tsamp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5  # float32 on both sides


def _np(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    x, w = _np(rng, (3, 5, 64), 3), _np(rng, (64,))
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, unit_offset=unit_offset)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6,
                          unit_offset=unit_offset)
    _close(got, want)


@pytest.mark.parametrize("name", ["silu", "gelu_pytorch_tanh", "relu"])
def test_activations(name):
    x = _np(np.random.default_rng(1), (200,), 4)
    _close(tact.ACT2FN[name](torch.from_numpy(x)), jact.ACT2FN[name](jnp.asarray(x)))


def test_softcap():
    x = _np(np.random.default_rng(2), (100,), 80)
    _close(tact.softcap(torch.from_numpy(x), 30.0), jact.softcap(jnp.asarray(x), 30.0), 1e-4)


@pytest.mark.parametrize("preset", ["meta-llama/Llama-3.2-1B", "google/gemma-2-2b"])
def test_rope(preset):
    """Llama-3 scaled (Llama-3.2) and plain (Gemma-2) frequencies, at
    positions past the original 8k context."""
    tcfg, jcfg = tconfig.PRESETS[preset], jconfig.PRESETS[preset]
    pos = np.array([[0, 1, 7, 900, 8191, 20000]], np.int64)
    tcos, tsin = trope.rope_cos_sin(torch.from_numpy(pos), tcfg)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos, jnp.int32), jcfg)
    _close(tcos, jcos, 2e-3)  # float32 angles up to 2e4 rad: ulp ~2e-3
    _close(tsin, jsin, 2e-3)
    x = _np(np.random.default_rng(3), (1, 6, 2, tcfg.head_dim))
    _close(trope.apply_rope(torch.from_numpy(x), tcos, tsin),
           jrope.apply_rope(jnp.asarray(x), jcos, jsin))


def test_causal_mask_and_gqa_attention():
    rng = np.random.default_rng(4)
    b, sq, skv, h, kh, d = 2, 5, 12, 6, 2, 16
    qpos = np.array([[7, 8, 9, 10, 11], [3, 4, 5, 6, 7]])
    valid = rng.random((b, skv)) > 0.2
    kvpos = np.arange(skv)
    tm = tattn.causal_mask(torch.from_numpy(qpos), torch.from_numpy(kvpos), window=4,
                           kv_valid=torch.from_numpy(valid))
    jm = jattn.causal_mask(jnp.asarray(qpos), jnp.asarray(kvpos), window=4,
                           kv_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    q, k, v = _np(rng, (b, sq, h, d), 2), _np(rng, (b, skv, kh, d), 2), _np(rng, (b, skv, kh, d))
    mask = np.array(jattn.causal_mask(jnp.asarray(qpos), jnp.asarray(kvpos)))
    tout, tw = tattn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(mask), scale=0.25, logit_softcap=10.0,
                                   return_weights=True)
    jout, jw = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), scale=0.25, logit_softcap=10.0,
                                   return_weights=True)
    _close(tout, jout)
    _close(tw, jw)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(5)
    x = _np(rng, (2, 7, 3, 16), 3)
    x[0, 2, 1] = 0.0  # an all-zero row keeps scale 0
    tq, ts = tcache.quantize_kv(torch.from_numpy(x))
    jq, js = jcache.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js, 1e-7)
    assert ts[0, 2, 1] == 0
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tcache.dequantize_kv(tq, ts, dt).float()
        want = jcache.dequantize_kv(jq, js, jdt).astype(jnp.float32)
        _close(got, want, 0.0)


def test_cache_updates_in_place():
    cfg = tconfig.tiny_config("llama")
    c = tcache.KVCache.init(cfg, 2, tcache.align_capacity(70), torch.float32, device="cpu")
    assert c.k.shape == (3, 2, 128, 2, 16) and c.max_seq_len == 128 and not c.quantized
    rng = np.random.default_rng(6)
    k_new, v_new = torch.from_numpy(_np(rng, (2, 4, 2, 16))), torch.from_numpy(_np(rng, (2, 4, 2, 16)))
    kl, vl = tcache.update_layer(c.k[1], c.v[1], k_new, v_new, 10)
    assert kl.data_ptr() == c.k[1].data_ptr()
    torch.testing.assert_close(c.k[1, :, 10:14], k_new)
    jk, jv = jcache.update_layer(jnp.zeros((2, 128, 2, 16)), jnp.zeros((2, 128, 2, 16)),
                                 jnp.asarray(k_new.numpy()), jnp.asarray(v_new.numpy()),
                                 jnp.int32(10))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="capacity"):
        tcache.update_layer(c.k[0], c.v[0], k_new, v_new, 126)
    # a [B] offset (speculative decoding) writes each row at its own slots
    kl, vl = tcache.update_layer(c.k[0], c.v[0], k_new, v_new, torch.tensor([1, 2]))
    jk, jv = jcache.update_layer(jnp.zeros((2, 128, 2, 16)), jnp.zeros((2, 128, 2, 16)),
                                 jnp.asarray(k_new.numpy()), jnp.asarray(v_new.numpy()),
                                 jnp.asarray([1, 2], jnp.int32))
    np.testing.assert_array_equal(kl.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(jv))
    c.valid[:, :20] = True
    c.length = 20
    tcache.truncate(c, 12)
    assert c.length == 12 and c.valid[:, :12].all() and not c.valid[:, 12:].any()


def test_quantized_cache_update_matches_jax():
    cfg = tconfig.tiny_config("llama")
    c = tcache.KVCache.init(cfg, 2, 32, torch.int8, device="cpu")
    assert c.quantized and c.k_scale.shape == (3, 2, 32, 2)
    rng = np.random.default_rng(7)
    k_new, v_new = _np(rng, (2, 3, 2, 16)), _np(rng, (2, 3, 2, 16))
    tcache.update_layer_quantized(c.k[0], c.v[0], c.k_scale[0], c.v_scale[0],
                                  torch.from_numpy(k_new), torch.from_numpy(v_new), 5)
    z8, z = jnp.zeros((2, 32, 2, 16), jnp.int8), jnp.zeros((2, 32, 2))
    jk, jv, jks, jvs = jcache.update_layer_quantized(
        z8, z8, z, z, jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(5))
    np.testing.assert_array_equal(c.k[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(c.v[0].numpy(), np.asarray(jv))
    _close(c.k_scale[0], jks, 1e-7)
    _close(c.v_scale[0], jvs, 1e-7)


# ----------------------------------------------------------------------
# sampling: greedy exactly, stochastic kinds at distribution level
# ----------------------------------------------------------------------

def test_greedy_first_occurrence():
    logits = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 0.0, 5.0]], np.float32)
    got = tsamp.greedy(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsamp.greedy(jnp.asarray(logits))))
    assert got.dtype == torch.int32 and got.tolist() == [1, 0]


@pytest.mark.parametrize(
    "kind,kw",
    [("greedy", {}), ("min_p", {"p_base": 0.05}), ("top_k", {"top_k": 7}),
     ("top_p", {"top_p": 0.8}), ("cdf", {}), ("top_k", {"top_k": 0}),
     ("top_p", {"top_p": 0.0, "temperature": 0.7})],
)
def test_filtered_logits_match_jax(kind, kw):
    logits = _np(np.random.default_rng(8), (3, 50), 2)
    got = tsamp.Sampler(kind, **kw).filtered_logits(torch.from_numpy(logits))
    want = jsamp.Sampler(kind, **kw).filtered_logits(jnp.asarray(logits))
    _close(got, want)


@pytest.mark.parametrize("kind", ["min_p", "top_k", "top_p", "cdf"])
def test_stochastic_draws_follow_filtered_distribution(kind):
    """Draws stay in the filtered support and their frequencies match
    softmax(filtered_logits) (the JAX sampler's distribution)."""
    logits = _np(np.random.default_rng(9), (1, 12), 1.5)
    sampler = tsamp.Sampler(kind, top_k=5, top_p=0.8, p_base=0.1)
    probs = np.asarray(jax.nn.softmax(
        jsamp.Sampler(kind, top_k=5, top_p=0.8, p_base=0.1).filtered_logits(jnp.asarray(logits))))
    big = torch.from_numpy(np.repeat(logits, 4000, axis=0))
    draws = sampler(trandom.PRNGKey(0), big).numpy()  # one key: each row its own counters
    freq = np.bincount(draws, minlength=12) / draws.size
    assert (freq[probs[0] == 0] == 0).all()
    np.testing.assert_allclose(freq, probs[0], atol=0.025)


def test_unknown_sampler_kind():
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamp.Sampler("beam")(None, torch.zeros(1, 4))


# ----------------------------------------------------------------------
# config and device
# ----------------------------------------------------------------------

def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("scan_unroll", None)  # the JAX package's XLA unroll knob
    return d


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match_jax(name):
    t, j = tconfig.PRESETS[name], jconfig.PRESETS[name]
    assert _fields(t) == _fields(j)
    assert t.attn_scale == j.attn_scale and t.num_query_groups == j.num_query_groups
    assert [t.layer_is_sliding(i) for i in range(4)] == [j.layer_is_sliding(i) for i in range(4)]


@pytest.mark.parametrize("model_type", ["llama", "gemma2", "qwen2"])
def test_tiny_and_hf_configs_match_jax(model_type):
    assert _fields(tconfig.tiny_config(model_type)) == _fields(jconfig.tiny_config(model_type))
    hf = {"model_type": model_type, "vocab_size": 100, "hidden_size": 64,
          "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "sliding_window": 32, "final_logit_softcapping": 30.0,
          "rope_scaling": {"rope_type": "llama3", "factor": 32.0}}
    assert _fields(tconfig.ModelConfig.from_hf_dict(hf)) == _fields(jconfig.ModelConfig.from_hf_dict(hf))
    with pytest.raises(ValueError, match="divisible"):
        tconfig.ModelConfig(num_attention_heads=6, num_key_value_heads=4)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").index is not None
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            tcache.KVCache.init(tconfig.tiny_config(), 1, 8)

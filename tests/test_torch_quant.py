"""The port's weight quantization (``llm_np_cp_tpu_torch/quant.py``) against
the JAX package's, on the CPU in float32.

Both sides get the same numpy-made weights.  Quantization is exact
integer arithmetic after one float32 division, so payloads and scales
must be bit-identical.  Products, the forward and the greedy ``Generator``
and ``ServeEngine`` run every weight mode (int8, int8_a8, int4, int4_a8)
on tiny Llama, Gemma-2 and Qwen-2 configs; the JAX side runs its Pallas
kernels in interpret mode (the int8-head fused epilogue among them), the
port the plain versions of its kernels, which is what its wrappers do for
CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import generate as jgen
from llm_np_cp_tpu import quant as jq
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.models.transformer import forward as jforward
from llm_np_cp_tpu.models.transformer import init_params as jinit
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu_torch import quant as tq
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.generate import Generator
from llm_np_cp_tpu_torch.models import transformer as ttf
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.utils.quality import quant_quality


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# mode → quantize_params keywords (the names of utils/quality.MODES)
MODES = {
    "int8": dict(bits=8, act_quant=False),
    "int8_a8": dict(bits=8, act_quant=True),
    "int4": dict(bits=4, act_quant=False),
    "int4_a8": dict(bits=4, act_quant=True),
}
KERNELS = dict(prefill_attn_impl="flash", decode_attn_impl="flash_decode")


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


def quantized_pair(model_type, mode, seed=0, **overrides):
    """(port config, port params, JAX config, JAX params), both quantized
    in ``mode`` by their own package from the same float weights."""
    cfg = tiny_config(model_type, **overrides)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    tp = tq.quantize_params(params_from_jax(npp, device="cpu"), **MODES[mode])
    jp = jq.quantize_params(jax.tree.map(jnp.asarray, npp), **MODES[mode])
    return cfg, tp, jcfg, jp


def assert_same_tree(tp, jp):
    """Every leaf bit-identical, same dtype, same keys."""
    assert tp.keys() == jp.keys()
    for k, v in jp.items():
        if isinstance(v, dict):
            assert_same_tree(tp[k], v)
        else:
            a = np.asarray(v)
            assert str(tp[k].dtype).removeprefix("torch.") == a.dtype.name, k
            np.testing.assert_array_equal(tp[k].numpy(), a, err_msg=k)


# ----------------------------------------------------------------------
# quantization functions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_array_matches_jax(axis):
    rng = np.random.default_rng(1)
    w = (0.2 * rng.standard_normal((3, 40, 24))).astype(np.float32)
    w[0, :, 5] = 0.0  # an all-zero channel: scale 1, payload 0
    w[1, 7, :] = 0.0
    w[2, 3, 3] = 127.5 * 0.01  # a value on a rounding boundary of its channel
    got = tq.quantize_array(torch.from_numpy(w), axis=axis)
    want = jq.quantize_array(jnp.asarray(w), axis=axis)
    assert_same_tree(got, want)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want)))


def test_quantize_array4_and_unpack_match_jax():
    rng = np.random.default_rng(2)
    w = (0.2 * rng.standard_normal((2, 32, 18))).astype(np.float32)
    w[1, :, 0] = 0.0
    got = tq.quantize_array4(torch.from_numpy(w))
    want = jq.quantize_array4(jnp.asarray(w))
    assert got["q4"].dtype == torch.uint8
    assert_same_tree(got, want)
    np.testing.assert_array_equal(tq.payload(got).numpy(), np.asarray(jq.payload(want)))
    np.testing.assert_array_equal(tq._unpack4_pairs(got["q4"]).numpy(),
                                  np.asarray(jq._unpack4_pairs(want["q4"])))
    with pytest.raises(ValueError, match="even"):
        tq.quantize_array4(torch.zeros(3, 4))
    with pytest.raises(NotImplementedError):
        tq.quantize_array4(torch.zeros(4, 4), axis=-1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model_type", ["llama", "gemma2"])
def test_quantize_params_and_param_bytes_match_jax(model_type, mode):
    # gemma2's tiny config is tied; an untied head adds the lm_head leaf
    cfg, tp, _, jp = quantized_pair(model_type, mode, tie_word_embeddings=model_type == "llama")
    assert_same_tree(tp, jp)
    assert tq.param_bytes(tp) == jq.param_bytes(jp)
    head = tp["embed_tokens"] if cfg.tie_word_embeddings else tp["lm_head"]
    assert tq.payload_key(head) == "q" and ttf.head_quant_mode(tp, cfg) == "int8"
    key = tq.payload_key(tp["layers"]["q_proj"])
    assert key == {"int8": "q", "int8_a8": "qa", "int4": "q4", "int4_a8": "q4a"}[mode]


# ----------------------------------------------------------------------
# products
# ----------------------------------------------------------------------

# int4 packs along axis -2 only, so no (out, in) int4 weight exists
EINSUM_CASES = [(spec, key) for spec in ("bsh,ho->bso", "bsh,hv->bsv", "bsh,vh->bsv")
                for key in ("q", "qa", "q4", "q4a")
                if not (spec.endswith("vh->bsv") and key.startswith("q4"))]


@pytest.mark.parametrize("spec,key", EINSUM_CASES)
def test_quant_einsum_matches_jax(spec, key):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero activation row: scale 1
    out_major = spec.endswith("vh->bsv")
    w = (0.1 * rng.standard_normal((24, 32) if out_major else (32, 24))).astype(np.float32)
    axis = -1 if out_major else -2
    if key.startswith("q4"):
        jw, tw = jq.quantize_array4(jnp.asarray(w)), tq.quantize_array4(torch.from_numpy(w))
    else:
        jw = jq.quantize_array(jnp.asarray(w), axis=axis)
        tw = tq.quantize_array(torch.from_numpy(w), axis=axis)
    if key.endswith("a"):
        jw = {key: jw.pop(key[:-1]), **jw}
        tw = {key: tw.pop(key[:-1]), **tw}
    want = np.asarray(jq.quant_einsum(spec, jnp.asarray(x), jw))
    got = tq.quant_einsum(spec, torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if key.endswith("a"):
        # the int32 product is exact and both sides scale it in one order
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # a float weight takes the same entry point
    plain = tq.quant_einsum(spec, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(plain, np.asarray(jq.quant_einsum(spec, jnp.asarray(x),
                                                                 jnp.asarray(w))), atol=1e-5)


def test_int_mm_is_exact_and_spec_checked():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 40)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (40, 16)).astype(np.int8))
    assert torch.equal(tq._int_mm(a, b), a.int() @ b.int())
    with pytest.raises(NotImplementedError, match="spec"):
        tq.quant_einsum("bh,ho->bo", torch.zeros(2, 4), torch.zeros(4, 4))


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model_type", ["llama", "gemma2", "qwen2"])
def test_forward_matches_jax(model_type, mode):
    """Logits of a cache-less forward.  The weight-only modes agree within
    1e-4 (float32; summation order only).  The a8 modes quantize every
    layer's activations per row: a hidden value ~1e-6 apart (the two
    libraries' summation order) on the two sides can round to int8 values
    one step apart, so past the first layers the check is the first
    quantized layer's output within 1e-4, and logits within the size of
    such a one-step flip."""
    cfg, tp, jcfg, jp = quantized_pair(model_type, mode, seed=5)
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9))
    want, _, jaux = jforward(jp, jnp.asarray(ids), jcfg, None, output_hidden_states=True)
    got, _, taux = ttf.forward(tp, torch.as_tensor(ids), cfg, None, device="cpu",
                               output_hidden_states=True)
    want = np.asarray(want)
    np.testing.assert_allclose(taux["hidden_states"][:2].numpy(),
                               np.asarray(jaux["hidden_states"])[:2], atol=1e-4)
    if mode.endswith("_a8"):
        diff = np.abs(got.numpy() - want)
        assert diff.max() <= 0.1 and diff.mean() <= 5e-3, (diff.max(), diff.mean())
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model_type", ["llama", "gemma2", "qwen2"])
def test_generate_matches_jax(model_type, mode):
    """Greedy tokens through flash prefill, the decode kernel and the
    int8-head fused epilogue on both sides (the JAX kernels in interpret
    mode)."""
    cfg, tp, jcfg, jp = quantized_pair(model_type, mode, seed=7)
    jg = jgen.Generator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32,
                        **KERNELS)
    tg = Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                   device="cpu", **KERNELS)
    assert jg.epilogue_impl == tg.epilogue_impl == "fused"
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 10))
    np.testing.assert_array_equal(tg.generate(prompts, 6).tokens,
                                  jg.generate(prompts, 6).tokens)


def test_layer_slicing_and_gate():
    cfg, tp, _, _ = quantized_pair("qwen2", "int4_a8")
    w = ttf.layer_weights(tp["layers"], 1)
    lw = tp["layers"]["q_proj"]
    assert w["q_proj"]["q4a"].shape == lw["q4a"].shape[1:]
    assert w["q_proj"]["s"].shape == (1, lw["s"].shape[-1])
    assert w["ln_attn_in"].shape == (cfg.hidden_size,)
    gamma, wq, ws = ttf.epilogue_params(tp, cfg)
    assert wq.dtype == torch.int8 and ws.shape == (1, cfg.vocab_size)
    # q4 / qa heads keep the logits tail
    for head in ({"q4": tp["embed_tokens"]["q"], "s": tp["embed_tokens"]["s"]},
                 {"qa": tp["embed_tokens"]["q"], "s": tp["embed_tokens"]["s"]}):
        p = dict(tp, embed_tokens=head)
        assert ttf.head_quant_mode(p, cfg) is None
        assert "q4/qa" in ttf.epilogue_gate_error(p, cfg, "greedy")
        assert Generator(p, cfg, sampler=Sampler("greedy"), device="cpu").epilogue_impl == "xla"


def test_jax_quantized_params_convert():
    """``params_from_jax`` takes a JAX-quantized tree as it is (int8 q,
    uint8 q4, float32 s) and the result drives the forward like the
    port's own quantization."""
    cfg, tp, jcfg, jp = quantized_pair("llama", "int4")
    conv = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert_same_tree(conv, jp)
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 7)))
    a, _ = ttf.forward(conv, ids, cfg, None, device="cpu")
    b, _ = ttf.forward(tp, ids, cfg, None, device="cpu")
    assert torch.equal(a, b)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mixed,impl", [("on", "xla"), ("off", "paged")],
                         ids=["unified_tick", "split_paged"])
def test_serve_int8_weights_match_jax(mixed, impl):
    """int8 weights behind both engines, in both tick modes: greedy tokens
    identical per request (the int8-head epilogue on both sides)."""
    cfg, tp, jcfg, jp = quantized_pair("llama", "int8", seed=10)
    kw = dict(mixed_step=mixed, decode_attn_impl=impl, max_slots=3, num_blocks=32,
              block_size=8, max_seq_len=64)
    port = serve.ServeEngine(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                             device="cpu", **kw)
    ref = jserve.ServeEngine(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32,
                             **kw)
    assert port.epilogue_impl == ref.epilogue_impl == "fused"
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (6, 13, 4, 9)]
    out = []
    for eng in (port, ref):
        for j, p in enumerate(prompts):
            eng.submit(p, 6, seed=j)
        eng.run_until_complete()
        out.append({r.req_id: list(r.generated) for r in eng.scheduler.finished})
    assert len(out[0]) == len(prompts) and out[0] == out[1]


# ----------------------------------------------------------------------
# quality
# ----------------------------------------------------------------------

# the JAX package's floors (tests/test_quant_quality.py): min divergence
# step of 128, max logit MAE, max abs error
FLOORS = {
    "int8": (96, 0.01, 0.08),
    "int8_a8": (96, 0.01, 0.08),
    "int4": (32, 0.10, 0.80),
    "int4_a8": (32, 0.10, 0.80),
    "kv_int8": (96, 0.005, 0.03),
}


@pytest.fixture(scope="module")
def quality_model():
    """The JAX floors' own fixture: tiny Llama from ``init_params(PRNGKey(7))``."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    jp = jinit(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("mode", list(FLOORS))
def test_quant_quality_floor(quality_model, mode):
    cfg, params = quality_model
    q = quant_quality(cfg, params, mode, steps=128, device="cpu")
    min_div, max_mae, max_abs = FLOORS[mode]
    assert q["mode"] == mode and q["steps"] == 128
    assert q["divergence_step"] >= min_div, q
    assert q["logit_mae"] <= max_mae, q
    assert q["logit_max_abs_err"] <= max_abs, q

"""The port's Generator against the JAX Generator, on the CPU in float32.

Both run the same numpy-made weights.  The JAX side runs the three
Pallas kernels of the path in interpret mode (``prefill_attn_impl=
"flash"``, ``decode_attn_impl="flash_decode"`` and the fused greedy
epilogue, which the JAX Generator selects by itself on the CPU); the port
runs the kernels' plain versions, which is what its wrappers do for CPU
tensors.  Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import generate as jgen
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu_torch import generate as tgen
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.ops.sampling import Sampler


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
        for k, v in param_shapes(cfg).items()
    }


def pair(model_type, seed=0, **overrides):
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config(model_type, **overrides)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def generators(model_type, seed=0, **kw):
    cfg, tp, jcfg, jp = pair(model_type, seed)
    jg = jgen.Generator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32, **kw)
    tg = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                        device="cpu", **kw)
    return cfg, jg, tg


KERNELS = dict(prefill_attn_impl="flash", decode_attn_impl="flash_decode")


@pytest.mark.parametrize("model_type", ["llama", "gemma2", "qwen2"])
def test_generate_matches_jax(model_type):
    cfg, jg, tg = generators(model_type, 1, **KERNELS)
    assert jg.epilogue_impl == tg.epilogue_impl == "fused"
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    want = jg.generate(prompts, 10)
    got = tg.generate(prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps == 9


@pytest.mark.parametrize("model_type", ["llama", "gemma2"])
def test_generate_ragged_and_many_match_jax(model_type):
    # flash refuses ragged input in both packages: ragged prefill is plain
    cfg, jg, tg = generators(model_type, 3, decode_attn_impl="flash_decode")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 20, 9)]
    np.testing.assert_array_equal(
        tg.generate_ragged(prompts, 8).tokens, jg.generate_ragged(prompts, 8).tokens
    )
    want = jg.generate_many(prompts, 6, batch_size=2)
    got = tg.generate_many(prompts, 6, batch_size=2)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_stream_matches_jax():
    cfg, jg, tg = generators("gemma2", 5, **KERNELS)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 14)
    assert list(tg.stream(prompt, 9)) == list(jg.stream(prompt, 9))


@pytest.mark.parametrize("ragged", [False, True])
def test_chunked_prefill_matches_jax(ragged):
    kw = dict(prefill_chunk=5, decode_attn_impl="flash_decode")
    if not ragged:
        kw["prefill_attn_impl"] = "flash"  # first chunk only
    cfg, jg, tg = generators("llama", 7, **kw)
    rng = np.random.default_rng(8)
    if ragged:
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (13, 7)]
        got, want = tg.generate_ragged(prompts, 6), jg.generate_ragged(prompts, 6)
    else:
        prompts = rng.integers(0, cfg.vocab_size, (2, 13))
        got, want = tg.generate(prompts, 6), jg.generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("early_stop", [False, True])
def test_stop_tokens_match_jax(early_stop):
    cfg, tp, jcfg, jp = pair("llama", 9)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 8))
    free = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                          device="cpu").generate(prompts, 12).tokens
    stop = int(free[0, 3])  # row 0 stops early; other rows may not
    kw = dict(stop_tokens=(stop,), early_stop=early_stop, **KERNELS)
    want = jgen.Generator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32,
                          **kw).generate(prompts, 12)
    got = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                         device="cpu", **kw).generate(prompts, 12)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps
    assert (got.tokens[0, 3:] == stop).all()


def test_int8_cache_matches_jax():
    cfg, tp, jcfg, jp = pair("qwen2", 11)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 10))
    want = jgen.Generator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.int8,
                          **KERNELS).generate(prompts, 8)
    got = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.int8,
                         device="cpu", **KERNELS).generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("kind", ["min_p", "top_k", "top_p", "cdf"])
def test_stochastic_sampler_generate(kind):
    """Stochastic draws differ from jax.random's by design: check the
    plain tail is taken, draws are reproducible per seed and in range."""
    cfg, tp, _, _ = pair("llama", 13)
    g = tgen.Generator(tp, cfg, sampler=Sampler(kind, temperature=0.8), cache_dtype=torch.float32,
                       device="cpu", **KERNELS)
    assert g.epilogue_impl == "xla"
    prompts = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 6))
    a = g.generate(prompts, 7, seed=3).tokens
    np.testing.assert_array_equal(a, g.generate(prompts, 7, seed=3).tokens)
    assert a.shape == (2, 7) and a.min() >= 0 and a.max() < cfg.vocab_size


def test_generator_contracts():
    cfg, tp, _, _ = pair("llama", 15)
    with pytest.raises(ValueError, match="decode_attn_impl"):
        tgen.Generator(tp, cfg, decode_attn_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="prefill_attn_impl"):
        tgen.Generator(tp, cfg, prefill_attn_impl="ring", device="cpu")
    with pytest.raises(ValueError, match="early_stop"):
        tgen.Generator(tp, cfg, early_stop=True, device="cpu")
    g = tgen.Generator(tp, cfg, cache_dtype=torch.float32, device="cpu", **KERNELS)
    with pytest.raises(ValueError, match="capacity"):
        g.generate(np.zeros((1, 8), np.int32), 8, max_seq_len=10)
    with pytest.raises(ValueError, match="ragged"):
        g.generate_ragged([[1, 2], [3]], 2)  # flash prefill refuses ragged input
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgen.Generator(tp, cfg)


def test_host_helpers_match_jax():
    prompts = [[1, 2, 3], [4], [5, 6]]
    for got, want in zip(tgen.Generator.left_pad(prompts), jgen.Generator.left_pad(prompts)):
        np.testing.assert_array_equal(got, want)
    toks = np.array([[1, 7, 2, 7], [3, 4, 5, 6]])
    np.testing.assert_array_equal(
        tgen._trim_after_stop(toks, (7,)), jgen._trim_after_stop(toks, (7,))
    )


class _FakeTokenizer:
    """Maps id i to chr(97 + i % 26); id 0 is half of a two-id glyph."""

    def decode(self, ids, skip_special_tokens=True):
        out = []
        for i, t in enumerate(ids):
            if t == 0:
                out.append("é" if i + 1 < len(ids) else "�")
            elif not (i > 0 and ids[i - 1] == 0):
                out.append(chr(97 + t % 26))
        return "".join(out)

    def __call__(self, text, return_tensors="np"):
        return {"input_ids": np.array([[ord(c) % 26 + 1 for c in text]])}


def test_incremental_detok_and_stream_text():
    tok = _FakeTokenizer()
    ids = [3, 0, 5, 8, 0]
    deltas = []
    for impl in (tgen.IncrementalDetok(tok), jgen.IncrementalDetok(tok)):
        deltas.append([impl.push(t) for t in ids] + [impl.flush()])
    assert deltas[0] == deltas[1]
    cfg, tp, _, _ = pair("llama", 16)
    g = tgen.Generator(tp, cfg, cache_dtype=torch.float32, device="cpu", **KERNELS)
    echoed = []
    text = g.stream_text(tok, "hello", 5, echo=echoed.append)
    assert "".join(echoed) == text and g.last_stream_stats["tokens"] == 5

"""The port's ring attention (``llm_np_cp_tpu_torch.parallel.
ring_attention``) and ``forward(attn_impl="ring")`` against the JAX
package's single device attention and forward, on the CPU in float32.

The counterparts of ``tests/test_ring_attention.py``, at their
tolerances: ``ring_attention`` on global tensors against
``gqa_attention`` (2e-5), the ring forward against the plain forward
(2e-4 / 1e-4).  The ranks are spawned gloo processes, once per world
size for this module (``mesh_ranks.run_cases``, which imports no JAX);
the JAX mesh test's 8-device meshes become 4 ranks here (seq 4, seq 2 x
model 2, data 2 x seq 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.cache import KVCache as JKVCache
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.attention import causal_mask, gqa_attention
from llm_np_cp_tpu_torch.cache import KVCache
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import forward, param_shapes
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from mesh_ranks import run_cases


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RING_ATOL = 2e-5  # ring_attention against gqa_attention
ATOL, RTOL = 2e-4, 1e-4  # the ring forward against the plain forward


def _reference(q, k, v, scale, window=None, softcap=None):
    b, s = q.shape[0], q.shape[1]
    pos = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))
    mask = causal_mask(pos, jnp.arange(s), window=window)
    return np.asarray(gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                                    scale=scale, logit_softcap=softcap))


def qkv(seed, b, s, h, kh, d, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32) * qk_scale,
            rng.standard_normal((b, s, kh, d), dtype=np.float32) * qk_scale,
            rng.standard_normal((b, s, kh, d), dtype=np.float32))


def np_params(cfg, seed, scale=0.15):
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


def tiny(model_type="llama", **kw):
    """``tests/test_ring_attention.py``'s ``_tiny_cfg``."""
    return tiny_config(model_type, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                       hidden_size=32, num_hidden_layers=2, **kw)


LLAMA = tiny()
GEMMA = tiny("gemma2", sliding_window=8, attn_logit_softcapping=30.0)
NPP = {"llama": np_params(LLAMA, 0), "gemma": np_params(GEMMA, 1)}
CFG = {"llama": LLAMA, "gemma": GEMMA}
TP = {m: params_from_jax(p, device="cpu") for m, p in NPP.items()}


def ids(seed, b, s, cfg=LLAMA):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ring_attention on global tensors: (name, seq shards, inputs, keywords)
RING = {
    "shards2": (2, qkv(0, 2, 16, 4, 2, 16), dict(scale=16 ** -0.5)),
    "shards4": (4, qkv(1, 2, 32, 4, 2, 16), dict(scale=16 ** -0.5)),
    "window_softcap2": (2, qkv(2, 1, 32, 2, 1, 8, 2.0), dict(scale=0.3, window=10,
                                                            logit_softcap=20.0)),
    "window_softcap4": (4, qkv(3, 1, 32, 2, 1, 8, 2.0), dict(scale=0.3, window=10,
                                                            logit_softcap=20.0)),
    "indivisible15_shards2": (2, qkv(4, 1, 15, 2, 1, 8), dict(scale=8 ** -0.5)),
    "indivisible30_shards4": (4, qkv(5, 1, 30, 2, 1, 8), dict(scale=8 ** -0.5)),
}
# the ring forward: (name, plan, model, ids)
FWD = {
    "seq2_model2": (dict(seq=2, model=2), "llama", ids(0, 2, 16)),
    "data2_seq2": (dict(data=2, seq=2), "llama", ids(0, 2, 16)),
    "seq2_model2_s5": (dict(seq=2, model=2), "llama", ids(5, 2, 5)),
    "seq2_model2_s13": (dict(seq=2, model=2), "llama", ids(13, 2, 13)),
    "seq2_model2_s15": (dict(seq=2, model=2), "llama", ids(15, 2, 15)),
    "seq4_s13": (dict(seq=4), "llama", ids(13, 2, 13)),
    "gemma_sliding_seq4": (dict(seq=4), "gemma", ids(2, 1, 16, GEMMA)),
}
CACHE_IDS = ids(1, 2, 16)


def _cases(world):
    cases = [(name, "ring", dict(plan=dict(seq=n), q=q, k=k, v=v, **kw))
             for name, (n, (q, k, v), kw) in RING.items() if n == world]
    if world == 4:
        cases += [(name, "forward", dict(plan=plan, params=TP[m], cfg=CFG[m], ids=x,
                                         attn_impl="ring"))
                  for name, (plan, m, x) in FWD.items()]
        cases.append(("ring_prefill_cache", "cached", dict(
            plan=dict(seq=2, model=2), params=TP["llama"], cfg=LLAMA, ids=CACHE_IDS,
            steps=ids(3, 2, 2), capacity=24, attn_impl="ring")))
    return cases


@pytest.fixture(scope="module")
def world2():
    return run_ranks(run_cases, 2, _cases(2))


@pytest.fixture(scope="module")
def world4():
    return run_ranks(run_cases, 4, _cases(4))


def _rank0(ranks, name):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name], ranks[0][name], err_msg=name)
    return ranks[0][name]


@pytest.mark.parametrize("name", list(RING), ids=list(RING))
def test_ring_matches_single_device(name, request):
    """``ring_attention`` over 2 or 4 seq shards (with a window and a
    softcap, and at an S the shards do not divide) equals single device
    ``gqa_attention``, on every rank; the K/V blocks make n - 1 hops."""
    n, (q, k, v), kw = RING[name]
    ranks = request.getfixturevalue(f"world{n}")
    got = _rank0(ranks, name)
    assert got.shape == q.shape
    want = _reference(q, k, v, kw["scale"], kw.get("window"), kw.get("logit_softcap"))
    np.testing.assert_allclose(got, want, atol=RING_ATOL)
    assert ranks[0][name + "/collectives"]["ppermute"]["calls"] == n - 1


@pytest.mark.parametrize("name", list(FWD), ids=list(FWD))
def test_forward_ring_parity(name, world4):
    """Cache-less ``forward(attn_impl="ring")`` under seq x model, data x
    seq and seq alone (prompt lengths the axis does not divide included;
    Gemma-2's sliding layers and softcaps) equals the JAX plain forward."""
    plan, model, x = FWD[name]
    got = _rank0(world4, name)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(CFG[model]))
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, NPP[model]), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_forward_ring_prefill_writes_cache(world4):
    """Ring prefill into a fresh cache gives the XLA prefill's logits and
    the same cache contents (every seq rank holds the whole sequence), so
    decode continues from it: two cached steps equal JAX's."""
    got = world4[0]["ring_prefill_cache"]
    for r in world4[1:]:
        np.testing.assert_array_equal(r["ring_prefill_cache"]["k"], got["k"])
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(LLAMA))
    jp = jax.tree.map(jnp.asarray, NPP["llama"])
    cache = JKVCache.init(jcfg, 2, 24, dtype=jnp.float32)
    want, cache = jtf.forward(jp, jnp.asarray(CACHE_IDS), jcfg, cache)
    np.testing.assert_allclose(got["logits"][0], np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["k"], np.asarray(cache.k), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["v"], np.asarray(cache.v), atol=ATOL, rtol=RTOL)
    assert got["length"] == int(cache.length) + 2
    for j, t in enumerate(ids(3, 2, 2).T):
        want, cache = jtf.forward(jp, jnp.asarray(t[:, None]), jcfg, cache)
        np.testing.assert_allclose(got["logits"][j + 1], np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_forward_ring_rejects_used_cache():
    params = TP["llama"]
    cache = KVCache.init(LLAMA, 1, 16, torch.float32, device="cpu")
    _, cache = forward(params, torch.tensor([[1, 2, 3, 4]]), LLAMA, cache, device="cpu")
    with pytest.raises(ValueError, match="fresh cache"):
        forward(params, torch.tensor([[1, 2, 3, 4]]), LLAMA, cache, attn_impl="ring",
                device="cpu")


def test_forward_ring_needs_seq_mesh():
    with pytest.raises(ValueError, match="seq"):
        forward(TP["llama"], torch.tensor([[1, 2, 3, 4]]), LLAMA, attn_impl="ring",
                device="cpu")
    from llm_np_cp_tpu_torch.generate import Generator

    with pytest.raises(ValueError, match="seq"):
        Generator(TP["llama"], LLAMA, prefill_attn_impl="ring", device="cpu")


def test_kv_cache_positions_match_jax():
    """``KVCache.positions``: every slot's absolute position."""
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(LLAMA))
    want = np.asarray(JKVCache.init(jcfg, 2, 24, dtype=jnp.float32).positions())
    got = KVCache.init(LLAMA, 2, 24, torch.float32, device="cpu").positions()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

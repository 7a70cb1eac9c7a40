"""The port's Mixture-of-Experts layers against the JAX package's, on the
CPU, on the same numpy-made weights.

``moe_mlp`` (float32 and bf16; capacities that keep every route, that
drop some and that drop many; a group length that does not divide the
tokens; top-1 and top-2; one expert against the dense MLP; planted tie
rows), the experts' two ``quant_einsum`` specs in every weight mode,
``quantize_params`` on expert stacks, and then the model through every
entry point: ``forward`` (cache-less, cached, the router loss),
``Generator``, ``SpeculativeGenerator`` and ``ServeEngine`` (unified and
phase-split ticks, int8 weights, ``spec_k``), with greedy tokens equal
to the JAX package's.  The JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.

Capacity: with ``E`` experts and ``k`` routes a token, a factor of
``E / k`` (``NO_DROP``) makes the capacity the group length, so no
route drops and a token's output does not depend on the rest of its
group; the default 2.0 with 8 experts can drop, and then a token's
output depends on what else is in its forward (its tick, its padded
batch).  The serve legs run on a ``TickClock`` so both engines see the
same ticks.
"""

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
from llm_np_cp_tpu import generate as jgen
from llm_np_cp_tpu import quant as jq
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu import speculative as jspec
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops import moe as jmoe
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import telemetry as jtel
from llm_np_cp_tpu.utils import loading as jloading
from llm_np_cp_tpu_torch import generate as tgen
from llm_np_cp_tpu_torch import quant as tq
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch import speculative as tspec
from llm_np_cp_tpu_torch.cache import KVCache
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models import transformer as ttf
from llm_np_cp_tpu_torch.ops import moe as tmoe
from llm_np_cp_tpu_torch.ops.activations import ACT2FN
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import telemetry as ttel
from llm_np_cp_tpu_torch.utils import loading as tloading
from sampled_parity import assert_prefix_parity, generate_margins
from tick_clock import clocked


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


E, K_TOP = 8, 2
NO_DROP = E / K_TOP  # capacity = group length: no route drops
ATOL = 1e-4  # float32 logits: only summation order differs
MODES = {
    "int8": dict(bits=8, act_quant=False),
    "int8_a8": dict(bits=8, act_quant=True),
    "int4": dict(bits=4, act_quant=False),
    "int4_a8": dict(bits=4, act_quant=True),
}
KERNELS = dict(prefill_attn_impl="flash", decode_attn_impl="flash_decode")


def moe_config(cf=2.0, **overrides):
    return tiny_config("llama", num_local_experts=E, num_experts_per_tok=K_TOP,
                       moe_capacity_factor=cf, **overrides)


def np_params(cfg, seed, scale=0.15):
    """Random float32 weights as numpy, in the layout both packages share
    (0.15, not the init's 0.02: greedy tokens then vary)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
        for k, v in ttf.param_shapes(cfg).items()
    }


def pair(cf=2.0, seed=0, mode=None, **overrides):
    """(port config, port params, JAX config, JAX params) on the same
    weights, each quantized by its own package in ``mode``."""
    cfg = moe_config(cf, **overrides)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    tp, jp = params_from_jax(npp, device="cpu"), jax.tree.map(jnp.asarray, npp)
    if mode is not None:
        tp, jp = tq.quantize_params(tp, **MODES[mode]), jq.quantize_params(jp, **MODES[mode])
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


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------

def layer_inputs(seed, b, s, h, e, i, *, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    x[0, 2] = 0.0  # router logits all 0: every expert ties
    w = [(0.5 * rng.standard_normal((h, e))).astype(np.float32)]
    w += [(scale * rng.standard_normal(sh)).astype(np.float32)
          for sh in ((e, h, i), (e, h, i), (e, i, h))]
    return [x] + w


class _F32Dots:
    """``jnp`` with an ``einsum`` that takes bf16 operands as float32
    where a float32 result is asked for: XLA's CPU backend has no
    bf16 x bf16 -> f32 dot, and the product is the same (a product of two
    bf16 values is exact in float32; the sum is float32 either way)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)


def both_moe(arrays, dtype, monkeypatch=None, **kw):
    """(port (out, aux), JAX (out, aux)) of ``moe_mlp`` on the same
    arrays cast to ``dtype`` (bf16: the JAX products through
    ``_F32Dots``)."""
    jd = jnp.float32
    if dtype == torch.bfloat16:
        jd = jnp.bfloat16
        monkeypatch.setattr(jmoe, "jnp", _F32Dots())
        monkeypatch.setattr(jq, "jnp", _F32Dots())
    got = tmoe.moe_mlp(*(torch.from_numpy(a).to(dtype) for a in arrays),
                       act=ACT2FN["silu"], **kw)
    want = jmoe.moe_mlp(*(jnp.asarray(a, jd) for a in arrays), act=jax.nn.silu, **kw)
    return got, want


def routes_kept(x, router_w, *, top_k, cf, group_size):
    """(routes, routes kept) of the port's routing on ``x [T, H]``."""
    _, gates = tmoe.route(torch.from_numpy(x), torch.from_numpy(router_w), top_k=top_k)
    routed = gates > 0
    gs = tmoe._group_split(x.shape[0], group_size)
    cap = max(1, int(np.ceil(gs * top_k / router_w.shape[1] * cf)))
    return int(routed.sum()), int(tmoe.dispatch_mask(routed, gs, cap, torch.float32).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cf", [4.0, 2.0, 0.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(dtype, cf, top_k, monkeypatch):
    """15 tokens in groups of 3 (group_size 4 does not divide 15), four
    experts: at 4.0 no route drops, at 0.25 many do; the planted zero
    row ties every expert and routes to JAX's experts 0..k-1."""
    arrays = layer_inputs(1, 3, 5, 32, 4, 48)
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=4)
    (out, aux), (jout, jaux) = both_moe(arrays, dtype, monkeypatch, **kw)
    assert out.dtype == dtype and out.shape == (3, 5, 32)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    else:
        # bf16: the intermediate roundings may part by an ulp of bf16
        np.testing.assert_allclose(as_np(out), as_np(jout), atol=2.0 ** -5, rtol=2.0 ** -6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    routes, kept = routes_kept(arrays[0].reshape(15, 32), arrays[1], top_k=top_k, cf=cf,
                               group_size=4)
    assert routes == 15 * top_k
    if cf == 4.0:
        assert kept == routes
    if cf == 0.25:
        assert kept < routes  # the dropping capacity really drops
    _, gates = tmoe.route(torch.zeros(1, 32), torch.from_numpy(arrays[1]), top_k=top_k)
    assert torch.nonzero(gates[0]).flatten().tolist() == list(range(top_k))


def test_moe_mlp_one_group_and_the_dense_mlp():
    """One group over all tokens (group_size above T), and one expert with
    one route a token: the dense SwiGLU MLP."""
    arrays = layer_inputs(2, 2, 9, 32, 4, 48)
    (out, _), (jout, _) = both_moe(arrays, torch.float32, top_k=2, group_size=1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    x, _, g, u, d = (torch.from_numpy(a) for a in layer_inputs(3, 2, 9, 32, 1, 48))
    out, aux = tmoe.moe_mlp(x, torch.zeros(32, 1), g, u, d, act=ACT2FN["silu"], top_k=1,
                            capacity_factor=1.0)
    dense = (torch.nn.functional.silu(x @ g[0]) * (x @ u[0])) @ d[0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    assert float(aux) == 1.0  # one expert takes every route: E · f · P = 1


@pytest.mark.parametrize("width", [8, 64])
def test_top_k_stable_matches_lax_top_k(width):
    """Rows of equal probabilities and rows with planted ties: the port's
    selection takes ``lax.top_k``'s indices (lower index first), where
    ``torch.topk`` need not."""
    rng = np.random.default_rng(width)
    rows = [np.full(width, 1.0 / width, np.float32)]
    for _ in range(20):
        r = rng.integers(0, 4, width).astype(np.float32)  # many ties
        rows.append(r / r.sum() if r.sum() else np.full(width, 1.0 / width, np.float32))
    p = np.stack(rows)
    for k in (1, 2, 3):
        vals, idx = tmoe.top_k_stable(torch.from_numpy(p), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(p), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert tmoe.top_k_stable(torch.from_numpy(p[:1]), 2)[1].tolist() == [[0, 1]]


@pytest.mark.parametrize("spec", ["gech,ehi->geci", "geci,eih->gech"])
@pytest.mark.parametrize("key", ["float", "q", "qa", "q4", "q4a"])
def test_quant_einsum_expert_specs_match_jax(spec, key):
    """Slots ``[G, E, C, in]`` against an expert stack ``[E, in, out]``;
    an empty slot (all zero) takes scale 1 in the W8A8 modes."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    x[1, 2, 3] = 0.0
    w = (0.1 * rng.standard_normal((3, 32, 24))).astype(np.float32)
    if key == "float":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    elif key.startswith("q4"):
        jw, tw = jq.quantize_array4(jnp.asarray(w)), tq.quantize_array4(torch.from_numpy(w))
    else:
        jw = jq.quantize_array(jnp.asarray(w), axis=-2)
        tw = tq.quantize_array(torch.from_numpy(w), axis=-2)
    if key.endswith("a"):
        jw = {key: jw.pop(key[:-1]), **jw}
        tw = {key: tw.pop(key[:-1]), **tw}
    want = np.asarray(jq.quant_einsum(spec, jnp.asarray(x), jw))
    got = tq.quant_einsum(spec, torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 3, 4, 24)
    if key.endswith("a"):
        # the int32 product is exact and both sides scale it in one order
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_params_expert_stacks_match_jax(mode):
    """Expert stacks ``[L, E, in, out]`` quantize along ``in`` per
    expert column, bit for bit (quantized a layer at a time here); the
    router stays float."""
    cfg, tp, jcfg, jp = pair(mode=mode)
    assert_same_tree(tp, jax.tree.map(np.asarray, jp))
    assert not tq.is_quantized(tp["layers"]["router"])
    assert tp["layers"]["gate_proj"]["s"].shape == (cfg.num_hidden_layers, E, 1,
                                                   cfg.intermediate_size)
    assert tq.param_bytes(tp) == jq.param_bytes(jp)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def test_param_shapes_and_init():
    cfg = moe_config()
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    assert ttf.param_shapes(cfg) == jtf.param_shapes(jcfg)
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        ttf.param_shapes(dataclasses.replace(cfg, mlp_bias=True))
    a = ttf.init_params(3, cfg, torch.bfloat16, device="cpu")
    b = ttf.init_params(3, cfg, torch.bfloat16, device="cpu")
    assert a["layers"]["gate_proj"].shape == (3, E, 64, 128)
    assert a["layers"]["router"].shape == (3, 64, E)
    assert torch.equal(a["layers"]["down_proj"], b["layers"]["down_proj"])
    # the expert stack is drawn a layer at a time: still N(0, 0.02^2)
    assert abs(a["layers"]["up_proj"].float().std().item() - 0.02) < 0.002
    assert not torch.equal(a["layers"]["up_proj"][0], a["layers"]["up_proj"][1])


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("mode", [None] + list(MODES))
def test_forward_cacheless_matches_jax(cf, mode):
    cfg, tp, jcfg, jp = pair(cf, 1, mode)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 23))
    got, _, aux = ttf.forward(tp, torch.as_tensor(ids), cfg, None, device="cpu",
                              output_router_losses=True)
    want, _, jaux = jtf.forward(jp, jnp.asarray(ids, jnp.int32), jcfg, None,
                                output_router_losses=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]), float(jaux["moe_aux_loss"]),
                               rtol=1e-6)
    assert float(aux["moe_aux_loss"]) > 0
    plain = ttf.forward(tp, torch.as_tensor(ids), cfg, None, device="cpu")
    assert len(plain) == 2 and torch.equal(plain[0], got)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_forward_cached_decode_matches_jax(cf):
    """A ragged prefill into a cache, then decode steps: each call's
    logits equal JAX's (its group is the call's B x S tokens, pads
    included)."""
    cfg, tp, jcfg, jp = pair(cf, 4)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, cfg.vocab_size, (3, 9))
    mask = np.ones((3, 9), bool)
    mask[1, :4] = mask[2, :2] = False
    pads = (~mask).sum(1)
    ids[~mask] = 0
    tc = KVCache.init(cfg, 3, 32, torch.float32, device="cpu")
    from llm_np_cp_tpu.cache import KVCache as JKVCache
    jc = JKVCache.init(jcfg, 3, 32, dtype=jnp.float32)
    got, tc = ttf.forward(tp, torch.as_tensor(ids), cfg, tc, attn_mask=torch.as_tensor(mask),
                          pad_offsets=torch.as_tensor(pads), device="cpu")
    want, jc = jtf.forward(jp, jnp.asarray(ids, jnp.int32), jcfg, jc,
                           attn_mask=jnp.asarray(mask), pad_offsets=jnp.asarray(pads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    nxt = np.asarray(want)[:, -1].argmax(-1)[:, None]
    for _ in range(4):
        got, tc = ttf.forward(tp, torch.as_tensor(nxt), cfg, tc, pad_offsets=torch.as_tensor(pads),
                              device="cpu")
        want, jc = jtf.forward(jp, jnp.asarray(nxt, jnp.int32), jcfg, jc,
                               pad_offsets=jnp.asarray(pads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        nxt = np.asarray(want)[:, -1].argmax(-1)[:, None]


def test_params_from_jax_carries_expert_leaves():
    """JAX MoE params as numpy (float and int4_a8) convert leaf for leaf
    and drive the forward like the port's own params."""
    cfg, tp, jcfg, jp = pair(mode="int4_a8")
    conv = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert_same_tree(conv, jax.tree.map(np.asarray, jp))
    assert conv["layers"]["down_proj"]["q4a"].shape == (cfg.num_hidden_layers, E, 64, 64)
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 7)))
    a, _ = ttf.forward(conv, ids, cfg, None, device="cpu")
    b, _ = ttf.forward(tp, ids, cfg, None, device="cpu")
    assert torch.equal(a, b)
    bf = jax.tree.map(lambda v: np.asarray(v).astype(ml_dtypes.bfloat16),
                      np_params(cfg, 0))
    conv = params_from_jax(bf, device="cpu")
    assert conv["layers"]["gate_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(conv["layers"]["gate_proj"].view(torch.int16).numpy(),
                                  bf["layers"]["gate_proj"].view(np.int16))


# ----------------------------------------------------------------------
# offline generation
# ----------------------------------------------------------------------

def generators(models, sampler="greedy", **kw):
    cfg, tp, jcfg, jp = models
    js = JSampler(sampler, p_base=0.05) if sampler == "min_p" else JSampler(sampler)
    ts = Sampler(sampler, p_base=0.05) if sampler == "min_p" else Sampler(sampler)
    jg = jgen.Generator(jp, jcfg, sampler=js, cache_dtype=jnp.float32, **kw)
    tg = tgen.Generator(tp, cfg, sampler=ts, cache_dtype=torch.float32, device="cpu", **kw)
    return tg, jg, js


@pytest.mark.parametrize("cf", [NO_DROP, 2.0, 0.5])
def test_generate_matches_jax(cf):
    """Greedy ``generate`` (flash prefill, the decode kernel, the fused
    epilogue), ``generate_ragged`` (left pads route through the experts)
    and ``stream``: the JAX package's tokens."""
    models = pair(cf, 6)
    cfg = models[0]
    tg, jg, _ = generators(models, **KERNELS)
    assert tg.epilogue_impl == jg.epilogue_impl == "fused"
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12))
    got, want = tg.generate(prompts, 10), jg.generate(prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(set(np.asarray(got.tokens).ravel().tolist())) > 5  # the tokens vary
    tr, jr = generators(models, decode_attn_impl="flash_decode")[:2]
    ragged = [rng.integers(0, cfg.vocab_size, n) for n in (5, 17, 9)]
    np.testing.assert_array_equal(tr.generate_ragged(ragged, 8).tokens,
                                  jr.generate_ragged(ragged, 8).tokens)
    assert list(tg.stream(prompts[1], 9)) == list(jg.stream(prompts[1], 9))


def test_min_p_generate_matches_jax():
    """Min-p draws the JAX tokens, each row up to the JAX side's first
    near-tie (the margins come from a cache-less forward, which routes
    alike only without drops: NO_DROP)."""
    models = pair(NO_DROP, 8)
    cfg, _, jcfg, jp = models
    tg, jg, js = generators(models, "min_p", **KERNELS)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 6))
    want = jg.generate(prompts, 12, seed=3).tokens
    got = tg.generate(prompts, 12, seed=3).tokens
    margins = generate_margins(jp, jcfg, js, prompts, want, 3)
    assert assert_prefix_parity(want, got, margins, "moe min_p") > 0


@pytest.mark.parametrize("cf", [NO_DROP, 2.0])
def test_speculative_matches_jax(cf):
    """The int8 self-draft: the JAX speculative tokens and rounds; without
    drops also the plain Generator's tokens (with drops a verify
    forward's group differs from a decode step's)."""
    models = pair(cf, 10)
    cfg, tp, jcfg, jp = models
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    got = tspec.SpeculativeGenerator(tp, cfg, gamma=3, sampler=Sampler("greedy"),
                                     cache_dtype=torch.float32, device="cpu").generate(prompts, 12)
    want = jspec.SpeculativeGenerator(jp, jcfg, gamma=3, sampler=JSampler("greedy"),
                                      cache_dtype=jnp.float32).generate(prompts, 12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert (got.rounds, got.acceptance_rate) == (want.rounds, want.acceptance_rate)
    if cf == NO_DROP:
        tg = generators(models)[0]
        np.testing.assert_array_equal(got.tokens, tg.generate(prompts, 12).tokens)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

LEGS = {"mixed": ("on", "xla"), "split_paged": ("off", "paged")}


def engines(models, leg, *, spec_k=0, **kw):
    """(port engine, JAX engine), each on its own ``TickClock``."""
    cfg, tp, jcfg, jp = models
    mixed, impl = LEGS[leg]
    kw = dict(dict(max_slots=4, num_blocks=48), mixed_step=mixed, decode_attn_impl=impl,
              block_size=8, max_seq_len=64, **kw)
    if spec_k:
        kw["spec_k"] = spec_k
    port = clocked(serve.ServeEngine, tp, cfg, sampler=Sampler("greedy"),
                   cache_dtype=torch.float32, device="cpu", **kw)
    ref = clocked(jserve.ServeEngine, jp, jcfg, sampler=JSampler("greedy"),
                  cache_dtype=jnp.float32, **kw)
    return port, ref


def tokens(engine):
    return {r.req_id: list(r.generated) for r in engine.scheduler.finished}


def trace32(cfg):
    return serve.poisson_trace(np.random.default_rng(0), 32, rate_rps=40.0,
                               prompt_len_range=(3, 14), max_new_tokens=6,
                               vocab_size=cfg.vocab_size)


@pytest.mark.parametrize("cf", [NO_DROP, 2.0, 0.5])
@pytest.mark.parametrize("leg", list(LEGS))
def test_serve_trace_parity_32_requests(leg, cf):
    """The 32-request trace through both engines: identical tokens per
    request (the ticks' pad rows route too, so drops fall on the same
    tokens only if both engines pack alike).  Without drops the tokens
    also equal the port's offline ``generate_ragged`` of each request
    alone; at 0.5 they do not (the drops bite)."""
    models = pair(cf, 12)
    cfg, tp = models[:2]
    trace = trace32(cfg)
    port, ref = engines(models, leg)
    assert port.replay_trace(trace)["finished"] == 32
    assert ref.replay_trace(trace)["finished"] == 32
    assert tokens(port) == tokens(ref)
    assert port.n_host_fetches == (port.n_dispatches if port.mixed
                                   else port.n_decode_dispatches) > 0
    if cf == 2.0:
        return
    gen = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                         device="cpu")
    alone = {req.req_id: [int(t) for t in gen.generate_ragged(
        [req.prompt], req.max_new_tokens, seed=req.seed).tokens[0][: req.max_new_tokens]]
        for req in port.scheduler.finished}
    if cf == NO_DROP:
        assert tokens(port) == alone
    else:  # the dropping capacity changes tokens: a request's tick matters
        assert tokens(port) != alone


def test_serve_int8_weights_match_jax():
    models = pair(2.0, 13, "int8")
    cfg = models[0]
    port, ref = engines(models, "mixed", max_slots=3, num_blocks=32)
    assert port.epilogue_impl == ref.epilogue_impl == "fused"
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (6, 13, 4, 9)]
    for eng in (port, ref):
        for j, p in enumerate(prompts):
            eng.submit(p, 6, seed=j)
        eng.run_until_complete()
    assert len(tokens(port)) == 4 and tokens(port) == tokens(ref)


def test_serve_spec_k4_matches_jax():
    """Served speculation (verify slices packed in the unified tick) on
    tiled prompts: the JAX spec engine's tokens and spec counts."""
    models = pair(2.0, 15)
    cfg = models[0]
    rng = np.random.default_rng(16)
    trace = serve.poisson_trace(rng, 12, rate_rps=40.0, prompt_len_range=(4, 14),
                                max_new_tokens=8, vocab_size=cfg.vocab_size)
    for item in trace:
        item["prompt"] = np.resize(rng.integers(1, cfg.vocab_size, 4).astype(np.int32),
                                   item["prompt"].size)
        item["speculative"] = True
    port, ref = engines(models, "mixed", spec_k=4)
    snap, jsnap = port.replay_trace(trace), ref.replay_trace(trace)
    assert snap["finished"] == jsnap["finished"] == 12
    assert tokens(port) == tokens(ref)
    keys = [k for k in jsnap if k.startswith("spec_")]
    assert keys and {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["spec_drafted_tokens"] > 0


def test_tick_segments_name_each_lane(monkeypatch):
    """``ServeEngine.tick_segments`` maps each unified tick's lanes to
    (request, content position): every request's router logits gathered
    from its ticks' lanes by that map equal a cache-less forward's over
    its prompt + tokens, position by position (float32, no drops)."""
    cfg, tp = pair(NO_DROP, 17)[:2]
    logged = []
    route = tmoe.route

    def logging_route(x, router_w, *, top_k):
        logged.append(x.float() @ router_w.float())
        return route(x, router_w, top_k=top_k)

    port = engines(pair(NO_DROP, 17), "mixed")[0]
    for j, item in enumerate(trace32(cfg)[:12]):
        port.submit(item["prompt"], item["max_new_tokens"], seed=j)
    monkeypatch.setattr(tmoe, "route", logging_route)
    ticks = []
    while True:
        last = port.tick_segments
        more = port.step()
        if port.tick_segments is not last:
            ticks.append(port.tick_segments)
        if not more:
            break
    layers = cfg.num_hidden_layers
    assert len(logged) == layers * len(ticks) and len(port.scheduler.finished) == 12
    for req in port.scheduler.finished:
        p = req.prompt.size + len(req.generated) - 1
        got = [[None] * p for _ in range(layers)]
        for t, segments in enumerate(ticks):
            for rid, lane0, n, pos0 in segments:
                if rid == req.req_id:
                    for k in range(min(n, p - pos0)):
                        for layer in range(layers):
                            got[layer][pos0 + k] = logged[t * layers + layer][lane0 + k]
        assert all(v is not None for row in got for v in row)
        want = []
        monkeypatch.setattr(tmoe, "route", lambda x, w, *, top_k: (
            want.append(x.float() @ w.float()), route(x, w, top_k=top_k))[1])
        ids = torch.as_tensor(np.concatenate([req.prompt, req.generated[:-1]]))[None].long()
        ttf.forward(tp, ids, cfg, None, device="cpu")
        monkeypatch.setattr(tmoe, "route", logging_route)
        for layer in range(layers):
            torch.testing.assert_close(torch.stack(got[layer]), want[layer], atol=1e-4, rtol=0)


def test_telemetry_bill_counts_every_expert():
    """The roofline model bills every expert's weights (streamed bytes
    and FLOP parameters), as the JAX model does: not a routed-FLOP
    count."""
    cfg, tp, jcfg, jp = pair()
    got = ttel.TelemetryModel(cfg, tp)
    want = jtel.TelemetryModel(jcfg, jp, hbm_gbps=3350.0, peak_tflops=989.0)
    for key in ("stream_bytes", "lm_head_bytes", "embed_row_bytes", "n_flop_params"):
        assert getattr(got, key) == getattr(want, key), key
    experts = sum(tp["layers"][n].numel() for n in ("gate_proj", "up_proj", "down_proj"))
    assert got.n_flop_params > experts


def test_load_moe_checkpoint_like_jax(tmp_path):
    """An MoE ``config.json`` beside dense-named shards: both loaders
    refuse it with the same message (neither package maps expert keys);
    without MLP tensors both name the same missing leaves."""
    cfg = moe_config()
    d = dataclasses.asdict(cfg)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "mixtral", "vocab_size": d["vocab_size"],
        "hidden_size": d["hidden_size"], "intermediate_size": d["intermediate_size"],
        "num_hidden_layers": d["num_hidden_layers"],
        "num_attention_heads": d["num_attention_heads"],
        "num_key_value_heads": d["num_key_value_heads"], "head_dim": d["head_dim"],
        "num_local_experts": E, "num_experts_per_tok": K_TOP, "tie_word_embeddings": True}))
    rng = np.random.default_rng(0)
    h, i = cfg.hidden_size, cfg.intermediate_size
    base = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, h)),
            "model.norm.weight": np.ones(h)}
    for n in range(cfg.num_hidden_layers):
        base[f"model.layers.{n}.self_attn.q_proj.weight"] = rng.standard_normal((64, h))
    base = {k: v.astype(np.float32) for k, v in base.items()}

    def outcome(load):
        with pytest.raises(ValueError) as e:
            load()
        return str(e.value)

    def both():
        t = outcome(lambda: tloading.load_model(tmp_path, dtype=torch.float32, device="cpu"))
        j = outcome(lambda: jloading.load_params(tmp_path, dtype=jnp.float32, use_native=False))
        return t, j

    save_file(base, str(tmp_path / "model.safetensors"))
    t, j = both()
    assert t == j and t.startswith("checkpoint incomplete")
    base["model.layers.0.mlp.up_proj.weight"] = rng.standard_normal((i, h)).astype(np.float32)
    save_file(base, str(tmp_path / "model.safetensors"))
    t, j = both()
    assert "checkpoint shape" in j and t.endswith(j)  # the port names the shard first

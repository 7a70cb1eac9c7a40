"""The port's mesh (``llm_np_cp_tpu_torch.parallel.sharding`` and the
tensor- and data-parallel forward and Generator) against the JAX
package's, on the CPU in float32.

The spec functions and the local shards need no processes: ``P`` trees
equal JAX's PartitionSpecs entry for entry, and each rank's shards from
``local_shards`` equal the ``addressable_shards`` JAX places on the
8-device virtual CPU mesh (int8 and int4 payloads included).

The mesh itself runs as spawned gloo ranks (``parallel.launch``), once
per world size for this module: a module fixture runs every case of the
world (``mesh_ranks.run_cases``, which imports no JAX) and returns what
the ranks saw.  Each case is held against the JAX package's single
device run at the JAX mesh test's own tolerance (``tests/test_sharding.py``:
logits within 2e-4 / 1e-3); greedy tokens must be equal, min-p tokens
equal up to the JAX side's first near-tie (``sampled_parity``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import generate as jgen
from llm_np_cp_tpu.cache import KVCache as JKVCache
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.parallel import sharding as jsh
from llm_np_cp_tpu.quant import quantize_params as jquantize_params
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.parallel import sharding as tsh
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from mesh_ranks import run_cases
from sampled_parity import assert_prefix_parity, generate_margins


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-4, 1e-3  # tests/test_sharding.py's


def shardable(model_type="llama", **kw):
    """Dims divisible by model=4: heads 8, KV heads 4, I 128, V 256 (the
    JAX mesh test's ``shardable_tiny``)."""
    return tiny_config(model_type, num_attention_heads=8, num_key_value_heads=4,
                       head_dim=8, hidden_size=64, **kw)


def gemma_fallback():
    """Gemma-2's KV heads (2) below the TP degree (4): replicated KV."""
    return tiny_config("gemma2", num_attention_heads=8, num_key_value_heads=2, head_dim=8)


def moe_tiny():
    return tiny_config("llama", num_attention_heads=8, num_key_value_heads=4, head_dim=8,
                       num_local_experts=4, num_experts_per_tok=2)


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


def jcfg_of(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def pair(cfg, seed):
    """(port params, JAX params) on the same numpy weights."""
    npp = np_params(cfg, seed)
    return params_from_jax(npp, device="cpu"), jax.tree.map(jnp.asarray, npp)


def ids(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ----------------------------------------------------------------------
# Plans and specs (no processes)
# ----------------------------------------------------------------------

VALID_SPECS = ["1,1,2", "2,1,2", "data=2,model=2", "seq=4", "data=2,pipe=2,model=2",
               "expert=2,model=2", "1,2,2,"]
MALFORMED_SPECS = ["1,2", "data=2,foo=1", "a,b,c", "model=x", "", "1,2,3,4", "data=2,3"]


@pytest.mark.parametrize("text", VALID_SPECS)
def test_parse_mesh_spec_matches_jax(text):
    assert dataclasses.asdict(tsh.parse_mesh_spec(text)) == dataclasses.asdict(
        jsh.parse_mesh_spec(text))


@pytest.mark.parametrize("text", MALFORMED_SPECS)
def test_parse_mesh_spec_rejects_like_jax(text):
    with pytest.raises(SystemExit) as want:
        jsh.parse_mesh_spec(text)
    with pytest.raises(SystemExit) as got:
        tsh.parse_mesh_spec(text)
    assert str(got.value.code) == str(want.value.code)


VALIDATE = {
    "model8_heads4": (lambda: tiny_config("llama"), dict(model=8)),
    "model4_ok": (shardable, dict(model=4)),
    "model3_heads": (shardable, dict(model=3)),
    "pipe2_layers3": (shardable, dict(pipe=2)),
    "expert2_dense": (shardable, dict(expert=2)),
    "expert3_moe": (moe_tiny, dict(expert=3)),
    "expert2_moe": (moe_tiny, dict(expert=2)),
}


@pytest.mark.parametrize("case", list(VALIDATE), ids=list(VALIDATE))
def test_plan_validate_matches_jax(case):
    make_cfg, plan_kw = VALIDATE[case]
    cfg = make_cfg()

    def outcome(sh, c):
        try:
            sh.MeshPlan(**plan_kw).validate(c)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tsh, cfg) == outcome(jsh, jcfg_of(cfg))
    assert tsh.MeshPlan(**plan_kw).num_devices == jsh.MeshPlan(**plan_kw).num_devices


SPEC_CONFIGS = {"llama": shardable, "gemma2": gemma_fallback,
                "qwen2_bias": lambda: shardable("qwen2"),
                "mlp_bias_untied": lambda: shardable(mlp_bias=True, tie_word_embeddings=False),
                "moe": moe_tiny}
SPEC_PLANS = {"model2": dict(model=2), "model4": dict(model=4), "data2_model2": dict(
    data=2, model=2), "seq2_model2": dict(seq=2, model=2), "pipe2": dict(pipe=2, model=2),
    "expert2": dict(expert=2, model=2)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _cache_fields(spec) -> dict:
    if isinstance(spec, dict):
        return spec
    return {f: getattr(spec, f) for f in ("k", "v", "valid", "length", "k_scale", "v_scale")
            if hasattr(spec, f)}


def _as_tuple(spec):
    return None if spec is None else tuple(spec)


# expert parallelism only for the MoE config (validate refuses it elsewhere)
SPEC_CASES = [(m, p) for m in SPEC_CONFIGS for p in SPEC_PLANS
              if p != "expert2" or m == "moe"]


@pytest.mark.parametrize("model,plan", SPEC_CASES, ids=[f"{m}-{p}" for m, p in SPEC_CASES])
def test_specs_match_jax(model, plan):
    """``param_specs``, ``cache_specs`` (plain and int8), ``paged_kv_specs``
    and ``batch_spec``: the same entries as JAX's PartitionSpecs."""
    cfg = SPEC_CONFIGS[model]()
    jplan, tplan = jsh.MeshPlan(**SPEC_PLANS[plan]), tsh.MeshPlan(**SPEC_PLANS[plan])
    jcfg = jcfg_of(cfg)
    want = dict(_leaves(jsh.param_specs(jcfg, jplan)))
    got = dict(_leaves(tsh.param_specs(cfg, tplan)))
    assert got.keys() == want.keys()
    for name in want:
        assert isinstance(got[name], tsh.P)
        assert tuple(got[name]) == tuple(want[name]), name
    for q in (False, True):
        jc = _cache_fields(jsh.cache_specs(jcfg, jplan, quantized=q))
        tc = tsh.cache_specs(cfg, tplan, quantized=q)
        assert {k: _as_tuple(v) for k, v in tc.items()} == {
            k: _as_tuple(v) for k, v in jc.items()}
        jp = jsh.paged_kv_specs(jcfg, jplan, quantized=q)
        tp = tsh.paged_kv_specs(cfg, tplan, quantized=q)
        assert {k: _as_tuple(v) for k, v in tp.items()} == {
            k: _as_tuple(getattr(jp, k)) for k in ("k", "v", "k_scale", "v_scale")}
    assert tuple(tsh.batch_spec(tplan)) == tuple(jsh.batch_spec(jplan))
    assert tsh.kv_heads_shardable(cfg, tplan) == jsh.kv_heads_shardable(jcfg, jplan)


def test_normalize_specs_matches_jax():
    from jax.sharding import PartitionSpec

    tree = {"a": tsh.P(None, "model", None), "b": {"c": tsh.P(None, None)}, "d": tsh.P()}
    jtree = {"a": PartitionSpec(None, "model", None), "b": {"c": PartitionSpec(None, None)},
             "d": PartitionSpec()}
    got, want = tsh.normalize_specs(tree), jsh.normalize_specs(jtree)
    assert {k: tuple(v) for k, v in _leaves(got)} == {k: tuple(v) for k, v in _leaves(want)}
    assert repr(tsh.P(None, "model")) == "P(None, 'model')"


SHARD_CASES = {
    "llama_model4": (shardable, dict(model=4), None),
    "llama_data2_model2_int8": (shardable, dict(data=2, model=2), dict(bits=8)),
    "llama_model2_int4": (shardable, dict(model=2), dict(bits=4)),
    "llama_model4_int4": (shardable, dict(model=4), dict(bits=4)),
    "gemma_model4_int8_a8": (gemma_fallback, dict(model=4), dict(bits=8, act_quant=True)),
    "untied_seq2_model4": (lambda: shardable(tie_word_embeddings=False, mlp_bias=True),
                           dict(seq=2, model=4), None),
    "qwen2_o_bias_model4": (lambda: shardable("qwen2", attention_out_bias=True), dict(model=4),
                            None),
}


@pytest.mark.parametrize("case", list(SHARD_CASES), ids=list(SHARD_CASES))
def test_local_shards_match_jax_addressable_shards(case):
    """Every rank's shards (``local_shards`` at its mesh coordinate):
    each leaf's shape and values equal the shard JAX's ``shard_params``
    puts on the device at that coordinate."""
    make_cfg, plan_kw, quant = SHARD_CASES[case]
    cfg = make_cfg()
    npp = np_params(cfg, 3)
    jp = jax.tree.map(jnp.asarray, npp)
    if quant is not None:
        jp = jquantize_params(jp, **quant)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jplan, tplan = jsh.MeshPlan(**plan_kw), tsh.MeshPlan(**plan_kw)
    mesh = jsh.make_mesh(jplan)
    placed = jsh.shard_params(jp, jcfg_of(cfg), jplan, mesh)
    devices = np.asarray(mesh.devices)
    by_coord = {}
    checked = 0
    for name, arr in _leaves(placed):
        for shard in arr.addressable_shards:
            coord = tuple(int(c) for c in np.argwhere(devices == shard.device)[0])
            coords = dict(zip(tsh.MESH_AXES, coord))
            if coord not in by_coord:
                by_coord[coord] = dict(_leaves(tsh.local_shards(tp, cfg, tplan, coords)))
            local = by_coord[coord][name]
            want = np.asarray(shard.data)
            assert tuple(local.shape) == want.shape, (name, coords)
            assert local.is_contiguous()
            np.testing.assert_array_equal(local.numpy(), want, err_msg=f"{name} {coords}")
            checked += 1
    assert checked >= tplan.num_devices * len(param_shapes(cfg)["layers"])


def test_int4_row_parallel_shard_needs_whole_bytes():
    """An int4 ``o_proj`` packs two rows a byte along its row-parallel
    axis: a plan that would split a byte raises."""
    cfg = tiny_config("llama", num_attention_heads=6, num_key_value_heads=6, head_dim=1,
                      hidden_size=16, intermediate_size=24, vocab_size=48)
    from llm_np_cp_tpu_torch.quant import quantize_params

    tp = quantize_params(params_from_jax(np_params(cfg, 0), device="cpu"), bits=4)
    with pytest.raises(ValueError, match="int4 payload packs two rows a byte"):
        tsh.local_shards(tp, cfg, tsh.MeshPlan(model=6), dict.fromkeys(tsh.MESH_AXES, 0))


def test_moe_under_tensor_parallelism_names_item_8b():
    cfg = moe_tiny()
    tp, _ = pair(cfg, 0)
    mesh = tsh.Mesh(plan=tsh.MeshPlan(model=2), device_mesh=None,
                    device=torch.device("cpu"), backend="gloo",
                    coords=dict.fromkeys(tsh.MESH_AXES, 0))
    with pytest.raises(NotImplementedError, match="item 8c"):
        tsh.shard_params(tp, cfg, mesh.plan, mesh)


def test_make_mesh_refuses_more_cards_than_the_host_has():
    """On CUDA a plan needs a card a rank unless the caller places the
    ranks and names gloo: JAX's message, before any process group."""
    plan = tsh.MeshPlan(data=2, model=4)
    have = torch.cuda.device_count()
    assert tsh.device_count_error(plan, None, None) == f"plan needs 8 devices, have {have}"
    with pytest.raises(ValueError, match="devices"):
        tsh.make_mesh(plan)
    with pytest.raises(ValueError, match="devices"):
        jsh.make_mesh(jsh.MeshPlan(data=4, model=4))
    assert tsh.device_count_error(plan, "cuda:0", "gloo") is None
    assert tsh.device_count_error(plan, "cuda:0", "nccl") is not None
    assert tsh.device_count_error(plan, "cpu", None) is None


def test_run_ranks_takes_host_tensors_only():
    """A tensor off the CPU among the ranks' arguments raises before any
    rank starts, naming where it sits (the CLI hands its params over from
    the CPU)."""
    params = {"embed": torch.zeros(2), "layers": {"w": torch.zeros(2, device="meta")}}
    with pytest.raises(ValueError, match=r"args\[0\]\['layers'\]\['w'\] is a meta tensor"):
        run_ranks(print, 2, params)


# ----------------------------------------------------------------------
# The mesh: spawned gloo ranks, one group per world size
# ----------------------------------------------------------------------

LLAMA = shardable()
GEMMA = gemma_fallback()
QWEN = shardable("qwen2", attention_out_bias=True)  # o_bias: added after the reduce
# 12 heads on 3 KV heads over model=2: rank 0's 6 query heads group onto
# KV heads 0 (four) and 1 (two), unevenly
UNEVEN = tiny_config("llama", num_attention_heads=12, num_key_value_heads=3, head_dim=8)
W = {"llama": pair(LLAMA, 1), "gemma": pair(GEMMA, 2), "qwen": pair(QWEN, 4),
     "uneven": pair(UNEVEN, 5)}
CFG = {"llama": LLAMA, "gemma": GEMMA, "qwen": QWEN, "uneven": UNEVEN}
A8 = dict(bits=8, act_quant=True)
FWD_IDS = ids(LLAMA, (2, 6), 0)
PROMPT = np.array([[3, 1, 4, 1, 5]], dtype=np.int32)
PROMPTS2 = ids(LLAMA, (2, 7), 5)
PROMPTS4 = ids(LLAMA, (4, 7), 6)
MIN_P = dict(kind="min_p", p_base=0.05, temperature=0.8)
NEW = 8


def _fwd(name, plan, model="llama", x=FWD_IDS, **kw):
    return (name, "forward", dict(plan=plan, params=W[model][0], cfg=CFG[model], ids=x, **kw))


def _gen(name, plan, prompts, sampler=None, **kw):
    return (name, "generate", dict(plan=plan, params=W["llama"][0], cfg=LLAMA, prompts=prompts,
                                   new_tokens=NEW, sampler_kw=sampler or dict(kind="greedy"),
                                   **kw))


CASES = {
    2: [
        _fwd("tp_model2", dict(model=2)),
        _gen("minp_data2", dict(data=2), PROMPTS4, MIN_P, seed=7),
        _gen("greedy_data2_batch1", dict(data=2), PROMPT),
        _fwd("uneven_kv_groups_model2", dict(model=2), "uneven", ids(UNEVEN, (2, 5), 2)),
        _fwd("w8a8_model2", dict(model=2), quantize=A8),
    ],
    4: [
        _fwd("tp_model4", dict(model=4)),
        _fwd("tp_data2_model2", dict(data=2, model=2)),
        _fwd("gemma_fallback_model4", dict(model=4), "gemma", ids(GEMMA, (1, 3), 0)),
        _fwd("qwen_bias_data2_model2", dict(data=2, model=2), "qwen", ids(QWEN, (2, 6), 1)),
        ("tp_cached_decode", "cached", dict(plan=dict(model=4), params=W["llama"][0], cfg=LLAMA,
                                            ids=np.array([[5, 9, 2, 7]], np.int32),
                                            steps=np.array([[3]], np.int32), capacity=12)),
        _gen("greedy_model4", dict(model=4), PROMPT),
        _gen("greedy_model4_kernels", dict(model=4), PROMPTS2, prefill_attn_impl="flash",
             decode_attn_impl="flash_decode"),
        _gen("greedy_data2_model2", dict(data=2, model=2), PROMPTS2),
        _gen("greedy_seq2_model2_ring", dict(seq=2, model=2), PROMPTS2,
             prefill_attn_impl="ring"),
        _gen("greedy_data2_model2_int8", dict(data=2, model=2), PROMPTS2,
             quantize=dict(bits=8)),
        _gen("minp_data2_model2", dict(data=2, model=2), PROMPTS4, MIN_P, seed=9),
    ],
}


def _spawn(world):
    out = run_ranks(run_cases, world, CASES[world])
    assert len(out) == world
    return out


@pytest.fixture(scope="module")
def world2():
    return _spawn(2)


@pytest.fixture(scope="module")
def world4():
    return _spawn(4)


@pytest.fixture
def ranks(request):
    return request.getfixturevalue(request.param)


def _same_on_every_rank(ranks, name):
    """Rank 0's result of case ``name``, after checking that every rank
    returned the same arrays."""
    first = ranks[0][name]
    for r in ranks[1:]:
        got = r[name]
        for key in (first if isinstance(first, dict) else [None]):
            a, b = (got, first) if key is None else (got[key], first[key])
            for x, y in zip(*((a, b) if isinstance(b, list) else ([a], [b]))):
                if isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=name)
    return first


def _jax_logits(model, x):
    return np.asarray(jtf.forward(W[model][1], jnp.asarray(x), jcfg_of(CFG[model]))[0])


FWD = [("world4", "tp_model4", "llama"), ("world4", "tp_data2_model2", "llama"),
       ("world2", "tp_model2", "llama"), ("world4", "qwen_bias_data2_model2", "qwen")]


@pytest.mark.parametrize("ranks,name,model", FWD, ids=[f[1] for f in FWD], indirect=["ranks"])
def test_tp_forward_matches_single_device(ranks, name, model):
    """Tensor (and data) parallel cache-less logits equal the JAX single
    device forward's; o_proj's and down_proj's partial sums are reduced
    once a layer each, the embedding once and the logits gathered once."""
    got = _same_on_every_rank(ranks, name)
    x = next(c for c in CASES[len(ranks)] if c[0] == name)[2]["ids"]
    np.testing.assert_allclose(got, _jax_logits(model, x), atol=ATOL, rtol=RTOL)
    coll = ranks[0][name + "/collectives"]
    layers = CFG[model].num_hidden_layers
    assert coll["all_reduce"]["calls"] == 2 * layers + 1
    assert coll["all_gather"]["calls"] >= 1 and coll["all_reduce"]["staged"] == 0


def test_tp_cached_decode_matches_single_device(world4):
    """KV heads (4) divide model (4): each rank's cache holds one head;
    prefill and one cached decode step equal JAX's, and so does the cache."""
    got = _same_on_every_rank(world4, "tp_cached_decode")
    jcfg = jcfg_of(LLAMA)
    jp = W["llama"][1]
    cache = JKVCache.init(jcfg, 1, 12, dtype=jnp.float32)
    want1, cache = jtf.forward(jp, jnp.asarray([[5, 9, 2, 7]], jnp.int32), jcfg, cache)
    want2, cache = jtf.forward(jp, jnp.asarray([[3]], jnp.int32), jcfg, cache)
    np.testing.assert_allclose(got["logits"][0], np.asarray(want1), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["logits"][1], np.asarray(want2), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["k"][:, :, :4], np.asarray(cache.k)[:, :, :4], atol=ATOL,
                               rtol=RTOL)
    assert got["length"] == int(cache.length)


def test_gemma_kv_heads_not_divisible_falls_back(world4):
    """Gemma-2's 2 KV heads on a 4-way model axis: the specs replicate
    the KV heads, each rank attends with the one its query heads group
    onto, and the logits equal JAX's single device run."""
    specs = tsh.param_specs(GEMMA, tsh.MeshPlan(model=4))
    assert specs["layers"]["k_proj"][2] is None and specs["layers"]["q_proj"][2] == "model"
    assert tsh.cache_specs(GEMMA, tsh.MeshPlan(model=4))["k"][3] is None
    got = _same_on_every_rank(world4, "gemma_fallback_model4")
    np.testing.assert_allclose(got, _jax_logits("gemma", ids(GEMMA, (1, 3), 0)), atol=ATOL,
                               rtol=RTOL)


def test_uneven_kv_groups_attend_their_own_heads(world2):
    """Replicated KV heads that a rank's query heads group onto unevenly
    (``kv_head_select`` gives a head a query head): JAX's logits."""
    got = _same_on_every_rank(world2, "uneven_kv_groups_model2")
    np.testing.assert_allclose(got, _jax_logits("uneven", ids(UNEVEN, (2, 5), 2)), atol=ATOL,
                               rtol=RTOL)


def test_w8a8_row_parallel_quantizes_rows_over_every_rank(world2):
    """W8A8 under tensor parallelism: a row-parallel projection quantizes
    each row by the absmax over every rank's columns (one all-reduce of
    the maxima), so the logits stay within one int8 step's flip of the
    JAX package's single device run (``tests/test_torch_quant.py``'s
    bound for the a8 modes)."""
    got = _same_on_every_rank(world2, "w8a8_model2")
    jp = jquantize_params(W["llama"][1], **A8)
    want = np.asarray(jtf.forward(jp, jnp.asarray(FWD_IDS), jcfg_of(LLAMA))[0])
    diff = np.abs(got - want)
    assert diff.max() <= 0.1 and diff.mean() <= 5e-3, (diff.max(), diff.mean())
    coll = world2[0]["w8a8_model2/collectives"]
    layers = LLAMA.num_hidden_layers
    assert coll["all_reduce"]["calls"] == 4 * layers + 1  # sums and row maxima


def _jax_tokens(prompts, sampler=None, seed=0, quantize=None):
    jp = W["llama"][1]
    if quantize is not None:
        jp = jquantize_params(jp, **quantize)
    js = JSampler(**(sampler or dict(kind="greedy")))
    g = jgen.Generator(jp, jcfg_of(LLAMA), sampler=js, cache_dtype=jnp.float32)
    return g.generate(prompts, NEW, seed=seed).tokens, js, jp


GREEDY = [("world4", "greedy_model4", PROMPT, None),
          ("world4", "greedy_model4_kernels", PROMPTS2, None),
          ("world4", "greedy_data2_model2", PROMPTS2, None),
          ("world4", "greedy_seq2_model2_ring", PROMPTS2, None),
          ("world4", "greedy_data2_model2_int8", PROMPTS2, dict(bits=8)),
          ("world2", "greedy_data2_batch1", PROMPT, None)]


@pytest.mark.parametrize("ranks,name,prompts,quant", GREEDY, ids=[g[1] for g in GREEDY],
                         indirect=["ranks"])
def test_tp_generation_token_parity(ranks, name, prompts, quant):
    """Greedy tokens of ``Generator(mesh=)`` under TP, DP x TP, SP x TP
    (ring prefill), int8 DP x TP, and a batch that does not divide over
    "data" (every data rank runs it): equal to the JAX Generator's on one
    device, on every rank.  The fused epilogue is the tail (merged over
    the vocab shards) and each decode step is built to run eagerly."""
    got = _same_on_every_rank(ranks, name)
    want, _, _ = _jax_tokens(prompts, quantize=quant)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    assert got["epilogue"] == "fused"
    assert got["counts"] == {"decode_step": 0, "decode_step_eager": 1}


@pytest.mark.parametrize("ranks,name,seed", [("world2", "minp_data2", 7),
                                             ("world4", "minp_data2_model2", 9)],
                         ids=["data2", "data2_model2"], indirect=["ranks"])
def test_min_p_tokens_under_data_parallelism(ranks, name, seed):
    """Each data rank draws its rows' share of the whole batch's
    threefry bits (``row0``): min-p tokens equal the JAX Generator's,
    each row up to the JAX side's first near-tie."""
    got = _same_on_every_rank(ranks, name)
    want, js, jp = _jax_tokens(PROMPTS4, MIN_P, seed)
    margins = generate_margins(jp, jcfg_of(LLAMA), js, PROMPTS4, np.asarray(want), seed)
    assert assert_prefix_parity(np.asarray(want), got["tokens"], margins, name) > 0

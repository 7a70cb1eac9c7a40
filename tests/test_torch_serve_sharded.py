"""The port's tensor-parallel ServeEngine (``ServeEngine(mesh_plan=
MeshPlan(model=N))``) against the JAX package's single-chip engine, on
the CPU in float32: the ported counterparts of ``tests/test_serve_sharded.py``.

The port is one process a rank: every rank of a spawned gloo group
(``parallel.launch.run_ranks``, one group per world size for this
module, the two groups and the JAX references running at once) builds
the engine over the full numpy weights, cuts its own shards, and serves
the same submissions (``mesh_ranks.serve_case``, which imports no JAX).
Both packages' engines run on a ``TickClock``, so arrivals follow the
trace.  The bar is the JAX file's: greedy token streams identical to the
single chip's, exactly, for the unified tick at TP 2 and 4, the
phase-split paged tick, int8 pools with their scale pages sharded,
prefix sharing (equal hit counts), Gemma-2's replicated KV heads, abort
and supervised recovery; the slabs really partitioned
(``kv_bytes_shard x TP == kv_bytes_total``); the steps eager (no graph
captured); the plan refusals.  Where the port differs on purpose: a
replicated-KV rank's pool holds only the KV heads its query heads read
(the JAX pool holds them all and reports one shard), the greedy tail
stays the fused epilogue under TP, and ranks that plan differently
raise at the tick digest instead of hanging.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.generate import Generator as JGenerator
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan
from mesh_ranks import run_cases
from tick_clock import clocked

pytestmark = pytest.mark.mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shardable_tiny(model_type="llama", **kw):
    """The JAX file's config: dims divisible by model=4 (heads 8, KV 4)."""
    kw.setdefault("num_attention_heads", 8)
    kw.setdefault("num_key_value_heads", 4)
    kw.setdefault("head_dim", 8)
    kw.setdefault("hidden_size", 64)
    return tiny_config(model_type, **kw)


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


def trace_of(cfg, n=32, seed=0, **kw):
    """The JAX file's ``_trace``."""
    kw.setdefault("prompt_len_range", (3, 14))
    kw.setdefault("max_new_tokens", 6)
    return serve.poisson_trace(np.random.default_rng(seed), n, rate_rps=40.0,
                               vocab_size=cfg.vocab_size, **kw)


def prompts_of(seed, sizes, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in sizes]


LLAMA = shardable_tiny()
GEMMA = shardable_tiny("gemma2", num_key_value_heads=2)  # 2 KV heads < TP 4
# 12 heads on 3 KV heads over model=2: a rank's 6 query heads group onto
# two KV heads unevenly (four and two), so its pool holds one KV head a
# query head
UNEVEN = tiny_config("llama", num_attention_heads=12, num_key_value_heads=3, head_dim=8)
WEIGHTS = {"llama": (LLAMA, 0), "gemma": (GEMMA, 2), "uneven": (UNEVEN, 4)}
NPP = {name: np_params(cfg, seed) for name, (cfg, seed) in WEIGHTS.items()}

# the JAX file's _engine defaults
GEOMETRY = dict(max_slots=4, num_blocks=48, block_size=8, max_seq_len=64)
# leg → (mixed_step, decode_attn_impl), the same on both packages
LEGS = {"mixed": ("on", "xla"), "split_paged": ("off", "paged")}

TRACE32 = trace_of(LLAMA)
SPLIT16 = trace_of(LLAMA, n=16)
GEMMA8 = trace_of(GEMMA, n=8, seed=3)
UNEVEN12 = trace_of(UNEVEN, n=12, seed=6, prompt_len_range=(18, 30), distinct_prompts=3)
PREFIX24 = trace_of(LLAMA, n=24, seed=5, prompt_len_range=(18, 30), distinct_prompts=4)
OFFLINE = prompts_of(11, (6, 11, 4), LLAMA.vocab_size)
RECOVER = prompts_of(9, (7, 12, 5), LLAMA.vocab_size)


def engine_kw(leg="mixed", **kw):
    mixed, impl = LEGS[leg]
    return {**GEOMETRY, "mixed_step": mixed, "decode_attn_impl": impl, **kw}


def case(name, tp, weights, **kw):
    cfg = WEIGHTS[weights][0]
    return (name, "serve", dict(plan=dict(model=tp), params=NPP[weights], cfg=cfg, **kw))


CASES = {
    2: [
        case("trace32", 2, "llama", engine_kw=engine_kw(), trace=TRACE32),
        case("offline_float32", 2, "llama", engine_kw=engine_kw(max_slots=3, num_blocks=32),
             prompts=OFFLINE, max_new=5, script="submit"),
        case("offline_int8", 2, "llama", prompts=OFFLINE, max_new=5, script="submit",
             engine_kw=engine_kw(max_slots=3, num_blocks=32, cache_dtype="int8")),
        case("prefix24", 2, "llama", trace=PREFIX24,
             engine_kw=engine_kw(enable_prefix_cache=True, num_blocks=64)),
        case("uneven_mixed", 2, "uneven", trace=UNEVEN12,
             engine_kw=engine_kw(enable_prefix_cache=True, num_blocks=64)),
        case("uneven_split_paged", 2, "uneven", trace=UNEVEN12,
             engine_kw=engine_kw("split_paged", enable_prefix_cache=True, num_blocks=64)),
        case("abort_recover", 2, "llama", engine_kw=engine_kw(), prompts=RECOVER,
             script="abort_recover"),
        case("refusals", 2, "llama", engine_kw=engine_kw(), prompts=OFFLINE[:1], max_new=2,
             script="refusals"),
        # last: the ranks part on purpose
        case("diverge", 2, "llama", engine_kw=engine_kw(), prompts=OFFLINE, max_new=3,
             script="diverge", diverge_rank=1),
    ],
    4: [
        case("trace32", 4, "llama", engine_kw=engine_kw(), trace=TRACE32),
        case("split_paged16", 4, "llama", engine_kw=engine_kw("split_paged"), trace=SPLIT16),
        case("gemma8", 4, "gemma", engine_kw=engine_kw(), trace=GEMMA8),
    ],
}


def jax_pair(weights):
    cfg = WEIGHTS[weights][0]
    return (jconfig.ModelConfig(**dataclasses.asdict(cfg)),
            jax.tree.map(jnp.asarray, NPP[weights]))


def jax_engine(weights, leg="mixed", **kw):
    """The JAX package's single-chip engine with the JAX file's geometry."""
    jcfg, jp = jax_pair(weights)
    mixed, impl = LEGS[leg]
    kw = {**GEOMETRY, **kw}
    return clocked(jserve.ServeEngine, jp, jcfg, sampler=JSampler("greedy"), mixed_step=mixed,
                   decode_attn_impl=impl, cache_dtype=kw.pop("cache_dtype", jnp.float32), **kw)


def jax_tokens(engine):
    return {r.req_id: list(r.generated) for r in engine.scheduler.finished}


def jax_replay(weights, trace, leg="mixed", **kw):
    engine = jax_engine(weights, leg, **kw)
    snap = engine.replay_trace(trace)
    return jax_tokens(engine), snap


def jax_offline(cache_dtype):
    """JAX ``generate_ragged``, one prompt at a time (the JAX file's bar)."""
    jcfg, jp = jax_pair("llama")
    gen = JGenerator(jp, jcfg, sampler=JSampler(kind="greedy"), cache_dtype=cache_dtype)
    return {j: [int(t) for t in np.asarray(gen.generate_ragged([p], 5, seed=j).tokens)[0][:5]]
            for j, p in enumerate(OFFLINE)}


def jax_recover():
    """The uninterrupted single chip over the survivors (requests 0, 2)."""
    engine = jax_engine("llama")
    for j, p in enumerate(RECOVER):
        if j != 1:
            engine.submit(p, 6, seed=j)
    engine.run_until_complete()
    return {tuple(r.generated) for r in engine.scheduler.finished}


def jax_references():
    return {
        "trace32": jax_replay("llama", TRACE32),
        "split_paged16": jax_replay("llama", SPLIT16, "split_paged"),
        "gemma8": jax_replay("gemma", GEMMA8),
        "prefix24": jax_replay("llama", PREFIX24, enable_prefix_cache=True, num_blocks=64),
        "uneven_mixed": jax_replay("uneven", UNEVEN12, enable_prefix_cache=True, num_blocks=64),
        "uneven_split_paged": jax_replay("uneven", UNEVEN12, "split_paged",
                                         enable_prefix_cache=True, num_blocks=64),
        "offline_float32": jax_offline(jnp.float32),
        "offline_int8": jax_offline(jnp.int8),
        "abort_recover": jax_recover(),
    }


@pytest.fixture(scope="module")
def runs():
    """``{world: [rank results]}`` for worlds 2 and 4, spawned at once,
    and the JAX references (computed here meanwhile)."""
    worlds, errors = {}, []

    def spawn(world):
        try:
            worlds[world] = run_ranks(run_cases, world, CASES[world])
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in CASES]
    for t in threads:
        t.start()
    try:
        refs = jax_references()
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return worlds, refs


def result(runs, world, name):
    """Rank 0's result of a case, after checking that every rank served
    the same tokens."""
    ranks = runs[0][world]
    first = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["tokens"] == first["tokens"], f"{name}: ranks disagree"
    return first


# ---------------------------------------------------------------------------
# The acceptance criterion: token parity, TP vs the JAX single chip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_trace_parity_32_requests(runs, tp):
    got = result(runs, tp, "trace32")
    want, _ = runs[1]["trace32"]
    assert got["snapshot"]["finished"] == 32
    assert got["tokens"] == want
    # the unified tick over the ragged kernel's path, the fused tail
    assert got["mixed"] and got["epilogue"] == "fused"
    assert got["mesh_desc"] == f"tp={tp} over {tp} gloo ranks on cpu (kv-sharded)"


def test_tp_phase_split_parity(runs):
    got = result(runs, 4, "split_paged16")
    want, _ = runs[1]["split_paged16"]
    assert not got["mixed"]
    assert got["tokens"] == want
    assert got["counts"] == {"decode_step": 0, "decode_step_eager": 1}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tp_offline_parity_and_int8(runs, dtype):
    """TP 2 serving == the JAX package's offline ``generate_ragged``, and
    an int8 pool's scale pages shard with its KV heads."""
    got = result(runs, 2, f"offline_{dtype}")
    want = runs[1][f"offline_{dtype}"]
    assert got["tokens"] == want, f"dtype={dtype} diverged"
    k, v, ks, vs = got["page_shapes"]
    cfg = LLAMA
    assert k == v == (cfg.num_hidden_layers, 32, 8, cfg.num_key_value_heads // 2, cfg.head_dim)
    if dtype == "int8":
        assert ks == vs == k[:-1], "int8 scale pages must shard with the kv heads"
    else:
        assert ks is vs is None


def test_gemma_sliding_window_kv_replicated_parity(runs):
    """Gemma-2's 2 KV heads under TP 4: the heads replicate, each rank's
    pool holds the one its two query heads read, both paged kernels'
    paths stay (no plain attention), and tokens match the single chip.
    The port's stats differ from the JAX pool's (which holds every head
    and reports one shard): two distinct shards, each on two ranks."""
    cfg = GEMMA
    assert cfg.sliding_window is not None
    got = result(runs, 4, "gemma8")
    want, _ = runs[1]["gemma8"]
    assert got["mesh_desc"].endswith("(kv-replicated)")
    assert got["mixed"] and got["epilogue"] == "fused"
    assert got["tokens"] == want
    st = got["stats"]
    assert st["kv_shards"] == 2
    assert st["kv_bytes_shard"] * 2 == st["kv_bytes_total"]
    assert got["page_shapes"][0][3] == 1


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_uneven_replicated_kv_heads_parity(runs, leg):
    """KV heads a rank's query heads read unevenly (4 and 2): the pool
    holds one KV head a query head, written, gathered and scattered
    through that map; tokens match the single chip with prefix sharing
    on (the phase-split prefill gathers shared blocks back)."""
    got = result(runs, 2, f"uneven_{leg}")
    want, snap = runs[1][f"uneven_{leg}"]
    assert got["tokens"] == want
    assert got["snapshot"]["prefix_blocks_hit"] == snap["prefix_blocks_hit"] > 0
    assert got["page_shapes"][0][3] == UNEVEN.num_attention_heads // 2
    assert got["mesh_desc"].endswith("(kv-replicated)")


def test_tp_prefix_sharing_parity_and_hits(runs):
    """Prefix sharing over sharded slabs: the registry is host-side block
    ids, the same on every rank."""
    got = result(runs, 2, "prefix24")
    want, snap = runs[1]["prefix24"]
    assert got["tokens"] == want
    assert got["snapshot"]["prefix_blocks_hit"] > 0
    assert got["snapshot"]["prefix_blocks_hit"] == snap["prefix_blocks_hit"]


def test_tp_abort_and_recovery_parity(runs):
    """Abort mid-flight, then ``clone_fresh`` + ``recover`` on every
    rank: the survivors' tokens equal the uninterrupted single chip's,
    the clone keeps the mesh, and no block stays held."""
    got = result(runs, 2, "abort_recover")
    assert got["aborted"]
    assert {tuple(t) for t in got["tokens"].values()} == runs[1]["abort_recover"]
    assert got["rebuilt_stats"]["request_held"] == 0
    assert got["rebuilt_desc"] == "tp=2 over 2 gloo ranks on cpu (kv-sharded)"


# ---------------------------------------------------------------------------
# The placement contract: really sharded, really eager, really in lockstep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_slabs_partitioned(runs, tp):
    """Each rank's slabs hold its KV-head share; ``stats`` and
    ``shard_stats`` report ``kv_shards == TP`` and ``kv_bytes_shard x TP
    == kv_bytes_total``, the same on every rank."""
    cfg = LLAMA
    got = result(runs, tp, "trace32")
    assert got["page_shapes"][0] == (cfg.num_hidden_layers, 48, 8,
                                     cfg.num_key_value_heads // tp, cfg.head_dim)
    st = got["stats"]
    assert st["kv_shards"] == tp
    assert st["kv_bytes_shard"] * tp == st["kv_bytes_total"]
    assert {k: st[k] for k in got["shard_stats"]} == got["shard_stats"]
    assert st["request_held"] == 0
    assert all(r["trace32"]["stats"] == st for r in runs[0][tp])
    # the whole logical slab: [L, NB, BS, K, D] float32, K and V
    assert st["kv_bytes_total"] == 2 * cfg.num_hidden_layers * 48 * 8 * \
        cfg.num_key_value_heads * cfg.head_dim * 4


@pytest.mark.parametrize("tp", [2, 4])
def test_eager_ticks_capture_nothing(runs, tp):
    """A multi-rank engine's steps run eagerly (a gloo collective cannot
    be captured): ``compile_counts`` reports them as ``mixed_step_eager``,
    no graph is captured, and every step ran through its collectives
    (the tick digests and the epilogue's pair merge are all-gathers)."""
    got = result(runs, tp, "trace32")
    assert got["counts"]["mixed_step"] == 0
    assert 0 < got["counts"]["mixed_step_eager"] <= len(got["buckets"])
    assert got["captures"] == 0 and all(got["eager_steps"])
    colls = runs[0][tp][0]["trace32/collectives"]
    assert colls["all_reduce"]["calls"] > 0 and colls["all_gather"]["calls"] > 0


def test_ranks_that_plan_differently_raise(runs):
    """Rank 1 submits one prompt a token longer: the first dispatching
    tick's digest differs, and every rank raises naming rank 1 (none
    hangs in a collective paired with another rank's)."""
    for r in runs[0][2]:
        err = r["diverge"]["error"]
        assert "out of lockstep at tick 1" in err and "model rank 1 (global rank 1)" in err


def test_multi_rank_refusals(runs):
    """What a multi-rank engine refuses at the call (item 8c): a
    deadline, ``recover(deadline_at=)`` and a realtime replay."""
    got = result(runs, 2, "refusals")
    assert set(got["refused"]) == {"deadline_s", "deadline_at", "realtime"}
    assert all("item 8c" in msg for msg in got["refused"].values())


def test_mesh_plan_rejects_non_tp_axes():
    """The JAX engine's refusals, before any process group: non-TP axes
    and a plan the config does not divide; then the port's: MoE under TP,
    ``mesh_devices`` and the options whose host decisions would differ
    between ranks (item 8c)."""
    tp = params_from_jax(NPP["llama"], device="cpu")
    kw = dict(**GEOMETRY, cache_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="tensor-parallel only"):
        serve.ServeEngine(tp, LLAMA, mesh_plan=MeshPlan(data=2, model=2), **kw)
    with pytest.raises(ValueError, match="not divisible"):
        serve.ServeEngine(tp, LLAMA, mesh_plan=MeshPlan(model=3), **kw)
    for opt in (dict(spec_k=2, mixed_step="on"), dict(actions=serve.ActionPolicy()),
                dict(fault_injector=serve.FaultInjector("decode@9"))):
        with pytest.raises(NotImplementedError, match="item 8c"):
            serve.ServeEngine(tp, LLAMA, mesh_plan=MeshPlan(model=2), **opt, **kw)
    with pytest.raises(NotImplementedError, match="mesh_devices.*item 8c"):
        serve.ServeEngine(tp, LLAMA, mesh_devices=[0], **kw)
    moe = shardable_tiny(num_local_experts=4, num_experts_per_tok=2)
    with pytest.raises(NotImplementedError, match="item 8c"):
        serve.ServeEngine(params_from_jax(np_params(moe, 0), device="cpu"), moe,
                          mesh_plan=MeshPlan(model=2), **kw)
    # a one-device plan is no mesh
    one = serve.ServeEngine(tp, LLAMA, mesh_plan=MeshPlan(), **kw)
    assert one.mesh is None and one.mesh_desc is None

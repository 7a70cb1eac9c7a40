"""The compiled-step layer of the port against the JAX package, on the CPU.

The port's cache offset lives on the device, and its decode step and the
engine's unified tick are functions over static buffers that the card
captures as CUDA graphs (``graphs.CapturedStep``).  On the CPU the same
functions run eagerly; here they are held against the JAX package on
the same numpy-made weights (tiny llama, gemma2 and qwen2, float32
weights): ``forward`` over prefill then decode steps with float32, bf16
and int8 caches, the static-buffer decode loop and the ``Generator``
(greedy tokens exactly, with and without stop tokens, ``early_stop``,
two calls on one Generator), and the engine's ``compile_counts``.  The
JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import generate as jgen
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu_torch import cache as tcache
from llm_np_cp_tpu_torch import generate as tgen
from llm_np_cp_tpu_torch import graphs, serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models import transformer as ttf
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from tick_clock import clocked


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ["llama", "gemma2", "qwen2"]
# logits: float32 on both sides differ in summation order only (1e-4, as
# in test_torch_model.py); a bf16 or int8 cache rounds each K/V element,
# and a float32 difference can move one across a rounding boundary: one
# step is 2^-8 relative (bf16) or absmax/127 of its token-head row (int8)
ATOL = {"float32": 1e-4, "bfloat16": 1e-2, "int8": 1e-2}
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


def pair(model_type, seed=0):
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config(model_type)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=0)


# ----------------------------------------------------------------------
# the cache offset on the device
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model_type", MODELS)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_forward_device_offset_matches_jax(model_type, cache_dtype):
    """Prefill then six single-token steps: the logits match the JAX
    forward's, and the device offset and host count move together."""
    cfg, tp, jcfg, jp = pair(model_type, 21)
    ids = np.random.default_rng(22).integers(0, cfg.vocab_size, (2, 16))
    tc = tcache.KVCache.init(cfg, 2, 32, getattr(torch, cache_dtype), device="cpu")
    jc = jcache.KVCache.init(jcfg, 2, 32, dtype=getattr(jnp, cache_dtype))
    assert tc.offset.dtype == torch.int32 and tc.offset.ndim == 0
    for lo, hi in ((0, 10),) + tuple((i, i + 1) for i in range(10, 16)):
        got, tc = ttf.forward(tp, torch.as_tensor(ids[:, lo:hi]), cfg, tc, device="cpu")
        want, jc = jtf.forward(jp, jnp.asarray(ids[:, lo:hi]), jcfg, jc)
        _close(got, want, ATOL[cache_dtype])
        assert tc.length == int(tc.offset) == int(jc.length) == hi
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


def test_device_offset_alone_places_the_write():
    """The write slot comes from the device offset, not the host count
    (which only the capacity check reads); truncate moves both."""
    cfg, tp, _, _ = pair("llama", 23)
    ids = torch.as_tensor(np.random.default_rng(24).integers(0, cfg.vocab_size, (1, 5)))
    ref = tcache.KVCache.init(cfg, 1, 16, torch.float32, device="cpu")
    ttf.forward(tp, ids, cfg, ref, device="cpu")
    c = tcache.KVCache.init(cfg, 1, 16, torch.float32, device="cpu")
    c.offset.fill_(3)  # the host count still says 0
    ttf.forward(tp, ids[:, :2], cfg, c, device="cpu")
    assert (c.length, int(c.offset)) == (2, 5)
    assert c.valid[0].tolist() == [False] * 3 + [True] * 2 + [False] * 11
    tcache.truncate(c, 4)
    assert (c.length, int(c.offset)) == (4, 4) and not c.valid[0, 4:].any()
    # a [B] offset (speculative decoding) writes each row at its own slot
    slots = tcache.cache_slots(torch.tensor([0, 3], dtype=torch.int32), 2, 2, 16,
                               torch.device("cpu"))
    assert slots.tolist() == [[0, 1], [3, 4]]


# ----------------------------------------------------------------------
# the static-buffer decode step
# ----------------------------------------------------------------------

def _prefilled(cfg, tp, jcfg, jp, ids, cap):
    """Both caches after the same prefill, and its greedy first token."""
    tc = tcache.KVCache.init(cfg, ids.shape[0], cap, torch.float32, device="cpu")
    jc = jcache.KVCache.init(jcfg, ids.shape[0], cap, dtype=jnp.float32)
    logits, tc = ttf.forward(tp, torch.as_tensor(ids), cfg, tc, logits_last_only=True,
                             device="cpu")
    _, jc = jtf.forward(jp, jnp.asarray(ids), jcfg, jc, logits_last_only=True)
    return tc, jc, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


@pytest.mark.parametrize("model_type", MODELS)
@pytest.mark.parametrize("stops", ["none", "stop", "early_stop"])
def test_decode_loop_matches_jax(model_type, stops):
    """The port's decode loop (the static step, run eagerly here) gives
    the JAX ``make_decode_loop_fn``'s greedy tokens and step count over
    the decode kernel and the fused epilogue."""
    cfg, tp, jcfg, jp = pair(model_type, 25)
    ids = np.random.default_rng(26).integers(0, cfg.vocab_size, (3, 9))
    tc, jc, first = _prefilled(cfg, tp, jcfg, jp, ids, 32)
    stop_tokens = ()
    if stops != "none":  # row 0 stops at its third token
        free, _, _ = tgen.make_decode_loop_fn(cfg, Sampler("greedy"), device="cpu")(
            tp, first, _prefilled(cfg, tp, jcfg, jp, ids, 32)[0], None, 4)
        stop_tokens = (int(free[0, 2]),)
    kw = dict(stop_tokens=stop_tokens, attn_impl="flash_decode",
              early_stop=stops == "early_stop", fused_epilogue=True)
    got, tc, steps = tgen.make_decode_loop_fn(cfg, Sampler("greedy"), device="cpu", **kw)(
        tp, first, tc, None, 12)
    want, _, jsteps = jgen.make_decode_loop_fn(jcfg, JSampler("greedy"), **kw)(
        jp, jnp.asarray(first.numpy()), jc, jax.random.PRNGKey(0), 12)
    np.testing.assert_array_equal(tgen._trim_after_stop(got.numpy(), stop_tokens),
                                  jgen._trim_after_stop(np.asarray(want), stop_tokens))
    assert steps == int(jsteps)
    assert tc.length == int(tc.offset) == 9 + steps
    assert len(tc.steps) == 1


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_fn_matches_jax(fused):
    """``make_decode_step_fn``: one static step a call over the same
    cache, the JAX step's greedy tokens (logits tail or fused epilogue)."""
    cfg, tp, jcfg, jp = pair("gemma2", 29)
    ids = np.random.default_rng(30).integers(0, cfg.vocab_size, (2, 7))
    tc, jc, tok = _prefilled(cfg, tp, jcfg, jp, ids, 16)
    step = tgen.make_decode_step_fn(cfg, Sampler("greedy"), "flash_decode", fused, device="cpu")
    jstep = jgen.make_decode_step_fn(jcfg, JSampler("greedy"), "flash_decode", fused)
    jtok = jnp.asarray(tok.numpy())
    for _ in range(4):
        tok, tc = step(tp, tok, tc, None)
        jtok, jc = jstep(jp, jtok, jc, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert tc.length == int(tc.offset) == 11 and len(tc.steps) == 1


@pytest.mark.parametrize("model_type", MODELS)
@pytest.mark.parametrize("stops", ["none", "stop", "early_stop"])
def test_generator_two_calls_match_jax(model_type, stops):
    """Two calls on one Generator (the second on the first's reset cache
    and static step) give the JAX Generator's greedy tokens; the same
    shapes build no second step."""
    cfg, tp, jcfg, jp = pair(model_type, 27)
    rng = np.random.default_rng(28)
    prompts = [rng.integers(0, cfg.vocab_size, (2, 11)) for _ in range(2)]
    kw = dict(KERNELS)
    if stops != "none":
        free = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                              device="cpu").generate(prompts[1], 10).tokens
        kw.update(stop_tokens=(int(free[0, 4]),), early_stop=stops == "early_stop")
    tg = tgen.Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                        device="cpu", **kw)
    jg = jgen.Generator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32, **kw)
    for p in prompts + prompts[:1]:
        got, want = tg.generate(p, 10), jg.generate(p, 10)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.steps == want.steps
    assert tg.compile_counts() == {"decode_step": 1}
    # stream runs the loop's step at its shape: batch 1 is a new one
    streamed = list(tg.stream(prompts[0][0], 6))
    assert streamed == list(jg.stream(prompts[0][0], 6))
    assert tg.compile_counts() == {"decode_step": 1 + (len(streamed) > 1)}


def test_captured_step_runs_eagerly_on_the_cpu():
    """On the CPU a CapturedStep calls its function every time and never
    touches the launch counters; ``compiled`` means built and run."""
    calls = []
    counts = [getattr(fn, attr) for fn, attr in graphs.launch_counters()]
    step = graphs.CapturedStep(lambda: calls.append(1), torch.device("cpu"), "count")
    assert not step.compiled
    for _ in range(3):
        step()
    assert len(calls) == step.calls == 3 and step.compiled and step.graph is None
    assert [getattr(fn, attr) for fn, attr in graphs.launch_counters()] == counts
    assert ("launches_int8" in {attr for _, attr in graphs.launch_counters()})


# ----------------------------------------------------------------------
# the engine's unified tick
# ----------------------------------------------------------------------

def test_engine_compile_counts_match_jax_contract():
    """One mixed step per packed-width bucket used, at most
    ``len(mixed_buckets)``; a second replay of the 32-request trace
    builds none; the tokens equal the JAX engine's."""
    cfg, tp, jcfg, jp = pair("llama", 0)
    trace = serve.poisson_trace(np.random.default_rng(0), 32, rate_rps=40.0,
                                prompt_len_range=(3, 14), max_new_tokens=6,
                                vocab_size=cfg.vocab_size)
    kw = dict(max_slots=4, num_blocks=48, block_size=8, max_seq_len=64)
    port = clocked(serve.ServeEngine, tp, cfg, sampler=Sampler("greedy"), mixed_step="on",
                   cache_dtype=torch.float32, device="cpu", **kw)
    ref = clocked(jserve.ServeEngine, jp, jcfg, sampler=JSampler("greedy"), mixed_step="on",
                  cache_dtype=jnp.float32, **kw)
    assert port.replay_trace(trace)["finished"] == 32
    assert ref.replay_trace(trace)["finished"] == 32
    first = {r.req_id: list(r.generated) for r in port.scheduler.finished}
    assert first == {r.req_id: list(r.generated) for r in ref.scheduler.finished}
    counts = port.compile_counts()
    assert set(counts) == {"mixed_step"}
    assert 0 < counts["mixed_step"] <= len(port.mixed_buckets)
    assert counts["mixed_step"] == len(port.bucket_dispatches)
    assert sum(port.bucket_dispatches.values()) == port.n_dispatches
    # the growth check also runs the trace's requests all at once
    for rnd in range(2):
        for j, item in enumerate(trace):
            port.submit(item["prompt"], item["max_new_tokens"], seed=j)
        port.run_until_complete()
        if rnd == 0:
            counts = port.compile_counts()
            assert counts["mixed_step"] <= len(port.mixed_buckets)
    assert port.compile_counts() == counts
    assert len(port.scheduler.finished) == 96
    # warmup captures every bucket (an all-dead batch each), as the JAX
    # engine compiles every bucket; the tokens stay the same
    warm = clocked(serve.ServeEngine, tp, cfg, sampler=Sampler("greedy"), mixed_step="on",
                   cache_dtype=torch.float32, device="cpu", **kw)
    warm.warmup([5], 2)
    assert warm.compile_counts() == {"mixed_step": len(warm.mixed_buckets)}
    assert warm.replay_trace(trace)["finished"] == 32
    # (the warmup's dummy request took id 0)
    assert {r.req_id - 1: list(r.generated) for r in warm.scheduler.finished} == first
    assert warm.compile_counts() == {"mixed_step": len(warm.mixed_buckets)}
    # the phase-split engine: one decode step, built at its first tick
    split = clocked(serve.ServeEngine, tp, cfg, mixed_step="off", cache_dtype=torch.float32,
                    device="cpu", **kw)
    assert split.compile_counts() == {"decode_step": 0}
    assert split.replay_trace(trace)["finished"] == 32
    assert split.compile_counts() == {"decode_step": 1}


def test_engine_sampled_tick_stays_eager():
    """A non-greedy unified tick is a static step like a greedy one (its
    keys come from the bucket's seed and position operands): it is
    counted once per bucket used, and warmup builds every bucket."""
    cfg, tp, _, _ = pair("llama", 0)
    eng = serve.ServeEngine(tp, cfg, sampler=Sampler("min_p"), mixed_step="on",
                            cache_dtype=torch.float32, device="cpu", max_slots=2,
                            num_blocks=24, block_size=8, max_seq_len=64)
    eng.submit(np.arange(1, 9), 4, seed=3)
    eng.run_until_complete()
    assert len(eng.scheduler.finished[0].generated) == 4
    assert eng.compile_counts() == {"mixed_step": len(eng.bucket_dispatches)} != {
        "mixed_step": 0}
    eng.warmup([5], 2)
    assert eng.compile_counts() == {"mixed_step": len(eng.mixed_buckets)}

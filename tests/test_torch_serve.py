"""The port's ServeEngine against the JAX package's, on the CPU in float32.

Both engines run the same numpy-made weights on the same request traces.
The JAX engine runs its Pallas kernels in interpret mode (the ragged
kernel in the unified tick, the paged kernel in the split paged decode,
the fused greedy epilogue in both); the port runs the plain versions of
its kernels, which is what its wrappers do for CPU tensors.  Greedy
tokens must be identical per request id, and equal to the port's own
offline ``generate_ragged``.  (Tick counts may differ: the replay's
virtual clock also follows the wall clock, so arrivals interleave
differently with the ticks of engines of different speed.)

Also here: the copied host-side pieces against their originals (trace
draws, prefix keys, pool sizing, the scheduler's decisions), the port's
own structural pins (no gathered view in the paged step, no logits in
the fused step), the one-fetch contract, and a min-p request replaying
its stream across a preemption.  Sampled requests draw the JAX engine's
tokens, each up to the JAX side's first near-tie (``sampled_parity``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve.block_pool import FreeList as JFreeList
from llm_np_cp_tpu.serve.scheduler import Request as JRequest
from llm_np_cp_tpu.serve.scheduler import Scheduler as JScheduler
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.generate import Generator
from llm_np_cp_tpu_torch.models import transformer
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve.engine import _pack_sync
from llm_np_cp_tpu_torch.serve.slo import TickSentinel
from llm_np_cp_tpu_torch.serve.telemetry import TelemetryModel
from llm_np_cp_tpu_torch.serve.tenants import TenantLedger
from llm_np_cp_tpu_torch.serve.tracing import TraceRecorder
from sampled_parity import assert_prefix_parity, request_margins
from tick_clock import clocked


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# leg name → (mixed_step, decode_attn_impl) on both engines
LEGS = {
    "mixed": ("on", "xla"),
    "split_paged": ("off", "paged"),
    "split_xla": ("off", "xla"),
}


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


def pair(model_type, seed=0):
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config(model_type)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


@pytest.fixture(scope="module")
def llama():
    return pair("llama")


def engines(models, leg, *, int8=False, sampler="greedy", tick_clock=False, **kw):
    """(port engine, JAX engine) with the same geometry, for one leg;
    ``tick_clock``: each on its own ``TickClock`` (trace replays)."""
    cfg, tp, jcfg, jp = models
    mixed, impl = LEGS[leg]
    kw.setdefault("max_slots", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    build = clocked if tick_clock else (lambda f, *a, **k: f(*a, **k))
    port = build(
        serve.ServeEngine, tp, cfg, sampler=Sampler(sampler), mixed_step=mixed,
        decode_attn_impl=impl, cache_dtype=torch.int8 if int8 else torch.float32,
        device="cpu", **kw)
    ref = build(
        jserve.ServeEngine, jp, jcfg, sampler=JSampler(sampler), mixed_step=mixed,
        decode_attn_impl=impl, cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)
    return port, ref


def tokens(engine):
    return {r.req_id: list(r.generated) for r in engine.scheduler.finished}


def submit_all(engine, prompts, max_new, **kw):
    for j, p in enumerate(prompts):
        engine.submit(p, max_new, seed=j, **kw)
    engine.run_until_complete()
    return tokens(engine)


def assert_offline_parity(engine, cfg, params, cache_dtype):
    gen = Generator(params, cfg, sampler=Sampler("greedy"), cache_dtype=cache_dtype,
                    device="cpu")
    assert engine.scheduler.finished, "nothing finished — bad test setup"
    for req in engine.scheduler.finished:
        res = gen.generate_ragged([req.prompt], req.max_new_tokens, seed=req.seed)
        want = [int(t) for t in res.tokens[0][: req.max_new_tokens]]
        assert req.generated == want, (
            f"request {req.req_id} (preempted {req.n_preemptions}x) diverged from "
            "the offline run")


def trace32(cfg):
    """The 32-request trace of the JAX package's unified-tick parity test."""
    return serve.poisson_trace(
        np.random.default_rng(0), 32, rate_rps=40.0, prompt_len_range=(3, 14),
        max_new_tokens=6, vocab_size=cfg.vocab_size,
    )


# ----------------------------------------------------------------------
# the acceptance criterion: the 32-request trace, three legs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("leg", list(LEGS))
def test_trace_parity_32_requests_vs_jax_engine_and_offline(llama, leg):
    cfg, tp = llama[:2]
    trace = trace32(cfg)
    port, ref = engines(llama, leg, tick_clock=True)
    snap = port.replay_trace(trace)
    assert ref.replay_trace(trace)["finished"] == 32
    assert snap["finished"] == 32
    assert tokens(port) == tokens(ref)
    assert_offline_parity(port, cfg, tp, torch.float32)
    # the one-fetch contract: one packed fetch per dispatching step
    fetching = port.n_dispatches if port.mixed else port.n_decode_dispatches
    assert port.n_host_fetches == fetching > 0
    if port.mixed:
        assert snap["mixed_decode_tokens"] == snap["total_generated_tokens"] - 32
        assert snap["mixed_prefill_tokens"] > 0
    assert port.pool.stats()["request_held"] == 0


def test_flash_decode_leg_matches_xla_leg(llama):
    """The gather path through the decode_attention kernel's plain
    version gives the plain masked path's tokens."""
    cfg, tp = llama[:2]
    trace = trace32(cfg)

    def run(impl):
        eng = clocked(serve.ServeEngine, tp, cfg, sampler=Sampler("greedy"), mixed_step="off",
                      decode_attn_impl=impl, max_slots=4, num_blocks=48, block_size=8,
                      max_seq_len=64, cache_dtype=torch.float32, device="cpu")
        eng.replay_trace(trace)
        return tokens(eng)

    assert run("flash_decode") == run("xla")


# ----------------------------------------------------------------------
# further parity cases
# ----------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["mixed", "split_paged", "split_xla"])
def test_int8_pool_parity(llama, leg):
    prompts = [np.random.default_rng(11).integers(1, 256, size=n) for n in (6, 11, 4)]
    port, ref = engines(llama, leg, int8=True, max_slots=3, num_blocks=16)
    assert port.pool.pages.quantized
    assert submit_all(port, prompts, 5) == submit_all(ref, prompts, 5)
    # the K/V bytes the ticks' attention read (the scale pages counted)
    assert port.metrics.snapshot()["kv_bytes_total"] == ref.metrics.snapshot()["kv_bytes_total"] > 0


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_gemma2_sliding_window_parity(leg):
    """Gemma-2's alternating sliding layers: long decodes crossing the
    window (16) and several block boundaries."""
    models = pair("gemma2", seed=2)
    assert models[0].sliding_window == 16
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n) for n in (9, 13)]
    port, ref = engines(models, leg, max_slots=2, num_blocks=32)
    assert submit_all(port, prompts, 16) == submit_all(ref, prompts, 16)
    # the K/V bytes the ticks' attention read, window-aware per layer
    assert port.metrics.snapshot()["kv_bytes_total"] == ref.metrics.snapshot()["kv_bytes_total"] > 0


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_prefix_sharing_parity(llama, leg):
    """Repeated prompts hit the prefix cache: the covered chunks are
    skipped, the tokens and hit counts equal the JAX engine's, and the
    shared run's tokens equal an unshared run's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=n) for n in (20, 17)] * 4
    port, ref = engines(llama, leg, enable_prefix_cache=True)
    got = submit_all(port, prompts, 4)
    assert got == submit_all(ref, prompts, 4)
    cold, _ = engines(llama, leg)
    assert got == submit_all(cold, prompts, 4)
    snap, jsnap = port.metrics.snapshot(), ref.metrics.snapshot()
    assert snap["prefix_blocks_hit"] == jsnap["prefix_blocks_hit"] > 0
    assert snap["prefix_blocks_requested"] == jsnap["prefix_blocks_requested"]
    fl = port.pool.free_list
    assert fl.num_allocated == len(port.pool.prefix_cache)


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_eviction_requeue_parity(llama, leg):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=n) for n in (4, 5, 3)]
    port, ref = engines(llama, leg, max_slots=2, num_blocks=6)
    assert submit_all(port, prompts, 20) == submit_all(ref, prompts, 20)
    assert port.scheduler.n_preemptions == ref.scheduler.n_preemptions > 0
    assert port.pool.free_list.num_allocated == 0


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_stop_tokens_parity(llama, leg):
    """A stop token ends a request early with reason "stop", on both
    engines alike."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 256, size=n) for n in (7, 12, 5, 9)]
    free, _ = engines(llama, leg)
    stop = submit_all(free, prompts, 8)[0][2]  # request 0's third token
    port, ref = engines(llama, leg, stop_tokens=(stop,))
    got = submit_all(port, prompts, 8)
    assert got == submit_all(ref, prompts, 8)
    assert len(got[0]) == 3 and got[0][-1] == stop
    reasons = {r.req_id: r.finish_reason for r in port.scheduler.finished}
    assert reasons == {r.req_id: r.finish_reason for r in ref.scheduler.finished}
    assert reasons[0] == "stop"


@pytest.mark.parametrize("leg", ["mixed", "split_paged"])
def test_min_p_stream_survives_preemption(llama, leg):
    """A stochastic request preempted mid-stream re-prefills and must
    draw the tokens it draws unpreempted: each draw is seeded from
    (request seed, content position)."""
    cfg, tp = llama[:2]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=n) for n in (4, 5, 3)]

    def run(num_blocks):
        eng = serve.ServeEngine(
            tp, cfg, sampler=Sampler("min_p", p_base=0.05, temperature=1.5),
            mixed_step=LEGS[leg][0], decode_attn_impl=LEGS[leg][1], max_slots=2,
            num_blocks=num_blocks, block_size=8, max_seq_len=64,
            cache_dtype=torch.float32, device="cpu")
        got = submit_all(eng, prompts, 20)
        return got, eng.scheduler.n_preemptions

    tight, n_pre = run(6)
    roomy, n_none = run(48)
    assert n_pre > 0 and n_none == 0
    assert tight == roomy
    # the draws are stochastic, not the greedy path in disguise
    greedy = serve.ServeEngine(tp, cfg, sampler=Sampler("greedy"), max_slots=2,
                               num_blocks=48, block_size=8, max_seq_len=64,
                               cache_dtype=torch.float32, device="cpu")
    assert submit_all(greedy, prompts, 20) != roomy


@pytest.mark.parametrize("leg", ["mixed", "split_paged", "split_xla"])
def test_min_p_ticks_match_jax_engine(llama, leg):
    """Min-p (the reference's live sampler) through the unified tick or
    the phase-split tick, with a pool tight enough to preempt: every
    request draws the JAX engine's tokens (each row keyed by
    ``fold_in(PRNGKey(seed), content position)`` on the card), up to a
    near-tie (``sampled_parity``), and a preempted request's stream is
    the one it draws unpreempted.  The step is a static step (counted by
    ``compile_counts``)."""
    cfg, tp, jcfg, jp = llama
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=n) for n in (4, 5, 3)]
    kw = dict(p_base=0.05, temperature=1.5)
    js = JSampler("min_p", **kw)
    mixed, impl = LEGS[leg]

    def port_engine(num_blocks):
        return serve.ServeEngine(tp, cfg, sampler=Sampler("min_p", **kw), mixed_step=mixed,
                                 decode_attn_impl=impl, max_slots=2, num_blocks=num_blocks,
                                 block_size=8, max_seq_len=64, cache_dtype=torch.float32,
                                 device="cpu")

    port = port_engine(6)
    ref = jserve.ServeEngine(jp, jcfg, sampler=js, mixed_step=mixed, decode_attn_impl=impl,
                             max_slots=2, num_blocks=6, block_size=8, max_seq_len=64,
                             cache_dtype=jnp.float32)
    got, want = submit_all(port, prompts, 20), submit_all(ref, prompts, 20)
    assert port.scheduler.n_preemptions > 0 and ref.scheduler.n_preemptions > 0
    reqs = {r.req_id: r for r in ref.scheduler.finished}
    ids = sorted(want)
    assert sorted(got) == ids
    margins = [request_margins(jp, jcfg, js, reqs[i]) for i in ids]
    assert assert_prefix_parity([want[i] for i in ids], [got[i] for i in ids], margins,
                                f"min_p {leg}") > 0
    preempted = [r.req_id for r in port.scheduler.finished if r.n_preemptions]
    assert preempted
    roomy = submit_all(port_engine(48), prompts, 20)
    assert all(got[i] == roomy[i] for i in preempted)
    counts = port.compile_counts()
    assert counts == ({"decode_step": 1} if mixed == "off"
                      else {"mixed_step": len(port.bucket_dispatches)})


# ----------------------------------------------------------------------
# the port's structural pins (the JAX package pins its jaxprs)
# ----------------------------------------------------------------------

class _ShapeRecorder(TorchDispatchMode):
    """Records the shape of every tensor an op returns, except inside a
    kernel wrapper: on the card the kernel is opaque (its plain version,
    which runs here, may gather or build logits)."""

    def __init__(self):
        super().__init__()
        self.shapes: set[tuple[int, ...]] = set()
        self.opaque = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.opaque:
            self.shapes.update(tuple(t.shape) for t in tree_leaves(out)
                               if isinstance(t, torch.Tensor))
        return out


def _record_step(monkeypatch, engine, step_name, prompts):
    """Shapes produced inside the engine's ``step_name`` calls while it
    serves ``prompts``, kernel wrappers opaque."""
    rec = _ShapeRecorder()

    def opaque(fn):
        def call(*a, **k):
            rec.opaque += 1
            try:
                return fn(*a, **k)
            finally:
                rec.opaque -= 1
        return call

    for mod, name in ((da, "paged_decode_attention"), (da, "ragged_paged_attention"),
                      (da, "decode_attention"), (transformer, "sample_epilogue")):
        monkeypatch.setattr(mod, name, opaque(getattr(mod, name)))
    step = getattr(engine, step_name)

    def recorded(*a, **k):
        with rec:
            return step(*a, **k)

    monkeypatch.setattr(engine, step_name, recorded)
    submit_all(engine, prompts, 4)
    return rec.shapes


def test_paged_decode_step_has_no_gathered_view(llama, monkeypatch):
    """The paged decode step never builds a [B, S_max, K, D] view; the
    gather step (the control) does."""
    cfg, tp = llama[:2]
    prompts = [np.arange(1, 12), np.arange(3, 9)]
    view = (4, 64, cfg.num_key_value_heads, cfg.head_dim)

    def shapes(impl):
        eng = serve.ServeEngine(tp, cfg, max_slots=4, num_blocks=16, block_size=8,
                                max_seq_len=64, cache_dtype=torch.float32,
                                decode_attn_impl=impl, device="cpu")
        return _record_step(monkeypatch, eng, "_decode_step", prompts)

    assert view in shapes("xla"), "control failed: the gather step builds no view"
    assert view not in shapes("paged")


def test_fused_mixed_step_never_materializes_logits(llama, monkeypatch):
    """The fused mixed step produces no [R, V] or [R, W, V] tensor; the
    logits tail (the control) does."""
    cfg, tp = llama[:2]
    prompts = [np.arange(1, 12), np.arange(3, 9)]
    logits = {(4, cfg.vocab_size), (4, 1, cfg.vocab_size)}

    def shapes(epilogue):
        eng = serve.ServeEngine(tp, cfg, max_slots=4, num_blocks=16, block_size=8,
                                max_seq_len=64, cache_dtype=torch.float32, mixed_step="on",
                                sample_epilogue=epilogue, device="cpu")
        assert eng.epilogue_impl == ("fused" if epilogue == "auto" else "xla")
        return _record_step(monkeypatch, eng, "_mixed_step", prompts)

    assert logits & shapes("off"), "control failed: the logits tail builds no logits"
    assert not logits & shapes("auto")


# ----------------------------------------------------------------------
# the copied host side against its original
# ----------------------------------------------------------------------

def test_poisson_trace_draws_the_jax_sequence():
    kw = dict(rate_rps=40.0, prompt_len_range=(16, 200), max_new_tokens=32, vocab_size=1000)
    ours = serve.poisson_trace(np.random.default_rng(0), 32, **kw)
    theirs = jserve.poisson_trace(np.random.default_rng(0), 32, **kw)
    assert [t["arrival_s"] for t in ours] == [t["arrival_s"] for t in theirs]
    assert all(np.array_equal(a["prompt"], b["prompt"]) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("pad", [0, 5, 19])
def test_prefix_block_keys_are_byte_identical(pad):
    tokens_ = np.random.default_rng(pad).integers(1, 5000, size=70)
    assert (serve.prefix_block_keys(tokens_, pad, 16, 5)
            == jserve.prefix_block_keys(tokens_, pad, 16, 5))


@pytest.mark.parametrize("p,m,chunk,slots,bs", [(200, 32, 64, 8, 16), (13, 6, 8, 4, 8),
                                                 (65, 40, 64, 2, 16)])
def test_pool_sizing_matches_jax(p, m, chunk, slots, bs):
    assert serve.worst_case_slots(p, m, chunk) == jserve.worst_case_slots(p, m, chunk)
    assert (serve.pool_geometry(p, m, slots, bs, chunk)
            == jserve.pool_geometry(p, m, slots, bs, chunk))


@pytest.mark.parametrize("bs,qb,window,n_sliding", [(16, 8, None, 0), (128, 8, None, 0),
                                                   (8, 8, 16, 2), (16, 8, 5, 1), (12, 8, 40, 3)])
def test_segment_kv_slots_equals_the_per_tile_sum(bs, qb, window, n_sliding):
    """The byte model's closed form (the kv_bytes_tick gauge and the
    telemetry bill) equals the per-q-tile sum the JAX engine walks, on
    random segments."""
    from llm_np_cp_tpu_torch.serve.telemetry import _segment_kv_slots

    n_layers = 4

    def per_tile(pad, start, n):
        slots = 0
        for k in range(-(-n // qb)):
            q0 = start + k * qb
            qlast = q0 + min(qb, n - k * qb) - 1
            full = (qlast // bs - pad // bs + 1) * bs
            windowed = 0
            if n_sliding:
                lo = max(pad, q0 - window + 1)
                windowed = (qlast // bs - lo // bs + 1) * bs
            slots += (n_layers - n_sliding) * full + n_sliding * windowed
        return slots

    rng = np.random.default_rng(bs * 7 + qb)
    for _ in range(300):
        pad = int(rng.integers(0, 40))
        start = pad + int(rng.integers(0, 300))
        n = int(rng.integers(1, 300))
        assert _segment_kv_slots(pad, start, n, block_size=bs, q_tile=qb, window=window,
                                 n_layers=n_layers, n_sliding=n_sliding) \
            == per_tile(pad, start, n), (pad, start, n)


def test_scheduler_decisions_match_jax():
    """Random admissions, growth, planning, finishes and aborts drive
    both schedulers over their own free lists: every decision agrees."""
    rng = np.random.default_rng(4)
    ours = serve.Scheduler(serve.FreeList(12), max_slots=3, block_size=8)
    theirs = JScheduler(JFreeList(12), max_slots=3, block_size=8)
    reqs: dict[int, tuple] = {}
    for step in range(300):
        op = rng.integers(0, 5)
        if op == 0:
            prompt = rng.integers(1, 100, size=int(rng.integers(1, 30))).astype(np.int32)
            pair_ = (serve.Request(step, prompt, 8), JRequest(step, prompt, 8))
            reqs[step] = pair_
            ours.add(pair_[0])
            theirs.add(pair_[1])
        elif op == 1:
            a, b = ours.admit(), theirs.admit()
            assert [r.req_id for r in a] == [r.req_id for r in b]
            for r in a + b:
                r.prefill_target, r.prefilled = r.total_len, False
        elif op == 2:
            for sched in (ours, theirs):
                for r in sched.running:
                    r.prefilled = True
                    r.generated.extend([1] * 3)
            a, b = ours.ensure_decode_blocks(), theirs.ensure_decode_blocks()
            assert [r.req_id for r in a] == [r.req_id for r in b]
        elif op == 3:
            a, b = ours.plan_tick(10, 4), theirs.plan_tick(10, 4)
            assert [r.req_id for r in a[0]] == [r.req_id for r in b[0]]
            assert [(r.req_id, n) for r, n in a[1]] == [(r.req_id, n) for r, n in b[1]]
        elif ours.running:
            k = int(rng.integers(0, len(ours.running)))
            rid = ours.running[k].req_id
            ro, rt = reqs[rid]
            if rng.integers(0, 2):
                ours.finish(ro)
                theirs.finish(rt)
            else:
                ours.abort(ro)
                theirs.abort(rt)
        assert [r.req_id for r in ours.running] == [r.req_id for r in theirs.running]
        assert [r.req_id for r in ours.queue] == [r.req_id for r in theirs.queue]
        assert ours.allocator.num_free == theirs.allocator.num_free
    assert ours.n_preemptions == theirs.n_preemptions > 0


def test_pack_sync_matches_jax():
    from llm_np_cp_tpu.serve.engine import _pack_sync as j_pack_sync

    rng = np.random.default_rng(1)
    samples = rng.integers(0, 5, size=(6, 4)).astype(np.int32)
    hit = rng.random((6, 4)) < 0.3
    accept = rng.integers(0, 4, size=6).astype(np.int32)
    got = _pack_sync(torch.from_numpy(samples), torch.from_numpy(hit), torch.from_numpy(accept))
    want = j_pack_sync(jnp.asarray(samples), jnp.asarray(hit), jnp.asarray(accept))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# engine surface
# ----------------------------------------------------------------------

def test_auto_means_on_and_unported_options_raise(llama):
    cfg, tp = llama[:2]
    kw = dict(num_blocks=16, block_size=8, max_seq_len=64, cache_dtype=torch.float32,
              device="cpu")
    eng = serve.ServeEngine(tp, cfg, mixed_step="auto", **kw)
    assert eng.mixed and eng.mixed_buckets[0] == da.RAGGED_Q_TILE
    # mesh_plan is ported (tests/test_torch_serve_sharded.py); the fleet's
    # one-device placement (mesh_devices) still refuses
    with pytest.raises(NotImplementedError, match="mesh_devices.*item 8c"):
        serve.ServeEngine(tp, cfg, mesh_devices=[0], **kw)
    # the lifecycle slice is ported: actions and the weight version are
    # accepted
    acting = serve.ServeEngine(tp, cfg, actions=serve.ActionPolicy(), weights_version=2, **kw)
    assert acting.actions is not None and acting.weights_version == 2
    # the observability plane is ported: its layers are accepted
    tr = TraceRecorder()
    traced = serve.ServeEngine(tp, cfg, tracer=tr, sentinel=TickSentinel(),
                               telemetry=TelemetryModel(cfg, tp), tenants=TenantLedger(), **kw)
    assert traced.tracer is tr and traced.tenants is not None and traced.telemetry is not None
    # the faults-and-recovery slice is ported: its layers are accepted
    inj = serve.FaultInjector("decode@9")
    assert serve.ServeEngine(tp, cfg, fault_injector=inj, **kw).faults is inj
    # host_tier is ported: it takes the JAX engine's gate instead
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        serve.ServeEngine(tp, cfg, host_tier=object(), **kw)
    # spec_k is ported: it rides the unified tick ("auto" means "on")
    assert serve.ServeEngine(tp, cfg, spec_k=4, mixed_step="auto", **kw).spec_k == 4
    with pytest.raises(TypeError, match="bogus"):
        serve.ServeEngine(tp, cfg, bogus=1, **kw)
    with pytest.raises(ValueError, match="device"):
        serve.ServeEngine(tp, cfg, **{**kw, "device": "meta"})
    for name in ("recover", "finish_recovered", "clone_fresh", "retire"):
        assert callable(getattr(eng, name))
    # the fleet's contract: capture what the peer captured (nothing yet)
    eng.share_compiled_steps(eng)
    assert eng.compile_counts() == {"mixed_step": 0}


def test_block_pool_layout_and_stats(llama):
    cfg = llama[0]
    pool = serve.BlockPool(cfg, 10, 8, dtype=torch.int8, device="cpu")
    l, kh, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    assert pool.pages.k.shape == (l, 10, 8, kh, d) and pool.pages.k.dtype == torch.int8
    assert pool.pages.k_scale.shape == (l, 10, 8, kh)
    stats = pool.stats()
    assert stats["capacity"] == 9 and stats["request_held"] == 0
    assert stats["kv_bytes_total"] == 2 * (l * 10 * 8 * kh * d + 4 * l * 10 * 8 * kh)
    with pytest.raises(ValueError, match="multiple of 8"):
        serve.BlockPool(cfg, 10, 12, dtype=torch.float32, device="cpu")
    assert pool.alloc(9) is not None and pool.alloc(1) is None  # block 0 stays scratch


def test_abort_and_deadline_free_every_block(llama):
    cfg, tp = llama[:2]
    eng = serve.ServeEngine(tp, cfg, mixed_step="on", max_slots=2, num_blocks=24, block_size=8,
                            max_seq_len=64, cache_dtype=torch.float32, device="cpu",
                            tick_token_budget=6)
    events = []
    reqs = [eng.submit(np.arange(1, 20), 8, on_event=lambda r, e: events.append((r.req_id, e)))
            for _ in range(3)]
    eng.step()  # the first row is mid-prefill (budget 6 < 19 tokens)
    assert eng.abort(reqs[0].req_id) and not eng.abort(reqs[0].req_id)
    assert eng.abort(reqs[2].req_id)  # still queued
    eng.run_until_complete()
    assert (0, "aborted") in events and (2, "aborted") in events and (1, "length") in events
    assert len(reqs[1].generated) == 8
    assert eng.pool.stats()["request_held"] == 0
    snap = eng.metrics.snapshot()
    assert snap["aborted"] == 2 and snap["finished"] == 1
    assert snap["tpot_s_p50"] > 0 and snap["ttft_s_p50"] > 0


def test_deadline_and_queue_cap(llama):
    """A request past its deadline (on the engine's clock) is aborted at
    the next tick; a submit beyond ``max_queue`` raises QueueFull and is
    counted as rejected."""
    cfg, tp = llama[:2]
    now = [0.0]
    eng = serve.ServeEngine(tp, cfg, mixed_step="on", max_slots=1, num_blocks=24, block_size=8,
                            max_seq_len=64, cache_dtype=torch.float32, device="cpu",
                            max_queue=1, clock=lambda: now[0])
    late = eng.submit(np.arange(1, 6), 4, deadline_s=1.0)
    eng.step()  # admits it
    on_time = eng.submit(np.arange(2, 9), 4)
    with pytest.raises(serve.QueueFull):
        eng.submit(np.arange(3, 7), 4)
    now[0] = 2.0
    eng.run_until_complete()
    assert late.finish_reason == "aborted" and len(late.generated) < 4
    assert on_time.finish_reason == "length" and len(on_time.generated) == 4
    snap = eng.metrics.snapshot()
    assert (snap["rejected"], snap["aborted"], snap["finished"]) == (1, 1, 1)
    assert eng.pool.stats()["request_held"] == 0

"""Faults and recovery in the port (``serve/faults.py``, the engine's
fault sites, ``recover`` / ``finish_recovered`` / ``clone_fresh`` /
``retire``, and the ``EngineRunner`` supervisor) against the JAX
package's, on the CPU in float32.

The injector's schedules (hits, injected counts, ``%P`` replay by seed)
equal the JAX module's on the same specs and seeds.  A ``tick_crash``, or
a ``tick_hang`` the watchdog catches, in the middle of a served trace
restarts the engine, and every recovered
stream — greedy, min-p and ``spec_k=2`` — equals an uninterrupted port
run and the JAX engine's tokens on the same weights (min-p up to the JAX
side's first near-tie, ``sampled_parity``).  Then the port's deliberate
differences: a ``decode`` fault restarts the engine instead of degrading
the kernel, a retired engine raises, and a rebuild captures its own
steps.  Also the restart budget, a rebuild that itself fails, the HTTP
chaos sites against the retrying client, the ``ckpt_read`` retry and
``clone_fresh`` carrying the host tier.
"""

import asyncio
import dataclasses
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import faults as jfaults
from llm_np_cp_tpu_torch import graphs, serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import faults
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
from llm_np_cp_tpu_torch.serve.request_log import RequestLog, read_request_log
from llm_np_cp_tpu_torch.utils import loading as tloading
from sampled_parity import assert_prefix_parity, request_margins
from test_torch_http import run, serving, until
from test_torch_loading import hf_checkpoint

pytestmark = pytest.mark.chaos

NEW_TOKENS = 10
MIN_P = dict(p_base=0.05, temperature=1.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_global_injector():
    yield
    faults.install(None)


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's own seeded init, handed to both packages as numpy:
    a random model whose greedy streams fall into the cycles prompt
    lookup drafts (so the spec_k leg verifies real drafts)."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg,
                                                    dtype=jnp.float32))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def tiled_prompts(seed, lens=(6, 9, 12, 7), pattern=3):
    rng = np.random.default_rng(seed)
    return [np.resize(rng.integers(1, 256, size=pattern), n).astype(np.int32) for n in lens]


# mode → (sampler kind, its keywords, spec_k)
MODES = {"greedy": ("greedy", {}, 0), "min_p": ("min_p", MIN_P, 0), "spec_k2": ("greedy", {}, 2)}


def engine(models, mode="greedy", **kw):
    cfg, tp = models[:2]
    kind, skw, spec_k = MODES[mode]
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("mixed_step", "on")
    return serve.ServeEngine(tp, cfg, sampler=Sampler(kind, **skw), spec_k=spec_k,
                             cache_dtype=torch.float32, device="cpu", **kw)


def direct_tokens(eng, prompts, n=NEW_TOKENS, speculative=False):
    """Each prompt's tokens from an uninterrupted run (prompt j seeded j)."""
    for j, p in enumerate(prompts):
        eng.submit(p, n, seed=j, speculative=speculative)
    eng.run_until_complete()
    return [list(r.generated) for r in sorted(eng.scheduler.finished, key=lambda r: r.seed)]


async def stream_all(srv, prompts, n=NEW_TOKENS, **extra):
    return await asyncio.gather(*(astream_completion(
        srv.host, srv.port, {"prompt": [int(t) for t in p], "max_tokens": n, "seed": j,
                             "stream": True, **extra}, timeout=60)
        for j, p in enumerate(prompts)))


def scrape(srv) -> dict[str, float]:
    _, raw = http_get(srv.host, srv.port, "/metrics")
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^llm_serve_(\w+) (\S+)$", raw.decode(), re.M)}


# ---------------------------------------------------------------------------
# The injector against the JAX module's
# ---------------------------------------------------------------------------

SPECS = [
    ("decode@3:2=7.5;prefill@1", 0),
    ("tick_hang@2:4=1.5, http_429%0.25=0", 7),
    ("decode%0.3", 42),
    ("decode%0.4;http_429%0.4;journal_fsync@5", 3),
    ("", 0),
]
BAD_SPECS = ["nope@1", "decode", "decode@0", "decode@1:0", "decode%1.5", "decode@x"]


@pytest.mark.parametrize("spec,seed", SPECS)
def test_schedules_equal_jax(spec, seed):
    """Parsed events, every trip's answer over an interleaving of sites,
    the hit and injected counters and the snapshot equal the JAX
    injector's; the same seed replays the same schedule."""
    assert faults.SITES == jfaults.SITES
    assert ([dataclasses.astuple(e) for e in faults.parse_chaos_spec(spec)]
            == [dataclasses.astuple(e) for e in jfaults.parse_chaos_spec(spec)])
    assert (faults.FaultInjector.from_spec(spec) is None) == (not spec.strip())
    sites = ("decode", "prefill", "http_429", "tick_hang", "journal_fsync")
    order = [sites[(i * 7) % len(sites)] for i in range(300)]
    runs = []
    for mod in (faults, jfaults, faults):
        inj = mod.FaultInjector(spec, seed=seed)
        fired = [inj.trip(s) for s in order]
        runs.append((fired, dict(inj.hits), dict(inj.injected), inj.injected_total,
                     inj.snapshot()))
    assert runs[0] == runs[1] == runs[2]
    if "%" in spec:
        assert 0 < runs[0][3] < len(order)


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_bad_specs_raise_as_jax(bad):
    with pytest.raises(ValueError) as got:
        faults.parse_chaos_spec(bad)
    with pytest.raises(ValueError) as want:
        jfaults.parse_chaos_spec(bad)
    assert str(got.value) == str(want.value) and "bad chaos event" in str(got.value)
    assert faults.FaultInjected("decode").site == "decode"


@pytest.mark.parametrize("spec,ok", [("ckpt_read@1:2", True), ("ckpt_read@1:3", False)])
def test_ckpt_read_site_retries_shard_reads(tmp_path, monkeypatch, spec, ok):
    """``install`` hooks the port's loader: two transient read errors are
    retried and the load matches a clean one; a third exhausts the
    bounded retry and the error names the shard."""
    from safetensors.numpy import save_file

    cfg = tiny_config("llama")
    save_file(hf_checkpoint(cfg, 3), str(tmp_path / "model.safetensors"))
    monkeypatch.setattr(tloading, "SHARD_READ_BACKOFF_S", 0.001)
    clean, _ = tloading.load_params(tmp_path, cfg, dtype=torch.float32, device="cpu")
    inj = faults.FaultInjector(spec)
    faults.install(inj)
    assert faults.active() is inj and tloading.SHARD_READ_HOOK is not None
    if ok:
        got, _ = tloading.load_params(tmp_path, cfg, dtype=torch.float32, device="cpu")
        assert torch.equal(got["embed_tokens"], clean["embed_tokens"])
        assert inj.injected["ckpt_read"] == 2 and inj.hits["ckpt_read"] == 3
    else:
        with pytest.raises(OSError, match="model.safetensors: shard read failed after 3"):
            tloading.load_params(tmp_path, cfg, dtype=torch.float32, device="cpu")
    faults.install(None)
    assert tloading.SHARD_READ_HOOK is None


# ---------------------------------------------------------------------------
# Supervised restart: recovered streams against an uninterrupted run and JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def references(tiny):
    """mode → (uninterrupted port tokens, JAX engine tokens) of the
    trace's prompts, each computed once."""
    cfg, tp, jcfg, jp = tiny
    prompts, cache = tiled_prompts(1), {}

    def get(mode):
        if mode not in cache:
            kind, skw, spec_k = MODES[mode]
            spec = bool(spec_k)
            want = direct_tokens(engine(tiny, mode), prompts, speculative=spec)
            ref = jserve.ServeEngine(jp, jcfg, sampler=JSampler(kind, **skw), spec_k=spec_k,
                                     mixed_step="on", max_slots=2, num_blocks=32, block_size=8,
                                     max_seq_len=64, cache_dtype=jnp.float32)
            jwant = direct_tokens(ref, prompts, speculative=spec)
            if kind == "greedy":
                assert want == jwant
            else:
                reqs = sorted(ref.scheduler.finished, key=lambda r: r.seed)
                margins = [request_margins(jp, jcfg, JSampler(kind, **skw), r) for r in reqs]
                assert assert_prefix_parity(jwant, want, margins, f"{mode} uninterrupted") > 0
            cache[mode] = want
        return prompts, cache[mode]

    return get


# site → (chaos spec, server keywords): a crash, and a hang the watchdog
# declares past tick_deadline
SITES = {"tick_crash": ("tick_crash@6", {}),
         "tick_hang": ("tick_hang@6=3.0", dict(tick_deadline=1.0))}


@pytest.mark.http
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("mode", list(MODES))
def test_recovered_streams_equal_uninterrupted_and_jax(tiny, references, tmp_path, mode, site):
    """A ``tick_crash``, or a ``tick_hang`` the watchdog catches, mid-trace
    under ``max_restarts=2``: every stream completes, equal to an
    uninterrupted port run and to the JAX engine's tokens on the same
    weights (``references``); the restart is counted, the replays are
    ``requests_recovered_total`` and the request log's ``replays``,
    ``submitted == finished + aborted``, and a hung thread that wakes
    finds itself superseded, its engine retired and its metrics muted."""
    spec = bool(MODES[mode][2])
    prompts, want = references(mode)
    log = RequestLog(str(tmp_path / "requests.jsonl"))
    chaos, server_kw = SITES[site]
    inj = faults.FaultInjector(chaos)
    eng = engine(tiny, mode, fault_injector=inj, request_log=log)

    async def main():
        async with serving(eng, max_restarts=2, restart_backoff_s=0.02, **server_kw) as srv:
            res = await stream_all(srv, prompts, speculative=spec)
            assert [r["token_ids"] for r in res] == want
            assert all(r["finish_reason"] == "length" for r in res)
            assert srv.runner.restarts == 1 and inj.injected[site] == 1
            assert srv.runner.engine is not eng and eng.retired
            prom = await asyncio.get_running_loop().run_in_executor(None, scrape, srv)
            snap = srv.runner.engine.metrics.snapshot()
            assert prom["restarts_total"] == 1 and prom["faults_injected_total"] == 1
            assert prom["requests_recovered_total"] == snap["recovered"] > 0
            assert snap["submitted"] == snap["finished"] + snap["aborted"] == len(prompts)
            assert prom["recovery_latency_s_last"] > 0
            if spec:  # the replay resumed drafting: verify rounds ran
                assert snap["spec_drafted_tokens"] > 0 and snap["spec_accepted_tokens"] > 0
            return snap["recovered"]

    recovered = asyncio.run(asyncio.wait_for(main(), timeout=120))
    assert eng.metrics.snapshot()["finished"] == 0  # the zombie's metrics were muted
    log.close()
    lines = read_request_log(log.path)
    assert len(lines) == len(prompts) and {ln["reason"] for ln in lines} == {"length"}
    assert sum(ln["replays"] for ln in lines) == recovered


@pytest.mark.http
@pytest.mark.parametrize("leg", [dict(mixed_step="on"),
                                 dict(mixed_step="off", decode_attn_impl="paged")],
                         ids=["mixed", "split_paged"])
def test_decode_fault_restarts_instead_of_degrading(tiny, leg):
    """A deliberate difference from the JAX engine, which degrades the
    faulting kernel to its XLA sibling: the port has no plain fallback on
    the card, so a ``decode`` fault raises, the supervisor restarts the
    engine, and ``decode_degraded`` stays None on both engines.  While
    the restart backs off, /healthz answers ``degraded`` with 200."""
    prompts = tiled_prompts(2, lens=(5, 8))
    want = direct_tokens(engine(tiny, **leg), prompts)
    inj = faults.FaultInjector("decode@4")
    eng = engine(tiny, fault_injector=inj, **leg)
    with pytest.raises(faults.FaultInjected) as e:
        probe = engine(tiny, fault_injector=faults.FaultInjector("decode@1"), **leg)
        probe.submit(prompts[0], 4)
        probe.run_until_complete()
    assert e.value.site == "decode" and probe.decode_degraded is None

    async def main():
        async with serving(eng, max_restarts=1, restart_backoff_s=0.5) as srv:
            task = asyncio.ensure_future(stream_all(srv, prompts))
            loop = asyncio.get_running_loop()
            await until(lambda: srv.runner.recovering)
            st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
            assert st == 200 and json.loads(body)["status"] == "degraded"
            assert json.loads(body)["restarts"] == 1
            res = await task
            assert [r["token_ids"] for r in res] == want
            st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
            assert st == 200 and json.loads(body)["status"] == "ok"
            new = srv.runner.engine
            assert new is not eng and eng.decode_degraded is None and new.decode_degraded is None
            assert inj.injected["decode"] == 1 and srv.runner.restarts == 1

    run(main())


def raise_on_clone(eng):
    def clone_fresh():
        eng.retire()
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng.clone_fresh = clone_fresh
    return eng


@pytest.mark.http
@pytest.mark.parametrize("case", ["crash_loop", "rebuild_fails"])
def test_spent_restart_budget_is_terminal(tiny, case):
    """Deaths past ``max_restarts`` fall back to the terminal backstop:
    the stream ends ``aborted``, /healthz answers 503 ``crashed``, new
    work gets 503.  The same holds when the rebuild itself raises, as it
    does in a process whose CUDA context a real kernel fault poisoned."""
    spec = "tick_crash@2:10" if case == "crash_loop" else "tick_crash@2"
    eng = engine(tiny, fault_injector=faults.FaultInjector(spec))
    if case == "rebuild_fails":
        raise_on_clone(eng)

    async def main():
        async with serving(eng, max_restarts=2, restart_backoff_s=0.01,
                           drain_timeout=5.0) as srv:
            res = await stream_all(srv, tiled_prompts(3, lens=(6,)), n=40)
            assert res[0]["finish_reason"] == "aborted"
            loop = asyncio.get_running_loop()
            st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
            body = json.loads(body)
            assert st == 503 and body["status"] == "crashed" and body["restarts"] == 2
            if case == "rebuild_fails":
                assert "illegal memory access" in body["error"]
                assert srv.runner.engine is eng and eng.retired
            res = await stream_all(srv, tiled_prompts(3, lens=(6,)), n=4)
            assert res[0]["status"] == 503
            assert not srv.runner.recovering and srv.runner.state == "crashed"

    run(main())


@pytest.mark.http
def test_slow_rebuild_is_not_a_hang(tiny):
    """A rebuild (retire + ``clone_fresh``, whose captures take seconds on
    the card) that outlasts ``tick_deadline`` plus the backoff is not a
    hung tick: the watchdog waits for it, so one crash is one restart, no
    second rebuild starts beside the first, and every stream completes
    equal to an uninterrupted run."""
    prompts = tiled_prompts(4, lens=(5, 8))
    want = direct_tokens(engine(tiny), prompts)
    eng = engine(tiny, fault_injector=faults.FaultInjector("tick_crash@3"))
    clones = []
    real_clone = eng.clone_fresh

    def slow_clone():
        clones.append(time.monotonic())
        time.sleep(1.2)
        return real_clone()

    eng.clone_fresh = slow_clone

    async def main():
        async with serving(eng, max_restarts=2, restart_backoff_s=0.01,
                           tick_deadline=0.3) as srv:
            res = await stream_all(srv, prompts)
            assert [r["token_ids"] for r in res] == want
            assert srv.runner.restarts == 1 and len(clones) == 1
            assert len(srv.runner.rebuilds) == 1 and srv.runner.rebuilds[0]["rebuild_s"] >= 1.2

    run(main())


# ---------------------------------------------------------------------------
# retire and clone_fresh
# ---------------------------------------------------------------------------

def test_retired_engine_raises_and_clone_captures_its_own(tiny):
    """``retire`` drops every captured step (a call raises rather than
    replay), releases the pool's pages and makes ``step`` raise;
    ``clone_fresh`` builds a fresh pool and runs (captures, on the card)
    each bucket the dead engine had, before it serves."""
    eng = engine(tiny, max_slots=4)
    for j, p in enumerate(tiled_prompts(5)):
        eng.submit(p, NEW_TOKENS, seed=j)
    for _ in range(3):
        eng.step()
    runs = eng.graph_steps()
    counts = eng.compile_counts()
    assert runs and counts["mixed_step"] == len(runs)
    new = eng.clone_fresh()
    assert eng.retired and eng.pool.pages is None and eng.graph_steps() == []
    assert eng.pool.stats()["kv_bytes_total"] == 0
    with pytest.raises(RuntimeError, match="retired"):
        eng.step()
    for r in runs:
        assert r.retired and r.graph is None
        with pytest.raises(RuntimeError, match="retired"):
            r()
    assert new.compile_counts() == counts and new.pool.stats()["allocated"] == 0
    assert new.metrics is eng.metrics and new._next_id == eng._next_id
    eng.retire()  # idempotent
    step = graphs.CapturedStep(lambda: None, torch.device("cpu"), "probe")
    step()
    step.retire()
    with pytest.raises(RuntimeError, match="probe"):
        step()
    # the fleet's contract: a peer's captured buckets are captured here
    # (the retired source's, as it had them); nothing new to capture
    new.share_compiled_steps(eng)
    assert new.compile_counts() == counts


def test_clone_fresh_carries_the_host_tier_and_every_option(tiny):
    """The clone keeps the host tier (its entries survive the restart, so
    the empty pool restores a spilled prefix instead of re-prefilling it),
    the injector, journal and request log, and every constructor
    option."""
    inj = faults.FaultInjector("decode@1000")
    tier = serve.HostTier(1 << 20)
    tier.policy = "always"
    eng = engine(tiny, num_blocks=8, enable_prefix_cache=True, host_tier=tier,
                 fault_injector=inj, max_queue=5, tick_token_budget=24)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 50, size=24).astype(np.int32) for _ in range(4)]
    for p in prompts:
        eng.submit(p, 2)
        eng.run_until_complete()
        tier.drain()
    assert eng.metrics.snapshot()["tier_spilled_blocks"] > 0
    new = eng.clone_fresh()
    for name in ("host_tier", "faults", "journal", "request_log", "metrics", "sampler",
                 "stop_tokens", "block_size", "max_seq_len", "prefill_chunk", "cache_dtype",
                 "mixed_step_mode", "sample_epilogue_mode", "tick_token_budget", "spec_k",
                 "clock", "device"):
        assert getattr(new, name) is getattr(eng, name) or getattr(new, name) == getattr(eng, name)
    assert new.scheduler.max_queue == 5 and new.pool.prefix_cache is not None
    before = new.metrics.snapshot()["tier_restored_blocks"]
    new.submit(prompts[0], 2)
    new.run_until_complete()
    assert new.metrics.snapshot()["tier_restored_blocks"] > before


# ---------------------------------------------------------------------------
# HTTP chaos sites against the retrying client
# ---------------------------------------------------------------------------

@pytest.mark.http
@pytest.mark.parametrize("spec,site,retries", [("http_429@1:2=0", "http_429", 2),
                                               ("http_reset@1", "http_reset", 1)])
def test_http_sites_against_the_retrying_client(tiny, spec, site, retries):
    """``http_429`` rejects with 429 + Retry-After and ``http_reset`` aborts
    the socket before the first token: the port's client retries both and
    gets the uninterrupted tokens; a reset stream's request is aborted
    server-side and its blocks come back."""
    prompts = tiled_prompts(7, lens=(5,))
    want = direct_tokens(engine(tiny), prompts, n=4)
    inj = faults.FaultInjector(spec)
    eng = engine(tiny, fault_injector=inj)

    async def main():
        async with serving(eng) as srv:
            res = await astream_completion(
                srv.host, srv.port, {"prompt": [int(t) for t in prompts[0]], "max_tokens": 4,
                                     "seed": 0, "stream": True}, retries=3, backoff_s=0.02)
            assert res["status"] == 200 and res["retries"] == retries
            assert res["token_ids"] == want[0] and res["finish_reason"] == "length"
            assert inj.injected[site] == retries
            await until(lambda: eng.pool.stats()["request_held"] == 0)
            snap = eng.metrics.snapshot()
            assert snap["aborted"] == (1 if site == "http_reset" else 0)

    run(main())

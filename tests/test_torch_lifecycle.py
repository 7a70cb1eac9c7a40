"""The fleet lifecycle in the port (``serve/lifecycle.py``, the engine's
``actions`` hooks, rolling upgrades through ``serve/replica.py`` and the
HTTP admin plane) against the JAX package's, on the CPU in float32.

Policies first, with no engine: ``ActionPolicy`` and ``Autoscaler``
verdicts, budgets, ``Retry-After`` values and snapshots equal the JAX
classes' on identical outlier and burn sequences under a fake clock.
Then engines of both packages on the same numpy weights: the shed-prefill
engage and revert under an injected ``host_sync`` window whose 20 ms
advance the engines' clock (no wall-clock sleep), the burn spike that
sheds load, rolling upgrades over the same trace (tokens, version tags,
request-log lines, lifecycle counters; the fleet of one; ``upgrade_ckpt``
clean aborts; one checkpoint read a roll; the journal's
``weights_version`` round trip; the source journal terminated on a
drain; a roll onto a second weight set), the ``LifecycleController``,
and the HTTP surface: ``POST /admin/upgrade`` and ``/admin/scale``, the
409 of a concurrent admin call and the 503-first shedding.
"""

import asyncio
import dataclasses
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import engine as jengine_mod
from llm_np_cp_tpu.serve import faults as jfaults
from llm_np_cp_tpu.serve import lifecycle as jlifecycle
from llm_np_cp_tpu.serve.http.server import HttpServer as JHttpServer
from llm_np_cp_tpu.serve.journal import iter_records as jiter_records
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import engine as engine_mod
from llm_np_cp_tpu_torch.serve import faults, lifecycle
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get, http_post
from llm_np_cp_tpu_torch.serve.http.server import EngineRunner, HttpServer
from llm_np_cp_tpu_torch.serve.journal import iter_records
from test_torch_http import np_params, run

pytestmark = pytest.mark.http


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
    jfaults.install(None)


@pytest.fixture(scope="module")
def tiny():
    """(port config, port params, JAX config, JAX params) on the same
    numpy weights, and a second weight set (the upgrade's)."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp, npp2 = np_params(cfg, 0), np_params(cfg, 1)
    return types.SimpleNamespace(
        cfg=cfg, tp=params_from_jax(npp, device="cpu"), tp2=params_from_jax(npp2, device="cpu"),
        jcfg=jcfg, jp=jax.tree.map(jnp.asarray, npp), jp2=jax.tree.map(jnp.asarray, npp2))


def port_engine(m, params=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("mixed_step", "on")
    return serve.ServeEngine(m.tp if params is None else params, m.cfg,
                             sampler=Sampler("greedy"), cache_dtype=torch.float32,
                             device="cpu", **kw)


def jax_engine(m, params=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("mixed_step", "on")
    return jserve.ServeEngine(m.jp if params is None else params, m.jcfg,
                              sampler=JSampler(kind="greedy"), cache_dtype=jnp.float32, **kw)


def streams(fleet):
    return [list(r.generated) for r in fleet.finished]


def trace_prompts(seed, n, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


class FakeClock:
    """A clock that moves only when told: ``tick_us`` a read, plus whatever
    ``sleep`` adds."""

    def __init__(self, t=0.0, tick_us=0.0):
        self.t, self.step = t, tick_us * 1e-6

    def now(self):
        self.t += self.step
        return self.t

    def sleep(self, s):
        self.t += s


class FakeTracker:
    """A burn-rate stub: the policy reads only ``burn_rate`` (the metrics
    hand it each terminal, which it ignores)."""

    def __init__(self, burn):
        self.burn = burn

    def burn_rate(self, window):
        return self.burn

    def observe(self, req):  # a served request's verdict: not tracked
        pass

    def snapshot(self):
        return {}


# ----------------------------------------------------------------------
# policies, held to the JAX classes verdict for verdict
# ----------------------------------------------------------------------

def _anom(phase="host_sync"):
    return [{"phase": phase}]


# name → (policy keywords, a sequence of (outliers, burn, seconds to advance))
POLICY_SEQUENCES = {
    "shed_prefill": (dict(engage_streak=3, release_clean=4, min_flip_interval_s=0.0),
                     [(_anom(), None, 0.0)] * 3 + [(_anom("deliver"), None, 0.0)]
                     + [([], None, 0.0)] * 4 + [(_anom(), None, 0.0)] * 5),
    "shed_load": (dict(burn_threshold=2.0, burn_clear_frac=0.5, min_flip_interval_s=0.0),
                  [([], b, 0.0) for b in (1.5, 10.0, 1.5, 0.9, 40.0, 100.0, 3.0, 1.0)]),
    "rate_limit": (dict(burn_threshold=2.0, min_flip_interval_s=5.0),
                   [([], 10.0, 0.0), ([], 0.0, 1.0), ([], 0.0, 6.0), ([], 10.0, 1.0),
                    ([], 10.0, 5.0)]),
    "both": (dict(engage_streak=2, release_clean=3, burn_threshold=1.5, shed_frac=0.25,
                  min_flip_interval_s=0.5),
             [(_anom(), 3.0, 0.3), (_anom(), 3.0, 0.3), ([], 0.2, 0.3), ([], 0.2, 0.3),
              ([], 0.2, 0.3), (_anom(), 9.0, 1.0)]),
}


@pytest.mark.parametrize("name", sorted(POLICY_SEQUENCES))
def test_action_policy_matches_jax(name):
    kw, seq = POLICY_SEQUENCES[name]
    clocks = FakeClock(), FakeClock()
    port = lifecycle.ActionPolicy(clock=clocks[0].now, **kw)
    ref = jlifecycle.ActionPolicy(clock=clocks[1].now, **kw)
    for outliers, burn, dt in seq:
        for c in clocks:
            c.t += dt
        slo = FakeTracker(burn) if burn is not None else None
        assert port.on_tick(outliers, slo) == ref.on_tick(outliers, slo)
        assert port.plan_budget(100, 8) == ref.plan_budget(100, 8)
        assert (port.shedding, port.retry_after()) == (ref.shedding, ref.retry_after())
        assert port.state_args() == ref.state_args()
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["actions_total"]


def test_action_policy_pinned_values_spawn_and_validation():
    """The JAX test's pinned numbers, the share-nothing spawn, and the
    constructor's refusals (same messages as the JAX class)."""
    p = lifecycle.ActionPolicy(engage_streak=3, release_clean=4, min_flip_interval_s=0.0)
    for _ in range(3):
        p.on_tick(_anom(), None)
    assert p.plan_budget(100, 8) == 8 + int(92 * 0.5)
    q = lifecycle.ActionPolicy(burn_threshold=2.0, min_flip_interval_s=0.0)
    assert q.on_tick([], FakeTracker(10.0)) == ["shed_load_on"] and q.retry_after() == 5.0
    s = q.spawn()
    assert s is not q and s.burn_threshold == 2.0 and not s.shedding
    s.on_tick([], FakeTracker(100.0))
    assert s.retry_after() == 30.0  # bounded
    for bad in (dict(burn_threshold=0), dict(burn_clear_frac=0.0), dict(engage_streak=0),
                dict(shed_frac=1.5)):
        with pytest.raises(ValueError) as err:
            lifecycle.ActionPolicy(**bad)
        with pytest.raises(ValueError) as jerr:
            jlifecycle.ActionPolicy(**bad)
        assert str(err.value) == str(jerr.value)


def test_autoscaler_matches_jax():
    """Verdicts and cooldowns on a seeded walk of queue depths and burn
    rates, against the JAX class (and the JAX test's pinned sequence)."""
    kw = dict(min_replicas=1, max_replicas=3, scale_up_queue_depth=4.0, scale_up_burn=2.0,
              scale_down_queue_depth=0.5, cooldown_s=10.0)
    clocks = FakeClock(), FakeClock()
    port = lifecycle.Autoscaler(clock=clocks[0].now, **kw)
    ref = jlifecycle.Autoscaler(clock=clocks[1].now, **kw)
    rng = np.random.default_rng(7)
    n, verdicts = 1, []
    for _ in range(200):
        dt = float(rng.choice([0.0, 3.0, 11.0]))
        for c in clocks:
            c.t += dt
        depth = float(rng.choice([0.0, 0.3, 2.0, 5.0, 9.0]))
        burn = float(rng.choice([0.0, 0.5, 1.5, 5.0]))
        v = port.verdict(n_replicas=n, queue_depth_per_replica=depth, burn_5m=burn)
        assert v == ref.verdict(n_replicas=n, queue_depth_per_replica=depth, burn_5m=burn)
        n += v
        verdicts.append(v)
    assert {-1, 0, 1} <= set(verdicts)
    a = lifecycle.Autoscaler(clock=FakeClock().now, **kw)
    assert a.verdict(n_replicas=1, queue_depth_per_replica=8.0) == 1
    assert a.verdict(n_replicas=2, queue_depth_per_replica=8.0) == 0  # cooldown
    with pytest.raises(ValueError, match="min_replicas"):
        lifecycle.Autoscaler(min_replicas=3, max_replicas=2)


def test_load_upgrade_params_and_cache():
    """The ``upgrade_ckpt`` chaos site and a raising loader both abort
    with ``UpgradeAborted`` (counted), as in JAX; ``cache_params_fn``
    loads once."""
    m = serve.ServeMetrics()
    inj = faults.FaultInjector("upgrade_ckpt@2")
    assert lifecycle.load_upgrade_params(lambda: "w", replica=0, faults=inj, metrics=m) == "w"
    with pytest.raises(lifecycle.UpgradeAborted) as err:
        lifecycle.load_upgrade_params(lambda: "w", replica=1, faults=inj, metrics=m,
                                      rolled=[0], version=3)
    assert err.value.rolled == [0] and err.value.version == 3 and "chaos" in str(err.value)

    def bad():
        raise OSError("shard vanished")

    with pytest.raises(lifecycle.UpgradeAborted, match="checkpoint load failed"):
        lifecycle.load_upgrade_params(bad, replica=2, metrics=m)
    assert m.snapshot()["lifecycle_actions"] == {"upgrade_aborted": 2}
    calls = []
    once = lifecycle.cache_params_fn(lambda: calls.append(1) or "w")
    assert [once(), once(), once()] == ["w"] * 3 and calls == [1]


# ----------------------------------------------------------------------
# the engine's auto-actions, both packages on the same clock
# ----------------------------------------------------------------------

def _fake_time(clock):
    """The ``time`` module with ``sleep`` moving ``clock`` instead: the
    ``host_sync`` chaos site's stall lands in the engines' clock."""
    names = {k: getattr(time, k) for k in dir(time) if not k.startswith("_")}
    return types.SimpleNamespace(**{**names, "sleep": clock.sleep})


def test_engine_shed_prefill_and_revert_matches_jax(tiny, monkeypatch):
    """An injected sustained ``host_sync`` regression (hits 8-14 stall
    20 ms, on the engines' clock): the sentinel names it, the policy
    engages shed-prefill after the streak, the budget shrinks (decode
    floor intact), and the action reverts once the window clears — the
    same counters, budgets, instants and tokens in both packages, and no
    capture during the window."""
    runs = {}
    for pkg in ("port", "jax"):
        clock = FakeClock(tick_us=1.0)
        mod = engine_mod if pkg == "port" else jengine_mod
        monkeypatch.setattr(mod, "time", _fake_time(clock))
        S = serve if pkg == "port" else jserve
        make = port_engine if pkg == "port" else jax_engine
        tracer = S.TraceRecorder(clock=clock.now)
        eng = make(tiny, clock=clock.now, tracer=tracer,
                   fault_injector=S.FaultInjector("host_sync@8:14=0.02"),
                   sentinel=S.TickSentinel(threshold=3.0, warmup_ticks=4),
                   actions=S.ActionPolicy(engage_streak=3, release_clean=8,
                                          min_flip_interval_s=0.0, clock=clock.now))
        eng.warmup([6], max_new_tokens=2)
        counts0 = dict(eng.compile_counts())
        budgets = []
        req = eng.submit([5] * 6, 48, seed=0,
                         callback=lambda r, t, d, e=eng: budgets.append(e._tick_budget()))
        eng.run_until_complete()
        snap = eng.metrics.snapshot()
        names = [e.get("name") for e in tracer.to_dict()["traceEvents"]]
        runs[pkg] = dict(acts=snap["lifecycle_actions"], anomalies=snap["anomaly_ticks"],
                         budgets=budgets, tokens=list(req.generated),
                         instants=names.count("lifecycle-action"),
                         full=eng.tick_token_budget, slots=eng.scheduler.max_slots,
                         captured=dict(eng.compile_counts()) == counts0,
                         shed=eng.actions.snapshot()["shed_prefill"])
    port, ref = runs["port"], runs["jax"]
    assert port["acts"] == ref["acts"] == {"shed_prefill_on": 1, "shed_prefill_off": 1}
    assert port["anomalies"] == ref["anomalies"] and port["anomalies"]["host_sync"] >= 3
    assert port["budgets"] == ref["budgets"] and port["tokens"] == ref["tokens"]
    assert port["instants"] == ref["instants"] == 2
    assert port["slots"] <= min(port["budgets"]) < port["full"] == port["budgets"][-1]
    assert port["captured"] and not port["shed"]


def test_engine_burn_spike_sheds_load_and_reverts_matches_jax(tiny):
    """Every request misses a tight TTFT (a fake second between submit and
    first token): the burn crosses the threshold, shed_load engages with a
    burn-scaled Retry-After, and once the window ages out fresh traffic
    releases it — the same verdicts in both packages."""
    out = {}
    for pkg in ("port", "jax"):
        S = serve if pkg == "port" else jserve
        clock = FakeClock()
        eng = (port_engine if pkg == "port" else jax_engine)(
            tiny, clock=clock.now,
            actions=S.ActionPolicy(burn_threshold=2.0, min_flip_interval_s=0.0,
                                   clock=clock.now))
        eng.metrics.slo = S.SLOTracker(S.SLOPolicy(ttft_s=0.05, target=0.99), clock=clock.now)
        srv = (HttpServer if pkg == "port" else JHttpServer)(eng, model_id="tiny")  # runner built, not started
        seen = [srv._shed_retry_after()]
        for i in range(5):
            eng.submit([3] * 4, 2, seed=i)
            clock.t += 1.0
            eng.run_until_complete()
        seen.append(srv._shed_retry_after())
        burn = eng.metrics.snapshot()["slo_burn_rate_5m"]
        clock.t += 400.0
        for i in range(3):
            eng.submit([3] * 4, 2, seed=10 + i)
            eng.run_until_complete()
        seen.append(srv._shed_retry_after())
        out[pkg] = (seen, burn, eng.metrics.snapshot()["lifecycle_actions"])
    assert out["port"] == out["jax"]
    seen, burn, acts = out["port"]
    assert seen[0] is None and seen[1] >= 1.0 and seen[2] is None and burn > 2.0
    assert acts == {"shed_load_on": 1, "shed_load_off": 1}


def test_idle_runner_releases_shed_load(tiny):
    """An idle runner's loop passes feed the policy too: shed_load 503s the
    fresh work whose ticks would release it."""
    eng = port_engine(tiny, actions=serve.ActionPolicy(burn_threshold=2.0,
                                                       min_flip_interval_s=0.0))
    eng.metrics.slo = FakeTracker(10.0)
    eng._actions_tick([])
    assert eng.actions.shedding
    eng.metrics.slo = FakeTracker(0.0)
    runner = EngineRunner(eng)
    runner.start()
    try:
        deadline = time.monotonic() + 5.0
        while eng.actions.shedding and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not eng.actions.shedding
    finally:
        runner.stop(timeout=5.0)


# ----------------------------------------------------------------------
# rolling upgrades, both packages over the same trace
# ----------------------------------------------------------------------

def _fleet_pair(tiny, n, **kw):
    return (serve.ReplicaSet([port_engine(tiny, **kw) for _ in range(n)]),
            jserve.ReplicaSet([jax_engine(tiny, **kw) for _ in range(n)]))


def test_rolling_upgrade_matches_jax(tiny, tmp_path):
    """16 live streams across a full 3-replica roll in both packages:
    no stream dropped, tokens equal to an unrolled fleet and to the JAX
    fleet's, every request-log line reports the version that admitted it
    (0), some drained, three ``upgrade_replica`` actions, the rolled
    replicas captured what they had (no capture left for a serving tick),
    and post-roll admissions carry version 1."""
    prompts = trace_prompts(11, 16, 3, 14)
    control = serve.ReplicaSet([port_engine(tiny) for _ in range(3)])
    for i, p in enumerate(prompts):
        control.submit(p, 6, seed=i)
    control.run_until_complete()
    want = streams(control)

    log = serve.RequestLog(str(tmp_path / "req.log"))
    jlog = jserve.RequestLog(str(tmp_path / "jreq.log"))
    fleets = (serve.ReplicaSet([port_engine(tiny, request_log=log) for _ in range(3)]),
              jserve.ReplicaSet([jax_engine(tiny, request_log=jlog) for _ in range(3)]))
    outs = []
    for fleet, params in zip(fleets, (tiny.tp, tiny.jp)):
        for e in fleet.engines:
            e.warmup([3], max_new_tokens=6)
        counts0 = dict(fleet.engines[0].compile_counts())
        for i, p in enumerate(prompts):
            fleet.submit(p, 6, seed=i)
        for _ in range(2):
            fleet.step()
        assert any(e._requests for e in fleet.engines)
        out = fleet.rolling_upgrade(lambda: params, version=1, steps_between=1)
        rolled_counts = [dict(e.compile_counts()) for e in fleet.engines]
        fleet.run_until_complete()
        acts = sum(e.metrics.snapshot().get("lifecycle_actions", {}).get("upgrade_replica", 0)
                   for e in fleet.engines)
        post = fleet.submit(prompts[0], 2, seed=99)
        fleet.run_until_complete()
        outs.append((out, streams(fleet)[:16], [e.weights_version for e in fleet.engines],
                     acts, post.extra["weights_version"]))
        if fleet is fleets[0]:
            assert rolled_counts == [counts0] * 3
    assert outs[0] == outs[1]
    out, got, versions, acts, post_version = outs[0]
    assert out["rolled"] == [0, 1, 2] and out["drained"] > 0
    assert got == want and versions == [1, 1, 1] and acts == 3 and post_version == 1
    for lg in (log, jlog):
        lg.flush(5.0)
        lg.close()
    lines = serve.read_request_log(str(tmp_path / "req.log"))
    jlines = jserve.read_request_log(str(tmp_path / "jreq.log"))
    assert len(lines) == len(jlines) == 17
    pick = ("weights_version", "drains", "replays", "reason", "tokens_out")
    key = lambda ln: ln["rid"]  # noqa: E731
    assert ([{k: ln.get(k) for k in pick} for ln in sorted(lines, key=key)]
            == [{k: ln.get(k) for k in pick} for ln in sorted(jlines, key=key)])
    assert sorted(ln["weights_version"] for ln in lines) == [0] * 16 + [1]
    assert any(ln["drains"] >= 1 for ln in lines)


def test_roll_onto_new_weights_matches_jax(tiny):
    """A roll onto a second weight set: streams admitted before it keep
    their version tag and finish (teacher-forced on peers, then on the
    new weights where no old-version peer is left), post-roll traffic
    samples the new weights on every replica — equal to the JAX fleet's
    tokens — and each rolled replica captured the buckets it had."""
    prompts = trace_prompts(3, 6)
    fleets = _fleet_pair(tiny, 2)
    got = []
    for fleet, new in zip(fleets, (tiny.tp2, tiny.jp2)):
        for e in fleet.engines:
            e.warmup([3], max_new_tokens=4)
        counts0 = dict(fleet.engines[0].compile_counts())
        reqs = [fleet.submit(p, 5, seed=i) for i, p in enumerate(prompts)]
        fleet.step()
        fleet.rolling_upgrade(lambda: new, version=2, steps_between=0)
        after = [fleet.submit(prompts[0], 5, seed=0, replica=i) for i in (0, 1)]
        fleet.run_until_complete()
        got.append(([list(r.generated) for r in reqs + after],
                    [r.extra["weights_version"] for r in reqs + after]))
        if fleet is fleets[0]:
            assert all(dict(e.compile_counts()) == counts0 for e in fleet.engines)
            assert all(e.params is new for e in fleet.engines)
    assert got[0] == got[1]
    tokens, versions = got[0]
    assert versions == [0] * 6 + [2, 2] and tokens[-1] == tokens[-2]


def test_fleet_of_one_roll_replays_in_place(tiny):
    """One replica has no peer: the roll replays its in-flight streams in
    place on the rebuilt engine (teacher-forced), as in JAX."""
    prompts = trace_prompts(41, 4)
    control = serve.ReplicaSet([port_engine(tiny)])
    for i, p in enumerate(prompts):
        control.submit(p, 6, seed=i)
    control.run_until_complete()
    got = []
    for fleet, params in zip(_fleet_pair(tiny, 1), (tiny.tp, tiny.jp)):
        for i, p in enumerate(prompts):
            fleet.submit(p, 6, seed=i)
        fleet.step()
        assert fleet.engines[0]._requests
        out = fleet.rolling_upgrade(lambda: params, version=1, steps_between=0)
        assert out["rolled"] == [0] and fleet.alive == [True]
        fleet.run_until_complete()
        got.append((streams(fleet), fleet.engines[0].weights_version))
    assert got[0] == got[1] == (streams(control), 1)


def test_upgrade_ckpt_chaos_aborts_cleanly(tiny):
    """The checkpoint read fails while rolling replica 1: ``UpgradeAborted``
    naming the rolled prefix, replica 1 live on its old weights, every
    stream completing with the unrolled tokens — as in JAX."""
    prompts = trace_prompts(5, 8)
    control = serve.ReplicaSet([port_engine(tiny) for _ in range(3)])
    for i, p in enumerate(prompts):
        control.submit(p, 5, seed=i)
    control.run_until_complete()
    got = []
    for pkg, params in (("port", tiny.tp), ("jax", tiny.jp)):
        S = serve if pkg == "port" else jserve
        make = port_engine if pkg == "port" else jax_engine
        inj = S.FaultInjector("upgrade_ckpt@2")
        fleet = S.ReplicaSet([make(tiny, fault_injector=inj) for _ in range(3)])
        for i, p in enumerate(prompts):
            fleet.submit(p, 5, seed=i)
        fleet.step()
        with pytest.raises(S.UpgradeAborted) as err:
            fleet.rolling_upgrade(lambda: params, version=1)
        alive = list(fleet.alive)
        fleet.run_until_complete()
        aborted = sum(e.metrics.snapshot().get("lifecycle_actions", {})
                      .get("upgrade_aborted", 0) for e in fleet.engines)
        got.append((err.value.rolled, alive, [e.weights_version for e in fleet.engines],
                    streams(fleet), aborted))
    assert got[0] == got[1] == ([0], [True] * 3, [1, 0, 0], streams(control), 1)


def test_checkpoint_loaded_once_per_roll(tiny):
    fleet = serve.ReplicaSet([port_engine(tiny) for _ in range(3)])
    calls = []
    fleet.rolling_upgrade(lambda: calls.append(1) or tiny.tp, version=1, steps_between=0)
    assert calls == [1] and [e.weights_version for e in fleet.engines] == [1, 1, 1]
    assert fleet.snapshot()["weights_versions"] == [1, 1, 1]


def test_weights_version_journal_roundtrip(tiny, tmp_path):
    """Admission records journal the serving version (the same records as
    the JAX journal's), it survives compaction and the scan, and the
    runner's replay into an engine on a newer version re-stamps the
    original one."""
    recs = {}
    for pkg in ("port", "jax"):
        S = serve if pkg == "port" else jserve
        path = str(tmp_path / f"j.{pkg}")
        j = S.RequestJournal(path, compact_bytes=1)
        eng = (port_engine if pkg == "port" else jax_engine)(tiny, journal=j, weights_version=3)
        req = eng.submit([7] * 6, 8, seed=1)
        assert req.extra["weights_version"] == 3
        for _ in range(3):
            eng.step()
        assert j.flush(5.0)
        recs[pkg] = [(r.get("t"), r.get("wv")) for r in
                     (iter_records if pkg == "port" else jiter_records)(path)]
        j.close()
        state, _, _ = S.scan_journal(path)
        assert state[req.req_id]["wv"] == 3
    assert recs["port"] == recs["jax"] and ("adm", 3) in recs["port"]
    j2 = serve.RequestJournal(str(tmp_path / "j.port"))
    eng2 = port_engine(tiny, journal=j2, weights_version=5)
    srv = HttpServer(eng2, model_id="tiny")
    assert srv.runner.journal_replayed == 1
    assert next(iter(eng2._requests.values())).extra["weights_version"] == 3
    eng2.run_until_complete()
    j2.close()


def test_direct_drain_terminates_source_journal(tiny, tmp_path):
    """``remove_replica`` writes a ``drained`` terminal into the source
    replica's journal segment for every moved stream (the peer's journal
    re-admits it), so no segment replays it twice; the removed replica is
    retired and its stream tokens equal the JAX fleet's."""
    got = []
    for pkg in ("port", "jax"):
        S = serve if pkg == "port" else jserve
        paths = [str(tmp_path / f"{pkg}.{i}") for i in range(2)]
        js = [S.RequestJournal(p) for p in paths]
        make = port_engine if pkg == "port" else jax_engine
        fleet = S.ReplicaSet([make(tiny, journal=js[i]) for i in range(2)])
        for i in range(6):
            fleet.submit([5 + i] * 6, 6, seed=i)
        for _ in range(2):
            fleet.step()
        victim = next(i for i, e in enumerate(fleet.engines) if e._requests)
        drained = fleet.remove_replica(victim)
        assert drained
        if pkg == "port":
            assert fleet.engines[victim].retired and fleet.engines[victim].pool.pages is None
        fleet.run_until_complete()
        for j in js:
            assert j.flush(5.0)
            j.close()
        assert [S.scan_journal(p)[0] for p in paths] == [{}, {}]
        got.append((victim, drained, streams(fleet)))
    assert got[0] == got[1]


def test_lifecycle_controller_autoscales_and_serializes(tiny):
    """Deep queues scale up, a quiet fleet scales down (cooldown-gated,
    draining through the peer path, floor 1); a roll started inside a
    roll is refused."""
    clock = FakeClock()
    fleet = serve.ReplicaSet([port_engine(tiny)])
    ctl = serve.LifecycleController(fleet, autoscaler=serve.Autoscaler(
        min_replicas=1, max_replicas=2, scale_up_queue_depth=3.0,
        scale_down_queue_depth=0.5, cooldown_s=5.0, clock=clock.now))
    prompt = np.arange(1, 10, dtype=np.int32)
    for i in range(8):
        fleet.submit(prompt, 3, seed=i)
    assert ctl.autoscale_tick() == 1
    assert len(fleet.engines) == 2 and fleet.alive == [True, True]
    assert ctl.autoscale_tick() == 0
    fleet.run_until_complete()
    clock.t += 6.0
    assert ctl.autoscale_tick() == -1 and sum(fleet.alive) == 1
    clock.t += 6.0
    assert ctl.autoscale_tick() == 0
    assert len(fleet.finished) == 8

    def reentrant():
        with pytest.raises(RuntimeError, match="already in progress"):
            ctl.rolling_upgrade(lambda: tiny.tp)
        return tiny.tp

    out = ctl.rolling_upgrade(reentrant, version=1, steps_between=0)
    assert out["version"] == 1 and ctl.roll_history == [out] and not ctl.roll_active


# ----------------------------------------------------------------------
# the HTTP admin plane
# ----------------------------------------------------------------------

def direct(tiny, prompts, n):
    """Each prompt's greedy tokens from one uninterrupted port engine (the
    fleets above hold the port's engines to the JAX package's)."""
    eng = port_engine(tiny)
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run_until_complete()
    return [list(r.generated) for r in reqs]


def slowed(eng, seconds=0.01):
    """Slow each tick (so an admin call lands while streams are live)."""
    step = eng.step

    def slow():
        time.sleep(seconds)
        return step()

    eng.step = slow
    return eng


def test_http_admin_upgrade_fleet(tiny):
    """``POST /admin/upgrade`` on a live 2-replica fleet: every stream
    completes with the JAX package's offline tokens, ``/healthz`` and the
    scrape report version 1, a second concurrent upgrade gets 409, and a
    loader that raises answers 500 with the fleet still serving."""
    engines = [slowed(port_engine(tiny)) for _ in range(2)]
    runner = serve.ReplicaRunner(engines, spill_queue_depth=None)
    ps = [list(map(int, p)) for p in trace_prompts(31, 6)]
    gate = threading.Event()

    def loader(body):
        gate.wait(10.0)
        if body.get("model") == "broken":
            raise OSError("checkpoint shard vanished")
        return tiny.tp

    async def main():
        srv = HttpServer(engines[0], model_id="tiny", drain_timeout=10.0, runner=runner,
                         upgrade_loader=loader)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        tasks = [asyncio.create_task(astream_completion(
            srv.host, srv.port, {"prompt": p, "max_tokens": 24, "stream": True}, timeout=60))
            for p in ps]
        while runner.inflight < len(ps):
            await asyncio.sleep(0.002)
        first = loop.run_in_executor(None, http_post, srv.host, srv.port, "/admin/upgrade", {})
        await asyncio.sleep(0.05)
        st2, body2 = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                                "/admin/upgrade", {})
        assert st2 == 409, body2
        gate.set()
        st, body = await first
        assert st == 200 and body == {"rolled": [0, 1], "version": 1}, body
        want = direct(tiny, ps, 24)
        for w, res in zip(want, await asyncio.gather(*tasks)):
            assert res["status"] == 200 and res["finish_reason"] == "length"
            assert res["token_ids"] == w
        st, hz = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
        assert st == 200
        assert [r["weights_version"] for r in json.loads(hz)["replicas"]] == [1, 1]
        _, scrape = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
        text = scrape.decode()
        assert 'version="1"' in text and 'replica="1"' in text
        assert 'llm_serve_lifecycle_actions_total{action="upgrade_replica"' in text
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/upgrade", {"model": "broken"})
        assert st == 500 and "checkpoint load failed" in body["error"] and body["rolled"] == []
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/upgrade", {"version": 0})
        assert st == 400
        res = await astream_completion(srv.host, srv.port,
                                       {"prompt": [6] * 5, "max_tokens": 3, "stream": True},
                                       timeout=30)
        assert res["status"] == 200
        assert [e.weights_version for e in runner.serving_engines()] == [1, 1]
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)


def test_http_admin_upgrade_single_engine_and_guards(tiny):
    """The fleet of one over HTTP: no loader → 404 with a hint; the roll
    replays in place and the stream finishes; ``/admin/scale`` answers
    400 on a single engine, as in JAX."""
    eng = slowed(port_engine(tiny))

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        st, _ = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                           "/admin/upgrade", {})
        assert st == 404
        st, _ = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                           "/admin/scale", {"replicas": 2})
        assert st == 400
        srv.upgrade_loader = lambda body: tiny.tp
        task = asyncio.create_task(astream_completion(
            srv.host, srv.port, {"prompt": [6] * 12, "max_tokens": 12, "stream": True},
            timeout=60))
        while srv.runner.inflight < 1:
            await asyncio.sleep(0.002)
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/upgrade", {"version": 4})
        assert st == 200 and body == {"rolled": [0], "version": 4}, body
        res = await task
        assert res["status"] == 200 and res["token_ids"] == direct(tiny, [[6] * 12], 12)[0]
        assert srv.runner.engine.weights_version == 4
        assert srv.runner.engine is not eng and eng.retired
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)


def test_http_admin_scale_elastic_fleet(tiny):
    """``POST /admin/scale`` grows the fleet by one warmed clone (it has
    captured its source's buckets before the router can name it), serves
    through it, and shrinks back with a drain: indices stay stable, the
    removed replica reads ``removed`` and is retired."""
    engines = [port_engine(tiny) for _ in range(2)]
    for e in engines:
        e.warmup([6], max_new_tokens=2)
    runner = serve.ReplicaRunner(engines, spill_queue_depth=None)

    async def main():
        srv = HttpServer(engines[0], model_id="tiny", drain_timeout=10.0, runner=runner)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/scale", {"replicas": 3})
        assert st == 200 and body["replicas"] == 3 and body["added"] == [2], body
        added = runner.replicas[2].engine
        assert added.compile_counts() == engines[0].compile_counts()
        assert added.metrics is not engines[0].metrics and added.journal is None
        outs = await asyncio.gather(*(astream_completion(
            srv.host, srv.port, {"prompt": [8 + i] * 6, "max_tokens": 3, "stream": True},
            timeout=30) for i in range(6)))
        assert all(o["status"] == 200 for o in outs)
        assert added.metrics.snapshot()["finished"] >= 1
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/scale", {"replicas": 1})
        assert st == 200 and body["replicas"] == 1 and body["removed"] == [2, 1], body
        states = {r["replica"]: r["state"] for r in body["states"]}
        assert states == {0: "ok", 1: "removed", 2: "removed"}
        assert added.retired and added.pool.pages is None
        st, body = await loop.run_in_executor(None, http_post, srv.host, srv.port,
                                              "/admin/scale", {"replicas": 0})
        assert st == 400
        res = await astream_completion(srv.host, srv.port,
                                       {"prompt": [9] * 6, "max_tokens": 3, "stream": True},
                                       timeout=30)
        assert res["status"] == 200
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)


async def until_async(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        await asyncio.sleep(0.005)


def test_http_503_first_load_shedding(tiny):
    """Fresh completions get 503 with the policy's Retry-After while it
    sheds, ``/healthz`` stays 200, and admission reopens on release; a
    removed replica's frozen verdict never sheds the fleet."""
    eng = port_engine(tiny, actions=serve.ActionPolicy(min_flip_interval_s=0.0))
    eng.metrics.slo = FakeTracker(0.0)
    fleet_engines = [port_engine(tiny, actions=serve.ActionPolicy(min_flip_interval_s=0.0))
                     for _ in range(2)]
    fleet = serve.ReplicaRunner(fleet_engines, spill_queue_depth=None)
    req = {"prompt": [4] * 5, "max_tokens": 3, "stream": True}

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        assert (await astream_completion(srv.host, srv.port, req, timeout=30))["status"] == 200
        # the burn drives the runner's own (idle) ticks: engage, then release
        eng.metrics.slo = FakeTracker(10.0)
        await until_async(lambda: eng.actions.shedding)
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        body = json.dumps(req).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\nConnection: close\r\n\r\n" + body)
        await writer.drain()
        head = (await reader.read()).decode()
        writer.close()
        assert head.startswith("HTTP/1.1 503") and "Retry-After: 5\r\n" in head
        assert "load shedding" in head
        st, _ = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
        assert st == 200
        eng.metrics.slo = FakeTracker(0.0)
        await until_async(lambda: not eng.actions.shedding)
        assert (await astream_completion(srv.host, srv.port, req, timeout=30))["status"] == 200
        srv.begin_drain()
        await srv.serve_until_shutdown()

        srv = HttpServer(fleet_engines[0], model_id="tiny", drain_timeout=10.0, runner=fleet)
        await srv.start("127.0.0.1", 0)
        fleet_engines[1].metrics.slo = FakeTracker(100.0)
        await until_async(lambda: fleet_engines[1].actions.shedding)
        assert srv._shed_retry_after() == 30.0
        await loop.run_in_executor(None, fleet.remove_replica, 1)
        assert srv._shed_retry_after() is None
        assert (await astream_completion(srv.host, srv.port, req, timeout=30))["status"] == 200
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)

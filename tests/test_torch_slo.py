"""SLO accounting and the tick sentinel in the port (``serve/slo.py``, the
metrics' ``slo`` tracker and its scrape series, the engine's sentinel
hook and ``GET /debug/slo``) against the JAX package's, on the CPU.

Verdicts of one set of requests, ``SLOTracker`` snapshots and burn rates
under one injected clock, ``aggregate_slo`` over several trackers, the
rolling windows, and the sentinel's outliers on one synthetic phase
series (spikes, a regression that re-baselines, a roofline-deficit
pseudo-phase) equal the JAX module's.  The served engines' trackers
(``observe_parity``) give equal verdict counts, and the scrape's SLO
lines equal the JAX scrape's.
"""

import asyncio
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import observe_parity as op
from llm_np_cp_tpu.serve import metrics as jmetrics
from llm_np_cp_tpu.serve import slo as jslo
from llm_np_cp_tpu_torch.serve import metrics, slo
from llm_np_cp_tpu_torch.serve.http.client import http_get
from test_torch_http import serving


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def requests(seed: int = 0, n: int = 60) -> list[SimpleNamespace]:
    """Terminal requests of every kind: timed, slow first token, slow
    decode, aborted with and without a token, single-token, recovered with
    no timestamps, realtime arrivals."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 7
        submit = float(rng.uniform(0, 100))
        first = submit + float(rng.uniform(0.01, 3.0))
        n_tok = int(rng.integers(1, 40))
        finish = first + n_tok * float(rng.uniform(0.005, 0.2))
        extra = {"arrival_wall": submit - 0.5} if kind == 6 else {}
        reason = "aborted" if kind in (3, 4) else "stop" if i % 2 else "length"
        r = SimpleNamespace(submit_time=submit, first_token_time=first, finish_time=finish,
                            generated=list(range(n_tok)), finish_reason=reason, extra=extra,
                            admit_time=None, prefill_s=0.0)
        if kind == 4:
            r.first_token_time, r.generated = None, []
        if kind == 5:
            r.submit_time = r.first_token_time = r.finish_time = None
        out.append(r)
    return out


@pytest.mark.parametrize("policy", [dict(ttft_s=1.0, tpot_s=0.1), dict(ttft_s=2.0),
                                    dict(tpot_s=0.05, target=0.9), dict()],
                         ids=["both", "ttft", "tpot", "none"])
def test_verdicts_equal_jax(policy):
    got, want = slo.SLOPolicy(**policy), jslo.SLOPolicy(**policy)
    for r in requests():
        assert dataclasses.asdict(got.verdict(r)) == dataclasses.asdict(want.verdict(r))
        assert got.verdict(r).to_dict() == want.verdict(r).to_dict()
    for bad in (dict(ttft_s=0), dict(tpot_s=-1), dict(target=1.0)):
        with pytest.raises(ValueError):
            slo.SLOPolicy(**bad)


def _tracker(mod, times, reqs, policy=dict(ttft_s=1.0, tpot_s=0.1)):
    t = [0.0]
    tracker = mod.SLOTracker(mod.SLOPolicy(**policy), clock=lambda: t[0])
    for now, r in zip(times, reqs):
        t[0] = now
        tracker.observe(r)
    t[0] = times[-1] + 30.0
    return tracker, t


def test_tracker_snapshot_and_burn_rates_equal_jax():
    """One injected clock over an hour and a half of terminals: counters,
    goodput, attainment and the 5m / 1h burn rates equal, at the end and
    after the windows slide."""
    reqs = requests(1, 200)
    times = sorted(np.random.default_rng(2).uniform(0, 5400, size=len(reqs)).tolist())
    got, gt = _tracker(slo, times, reqs)
    want, wt = _tracker(jslo, times, reqs)
    assert got.snapshot() == want.snapshot()
    for label in ("5m", "1h"):
        assert got.burn_rate(label) == want.burn_rate(label)
    gt[0] = wt[0] = times[-1] + 4000.0
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["slo_burn_rate_5m"] == 0.0
    assert got.n_untimed == sum(1 for r in reqs if r.submit_time is None)


def test_aggregate_slo_equals_jax():
    reqs = requests(3, 90)
    times = np.linspace(0, 600, len(reqs)).tolist()
    parts = [slice(0, 30), slice(30, 75), slice(75, 90)]
    got = [_tracker(slo, times[p], reqs[p])[0] for p in parts]
    want = [_tracker(jslo, times[p], reqs[p])[0] for p in parts]
    assert slo.aggregate_slo(got + [None]) == jslo.aggregate_slo(want + [None])
    assert slo.aggregate_slo([None]) == {} == jslo.aggregate_slo([])


def test_rolling_window_equals_jax():
    rng = np.random.default_rng(4)
    got, want = slo.RollingWindow(60.0, 6), jslo.RollingWindow(60.0, 6)
    for t in np.cumsum(rng.uniform(0, 7, size=300)):
        ok = bool(rng.random() < 0.8)
        got.add(t, ok)
        want.add(t, ok)
        assert got.totals(t) == want.totals(t)
    with pytest.raises(ValueError):
        slo.RollingWindow(0.0, 3)


def test_sentinel_outliers_equal_jax():
    """One synthetic tick-phase series — steady jitter, one-tick spikes, a
    lasting regression of host_sync, a roofline-deficit pseudo-phase —
    gives identical outliers (order, phases, excess) tick by tick, and
    equal baselines and counts."""
    rng = np.random.default_rng(5)
    got, want = slo.TickSentinel(warmup_ticks=16), jslo.TickSentinel(warmup_ticks=16)
    flagged = 0
    for i in range(400):
        t, phases = 0.0, []
        for name, base in (("admission", 20.0), ("mixed_dispatch", 60.0),
                           ("host_sync", 3000.0), ("deliver", 400.0)):
            dur = base * float(rng.uniform(0.9, 1.1))
            if i in (50, 120) and name == "deliver":
                dur *= 40
            if i >= 300 and name == "host_sync":
                dur *= 6  # a regression: pages, then re-baselines
            phases.append((name, t, t + dur))
            t += dur
        phases.append(("roofline_deficit", 0.0, 2000.0 * (5 if i == 200 else 1)))
        a, b = got.observe(tuple(phases)), want.observe(tuple(phases))
        assert a == b, i
        flagged += bool(a)
    assert flagged >= 3 and got.anomalies == want.anomalies
    assert got.anomalies["host_sync"] >= 1 and got.anomalies["deliver"] == 2
    assert got.baselines() == want.baselines() and got.ticks == want.ticks == 400
    with pytest.raises(ValueError):
        slo.TickSentinel(alpha=0.0)


def test_metrics_slo_series_equal_jax():
    """The same terminals through a ServeMetrics with a tracker: the
    snapshot's SLO block and the scrape's goodput / attainment / verdict /
    burn lines equal the JAX ones."""
    def fed(mod, smod):
        t = [10.0]
        m = mod.ServeMetrics(clock=lambda: t[0],
                             slo=smod.SLOTracker(smod.SLOPolicy(ttft_s=1.0, tpot_s=0.1),
                                                 clock=lambda: t[0]))
        for r in requests(6, 40):
            t[0] += 0.5
            m.on_submit(r)
            (m.on_abort if r.finish_reason == "aborted" else m.on_finish)(r)
        return m

    got, want = fed(metrics, slo), fed(jmetrics, jslo)
    gs, ws = got.snapshot(), want.snapshot()
    for key in ("slo_ok", "slo_miss", "slo_untimed", "goodput_tokens", "goodput_tok_s",
                "slo_attainment", "slo_burn_rate_5m", "slo_burn_rate_1h", "policy"):
        assert gs[key] == ws[key], key

    def slo_lines(text):
        return [ln for ln in text.splitlines()
                if any(k in ln for k in ("goodput", "slo_", "burn"))]

    assert slo_lines(got.prometheus()) == slo_lines(want.prometheus())
    assert len(slo_lines(got.prometheus())) >= 10


def test_served_verdicts_equal_jax():
    """The observed legs' trackers: equal verdict counts and goodput tokens
    (the aborted request a miss), per engine and per tenant."""
    for leg in ("mixed", "split", "spec"):
        got, want = op.run(leg, True), op.run(leg, False)
        for key in ("slo_ok", "slo_miss", "slo_untimed", "goodput_tokens"):
            assert got["snapshot"][key] == want["snapshot"][key], (leg, key)
        assert got["snapshot"]["slo_miss"] == 1
        for t, ent in got["tenants"]["tenants"].items():
            jent = want["tenants"]["tenants"][t]
            assert {k: ent["slo"][k] for k in ("slo_ok", "slo_miss", "goodput_tokens")} == {
                k: jent["slo"][k] for k in ("slo_ok", "slo_miss", "goodput_tokens")}


def test_debug_slo_route():
    """``GET /debug/slo`` answers the tracker's ``aggregate_slo`` view (404
    without one, as the idle-server test pins)."""
    eng = op.build(True, "mixed", max_slots=2, num_blocks=32)

    async def main():
        async with serving(eng) as srv:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, http_get, srv.host, srv.port, "/debug/slo")

    st, raw = asyncio.run(asyncio.wait_for(main(), 60))
    body = json.loads(raw)
    assert st == 200 and body == slo.aggregate_slo([eng.metrics.slo])
    assert body["policy"] == dict(op.POLICY, target=0.99)

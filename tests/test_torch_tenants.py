"""Multi-tenant accounting in the port (``serve/tenants.py``: the
``TenantLedger``, ``aggregate_tenants`` and the ``tenant="other"``
roll-up; the engine's in-flight cap, fair-share prefill order and
terminal billing; ``GET /debug/tenants`` and the tenant series of the
scrape) against the JAX package's, on the CPU.

Ledgers fed the same terminals and throttles under one clock give equal
snapshots, cost shares, Prometheus text (the top ``max_series`` tenants
and the rest rolled into ``tenant="other"``, counters conserved) and
``aggregate_tenants`` views.  The served engines (``observe_parity``,
fair-share prefill on) bill every tenant as the JAX engine does, and the
per-tenant sums conserve against the global ledgers; the in-flight cap
raises ``TenantThrottled`` (HTTP 429) as the JAX engine's does.
"""

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import observe_parity as op
from llm_np_cp_tpu.serve import scheduler as jscheduler
from llm_np_cp_tpu.serve import slo as jslo
from llm_np_cp_tpu.serve import tenants as jtenants
from llm_np_cp_tpu_torch.serve import TenantThrottled, slo, tenants
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
from test_torch_http import serving

FIELDS = ("requests", "tokens", "kv_bytes_read", "kv_bytes_written",
          "weight_bytes_amortized", "device_time_s", "throttled")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def terminals(seed: int, n: int = 80, n_tenants: int = 7) -> list[SimpleNamespace]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        submit = float(rng.uniform(0, 50))
        first = submit + float(rng.uniform(0.01, 2.0))
        gen = list(range(int(rng.integers(0, 30))))
        out.append(SimpleNamespace(
            tenant="default" if i % 5 == 0 else f"t{int(rng.integers(0, n_tenants))}",
            generated=gen, finish_reason=("aborted", "stop", "length")[i % 3],
            submit_time=submit, first_token_time=first if gen else None,
            finish_time=first + 0.05 * len(gen), extra={},
            kv_bytes_read=float(rng.uniform(0, 1e7)), kv_bytes_written=float(rng.uniform(0, 1e6)),
            weight_bytes_amortized=float(rng.uniform(0, 1e9)),
            device_time_s=float(rng.uniform(0, 0.1)), prefill_done=int(rng.integers(0, 64))))
    return out


def ledger(mod, smod, seed: int, **kw):
    t = [100.0]
    led = mod.TenantLedger(policy=smod.SLOPolicy(ttft_s=1.0, tpot_s=0.1), clock=lambda: t[0],
                           **kw)
    for i, r in enumerate(terminals(seed)):
        t[0] += 1.0
        led.on_terminal(r)
        if i % 9 == 0:
            led.on_throttle(r.tenant)
    return led


def test_ledger_snapshot_and_cost_shares_equal_jax():
    got, want = ledger(tenants, slo, 0), ledger(jtenants, jslo, 0)
    assert got.snapshot() == want.snapshot()
    live = terminals(1, 10)
    for use_bytes in (False, True):
        assert got.cost_shares(live, use_bytes=use_bytes) == want.cost_shares(
            live, use_bytes=use_bytes)
    snap = got.snapshot()["tenants"]
    assert sum(e["cost_share"] for e in snap.values()) == pytest.approx(1.0)
    assert all("slo" in e for e in snap.values())
    for bad in (dict(max_inflight=0), dict(max_series=0)):
        with pytest.raises(ValueError):
            tenants.TenantLedger(**bad)


@pytest.mark.parametrize("max_series", [2, 5, 20])
def test_prometheus_rollup_equals_jax(max_series):
    """The tenant series: the top ``max_series`` tenants by cost keep their
    labels, the rest sum into ``tenant="other"``; text equal to JAX's, and
    every counter conserved across the roll-up."""
    got = ledger(tenants, slo, 2, max_series=max_series)
    want = ledger(jtenants, jslo, 2, max_series=max_series)
    text = got.prometheus(const_labels={"version": "3"})
    assert text == want.prometheus(const_labels={"version": "3"})
    assert got.prometheus() == want.prometheus()
    snap = got.snapshot()["tenants"]
    assert (f'tenant="{tenants.OTHER_TENANT}"' in text) == (len(snap) > max_series)
    total = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                if ln.startswith("llm_serve_tenant_requests_total{"))
    assert total == sum(e["requests"] for e in snap.values())
    assert tenants.OTHER_TENANT == jtenants.OTHER_TENANT == "other"


def test_aggregate_tenants_equals_jax():
    got = [ledger(tenants, slo, s) for s in (3, 4)] + [None]
    want = [ledger(jtenants, jslo, s) for s in (3, 4)] + [None]
    assert tenants.aggregate_tenants(got) == jtenants.aggregate_tenants(want)
    agg = tenants.aggregate_tenants(got)
    for t, ent in agg["tenants"].items():
        for key in FIELDS:
            assert ent[key] == pytest.approx(sum(
                led.snapshot()["tenants"].get(t, {}).get(key, 0) for led in got[:2]))
    assert tenants.aggregate_tenants([None]) == {}


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_served_ledgers_equal_jax_and_conserve(leg):
    """Fair-share prefill on: the same tokens as the JAX engine, each
    tenant's requests, tokens, reasons and billed bytes equal, and the
    per-tenant sums equal to the global ledgers."""
    got, want = op.run(leg, True), op.run(leg, False)
    assert got["tokens"] == want["tokens"]
    gt, wt = got["tenants"]["tenants"], want["tenants"]["tenants"]
    assert sorted(gt) == sorted(wt) and len(gt) >= 2
    for t in gt:
        for key in ("requests", "tokens", "finish_reasons", "throttled"):
            assert gt[t][key] == wt[t][key], (t, key)
        for key in ("kv_bytes_read", "kv_bytes_written", "weight_bytes_amortized"):
            assert gt[t][key] == pytest.approx(wt[t][key], rel=1e-9), (t, key)
    snap = got["snapshot"]
    assert sum(e["requests"] for e in gt.values()) == snap["finished"] + snap["aborted"]
    assert sum(e["tokens"] for e in gt.values()) == snap["total_generated_tokens"]
    for key, total in (("kv_bytes_read", "kv_read_bytes_total"),
                       ("kv_bytes_written", "kv_write_bytes_total"),
                       ("weight_bytes_amortized", "weight_bytes_total"),
                       ("device_time_s", "device_time_s_total")):
        assert sum(e[key] for e in gt.values()) == pytest.approx(snap[total], rel=1e-9)


def test_fair_order_equals_jax():
    """The fairness sort over the same running list and ledger state."""
    eng, jeng = op.run("mixed", True)["engine"], op.run("mixed", False)["engine"]
    live = terminals(5, 12, n_tenants=3)
    got = [r.tenant for r in eng._fair_prefill_order(live)]
    assert got == [r.tenant for r in jeng._fair_prefill_order(live)]
    # smallest accumulated cost share first, ties in admission order
    shares = eng.tenants.cost_shares(live, use_bytes=True)
    assert [shares[t] for t in got] == sorted(shares[t] for t in got)
    assert len(set(got)) >= 3


def test_inflight_cap_throttles_as_jax():
    """``max_inflight=2``: the third live request of a tenant raises
    ``TenantThrottled`` (a ``QueueFull``), counted as a throttle and a
    reject; another tenant and a recovered resubmit are not capped."""
    engines = []
    for port, mod, exc in ((True, tenants, TenantThrottled),
                           (False, jtenants, jscheduler.TenantThrottled)):
        eng = op.build(port, "mixed", observed=False)
        eng.tenants = mod.TenantLedger(max_inflight=2)
        p = op.prompts("mixed")[0]
        eng.submit(p, 3, tenant="a")
        eng.submit(p, 3, tenant="a")
        with pytest.raises(exc, match="in-flight cap"):
            eng.submit(p, 3, tenant="a")
        eng.submit(p, 3, tenant="b")
        eng.recover(p, 3, request_id=50, generated=[1], tenant="a")
        eng.run_until_complete()
        engines.append(eng)
    got, want = (e.tenants.snapshot() for e in engines)
    assert got == want
    assert got["tenants"]["a"]["throttled"] == 1 and got["tenants"]["a"]["requests"] == 3
    assert engines[0].metrics.snapshot()["rejected"] == 1


def test_debug_tenants_and_429_over_http():
    """Over HTTP: a tenant past its cap gets 429 with Retry-After;
    ``/debug/tenants`` answers ``aggregate_tenants`` of the ledger, and the
    scrape carries the tenant series."""
    eng = op.build(True, "mixed", max_slots=2, num_blocks=32)
    eng.tenants = tenants.TenantLedger(max_inflight=1)
    ps = op.prompts("mixed")

    async def main():
        async with serving(eng) as srv:
            outs = await asyncio.gather(*(astream_completion(
                srv.host, srv.port, {"prompt": [int(t) for t in p], "max_tokens": 6,
                                     "stream": True, "tenant": "burst"}, timeout=60)
                for p in ps[:4]))
            loop = asyncio.get_running_loop()
            dbg = await loop.run_in_executor(None, http_get, srv.host, srv.port,
                                             "/debug/tenants")
            _, prom = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
            return outs, dbg, prom.decode()

    outs, (st, raw), prom = asyncio.run(asyncio.wait_for(main(), 60))
    statuses = [o["status"] for o in outs]
    assert 200 in statuses and 429 in statuses
    body = json.loads(raw)
    assert st == 200 and body == tenants.aggregate_tenants([eng.tenants])
    assert body["tenants"]["burst"]["throttled"] == statuses.count(429)
    assert 'llm_serve_tenant_throttled_total{tenant="burst"}' in prom

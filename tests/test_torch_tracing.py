"""Tracing in the port (``serve/tracing.TraceRecorder``, the engine's
tracer hooks, the HTTP server's ``http`` bracket and ``/debug/trace``,
and ``serve/otel.OtlpExporter``) against the JAX package's, on the CPU.

The same seeded weights and trace go through both ``ServeEngine``s
(``observe_parity``): every request's track — its ``queued`` / ``prefill``
/ ``decode`` spans, the reason-tagged ``finish`` and the
``kv-restore`` / ``spec-fallback`` instants, args other than times — is
the JAX engine's, and so are the ticks: one ``tick`` span a tick, its
phases named in order, contiguous and summing to it, its args (token
split, fetches, roofline bytes, the tier and spec counts) equal.  Also:
the recorder against the JAX recorder on one scripted sequence, the
zero-overhead discipline (the guarded-hook lint over the engine and the
server, equal captures and tokens traced or not, warm-up never traced),
``tools/summarize_trace.py`` on a port dump, OTLP conversion and export,
and a supervised restart's marks on the trace.
"""

import asyncio
import json
import pathlib
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

import observe_parity as op
from llm_np_cp_tpu.serve import otel as jotel
from llm_np_cp_tpu.serve import tracing as jtracing
from llm_np_cp_tpu_torch.serve import faults, otel, tracing
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
from test_torch_http import serving
from tools.lint.rules.guarded_hook import scan_hook_guard_files
from tools.summarize_trace import LIFECYCLE_COLUMNS

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tick args and request-track args that are measured times
TIMED = {"host_sync_us", "roofline_gbps", "roofline_util", "mfu", "device_time_s",
         "tier_restore_us", "restore_us"}


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


def untimed(args: dict) -> dict:
    return {k: v for k, v in args.items() if k not in TIMED}


def test_phase_tuples_equal_jax_and_the_tool():
    assert tracing.REQUEST_PHASES == jtracing.REQUEST_PHASES
    assert tracing.TICK_PHASES == jtracing.TICK_PHASES
    assert tracing.MIXED_TICK_PHASES == jtracing.MIXED_TICK_PHASES
    assert LIFECYCLE_COLUMNS == tracing.REQUEST_PHASES + ("http",)


def test_recorder_events_equal_jax_on_one_script():
    """Both recorders on one clock and one scripted sequence (phases,
    instants, a tick, ends, a finish): the same events, in order."""
    def script(mod):
        t = [0.0]

        def clock():
            t[0] += 0.001
            return t[0]

        rec = mod.TraceRecorder(clock=clock, ring=40)
        rec.request_phase(1, "queued", args={"trace": "ab" * 16})
        rec.request_phase(1, "prefill")
        rec.request_instant(1, "evicted-requeued")
        rec.async_begin(1, "http", ts_us=0.5, args={"stream": True})
        rec.complete("prefill_chunk", rec.now_us(), cat="prefill", args={"rid": 1})
        rec.tick(rec.now_us(), (("admission", 1.0, 2.0), ("grow", 2.0, 3.0)),
                 args={"active_slots": 1})
        rec.instant("anomaly", cat="sentinel", args={"phase": "host_sync"})
        rec.request_end(1, "stop", args={"tenant": "team-a"})
        rec.async_end(1, "http")
        rec.request_end(2, "aborted")
        return rec

    got, want = script(tracing), script(jtracing)
    assert got.events() == want.events()
    assert got.to_dict()["traceEvents"] == want.to_dict()["traceEvents"]
    assert got.dropped == want.dropped == 0 and len(got) == len(want)


def test_ring_bounds_the_recorder_and_counts_drops(tmp_path):
    rec = tracing.TraceRecorder(ring=5)
    for i in range(9):
        rec.instant(f"e{i}")
    evs = rec.events()
    assert len(evs) == 5 and evs[-1]["name"] == "e8"
    # 9 instants + the thread's name event, 5 kept
    assert rec.dropped == 5
    assert rec.dump(str(tmp_path / "t.json")) == 5
    dumped = json.loads((tmp_path / "t.json").read_text())
    assert dumped["otherData"]["dropped_events"] == 5 and len(dumped["traceEvents"]) == 5
    with pytest.raises(ValueError, match="ring"):
        tracing.TraceRecorder(ring=0)


def test_appends_from_many_threads_keep_every_tick_whole():
    """Appends from more threads than cores, switching often, under the one
    lock: no event lost, every tick's phases follow it, none torn apart
    by another thread's events, and each request's phase spans pair."""
    rec = tracing.TraceRecorder()
    n_threads, n_ticks = 16, 150
    interval = sys.getswitchinterval()

    def work(k):
        for _ in range(n_ticks):
            t0 = rec.now_us()
            rec.tick(t0, (("a", t0, t0 + 1), ("b", t0 + 1, t0 + 2)), args={"k": k})
            rec.request_phase(k, "decode")

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    evs = rec.events()
    ticks = op.ticks(evs, ("a", "b"))
    assert len(ticks) == n_threads * n_ticks
    assert all([p["name"] for p in ph] == ["a", "b"] and p["tid"] == t["tid"]
               for t, ph in ticks for p in ph)
    for k in range(n_threads):
        track = [e["ph"] for e in evs if e.get("id") == k]
        assert track == ["b"] + ["e", "b"] * (n_ticks - 1)


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_request_tracks_equal_jax(leg):
    """Every request's track: span and instant names, phases, finish
    reasons and args (times aside), the JAX engine's."""
    got, want = op.run(leg, True), op.run(leg, False)
    rids = sorted(got["tokens"])
    assert rids == sorted(want["tokens"])
    for rid in rids:
        a = [(n, ph, untimed(args)) for n, ph, args in op.request_track(got["events"], rid)]
        b = [(n, ph, untimed(args)) for n, ph, args in op.request_track(want["events"], rid)]
        assert a == b, rid
        assert a[-1][0] == "finish" and a[0][:2] == ("queued", "b")
        assert a[0][2]["trace"] == op.trace_id(rid)
    names = {n for rid in rids for n, _, _ in op.request_track(got["events"], rid)}
    finishes = [args["reason"] for rid in rids
                for n, _, args in op.request_track(got["events"], rid) if n == "finish"]
    if leg in ("mixed", "split", "spec"):
        assert finishes.count("aborted") == 1
    if leg == "tier":
        assert "kv-restore" in names
        evict = [untimed(e["args"]) for e in got["events"] if e["name"] == "prefix-evict"]
        assert evict and evict == [untimed(e["args"]) for e in want["events"]
                                   if e["name"] == "prefix-evict"]
        assert all(e["spilled"] for e in evict)
    if leg == "spec":
        assert "spec-fallback" in names


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_ticks_equal_jax_and_phases_sum_to_them(leg):
    """One ``tick`` span a tick with its phases named in order,
    contiguous inside it and summing to it (up to the args' emission);
    the ticks' untimed args equal the JAX engine's."""
    names = tracing.TICK_PHASES if leg == "split" else tracing.MIXED_TICK_PHASES
    got, want = op.run(leg, True), op.run(leg, False)
    gt, wt = op.ticks(got["events"], names), op.ticks(want["events"], names)
    assert len(gt) == len(wt) == got["snapshot"]["ticks"]
    for (t, ph), (jt, _) in zip(gt, wt):
        assert [p["name"] for p in ph] == list(names)
        assert all(p["tid"] == t["tid"] and p["cat"] == "phase" for p in ph)
        assert ph[0]["ts"] == t["ts"]
        for a, b in zip(ph, ph[1:]):
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"], abs=1e-6)
        covered = sum(p["dur"] for p in ph)
        assert covered <= t["dur"] + 1e-6
        assert t["dur"] - covered < max(0.1 * t["dur"], 200.0)
        assert untimed(t["args"]) == untimed(jt["args"])
        # the one-fetch contract: one fetch a dispatching tick (the split
        # prefill's first-token sync counts in its prefill phase)
        assert t["args"]["host_fetches"] == (1 if "kv_read_bytes" in t["args"] else 0)
    if leg == "split":
        chunks = [e["args"] for e in got["events"] if e["name"] == "prefill_chunk"]
        assert chunks and chunks == [e["args"] for e in want["events"]
                                     if e["name"] == "prefill_chunk"]


def test_tick_slice_ends_at_the_given_end():
    """``end_us`` ends the tick slice there; without it the slice ends
    at the call, as the JAX recorder's does."""
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    rec = tracing.TraceRecorder(clock=clock)
    t0 = rec.now_us()
    rec.tick(t0, (("a", t0, t0 + 10.0), ("b", t0 + 10.0, t0 + 25.0)), end_us=t0 + 25.0)
    rec.tick(t0, (("a", t0, t0 + 10.0),))
    ticks = [e for e in rec.events() if e["name"] == "tick"]
    assert ticks[0]["dur"] == pytest.approx(25.0)
    assert ticks[1]["dur"] == pytest.approx(1000.0)


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_port_ticks_end_with_their_last_phase(leg):
    """The port's engine ends each tick where its last phase ends: the
    phases cover the tick whole, and the args' build after it is outside."""
    names = tracing.TICK_PHASES if leg == "split" else tracing.MIXED_TICK_PHASES
    got = op.run(leg, True)
    ticks = op.ticks(got["events"], names)
    assert ticks and len(ticks) == got["snapshot"]["ticks"]
    for t, ph in ticks:
        assert t["ts"] + t["dur"] == pytest.approx(ph[-1]["ts"] + ph[-1]["dur"], abs=1e-6)
        assert sum(p["dur"] for p in ph) == pytest.approx(t["dur"], abs=1e-6)

def test_guarded_hooks_lint_is_clean(tmp_path):
    """Every tracer / sentinel / telemetry / tenants call in the port's
    engine and server sits behind an ``is None`` check (the JAX package's
    own lint rule, pointed at the port)."""
    files = ("llm_np_cp_tpu_torch/serve/engine.py", "llm_np_cp_tpu_torch/serve/http/server.py")
    hooks = ("tracer", "sentinel", "telemetry", "tenants")
    assert scan_hook_guard_files(files, hooks=hooks) == []
    # the rule does see a bare call
    bad = tmp_path / "unguarded_probe.py"
    bad.write_text("def f(self):\n    self.tracer.instant('x')\n")
    assert scan_hook_guard_files((str(bad),), hooks=hooks)


@pytest.mark.parametrize("leg", ["mixed", "split", "spec"])
def test_traced_engine_captures_and_tokens_as_untraced(leg):
    """The plane adds no step: equal ``compile_counts()`` and equal tokens,
    traced (every layer) or not; warm-up leaves no trace, bill or verdict,
    and every later tick is one tick span."""
    plain = op.build(True, leg, observed=False)
    plain.warmup([5, 20], 4)
    op.drive(plain, leg)
    traced = op.build(True, leg)
    traced.warmup([5, 20], 4)
    assert traced.tracer.events() == [] and traced.sentinel.ticks == 0
    assert traced.telemetry.costs == [] and traced.tenants.snapshot()["n_tenants"] == 0
    assert traced.metrics.slo is not None and traced.metrics.slo.n_ok == 0
    before = traced.compile_counts()
    steps = [0]
    real = traced.step

    def step():
        steps[0] += 1
        return real()

    traced.step = step
    op.drive(traced, leg)
    assert traced.compile_counts() == before == plain.compile_counts()
    toks = {r.req_id: r.generated for r in traced.scheduler.finished}
    assert toks == {r.req_id: r.generated for r in plain.scheduler.finished}
    names = tracing.TICK_PHASES if leg == "split" else tracing.MIXED_TICK_PHASES
    assert len(op.ticks(traced.tracer.events(), names)) == steps[0] == traced.sentinel.ticks


def test_summarize_trace_reads_a_port_dump(tmp_path):
    path = tmp_path / "port_trace.json"
    op.run("mixed", True)["engine"].tracer.dump(str(path))
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "summarize_trace.py"), str(path)],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for word in ("mixed_dispatch", "host_sync", "roofline", "queued"):
        assert word in out.stdout


# ----------------------------------------------------------------------
# OTLP export
# ----------------------------------------------------------------------

def _strip(span: dict) -> dict:
    return {k: v for k, v in span.items() if k != "spanId"}


def test_otlp_convert_equals_jax():
    """``_convert`` of one event list (a leg's whole trace): the same spans
    as the JAX exporter, span ids aside, on one wall anchor and one
    process trace id."""
    events = op.run("split", True)["events"]
    got = otel.OtlpExporter("http://127.0.0.1:9/v1/traces", wall_epoch=1.0e9)
    want = jotel.OtlpExporter("http://127.0.0.1:9/v1/traces", wall_epoch=1.0e9)
    got._proc_trace_id = want._proc_trace_id
    try:
        a = [_strip(s) for s in map(got._convert, events) if s is not None]
        b = [_strip(s) for s in map(want._convert, events) if s is not None]
        assert a == b and len(a) > 20
        assert {s["traceId"] for s in a} >= {op.trace_id(0), got._proc_trace_id}
    finally:
        got.close()
        want.close()


class _Collector:
    """A loopback OTLP/HTTP JSON collector."""

    def __init__(self):
        self.spans, self.scopes = 0, set()
        lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with lock:
                    for rs in body["resourceSpans"]:
                        for ss in rs["scopeSpans"]:
                            outer.scopes.add(ss["scope"]["name"])
                            outer.spans += len(ss["spans"])
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/v1/traces"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_otlp_export_to_a_loopback_collector_and_to_a_closed_port():
    """Every span the exporter counts reaches the collector, under the
    port's scope; against a closed port every batch is an error and its
    spans are dropped, and ``offer`` never blocks."""
    col = _Collector()
    try:
        rec = tracing.TraceRecorder()
        exp = otel.OtlpExporter(col.url, batch_max=16, flush_interval_s=0.05).attach(rec)
        assert exp.wall_epoch == rec.wall_epoch
        for i in range(50):
            rec.request_phase(i, "queued", args={"trace": op.trace_id(i)})
            rec.tick(rec.now_us(), (("admission", 0.0, 1.0),))
            rec.request_end(i, "stop")
        assert exp.flush(timeout=30.0)
        exp.close()
        st = exp.stats()
        assert st["spans"] == col.spans > 0 and st["dropped"] == st["export_errors"] == 0
        assert col.scopes == {"llm_np_cp_tpu_torch.serve"}
    finally:
        col.close()
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    down = otel.OtlpExporter(f"http://127.0.0.1:{port}/v1/traces", batch_max=8, timeout_s=1.0)
    rec = tracing.TraceRecorder()
    down.attach(rec)
    for i in range(20):
        rec.instant(f"e{i}")
    assert down.flush(timeout=30.0)
    down.close()
    st = down.stats()
    assert st["spans"] == 0 and st["dropped"] == 20 and st["export_errors"] >= 1


# ----------------------------------------------------------------------
# the server and the supervisor
# ----------------------------------------------------------------------

def test_http_bracket_debug_trace_and_otlp_counters():
    """Over HTTP: each completion's track is enclosed in an ``http`` span
    from accept; ``/debug/trace`` serves the recorder's dump; the scrape
    carries the exporter's counters."""
    eng = op.build(True, "mixed", max_slots=2, num_blocks=32)
    col = _Collector()
    exp = otel.OtlpExporter(col.url, flush_interval_s=0.05).attach(eng.tracer)
    ps = op.prompts("mixed")[:3]

    async def main():
        async with serving(eng) as srv:
            outs = await asyncio.gather(*(astream_completion(
                srv.host, srv.port, {"prompt": [int(t) for t in p], "max_tokens": 4,
                                     "stream": True}, timeout=60) for p in ps))
            assert [o["status"] for o in outs] == [200] * 3
            loop = asyncio.get_running_loop()
            st, raw = await loop.run_in_executor(None, http_get, srv.host, srv.port,
                                                 "/debug/trace")
            _, prom = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
            return st, json.loads(raw), prom.decode()

    try:
        st, dump, prom = asyncio.run(asyncio.wait_for(main(), 60))
    finally:
        exp.close()
        col.close()
    assert st == 200 and "traceEvents" in dump
    evs = dump["traceEvents"]
    for rid in {e["id"] for e in evs if e.get("name") == "finish"}:
        track = [e for e in evs if e.get("id") == rid and e.get("cat") == "request"]
        http = [e for e in track if e["name"] == "http"]
        assert [e["ph"] for e in http] == ["b", "e"]
        assert http[0]["ts"] <= track[1]["ts"] and http[1]["ts"] >= track[-2]["ts"]
    assert "llm_serve_otlp_spans_exported_total" in prom
    assert "llm_serve_otlp_export_errors_total 0" in prom


def test_restart_marks_the_trace_and_mutes_the_dead_engine():
    """A tick crash under supervision: ``engine-death`` and a ``restart``
    span on the trace, the rebuilt engine carrying the same tracer,
    sentinel, telemetry and ledger, the dead one muted, and no tick span
    between the death and the rebuild's end (its captures are not
    ticks)."""
    eng = op.build(True, "mixed", max_slots=2, num_blocks=32,
                   fault_injector=faults.FaultInjector("tick_crash@4"))
    layers = (eng.tracer, eng.sentinel, eng.telemetry, eng.tenants)
    ps = op.prompts("mixed")[:3]

    async def main():
        async with serving(eng, max_restarts=2, restart_backoff_s=0.05) as srv:
            outs = await asyncio.gather(*(astream_completion(
                srv.host, srv.port, {"prompt": [int(t) for t in p], "max_tokens": 5,
                                     "stream": True}, timeout=60) for p in ps))
            return srv.runner, outs

    runner, outs = asyncio.run(asyncio.wait_for(main(), 60))
    assert [o["status"] for o in outs] == [200] * 3 and runner.restarts == 1
    new = runner.engine
    assert new is not eng and (new.tracer, new.sentinel, new.telemetry, new.tenants) == layers
    assert (eng.tracer, eng.sentinel, eng.tenants) == (None, None, None)
    evs = layers[0].events()
    (death,) = [e for e in evs if e["name"] == "engine-death"]
    (restart,) = [e for e in evs if e["name"] == "restart"]
    assert restart["args"]["replayed"] == 3 and death["args"]["restart"] == 1
    ticks = op.ticks(evs, tracing.MIXED_TICK_PHASES)
    assert not [t for t, _ in ticks if death["ts"] <= t["ts"] <= restart["ts"] + restart["dur"]]
    assert layers[1].ticks == len(ticks)
    assert sum(1 for e in evs if e["name"] == "recovery-replay") == 3

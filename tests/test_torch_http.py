"""The port's HTTP front end (``llm_np_cp_tpu_torch/serve/http/``) against
the JAX package's, on the CPU.

Pure pieces are held to the JAX package's on the same inputs: SSE bytes,
every protocol status / type / message, the trace-context helpers, and
the Prometheus and operator text of ``ServeMetrics`` for one event
sequence (bounded windows included).  Live servers bind ``127.0.0.1:0``
only (the ``http`` marker's contract) and serve the port's engine — a
tiny Llama in float32 on numpy-made weights, through the unified tick —
whose greedy tokens must equal the JAX package's
``Generator.generate_ragged`` on the same weights, exactly: unary, one
stream, and 8 concurrent streams on a 2-slot engine.  Then the server's
behaviours: 429 with Retry-After on a full queue, a mid-stream
disconnect returning every block, a deadline expiry, the crash
backstop, drain, Last-Event-ID resume, the scrape, the 404 hints and
the idle scrape held to a JAX server's bytes, and the option of a later
slice (the mesh) raising ``NotImplementedError``.
"""

import asyncio
import contextlib
import dataclasses
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.generate import Generator as JGenerator
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import tracing as jtracing
from llm_np_cp_tpu.serve.http import protocol as jprotocol
from llm_np_cp_tpu.serve.http import sse as jsse
from llm_np_cp_tpu.serve.http.server import HttpServer as JHttpServer
from llm_np_cp_tpu.serve.metrics import ServeMetrics as JServeMetrics
from llm_np_cp_tpu.serve.scheduler import Request as JRequest
from llm_np_cp_tpu.serve.tenants import normalize_tenant as jnormalize_tenant
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import tracing
from llm_np_cp_tpu_torch.serve.http import protocol, sse
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get, post_completion
from llm_np_cp_tpu_torch.serve.http.server import EngineRunner, HttpServer, serve_forever
from llm_np_cp_tpu_torch.serve.metrics import ServeMetrics
from llm_np_cp_tpu_torch.serve.tenants import normalize_tenant

pytestmark = pytest.mark.http

# the JAX package's own pattern for a scrape sample line
PROM_LINE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.]+(e[+-]?[0-9]+)?")
PROMPT_LEN, REF_TOKENS = 12, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(cfg, seed, scale=0.15):
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


@pytest.fixture(scope="module")
def llama():
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config("llama")
    npp = np_params(cfg, 0)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


@pytest.fixture(scope="module")
def reference(llama):
    """prompt → the JAX package's greedy ``generate_ragged`` tokens
    (REF_TOKENS of them; every prompt is PROMPT_LEN long, so one compile
    serves them all and a shorter request compares with a prefix)."""
    jcfg, jp = llama[2], llama[3]
    gen = JGenerator(jp, jcfg, sampler=JSampler(kind="greedy"), cache_dtype=jnp.float32)
    cache: dict[tuple, list[int]] = {}

    def tokens(prompt, n):
        key = tuple(int(t) for t in prompt)
        assert len(key) == PROMPT_LEN and n <= REF_TOKENS
        if key not in cache:
            res = gen.generate_ragged([np.asarray(key, np.int32)], REF_TOKENS)
            cache[key] = [int(t) for t in np.asarray(res.tokens)[0][:REF_TOKENS]]
        return cache[key][:n]

    return tokens


def prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=PROMPT_LEN).tolist() for _ in range(n)]


def engine(llama, **kw):
    cfg, tp = llama[:2]
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    return serve.ServeEngine(tp, cfg, sampler=Sampler("greedy"), mixed_step="on",
                             cache_dtype=torch.float32, device="cpu", **kw)


def slow_ticks(eng, seconds=0.02, explode_after=None):
    """Slow each tick down (so a test can act while streams are live), and
    optionally make the tick raise after ``explode_after`` ticks."""
    real_step, calls = eng.step, [0]

    def step():
        calls[0] += 1
        if explode_after is not None and calls[0] > explode_after:
            raise RuntimeError("synthetic tick explosion")
        time.sleep(seconds)
        return real_step()

    eng.step = step
    return eng


@contextlib.asynccontextmanager
async def serving(eng, **kw):
    kw.setdefault("drain_timeout", 10.0)
    srv = HttpServer(eng, model_id="tiny", **kw)
    await srv.start("127.0.0.1", 0)
    try:
        yield srv
    finally:
        srv.begin_drain()
        await asyncio.wait_for(srv.serve_until_shutdown(), timeout=30)


def run(coro, timeout=60):
    asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def raw_request(host, port, method, path, payload=None, headers=()):
    """One HTTP/1.1 request over raw asyncio streams; returns ``(status,
    headers, reader, writer)`` with the body unread."""
    body = json.dumps(payload).encode() if payload is not None else b""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: {host}\r\nContent-Length: {len(body)}\r\n".encode()
        + b"".join(f"{k}: {v}\r\n".encode() for k, v in headers)
        + b"Content-Type: application/json\r\nConnection: close\r\n\r\n" + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdr = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        hdr[k.strip().lower()] = v.strip()
    return status, hdr, reader, writer


async def read_sse(reader, writer):
    """(token ids, event ids, finish reason, [DONE] seen) of a raw SSE body."""
    toks, ids, reason, done = [], [], None, False
    while True:
        line = await reader.readline()
        if not line:
            break
        if line.strip() == b"data: [DONE]":
            done = True
        elif line.startswith(b"id: "):
            ids.append(int(line.split()[1]))
        elif line.strip():
            choice = sse.parse_sse_line(line)["choices"][0]
            if choice.get("token_id") is not None:
                toks.append(choice["token_id"])
            reason = choice["finish_reason"] or reason
    writer.close()
    return toks, ids, reason, done


def stream(srv, prompt, n, **extra):
    return astream_completion(srv.host, srv.port,
                              {"prompt": prompt, "max_tokens": n, "stream": True, **extra})


async def until(pred, seconds=20.0):
    t_end = time.time() + seconds
    while not pred() and time.time() < t_end:
        await asyncio.sleep(0.01)
    assert pred()


# ---------------------------------------------------------------------------
# Pure pieces against the JAX package's
# ---------------------------------------------------------------------------

SSE_PAYLOADS = [
    {"choices": [{"text": "ab", "token_id": 7}]},
    {"id": "cmpl-3", "choices": [{"index": 0, "text": "é\n\"x\"", "finish_reason": None}]},
    {},
]


def test_sse_bytes_equal_jax():
    assert sse.DONE_SENTINEL == jsse.DONE_SENTINEL
    frames = b""
    for i, p in enumerate(SSE_PAYLOADS):
        for event_id in (None, i + 1):
            frame = sse.sse_event(p, event_id=event_id)
            assert frame == jsse.sse_event(p, event_id=event_id)
            frames += frame
    for line in frames.splitlines() + [b"data: [DONE]", b": comment", b"event: x", b"retry: 9"]:
        assert sse.parse_sse_line(line) == jsse.parse_sse_line(line)
    for mod in (sse, jsse):
        with pytest.raises(ValueError):
            mod.parse_sse_line(b"garbage line")

    async def payloads(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(frames + sse.DONE_SENTINEL + sse.sse_event({"after": 1}))
        reader.feed_eof()
        return [p async for p in mod.iter_sse_payloads(reader)]

    got = asyncio.run(payloads(sse))
    assert got == asyncio.run(payloads(jsse)) == [p for p in SSE_PAYLOADS for _ in range(2)]


def _outcome(fn, *args, **kw):
    """A parse's result, or its error as (status, type, message, code)."""
    try:
        out = fn(*args, **kw)
    except jprotocol.HTTPError as e:
        return ("error", e.status, e.etype, e.message, e.code, e.headers)
    except protocol.HTTPError as e:
        return ("error", e.status, e.etype, e.message, e.code, e.headers)
    except ValueError as e:
        return ("ValueError", str(e))
    if dataclasses.is_dataclass(out):
        out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in dataclasses.asdict(out).items() if k != "route_spilled"}
    return ("ok", out)


def _body(obj):
    return obj if isinstance(obj, bytes) else json.dumps(obj).encode()


# (name, function name, arguments, keywords): JAX's
# test_parse_completion_request_validation cases first, then the
# tenant, resume and id parsers
PROTOCOL_CASES = [
    ("ok", "parse_completion_request",
     ({"prompt": [1, 2, 3], "max_tokens": 4, "stream": True, "seed": 9},), {}),
    ("bad_json", "parse_completion_request", (b"{nope",), {}),
    ("not_object", "parse_completion_request", ([1, 2],), {}),
    ("other_model", "parse_completion_request", ({"prompt": [1], "model": "other"},), {}),
    ("empty_prompt", "parse_completion_request", ({"prompt": []},), {}),
    ("text_no_tokenizer", "parse_completion_request", ({"prompt": "text needs tokenizer"},), {}),
    ("max_tokens_0", "parse_completion_request", ({"prompt": [1], "max_tokens": 0},), {}),
    ("stream_str", "parse_completion_request", ({"prompt": [1], "stream": "yes"},), {}),
    ("timeout_neg", "parse_completion_request", ({"prompt": [1], "timeout_s": -1},), {}),
    ("n_2", "parse_completion_request", ({"prompt": [1], "n": 2},), {}),
    ("over_cap", "parse_completion_request", ({"prompt": [1], "max_tokens": 33},),
     {"max_tokens_cap": 32}),
    ("at_cap", "parse_completion_request", ({"prompt": [1], "max_tokens": 32},),
     {"max_tokens_cap": 32}),
    ("speculative", "parse_completion_request", ({"prompt": [1], "speculative": True},), {}),
    ("speculative_str", "parse_completion_request", ({"prompt": [1], "speculative": "yes"},), {}),
    ("seed_bool", "parse_completion_request", ({"prompt": [1], "seed": True},), {}),
    ("prompt_bools", "parse_completion_request", ({"prompt": [True, 2]},), {}),
    ("timeout_ok", "parse_completion_request", ({"prompt": [1], "timeout_s": 2},), {}),
    ("header_tenant", "parse_completion_request", ({"prompt": [1]},),
     {"header_tenant": "team-a"}),
    ("body_tenant_wins", "parse_completion_request", ({"prompt": [1], "tenant": "b.2"},),
     {"header_tenant": "team-a"}),
    ("tenant_chars", "parse_completion_request", ({"prompt": [1], "tenant": "a b"},), {}),
    ("tenant_long", "parse_completion_request", ({"prompt": [1], "tenant": "x" * 65},), {}),
    ("tenant_type", "parse_completion_request", ({"prompt": [1], "tenant": 5},), {}),
    ("rid_str", "parse_completion_rid", ("cmpl-7",), {}),
    ("rid_int", "parse_completion_rid", (7,), {}),
    ("rid_bad", "parse_completion_rid", ("x-7",), {}),
    ("rid_bool", "parse_completion_rid", (True,), {}),
    ("last_none", "parse_last_event_id", (None,), {}),
    ("last_str", "parse_last_event_id", ("3",), {}),
    ("last_neg", "parse_last_event_id", ("-1",), {}),
    ("last_word", "parse_last_event_id", ("abc",), {}),
    ("resume_header", "parse_resume_request", ({"request_id": "cmpl-4"}, {"last-event-id": "2"}),
     {}),
    ("resume_field", "parse_resume_request", ({"request_id": 4, "last_event_id": 1}, {}), {}),
    ("resume_unary", "parse_resume_request", ({"request_id": 4, "stream": False}, {}), {}),
    ("resume_model", "parse_resume_request", ({"request_id": 4, "model": "x"}, {}), {}),
    ("not_resume", "parse_resume_request", ({"prompt": [1]}, {}), {}),
    ("resume_bad_json", "parse_resume_request", (b"{", {}), {}),
]


PROTOCOL_OK = {"ok", "at_cap", "speculative", "timeout_ok", "header_tenant", "body_tenant_wins",
               "rid_str", "rid_int", "last_none", "last_str", "resume_header", "resume_field",
               "not_resume", "resume_bad_json"}


@pytest.mark.parametrize("name,fn,args,kw", PROTOCOL_CASES, ids=[c[0] for c in PROTOCOL_CASES])
def test_protocol_equals_jax(name, fn, args, kw):
    """Every parse gives the JAX package's result or its exact error."""
    if fn == "parse_completion_request":
        args, kw = (_body(args[0]),), dict(kw, model_id="m", tokenizer=None)
    elif fn == "parse_resume_request":
        args, kw = (_body(args[0]), args[1]), dict(kw, model_id="m")
    got = _outcome(getattr(protocol, fn), *args, **kw)
    assert got == _outcome(getattr(jprotocol, fn), *args, **kw)
    assert got[0] == ("ok" if name in PROTOCOL_OK else "error")


def test_payloads_tenants_and_traceparent_equal_jax():
    for fn in ("chunk_payload", "completion_payload"):
        kw = (dict(text="ab", token_id=5, finish_reason=None) if fn == "chunk_payload" else
              dict(text="ab", token_ids=[5, 6], finish_reason="stop", prompt_tokens=3))
        assert getattr(protocol, fn)(3, "m", 17, **kw) == getattr(jprotocol, fn)(3, "m", 17, **kw)
    assert protocol.completion_id(9) == jprotocol.completion_id(9) == "cmpl-9"
    assert protocol.error_body("x", code="c") == jprotocol.error_body("x", code="c")
    for value in (None, "", "a.b-c_9", "x" * 64, "x" * 65, "bad id", 3):
        assert _outcome(normalize_tenant, value) == _outcome(jnormalize_tenant, value)
    good = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for header in (None, "", good, good.upper(), " " + good, "ff" + good[2:],
                   "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "00-xyz", good + "-x"):
        assert tracing.parse_traceparent(header) == jtracing.parse_traceparent(header)
    tp = tracing.make_traceparent("ab" * 16)
    assert jtracing.parse_traceparent(tp)[0] == "ab" * 16
    assert tracing.make_traceparent("ab" * 16, "cd" * 8) == jtracing.make_traceparent(
        "ab" * 16, "cd" * 8)
    assert len(tracing.gen_trace_id()) == 32 and len(tracing.gen_span_id()) == 16


def _drive_metrics(m, Req, now, n=12):
    """One event sequence through a ServeMetrics (port or JAX); ``now``
    is the clock's cell, set before every event."""
    for i in range(n):
        now[0] = 10.0 + i
        req = Req(req_id=i, prompt=np.ones(4, np.int32), max_new_tokens=8)
        req.submit_time = now[0]
        m.on_submit(req)
        if i % 5 == 4:
            m.on_reject()
        m.on_tick(queue_depth=i % 3, occupancy=0.1 * (i % 7), active_slots=i % 4,
                  preemptions_total=i // 6, kv_bytes=1000 * i,
                  prefill_tokens=3 * i, decode_tokens=i % 4)
        m.on_prefix(requested=2, hits=i % 2)
        if i % 4 == 1:
            m.on_spec(drafted=4, accepted=i % 5)
        if i % 6 == 5:
            m.on_prefix_evicted(blocks=1, nbytes=4096)
            m.on_tier_spill(blocks=1, nbytes=4096)
            m.on_tier_restore(blocks=1, nbytes=4096, latency_s=0.001 * i)
            m.on_tier_gauge(resident_bytes=4096 * i, breakeven=1.5)
        req.admit_time = now[0] + 0.01 * i
        req.prefill_s = 0.002 * (i + 1)
        req.generated = list(range(1 + i % 5))
        req.first_token_time = now[0] + 0.003 * (i + 1)
        if i % 2:
            req.extra["arrival_wall"] = now[0] - 0.5
        for _ in req.generated:
            m.on_token(req)
        now[0] += 0.25
        req.finish_time = now[0]
        if i % 3 == 2:
            req.finish_reason = "aborted"
            m.on_abort(req)
        else:
            req.finish_reason = "stop" if i % 2 else "length"
            m.on_finish(req)


@pytest.mark.parametrize("max_samples", [None, 4])
def test_metrics_text_equals_jax(max_samples):
    """For one event sequence: the snapshot (every key the JAX package
    reports), ``prometheus()`` with and without live gauges and constant
    labels, and ``format()`` equal the JAX ServeMetrics' — with
    ``max_samples`` trimming the windows as JAX trims them."""
    now = [0.0]
    port = ServeMetrics(clock=lambda: now[0], max_samples=max_samples)
    ref = JServeMetrics(clock=lambda: now[0], max_samples=max_samples)
    _drive_metrics(port, serve.Request, now)
    _drive_metrics(ref, JRequest, now)
    snap, want = port.snapshot(), ref.snapshot()
    assert {k: snap[k] for k in want} == want
    if max_samples:
        assert len(port.ttft_s) <= max_samples and port.ttft_s == ref.ttft_s
        assert len(port.queue_depth) <= max_samples and port.queue_depth == ref.queue_depth
    gauges = {"pool_blocks_free": 7, "inflight_streams": 2, "draining": 0.0}
    for kw in ({}, dict(extra_gauges=gauges), dict(const_labels={"version": "2"}),
               dict(extra_gauges=gauges, prefix="x", const_labels={"replica": "0"})):
        text = port.prometheus(**kw)
        assert text == ref.prometheus(**kw)
        assert all(ln.startswith("# ") or PROM_LINE.fullmatch(ln) for ln in text.splitlines())
    assert port.format() == ref.format()
    empty, jempty = ServeMetrics(clock=lambda: 1.0), JServeMetrics(clock=lambda: 1.0)
    assert empty.prometheus() == jempty.prometheus() and empty.format() == jempty.format()


def test_unported_options_raise(llama):
    """Only the mesh (a later slice) raises ``NotImplementedError``; the
    supervised restart, the journal, the request log and the fault
    injector (faults and recovery), and the fleet and its lifecycle
    (``runner=``, ``upgrade_loader=``, the runner's roll methods,
    ``actions=``) are accepted."""
    eng = engine(llama)
    runner = HttpServer(eng, model_id="tiny", max_restarts=1, restart_backoff_s=0.1,
                        restart_window_s=60.0).runner
    assert (runner.max_restarts, runner.restart_backoff_s, runner.restart_window_s) == (
        1, 0.1, 60.0)
    fleet = serve.ReplicaRunner([engine(llama), engine(llama)])
    assert HttpServer(eng, model_id="tiny", runner=fleet).runner is fleet
    loader = lambda body: None  # noqa: E731
    assert HttpServer(eng, model_id="tiny", upgrade_loader=loader).upgrade_loader is loader
    # an idle runner's planned swap: nothing in flight, a clean timeout
    assert runner.detach_inflight() == [] and runner.recovering
    with pytest.raises(TimeoutError):
        runner.await_recovered(0.05)
    assert callable(runner.rolling_upgrade) and callable(runner.rebuild_upgraded)
    assert runner.serving_engines() == [eng]
    # a traced engine is served
    eng.tracer = tracing.TraceRecorder()
    assert EngineRunner(eng).engine.tracer is eng.tracer
    eng.tracer = None
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        engine(llama, mesh_devices=[0])
    assert engine(llama, actions=serve.ActionPolicy()).actions is not None
    accepted = engine(llama, fault_injector=serve.FaultInjector("decode@99"))
    assert accepted.faults is not None and accepted.journal is None
    # the engine attributes the server reads, at the JAX engine's "off"
    assert (eng.weights_version, eng.decode_degraded, eng.tracer, eng.actions, eng.faults,
            eng.journal, eng.tenants) == (0, None, None, None, None, None, None)
    req = eng.submit([1, 2, 3], 2, trace_id="ab" * 16, tenant="team-a")
    assert req.tenant == "team-a" and req.extra["trace"] == "ab" * 16


# ---------------------------------------------------------------------------
# Live servers over the port's engine
# ---------------------------------------------------------------------------

HINT_ROUTES = [("GET", "/debug/slo"), ("GET", "/debug/tenants"), ("GET", "/debug/trace"),
               ("POST", "/admin/upgrade"), ("GET", "/admin/upgrade"), ("POST", "/admin/scale"),
               ("GET", "/admin/scale"), ("GET", "/nope"), ("GET", "/v1/completions"),
               ("PUT", "/v1/completions/cmpl-1"), ("GET", "/v1/completions/cmpl-x"),
               ("GET", "/healthz"), ("GET", "/metrics")]


def test_idle_server_answers_as_jax(llama):
    """Idle servers over engines of one geometry: every route of
    HINT_ROUTES (the 404 hints of absent layers among them) and the idle
    scrape answer with the JAX server's status and bytes."""
    jcfg, jp = llama[2], llama[3]
    ref_engine = jserve.ServeEngine(
        jp, jcfg, sampler=JSampler(kind="greedy"), mixed_step="off", decode_attn_impl="xla",
        max_slots=2, num_blocks=32, block_size=8, max_seq_len=64, cache_dtype=jnp.float32)

    async def answers(srv):
        out = []
        for method, path in HINT_ROUTES:
            st, _, reader, writer = await raw_request(srv.host, srv.port, method, path)
            out.append((method, path, st, await reader.read()))
            writer.close()
        return out

    async def main():
        async with serving(engine(llama)) as srv:
            got = await answers(srv)
        ref = JHttpServer(ref_engine, model_id="tiny", drain_timeout=10.0)
        await ref.start("127.0.0.1", 0)
        try:
            want = await answers(ref)
        finally:
            ref.begin_drain()
            await ref.serve_until_shutdown()
        assert got == want
        assert [st for *_, st, _ in got] == [404, 404, 404, 404, 405, 400, 405, 404, 405, 405,
                                               400, 200, 200]

    run(main())


def test_unary_stream_and_scrape_match_jax(llama, reference):
    """A unary request and a stream: greedy tokens equal the JAX
    package's generate_ragged; SSE frames carry event ids 1..n, a final
    finish frame and [DONE]; the response continues the caller's trace;
    the scrape parses and its counters equal the snapshot."""
    eng = engine(llama)
    p_unary, p_stream = prompts(1, 2)
    trace_id = "12" * 16

    async def main():
        async with serving(eng) as srv:
            loop = asyncio.get_running_loop()
            st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
            assert st == 200 and json.loads(body)["status"] == "ok"
            st, obj = await loop.run_in_executor(
                None, post_completion, srv.host, srv.port, {"prompt": p_unary, "max_tokens": 6})
            assert st == 200 and obj["choices"][0]["finish_reason"] == "length"
            assert obj["choices"][0]["token_ids"] == reference(p_unary, 6)
            assert obj["usage"] == {"prompt_tokens": PROMPT_LEN, "completion_tokens": 6,
                                    "total_tokens": PROMPT_LEN + 6}
            st, hdr, reader, writer = await raw_request(
                srv.host, srv.port, "POST", "/v1/completions",
                {"prompt": p_stream, "max_tokens": REF_TOKENS, "stream": True},
                headers=(("traceparent", f"00-{trace_id}-{'cd' * 8}-01"),))
            assert st == 200 and hdr["content-type"].startswith("text/event-stream")
            assert tracing.parse_traceparent(hdr["traceparent"])[0] == trace_id
            toks, ids, reason, done = await read_sse(reader, writer)
            assert toks == reference(p_stream, REF_TOKENS)
            assert ids == list(range(1, REF_TOKENS + 1)) and reason == "length" and done
            st, raw = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
            prom = raw.decode()
            assert st == 200
            assert all(ln.startswith("# ") or PROM_LINE.fullmatch(ln) for ln in prom.splitlines())
            snap = eng.metrics.snapshot()
            for key, series in (("finished", "requests_finished_total"),
                                ("submitted", "requests_submitted_total"),
                                ("total_generated_tokens", "tokens_generated_total")):
                val = float(re.search(rf"^llm_serve_{series} (\S+)", prom, re.M).group(1))
                assert val == snap[key] > 0
            assert re.search(r"^llm_serve_pool_blocks_request_held 0$", prom, re.M)
            assert re.search(r"^llm_serve_kv_bytes_tick_mean [1-9]", prom, re.M)

    run(main())


def test_concurrent_streams_on_two_slots_match_jax(llama, reference):
    """8 concurrent streams on a 2-slot engine: each stream's tokens equal
    the JAX package's generate_ragged for its prompt."""
    eng = engine(llama)
    ps = prompts(2, 8)
    budgets = [REF_TOKENS - (i % 3) for i in range(8)]

    async def main():
        async with serving(eng) as srv:
            res = await asyncio.gather(*(stream(srv, p, n) for p, n in zip(ps, budgets)))
        for p, n, r in zip(ps, budgets, res):
            assert r["status"] == 200 and r["finish_reason"] == "length"
            assert r["token_ids"] == reference(p, n)
        assert eng.pool.stats()["request_held"] == 0

    run(main())


def test_serve_forever_on_a_worker_thread_answers_and_drains(llama, reference, tmp_path):
    """The blocking entry point, on a worker thread (where no signal
    handler can be installed): ``on_started`` hands over the live server,
    ``port_file`` names its address, it answers a completion with the JAX
    package's tokens, and ``exit_after_s`` drains it and returns."""
    eng = engine(llama)
    p = prompts(9, 1)[0]
    port_file = tmp_path / "port"
    started, errors = [], []

    def serve():
        try:
            serve_forever(eng, model_id="tiny", host="127.0.0.1", port=0,
                          port_file=str(port_file), exit_after_s=2.0, drain_timeout=10.0,
                          on_started=started.append)
        except BaseException as e:  # surfaced by the assertions below
            errors.append(e)

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    t_end = time.time() + 30
    while not started and worker.is_alive() and time.time() < t_end:
        time.sleep(0.01)
    assert started and not errors
    srv = started[0]
    assert isinstance(srv, HttpServer) and port_file.read_text() == f"127.0.0.1 {srv.port}\n"
    st, obj = post_completion("127.0.0.1", srv.port, {"prompt": p, "max_tokens": 6})
    assert st == 200 and obj["choices"][0]["token_ids"] == reference(p, 6)
    worker.join(timeout=30)
    assert not worker.is_alive() and not errors
    assert srv.draining and eng.metrics.snapshot()["finished"] == 1


def test_full_queue_returns_429_with_retry_after(llama):
    """One slot and one queue seat: with a request decoding and one
    queued, a third is rejected on the engine thread → 429 with
    Retry-After, counted in the metrics."""
    eng = slow_ticks(engine(llama, max_slots=1, max_queue=1))
    pa, pb, pc = prompts(3, 3)

    async def main():
        async with serving(eng) as srv:
            st, _, reader_a, writer_a = await raw_request(
                srv.host, srv.port, "POST", "/v1/completions",
                {"prompt": pa, "max_tokens": 40, "stream": True})
            assert st == 200
            await until(lambda: eng.metrics.snapshot()["total_generated_tokens"] > 0)
            task_b = asyncio.create_task(stream(srv, pb, 2))
            await until(lambda: eng.scheduler.queue_depth == 1)
            st, hdr, reader_c, writer_c = await raw_request(
                srv.host, srv.port, "POST", "/v1/completions", {"prompt": pc, "max_tokens": 2})
            body = json.loads(await reader_c.read())
            writer_c.close()
            assert st == 429 and hdr["retry-after"] == "1"
            assert body["error"]["type"] == "rate_limit_error"
            writer_a.close()  # frees the slot: B runs
            assert (await task_b)["finish_reason"] == "length"
        assert eng.metrics.snapshot()["rejected"] == 1

    run(main())


def test_disconnect_and_deadline_abort_and_free_the_pool(llama):
    """A client that hangs up mid-stream and a request past its deadline
    both abort: ``request_held`` goes back to 0."""
    eng = slow_ticks(engine(llama))
    pa, pb = prompts(4, 2)

    async def main():
        async with serving(eng) as srv:
            cut, late = await asyncio.gather(
                astream_completion(srv.host, srv.port,
                                   {"prompt": pa, "max_tokens": 40, "stream": True},
                                   disconnect_after=2),
                stream(srv, pb, 40, timeout_s=0.3))
            assert cut["finish_reason"] == "disconnected"
            assert late["finish_reason"] == "aborted" and 0 < len(late["token_ids"]) < 40
            await until(lambda: eng.metrics.snapshot()["aborted"] == 2
                        and eng.pool.stats()["request_held"] == 0)
        assert not eng.scheduler.has_work

    run(main())


def test_tick_crash_ends_streams_and_turns_health_503(llama):
    """The backstop: a tick that raises ends the in-flight stream
    (``aborted``, not a hang), /healthz reads 503 ``crashed``, and new
    work gets 503."""
    eng = slow_ticks(engine(llama), seconds=0.0, explode_after=2)

    async def main():
        async with serving(eng, drain_timeout=5.0) as srv:
            res = await stream(srv, prompts(5, 1)[0], 40)
            assert res["finish_reason"] == "aborted"
            loop = asyncio.get_running_loop()
            st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
            assert st == 503 and json.loads(body)["status"] == "crashed"
            assert "synthetic tick explosion" in json.loads(body)["error"]
            st, obj = await loop.run_in_executor(
                None, post_completion, srv.host, srv.port, {"prompt": [1], "max_tokens": 2})
            assert st == 503 and "crashed" in obj["error"]["message"]

    run(main())


def test_hung_tick_is_a_terminal_crash(llama):
    """A tick past ``tick_deadline`` is a death with supervision off: the
    stream ends ``aborted`` and /healthz reads ``crashed``."""
    eng = engine(llama)
    real_step = eng.step

    def hanging_step():
        if eng.metrics.snapshot()["total_generated_tokens"] >= 2:
            time.sleep(1.5)
        return real_step()

    eng.step = hanging_step

    async def main():
        async with serving(eng, tick_deadline=0.3, drain_timeout=5.0) as srv:
            res = await stream(srv, prompts(6, 1)[0], 40)
            assert res["finish_reason"] == "aborted"
            assert "tick hung" in srv.runner.crashed

    run(main())


def test_drain_finishes_inflight_and_refuses_new_work(llama, reference):
    """begin_drain: the in-flight stream runs to its end, new completions
    get 503 with Retry-After meanwhile, then the server shuts down."""
    eng = slow_ticks(engine(llama))
    pa, pb = prompts(7, 2)

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=20.0)
        await srv.start("127.0.0.1", 0)
        task = asyncio.create_task(stream(srv, pa, REF_TOKENS))
        await until(lambda: eng.metrics.snapshot()["total_generated_tokens"] > 0)
        srv.begin_drain()
        st, hdr, reader, writer = await raw_request(
            srv.host, srv.port, "POST", "/v1/completions", {"prompt": pb, "max_tokens": 2})
        body = json.loads(await reader.read())
        writer.close()
        assert st == 503 and hdr["retry-after"] == "1" and "draining" in body["error"]["message"]
        res = await task
        await asyncio.wait_for(srv.serve_until_shutdown(), timeout=30)
        assert res["finish_reason"] == "length" and res["token_ids"] == reference(pa, REF_TOKENS)

    run(main())


def test_resume_by_last_event_id_replays_the_exact_suffix(llama, reference):
    """A finished stream stays re-readable: GET /v1/completions/<id> with
    Last-Event-ID k, or a POST naming its request_id, replays exactly the
    tokens after k (event ids k+1..n) and its finish; an unknown id is a
    404 the client can fall back on."""
    eng = engine(llama)
    p = prompts(8, 1)[0]
    want = reference(p, 8)

    async def main():
        async with serving(eng) as srv:
            first = await stream(srv, p, 8)
            assert first["token_ids"] == want
            cid = first["stream_id"]
            st, _, reader, writer = await raw_request(
                srv.host, srv.port, "GET", f"/v1/completions/{cid}",
                headers=(("Last-Event-ID", "3"),))
            assert st == 200
            toks, ids, reason, done = await read_sse(reader, writer)
            assert (toks, ids, reason, done) == (want[3:], list(range(4, 9)), "length", True)
            st, _, reader, writer = await raw_request(
                srv.host, srv.port, "POST", "/v1/completions", {"request_id": cid},
                headers=(("Last-Event-ID", "6"),))
            assert st == 200 and (await read_sse(reader, writer))[0] == want[6:]
            st, _, reader, writer = await raw_request(
                srv.host, srv.port, "GET", "/v1/completions/cmpl-999",
                headers=(("Last-Event-ID", "0"),))
            body = json.loads(await reader.read())
            writer.close()
            assert st == 404 and body["error"]["code"] == "unknown_completion"
            st, _, reader, writer = await raw_request(
                srv.host, srv.port, "GET", f"/v1/completions/{cid}",
                headers=(("Last-Event-ID", "9"),))
            writer.close()
            assert st == 404
        assert srv.runner.journal_resumed == 2

    run(main())

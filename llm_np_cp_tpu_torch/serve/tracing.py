"""Request-lifecycle and tick-phase tracing, and W3C trace context (port
of ``llm_np_cp_tpu/serve/tracing.py``).

``ServeMetrics`` answers how much; this module answers where the time
went.  ``TraceRecorder`` collects a Chrome/Perfetto trace-event timeline
(stdlib only; open a dump at ui.perfetto.dev or chrome://tracing):

- **per-request spans**: async events (``ph`` b/e/n) on one track per
  request id — ``queued`` → ``prefill`` (one ``prefill_chunk`` slice per
  phase-split chunk) → ``decode`` → a reason-tagged ``finish`` instant,
  with ``evicted-requeued``, ``recovery-replay``, ``kv-restore`` and
  ``spec-fallback`` instants.  The HTTP layer brackets each request with
  an ``http`` span from socket accept.
- **per-tick phase spans**: complete events (``ph`` X) on the engine's
  tick thread, ``TICK_PHASES`` (phase-split) or ``MIXED_TICK_PHASES``
  (unified) nested under one ``tick`` event.  The phases are measured at
  consecutive timestamps, so they sum to the tick span by construction.
  On the card every unified tick is a CUDA graph replay: ``mixed_dispatch``
  is the graph launch (tens of µs) and ``host_sync`` the wait on the
  device, since the token fetch synchronises.
- the dispatch phases run under ``torch.profiler.record_function``
  (``serve.mixed_dispatch`` / ``serve.decode_dispatch`` /
  ``serve.prefill_chunk``) while a tracer is attached, so this host
  timeline lines up with a torch.profiler capture of the card.

Every recorder hook in the engine and the HTTP server is a single ``is
None`` check: nothing constructs a recorder unless asked.  Every hook
runs in the host tick code around a replay, never inside a captured
step (Python inside a captured step runs once, at capture).

Thread safety: events arrive from the engine's tick thread, the event
loop, the watchdog and the supervisor's rebuild thread; one lock
serializes every append, and readers (``events()`` / ``to_dict()`` /
``GET /debug/trace``) copy under it.  With ``ring=N`` the recorder keeps
the newest N events and ``dropped`` counts what the ring displaced.

W3C trace context: every request carries one 32-hex trace id, the
caller's (parsed from its ``traceparent`` header) or one the server
generates; the engine keeps it in ``Request.extra["trace"]`` and span
args carry it.  Format: ``00-<32 hex trace id>-<16 hex parent span
id>-<2 hex flags>``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable

# The request-lifecycle phase names, in order (``request_phase`` moves a
# request between them; ``request_end`` closes the track with a finish
# instant).  tools/summarize_trace.py keeps its own copy.
REQUEST_PHASES = ("queued", "prefill", "decode")
# The phase-split tick's phases, in tick order (ServeEngine._step_split).
TICK_PHASES = (
    "admission", "prefill", "grow", "decode_dispatch", "host_sync", "deliver",
)
# The unified tick's phases (ServeEngine._step_mixed): prefill folds into
# the one mixed dispatch, the token-budget planner gets its own slice, and
# ``draft`` is the host-side prompt-lookup pass of speculative serving
# (~0 without spec_k).  Tick args also carry the prefill/decode token
# split, and spec_draft_tokens / spec_accept_tokens on a spec engine.
MIXED_TICK_PHASES = (
    "admission", "draft", "grow", "plan", "mixed_dispatch", "host_sync", "deliver",
)

_TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def gen_trace_id() -> str:
    return os.urandom(16).hex()


def gen_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``traceparent`` header → ``(trace_id, parent_span_id)``, or None
    when absent/malformed (a bad header means a fresh trace, never a
    400 — trace context must not be able to fail a request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, parent_id, _flags = m.groups()
    if version == "ff":  # forbidden version
        return None
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None  # all-zero ids are invalid per spec
    return trace_id, parent_id


def make_traceparent(trace_id: str, span_id: str | None = None) -> str:
    """Render the header this server emits back (sampled flag set: the
    server recorded the request, whatever upstream decided)."""
    return f"00-{trace_id}-{span_id or gen_span_id()}-01"


class TraceRecorder:
    """The trace-event timeline (module docstring).  ``clock`` is the
    recorder's own (perf_counter by default); ``wall_epoch`` anchors its
    epoch on the wall clock, so dumps of several processes merge
    (``tools/summarize_trace.py --merge``).  ``otel`` is an optional span
    sink (``serve/otel.OtlpExporter``): every kept event is also offered
    to it, enqueue only."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 ring: int | None = None) -> None:
        if ring is not None and ring < 1:
            raise ValueError(f"ring must be >= 1 or None, got {ring}")
        self.clock = clock
        self.ring = ring
        self._t0 = clock()
        self.wall_epoch = time.time()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._events: deque | list = deque(maxlen=ring) if ring is not None else []
        self.otel: Any = None
        self.dropped = 0
        # rid → the request's open lifecycle phase (the http bracket is
        # tracked apart, by async_begin / async_end)
        self._req_phase: dict[int, str] = {}
        self._named_threads: set[int] = set()

    # -- clock ---------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since the recorder was built (the trace epoch)."""
        return (self.clock() - self._t0) * 1e6

    # -- append (callers hold no lock) ---------------------------------
    def _ensure_thread_named(self, tid: int) -> None:
        # caller holds the lock: a thread's first event gets the
        # thread_name metadata event viewers label its track with
        if tid not in self._named_threads:
            self._named_threads.add(tid)
            self._push({"name": "thread_name", "ph": "M", "pid": self._pid, "tid": tid,
                        "args": {"name": threading.current_thread().name}})

    def _append(self, ev: dict, tid: int | None = None) -> None:
        tid = threading.get_ident() if tid is None else tid
        ev.setdefault("pid", self._pid)
        ev.setdefault("tid", tid)
        with self._lock:
            self._ensure_thread_named(tid)
            self._push(ev)

    def _push(self, ev: dict) -> None:
        # caller holds the lock; the exporter's offer() is one append
        # under its own lock (recorder lock → exporter lock, never back)
        if self.ring is not None and len(self._events) == self.ring:
            self.dropped += 1
        self._events.append(ev)
        if self.otel is not None:
            self.otel.offer(ev)

    # -- thread-track events -------------------------------------------
    def complete(self, name: str, start_us: float, end_us: float | None = None, *,
                 cat: str = "phase", args: dict | None = None) -> None:
        """One ``ph: X`` slice on the calling thread's track."""
        if end_us is None:
            end_us = self.now_us()
        ev: dict[str, Any] = {"name": name, "cat": cat, "ph": "X", "ts": start_us,
                              "dur": max(end_us - start_us, 0.0)}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, *, cat: str = "tick", args: dict | None = None) -> None:
        ev: dict[str, Any] = {"name": name, "cat": cat, "ph": "i", "ts": self.now_us(),
                              "s": "t"}
        if args:
            ev["args"] = args
        self._append(ev)

    def tick(self, start_us: float, phases: tuple[tuple[str, float, float], ...], *,
             args: dict | None = None, end_us: float | None = None) -> None:
        """One tick: the ``tick`` slice and its phase slices ``(name,
        t0_us, t1_us)``, appended atomically (a ``/debug/trace`` read
        never sees half a tick).  Measured at consecutive timestamps, the
        phases sum to the tick span.  The slice ends at ``end_us``, or now
        when it is None."""
        if end_us is None:
            end_us = self.now_us()
        tid = threading.get_ident()
        events = [{"name": "tick", "cat": "tick", "ph": "X", "ts": start_us,
                   "dur": max(end_us - start_us, 0.0), "pid": self._pid, "tid": tid,
                   **({"args": args} if args else {})}]
        for name, p0, p1 in phases:
            events.append({"name": name, "cat": "phase", "ph": "X", "ts": p0,
                           "dur": max(p1 - p0, 0.0), "pid": self._pid, "tid": tid})
        with self._lock:
            self._ensure_thread_named(tid)
            for ev in events:
                self._push(ev)

    # -- request-lifecycle (async-track) events ------------------------
    def async_begin(self, rid: int, name: str, *, ts_us: float | None = None,
                    args: dict | None = None) -> None:
        ev: dict[str, Any] = {"name": name, "cat": "request", "ph": "b", "id": rid,
                              "ts": self.now_us() if ts_us is None else ts_us}
        if args:
            ev["args"] = args
        self._append(ev)

    def async_end(self, rid: int, name: str, *, ts_us: float | None = None) -> None:
        self._append({"name": name, "cat": "request", "ph": "e", "id": rid,
                      "ts": self.now_us() if ts_us is None else ts_us})

    def request_phase(self, rid: int, phase: str, *, args: dict | None = None) -> None:
        """Move request ``rid`` into ``phase``: end its open lifecycle span
        and begin the new one at the same timestamp."""
        now = self.now_us()
        with self._lock:
            open_phase = self._req_phase.get(rid)
            self._req_phase[rid] = phase
        if open_phase is not None:
            self.async_end(rid, open_phase, ts_us=now)
        self.async_begin(rid, phase, ts_us=now, args=args)

    def request_instant(self, rid: int, name: str, *, args: dict | None = None) -> None:
        """An async instant (``ph: n``) on the request's track."""
        ev: dict[str, Any] = {"name": name, "cat": "request", "ph": "n", "id": rid,
                              "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._append(ev)

    def request_end(self, rid: int, reason: str, *, args: dict | None = None) -> None:
        """Terminal: close the open lifecycle span and stamp a
        reason-tagged ``finish`` instant (one per terminal counter)."""
        now = self.now_us()
        with self._lock:
            open_phase = self._req_phase.pop(rid, None)
        if open_phase is not None:
            self.async_end(rid, open_phase, ts_us=now)
        merged = {"reason": reason}
        if args:
            merged.update(args)
        self._append({"name": "finish", "cat": "request", "ph": "n", "id": rid, "ts": now,
                      "args": merged})

    # -- export --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        """A point-in-time copy (the ring keeps moving underneath)."""
        with self._lock:
            return list(self._events)

    def to_dict(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped, "wall_epoch": self.wall_epoch}}

    def dump(self, path: str) -> int:
        """Write the Chrome trace-event JSON; returns the event count."""
        payload = self.to_dict()
        with open(path, "w") as f:
            json.dump(payload, f)
        return len(payload["traceEvents"])

"""OTLP/HTTP span export: the serve trace plane shipped to a collector
(port of ``llm_np_cp_tpu/serve/otel.py``; stdlib only, no CUDA call).

A stdlib OTLP/HTTP **JSON** exporter (the OpenTelemetry protocol's
``application/json`` encoding, POSTed to ``<endpoint>``, typically
``http://collector:4318/v1/traces``):

- ``OtlpExporter.offer(event)``: the ``TraceRecorder``'s sink hook —
  every event the recorder keeps is also enqueued here (one append under
  a lock; the recorder guards the call with an ``is None`` check).
- a writer thread drains the queue in batches, converts trace events to
  OTLP ``ResourceSpans`` and POSTs them with ``urllib``.  A slow or dead
  collector shows as dropped batches and a counter, never as tick or
  event-loop latency: an export error is counted and its batch dropped.
  The pending queue is bounded (``pending_max``): a hung collector makes
  ``offer`` drop and count instead of growing memory.

Conversion (OTLP has spans, not Perfetto's event kinds): ``ph: X``
slices → spans; ``ph: b``/``e`` request phases → spans matched per
``(id, name)`` on the writer thread (an unmatched ``b`` at close exports
as a zero-length span); ``ph: i``/``n`` instants → zero-length spans with
``llm.instant: true``; metadata events are skipped.  A span's
``traceId`` is the event's W3C ``args.trace`` when it has one, else one
synthetic id a process; timestamps are the recorder's µs rebased on its
``wall_epoch`` → Unix nanos.  The scope is this package's,
``llm_np_cp_tpu_torch.serve``.

Thread safety: ``offer`` may run on any thread (under the recorder's
lock); the pending queue and counters are under the exporter's lock, the
open-span map and the HTTP plumbing belong to the writer thread.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any

_HEX32 = re.compile(r"^[0-9a-f]{32}$")


def _otlp_value(v: Any) -> dict[str, Any]:
    """One OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attrs(pairs: dict[str, Any]) -> list[dict[str, Any]]:
    return [
        {"key": k, "value": _otlp_value(v)} for k, v in pairs.items()
    ]


class OtlpExporter:
    """Batched, drop-on-failure OTLP/HTTP JSON span exporter.

    Engine/recorder-side API: ``offer(event)`` (enqueue only, no IO).
    Control: ``flush()`` (barrier: everything offered before the call
    has been attempted against the collector), ``close()``,
    ``stats()``.
    """

    def __init__(
        self,
        endpoint: str,
        *,
        service_name: str = "llm-serve",
        resource_attrs: dict[str, Any] | None = None,
        wall_epoch: float | None = None,
        batch_max: int = 512,
        pending_max: int = 65536,
        flush_interval_s: float = 1.0,
        timeout_s: float = 5.0,
    ) -> None:
        if not endpoint:
            raise ValueError("otlp endpoint must be a non-empty URL")
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        if pending_max < 1:
            raise ValueError(
                f"pending_max must be >= 1, got {pending_max}"
            )
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.batch_max = batch_max
        self.pending_max = pending_max
        self.flush_interval_s = flush_interval_s
        # µs-since-recorder-epoch → Unix nanos anchor; attach() copies
        # the recorder's own wall anchor so exported spans line up with
        # summarize_trace --merge timelines
        self.wall_epoch = wall_epoch if wall_epoch is not None \
            else time.time()
        self._resource = {
            "attributes": _attrs({
                "service.name": service_name,
                "process.pid": os.getpid(),
                **(resource_attrs or {}),
            }),
        }
        # synthetic trace id for events with no W3C id of their own
        # (tick phases, lifecycle instants): one service-level trace
        # per process
        self._proc_trace_id = os.urandom(16).hex()
        # shared under _lock: the pending queue and the stats counters
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list = []
        self._stopping = False
        self.n_spans = 0
        self.n_batches = 0
        self.n_dropped = 0
        self.n_export_errors = 0
        # writer-thread-owned from here on: open
        # async spans awaiting their ``e`` event
        self._wopen: dict[tuple, dict] = {}
        self._thread = threading.Thread(
            target=self._writer_loop, name="serve-otlp-exporter",
            daemon=True,
        )
        self._thread.start()

    # -- recorder-side hook (enqueue only, no IO) ----------------------
    def offer(self, event: dict[str, Any]) -> None:
        with self._lock:
            if self._stopping:
                return
            if len(self._pending) >= self.pending_max:
                # a HUNG collector (blackholed, not refused) blocks the
                # writer in its POST timeout while the engine keeps
                # producing; the queue must not grow without bound —
                # drop-and-count, like every other degradation here
                self.n_dropped += 1
                return
            self._pending.append(event)
            if len(self._pending) >= self.batch_max:
                self._cond.notify()

    def attach(self, tracer: Any) -> "OtlpExporter":
        """Wire this exporter as ``tracer``'s sink (idempotent helper
        for the CLI): adopts the recorder's wall anchor so span
        timestamps and merged trace timelines agree."""
        self.wall_epoch = tracer.wall_epoch
        tracer.otel = self
        return self

    # -- control -------------------------------------------------------
    def flush(self, timeout: float = 10.0) -> bool:
        ev = threading.Event()
        with self._lock:
            if self._stopping and self._thread.is_alive() is False:
                return True
            self._pending.append(("flush", ev))
            self._cond.notify()
        return ev.wait(timeout)

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "spans": self.n_spans,
                "batches": self.n_batches,
                "dropped": self.n_dropped,
                "export_errors": self.n_export_errors,
            }

    # -- writer thread ---------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stopping:
                    self._cond.wait(self.flush_interval_s)
                batch, self._pending = self._pending, []
                stopping = self._stopping
            if batch:
                self._writer_batch(batch)
            if stopping:
                with self._lock:
                    leftover, self._pending = self._pending, []
                if leftover:
                    self._writer_batch(leftover)
                # unmatched async begins: export as zero-length spans
                # rather than losing the request's last phase
                tails = [
                    self._span_from(ev, ev["ts"], ev["ts"])
                    for ev in self._wopen.values()
                ]
                self._wopen.clear()
                if tails:
                    self._export(tails)
                return

    def _writer_batch(self, batch: list) -> None:
        spans: list[dict] = []
        barriers = []
        for item in batch:
            if not isinstance(item, dict):
                barriers.append(item[1])
                continue
            span = self._convert(item)
            if span is not None:
                spans.append(span)
        # ship in bounded slices so one huge drain cannot build an
        # unbounded request body
        for i in range(0, len(spans), self.batch_max):
            self._export(spans[i:i + self.batch_max])
        for ev in barriers:
            ev.set()

    def _convert(self, ev: dict[str, Any]) -> dict | None:
        ph = ev.get("ph")
        if ph == "X":
            ts = ev.get("ts", 0.0)
            return self._span_from(ev, ts, ts + ev.get("dur", 0.0))
        if ph == "b":
            self._wopen[(ev.get("id"), ev.get("name"))] = ev
            return None
        if ph == "e":
            begin = self._wopen.pop((ev.get("id"), ev.get("name")), None)
            if begin is None:
                return None  # end without a begin (ring displaced it)
            return self._span_from(begin, begin.get("ts", 0.0),
                                   ev.get("ts", 0.0))
        if ph in ("i", "n"):
            ts = ev.get("ts", 0.0)
            return self._span_from(ev, ts, ts, instant=True)
        return None  # metadata / counter events

    def _span_from(self, ev: dict[str, Any], t0_us: float,
                   t1_us: float, *, instant: bool = False) -> dict:
        args = ev.get("args") or {}
        trace = args.get("trace")
        trace_id = (
            trace if isinstance(trace, str) and _HEX32.match(trace)
            else self._proc_trace_id
        )
        attrs: dict[str, Any] = {"llm.cat": ev.get("cat", "")}
        if ev.get("id") is not None:
            attrs["llm.rid"] = ev["id"]
        if instant:
            attrs["llm.instant"] = True
        for k, v in args.items():
            if k != "trace":
                attrs[f"llm.{k}"] = v
        base_ns = self.wall_epoch * 1e9
        return {
            "traceId": trace_id,
            "spanId": os.urandom(8).hex(),
            "name": str(ev.get("name", "?")),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(base_ns + t0_us * 1e3)),
            "endTimeUnixNano": str(int(base_ns + max(t1_us, t0_us) * 1e3)),
            "attributes": _attrs(attrs),
        }

    def _export(self, spans: list[dict]) -> None:
        if not spans:
            return
        payload = {
            "resourceSpans": [{
                "resource": self._resource,
                "scopeSpans": [{
                    "scope": {"name": "llm_np_cp_tpu_torch.serve"},
                    "spans": spans,
                }],
            }],
        }
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload, separators=(",", ":")).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except (urllib.error.URLError, OSError, ValueError):
            # collector down/slow/misconfigured: telemetry degradation,
            # never an outage — drop the batch and count it
            with self._lock:
                self.n_export_errors += 1
                self.n_dropped += len(spans)
            return
        with self._lock:
            self.n_spans += len(spans)
            self.n_batches += 1

"""W3C trace context, the ``traceparent`` header (port of
``llm_np_cp_tpu/serve/tracing.py``, its trace-context helpers only).

Every request carries one 32-hex trace id: the caller's, parsed from
its ``traceparent`` header, or one the server generates.  The engine
keeps it in ``Request.extra["trace"]`` and the server echoes it back on
every response, so a client or proxy can join its own telemetry to this
server's requests.
Format: ``00-<32 hex trace id>-<16 hex parent span id>-<2 hex flags>``.

``TraceRecorder`` (the Chrome/Perfetto request and tick-phase timeline,
``/debug/trace``) and the engine's tracer hooks are the tracing slice,
not ported yet: ``ServeEngine(tracer=...)`` raises.
"""

from __future__ import annotations

import os
import re

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

"""Server-Sent Events framing, the OpenAI streaming wire format (port of
``llm_np_cp_tpu/serve/http/sse.py``; its bytes are the JAX package's).

One event per generated token: ``data: <json>\\n\\n``, terminated by the
literal ``data: [DONE]\\n\\n`` sentinel.  Kept apart from the HTTP server
so the framing is testable against raw bytes and reusable by the
stdlib client without the server's asyncio machinery.
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator

DONE_SENTINEL = b"data: [DONE]\n\n"


def sse_event(payload: dict[str, Any], *, event_id: int | None = None) -> bytes:
    """One ``data:`` frame, optionally carrying an ``id:`` line.  Token
    frames use the delivered-token index as the event id — what a
    reconnecting client sends back as ``Last-Event-ID`` to resume the
    stream.  Payloads are single-line JSON, so the multi-line ``data:``
    continuation rule never applies."""
    head = f"id: {event_id}\n".encode() if event_id is not None else b""
    return head + b"data: " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n"


def parse_sse_line(line: bytes) -> dict[str, Any] | None:
    """Decode one stripped SSE line → payload dict, None for the [DONE]
    sentinel / blank separators / comments / non-data fields (``id:``,
    ``event:``, ``retry:``).  Raises ValueError on a ``data:`` line that
    is not valid JSON (a framing bug, not traffic)."""
    line = line.strip()
    if not line or line.startswith(b":"):
        return None
    if line.startswith(b"id:") or line.startswith(b"event:") or line.startswith(b"retry:"):
        return None
    if not line.startswith(b"data:"):
        raise ValueError(f"not an SSE data line: {line!r}")
    body = line[len(b"data:"):].strip()
    if body == b"[DONE]":
        return None
    return json.loads(body)


async def iter_sse_payloads(reader) -> AsyncIterator[dict[str, Any]]:
    """Yield decoded payloads from an ``asyncio.StreamReader`` until the
    [DONE] sentinel or EOF."""
    while True:
        line = await reader.readline()
        if not line:
            return
        stripped = line.strip()
        if stripped == b"data: [DONE]" or stripped == b"data:[DONE]":
            return
        payload = parse_sse_line(line)
        if payload is not None:
            yield payload

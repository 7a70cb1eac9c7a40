"""Stdlib clients for the HTTP front end (port of
``llm_np_cp_tpu/serve/http/client.py``): loadgen and smoke tests.

Two flavors, both dependency-free:

- ``astream_completion`` — asyncio streams, one coroutine per request;
  what the bench loadgen fans out to measure client-observed TTFT (the
  number the HTTP layer's overhead actually shows up in).
- ``http_get`` / ``post_completion`` — synchronous ``http.client``, the
  "any stock client works" smoke path (no asyncio on the caller side).
"""

from __future__ import annotations

import asyncio
import contextlib
import http.client
import json
import random
import time
from typing import Any

from llm_np_cp_tpu_torch.serve.http.sse import iter_sse_payloads


def http_get(host: str, port: int, path: str,
             timeout: float = 10.0) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_post(host: str, port: int, path: str,
              payload: dict[str, Any] | None = None,
              timeout: float = 60.0) -> tuple[int, dict[str, Any]]:
    """JSON POST to an arbitrary path (the /admin lifecycle endpoints);
    returns (status, parsed body or {})."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path,
                     body=json.dumps(payload or {}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw) if raw else {}
        except ValueError:
            return resp.status, {"raw": raw.decode(errors="replace")}
    finally:
        conn.close()


def post_completion(host: str, port: int, payload: dict[str, Any],
                    timeout: float = 60.0) -> tuple[int, dict[str, Any]]:
    """Non-streaming completion through the stock stdlib client."""
    return http_post(host, port, "/v1/completions", payload, timeout)


async def _astream_once(
    host: str, port: int, body: bytes, t0: float,
    out: dict[str, Any], *,
    timeout: float, disconnect_after: int | None,
    headers: tuple[tuple[str, str], ...] = (),
) -> dict[str, Any]:
    """One streaming POST attempt (no retry).  ``out`` is caller-owned so
    partial progress (tokens already received) survives a mid-stream
    exception — the retry wrapper must see it to resume (or refuse a
    resend)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(
            b"POST /v1/completions HTTP/1.1\r\n"
            + f"Host: {host}:{port}\r\n".encode()
            + b"Content-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n".encode()
            + b"".join(f"{k}: {v}\r\n".encode() for k, v in headers)
            + b"Connection: close\r\n\r\n" + body
        )
        await writer.drain()

        async def consume() -> None:
            status_line = await reader.readline()
            if not status_line:
                # closed before any response byte — the same transient
                # class as a refused connection, typed so the retry
                # wrapper's except tuple catches it
                raise asyncio.IncompleteReadError(b"", None)
            out["status"] = int(status_line.split()[1])
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, value = line.decode("latin-1").partition(":")
                if key.strip().lower() == "retry-after":
                    with contextlib.suppress(ValueError):
                        out["retry_after_s"] = float(value.strip())
            if out["status"] != 200:
                out["error"] = (await reader.read()).decode(errors="replace")
                return
            n = 0
            async for chunk in iter_sse_payloads(reader):
                choice = chunk["choices"][0]
                if chunk.get("id"):
                    # the completion id — the resume handle a retry
                    # re-POSTs with after a mid-stream cut
                    out["stream_id"] = chunk["id"]
                if out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                if choice.get("token_id") is not None:
                    out["token_ids"].append(choice["token_id"])
                if choice.get("text"):
                    # caller-owned like token_ids: text received before
                    # a mid-stream cut must survive into the resume
                    out["text_parts"].append(choice["text"])
                if choice.get("finish_reason"):
                    out["finish_reason"] = choice["finish_reason"]
                n += 1
                if disconnect_after is not None and n >= disconnect_after:
                    out["finish_reason"] = "disconnected"
                    return

        await asyncio.wait_for(consume(), timeout=timeout)
    finally:
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()
    out["latency_s"] = time.perf_counter() - t0
    return out


async def astream_completion(
    host: str, port: int, payload: dict[str, Any], *,
    timeout: float = 120.0,
    disconnect_after: int | None = None,
    retries: int = 0,
    backoff_s: float = 0.25,
    max_backoff_s: float = 4.0,
    rng: random.Random | None = None,
) -> dict[str, Any]:
    """POST a streaming completion and consume its SSE stream.

    Returns ``{"status", "token_ids", "text", "finish_reason",
    "ttft_s", "latency_s", "error", "retries"}``.  ``disconnect_after=n``
    closes the socket after the n-th token chunk (the forced mid-stream
    disconnect the abort tests drive); the result then carries
    ``finish_reason="disconnected"``.

    ``retries``: transient failures — HTTP 429/503 (backpressure, drain,
    a mid-restart blip) and connection errors that struck before any
    token arrived — are retried up to this many times with capped
    exponential backoff plus jitter, honoring the server's ``Retry-After``
    when it is larger than the backoff.  TTFT is measured from the FIRST
    attempt, so retried requests honestly carry their queueing delay.

    RESUME (the Last-Event-ID protocol): a stream cut AFTER tokens
    were delivered is never blindly resent — if the stream's completion
    id was seen, the retry re-POSTs ``{"request_id": <id>}`` with
    ``Last-Event-ID: <tokens received>``, and the server replays exactly
    the missing suffix (from its in-flight ledger or its finished-stream
    LRUs) then continues live, so no token is ever generated twice.  Without a
    resume handle the old rule holds: the failure surfaces.  The result
    carries ``resumed`` (resume attempts) and ``resume_latency_s``
    (first cut → first resumed token — the client-observed
    restart-to-first-resumed-token latency).
    """
    t0 = time.perf_counter()
    req = dict(payload)
    req["stream"] = True
    base_body = json.dumps(req).encode()
    rng = rng or random
    attempts = 0
    tokens: list[int] = []
    text_parts: list[str] = []
    stream_id: str | None = None
    ttft_s: float | None = None
    resumed = 0
    resume_latency_s: float | None = None
    t_cut: float | None = None
    while True:
        out: dict[str, Any] = {
            "status": None, "token_ids": [], "text_parts": [],
            "finish_reason": None, "ttft_s": None, "latency_s": None,
            "error": None, "retry_after_s": None, "stream_id": None,
        }
        if tokens and stream_id is not None:
            # resume the cut stream instead of resending the prompt
            # (no "model" key when the original request carried none —
            # the server then echoes its own model id)
            resume_req = {"request_id": stream_id, "stream": True}
            if req.get("model") is not None:
                resume_req["model"] = req["model"]
            body = json.dumps(resume_req).encode()
            headers = (("Last-Event-ID", str(len(tokens))),)
        else:
            body, headers = base_body, ()
        try:
            await _astream_once(
                host, port, body, t0, out,
                timeout=timeout, disconnect_after=disconnect_after,
                headers=headers,
            )
            # a 200 whose SSE stream ended with neither a token nor a
            # finish_reason is a truncated response (a reset can read as
            # clean EOF on loopback) — transient, like a refused
            # connection.  A truncated stream that DID deliver tokens is
            # transient too WHEN it can be resumed (the server replays
            # the suffix); without a resume handle it is returned as-is
            # (resending would duplicate generation).
            cut_mid_stream = (
                out["status"] == 200 and out["finish_reason"] is None
                and (tokens or out["token_ids"])
                and (out["stream_id"] or stream_id) is not None
            )
            transient = out["status"] in (429, 503) or cut_mid_stream or (
                out["status"] == 200 and not out["token_ids"]
                and not tokens and out["finish_reason"] is None
            )
        except (OSError, asyncio.IncompleteReadError) as e:
            if isinstance(e, TimeoutError):
                # py>=3.11 spells asyncio.wait_for's timeout as
                # builtins.TimeoutError, an OSError subclass — a timeout
                # is the caller's budget, never a transient to retry
                raise
            resumable = (
                (out["stream_id"] or stream_id) is not None
                or not (tokens or out["token_ids"])
            )
            if not resumable or attempts >= retries:
                # tokens streamed and no resume handle: a blind resend
                # would generate the whole completion twice — surface
                raise
            out["error"] = f"{type(e).__name__}: {e}"
            transient = True
        # fold this attempt's progress into the stream-so-far (resumes
        # deliver exactly the missing suffix, so append is exact)
        if out["token_ids"]:
            if (t_cut is not None and resume_latency_s is None
                    and out["ttft_s"] is not None):
                # cut → FIRST resumed token (the attempt's ttft is
                # anchored at t0), not cut → end-of-stream
                resume_latency_s = max(t0 + out["ttft_s"] - t_cut, 0.0)
            tokens.extend(out["token_ids"])
        text_parts.extend(out["text_parts"])
        if out["stream_id"]:
            stream_id = out["stream_id"]
        if ttft_s is None:
            ttft_s = out["ttft_s"]
        if not transient or attempts >= retries:
            out["token_ids"] = tokens
            out["text"] = "".join(text_parts)
            out.pop("text_parts", None)
            out["ttft_s"] = ttft_s
            out["latency_s"] = time.perf_counter() - t0
            out["retries"] = attempts
            out["resumed"] = resumed
            out["resume_latency_s"] = resume_latency_s
            return out
        if tokens and stream_id is not None:
            resumed += 1
            if t_cut is None:
                t_cut = time.perf_counter()
        wait = min(backoff_s * (2 ** attempts), max_backoff_s)
        if out.get("retry_after_s"):
            wait = max(wait, out["retry_after_s"])
        await asyncio.sleep(wait * (1.0 + 0.25 * rng.random()))
        attempts += 1

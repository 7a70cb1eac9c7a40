"""Dependency-free asyncio HTTP front end over ``ServeEngine`` (port of
``llm_np_cp_tpu/serve/http/server.py``).

Two threads, one contract:

- The **engine thread** (``EngineRunner``) owns the ``ServeEngine``
  exclusively: every engine entry point (submit/abort/step) runs there,
  so the engine needs no locks, and every CUDA call of the server is
  made there.  Handlers talk to it through a thread-safe command queue;
  admission verdicts (queue full → 429, capacity ValueError → 400) are
  made on the engine thread, where the scheduler's state is consistent,
  and come back as the first event on the request's bridge queue.  The
  thread runs on the engine's device and on the CUDA stream (and grad
  mode) that the runner's constructor found current, so the graphs that
  ``warmup`` captured on the caller's thread replay from it.
- The **event loop** (``HttpServer``) speaks HTTP/1.1 over stdlib
  ``asyncio`` streams and touches no tensor: the protocol hands numpy
  prompts to the runner, and the events that cross back (through
  ``loop.call_soon_threadsafe`` onto per-request ``asyncio.Queue``s) are
  ints and strings.

Endpoints:

- ``POST /v1/completions`` — OpenAI-compatible JSON; ``"stream": true``
  streams SSE chunks fed from the engine's per-request callbacks.  A
  client that disconnects mid-stream aborts its request (its blocks go
  back to the pool); ``timeout_s`` (or the server-wide
  ``request_timeout``) becomes an engine deadline with the same abort.
  A body naming a ``request_id`` resumes that stream.
- ``GET /v1/completions/<id>`` with ``Last-Event-ID`` — stream resume:
  the delivered-token suffix from the in-flight ledger (or, for a
  finished stream, from the bounded LRUs of finished output), then live.
- ``GET /healthz`` — ``ok`` / ``degraded`` (a supervised restart in
  progress, still 200) / ``draining`` / ``crashed``.
- ``GET /metrics`` — Prometheus text from ``ServeMetrics`` plus the
  live pool/stream gauges of the JAX server, the OTLP exporter's
  counters and the tenant ledger's series when those are attached.
- ``GET /debug/trace`` — the engine's ``TraceRecorder`` as Chrome
  trace-event JSON (copied under the recorder's lock, serialized off the
  event loop); ``GET /debug/slo`` — the metrics' ``SLOTracker``
  (``aggregate_slo``); ``GET /debug/tenants`` — the ``TenantLedger``
  (``aggregate_tenants``).  Each answers 404 with its layer off, as the
  JAX server does.

With a tracer on the engine, every completion gets an ``http`` span on
its request track from socket accept to the response's end, enclosing
the engine's queued / prefill / decode spans.

Shutdown (``begin_drain``, SIGTERM/SIGINT when the server runs on the
main thread): new completions get 503, in-flight streams finish up to
``drain_timeout``, stragglers are aborted, then the socket closes.

Faults and recovery: a tick that raises, or hangs past
``tick_deadline``, is an engine death.  With ``max_restarts > 0`` the
runner retires the dead engine, rebuilds it (``clone_fresh``: a fresh
pool, its graphs captured again before it serves) and replays every
in-flight stream teacher-forced (``recover``); past the restart budget,
or with supervision off, a death ends every stream cleanly
(``aborted``), ``/healthz`` turns 503 ``crashed`` and new work gets 503.
An engine with a request journal (``serve/journal.py``) has the
unterminated requests of a dead process replayed when the runner is
built, and its stream events reach clients only once the journal holds
what they carry (write-ahead delivery: after a ``kill -9`` a client
never holds a token the restart has to regenerate).  The chaos sites ``tick_hang``, ``tick_crash``, ``proc_kill``,
``http_429`` and ``http_reset`` (``serve/faults.py``) fire from the
engine's fault injector.  A restart mutes the dead engine's tracer,
sentinel and tenant ledger (the rebuilt engine shares them), stamps
``engine-death`` and a ``restart`` span (or ``engine-terminal-crash``)
on the trace, and the rebuild's captures are never tick spans or
sentinel samples (they run outside ``step``).

The fleet and its lifecycle (``serve/replica.py``, ``serve/lifecycle.py``):
``runner=`` takes a ``ReplicaRunner`` (one ``EngineRunner`` a replica,
each ticking on its own thread and CUDA stream, behind the
prefix-affinity router; ``/healthz`` lists the replicas and reads
``degraded`` while one is dark, ``/metrics`` labels each replica's
series); ``POST /admin/upgrade`` rolls the fleet (or the single engine
in place) onto what ``upgrade_loader`` returns, ``POST /admin/scale``
grows or shrinks a fleet, one admin operation at a time (409 otherwise);
and an engine's ``ActionPolicy`` sheds fresh completions 503-first with
a burn-scaled ``Retry-After`` while the SLO budget burns.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import json
import os
import queue as queue_mod
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any

import torch

from llm_np_cp_tpu_torch.generate import IncrementalDetok
from llm_np_cp_tpu_torch.serve.faults import FaultInjected

from llm_np_cp_tpu_torch.serve.http.protocol import (
    HTTPError,
    chunk_payload,
    completion_payload,
    error_body,
    parse_completion_request,
    parse_completion_rid,
    parse_last_event_id,
    parse_resume_request,
)
from llm_np_cp_tpu_torch.serve.http.sse import DONE_SENTINEL, sse_event
from llm_np_cp_tpu_torch.serve.metrics import ServeMetrics
from llm_np_cp_tpu_torch.serve.scheduler import QueueFull, TenantThrottled
from llm_np_cp_tpu_torch.serve.slo import aggregate_slo
from llm_np_cp_tpu_torch.serve.tenants import aggregate_tenants
from llm_np_cp_tpu_torch.serve.tracing import gen_trace_id, make_traceparent, parse_traceparent

TERMINAL_EVENTS = ("stop", "length", "aborted")


class _ResumeEcho:
    """The one payload field ``_stream_response`` reads, for resumed
    streams (which carry no CompletionPayload)."""

    def __init__(self, echo_model: str) -> None:
        self.echo_model = echo_model


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}
MAX_BODY_BYTES = 8 << 20


class EngineRunner:
    """Runs the engine's tick loop on a worker thread, supervises it, and
    bridges it to asyncio handlers.

    Commands (submit/attach/abort) are drained at the top of every loop
    pass, then one ``engine.step()`` runs if there is work; when idle the
    loop blocks on the command queue (no spin).  Events flow back per
    request: ``("accepted",)`` / ``("rejected", retry_after[, msg])`` /
    ``("error", msg)`` on the admission verdict, ``("token", id, delta)``
    per generated token, ``("finish", reason, final_text_delta)``
    terminally.

    Supervision (``max_restarts > 0``): a tick that raises (an injected
    ``tick_crash`` or ``decode`` fault, or a real one), or one the
    watchdog finds hung (no heartbeat within ``tick_deadline``), is an
    engine death.  The runner bumps the generation (a superseded thread
    that wakes finds itself stale and its callbacks mute), waits a
    backoff that doubles per death in ``restart_window_s`` (capped at
    10 s), then, on a new tick thread: retires the dead engine (its
    graphs and pages released, its ``step`` raising), rebuilds it with
    ``clone_fresh`` (a fresh pool, every bucket captured again before it
    serves), and replays every in-flight request with its delivered
    tokens teacher-forced (``ServeEngine.recover``), so no token is sent
    twice.  The watchdog does not judge the rebuild itself: its captures
    are not a tick, and a second rebuild started beside a capture would
    only collide with it.  Submits that arrive meanwhile queue up; ``/healthz`` answers
    ``degraded`` (200) until the rebuilt engine completes its first loop
    pass.  Once ``max_restarts`` deaths fall inside the window (or with
    supervision off, the default), a death is terminal: every stream gets
    ``aborted``, ``crashed`` holds the reason, new work is refused.  A
    real kernel fault that poisons the CUDA context makes ``clone_fresh``
    raise too, and such a death is terminal in-process: only a process
    restart over the request journal resumes those streams.

    With a journal on the engine, the runner's constructor replays the
    unterminated requests a dead process left behind (before any thread
    exists); their streams generate detached until a client resumes them
    by Last-Event-ID.
    """

    def __init__(self, engine: Any, *, request_timeout: float | None = None,
                 idle_poll_s: float = 0.02,
                 metrics_max_samples: int = 100_000,
                 tick_deadline: float | None = None,
                 max_restarts: int = 0,
                 restart_backoff_s: float = 0.5,
                 restart_window_s: float = 300.0) -> None:
        self.engine = engine
        self.faults = getattr(engine, "faults", None)
        # which replica this runner is in a fleet (ReplicaRunner sets it);
        # the request log tags every line with it
        self.replica_index = 0
        self.request_timeout = request_timeout
        self.idle_poll_s = idle_poll_s
        self.tick_deadline = tick_deadline
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.restart_window_s = restart_window_s
        # a server runs for weeks: bound the metrics sample lists
        # (counters stay exact; percentiles become a recent window) and
        # drop the scheduler's terminal ledgers after every tick
        engine.metrics.max_samples = metrics_max_samples
        # the torch state the tick threads run under, which is per
        # thread: the engine's device, the stream current here (where
        # warmup captured the step graphs) and grad mode
        self._device = getattr(engine, "device", torch.device("cpu"))
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        self._grad = torch.is_grad_enabled()
        self._cmds: queue_mod.Queue = queue_mod.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        # rid → (loop, asyncio.Queue); each rid is registered once
        # (submit/attach) and removed once (engine thread, on the
        # terminal event or reject)
        self._live: dict[int, tuple[asyncio.AbstractEventLoop, asyncio.Queue]] = {}
        # set when the tick thread dies terminally: the server turns
        # /healthz unhealthy and rejects new work
        self.crashed: str | None = None
        # one rolling upgrade at a time (the fleet-of-one roll): a second
        # detach would supersede the first rebuild's generation, and its
        # replay snapshot would run nowhere
        self._upgrade_lock = threading.Lock()
        # -- supervision state, guarded by _sup_lock: reentrant, since
        # _exec holds it across engine calls and an abort's terminal
        # event re-enters it through the bridge callbacks
        self._sup_lock = threading.RLock()
        # commands a superseded thread had in hand: drained before the
        # queue by the live thread, in arrival order
        self._handback: deque = deque()
        self._gen = 0  # engine generation; a restart or a terminal crash bumps it
        # lifetime restarts (restarts_total); the budget is the deaths
        # inside restart_window_s
        self.restarts = 0
        self._recent_deaths: list[float] = []
        self.recovering = False
        self.recovery_latency_s: list[float] = []
        # per rebuild: generation, clone seconds, captures, capture
        # seconds and graph-pool bytes (the restart's cost against the
        # JAX package's shared steps)
        self.rebuilds: list[dict] = []
        self._death_t: float | None = None
        self._beat = time.monotonic()
        # the current restart's backoff: the watchdog's grace while
        # recovering, so a rebuilt engine that wedges is still caught
        self._backoff_delay = 0.0
        # the generation whose rebuild (retire + clone_fresh) is running:
        # the watchdog leaves it alone until its first heartbeat
        self._rebuilding: int | None = None
        # rid → everything a restart needs to teacher-force the stream
        # back (prompt, budget, seed, absolute deadline, trace, lineage,
        # tokens and text deltas delivered so far), in FIFO order; also
        # what a Last-Event-ID resume replays
        self._inflight: dict[int, dict] = {}
        # a planned weight swap's (params, version, share_from) for the
        # next rebuild (rolling upgrade); consumed by _rebuild_and_replay
        self._pending_weights: tuple | None = None
        # fleet hook (serve/replica.ReplicaRunner): called from
        # _terminal_crash with the in-flight replay list; returns the rids
        # a live peer adopted (those streams are not abort-flushed)
        self.on_terminal_crash = None
        # terminal output of streams that finished with no client
        # attached (journal-recovered ones above all), kept so a late
        # resume gets its suffix + finish; bounded LRU
        self._resumable: dict[int, dict] = {}
        # delivered terminals, re-readable for a while: a client whose
        # final read tore on the wire can replay the stream; bounded LRU
        self._claimed: dict[int, dict] = {}
        # write-ahead delivery (with a journal): ((loop, queue), event)
        # pairs pushed since the last release; ``_release`` hands them to
        # the journal, whose writer delivers them once every record
        # enqueued before (the tick's watermark above all) is on disk
        self._outbox: list[tuple] = []
        self._outbox_lock = threading.Lock()
        # the durable request journal: replay what a dead process left
        # behind, here, before any thread exists
        self.journal = getattr(engine, "journal", None)
        self.journal_replayed = 0
        # Last-Event-ID attaches served
        self.journal_resumed = 0
        # past every rid the journal saw end (drained ones included)
        self._rid_floor = 0
        if self.journal is not None:
            self._replay_journal()
        # past every replayed rid, parked ones included, so a fresh
        # request never shadows a stream a client is about to resume
        self._rid = itertools.count(max(getattr(engine, "_next_id", 0), self._rid_floor,
                                        max(self._resumable, default=-1) + 1))

    # -- journal replay + stream resume --------------------------------
    def _replay_journal(self) -> None:
        """Teacher-force every unterminated journaled request back into the
        engine: delivered tokens forced, the remaining deadline budget
        resumed (wall time on disk; an expired one is swept on the first
        tick), and the ledger rebuilt so a client can re-attach.  The
        requests the journal saw end are parked for a late resume."""
        now_wall = time.time()
        clock_now = self.engine.clock()
        # streams that ended before the kill: a client may still lack
        # their tail (write-ahead delivery sends it after the ``fin`` is
        # on disk); a drained one lives on in a peer's journal
        for rec in self.journal.replay_finished():
            self._rid_floor = max(self._rid_floor, rec["rid"] + 1)
            if rec["reason"] != "drained":
                self._stash_resumable(rec["rid"], dict(rec, deltas=self._replay_deltas(rec["tokens"])),
                                      rec["reason"], None)
        for rec in self.journal.replay():
            deadline_at = None
            if rec.get("deadline_wall") is not None:
                deadline_at = clock_now + (rec["deadline_wall"] - now_wall)
            self._replay_one(0, dict(rec, deadline_at=deadline_at,
                                     deltas=self._replay_deltas(rec["tokens"])),
                             require_live=False)
            self.journal_replayed += 1

    def _replay_deltas(self, tokens: list) -> list:
        """Per-token text deltas of a journaled token prefix (a fresh
        detokenizer over the same ids yields the deltas the stream sent)."""
        tok = getattr(self.engine, "tokenizer", None)
        if tok is None or not tokens:
            return [None] * len(tokens)
        detok = IncrementalDetok(tok)
        return [detok.push(t) for t in tokens]

    def _replay_one(self, gen: int, rec: dict, *, require_live: bool = True) -> None:
        """Recover one ledger or journal record into ``self.engine``.  With
        ``require_live`` (the supervised restart), a stream whose client
        went away while the engine was down is dropped; a journal replay
        keeps detached requests generating for a later resume."""
        rid = rec["rid"]
        if require_live and rid not in self._live:
            with self._sup_lock:
                if gen == self._gen:
                    self._inflight.pop(rid, None)
            return
        engine = self.engine
        tokens = rec["tokens"]
        stopped = bool(tokens) and tokens[-1] in tuple(engine.stop_tokens)
        if len(tokens) >= rec["max_tokens"] or stopped:
            # generated before the crash; only the finish was lost
            self._finish_replayed(gen, rec, "stop" if stopped else "length")
            return
        lineage = {"replays": int(rec.get("replays", 0)) + 1,
                   "drains": int(rec.get("drains", 0))}
        cb, on_event = self._bridge(gen)
        try:
            req = engine.recover(
                rec["prompt"], rec["max_tokens"], request_id=rid, seed=rec["seed"],
                generated=tokens, callback=cb, on_event=on_event,
                deadline_at=rec.get("deadline_at"), trace_id=rec.get("trace"),
                lineage=lineage, speculative=bool(rec.get("spec", False)),
                tenant=rec.get("tenant", "default"), weights_version=rec.get("wv"),
            )
        except Exception as e:  # noqa: BLE001 — one request's fate, not the replay's
            self._finish_replayed(gen, rec, "aborted")
            print(f"[serve] recovery dropped request {rid}: {e}", file=sys.stderr)
        else:
            # the request now lives on this runner's replica (a drain
            # adoption moved it): the request log tags it here
            req.extra["replica"] = self.replica_index
            with self._sup_lock:
                if gen == self._gen:
                    self._inflight[rid] = dict(
                        rec, tokens=list(tokens), replays=lineage["replays"],
                        deltas=list(rec.get("deltas") or [None] * len(tokens)))

    def _finish_replayed(self, gen: int, rec: dict, reason: str) -> None:
        """Terminal bookkeeping for a replayed request that needs no re-run:
        deliver the lost finish to an attached stream, or park the output
        for a late resume."""
        rid = rec["rid"]
        with self._sup_lock:
            if gen != self._gen:
                return
            self._inflight.pop(rid, None)
        tail = self.engine.finish_recovered(
            rec["prompt"], rec["max_tokens"], request_id=rid, generated=rec["tokens"],
            reason=reason, trace_id=rec.get("trace"),
            lineage={"replays": int(rec.get("replays", 0)) + 1,
                     "drains": int(rec.get("drains", 0))},
            tenant=rec.get("tenant", "default"), weights_version=rec.get("wv"),
        )
        if rid in self._live:
            self._push(rid, ("finish", reason, tail))
            self._live.pop(rid, None)
            self._claim_insert(rid, self._fin_record(rec, reason, tail))
        else:
            self._stash_resumable(rid, rec, reason, tail)

    @staticmethod
    def _fin_record(rec: dict, reason: str, tail: str | None) -> dict:
        """The one parked/claimed terminal record shape (the resume wire
        format)."""
        return {
            "tokens": list(rec["tokens"]),
            "deltas": list(rec.get("deltas") or [None] * len(rec["tokens"])),
            "reason": reason,
            "tail": tail,
            # a late resume's response carries the original trace context
            "trace": rec.get("trace"),
        }

    def _stash_resumable(self, rid: int, rec: dict, reason: str, tail: str | None) -> None:
        """Park a detached stream's terminal output (bounded LRU)."""
        self._resumable[rid] = self._fin_record(rec, reason, tail)
        while len(self._resumable) > 512:
            self._resumable.pop(next(iter(self._resumable)))

    def resume(self, rid: int, last_idx: int,
               loop: asyncio.AbstractEventLoop, aq: asyncio.Queue) -> None:
        """Re-attach a dropped SSE stream: replay delivered tokens from
        index ``last_idx`` (the client's Last-Event-ID), then continue
        live.  The attach runs on the engine thread, between ticks, so
        the replayed suffix and the live continuation cannot race."""
        self._cmds.put(("attach", rid, last_idx, loop, aq))
        if self.crashed:
            # nobody will process the command (a duplicate verdict is
            # harmless: the handler stops at the first)
            aq.put_nowait(("gone", f"engine tick thread crashed: {self.crashed}"))

    # -- event-loop side ----------------------------------------------
    def start(self) -> None:
        self._spawn_thread(self._gen)
        if self.tick_deadline is not None:
            self._watchdog = threading.Thread(target=self._watch, name="serve-engine-watchdog",
                                              daemon=True)
            self._watchdog.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._cmds.put(("wake",))
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout=1.0)
        if self.journal is not None:
            self._release(wait=True)
            # the drain's aborts journaled their terminals: a clean
            # shutdown leaves an empty replay set
            self.journal.close()

    @property
    def inflight(self) -> int:
        """Live bridged requests (accepted, not yet terminal)."""
        return len(self._live)

    @property
    def state(self) -> str:
        """``ok`` | ``degraded`` (restart in progress) | ``crashed``."""
        if self.crashed:
            return "crashed"
        return "degraded" if self.recovering else "ok"

    def serving_engines(self) -> list:
        """Engines whose ActionPolicy verdicts may govern admission: a
        crashed engine's tick thread can never release a shed flag, so
        its frozen verdict must not shed the server forever."""
        return [] if self.crashed else [self.engine]

    def next_rid(self) -> int:
        return next(self._rid)

    def submit(self, rid: int, payload: Any,
               loop: asyncio.AbstractEventLoop, aq: asyncio.Queue) -> None:
        self._live[rid] = (loop, aq)
        self._cmds.put(("submit", rid, payload))
        # crash race: if the tick thread died between the handler's
        # pre-check and this registration, its flush may have run
        # already — nobody will answer the command, so answer it here
        if self.crashed and self._live.pop(rid, None) is not None:
            aq.put_nowait(("error", f"engine tick thread crashed: {self.crashed}"))

    def abort(self, rid: int) -> None:
        self._cmds.put(("abort", rid))

    def abort_all(self) -> None:
        self._cmds.put(("abort_all",))

    # -- planned lifecycle (rolling weight swap) -------------------------
    def detach_inflight(self) -> list[dict]:
        """Supersede the live tick generation and hand back the in-flight
        replay snapshot: the first half of a planned swap (upgrade or
        removal), with the crash path's discipline (the old thread turns
        zombie, its commands handed back).  The snapshot is what peers
        adopt (a drain) or the rebuilt engine replays."""
        with self._sup_lock:
            self._gen += 1
            self.recovering = True
            self._beat = time.monotonic()
            # the rebuild captures every bucket again: the same grace a
            # backoff restart gets
            self._backoff_delay = max(self._backoff_delay, 10.0)
            replay = [dict(rec, tokens=list(rec["tokens"]),
                           deltas=list(rec.get("deltas") or ()))
                      for rec in self._inflight.values()]
            self._inflight.clear()
        self._cmds.put(("wake",))  # unblock an idle superseded thread
        if self.journal is not None:
            self._release(wait=True)  # peers may adopt these streams
        return replay

    def rebuild_upgraded(self, params: Any, version: int, replay: list[dict], *,
                         share_from: Any = None) -> None:
        """Second half of the swap: spawn the new generation's tick thread,
        which waits for the superseded thread to finish its tick, rebuilds
        with ``clone_fresh(params=...)`` (every bucket the old engine had
        captured is captured again before it serves, and those of
        ``share_from``, a peer that already rolled) and replays ``replay``
        teacher-forced.  Caller ran ``detach_inflight`` first."""
        with self._sup_lock:
            if self._stop.is_set():
                raise RuntimeError("runner is stopped")
            self._pending_weights = (params, int(version), share_from)
            new_gen = self._gen
        self._spawn_thread(new_gen, replay=replay, after=self._thread)

    def await_recovered(self, timeout_s: float = 300.0) -> None:
        """Block until the rebuilt engine completes its first loop pass
        (``recovering`` clears): a roll moves on only once this replica
        serves again."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.crashed:
                raise RuntimeError(f"replica crashed during upgrade: {self.crashed}")
            if not self.recovering:
                return
            time.sleep(0.01)
        raise TimeoutError(f"upgrade rebuild did not complete within {timeout_s:g}s")

    def rolling_upgrade(self, params_fn: Any, *, version: int | None = None,
                        timeout_s: float = 300.0) -> dict:
        """The fleet-of-one roll (``POST /admin/upgrade`` on a single-engine
        server): no peer to drain to, so in-flight streams are replayed in
        place on the rebuilt engine, teacher-forced — delivered tokens
        never change; tokens still to come sample from the new weights,
        and the request's version tag records its admission version."""
        from llm_np_cp_tpu_torch.serve.lifecycle import UpgradeAborted, load_upgrade_params

        if not self._upgrade_lock.acquire(blocking=False):
            raise RuntimeError("a rolling upgrade is already in progress")
        try:
            if self.crashed:
                raise RuntimeError(f"cannot upgrade a crashed server: {self.crashed}")
            params = load_upgrade_params(
                params_fn, replica=self.replica_index, faults=self.faults,
                metrics=self.engine.metrics, rolled=[], version=version)
            if version is None:
                version = self.engine.weights_version + 1
            replay = [dict(rec, detached_ok=True) for rec in self.detach_inflight()]
            self.rebuild_upgraded(params, version, replay)
            try:
                self.await_recovered(timeout_s)
            except TimeoutError as e:
                # the same clean abort shape as a checkpoint failure: the
                # admin handler answers 500, the supervisor keeps going
                raise UpgradeAborted(f"replica {self.replica_index} rebuild timed out: {e}",
                                     rolled=[], version=version) from e
            self.engine.metrics.on_lifecycle_action("upgrade_replica")
            return {"rolled": [self.replica_index], "version": version}
        finally:
            self._upgrade_lock.release()

    # -- engine-thread side -------------------------------------------
    def _push(self, rid: int, item: tuple) -> None:
        ent = self._live.get(rid)
        if ent is None:
            return
        if self.journal is not None:
            with self._outbox_lock:
                self._outbox.append((rid, ent, item))
            return
        self._deliver([(rid, ent, item)])

    def _deliver(self, events: list[tuple]) -> None:
        for rid, (loop, aq), item in events:
            try:
                loop.call_soon_threadsafe(aq.put_nowait, item)
            except RuntimeError:
                # loop already closed (shutdown race): nobody is reading
                if self._live.get(rid) == (loop, aq):
                    self._live.pop(rid, None)

    def _release(self, wait: bool = False) -> None:
        """Deliver the outbox once the journal holds what it carries: by
        the journal's writer (``after_durable``), or with ``wait`` here,
        after a flush barrier — before a stream moves to a peer runner,
        whose journal would not order it behind this one's."""
        with self._outbox_lock:
            events, self._outbox = self._outbox, []
        if not events:
            return
        if wait:
            self.journal.flush(timeout=10.0)
            self._deliver(events)
        else:
            self.journal.after_durable(lambda: self._deliver(events))

    def _bridge(self, gen: int) -> tuple:
        """Per-request engine callbacks for generation ``gen``.  The gen
        guard (under the supervision lock, so it is atomic with a
        restart's replay snapshot) makes a superseded engine mute: a hung
        thread that wakes cannot append to the ledger or push tokens at a
        stream the rebuilt engine now owns."""

        def cb(req: Any, tok: int, delta: str | None) -> None:
            with self._sup_lock:
                if gen != self._gen:
                    return
                rec = self._inflight.get(req.req_id)
                if rec is not None:
                    rec["tokens"].append(int(tok))
                    rec["deltas"].append(delta)
            self._push(req.req_id, ("token", int(tok), delta))

        def on_event(req: Any, event: str) -> None:
            if event not in TERMINAL_EVENTS:
                return
            with self._sup_lock:
                if gen != self._gen:
                    return
                rec = self._inflight.pop(req.req_id, None)
            tail = req.extra.pop("final_text_delta", None)
            if req.req_id not in self._live:
                # detached terminal: park the output for a late resume
                if rec is not None:
                    self._stash_resumable(req.req_id, rec, event, tail)
                return
            self._push(req.req_id, ("finish", event, tail))
            self._live.pop(req.req_id, None)
            if rec is not None:
                self._claim_insert(req.req_id, self._fin_record(rec, event, tail))

        return cb, on_event

    def _claim_insert(self, rid: int, fin: dict) -> None:
        """Park a terminal's full output in the claimed LRU (bounded, most
        recent last)."""
        self._claimed.pop(rid, None)
        self._claimed[rid] = fin
        while len(self._claimed) > 64:
            self._claimed.pop(next(iter(self._claimed)))

    def _next_handback(self, gen: int) -> tuple | None:
        """Pop the next handed-back command, for the live generation only."""
        with self._sup_lock:
            if gen == self._gen and self._handback:
                return self._handback.popleft()
        return None

    def _exec(self, cmd: tuple, gen: int) -> bool:
        """Execute one command for generation ``gen``.  The gen check and
        the engine call are atomic under the supervision lock; a thread
        superseded in between hands the command to the live generation
        (order kept) and returns False."""
        with self._sup_lock:
            if gen != self._gen:
                self._handback.append(cmd)
                return False
            self._exec_inner(cmd, gen)
        return True

    def _exec_inner(self, cmd: tuple, gen: int) -> None:
        kind = cmd[0]
        if kind == "submit":
            _, rid, payload = cmd
            deadline = payload.timeout_s
            if self.request_timeout is not None:
                deadline = min(deadline or self.request_timeout, self.request_timeout)
            cb, on_event = self._bridge(gen)
            try:
                req = self.engine.submit(
                    payload.prompt_ids, payload.max_tokens,
                    request_id=rid, seed=payload.seed, callback=cb,
                    on_event=on_event, deadline_s=deadline,
                    trace_id=payload.trace_id,
                    speculative=payload.speculative,
                    tenant=payload.tenant,
                )
            except TenantThrottled as e:
                # the 429 + Retry-After of a full queue, naming the cap
                self._push(rid, ("rejected", 1, str(e)))
                self._live.pop(rid, None)
            except QueueFull:
                self._push(rid, ("rejected", 1))
                self._live.pop(rid, None)
            except ValueError as e:
                self._push(rid, ("error", str(e)))
                self._live.pop(rid, None)
            else:
                # route verdict and replica tag for the request log (the
                # fleet's router filled payload.route_spilled)
                req.extra["replica"] = self.replica_index
                if getattr(payload, "route_spilled", False):
                    req.extra["spilled"] = True
                self._inflight[rid] = {
                    "rid": rid,
                    "prompt": payload.prompt_ids,
                    "max_tokens": payload.max_tokens,
                    "seed": payload.seed,
                    # the absolute deadline on the engine clock, which
                    # clone_fresh shares: a restart resumes the remaining
                    # budget instead of granting a fresh window
                    "deadline_at": req.deadline,
                    "trace": req.extra.get("trace"),
                    "replays": 0,
                    "drains": 0,
                    "spec": bool(payload.speculative),
                    "wv": int(req.extra.get("weights_version", 0)),
                    "tenant": payload.tenant,
                    "tokens": [],
                    # parallel text deltas: a resume replays the exact
                    # text the stream carried
                    "deltas": [],
                }
                self._push(rid, ("accepted",))
        elif kind == "attach":
            self._exec_attach(cmd)
        elif kind == "recover":
            # a peer replica's drained stream (fleet adoption): the same
            # teacher-forced move as a restart replay
            self._replay_one(gen, cmd[1], require_live=False)
        elif kind == "abort":
            self.engine.abort(cmd[1])
        elif kind == "abort_all":
            for rid in list(self._live):
                self.engine.abort(rid)

    def _exec_attach(self, cmd: tuple) -> None:
        """Attach a resuming client to a live or finished stream.  Event
        ids are delivered-token indices: the client's Last-Event-ID is
        the count it has, so the replay starts there."""
        _, rid, last_idx, loop, aq = cmd
        rec = self._inflight.get(rid)
        fin = None
        if rec is None:
            fin = self._resumable.get(rid)
            if fin is None:
                fin = self._claimed.get(rid)
        src = rec if rec is not None else fin
        verdict = None
        if src is not None and rid in self._live:
            # a duplicate resume (or a guessed id) must not rebind the
            # live bridge entry and strand the attached client
            verdict = ("gone", f"request {rid} already has an attached stream")
        elif src is None:
            verdict = ("gone", f"unknown or expired request id {rid}")
        elif last_idx > len(src["tokens"]):
            if rec is not None:
                verdict = ("busy",
                           f"request {rid} has regenerated {len(src['tokens'])} of the "
                           f"{last_idx} tokens the client holds; retry shortly")
            else:
                verdict = ("gone",
                           f"Last-Event-ID {last_idx} is past the {len(src['tokens'])} "
                           f"tokens delivered for request {rid}")
        if verdict is not None:
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(aq.put_nowait, verdict)
            return
        self._live[rid] = (loop, aq)
        self.journal_resumed += 1
        # the verdict carries the original trace id: the resumed response
        # emits the same traceparent the first one did
        self._push(rid, ("accepted", src.get("trace")))
        for tok, delta in zip(src["tokens"][last_idx:], src["deltas"][last_idx:]):
            self._push(rid, ("token", tok, delta))
        if fin is not None:
            # finished while detached: suffix + finish; the claim moves
            # it to the claimed LRU, re-readable until evicted
            self._resumable.pop(rid, None)
            self._claim_insert(rid, fin)
            self._push(rid, ("finish", fin["reason"], fin["tail"]))
            self._live.pop(rid, None)

    # -- the tick threads -----------------------------------------------
    def _torch_context(self) -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(torch.set_grad_enabled(self._grad))
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self._device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _spawn_thread(self, gen: int, *, delay: float = 0.0,
                      replay: list[dict] | None = None,
                      after: threading.Thread | None = None) -> None:
        self._thread = threading.Thread(target=self._run, args=(gen, delay, replay, after),
                                        name=f"serve-engine-tick-{gen}", daemon=True)
        self._thread.start()

    def _run(self, gen: int, delay: float = 0.0, replay: list[dict] | None = None,
             after: threading.Thread | None = None) -> None:
        """One generation's tick thread: the backoff, then (after a death
        or a planned swap) the rebuild and replay, then the loop — all on
        the engine's device and stream.  A planned swap first waits for
        the superseded thread (``after``) to finish its tick, so the
        rebuild never retires an engine in the middle of one."""
        try:
            if after is not None and after is not threading.current_thread():
                after.join(timeout=60.0)
            if delay:
                time.sleep(delay)
            if self._stop.is_set():
                return
            if gen == self._gen:
                self._beat = time.monotonic()  # the backoff slept the clock off
            with self._torch_context():
                if replay is not None:
                    self._rebuild_and_replay(gen, replay)
                self._loop(gen)
        except BaseException as e:  # noqa: BLE001 — the supervisor's boundary
            traceback.print_exc()
            self._on_engine_death(f"{type(e).__name__}: {e}", gen)

    def _loop(self, gen: int) -> None:
        engine = self.engine
        faults = self.faults
        while not self._stop.is_set() and gen == self._gen:
            cmd = self._next_handback(gen)
            if cmd is None:
                try:
                    block = not engine.scheduler.has_work
                    cmd = self._cmds.get(block=block, timeout=self.idle_poll_s if block else None)
                except queue_mod.Empty:
                    cmd = None
            while cmd is not None:
                if cmd[0] != "wake" and not self._exec(cmd, gen):
                    return  # superseded; _exec handed the command back
                cmd = self._next_handback(gen)
                if cmd is None:
                    try:
                        cmd = self._cmds.get_nowait()
                    except queue_mod.Empty:
                        cmd = None
            self._release()
            if self._stop.is_set() or gen != self._gen:
                break
            if engine.scheduler.has_work:
                if faults is not None:
                    hang = faults.trip("tick_hang")
                    if hang is not None:
                        time.sleep(hang)
                        if gen != self._gen:
                            return  # the watchdog superseded this thread
                    if faults.trip("tick_crash") is not None:
                        raise FaultInjected("tick_crash")
                    if faults.trip("proc_kill") is not None:
                        # the kill -9 site: no drain, no flush, no atexit —
                        # what the journal's restart/resume must survive
                        print("[chaos] proc_kill: SIGKILL self", file=sys.stderr, flush=True)
                        os.kill(os.getpid(), signal.SIGKILL)
                engine.step()
                # the tick's tokens go out behind its watermark record
                self._release()
                # terminal requests delivered their events through the
                # bridge: dropping them keeps a long-running server flat
                engine.scheduler.finished.clear()
                engine.scheduler.aborted.clear()
            elif engine.actions is not None:
                # an idle server must still release its auto-actions:
                # shed_load 503s the fresh work whose ticks would release
                # it, so an idle pass feeds the policy a clean tick
                engine._actions_tick([])
            # tick heartbeat: idle passes beat every idle_poll_s, so only
            # a stuck tick starves it (a superseded thread must not
            # freshen the heartbeat the live generation is judged by)
            if gen == self._gen:
                self._beat = time.monotonic()
            if self.recovering:
                with self._sup_lock:
                    if gen == self._gen and self.recovering:
                        self.recovering = False
                        if self._death_t is not None:
                            self.recovery_latency_s.append(time.monotonic() - self._death_t)
                            self._death_t = None

    def _rebuild_and_replay(self, gen: int, replay: list[dict]) -> None:
        """The restart, on the new tick thread: (a) retire the dead engine —
        its graphs and pages are released, and its ``step`` raises, so a
        zombie thread can never replay a graph into memory the rebuilt
        engine now owns; (b) ``clone_fresh`` allocates the fresh pool into
        that memory and (c) captures every bucket before the replay, so no
        capture lands inside a serving tick; then every in-flight request
        is resubmitted with its delivered tokens teacher-forced.  A
        planned weight swap (``rebuild_upgraded``) rides the same path
        with the new params and version, and captures the buckets of the
        peer it names too."""
        old = self.engine
        tr = old.tracer
        t_restart = tr.now_us() if tr is not None else 0.0
        t0 = time.perf_counter()
        with self._sup_lock:
            self._rebuilding = gen
            pend = self._pending_weights
        try:
            old.retire(f"superseded by restart generation {gen}")
            if pend is not None:
                new_params, new_version, share_from = pend
                engine = old.clone_fresh(params=new_params, weights_version=new_version)
                if share_from is not None:
                    engine.share_compiled_steps(share_from)
            else:
                engine = old.clone_fresh()
        finally:
            with self._sup_lock:
                if gen == self._gen:
                    self._beat = time.monotonic()  # the captures were progress, not a hang
                if self._rebuilding == gen:
                    self._rebuilding = None
        steps = engine.graph_steps()
        self.rebuilds.append(dict(
            gen=gen, rebuild_s=time.perf_counter() - t0, captures=len(steps),
            capture_s=sum(st.capture_s or 0.0 for st in steps),
            pool_bytes=sum(st.pool_bytes or 0 for st in steps)))
        # mute the zombie: the clone shares the real metrics, journal,
        # request log, host tier, tracer, sentinel and tenant ledger, and a
        # superseded thread finishing a slow tick must not write into them
        # (engine internals have no generation guard; only the bridge
        # does): no stale span in the rebuilt engine's timeline, no sample
        # in its sentinel's baselines, no tenant billed twice
        old.metrics = ServeMetrics(clock=old.clock)
        old.journal = None
        old.request_log = None
        old.host_tier = None
        old.tracer = None
        old.sentinel = None
        old.tenants = None
        old.actions = None
        with self._sup_lock:
            if gen != self._gen:
                # superseded during the rebuild: the newer generation
                # rebuilds from the retired engine itself
                engine.retire("superseded during its rebuild")
                return
            self.engine = engine
            if pend is not None and self._pending_weights is pend:
                self._pending_weights = None
        for rec in replay:
            if gen != self._gen:
                return  # superseded mid-replay: the newer thread redoes it
            # an upgrade's leftover streams keep generating detached (a
            # journal-recovered client may attach later); a crash
            # restart's streams must have a live client
            self._replay_one(gen, rec, require_live=not rec.pop("detached_ok", False))
            if gen == self._gen:
                self._beat = time.monotonic()
        if tr is not None:
            tr.complete("restart", t_restart, cat="supervisor",
                        args={"gen": gen, "replayed": len(replay)})

    def _on_engine_death(self, reason: str, gen: int) -> None:
        """Crash or hang (from the dying thread or the watchdog): schedule a
        supervised restart, or go terminally dark."""
        now = time.monotonic()
        with self._sup_lock:
            if gen != self._gen:
                return  # a superseded thread died late: already handled
            # the budget is restart intensity: only deaths inside the
            # window count, and the backoff exponent follows them
            self._recent_deaths = [t for t in self._recent_deaths
                                   if now - t < self.restart_window_s]
            if self._stop.is_set() or len(self._recent_deaths) >= self.max_restarts:
                self._terminal_crash(reason)
                return
            self._recent_deaths.append(now)
            self.restarts += 1
            self._gen += 1
            self.recovering = True
            if self._death_t is None:
                self._death_t = now
            delay = min(self.restart_backoff_s * (2 ** (len(self._recent_deaths) - 1)), 10.0)
            self._backoff_delay = delay
            self._beat = time.monotonic()  # the restart's clock starts now
            replay = [dict(rec, tokens=list(rec["tokens"]), deltas=list(rec["deltas"]))
                      for rec in self._inflight.values()]
            new_gen = self._gen
        tr = self.engine.tracer
        if tr is not None:
            tr.instant("engine-death", cat="supervisor",
                       args={"reason": reason, "gen": gen, "restart": new_gen})
        print(f"[serve] engine death ({reason}); supervised restart, {len(replay)} in flight "
              f"to replay, {len(self._recent_deaths)}/{self.max_restarts} deaths in window, "
              f"backoff {delay:.2f}s", file=sys.stderr)
        self._spawn_thread(new_gen, delay=delay, replay=replay)

    def _terminal_crash(self, reason: str) -> None:
        """The backstop (caller holds ``_sup_lock``): every in-flight
        stream gets a terminal event, /healthz turns unhealthy, and new
        submits are refused.  The generation moves on, so a hung thread
        that wakes stops instead of ticking for flushed streams."""
        self.crashed = reason
        tr = self.engine.tracer
        if tr is not None:
            tr.instant("engine-terminal-crash", cat="supervisor", args={"reason": reason})
        self._gen += 1
        self.recovering = False
        # fleet drain (serve/replica.ReplicaRunner): a live peer can adopt
        # this runner's unterminated streams; their clients see a pause,
        # then the peer's teacher-forced continuation, not an abort
        adopted: set[int] = set()
        hook = self.on_terminal_crash
        if self.journal is not None:
            self._release(wait=True)  # peers may adopt these streams
        if hook is not None and self._inflight:
            adopted = hook([dict(rec, tokens=list(rec["tokens"]),
                                 deltas=list(rec.get("deltas") or ()))
                            for rec in self._inflight.values()])
        for rid in list(self._live):
            if rid in adopted:
                continue  # a peer now owns this stream's bridge entry
            self._push(rid, ("finish", "aborted", None))
            self._live.pop(rid, None)
        # the flush is these requests' terminal: journal it (the writer
        # outlives the tick thread), or the next process would replay
        # streams whose clients already saw "aborted"
        if self.journal is not None:
            for rid in self._inflight:
                if rid not in adopted:
                    self.journal.terminal(rid, "aborted")
            self._release()
        self._inflight.clear()

    def _watch(self) -> None:
        """Watchdog: declare the engine hung when the tick heartbeat goes
        stale past ``tick_deadline``.  While a restart is in progress the
        budget stretches by that restart's backoff, so a rebuilt engine
        that wedges is still caught; the rebuild itself (its captures) is
        not judged, and its end restarts the clock."""
        assert self.tick_deadline is not None
        interval = max(self.tick_deadline / 4.0, 0.01)
        while not self._stop.is_set() and not self.crashed:
            time.sleep(interval)
            with self._sup_lock:
                gen, beat = self._gen, self._beat
                grace = self._backoff_delay if self.recovering else 0.0
                if self._rebuilding == gen:
                    continue
            stale = time.monotonic() - beat
            if stale > self.tick_deadline + grace:
                self._on_engine_death(
                    f"engine tick hung ({stale:.2f}s > tick-deadline {self.tick_deadline:g}s "
                    f"+ {grace:g}s restart grace)", gen)


class HttpServer:
    """The asyncio front: routing, SSE streaming, drain shutdown."""

    def __init__(
        self,
        engine: Any,
        *,
        model_id: str,
        tokenizer: Any = None,
        request_timeout: float | None = None,
        drain_timeout: float = 30.0,
        default_max_tokens: int = 16,
        max_tokens_cap: int | None = None,
        tick_deadline: float | None = None,
        max_restarts: int = 0,
        restart_backoff_s: float = 0.5,
        restart_window_s: float = 300.0,
        runner: Any = None,
        upgrade_loader: Any = None,
    ) -> None:
        self.engine = engine
        self.model_id = model_id
        # rolling weight swaps (POST /admin/upgrade): the loader maps the
        # request body to fresh params; None = the endpoint 404s with a
        # hint.  One admin mutation at a time: a roll and a scale racing
        # would drain the same peers out from under each other
        self.upgrade_loader = upgrade_loader
        self._admin_lock = threading.Lock()
        self.tokenizer = tokenizer if tokenizer is not None \
            else getattr(engine, "tokenizer", None)
        self.drain_timeout = drain_timeout
        self.default_max_tokens = default_max_tokens
        self.max_tokens_cap = max_tokens_cap
        # ``runner`` injects a prebuilt fleet (serve/replica.ReplicaRunner:
        # N supervised replicas behind prefix-affinity routing); the
        # default is the single-engine runner
        self.runner = runner if runner is not None else EngineRunner(
            engine, request_timeout=request_timeout,
            tick_deadline=tick_deadline, max_restarts=max_restarts,
            restart_backoff_s=restart_backoff_s, restart_window_s=restart_window_s,
        )
        self.draining = False
        self.host: str | None = None
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._done: asyncio.Event | None = None
        self._drain_task: asyncio.Task | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._signals: list[int] = []

    # ------------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._loop = asyncio.get_running_loop()
        self._done = asyncio.Event()
        self.runner.start()
        self._server = await asyncio.start_server(self._on_conn, host, port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._loop.add_signal_handler(sig, self.begin_drain)
                self._signals.append(sig)
            except (NotImplementedError, RuntimeError, ValueError):
                # not the main thread (a test or chip_smoke.py runs the
                # server in a worker) or an embedded loop: drain stays
                # reachable through begin_drain
                break

    def begin_drain(self) -> None:
        """Idempotent shutdown trigger — the SIGTERM handler and the
        test hook both land here."""
        if self._drain_task is None and self._loop is not None:
            self._drain_task = self._loop.create_task(self._drain())

    async def _drain(self) -> None:
        self.draining = True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.drain_timeout
        while self.runner.inflight and loop.time() < deadline:
            await asyncio.sleep(0.02)
        if self.runner.inflight:
            self.runner.abort_all()
            grace = loop.time() + 5.0
            while self.runner.inflight and loop.time() < grace:
                await asyncio.sleep(0.02)
        # every stream got its terminal event; give the handlers a
        # bounded window to flush their last bytes before the socket
        # closes
        flush_deadline = loop.time() + 5.0
        while self._conn_tasks and loop.time() < flush_deadline:
            await asyncio.sleep(0.02)
        assert self._server is not None
        self._server.close()
        await self._server.wait_closed()
        for sig in self._signals:
            with contextlib.suppress(Exception):
                self._loop.remove_signal_handler(sig)  # type: ignore[union-attr]
        self.runner.stop()
        assert self._done is not None
        self._done.set()

    async def serve_until_shutdown(self) -> None:
        assert self._done is not None, "call start() first"
        await self._done.wait()

    # ------------------------------------------------------------------
    @property
    def tracer(self) -> Any:
        """The live engine's trace recorder, or None (the recorder is
        shared across supervised restarts; the runner's engine changes)."""
        return self.runner.engine.tracer

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        # a request's http span starts at socket accept: reading and
        # parsing are part of what the client waits for.  -1 when the
        # tracer appears only after accept (a restart's mute window)
        tracer = self.tracer
        t_accept = tracer.now_us() if tracer is not None else -1.0
        try:
            await self._handle(reader, writer, t_accept)
        except (ConnectionResetError, BrokenPipeError, asyncio.TimeoutError):
            pass
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, t_accept: float = -1.0) -> None:
        try:
            method, path, headers, body = await asyncio.wait_for(
                self._read_request(reader), timeout=30.0)
        except HTTPError as e:
            await self._respond_error(writer, e)
            return
        except (asyncio.IncompleteReadError, ValueError, asyncio.TimeoutError):
            return  # torn/oversized request line — nothing to answer
        if method == "GET" and path == "/healthz":
            crashed = self.runner.crashed
            # degraded (a supervised restart in progress) stays 200: the
            # server still accepts and queues work, so a load balancer
            # must not eject it mid-recovery
            status = 503 if (self.draining or crashed) else 200
            state = ("crashed" if crashed
                     else "draining" if self.draining
                     else self.runner.state)
            payload = {
                "status": state, "model": self.model_id,
                "restarts": self.runner.restarts,
                "weights_version": self.runner.engine.weights_version,
            }
            replica_states = getattr(self.runner, "replica_states", None)
            if replica_states is not None:
                payload["replicas"] = replica_states()
            if crashed:
                payload["error"] = crashed
            await self._respond(writer, status, json.dumps(payload).encode())
        elif method == "GET" and path == "/metrics":
            await self._respond(
                writer, 200, self._render_metrics().encode(),
                content_type="text/plain; version=0.0.4; charset=utf-8")
        elif method == "GET" and path == "/debug/slo":
            await self._respond_slo(writer)
        elif method == "GET" and path == "/debug/tenants":
            await self._respond_tenants(writer)
        elif method == "GET" and path == "/debug/trace":
            tracer = self.tracer
            if tracer is None:
                await self._respond_error(writer, HTTPError(
                    404, "tracing is off; start the server with "
                    "--trace-ring N (and/or --trace-out PATH)"))
            else:
                # copied under the recorder's lock, serialized off the
                # event loop: a full ring is many thousands of dicts, and
                # dumping them inline would stall every live stream
                body = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: json.dumps(tracer.to_dict()).encode())
                await self._respond(writer, 200, body)
        elif path == "/admin/upgrade":
            if method != "POST":
                await self._respond_error(writer, HTTPError(405, "use POST for /admin/upgrade"))
            else:
                await self._admin_upgrade(writer, body)
        elif path == "/admin/scale":
            if method != "POST":
                await self._respond_error(writer, HTTPError(405, "use POST for /admin/scale"))
            else:
                await self._admin_scale(writer, body)
        elif path == "/v1/completions":
            if method != "POST":
                await self._respond_error(writer, HTTPError(405, "use POST for /v1/completions"))
            else:
                await self._completions(reader, writer, body, headers, t_accept)
        elif path.startswith("/v1/completions/"):
            # stream resume by id: GET /v1/completions/cmpl-N with a
            # Last-Event-ID header replays the suffix and continues live
            if method != "GET":
                await self._respond_error(writer, HTTPError(
                    405, "use GET to resume a completion stream"))
                return
            try:
                rid = parse_completion_rid(path.rsplit("/", 1)[1])
                last_idx = parse_last_event_id(headers.get("last-event-id"))
            except HTTPError as e:
                await self._respond_error(writer, e)
                return
            await self._resume(reader, writer, rid, last_idx, self.model_id, t_accept)
        else:
            await self._respond_error(writer, HTTPError(404, f"no route for {method} {path}"))

    async def _read_request(
        self, reader: asyncio.StreamReader,
    ) -> tuple[str, str, dict[str, str], bytes]:
        line = await reader.readline()
        if not line:
            raise asyncio.IncompleteReadError(b"", None)
        parts = line.decode("latin-1").split()
        if len(parts) != 3:
            raise HTTPError(400, "malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers: dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            key, _, value = hline.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError as e:
            raise HTTPError(400, "bad Content-Length") from e
        if n > MAX_BODY_BYTES:
            raise HTTPError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    def _render_metrics(self) -> str:
        """The JAX server's scrape: the metrics' exposition plus its live
        gauges, in its order (a fleet renders its replicas' series with a
        ``replica`` label, ``ReplicaRunner.render_metrics``).  Host reads
        only (the pool's counts and the pages' shapes): no CUDA call from
        the event loop.  The runner's engine, not ``self.engine``: a
        supervised restart rebinds it."""
        runner = self.runner
        engine = runner.engine
        journal_gauges = {
            "journal_replayed_total": float(runner.journal_replayed),
            "journal_resumed_total": float(runner.journal_resumed),
        }
        # OTLP span export (serve/otel.py): shipped and dropped counters,
        # so a silent collector outage shows on the scrape
        otel = engine.tracer.otel if engine.tracer is not None else None
        if otel is not None:
            ostats = otel.stats()
            journal_gauges.update({
                "otlp_spans_exported_total": float(ostats["spans"]),
                "otlp_spans_dropped_total": float(ostats["dropped"]),
                "otlp_export_errors_total": float(ostats["export_errors"]),
            })
        journal = getattr(runner, "journal", None)
        if journal is not None:
            jstats = journal.stats()
            journal_gauges.update({
                "journal_records_total": float(jstats["records"]),
                "journal_fsync_p99_s": jstats["fsync_p99_s"],
                "journal_write_errors_total": float(
                    jstats["write_errors"] + jstats["fsync_errors"]),
                "journal_epoch": float(jstats["epoch"]),
            })
        render = getattr(runner, "render_metrics", None)
        if render is not None:
            return render(extra_gauges={"draining": 1.0 if self.draining else 0.0,
                                        **journal_gauges})
        stats = engine.pool.stats()
        wv = engine.weights_version
        faults = runner.faults
        recov = runner.recovery_latency_s
        text = engine.metrics.prometheus(
            # the version label appears once an upgrade rolled (wv > 0)
            const_labels={"version": str(wv)} if wv else None,
            extra_gauges={
                "weights_version": float(wv),
                "pool_blocks_free": stats["free"],
                "pool_blocks_request_held": stats["request_held"],
                "pool_blocks_cache_only": stats["cache_only"],
                "pool_kv_bytes_shard": stats["kv_bytes_shard"],
                "pool_kv_shards": stats["kv_shards"],
                "inflight_streams": runner.inflight,
                "queue_depth_live": engine.scheduler.queue_depth,
                "draining": 1.0 if self.draining else 0.0,
                # supervision: what recovery reads off the scrape
                "restarts_total": runner.restarts,
                "faults_injected_total": faults.injected_total if faults is not None else 0.0,
                "degraded": 1.0 if runner.state == "degraded" else 0.0,
                "recovery_latency_s_last": recov[-1] if recov else 0.0,
                "decode_impl_degraded": 1.0 if engine.decode_degraded else 0.0,
                **journal_gauges,
            })
        if engine.tenants is not None:
            # the tenant series, their label cardinality bounded by the
            # ledger's top-max_series roll-up
            text += engine.tenants.prometheus(const_labels={"version": str(wv)} if wv else None)
        return text

    async def _respond_slo(self, writer: asyncio.StreamWriter) -> None:
        """``GET /debug/slo``: the SLO accounting as one JSON, summed across
        a fleet's replicas with a per-replica breakdown; 404 and a hint
        when no tracker is attached."""
        replicas = getattr(self.runner, "replicas", None)
        runners = replicas if replicas is not None else [self.runner]
        trackers = [r.engine.metrics.slo for r in runners]
        if not any(t is not None for t in trackers):
            await self._respond_error(writer, HTTPError(
                404, "SLO accounting is off; start the server with --slo-ttft/--slo-tpot"))
            return
        body = aggregate_slo(trackers)
        if replicas is not None:
            body["replicas"] = [t.snapshot() if t is not None else None for t in trackers]
        await self._respond(writer, 200, json.dumps(body).encode())

    async def _respond_tenants(self, writer: asyncio.StreamWriter) -> None:
        """``GET /debug/tenants``: the per-tenant accounting as one JSON,
        summed across a fleet's replicas with a per-replica breakdown;
        404 and a hint when no ledger is attached."""
        replicas = getattr(self.runner, "replicas", None)
        runners = replicas if replicas is not None else [self.runner]
        ledgers = [r.engine.tenants for r in runners]
        if not any(t is not None for t in ledgers):
            await self._respond_error(writer, HTTPError(
                404, "tenant accounting is off; start the server with --tenants"))
            return
        body = aggregate_tenants(ledgers)
        if replicas is not None:
            body["replicas"] = [t.snapshot() if t is not None else None for t in ledgers]
        await self._respond(writer, 200, json.dumps(body).encode())

    # -- fleet lifecycle admin (serve/lifecycle.py) ----------------------
    async def _admin_upgrade(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        """``POST /admin/upgrade``: roll the fleet onto fresh weights, one
        replica at a time, no stream dropped.  Body (optional JSON):
        ``{"model": <what the loader reads>, "version": N}``.  Answers
        after the roll with ``{"rolled": [...], "version"}``; 409 while
        another admin operation runs, 500 with the rolled prefix when the
        roll aborted (the fleet keeps serving, mixed-version)."""
        from llm_np_cp_tpu_torch.serve.lifecycle import UpgradeAborted

        if self.upgrade_loader is None:
            await self._respond_error(writer, HTTPError(
                404, "no upgrade loader configured; the serve CLI "
                "wires one (POST /admin/upgrade)"))
            return
        try:
            data = json.loads(body) if body else {}
            if not isinstance(data, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            await self._respond_error(writer, HTTPError(400, f"bad JSON body: {e}"))
            return
        version = data.get("version")
        if version is not None and (not isinstance(version, int) or isinstance(version, bool)
                                    or version < 1):
            await self._respond_error(writer, HTTPError(
                400, f"version must be a positive integer, got {version!r}"))
            return
        if not self._admin_lock.acquire(blocking=False):
            await self._respond_error(writer, HTTPError(
                409, "an admin operation is already in progress"))
            return
        loader = self.upgrade_loader
        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(
                None, lambda: self.runner.rolling_upgrade(lambda: loader(data), version=version))
        except UpgradeAborted as e:
            await self._respond(writer, 500, json.dumps({
                "error": str(e), "rolled": e.rolled}).encode())
            return
        except RuntimeError as e:
            # only a concurrent roll is a conflict; a crashed or stopped
            # runner or an empty fleet is unavailability (a 409 would invite
            # retries against a fleet that can never finish a roll)
            status = 409 if "in progress" in str(e) else 503
            await self._respond_error(writer, HTTPError(status, str(e)))
            return
        finally:
            self._admin_lock.release()
        await self._respond(writer, 200, json.dumps(result).encode())

    async def _admin_scale(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        """``POST /admin/scale`` ``{"replicas": N}``: elastic data
        parallelism for a fleet — grow with warmed share-nothing clones,
        shrink with drain-to-peer removals."""
        if getattr(self.runner, "add_replica", None) is None:
            await self._respond_error(writer, HTTPError(
                400, "single-engine server cannot scale; start with --replicas N"))
            return
        try:
            data = json.loads(body) if body else {}
            n = data["replicas"]
            if not isinstance(n, int) or isinstance(n, bool) or not (1 <= n <= 64):
                raise ValueError(f"replicas must be in [1, 64], got {n!r}")
        except (KeyError, TypeError, ValueError) as e:
            await self._respond_error(writer, HTTPError(
                400, f'bad body (want {{"replicas": N}}): {e}'))
            return
        if not self._admin_lock.acquire(blocking=False):
            await self._respond_error(writer, HTTPError(
                409, "an admin operation is already in progress"))
            return

        def apply() -> tuple[list[int], list[int]]:
            added: list[int] = []
            removed: list[int] = []
            while self.runner.active_replicas() < n:
                added.append(self.runner.add_replica())
            while self.runner.active_replicas() > n:
                removed.append(self.runner.remove_replica())
            return added, removed

        loop = asyncio.get_running_loop()
        try:
            added, removed = await loop.run_in_executor(None, apply)
        except RuntimeError as e:
            await self._respond_error(writer, HTTPError(400, str(e)))
            return
        finally:
            self._admin_lock.release()
        await self._respond(writer, 200, json.dumps({
            "replicas": self.runner.active_replicas(),
            "added": added, "removed": removed,
            "states": self.runner.replica_states(),
        }).encode())

    def _shed_retry_after(self) -> float | None:
        """503-first load shedding: the largest Retry-After across serving
        replicas whose ActionPolicy sheds, or None while admission is
        open.  Only serving replicas vote (``serving_engines``): a removed
        or crashed replica can never release its flag.  The reads race
        the tick threads by design: one request admitted a tick early or
        late is noise."""
        worst = None
        for engine in self.runner.serving_engines():
            acts = engine.actions
            if acts is not None and acts.shedding:
                ra = acts.retry_after()
                worst = ra if worst is None else max(worst, ra)
        return worst

    # ------------------------------------------------------------------
    async def _completions(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           body: bytes, headers: dict[str, str],
                           t_accept: float = -1.0) -> None:
        if self.draining or self.runner.crashed:
            msg = ("engine tick thread crashed: " + self.runner.crashed
                   if self.runner.crashed
                   else "server is draining for shutdown")
            await self._respond_error(writer, HTTPError(
                503, msg, etype="server_error", headers=(("Retry-After", "1"),)))
            return
        faults = self.runner.faults
        if faults is not None:
            retry_after = faults.trip("http_429")
            if retry_after is not None:
                # an injected transient reject: client retry and backoff
                # without saturating the queue
                await self._respond_error(writer, HTTPError(
                    429, "chaos: injected transient reject", etype="rate_limit_error",
                    headers=(("Retry-After", f"{max(retry_after, 0):g}"),)))
                return
        try:
            resume = parse_resume_request(body, headers, model_id=self.model_id)
            if resume is not None:
                # re-POST with the original request id: the resume
                # protocol's POST spelling
                rid, last_idx, echo_model = resume
                await self._resume(reader, writer, rid, last_idx, echo_model, t_accept)
                return
            # 503-first load shedding (serve/lifecycle.ActionPolicy): while
            # the SLO error budget burns past threshold, fresh admissions
            # shed at the door with a burn-scaled Retry-After (resumes,
            # above, attach to work already done and always pass)
            shed = self._shed_retry_after()
            if shed is not None:
                await self._respond_error(writer, HTTPError(
                    503, "load shedding: SLO error budget is burning past threshold; "
                    "retry later", etype="server_error",
                    headers=(("Retry-After", f"{shed:g}"),)))
                return
            payload = parse_completion_request(
                body, model_id=self.model_id, tokenizer=self.tokenizer,
                default_max_tokens=self.default_max_tokens,
                max_tokens_cap=self.max_tokens_cap,
                header_tenant=headers.get("x-tenant-id"),
            )
        except HTTPError as e:
            await self._respond_error(writer, e)
            return
        # W3C trace context: continue the caller's trace or start one (a
        # malformed header means a fresh trace, never a 400)
        ctx = parse_traceparent(headers.get("traceparent"))
        payload.trace_id = ctx[0] if ctx is not None else gen_trace_id()

        loop = asyncio.get_running_loop()
        aq: asyncio.Queue = asyncio.Queue()
        rid = self.runner.next_rid()
        tracer = self.tracer
        if tracer is not None:
            # the http bracket: accept → response done, around the
            # engine's spans on the same track
            tracer.async_begin(rid, "http", ts_us=t_accept if t_accept >= 0.0 else None,
                               args={"stream": bool(payload.stream),
                                     "trace": payload.trace_id})
        try:
            await self._completions_inner(reader, writer, payload, rid, loop, aq)
        finally:
            if tracer is not None:
                tracer.async_end(rid, "http")

    async def _completions_inner(self, reader, writer, payload, rid, loop, aq) -> None:
        self.runner.submit(rid, payload, loop, aq)
        verdict = await aq.get()
        if verdict[0] == "rejected":
            msg = (verdict[2] + "; retry later" if len(verdict) > 2
                   else "request queue is full; retry later")
            await self._respond_error(writer, HTTPError(
                429, msg, etype="rate_limit_error",
                headers=(("Retry-After", str(verdict[1])),)))
            return
        if verdict[0] == "error":
            await self._respond_error(writer, HTTPError(400, verdict[1]))
            return
        if verdict[0] == "finish":
            # terminal before acceptance: only the crash backstop does it
            await self._respond_error(writer, HTTPError(
                503, "engine tick thread crashed before the request "
                "was accepted", etype="server_error"))
            return
        created = int(time.time())
        resp_headers = (("traceparent", make_traceparent(payload.trace_id)),)
        # disconnect watch: drain (and discard) anything else the client
        # sends, and complete only at EOF — for an HTTP/1.1 client, a
        # hang-up → abort
        monitor = asyncio.ensure_future(self._watch_disconnect(reader))
        try:
            if payload.stream:
                await self._stream_response(writer, aq, monitor, rid, payload, created,
                                            extra_headers=resp_headers)
            else:
                await self._unary_response(writer, aq, monitor, rid, payload, created,
                                           extra_headers=resp_headers)
        finally:
            monitor.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await monitor

    async def _resume(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, rid: int,
                      last_idx: int, echo_model: str, t_accept: float = -1.0) -> None:
        """Re-attach a dropped SSE stream: replay the delivered-token
        suffix from the client's Last-Event-ID, then continue live.  404
        when the id is unknown or expired — the client falls back to a
        fresh POST."""
        if self.draining or self.runner.crashed:
            await self._respond_error(writer, HTTPError(
                503, "server is draining for shutdown"
                if self.draining else
                "engine tick thread crashed: " + str(self.runner.crashed),
                etype="server_error", headers=(("Retry-After", "1"),)))
            return
        tracer = self.tracer
        if tracer is not None:
            tracer.async_begin(rid, "http", ts_us=t_accept if t_accept >= 0.0 else None,
                               args={"resume": True, "last_event_id": last_idx})
        try:
            await self._resume_inner(reader, writer, rid, last_idx, echo_model)
        finally:
            if tracer is not None:
                tracer.async_end(rid, "http")

    async def _resume_inner(self, reader, writer, rid: int, last_idx: int,
                            echo_model: str) -> None:
        loop = asyncio.get_running_loop()
        aq: asyncio.Queue = asyncio.Queue()
        self.runner.resume(rid, last_idx, loop, aq)
        verdict = await aq.get()
        if verdict[0] == "gone":
            await self._respond_error(writer, HTTPError(404, verdict[1], code="unknown_completion"))
            return
        if verdict[0] == "busy":
            await self._respond_error(writer, HTTPError(
                503, verdict[1], etype="server_error", headers=(("Retry-After", "1"),)))
            return
        if verdict[0] == "finish":
            await self._respond_error(writer, HTTPError(
                503, "engine tick thread crashed before the resume "
                "was attached", etype="server_error"))
            return
        created = int(time.time())
        tp = verdict[1] if len(verdict) > 1 else None
        resume_headers = (("traceparent", make_traceparent(tp)),) if tp else ()
        monitor = asyncio.ensure_future(self._watch_disconnect(reader))
        try:
            await self._stream_response(writer, aq, monitor, rid, _ResumeEcho(echo_model),
                                        created, start_idx=last_idx,
                                        extra_headers=resume_headers)
        finally:
            monitor.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await monitor

    @staticmethod
    async def _watch_disconnect(reader: asyncio.StreamReader) -> None:
        while True:
            data = await reader.read(4096)
            if not data:
                return

    async def _next_event(self, aq: asyncio.Queue,
                          monitor: asyncio.Future) -> tuple | None:
        """Next engine event, or None if the client disconnected first."""
        getter = asyncio.ensure_future(aq.get())
        done, _ = await asyncio.wait({getter, monitor}, return_when=asyncio.FIRST_COMPLETED)
        if getter in done:
            return getter.result()
        getter.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await getter
        return None

    async def _stream_response(self, writer, aq, monitor, rid,
                               payload, created, start_idx: int = 0,
                               extra_headers: tuple = ()) -> None:
        # delivered-token index, the SSE event id of every token frame: a
        # client that reconnects with Last-Event-ID = the last id it saw
        # gets exactly the tokens it is missing
        idx = start_idx
        head = (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-cache\r\n"
            "Connection: close\r\n"
        )
        for key, value in extra_headers:
            head += f"{key}: {value}\r\n"
        try:
            writer.write(head.encode() + b"\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            # gone before the first byte: free the decode slot
            self.runner.abort(rid)
            return
        while True:
            ev = await self._next_event(aq, monitor)
            if ev is None:  # client went away mid-stream
                self.runner.abort(rid)
                return
            if ev[0] == "token":
                _, tok, delta = ev
                idx += 1
                frame = sse_event(chunk_payload(
                    rid, payload.echo_model, created,
                    text=delta or "", token_id=tok, finish_reason=None,
                ), event_id=idx)
            else:  # ("finish", reason, tail)
                _, reason, tail = ev
                frame = sse_event(chunk_payload(
                    rid, payload.echo_model, created,
                    text=tail or "", token_id=None, finish_reason=reason,
                )) + DONE_SENTINEL
            faults = self.runner.faults
            if faults is not None and faults.trip("http_reset") is not None:
                # an injected socket reset mid-stream: the client sees a
                # hard RST, the request aborts like any disconnect
                writer.transport.abort()
                self.runner.abort(rid)
                return
            try:
                writer.write(frame)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                self.runner.abort(rid)
                return
            if ev[0] == "finish":
                return

    async def _unary_response(self, writer, aq, monitor, rid,
                              payload, created, extra_headers: tuple = ()) -> None:
        token_ids: list[int] = []
        text_parts: list[str] = []
        while True:
            ev = await self._next_event(aq, monitor)
            if ev is None:
                self.runner.abort(rid)
                return
            if ev[0] == "token":
                token_ids.append(ev[1])
                if ev[2]:
                    text_parts.append(ev[2])
            else:
                reason, tail = ev[1], ev[2]
                if tail:
                    text_parts.append(tail)
                break
        body = json.dumps(completion_payload(
            rid, payload.echo_model, created,
            text="".join(text_parts), token_ids=token_ids,
            finish_reason=reason, prompt_tokens=int(payload.prompt_ids.size),
        )).encode()
        await self._respond(writer, 200, body, extra_headers=extra_headers)

    # ------------------------------------------------------------------
    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       body: bytes, content_type: str = "application/json",
                       extra_headers: tuple = ()) -> None:
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n"
        )
        for key, value in extra_headers:
            head += f"{key}: {value}\r\n"
        writer.write(head.encode() + b"\r\n" + body)
        with contextlib.suppress(ConnectionResetError, BrokenPipeError, OSError):
            await writer.drain()

    async def _respond_error(self, writer: asyncio.StreamWriter, e: HTTPError) -> None:
        await self._respond(writer, e.status, error_body(e.message, e.etype, e.code),
                            extra_headers=tuple(e.headers))


async def run_server(
    engine: Any,
    *,
    model_id: str,
    tokenizer: Any = None,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout: float | None = None,
    drain_timeout: float = 30.0,
    default_max_tokens: int = 16,
    max_tokens_cap: int | None = None,
    tick_deadline: float | None = None,
    max_restarts: int = 0,
    restart_backoff_s: float = 0.5,
    restart_window_s: float = 300.0,
    port_file: str | None = None,
    exit_after_s: float | None = None,
    on_started: Any = None,
    runner: Any = None,
    upgrade_loader: Any = None,
) -> HttpServer:
    """Start serving and block until drain shutdown completes."""
    server = HttpServer(
        engine, model_id=model_id, tokenizer=tokenizer,
        request_timeout=request_timeout, drain_timeout=drain_timeout,
        default_max_tokens=default_max_tokens,
        max_tokens_cap=max_tokens_cap,
        tick_deadline=tick_deadline, max_restarts=max_restarts,
        restart_backoff_s=restart_backoff_s, restart_window_s=restart_window_s,
        runner=runner,
        upgrade_loader=upgrade_loader,
    )
    await server.start(host, port)
    if port_file:
        with open(port_file, "w") as f:
            f.write(f"{server.host} {server.port}\n")
    if exit_after_s is not None:
        asyncio.get_running_loop().call_later(exit_after_s, server.begin_drain)
    if on_started is not None:
        on_started(server)
    await server.serve_until_shutdown()
    return server


def serve_forever(engine: Any, **kwargs: Any) -> None:
    """Synchronous entry: run the server on a fresh event loop until a
    drain shutdown (SIGTERM/SIGINT, or ``exit_after_s``) completes."""
    asyncio.run(run_server(engine, **kwargs))

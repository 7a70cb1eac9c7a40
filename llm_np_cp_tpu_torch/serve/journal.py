"""Durable request journal: survive ``kill -9``, not just engine death
(port of ``llm_np_cp_tpu/serve/journal.py``: the same framing, records,
replay state machine and compaction, so a journal written by either
package replays under the other).

An append-only, CRC-framed, fsync'd journal of what the engine admitted
and delivered, written off the tick thread and replayed on server start
through the teacher-forced ``ServeEngine.recover``.  Rows are keyed by
(seed, content position), so the replayed continuation is the
interrupted one token for token (in float32; in bf16 a replay prefills
what the first run decoded, which can flip a near-tie): any durable
prefix of the stream resumes it, and a lost tail is regenerated.  A
regenerated token that a client already held could differ from it, so
the HTTP runner delivers stream events only once the journal holds what
they carry (``after_durable``, the port's difference): what a client
holds is always a durable prefix.

Records (JSON payloads in a ``[u32 len][u32 crc32]`` frame):

- **admission** (``adm``) — request id, prompt ids, seed, max_tokens,
  the absolute deadline as wall time, and any pre-seeded tokens (a
  recovery re-admission journals its teacher-forced state, so a second
  crash replays from the latest admission);
- **delivery watermark** (``wm``) — one record per tick:
  ``[request id, delivered-through index, new token ids]`` rows;
- **terminal** (``fin``) — the finish reason; the request leaves the
  replay set;

plus an ``epoch`` record per open and periodic compaction (past
``compact_bytes`` appended, the writer rewrites the file as one
admission per live request).  A torn tail stops replay at the first bad
frame, and reopening truncates the file back to the valid prefix.

Threading: the engine tick thread owns the enqueue side (``admit`` /
``end_tick`` / ``terminal`` and the ``_mark`` index); the writer thread
owns the file handle and the live mirror it compacts from, and does file
IO and the ``after_durable`` callbacks only (no CUDA call); the pending
queue and the stats share ``_lock``.
Chaos sites ``journal_write`` / ``journal_fsync`` fail the IO: the batch
is dropped and counted, serving continues.
"""


from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np

_HDR = struct.Struct("<II")  # payload length, crc32(payload)
_MAX_RECORD = 64 << 20  # sanity bound: a bigger "length" is torn garbage


def _crc(payload: bytes) -> int:
    import zlib

    return zlib.crc32(payload) & 0xFFFFFFFF


def _frame(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":")).encode()
    return _HDR.pack(len(payload), _crc(payload)) + payload


def _iter_frames(data: bytes) -> Iterator[tuple[dict, int]]:
    """Decode the valid frame prefix → ``(record, end offset)`` pairs,
    stopping at the first torn or corrupt frame.  The ONE framing
    decoder behind both ``iter_records`` and ``scan_journal`` — a
    framing change applied to one but not the other would make replay
    and the debug reader disagree about where the valid prefix ends."""
    off = 0
    while off + _HDR.size <= len(data):
        ln, crc = _HDR.unpack_from(data, off)
        if ln > _MAX_RECORD or off + _HDR.size + ln > len(data):
            return
        payload = data[off + _HDR.size: off + _HDR.size + ln]
        if _crc(payload) != crc:
            return
        try:
            rec = json.loads(payload)
        except ValueError:
            return
        off += _HDR.size + ln
        yield rec, off


def iter_records(path: str) -> Iterator[dict]:
    """Decode the journal's valid frame prefix (stops at the first torn
    or corrupt record — exactly the records replay would apply).  For
    tests and operator debugging; replay itself uses ``scan_journal``."""
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return
    for rec, _ in _iter_frames(data):
        yield rec


def scan_finished(path: str, keep: int = 512) -> dict[int, dict]:
    """→ the requests the journal saw end (a ``fin`` after their
    admission), the last ``keep`` to end, by rid: each its replay entry
    with the final tokens and the ``reason``.  Write-ahead delivery sends
    a stream's last tokens and its finish only once the ``fin`` is on
    disk, so after a ``kill -9`` a client can hold part of a stream that
    the live replay set no longer has: the runner parks these for its
    resume (the port's difference; compaction keeps live requests only,
    so a finished request compacted away is gone)."""
    state: dict[int, dict] = {}
    done: dict[int, dict] = {}
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return done
    for rec, _ in _iter_frames(data):
        t = rec.get("t")
        if t in ("adm", "fin"):
            rid = int(rec["rid"])
            ent = done.pop(rid, None) if t == "adm" else state.get(rid)
            if t == "fin" and ent is not None:
                done[rid] = dict(ent, tokens=list(ent["tokens"]), reason=rec.get("reason"))
                while len(done) > keep:
                    done.pop(next(iter(done)))
        _apply(state, rec)
    return done


def _apply(state: dict[int, dict], rec: dict) -> int | None:
    """Fold one record into the live-request state; returns the epoch
    for ``epoch`` records.  The ONE state machine shared by replay and
    the writer's compaction mirror, so they cannot drift."""
    t = rec.get("t")
    if t == "epoch":
        return int(rec.get("n", 0))
    if t == "adm":
        # an admission OVERWRITES: a recovery re-admission carries the
        # full teacher-forced token state, superseding older records
        state[int(rec["rid"])] = {
            "rid": int(rec["rid"]),
            "prompt": list(rec["prompt"]),
            "max_tokens": int(rec["max_tokens"]),
            "seed": int(rec.get("seed", 0)),
            "deadline_wall": rec.get("deadline_wall"),
            "tokens": list(rec.get("tokens", ())),
            # trace continuity + survival lineage: a replay continues
            # the request's W3C trace and its replays/drains counters
            # (the canonical request log reports them)
            "trace": rec.get("trace"),
            "replays": int(rec.get("replays", 0)),
            "drains": int(rec.get("drains", 0)),
            # the request's speculative opt-in: a replay onto a
            # spec-enabled engine resumes drafting (tokens are identical
            # either way — this only preserves the throughput mode)
            "spec": bool(rec.get("spec", False)),
            # the weight version the request was ADMITTED under: a
            # replay (possibly onto a rolled engine) keeps reporting
            # the version that actually served the stream
            "wv": int(rec.get("wv", 0)),
            # tenancy survives kill -9: the replay re-admits under the
            # tenant that submitted it, so the bill lands on the right
            # ledger row after the crash too
            "tenant": rec.get("tenant", "default"),
        }
    elif t == "wm":
        for rid, n, toks in rec["rows"]:
            ent = state.get(int(rid))
            if ent is not None:
                ent["tokens"].extend(int(x) for x in toks)
                # defensive: the watermark names the authoritative count
                del ent["tokens"][int(n):]
    elif t == "fin":
        state.pop(int(rec["rid"]), None)
    return None


def scan_journal(path: str) -> tuple[dict[int, dict], int, int]:
    """→ ``(live unterminated requests by rid, valid byte prefix,
    last epoch)``.  Replay stops at the first torn/corrupt frame; the
    byte offset is where a reopening journal truncates to."""
    state: dict[int, dict] = {}
    epoch = 0
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return state, 0, 0
    off = 0
    for rec, end in _iter_frames(data):
        e = _apply(state, rec)
        if e is not None:
            epoch = max(epoch, e)
        off = end
    return state, off, epoch


class RequestJournal:
    """One journal file + one writer thread.

    Engine-thread API (every call is enqueue-only — no IO on the tick
    thread): ``admit(req, now)``, ``end_tick(requests)``,
    ``terminal(rid, reason)``.  Control: ``replay()`` (the unterminated
    state found at open), ``flush()`` (barrier: everything enqueued so
    far is written AND fsynced), ``after_durable(fn)`` (the same
    barrier, non-blocking: ``fn`` runs on the writer thread), ``close()``,
    ``stats()``.
    """

    def __init__(
        self,
        path: str,
        *,
        clock: Callable[[], float] = time.perf_counter,
        compact_bytes: int = 4 << 20,
        fsync: bool = True,
        sync_admissions: bool = False,
        fault_injector: Any = None,
    ) -> None:
        self.path = path
        self.clock = clock
        self.compact_bytes = compact_bytes
        self.fsync = fsync
        # strict mode (``sync_admissions``): ``admit``
        # blocks on a writer-thread flush barrier, so the admission
        # record is written AND fsynced before the 202/stream starts —
        # closing the async-fsync window where an admission accepted
        # milliseconds before a kill -9 could vanish (clients retry, so
        # the default async mode tolerates it; strict mode is for
        # operators who would rather pay one fsync of admission latency)
        self.sync_admissions = sync_admissions
        self.faults = fault_injector
        # -- open: scan the existing file, truncate the torn tail, note
        # the unterminated state for the caller to replay (single-
        # threaded: the writer thread starts below, after this)
        state, valid_end, epoch = scan_journal(path)
        self._replay_state = state
        self._finished_state = scan_finished(path)
        self.epoch = epoch + 1
        f = open(path, "ab")
        if f.tell() != valid_end:
            f.truncate(valid_end)
            f.seek(valid_end)
        # writer-thread-owned from here on: the
        # file handle, the live-request mirror compaction snapshots,
        # and the bytes-since-compaction counter
        self._wfile = f
        self._wlive = {rid: dict(ent, tokens=list(ent["tokens"]))
                       for rid, ent in state.items()}
        self._wsince = 0
        # engine-thread-owned: rid → delivered count already journaled
        # (the watermark hook only records the per-tick delta)
        self._mark: dict[int, int] = {
            rid: len(ent["tokens"]) for rid, ent in state.items()
        }
        # shared under _lock: the pending queue and the stats counters
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list = []
        self._stopping = False
        self.n_records = 0
        self.bytes_written = 0
        self.n_fsyncs = 0
        self.fsync_s: list[float] = []
        self.n_write_errors = 0
        self.n_fsync_errors = 0
        self.n_compactions = 0
        self._enqueue({"t": "epoch", "n": self.epoch,
                       "wall": time.time()})
        self._thread = threading.Thread(
            target=self._writer_loop, name="serve-journal-writer",
            daemon=True,
        )
        self._thread.start()

    # -- replay --------------------------------------------------------
    def replay(self) -> list[dict]:
        """The unterminated requests found when the journal was opened,
        rid-ascending (original admission order): each is
        ``{rid, prompt (np.int32), max_tokens, seed, deadline_wall,
        tokens}`` — everything ``ServeEngine.recover`` needs to
        teacher-force the stream back."""
        out = []
        for rid in sorted(self._replay_state):
            ent = self._replay_state[rid]
            out.append(dict(
                ent,
                prompt=np.asarray(ent["prompt"], dtype=np.int32),
                tokens=list(ent["tokens"]),
            ))
        return out

    def replay_finished(self) -> list[dict]:
        """The requests found ended when the journal was opened
        (``scan_finished``), rid-ascending: each ``{rid, prompt,
        max_tokens, seed, tokens, reason, ...}``."""
        return [dict(self._finished_state[rid], tokens=list(self._finished_state[rid]["tokens"]))
                for rid in sorted(self._finished_state)]

    # -- engine-thread hooks (enqueue only, no IO) ---------------------
    def admit(self, req: Any, now: float) -> None:
        """Journal one admission.  ``now`` is the engine clock reading
        the request's absolute deadline compares against; the deadline
        goes to disk as WALL time so a restarted process can resume the
        REMAINING budget (a crash must not grant a fresh window)."""
        deadline_wall = None
        if req.deadline is not None:
            deadline_wall = time.time() + (req.deadline - now)
        self._mark[req.req_id] = len(req.generated)
        rec = {
            "t": "adm",
            "rid": req.req_id,
            "prompt": [int(x) for x in req.prompt],
            "max_tokens": int(req.max_new_tokens),
            "seed": int(req.seed),
            "deadline_wall": deadline_wall,
            "tokens": [int(x) for x in req.generated],
        }
        # trace id + survival lineage ride the admission record so a
        # post-restart replay continues the SAME trace (and the request
        # log's replays/drains counters survive a second crash)
        trace = req.extra.get("trace")
        if trace is not None:
            rec["trace"] = trace
        for key in ("replays", "drains"):
            val = req.extra.get(key)
            if val:
                rec[key] = int(val)
        if getattr(req, "speculative", False):
            rec["spec"] = True
        # the serving weight version (rolling-upgrade tagging): written
        # only when nonzero, so pre-upgrade journals stay byte-stable
        wv = req.extra.get("weights_version")
        if wv:
            rec["wv"] = int(wv)
        # tenant id: written only when non-default, so single-tenant
        # journals stay byte-stable across the tenancy feature
        tenant = getattr(req, "tenant", "default")
        if tenant != "default":
            rec["tenant"] = tenant
        self._enqueue(rec)
        if self.sync_admissions:
            # block the enqueuing (engine) thread until the writer has
            # written AND fsynced this admission; failure degrades
            # (counted), never blocks admission forever
            self.flush(timeout=10.0)

    def end_tick(self, requests: Any) -> None:
        """One watermark record for the whole tick (batched per tick,
        never per token): every live request whose delivered count
        advanced since the last journaled mark contributes one row."""
        rows = []
        for req in requests:
            n = len(req.generated)
            m = self._mark.get(req.req_id, 0)
            if n > m:
                rows.append([req.req_id, n,
                             [int(x) for x in req.generated[m:]]])
                self._mark[req.req_id] = n
        if rows:
            self._enqueue({"t": "wm", "rows": rows})

    def terminal(self, rid: int, reason: str) -> None:
        self._mark.pop(rid, None)
        self._enqueue({"t": "fin", "rid": int(rid), "reason": reason})

    # -- control -------------------------------------------------------
    def _enqueue(self, rec: dict) -> None:
        with self._lock:
            if self._stopping:
                return
            self._pending.append(rec)
            self._cond.notify()

    def flush(self, timeout: float = 10.0) -> bool:
        """Barrier: True once every record enqueued BEFORE this call is
        written and fsynced (tests and the drain path use it)."""
        ev = threading.Event()
        with self._lock:
            if self._stopping and self._thread.is_alive() is False:
                return True
            self._pending.append(("flush", ev))
            self._cond.notify()
        return ev.wait(timeout)

    def after_durable(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the writer thread once every record enqueued
        BEFORE this call is written and fsynced (or its batch failed and
        was counted: durability degrades, delivery does not stall).  The
        HTTP runner releases stream events through it, so a client never
        holds a token that a restart would regenerate.  Once the journal
        is closing, ``fn`` runs here after the writer has drained."""
        with self._lock:
            if not self._stopping:
                self._pending.append(("call", fn))
                self._cond.notify()
                return
        self._thread.join()
        fn()

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, fsync, and stop the writer thread."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            fsync_s = list(self.fsync_s)
            out = {
                "records": self.n_records,
                "bytes_written": self.bytes_written,
                "fsyncs": self.n_fsyncs,
                "write_errors": self.n_write_errors,
                "fsync_errors": self.n_fsync_errors,
                "compactions": self.n_compactions,
                "epoch": self.epoch,
                "replayed": len(self._replay_state),
            }
        out["fsync_p99_s"] = (
            float(np.percentile(np.asarray(fsync_s), 99)) if fsync_s
            else 0.0
        )
        return out

    # -- writer thread ---------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stopping:
                    self._cond.wait(0.5)
                batch, self._pending = self._pending, []
                stopping = self._stopping
            if batch:
                self._writer_batch(batch)
            if stopping:
                with self._lock:
                    leftover, self._pending = self._pending, []
                if leftover:
                    self._writer_batch(leftover)
                try:
                    self._wfile.close()
                except OSError:
                    pass
                return

    def _writer_batch(self, batch: list) -> None:
        recs = [b for b in batch if isinstance(b, dict)]
        barriers = [b for b in batch if not isinstance(b, dict)]
        if recs:
            blob = b"".join(_frame(r) for r in recs)
            faults = self.faults
            try:
                if (faults is not None
                        and faults.trip("journal_write") is not None):
                    raise OSError("chaos: injected journal write error")
                self._wfile.write(blob)
                self._wfile.flush()
            except OSError:
                # durability degradation, never an outage: the batch is
                # dropped and counted; serving continues
                with self._lock:
                    self.n_write_errors += 1
            else:
                for r in recs:
                    _apply(self._wlive, r)
                self._wsince += len(blob)
                with self._lock:
                    self.n_records += len(recs)
                    self.bytes_written += len(blob)
                if self.fsync:
                    t0 = time.monotonic()
                    try:
                        if (faults is not None
                                and faults.trip("journal_fsync") is not None):
                            raise OSError(
                                "chaos: injected journal fsync error")
                        os.fsync(self._wfile.fileno())
                    except OSError:
                        with self._lock:
                            self.n_fsync_errors += 1
                    else:
                        dt = time.monotonic() - t0
                        with self._lock:
                            self.n_fsyncs += 1
                            self.fsync_s.append(dt)
                            if len(self.fsync_s) > 10_000:
                                del self.fsync_s[:5_000]
                if self._wsince >= self.compact_bytes:
                    self._writer_compact()
        # in queue order: a flush barrier or a delivery (``after_durable``)
        # enqueued after another runs after it
        for kind, obj in barriers:
            if kind == "flush":
                obj.set()
            else:
                obj()

    def _writer_compact(self) -> None:
        """Rewrite the file as epoch + one admission per live request
        (tokens folded in) — replay-equivalent by construction (the same
        ``_apply`` state machine), size bounded by the live set."""
        tmp = self.path + ".compact"
        try:
            with open(tmp, "wb") as f:
                f.write(_frame({"t": "epoch", "n": self.epoch,
                                "wall": time.time()}))
                for rid in sorted(self._wlive):
                    ent = self._wlive[rid]
                    rec = {
                        "t": "adm", "rid": rid,
                        "prompt": ent["prompt"],
                        "max_tokens": ent["max_tokens"],
                        "seed": ent["seed"],
                        "deadline_wall": ent.get("deadline_wall"),
                        "tokens": ent["tokens"],
                    }
                    # trace/lineage survive compaction, or a compacted-
                    # then-replayed request would start a fresh trace
                    if ent.get("trace") is not None:
                        rec["trace"] = ent["trace"]
                    for key in ("replays", "drains"):
                        if ent.get(key):
                            rec[key] = ent[key]
                    if ent.get("spec"):
                        rec["spec"] = True
                    if ent.get("wv"):
                        rec["wv"] = ent["wv"]
                    if ent.get("tenant", "default") != "default":
                        rec["tenant"] = ent["tenant"]
                    f.write(_frame(rec))
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            old = self._wfile
            os.replace(tmp, self.path)
            self._wfile = open(self.path, "ab")
            self._wsince = 0
            try:
                old.close()
            except OSError:
                pass
            with self._lock:
                self.n_compactions += 1
        except OSError:
            with self._lock:
                self.n_write_errors += 1

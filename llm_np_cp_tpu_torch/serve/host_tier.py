"""Host-RAM KV block tier: spill evicted prefix blocks, restore on hit
(port of ``llm_np_cp_tpu/serve/host_tier.py``).

The paged pool's prefix cache (``serve/prefix_cache.py``) makes shared
prompt blocks free to SERVE but not free to KEEP: once the prefix
working set outgrows the pool, LRU reclaim drops cache-only blocks and
the next request with that prefix re-prefills it.  This module adds the
tier under the pool, with the JAX package's decisions:

- **spill** — when LRU reclaim is about to drop a fully-filled prefix
  block (``PrefixCache.on_reclaim``), the engine clones the block's K/V
  (and int8 scale pages) contiguous on its own stream and hands the
  clone to the tier; the WRITER THREAD copies it to host memory, keyed
  by the block's chained content hash.
- **restore** — at admission ``ServeEngine._prefill_plan`` consults the
  tier after the device cache; hits are staged back to the card by the
  writer thread and written into the pool's own pages before the
  covering tick dispatches (``ServeEngine._apply_tier_restores``), so
  restored prefixes consume no tick budget, exactly like device hits.
- **ship** — ``ServeEngine.spill_prefix_blocks`` copies registered
  blocks into a tier another engine shares, which then restores them.

Restore-vs-recompute is a measured breakeven: ``ensure_probe`` times a
host→device copy of one pool block, the engine feeds measured prefill
token rates (``note_prefill_rate``), and ``should_restore`` compares the
two; below breakeven the plan re-prefills (counted in ``note_skip``).

On the card:

- the host store is pinned memory from torch's caching pinned allocator
  (``pin_memory=True``); a block that capacity eviction drops returns to
  that cache, so nothing on the tick path frees pinned memory (which
  would synchronize the device);
- the writer copies on a ``torch.cuda.Stream`` of its own, never the
  legacy default stream.  A spill's device→host copy waits on an event
  the engine recorded after its clone (``enqueue_spill`` records it on
  the caller's stream) and holds the clone until the copy is done; a
  restore's host→device staging copy records an event that the engine's
  stream waits on before it copies the staged block into the pool (and
  the engine marks the staged tensors with ``record_stream``);
- the writer does its CUDA work while holding a lock that ``quiesce``
  takes: the engine holds it around a CUDA graph capture, so no tier
  call runs on the card while a capture is open;
- a failure of a copy (a CUDA error, or any other exception in a job)
  is not a miss: the writer keeps it and the next call into the tier
  from the engine raises it (``check``, ``take_restored``,
  ``enqueue_*``, ``drain``).  Only an absent key, a capacity race and a
  ``take_restored`` timeout are misses, which the engine answers by
  re-prefilling.

On the CPU the same code runs with plain tensor copies: no streams, no
pinning, no events.

THREADING, as in the JAX package: the writer thread alone owns the host
block store (``_wentries``, ``_wbytes``); the job queue (``_pending``),
the completion map (``_done``) and the counters sit under ``_lock``.
``match`` / ``contains`` read the store without the lock (dict lookups
are atomic under the interpreter lock, and a lost race just surfaces as
a restore miss the engine already handles).
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch


class HostBlock(NamedTuple):
    """One pool block's K/V.  Tensors are the block's pool layout minus
    the block axis: ``[L, BS, K, D]`` (scales ``[L, BS, K]`` for int8
    pools, else None).  Host-resident in the store; on the engine's
    device once staged for a restore."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self if a is not None)


class HostTierError(RuntimeError):
    """A spill or restore copy failed on the writer thread."""


def _host_copy(a: torch.Tensor, stream: torch.cuda.Stream | None) -> torch.Tensor:
    """``a`` copied into a fresh contiguous host tensor: pinned and
    asynchronous on ``stream`` for a CUDA tensor, a plain copy on the
    CPU."""
    if stream is None:
        return a.clone(memory_format=torch.contiguous_format)
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    host.copy_(a, non_blocking=True)
    return host


def _stage(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host block tensor ``a`` copied onto ``device`` for a restore
    (asynchronous from pinned memory on the card's current stream)."""
    return a.to(device, non_blocking=True, copy=True)


class HostTier:
    """LRU host pool of spilled KV blocks + the writer thread that moves
    them.

    ``capacity_bytes`` bounds host residency (LRU eviction past it — the
    tier is a cache, dropping is always safe).  One instance may be
    shared by several engines in a process: that is what block shipping
    (``ServeEngine.spill_prefix_blocks``) rides on.
    """

    def __init__(
        self,
        capacity_bytes: int,
        *,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.clock = clock
        # writer-thread-owned: the host block store, LRU-ordered oldest
        # first, its resident byte count, and the writer's copy streams
        self._wentries: OrderedDict[bytes, HostBlock] = OrderedDict()
        self._wbytes = 0
        self._wstreams: dict[torch.device, torch.cuda.Stream] = {}
        # held by the writer around its CUDA work and by ``quiesce``
        self._device_lock = threading.Lock()
        # shared under _lock: the job queue, the staged-restore
        # completion map, the counters and the first writer failure
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list = []
        self._done: dict[int, Any] = {}
        # tickets whose waiter timed out: the writer drops their staged
        # payloads instead of parking them in _done forever
        self._abandoned: set[int] = set()
        # keys with a spill queued but not yet applied (contains() only
        # sees applied entries; without this a ship-spill racing an
        # evict-spill would double-queue and double-count)
        self._pending_spill_keys: set[bytes] = set()
        self._fault: BaseException | None = None
        self._stopping = False
        self._next_ticket = 0
        self.n_spilled = 0
        self.spilled_bytes = 0
        self.n_restored = 0
        self.restored_bytes = 0
        self.n_restore_miss = 0
        self.n_dropped = 0
        self.n_skipped = 0  # below-breakeven re-prefill fallbacks
        self.restore_s: list[float] = []
        # breakeven measurements: the startup copy probe and the
        # engine-fed prefill-rate EWMA
        self.restore_s_per_block: float | None = None
        self.restore_gbps: float | None = None
        self.prefill_tok_s: float | None = None
        self._probed_bytes = 0
        # "auto" applies the measured breakeven; "always" / "never"
        # force the verdict (tests, and a tier-off twin)
        self.policy = "auto"
        self._thread = threading.Thread(target=self._writer_loop, name="serve-kv-tier-writer",
                                        daemon=True)
        self._thread.start()

    # -- lookups (engine side; lock-free reads, see module doc) --------
    def match(self, keys: list[bytes]) -> int:
        """Longest leading run of ``keys`` host-resident right now.  Pure
        lookup — no LRU touch (the restore jobs touch)."""
        n = 0
        for key in keys:
            if key not in self._wentries:
                break
            n += 1
        return n

    def contains(self, key: bytes) -> bool:
        return key in self._wentries

    @property
    def resident_bytes(self) -> int:
        return self._wbytes

    def __len__(self) -> int:
        return len(self._wentries)

    # -- breakeven policy ----------------------------------------------
    def ensure_probe(self, block_shapes: list[tuple[tuple[int, ...], torch.dtype]], *,
                     device: str | torch.device = "cuda", reps: int = 3) -> None:
        """Measure host→device bandwidth ONCE per tier with a block-sized
        copy: zero host buffers of the pool block's shapes and dtypes
        (pinned on the card), copied into device buffers allocated
        beforehand, ``reps`` times; keeps the median.  On the card each
        copy is timed with CUDA events on a stream of its own; on the CPU
        with ``clock``.  Engines call this at build time; a later engine
        with the same block bytes skips it."""
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        nbytes = sum(math.prod(s) * torch.empty((), dtype=dt).element_size()
                     for s, dt in block_shapes)
        with self._lock:
            if self.restore_s_per_block is not None and self._probed_bytes == nbytes:
                return
        src = [torch.zeros(s, dtype=dt, pin_memory=cuda) for s, dt in block_shapes]
        dst = [torch.empty(s, dtype=dt, device=dev) for s, dt in block_shapes]
        samples = []
        if cuda:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                for _ in range(max(reps, 1)):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    for d, s in zip(dst, src):
                        d.copy_(s, non_blocking=True)
                    end.record(stream)
                    end.synchronize()
                    samples.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(max(reps, 1)):
                t0 = self.clock()
                for d, s in zip(dst, src):
                    d.copy_(s)
                samples.append(self.clock() - t0)
        med = float(np.median(samples))
        with self._lock:
            self.restore_s_per_block = med
            self.restore_gbps = nbytes / med / 1e9 if med > 0 else float("inf")
            self._probed_bytes = nbytes

    def note_prefill_rate(self, tok_s: float) -> None:
        """Feed one measured prefill token rate; the EWMA is the
        recompute side of the breakeven."""
        if tok_s <= 0:
            return
        with self._lock:
            if self.prefill_tok_s is None:
                self.prefill_tok_s = float(tok_s)
            else:
                self.prefill_tok_s += 0.2 * (tok_s - self.prefill_tok_s)

    def set_measured(self, *, restore_s_per_block: float | None = None,
                     prefill_tok_s: float | None = None) -> None:
        """Pin the breakeven inputs directly (tests and offline
        calibration; engines use ensure_probe / note_prefill_rate)."""
        with self._lock:
            if restore_s_per_block is not None:
                self.restore_s_per_block = float(restore_s_per_block)
            if prefill_tok_s is not None:
                self.prefill_tok_s = float(prefill_tok_s)

    def breakeven_ratio(self, block_size: int) -> float | None:
        """(seconds to re-prefill one block) / (seconds to restore it):
        > 1 means restoring is cheaper.  None until both sides are
        measured."""
        restore_s = self.restore_s_per_block
        tok_s = self.prefill_tok_s
        if not restore_s or not tok_s:
            return None
        return (block_size / tok_s) / restore_s

    def should_restore(self, n_blocks: int, block_size: int) -> bool:
        """The restore-vs-recompute verdict for a span of ``n_blocks``
        (the span cancels out of the measured ratio).  An unmeasured side
        defaults to restore: a restore is bit-identical, so the
        optimistic default is correctness-neutral."""
        if self.policy == "always":
            return True
        if self.policy == "never":
            return False
        ratio = self.breakeven_ratio(block_size)
        return ratio is None or ratio >= 1.0

    def note_skip(self, n_blocks: int) -> None:
        """A below-breakeven host hit fell back to re-prefill."""
        with self._lock:
            self.n_skipped += n_blocks

    # -- spill / restore (enqueue side) --------------------------------
    def check(self) -> None:
        """Raise the writer's first failure, if any (engines call this
        once a tick, so a failed spill fails the next tick)."""
        if self._fault is not None:
            raise HostTierError(f"host tier writer failed: {self._fault!r}") from self._fault

    def enqueue_spill(self, key: bytes, k: torch.Tensor, v: torch.Tensor,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> bool:
        """Queue one block's tensors for the host copy.  Callers pass
        fresh contiguous clones of the block (made on the caller's stream
        before the block id frees, so the copy is race-free by stream
        order); on the card an event recorded here on the caller's stream
        orders the writer's copy after the clone.  Returns False — and
        queues nothing — when the key is already resident or pending, so
        callers' spill ledgers never run ahead of the tier's own."""
        self.check()
        ready = None
        if k.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(k.device))
        with self._lock:
            if self._stopping:
                return False
            if key in self._pending_spill_keys or key in self._wentries:
                return False
            self._pending_spill_keys.add(key)
            self._pending.append(("spill", key, (k, v, k_scale, v_scale), ready))
            self._cond.notify()
        return True

    def enqueue_restore(self, key: bytes, block_id: int,
                        device: str | torch.device = "cuda") -> int:
        """Queue one host block for staging on ``device``; returns the
        ticket ``take_restored`` redeems."""
        self.check()
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            if self._stopping:
                self._done[ticket] = None
            else:
                self._pending.append(("restore", ticket, key, block_id, torch.device(device)))
                self._cond.notify()
        return ticket

    def take_restored(self, tickets: list[int], timeout: float = 10.0) -> list[Any]:
        """Redeem restore tickets, in order; blocks until the writer has
        staged them all (or ``timeout``, after which missing entries come
        back None — the caller re-prefills, as for every miss).  Each
        result is ``(block_id, staged HostBlock on the device, stage
        seconds, ready event or None)``: the caller's stream waits on the
        event before it reads the staged tensors.  A failed staging copy
        raises ``HostTierError``."""
        deadline = self.clock() + timeout
        out: list[Any] = []
        with self._lock:
            for t in tickets:
                while t not in self._done:
                    left = deadline - self.clock()
                    if left <= 0 or (self._stopping and not self._pending):
                        break
                    self._cond.wait(min(left, 0.5))
                if t in self._done:
                    out.append(self._done.pop(t))
                else:
                    # the writer drops the late payload of an abandoned ticket
                    self._abandoned.add(t)
                    out.append(None)
        for res in out:
            if isinstance(res, BaseException):
                raise HostTierError(f"host tier restore failed: {res!r}") from res
        return out

    def await_resident(self, keys: list[bytes], timeout: float = 2.0) -> bool:
        """Wait until every key in ``keys`` is host-resident (or
        ``timeout``): the per-chain ship barrier, which returns as soon
        as the named chain lands however busy the queue is."""
        deadline = self.clock() + timeout
        with self._lock:
            while True:
                if self._fault is not None:
                    break
                if all(k in self._wentries for k in keys):
                    return True
                left = deadline - self.clock()
                if left <= 0 or self._stopping:
                    return False
                self._cond.wait(min(left, 0.2))
        self.check()
        return False

    @contextlib.contextmanager
    def quiesce(self) -> Iterator[None]:
        """While entered, the writer starts no CUDA work (it finishes the
        copy it is on first): what a CUDA graph capture on another thread
        needs, since a CUDA call from any thread during a capture breaks
        it."""
        with self._device_lock:
            yield

    # -- control -------------------------------------------------------
    def drain(self, timeout: float = 10.0) -> bool:
        """Barrier: every job enqueued before this call is processed.
        Raises the writer's failure, if one happened."""
        ev = threading.Event()
        with self._lock:
            if self._stopping and not self._thread.is_alive():
                return True
            self._pending.append(("flush", ev))
            self._cond.notify()
        done = ev.wait(timeout)
        self.check()
        return done

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)

    def stats(self) -> dict[str, Any]:
        """Point-in-time accounting for scrapes and tests."""
        with self._lock:
            restore_s = list(self.restore_s)
            out = {
                "capacity_bytes": self.capacity_bytes,
                "resident_bytes": self._wbytes,
                "resident_blocks": len(self._wentries),
                "spilled_blocks": self.n_spilled,
                "spilled_bytes": self.spilled_bytes,
                "restored_blocks": self.n_restored,
                "restored_bytes": self.restored_bytes,
                "restore_misses": self.n_restore_miss,
                "dropped_blocks": self.n_dropped,
                "skipped_blocks": self.n_skipped,
                "restore_gbps": self.restore_gbps or 0.0,
                "prefill_tok_s": self.prefill_tok_s or 0.0,
            }
        out["restore_s_p99"] = (float(np.percentile(np.asarray(restore_s), 99))
                                if restore_s else 0.0)
        return out

    # -- writer thread -------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stopping:
                    self._cond.wait(0.5)
                batch, self._pending = self._pending, []
                stopping = self._stopping
            # restores first: an admission waits on them, nothing waits
            # on a spill (a flush still follows every spill queued before
            # it, and a restore only ever targets an applied entry)
            batch.sort(key=lambda job: job[0] != "restore")
            for job in batch:
                self._writer_job(job)
            del batch
            if stopping:
                with self._lock:
                    leftover, self._pending = self._pending, []
                    # unblock take_restored waiters: their tickets
                    # resolve to None and the engine re-prefills
                    for job in leftover:
                        if job[0] == "restore":
                            self._done[job[1]] = None
                        elif job[0] == "flush":
                            job[1].set()
                    self._cond.notify_all()
                return

    def _writer_job(self, job: tuple) -> None:
        kind = job[0]
        if kind == "flush":
            job[1].set()
            return
        try:
            if kind == "spill":
                self._writer_spill(job)
            else:
                self._writer_restore(job)
        except Exception as e:  # noqa: BLE001 — kept and raised on the engine's side
            with self._lock:
                if self._fault is None:
                    self._fault = e
                if kind == "spill":
                    self._pending_spill_keys.discard(job[1])
                elif job[1] in self._abandoned:
                    self._abandoned.discard(job[1])
                else:
                    self._done[job[1]] = e
                self._cond.notify_all()

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        stream = self._wstreams.get(device)
        if stream is None:
            stream = self._wstreams[device] = torch.cuda.Stream(device)
        return stream

    def _writer_spill(self, job: tuple) -> None:
        _, key, arrs, ready = job
        if key in self._wentries:
            # already resident (the enqueue-side dedupe lost a race):
            # content under one key is identical, so an LRU touch is all
            self._wentries.move_to_end(key)
            with self._lock:
                self._pending_spill_keys.discard(key)
            return
        if ready is None:
            blk = HostBlock(*(_host_copy(a, None) if a is not None else None for a in arrs))
        else:
            with self._device_lock:
                stream = self._stream(arrs[0].device)
                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    blk = HostBlock(*(_host_copy(a, stream) if a is not None else None
                                      for a in arrs))
                # the clones are dropped with the job only after this
                stream.synchronize()
        self._wentries[key] = blk
        self._wbytes += blk.nbytes
        dropped = 0
        while self._wbytes > self.capacity_bytes and len(self._wentries) > 1:
            # the dropped pinned block returns to torch's pinned cache
            _, old = self._wentries.popitem(last=False)
            self._wbytes -= old.nbytes
            dropped += 1
        with self._lock:
            self.n_spilled += 1
            self.spilled_bytes += blk.nbytes
            self.n_dropped += dropped
            self._pending_spill_keys.discard(key)
            self._cond.notify_all()  # wake await_resident waiters

    def _writer_restore(self, job: tuple) -> None:
        _, ticket, key, block_id, device = job
        ent = self._wentries.get(key)
        if ent is None:
            with self._lock:
                self.n_restore_miss += 1
                if ticket in self._abandoned:
                    self._abandoned.discard(ticket)
                else:
                    self._done[ticket] = None
                self._cond.notify_all()
            return
        self._wentries.move_to_end(key)  # a restore is an LRU touch
        t0 = self.clock()
        ready = None
        if device.type == "cuda":
            with self._device_lock:
                stream = self._stream(device)
                with torch.cuda.stream(stream):
                    staged = HostBlock(*(_stage(a, device) if a is not None else None
                                         for a in ent))
                    ready = torch.cuda.Event()
                    ready.record(stream)
                # the writer pays the wait (the stage latency), never the tick
                ready.synchronize()
        else:
            staged = HostBlock(*(_stage(a, device) if a is not None else None for a in ent))
        dt = self.clock() - t0
        with self._lock:
            self.n_restored += 1
            self.restored_bytes += ent.nbytes
            self.restore_s.append(dt)
            if len(self.restore_s) > 4096:
                del self.restore_s[:2048]
            if ticket in self._abandoned:
                self._abandoned.discard(ticket)
            else:
                self._done[ticket] = (block_id, staged, dt, ready)
            self._cond.notify_all()

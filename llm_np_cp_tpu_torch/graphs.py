"""Captured static-shape steps: the port's counterpart of ``jax.jit``.

The JAX package compiles each decode step (``make_decode_step_fn``),
each packed-width bucket of the engine's unified tick (``_mixed_step``,
verify lanes included) and each speculative round
(``speculative.make_spec_decode_fn``) into one program, built once per
static shape and dispatched once per step.  Here such a step is a Python function over buffers that keep
their addresses from one call to the next (the step's inputs are copied
into them, its outputs read out of them), and ``CapturedStep`` runs it:

- for a step on the CPU, eagerly on every call: there are no graphs, so
  the tests run exactly the function the card captures;
- on the card, the first call runs the function eagerly on a side stream
  (a real step, and the warm-up that creates cuBLAS workspaces before a
  capture may not), then captures it into a CUDA graph with a private
  memory pool; every later call replays the graph with one launch.  A
  capture that fails raises: nothing falls back to the eager step.

``eager_steps()`` runs every step eagerly while it is entered (no
capture, no replay): the check that a replayed step gives what the same
function gives eagerly, on the same card.  A step built with
``eager=True`` always runs eagerly: a step that issues gloo collectives
(a decode step under a multi-rank mesh) cannot be captured.

A replay runs no Python, so the kernel wrappers' launch counters would
not see it.  The capture therefore records, on its own thread, what each
counter would have moved (the kernels in the graph; a capture launches
nothing) and adds that record at every replay: a counter reads kernels
captured × replays, plus eager launches.  Counts move under one lock
(``ops/cuda/_common.count``), so engines ticking on several threads at
once, one of them capturing, lose none.

Several engines may share the card, each ticking on its own thread (a
replica fleet, ``serve/replica.py``).  A first call (the eager step and
its capture) holds a process-wide lock, so one capture runs at a time;
the capture is ``thread_local`` (only the capturing thread is barred
from calls a capture forbids: a peer's replays and host fetches go on),
and it makes no device-wide synchronize — it waits on its side stream
only.  Each engine captures on a side stream of its own
(``take_side_stream``): a graph keeps the cuBLAS workspace of the
stream it was captured on, and two engines' graphs replaying at once
must not share one.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Iterator

import torch

from llm_np_cp_tpu_torch.ops.cuda import _common

# totals over every captured step of the process, as a caller may read
# them around a run: captures, replays, eager first calls, seconds spent
# capturing and the bytes the graphs' pools took from the card
TOTALS = {"captures": 0, "replays": 0, "eager": 0, "capture_s": 0.0, "pool_bytes": 0}
_TOTALS_LOCK = threading.Lock()

# held by a step's first call (eager run + capture) and by a graph's
# reset: one capture at a time in the process, never beside a teardown
_CAPTURE_LOCK = threading.RLock()


def _add_totals(**moves: float) -> None:
    with _TOTALS_LOCK:
        for k, v in moves.items():
            TOTALS[k] += v


_EAGER = [0]

# the stream each device's first (eager) calls run on and are captured
# on, for steps that name none: one a device for the process, since every
# stream a step runs on gets a cuBLAS workspace of its own from the
# caching allocator, kept until the process ends
_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
# the side streams engines own (``take_side_stream``).  A captured graph
# keeps the cuBLAS workspace of the stream it was captured on, so two
# engines whose graphs replay at once on two streams (a fleet's replicas)
# must not share one: each engine captures on its own side stream, and a
# dead or retired engine's goes back here for the next engine (a restart
# reuses it, so reserved memory does not grow with every rebuild)
_FREE_SIDE: dict[torch.device, list[torch.cuda.Stream]] = {}
_FREE_SIDE_LOCK = threading.Lock()


def take_side_stream(device: torch.device) -> torch.cuda.Stream:
    """A side stream for one engine's captures on ``device``: a freed one,
    or a new one."""
    with _FREE_SIDE_LOCK:
        free = _FREE_SIDE.setdefault(device, [])
        return free.pop() if free else torch.cuda.Stream(device)


def give_side_stream(device: torch.device, stream: torch.cuda.Stream) -> None:
    """Return an engine's side stream once no graph of it replays."""
    with _FREE_SIDE_LOCK:
        _FREE_SIDE.setdefault(device, []).append(stream)


@contextlib.contextmanager
def eager_steps() -> Iterator[None]:
    """While entered, every ``CapturedStep`` runs its function eagerly on
    the current stream: nothing is captured or replayed."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def launch_counters() -> list[tuple[Callable, str]]:
    """``(wrapper, attribute)`` of every kernel launch counter."""
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se
    from llm_np_cp_tpu_torch.ops.cuda import softmax as sm
    from llm_np_cp_tpu_torch.ops.cuda import threefry as tf

    wrappers = (da.decode_attention, da.decode_attention_split, da.combine_splits,
                da.paged_decode_attention, da.paged_decode_attention_split,
                da.ragged_paged_attention, da.ragged_paged_attention_split,
                fa.flash_attention, se.sample_epilogue, sm.softmax, tf.threefry2x32,
                tf.categorical)
    return [(fn, attr) for fn in wrappers
            for attr in ("launches", "combine_launches", "launches_int8") if hasattr(fn, attr)]


class CapturedStep:
    """``fn()`` run eagerly on the CPU; on the card captured as a CUDA
    graph at its first call and replayed at every later one.  A step
    that draws reads its keys from its static buffers (``random``), so a
    replay draws as the eager step would.  ``guard()``, when given, is
    entered around the capture: a CUDA call from another thread while a
    capture is open would break it.  ``side`` is the stream the first call
    runs on and is captured on (the device's shared one by default; an
    engine passes its own).  ``eager=True``: never captured, run eagerly
    at every call."""

    def __init__(self, fn: Callable[[], None], device: torch.device, name: str,
                 guard: Callable[[], contextlib.AbstractContextManager] | None = None,
                 side: torch.cuda.Stream | None = None, eager: bool = False) -> None:
        self.fn, self.device, self.name = fn, device, name
        self.eager = eager
        self.side = side
        # entered around a capture: what must stay off the card meanwhile
        # (the engine's host tier writer, ``HostTier.quiesce``)
        self.guard = guard
        self.graph: torch.cuda.CUDAGraph | None = None
        self.deltas: tuple[tuple[Callable, str, int], ...] = ()
        self.calls = self.replays = 0
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None
        # set by ``retire``; the lock makes a replay and a retire exclusive
        self.retired = False
        self._lock = threading.Lock()

    @property
    def compiled(self) -> bool:
        """The step's graph exists (on the CPU, where the step runs
        eagerly: the step has been built and run).  An ``eager`` step has
        no graph on the card."""
        if self.device.type != "cuda":
            return self.calls > 0
        return self.graph is not None

    def retire(self) -> None:
        """Drop the graph and refuse every later call: after its engine is
        retired, the memory the graph would replay into may belong to the
        engine that replaced it (a replay after a free does not fail, it
        writes whatever now lives there)."""
        with _CAPTURE_LOCK, self._lock:
            self.retired = True
            if self.graph is not None:
                self.graph.reset()
            self.graph = None

    def _refuse(self) -> None:
        raise RuntimeError(f"{self.name}: this step's engine was retired; nothing replays it")

    def __call__(self) -> None:
        if self.retired:
            self._refuse()
        self.calls += 1
        if self.device.type != "cuda" or self.eager or _EAGER[0]:
            self.fn()
            return
        if self.graph is not None:
            with self._lock:
                if self.retired:
                    self._refuse()
                self.graph.replay()
            self.replays += 1
            _add_totals(replays=1)
            for fn, attr, n in self.deltas:
                _common.count(fn, attr, n)
            return
        with _CAPTURE_LOCK:
            cur = torch.cuda.current_stream(self.device)
            side = self.side or _SIDE_STREAMS.get(self.device)
            if side is None:
                side = _SIDE_STREAMS.setdefault(self.device, torch.cuda.Stream(self.device))
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn()
            cur.wait_stream(side)
            _add_totals(eager=1)
            with self.guard() if self.guard is not None else contextlib.nullcontext():
                self._capture(side)

    def _capture(self, side: torch.cuda.Stream) -> None:
        """Capture ``fn`` on ``side`` (caller holds ``_CAPTURE_LOCK``).
        What ``torch.cuda.graph`` does on entry, without its device-wide
        synchronize: the eager run's stream is waited on, garbage is
        collected and the allocator's free memory (retired graphs' pools
        among it) goes back, so the reserved bytes below move by this
        graph's pool alone (and by what a peer allocates meanwhile)."""
        graph = torch.cuda.CUDAGraph()
        side.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # no collection while the capture is open: one that another
        # thread's allocation triggers (the HTTP server's event loop)
        # would free CUDA tensors from that thread mid-capture
        gc_on = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with _common.recording() as moves, torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.fn()
                finally:
                    graph.capture_end()
            side.synchronize()
        except Exception as e:
            raise RuntimeError(f"capturing {self.name} as a CUDA graph failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.deltas = tuple((fn, attr, n) for (fn, attr), n in moves.items() if n)
        with self._lock:
            if self.retired:
                graph.reset()
                self._refuse()
            self.graph = graph
        _add_totals(captures=1, capture_s=self.capture_s, pool_bytes=self.pool_bytes)

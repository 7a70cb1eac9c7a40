"""Profiling and tracing (port of ``llm_np_cp_tpu/utils/profiling.py``).

``timing`` is a switchable wall-clock decorator (env ``LLMTPU_TIMING=1``
or ``enable_timing()``) that synchronises the card before it stops the
clock: CUDA launches return before the device finishes, so a clock
without a synchronise measures the enqueue.  ``trace(log_dir)`` is a
``torch.profiler`` context (CPU activity, and CUDA activity when a card
is present) that writes a Chrome trace into ``log_dir`` (open it at
ui.perfetto.dev); it stands where the JAX package has
``jax.profiler.start_trace``.  ``Stopwatch`` marks TTFT-style phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

_TIMING_ENABLED = os.environ.get("LLMTPU_TIMING", "") not in ("", "0")

# the file ``trace`` writes inside its ``log_dir``
TRACE_FILE = "trace.json"


def enable_timing(on: bool = True) -> None:
    global _TIMING_ENABLED
    _TIMING_ENABLED = on


def _cuda_devices(obj: Any) -> set[torch.device]:
    """The CUDA devices of every tensor in ``obj`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.device.type == "cuda" else set()
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = vars(obj).values()
    else:
        return set()
    out: set[torch.device] = set()
    for v in items:
        out |= _cuda_devices(v)
    return out


def _synchronize(obj: Any) -> None:
    """Wait until the devices of ``obj``'s tensors have finished."""
    for dev in _cuda_devices(obj):
        torch.cuda.synchronize(dev)


def timing(fn: Callable) -> Callable:
    """Per-call wall-clock printer (the reference's decorator, made real)."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any):
        if not _TIMING_ENABLED:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        dt = time.perf_counter() - t0
        print(f"[timing] {fn.__qualname__}: {dt * 1e3:.2f} ms")
        return out

    return wrapper


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    to ``log_dir/trace.json`` (default: ``llmtpu_trace`` under the
    temporary directory)."""
    out = Path(log_dir or os.path.join(tempfile.gettempdir(), "llmtpu_trace"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / TRACE_FILE))


class Stopwatch:
    """Tiny helper for step metrics: TTFT, per-phase durations, rates."""

    def __init__(self) -> None:
        self.marks: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def mark(self, name: str, result: Any = None) -> float:
        if result is not None:
            _synchronize(result)
        t = time.perf_counter() - self._t0
        self.marks[name] = t
        return t

    def span(self, a: str, b: str) -> float:
        return self.marks[b] - self.marks[a]

"""Argument checks and the launch counts shared by the kernel wrappers."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch

# the launchers' element-type codes (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version); raises on a mix of devices or a device that is
    neither CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous."""
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def dtype_code(name: str, dtype: torch.dtype) -> int:
    """The launcher's element-type code for ``dtype``; raises for a type
    the kernels do not take."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def check_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS}, got {d}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the launch counts: every wrapper's ``launches`` (and ``combine_launches``
# / ``launches_int8``) attribute moves only through ``count``, under one
# lock, so tick threads of several engines launching at once lose no
# count.  A thread that is capturing a CUDA graph records what its
# kernels would add in its own record instead (``recording``): a capture
# launches nothing, and the graph's replays add the record.
_COUNT_LOCK = threading.Lock()
_RECORD = threading.local()


def count(fn: Callable, attr: str, n: int = 1) -> None:
    """Add ``n`` launches to ``fn.attr`` — or, on a thread inside
    ``recording()``, to that thread's record."""
    if not n:
        return
    rec = getattr(_RECORD, "moves", None)
    if rec is not None:
        rec[(fn, attr)] = rec.get((fn, attr), 0) + n
        return
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


@contextlib.contextmanager
def recording() -> Iterator[dict[tuple[Callable, str], int]]:
    """While entered, this thread's ``count`` calls fill the yielded dict
    (``(wrapper, attribute) → launches``) and leave the counts alone;
    other threads count as usual."""
    if getattr(_RECORD, "moves", None) is not None:
        raise RuntimeError("launch recording does not nest")
    moves: dict[tuple[Callable, str], int] = {}
    _RECORD.moves = moves
    try:
        yield moves
    finally:
        _RECORD.moves = None

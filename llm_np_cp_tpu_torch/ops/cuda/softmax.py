"""Softmax over the last axis (port of ``llm_np_cp_tpu/ops/pallas/softmax.py``).

The kernel is ``csrc/softmax.cu``: short rows a few to a warp, long rows
split over a thread-block cluster of up to 8 blocks, every row read from
memory once.  ``softmax_plain`` is the same function in plain PyTorch.  As in the JAX package, no model path calls it: the kernel
is held against its plain version and timed on its own.
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Max-subtracted softmax over the last axis in float32, cast back to
    x's dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of ``x``; leading axes are flattened to
    rows.  Float32 inside, the output in x's dtype.

    CPU tensors run ``softmax_plain``; CUDA tensors launch the kernel or
    raise.
    """
    if _common.on_cpu(x):
        return softmax_plain(x)
    code = _common.dtype_code("softmax", x.dtype)
    _common.check_contiguous("softmax", x=x)
    n = x.shape[-1] if x.dim() else 1
    rows = x.numel() // n if n else 0
    out = torch.empty_like(x)
    err = library().softmax_launch(
        x.data_ptr(), out.data_ptr(), rows, n, code, _common.stream_ptr(x))
    check(err, "softmax")
    _common.count(softmax, "launches")
    return out


softmax.launches = 0

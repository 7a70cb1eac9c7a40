"""Device selection for the port's entry points.

Every entry point (``Generator``, ``forward``, ``init_params``,
``KVCache.init``, ``load_params``) takes ``device=`` and defaults to
``"cuda"``.  A CUDA request on a machine without a card raises here: the
port never falls back to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` with an explicit card index
    (``"cuda"`` → ``cuda:<current>``, so it compares equal to a tensor's
    device); raises when it names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""JAX params (as numpy) → port params.

The one place where layouts would change.  The port keeps the JAX
package's dict layout (stacked ``[L, ...]`` layer leaves, projections
stored (in, out)), so conversion is a per-leaf copy.  bfloat16 leaves
arrive as numpy arrays of the ``bfloat16`` extension dtype; they are
reinterpreted through ``int16`` without importing the package that
defines that dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llm_np_cp_tpu_torch.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    """One numpy array → torch tensor on ``device`` (bfloat16 bit-exact)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def params_from_jax(tree: dict[str, Any], *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """A JAX param dict whose leaves were turned into numpy arrays
    (``jax.tree.map(np.asarray, params)``) → the port's param dict."""
    return {
        k: params_from_jax(v, device=device) if isinstance(v, dict)
        else tensor_from_numpy(v, device)
        for k, v in tree.items()
    }

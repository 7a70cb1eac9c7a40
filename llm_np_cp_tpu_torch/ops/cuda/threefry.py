"""threefry2x32 draws on the card (the port's counterpart of XLA's fused
threefry, which ``jax.random`` lowers to; no ``pl.pallas_call`` of the
JAX package draws).

The kernels are ``csrc/threefry.cu``: ``threefry2x32``, elementwise over
keys and 64-bit counters (keys, words or uniforms: ``PRNGKey``-derived
keys, ``split``, ``fold_in``, ``random_bits``, ``uniform``), and
``categorical``, which hashes each logit's counter, turns the word into
a Gumbel draw, adds the logit and takes each row's argmax, reading the
logits once.  Their plain versions are ``random.words_plain`` and
``random.categorical_plain``; ``llm_np_cp_tpu_torch.random`` is the API
over both wrappers.
"""

from __future__ import annotations

import numpy as np
import torch

from llm_np_cp_tpu_torch import random as _random
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library

# categorical's first pass: elements of a row one block reduces (256
# threads x 8); csrc/threefry.cu's kChunk
CATEGORICAL_CHUNK = 2048


def _check_keys(name: str, keys: torch.Tensor, rows: int) -> None:
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, got {keys.dtype}")
    if keys.shape != (2,) and keys.shape != (rows, 2):
        raise ValueError(f"{name}: keys must be [2] or [{rows}, 2], got {tuple(keys.shape)}")
    _common.check_contiguous(name, keys=keys)


def threefry2x32(keys: torch.Tensor, n: int, cols: int, data: torch.Tensor | None, mode: int,
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The hash over ``n`` counters: keys ``[2]`` (counters 0..n-1) or a
    key per row of ``cols`` (``[n / cols, 2]``, counters the index in the
    row); ``data`` (int32 ``[n]``) makes the counters ``(0, data)``.
    ``mode`` (``random.PAIR`` / ``BITS`` / ``UNIFORM``) picks the output:
    int32 ``[n, 2]``, int32 ``[n]`` or float32 ``[n]`` in [minval, maxval).

    CPU tensors run ``random.words_plain``; CUDA tensors launch the kernel
    or raise."""
    cols = max(int(cols), 1)
    tensors = (keys,) if data is None else (keys, data)
    if _common.on_cpu(*tensors):
        return _random.words_plain(keys, n, cols, data, mode, minval, maxval)
    _check_keys("threefry2x32", keys, n // cols)
    if n % cols:
        raise ValueError(f"threefry2x32: {n} counters are not rows of {cols}")
    if data is not None:
        if data.dtype != torch.int32 or data.numel() != n:
            raise ValueError(f"threefry2x32: data must be int32 [{n}], got {data.dtype} "
                             f"{tuple(data.shape)}")
        _common.check_contiguous("threefry2x32", data=data)
    if mode not in (_random.PAIR, _random.BITS, _random.UNIFORM):
        raise ValueError(f"threefry2x32: unknown mode {mode}")
    shape = (n, 2) if mode == _random.PAIR else (n,)
    out = torch.empty(shape, dtype=torch.float32 if mode == _random.UNIFORM else torch.int32,
                      device=keys.device)
    lo = np.float32(minval)
    err = library().threefry2x32_launch(
        keys.data_ptr(), int(keys.dim() == 2), 0 if data is None else data.data_ptr(),
        out.data_ptr(), n, cols, mode, float(lo), float(np.float32(maxval) - lo),
        _common.stream_ptr(keys))
    check(err, "threefry2x32")
    _common.count(threefry2x32, "launches")
    return out


threefry2x32.launches = 0


def categorical(keys: torch.Tensor, logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """One Gumbel-max draw per row of float32 logits ``[N, V]`` under keys
    ``[2]`` (counters ``(row0 + n) * V + v``: these rows are rows row0...
    of a larger draw, a data-parallel rank's share) or ``[N, 2]``
    (counters ``v``) → int32 ``[N]``, the first index on ties.

    CPU tensors run ``random.categorical_plain``; CUDA tensors launch the
    kernel (two passes: row chunks, then each row's chunks) or raise."""
    if row0 < 0:
        raise ValueError(f"categorical: row0 must be >= 0, got {row0}")
    if _common.on_cpu(keys, logits):
        return _random.categorical_plain(keys, logits, row0)
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(f"categorical: logits must be float32 [N, V], got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    n, v = logits.shape
    _check_keys("categorical", keys, n)
    _common.check_contiguous("categorical", logits=logits)
    splits = -(-v // CATEGORICAL_CHUNK)
    part_val = torch.empty((n, splits), dtype=torch.float32, device=logits.device)
    part_idx = torch.empty((n, splits), dtype=torch.int32, device=logits.device)
    out = torch.empty((n,), dtype=torch.int32, device=logits.device)
    err = library().categorical_launch(
        keys.data_ptr(), int(keys.dim() == 2), logits.data_ptr(), part_val.data_ptr(),
        part_idx.data_ptr(), out.data_ptr(), n, v, splits, int(row0),
        _common.stream_ptr(logits))
    check(err, "categorical")
    _common.count(categorical, "launches")
    return out


categorical.launches = 0

"""Counter-based random draws: the ``jax.random`` subset the JAX package
uses, drawing the same bits.

jax's default generator is threefry2x32 in its partitionable mode
(``jax_threefry_partitionable``, the default since jax 0.5): element ``i``
of a draw over ``shape`` hashes the 64-bit counter ``i`` (its high and low
words) under the key, and a 32-bit draw takes ``bits1 ^ bits2``.  That is
a pure function of (key, counter), so the card computes the same words as
XLA does on the CPU or a TPU, and a draw depends on device operands alone
(a captured step can take it).  Keys are ``[..., 2]`` int32 tensors
holding the uint32 words of a jax key.

- ``PRNGKey(seed)``: ``[0, seed mod 2**32]`` (jax with 64-bit types off;
  a tensor of seeds gives a key per seed).
- ``split(key, num)``: keys ``[num, 2]``, the hash of counters 0..num-1.
- ``fold_in(key, data)``: the hash of the counter ``(0, data)``; keys
  ``[N, 2]`` with ``data [N]`` fold row by row.
- ``random_bits``, ``uniform``, ``gumbel`` (jax's ``"low"`` mode) and
  ``categorical`` (the Gumbel-max draw, first index on ties).

A draw takes one key, its counters running over the whole ``shape``, or
keys ``[N, 2]`` with ``shape[0] == N``: row n then draws under key n with
counters running over the row from 0, which is what ``jax.vmap`` over
one key a row gives (the serve engine keys each row by (seed, position)).

The functions run on any device: tensors on the CPU take the plain
versions below (``hash_plain``, ``words_plain``, ``categorical_plain``),
tensors on the card the kernels of ``ops/cuda/threefry.py`` (the hash,
and the fused categorical that reads the logits once).  The tests hold
the plain versions against ``jax.random`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal: gumbel's uniform floor (jax's finfo.tiny)
TINY = float(np.finfo(np.float32).tiny)

# what a draw writes: the two hash words, their xor, or a uniform float
PAIR, BITS, UNIFORM = 0, 1, 2


def _kernels():
    from llm_np_cp_tpu_torch.ops.cuda import threefry

    return threefry


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their uint32 values in int64."""
    return t.to(torch.int64) & MASK


def _i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 → int32 bit patterns."""
    return torch.where(t > 0x7FFFFFFF, t - (1 << 32), t).to(torch.int32)


def hash_plain(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
               x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32: 20 rounds over the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``, with the key injected every 4 rounds.  Every
    argument is an int64 tensor of uint32 values (broadcast together);
    returns the two hashed words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _keys_rows(keys: torch.Tensor, n: int, cols: int) -> tuple[torch.Tensor, torch.Tensor,
                                                                 torch.Tensor]:
    """Each of the ``n`` elements' key words and 64-bit counter (int64,
    a uint64 below 2**63): one key, the flat index; a key per row of
    ``cols`` elements, the index within the row."""
    m = torch.arange(n, dtype=torch.int64, device=keys.device)
    if keys.dim() == 1:
        k = _u32(keys)
        return k[0], k[1], m
    rows = _u32(keys).repeat_interleave(cols, dim=0)
    return rows[:, 0], rows[:, 1], m % cols


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """32-bit words (uint32 values in int64) → float32 in [minval, maxval),
    as jax's ``_uniform``: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, then ``f * (maxval - minval) + minval`` rounded once
    (XLA fuses it into an FMA; the float64 product of two float32 values
    is exact) and ``max(minval, ·)``."""
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    f = _i32((bits >> 9) | 0x3F800000).view(torch.float32) - 1.0
    u = (f.double() * float(scale) + float(lo)).float()
    return torch.clamp_min(u, float(lo))


def words_plain(keys: torch.Tensor, n: int, cols: int, data: torch.Tensor | None,
                mode: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The plain version of the ``threefry2x32`` kernel over ``n``
    elements: keys ``[2]`` (one key, counters the flat index) or
    ``[n / cols, 2]`` (a key per row of ``cols``, counters the index in
    the row); ``data`` (int32 ``[n]``) replaces the counter by
    ``(0, data)`` (``fold_in``).  ``mode``: PAIR → int32 ``[n, 2]``,
    BITS → int32 ``[n]`` (``bits1 ^ bits2``), UNIFORM → float32 ``[n]``."""
    k0, k1, c = _keys_rows(keys, n, cols)
    if data is not None:
        x0, x1 = torch.zeros_like(c), _u32(data.reshape(-1))
    else:
        x0, x1 = c >> 32, c & MASK
    y0, y1 = hash_plain(k0, k1, x0, x1)
    if mode == PAIR:
        return _i32(torch.stack([y0, y1], dim=-1))
    if mode == BITS:
        return _i32(y0 ^ y1)
    return uniform_from_bits(y0 ^ y1, minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax's ``"low"`` gumbel: ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform_from_bits(bits, TINY, 1.0)))


def categorical_plain(keys: torch.Tensor, logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The plain version of the ``categorical`` kernel: logits ``[N, V]``
    (float32), keys ``[2]`` (counters ``(row0 + n) * V + v``) or ``[N, 2]``
    (counters ``v``) → int32 ``[N]``, the argmax of gumbel + logits (the
    first index on ties)."""
    n, v = logits.shape
    k0, k1, c = _keys_rows(keys, n * v, v)
    if keys.dim() == 1:
        c = c + row0 * v
    y0, y1 = hash_plain(k0, k1, c >> 32, c & MASK)
    g = gumbel_from_bits(y0 ^ y1).view(n, v)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


# ----------------------------------------------------------------------
# The jax.random API
# ----------------------------------------------------------------------

def _check_keys(keys: torch.Tensor, shape: tuple[int, ...]) -> None:
    if keys.dtype != torch.int32 or keys.shape[-1:] != (2,) or keys.dim() > 2:
        raise ValueError(f"keys must be int32 [2] or [N, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.dim() == 2 and (not shape or shape[0] != keys.shape[0]):
        raise ValueError(f"{keys.shape[0]} keys for a draw of shape {shape}: a key per "
                         "row needs shape[0] == N")


def _draw(keys: torch.Tensor, shape: tuple[int, ...], mode: int, minval: float = 0.0,
          maxval: float = 1.0) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    _check_keys(keys, shape)
    n = int(np.prod(shape))
    cols = n // shape[0] if keys.dim() == 2 and n else max(n, 1)
    out = _kernels().threefry2x32(keys.contiguous(), n, cols, None, mode, minval, maxval)
    return out.view(*shape, 2) if mode == PAIR else out.view(shape)


def PRNGKey(seed: int | torch.Tensor, device: str | torch.device | None = None) -> torch.Tensor:
    """jax's legacy key of ``seed`` with 64-bit types off: ``[0, seed mod
    2**32]``.  A tensor of seeds ``[N]`` gives keys ``[N, 2]`` on its
    device, with no host copy (a captured step can take it)."""
    if isinstance(seed, torch.Tensor):
        lo = seed.to(torch.int32)  # the low word's bit pattern
        return torch.stack([torch.zeros_like(lo), lo], dim=-1)
    lo = int(seed) & MASK
    return torch.tensor([0, lo - (1 << 32) if lo > 0x7FFFFFFF else lo], dtype=torch.int32,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys ``[num, 2]`` from one key ``[2]`` (jax's fold-like
    split: the hash of counters 0..num-1)."""
    if key.shape != (2,):
        raise ValueError(f"split takes one key [2], got {tuple(key.shape)}")
    return _draw(key, (num,), PAIR)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """The key ``key`` with ``data`` (a 32-bit integer) folded in: the
    hash of the counter ``(0, data)``.  Keys ``[N, 2]`` with ``data [N]``
    fold each row's own (jax's ``vmap(fold_in)``)."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data) & MASK, dtype=torch.int64, device=key.device)
    data = _i32(data.to(torch.int64) & MASK) if data.dtype != torch.int32 else data
    n = data.numel()
    if key.dim() == 2 and key.shape[0] != n or key.dim() == 1 and n != 1:
        raise ValueError(f"fold_in: keys {tuple(key.shape)} and data {tuple(data.shape)} "
                         "do not pair up")
    _check_keys(key, (n,) if key.dim() == 2 else ())
    out = _kernels().threefry2x32(key.contiguous(), n, 1, data.reshape(-1).contiguous(),
                                  PAIR, 0.0, 1.0)
    return out.view(key.shape)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit words (int32 bit patterns) of ``shape``: ``bits1 ^ bits2``."""
    return _draw(key, shape, BITS)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) of ``shape``."""
    return _draw(key, shape, UNIFORM, minval, maxval)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel float32 draws of ``shape`` (jax's ``"low"`` mode)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """One draw per row from softmax(logits) over the last axis: the
    argmax of gumbel + logits (int32, the first index on ties).  One key
    ``[2]`` draws over every element of ``logits``; keys ``[N, 2]`` key
    each of the N rows (``logits.shape[:-1]`` flattened) on its own.
    ``row0``: with one key, ``logits`` are the rows from ``row0`` on of a
    larger draw (a data-parallel rank's rows), whose bits they take."""
    lead = logits.shape[:-1]
    rows = logits.reshape(-1, logits.shape[-1]).float().contiguous()
    _check_keys(key, (rows.shape[0],))
    return _kernels().categorical(key.contiguous(), rows, row0).view(lead)

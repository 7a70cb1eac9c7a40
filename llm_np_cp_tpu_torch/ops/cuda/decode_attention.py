"""Decode-step attention kernels: the static cache slab and the paged pool.

Port of the three kernels of ``llm_np_cp_tpu/ops/pallas/decode_attention.py``,
each with its plain PyTorch version beside it:

- ``decode_attention`` (``csrc/decode_attention.cu``): one token per row
  over a contiguous [B, S, K, D] cache slab.  Mask-driven like the TPU
  kernel: the caller passes the same [B, S] bool mask the plain path uses
  (cache validity, causality, sliding window, ragged-batch pads), and only
  the kv blocks between each row's first and last visible slot are read.
  Split-KV: ``split_plan`` cuts each row's visible band into NSPLIT
  contiguous ranges, one block each, whose float32 partials a second
  kernel combines (``csrc/split_kv.cuh``); ``decode_attention_split`` /
  ``combine_splits`` launch the two halves alone, beside their plain
  versions.  The TPU kernel's block-size search and cache padding exist
  for Mosaic's tiling rules and are not ported.
- ``paged_decode_attention`` (``csrc/paged_decode_attention.cu``): one
  token per row straight off the serving engine's paged pool through block
  tables; row b sees logical slots ``[pads[b], lengths[b])``.  Split-KV
  like the slab kernel (the two share ``csrc/split_decode.cuh``), planned
  over the table width MB*BS; ``paged_decode_attention_split`` launches
  the split kernel alone.
- ``ragged_paged_attention`` (``csrc/ragged_paged_attention.cu``): the
  unified tick's mixed prefill + decode batch, packed in
  ``RAGGED_Q_TILE``-token query tiles, off the paged pool.  Split-KV over
  each tile's band (``ragged_split_plan``, from the shapes alone); decode
  tiles run the split decode kernels' kv loop, bf16 prefill tiles the
  tensor cores; ``ragged_paged_attention_split`` launches the kernel
  alone.

A query with nothing visible yields zeros in all three.  The kernels use
the classic online softmax where the TPU kernels keep an AMLA ln2-grid
running max (``csrc/paged_attention.cuh`` says why it does not matter);
the plain versions take the global max.
"""

from __future__ import annotations

import ctypes

import torch

from llm_np_cp_tpu_torch.ops.attention import NEG_INF
from llm_np_cp_tpu_torch.ops.activations import softcap as _softcap
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library


def _check_int8(k, v, k_scale, v_scale) -> bool:
    quantized = k_scale is not None
    if (
        quantized != (k.dtype == torch.int8)
        or quantized != (v.dtype == torch.int8)
        or quantized != (v_scale is not None)
    ):
        raise ValueError(
            "int8 k AND v require both k_scale and v_scale (and vice "
            f"versa); got k={k.dtype}, v={v.dtype}, "
            f"k_scale={'set' if k_scale is not None else None}, "
            f"v_scale={'set' if v_scale is not None else None}"
        )
    return quantized


# query-tile width of the ragged kernel's packed token axis: each engine
# row's segment starts on a multiple of it, so every tile has one owner
RAGGED_Q_TILE = 8

def _tile(d: int) -> int:
    """Slots per kv tile of the split decode kernels (``DecodeTile`` in
    ``csrc/split_decode.cuh``)."""
    return 32 if d == 256 else 64


# query heads one block of a split decode kernel takes (kGC in split_decode.cuh)
_HEADS_PER_BLOCK = 4


def split_plan(b: int, kh: int, s: int, d: int, sm_count: int, g: int = _HEADS_PER_BLOCK,
               min_tiles: int = 2) -> int:
    """NSPLIT of a split decode kernel's (kh * ceil(g/4), b, NSPLIT) grid
    (slab, or paged over the table width; the ragged kernel's b is its q
    tiles) for ``g`` query heads per kv head and ``s`` slots: as many
    blocks as fit on the card at
    once, two per SM — a block more would wait for a second wave — with
    at least ``min_tiles`` kv tiles per split; never more splits than
    tiles, never fewer than 1.  It reads shapes only, so it costs no host
    sync."""
    tiles = -(-s // _tile(d))
    rows = max(b * kh * -(-g // _HEADS_PER_BLOCK), 1)
    return max(1, min(2 * sm_count // rows, tiles // min_tiles))


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _dequant(q, k, v, k_scale, v_scale):
    """An int8 cache dequantised in q's dtype (the kernel's rounding)."""
    if k_scale is None:
        return k, v
    return (k.to(q.dtype) * k_scale[..., None].to(q.dtype),
            v.to(q.dtype) * v_scale[..., None].to(q.dtype))


def _scores(q, k, scale, logit_softcap) -> torch.Tensor:
    """float32 scores [B, K, G, S] of q [B, 1, H, D] against k [B, S, K, D]."""
    b, _, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    return _softcap(s, logit_softcap) if logit_softcap is not None else s


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: float32 scores,
    unnormalised p zeroed on masked slots, p rounded to the value dtype
    before the PV product, division by the float32 sum (zeros where it
    is 0).  An int8 cache is dequantised in q's dtype first."""
    b, _, h, d = q.shape
    k, v = _dequant(q, k, v, k_scale, v_scale)
    s = _scores(q, k, scale, logit_softcap)
    vis = mask[:, None, None, :]
    s = torch.where(vis, s, NEG_INF)
    p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_bounds(mask: torch.Tensor, nsplit: int, bs: int) -> torch.Tensor:
    """[B, nsplit + 1] tile boundaries: split i of row b attends tiles
    ``[bounds[b, i], bounds[b, i + 1])`` — the n tiles of the row's
    visible band cut into equal contiguous ranges, as the kernel cuts
    them (an empty row has none)."""
    s = mask.shape[1]
    pos = torch.arange(s, device=mask.device)
    first = torch.where(mask, pos, s).amin(dim=1)
    last = torch.where(mask, pos, -1).amax(dim=1)
    t0 = torch.where(last >= 0, first // bs, 0)
    n = torch.where(last >= 0, last // bs - t0 + 1, 0)
    i = torch.arange(nsplit + 1, device=mask.device)
    return t0[:, None] + (i[None, :] * n[:, None]) // nsplit


def decode_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    nsplit: int, k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the split kernel: each split's float32 partials
    over its range of the row's visible band → (acc [B, K, nsplit, G, D],
    m [B, K, nsplit, G], l [B, K, nsplit, G]).  ``m`` is the split's max
    score (NEG_INF where it sees nothing), ``l`` its sum of unrounded p,
    ``acc`` the sum of p rounded to the value dtype times V; a split with
    nothing visible gives l = 0 and acc = 0."""
    bounds = _split_bounds(mask, nsplit, _tile(q.shape[-1]))
    return _split_partials(q, k, v, mask, bounds, k_scale, v_scale, scale, logit_softcap)


def _split_partials(q, k, v, mask, bounds, k_scale, v_scale, scale, logit_softcap):
    """The partials of ``decode_attention_split_plain`` with split i of row
    b over the kv tiles ``[bounds[b, i], bounds[b, i + 1])``."""
    d = q.shape[-1]
    k, v = _dequant(q, k, v, k_scale, v_scale)
    s = _scores(q, k, scale, logit_softcap)
    tile = torch.arange(k.shape[1], device=q.device) // _tile(d)
    part = (tile >= bounds[:, :-1, None]) & (tile < bounds[:, 1:, None])  # [B, N, S]
    vis = (mask[:, None, :] & part)[:, None, :, None, :]  # [B, 1, N, 1, S]
    sv = torch.where(vis, s[:, :, None], NEG_INF)  # [B, K, N, G, S]
    m = sv.amax(dim=-1)
    p = torch.where(vis, torch.exp(sv - m[..., None]), 0.0)
    acc = torch.einsum("bkngs,bskd->bkngd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


def combine_splits_plain(
    acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of the combine (``csrc/split_kv.cuh``): acc [..., N,
    G, D], m / l [..., N, G] float32 → [..., G, D] in ``dtype``.  With
    M the max m over the splits with l > 0 and w = exp(m - M) there (0
    elsewhere): sum w*acc / sum w*l, zeros where that sum is 0.  A split
    with l = 0 never enters (its acc may be unwritten scratch)."""
    live = l > 0.0
    mx = torch.where(live, m, NEG_INF).amax(dim=-2, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    den = (w * l).sum(dim=-2)[..., None]
    num = torch.where(live[..., None], w[..., None] * acc, 0.0).sum(dim=-3)
    return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 0.0).to(dtype)


def _check_decode(name: str, q, k, v, mask, k_scale, v_scale) -> bool:
    """Shape checks of the slab wrappers; returns whether the cache is int8."""
    quantized = _check_int8(k, v, k_scale, v_scale)
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"{name} is q_len=1 only, got {one}")
    _, s, kh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if mask.shape != (b, s) or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be bool [{b}, {s}], got {mask.dtype} {tuple(mask.shape)}")
    if quantized and (k_scale.shape != (b, s, kh) or v_scale.shape != (b, s, kh)):
        raise ValueError(f"{name}: scales must be [{b}, {s}, {kh}]")
    return quantized


def _check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """The split kernels copy K/V (and the ragged kernel's prefill tiles
    q) in 16-byte vectors (``cp.async``)."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned (the kernel loads 16-byte "
                             "vectors)")


def _partials(q: torch.Tensor, b: int, kh: int, nsplit: int, g: int, d: int,
              zeroed: bool = False):
    """One float32 scratch buffer for the split kernel's partials, acc [B,
    K, N, G, D] then m and l [B, K, N, G]: (the buffer, their three
    pointers).  ``zeroed``: for a kernel that leaves some acc unwritten."""
    n = b * kh * nsplit * g
    buf = (torch.zeros if zeroed else torch.empty)(n * (d + 2), dtype=torch.float32,
                                                   device=q.device)
    base = buf.data_ptr()
    return buf, (base, base + 4 * n * d, base + 4 * n * (d + 1))


def _partial_views(buf: torch.Tensor, b: int, kh: int, nsplit: int, g: int, d: int):
    """``_partials``' buffer as (acc, m, l)."""
    n = b * kh * nsplit * g
    return (buf[: n * d].view(b, kh, nsplit, g, d),
            buf[n * d: n * (d + 1)].view(b, kh, nsplit, g),
            buf[n * (d + 1):].view(b, kh, nsplit, g))


def _launch_decode(name: str, q, k, v, mask, k_scale, v_scale, scale, logit_softcap,
                   nsplit: int, out):
    """The kernel-side checks, then ``decode_attention_launch``: with
    ``out`` the output (split kernel, then the combine when nsplit > 1),
    without it the partials alone.  Returns (the kernels the C entry
    reports it launched, the partials (acc, m, l) or None with ``out``)."""
    quantized = k_scale is not None
    code = _common.dtype_code(name, q.dtype)
    if not quantized and k.dtype != q.dtype:
        raise TypeError(f"{name}: k/v dtype {k.dtype} != q dtype {q.dtype}")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: int8 scales must be float32")
    b, _, h, d = q.shape
    _, s, kh, _ = k.shape
    g = h // kh
    _common.check_head_dim(name, d)
    if g * d > 2048:
        raise ValueError(f"{name}: query group x head_dim {g * d} > 2048")
    _common.check_contiguous(name, q=q, k=k, v=v, mask=mask)
    if quantized:
        _common.check_contiguous(name, k_scale=k_scale, v_scale=v_scale)
    _check_aligned(name, k=k, v=v)
    buf, ptrs = None, (None, None, None)
    if out is None or nsplit > 1:
        buf, ptrs = _partials(q, b, kh, nsplit, g, d)
    launched = ctypes.c_int(0)
    err = library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        mask.data_ptr(), out.data_ptr() if out is not None else None, *ptrs,
        b, s, h, kh, d, nsplit, float(scale), float(logit_softcap or 0.0), code, int(quantized),
        _common.stream_ptr(q), ctypes.addressof(launched),
    )
    check(err, name)
    return launched.value, _partial_views(buf, b, kh, nsplit, g, d) if out is None else None


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """One-token GQA attention against the cache.

    q [B, 1, H, D], k/v [B, S, K, D], mask [B, S] bool (True = visible)
    → [B, 1, H, D].  int8 cache mode: k/v int8 with ``k_scale``/``v_scale``
    [B, S, K] float32 (``cache.quantize_kv`` layout).

    CPU tensors run ``decode_attention_plain``; CUDA tensors launch the
    split kernel over ``split_plan``'s NSPLIT ranges of each row's band
    and, when NSPLIT > 1, the combine, or raise.  ``launches`` counts the
    split kernel's launches and ``combine_launches`` the combine's, as the
    C entry reports them.
    """
    quantized = _check_decode("decode_attention", q, k, v, mask, k_scale, v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k, v, mask, *scales):
        return decode_attention_plain(
            q, k, v, mask, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    b, _, h, d = q.shape
    nsplit = split_plan(b, k.shape[2], k.shape[1], d, sm_count(q.device), h // k.shape[2])
    out = torch.empty_like(q)
    launched, _ = _launch_decode("decode_attention", q, k, v, mask, k_scale, v_scale, scale,
                                 logit_softcap, nsplit, out)
    _common.count(decode_attention, "launches", int(launched >= 1))
    _common.count(decode_attention, "combine_launches", int(launched >= 2))
    return out


decode_attention.launches = 0
decode_attention.combine_launches = 0


def decode_attention_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
    nsplit: int, k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split kernel alone, over ``nsplit`` ranges: its float32 partials
    (acc, m, l) as ``decode_attention_split_plain`` returns them.  For the
    card tests and ``chip_smoke.py``; CPU tensors run the plain version."""
    if nsplit < 1:
        raise ValueError(f"decode_attention_split: nsplit must be >= 1, got {nsplit}")
    quantized = _check_decode("decode_attention_split", q, k, v, mask, k_scale, v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k, v, mask, *scales):
        return decode_attention_split_plain(
            q, k, v, mask, nsplit=nsplit, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    launched, parts = _launch_decode("decode_attention_split", q, k, v, mask, k_scale, v_scale,
                                     scale, logit_softcap, nsplit, None)
    _common.count(decode_attention_split, "launches", launched)
    return parts


decode_attention_split.launches = 0

# the combine keeps its weights in shared memory (csrc/split_kv.cuh)
_COMBINE_MAX_SMEM = 227 * 1024


def combine_splits(
    acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, dtype: torch.dtype,
) -> torch.Tensor:
    """The combine alone: acc [..., N, G, D], m / l [..., N, G] float32 →
    [..., G, D] in ``dtype`` (``combine_splits_plain``'s function).  For
    the card tests and ``chip_smoke.py``; CPU tensors run the plain
    version, CUDA tensors launch the kernel or raise."""
    if acc.ndim < 3 or m.shape != acc.shape[:-1] or l.shape != m.shape:
        raise ValueError(f"combine_splits: acc {tuple(acc.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)}")
    if _common.on_cpu(acc, m, l):
        return combine_splits_plain(acc, m, l, dtype)
    code = _common.dtype_code("combine_splits", dtype)
    if {acc.dtype, m.dtype, l.dtype} != {torch.float32}:
        raise TypeError("combine_splits: partials must be float32")
    _common.check_contiguous("combine_splits", acc=acc, m=m, l=l)
    n, g, d = acc.shape[-3:]
    if 4 * (n * g + g) > _COMBINE_MAX_SMEM:
        raise ValueError(f"combine_splits: {n} splits x {g} rows exceed shared memory")
    out = torch.empty((*acc.shape[:-3], g, d), dtype=dtype, device=acc.device)
    r = out.numel() // max(g * d, 1)
    err = library().split_kv_combine_launch(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), r, n, g, d, code,
        _common.stream_ptr(acc),
    )
    check(err, "combine_splits")
    _common.count(combine_splits, "launches")
    return out


combine_splits.launches = 0


# ----------------------------------------------------------------------
# paged pool kernels
# ----------------------------------------------------------------------

def _gather_rows(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[NB, BS, *t] pool pages → the rows' contiguous [R, MB*BS, *t] views."""
    r, mb = tables.shape
    return pages[tables.long()].reshape(r, mb * pages.shape[1], *pages.shape[2:])


def _paged_views(q, k_pages, v_pages, tables, lengths, pads, k_scale, v_scale):
    """The rows' gathered contiguous K/V views and the mask ``pads <= pos <
    lengths``: (k, v, mask, scale kwargs) for the slab's plain versions."""
    s = tables.shape[1] * k_pages.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = (pos >= pads.long()[:, None]) & (pos < lengths.long()[:, None])
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=_gather_rows(k_scale, tables), v_scale=_gather_rows(v_scale, tables))
    return _gather_rows(k_pages, tables), _gather_rows(v_pages, tables), mask, scales


def paged_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, pads: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather each row's blocks into a contiguous
    view and run ``decode_attention_plain`` with the mask
    ``pads <= pos < lengths`` (the kernel's numerics)."""
    k, v, mask, scales = _paged_views(q, k_pages, v_pages, tables, lengths, pads, k_scale, v_scale)
    return decode_attention_plain(q, k, v, mask, scale=scale, logit_softcap=logit_softcap,
                                  **scales)


def paged_decode_attention_split_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, pads: torch.Tensor, *,
    nsplit: int, k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the paged split kernel: the gathered views and the
    mask ``pads <= pos < lengths`` through ``decode_attention_split_plain``.
    The mask's visible band is ``[max(pads, 0), min(lengths, MB*BS))``, the
    kernel's band, so the splits cut the same tiles."""
    k, v, mask, scales = _paged_views(q, k_pages, v_pages, tables, lengths, pads, k_scale, v_scale)
    return decode_attention_split_plain(q, k, v, mask, nsplit=nsplit, scale=scale,
                                        logit_softcap=logit_softcap, **scales)


def _check_pages(name: str, q_heads: int, d: int, k_pages, v_pages, k_scale, v_scale) -> bool:
    quantized = _check_int8(k_pages, v_pages, k_scale, v_scale)
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"{name}: k/v pages must be [NB, BS, K, {d}], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if q_heads % k_pages.shape[2]:
        raise ValueError(f"{name}: {q_heads} query heads over {k_pages.shape[2]} kv heads")
    if quantized and (k_scale.shape != k_pages.shape[:3] or v_scale.shape != k_pages.shape[:3]):
        raise ValueError(f"{name}: scale pages must be {tuple(k_pages.shape[:3])}")
    return quantized


def _check_launch(name: str, q, k_pages, v_pages, quantized, k_scale, v_scale, **ints) -> int:
    """The kernel-side checks of both paged wrappers (``ints``: the int32
    index operands); returns the dtype code."""
    code = _common.dtype_code(name, q.dtype)
    if not quantized and k_pages.dtype != q.dtype:
        raise TypeError(f"{name}: pages dtype {k_pages.dtype} != q dtype {q.dtype}")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: int8 scale pages must be float32")
    _common.check_head_dim(name, q.shape[-1])
    for arg, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    _common.check_contiguous(name, q=q, k_pages=k_pages, v_pages=v_pages, **ints)
    if quantized:
        _common.check_contiguous(name, k_scale=k_scale, v_scale=v_scale)
    return code


def _check_paged_decode(name: str, q, k_pages, v_pages, tables, lengths, pads, k_scale,
                        v_scale) -> bool:
    """Shape checks of the paged decode wrappers; returns whether the pool
    is int8."""
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"{name} is q_len=1 only, got {one}")
    quantized = _check_pages(name, h, d, k_pages, v_pages, k_scale, v_scale)
    if tables.ndim != 2 or tables.shape[0] != b or lengths.shape != (b,) or pads.shape != (b,):
        raise ValueError(
            f"{name}: tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}, pads {tuple(pads.shape)} for batch {b}")
    return quantized


def paged_split_plan(q: torch.Tensor, k_pages: torch.Tensor, tables: torch.Tensor) -> int:
    """NSPLIT of the paged kernel on this card: ``split_plan`` over the
    table width MB*BS (the lengths live on the card)."""
    b, _, h, d = q.shape
    kh = k_pages.shape[2]
    return split_plan(b, kh, tables.shape[1] * k_pages.shape[1], d, sm_count(q.device), h // kh)


def _launch_paged(name: str, q, k_pages, v_pages, tables, lengths, pads, k_scale, v_scale,
                  scale, logit_softcap, nsplit: int, out):
    """The kernel-side checks, then ``paged_decode_attention_launch``: with
    ``out`` the output (split kernel, then the combine when nsplit > 1),
    without it the partials alone.  Returns (the kernels the C entry
    reports it launched, the partials (acc, m, l) or None with ``out``)."""
    quantized = k_scale is not None
    code = _check_launch(name, q, k_pages, v_pages, quantized, k_scale, v_scale, tables=tables,
                         lengths=lengths, pads=pads)
    _check_aligned(name, k_pages=k_pages, v_pages=v_pages)
    b, _, h, d = q.shape
    _, bs, kh, _ = k_pages.shape
    g = h // kh
    buf, ptrs = None, (None, None, None)
    if out is None or nsplit > 1:
        buf, ptrs = _partials(q, b, kh, nsplit, g, d)
    launched = ctypes.c_int(0)
    err = library().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), pads.data_ptr(),
        out.data_ptr() if out is not None else None, *ptrs,
        b, tables.shape[1], bs, h, kh, d, nsplit, float(scale), float(logit_softcap or 0.0), code,
        int(quantized), _common.stream_ptr(q), ctypes.addressof(launched),
    )
    check(err, name)
    return launched.value, _partial_views(buf, b, kh, nsplit, g, d) if out is None else None


def paged_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, pads: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """One-token GQA attention straight off a paged KV pool.

    q [B, 1, H, D]; k_pages/v_pages [NB, BS, K, D] (one layer's pool
    slab); tables [B, MB] int32 block ids (scratch-0 padded past each
    row's allocation); lengths [B] int32 visible slots per row (the
    current token's K/V already written at slot lengths-1); pads [B]
    int32 left-pad slots to skip → [B, 1, H, D].  Row b sees pool slot
    ``tables[b, pos // BS] * BS + pos % BS`` for ``pads[b] <= pos <
    lengths[b]``.  int8 pool: k/v pages int8 with ``k_scale``/``v_scale``
    [NB, BS, K] float32 scale pages.

    CPU tensors run ``paged_decode_attention_plain``; CUDA tensors launch
    the split kernel over ``paged_split_plan``'s NSPLIT ranges of each
    row's band and, when NSPLIT > 1, the combine, or raise.  ``launches``
    counts the split kernel's launches and ``combine_launches`` the
    combine's, as the C entry reports them.
    """
    name = "paged_decode_attention"
    quantized = _check_paged_decode(name, q, k_pages, v_pages, tables, lengths, pads, k_scale,
                                    v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, lengths, pads, *scales):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, tables, lengths, pads, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    out = torch.empty_like(q)
    launched, _ = _launch_paged(name, q, k_pages, v_pages, tables, lengths, pads, k_scale,
                                v_scale, scale, logit_softcap,
                                paged_split_plan(q, k_pages, tables), out)
    _common.count(paged_decode_attention, "launches", int(launched >= 1))
    _common.count(paged_decode_attention, "combine_launches", int(launched >= 2))
    return out


paged_decode_attention.launches = 0
paged_decode_attention.combine_launches = 0


def paged_decode_attention_split(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, pads: torch.Tensor, *,
    nsplit: int, k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paged split kernel alone, over ``nsplit`` ranges: its float32
    partials (acc, m, l) as ``paged_decode_attention_split_plain`` returns
    them.  For the card tests and ``chip_smoke.py``; CPU tensors run the
    plain version."""
    name = "paged_decode_attention_split"
    if nsplit < 1:
        raise ValueError(f"{name}: nsplit must be >= 1, got {nsplit}")
    quantized = _check_paged_decode(name, q, k_pages, v_pages, tables, lengths, pads, k_scale,
                                    v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, lengths, pads, *scales):
        return paged_decode_attention_split_plain(
            q, k_pages, v_pages, tables, lengths, pads, nsplit=nsplit, k_scale=k_scale,
            v_scale=v_scale, scale=scale, logit_softcap=logit_softcap,
        )
    launched, parts = _launch_paged(name, q, k_pages, v_pages, tables, lengths, pads, k_scale,
                                    v_scale, scale, logit_softcap, nsplit, None)
    _common.count(paged_decode_attention_split, "launches", launched)
    return parts


paged_decode_attention_split.launches = 0


def _ragged_views(q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, window,
                  k_scale, v_scale):
    """Every packed token's row view and its mask ``live ∧ kv >= pad ∧ kv >
    slot - window ∧ kv <= slot``: (q [T, 1, H, D], k, v [T, S, K, D], mask
    [T, S], scale kwargs) for the slab's plain versions."""
    lane = torch.arange(q.shape[0], device=q.device)
    tile = lane // RAGGED_Q_TILE
    lane = lane % RAGGED_Q_TILE
    row = tile_row.long()[tile]
    slot = tile_qpos0.long()[tile] + lane
    live = lane < tile_qlen.long()[tile]
    lower = torch.maximum(slot - int(window) + 1, pads.long()[row])
    s = tables.shape[1] * k_pages.shape[1]
    pos = torch.arange(s, device=q.device)[None, :]
    mask = live[:, None] & (pos >= lower[:, None]) & (pos <= slot[:, None])
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=_gather_rows(k_scale, tables)[row],
                      v_scale=_gather_rows(v_scale, tables)[row])
    return (q[:, None], _gather_rows(k_pages, tables)[row], _gather_rows(v_pages, tables)[row],
            mask, scales)


def ragged_paged_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, tile_row: torch.Tensor, tile_qpos0: torch.Tensor,
    tile_qlen: torch.Tensor, pads: torch.Tensor, window: int, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: every packed token attends its row's
    gathered view through ``decode_attention_plain`` with the kernel's
    per-token mask ``live ∧ kv >= pad ∧ kv > slot - window ∧ kv <= slot``
    (dead lanes and dead tiles give zeros)."""
    qt, k, v, mask, scales = _ragged_views(q, k_pages, v_pages, tables, tile_row, tile_qpos0,
                                           tile_qlen, pads, window, k_scale, v_scale)
    out = decode_attention_plain(qt, k, v, mask, scale=scale, logit_softcap=logit_softcap,
                                 **scales)
    return out[:, 0]


def _ragged_split_bounds(tile_row, tile_qpos0, tile_qlen, pads, window, s, nsplit, bs):
    """[NT, nsplit + 1] kv-tile boundaries of each q tile's splits: the
    tile's band ``[max(pad, qpos0 - window + 1, 0), min(qpos0 + qlen, s) -
    1]`` cut as ``_split_bounds`` cuts a row's (a dead tile has none)."""
    qpos0, qlen = tile_qpos0.long(), tile_qlen.long()
    first = torch.clamp(torch.maximum(pads.long()[tile_row.long()], qpos0 - int(window) + 1),
                        min=0)
    last = torch.clamp(qpos0 + qlen, max=s) - 1
    some = (qlen > 0) & (last >= first)
    t0 = torch.where(some, first // bs, 0)
    n = torch.where(some, last // bs - t0 + 1, 0)
    i = torch.arange(nsplit + 1, device=tile_row.device)
    return t0[:, None] + (i[None, :] * n[:, None]) // nsplit


def ragged_paged_attention_split_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, tile_row: torch.Tensor, tile_qpos0: torch.Tensor,
    tile_qlen: torch.Tensor, pads: torch.Tensor, window: int, *, nsplit: int,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the ragged kernel's split-KV partials: split i of
    a q tile attends kv tiles ``[bounds[i], bounds[i + 1])`` of the tile's
    band (``_ragged_split_bounds``) → (acc [NT, K, nsplit, 8*G, D], m / l
    [NT, K, nsplit, 8*G]), rows (lane, head), as
    ``decode_attention_split_plain`` defines them.  ``combine_splits_plain``
    of them is [NT, K, 8*G, D]; ``ragged_from_rows`` packs that as the
    output."""
    t, h, d = q.shape
    nt, kh = t // RAGGED_Q_TILE, k_pages.shape[2]
    qt, k, v, mask, scales = _ragged_views(q, k_pages, v_pages, tables, tile_row, tile_qpos0,
                                           tile_qlen, pads, window, k_scale, v_scale)
    bounds = _ragged_split_bounds(tile_row, tile_qpos0, tile_qlen, pads, window, mask.shape[1],
                                  nsplit, _tile(d))
    acc, m, l = _split_partials(qt, k, v, mask, bounds.repeat_interleave(RAGGED_Q_TILE, 0),
                                scales.get("k_scale"), scales.get("v_scale"), scale,
                                logit_softcap)
    # [T, K, N, G, ...] per token → [NT, K, N, 8*G, ...] per tile
    g = h // kh

    def rows(x):
        x = x.reshape(nt, RAGGED_Q_TILE, kh, nsplit, g, *x.shape[4:])
        return x.transpose(1, 2).transpose(2, 3).reshape(nt, kh, nsplit, RAGGED_Q_TILE * g,
                                                         *x.shape[5:])

    return rows(acc), rows(m), rows(l)


def ragged_from_rows(x: torch.Tensor) -> torch.Tensor:
    """The ragged kernel's per-tile rows [NT, K, 8*G, D] packed as its
    output [NT*8, K*G, D]."""
    nt, kh, rows, d = x.shape
    g = rows // RAGGED_Q_TILE
    return x.reshape(nt, kh, RAGGED_Q_TILE, g, d).transpose(1, 2).reshape(
        nt * RAGGED_Q_TILE, kh * g, d)


# kv tiles a split of the ragged kernel takes at least: below that the
# combine's ~5 us costs more than the split saves (PERF.md §6)
RAGGED_MIN_TILES = 4


def ragged_split_plan(q: torch.Tensor, k_pages: torch.Tensor, tables: torch.Tensor,
                      window: int) -> int:
    """NSPLIT of the ragged kernel on q's card: ``split_plan`` for the
    packed width's q tiles over the longest band a tile can have, the
    table width MB*BS or the window and the tile's tokens, with at least
    ``RAGGED_MIN_TILES`` kv tiles a split (the lengths live on the card).  A tick of many prefill tiles fills the
    card without a split; raising NSPLIT for its long decode rows only
    added partials and the combine (PERF.md §6)."""
    t, h, d = q.shape
    kh = k_pages.shape[2]
    s = min(tables.shape[1] * k_pages.shape[1], int(window) + RAGGED_Q_TILE - 1)
    return split_plan(t // RAGGED_Q_TILE, kh, s, d, sm_count(q.device), h // kh,
                      RAGGED_MIN_TILES)


def _check_ragged(name: str, q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads,
                  k_scale, v_scale) -> bool:
    """Shape checks of the ragged wrappers; returns whether the pool is int8."""
    t, h, d = q.shape
    if t % RAGGED_Q_TILE:
        raise ValueError(
            f"packed token axis ({t}) must be a multiple of RAGGED_Q_TILE ({RAGGED_Q_TILE})")
    nt = t // RAGGED_Q_TILE
    for arg, meta in (("tile_row", tile_row), ("tile_qpos0", tile_qpos0), ("tile_qlen", tile_qlen)):
        if meta.shape != (nt,):
            raise ValueError(
                f"tile metadata must have T/RAGGED_Q_TILE = {nt} entries, {arg} has "
                f"{tuple(meta.shape)}")
    quantized = _check_pages(name, h, d, k_pages, v_pages, k_scale, v_scale)
    if tables.ndim != 2 or pads.shape != (tables.shape[0],):
        raise ValueError(f"{name}: tables {tuple(tables.shape)} vs pads {tuple(pads.shape)}")
    return quantized


def _launch_ragged(name: str, q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen,
                   pads, window, k_scale, v_scale, scale, logit_softcap, nsplit: int, out):
    """The kernel-side checks, then ``ragged_paged_attention_launch``: with
    ``out`` the output (the kernel, then the combine when nsplit > 1),
    without it the partials alone.  Returns (the kernels the C entry
    reports it launched, the partials (acc, m, l) or None with ``out``)."""
    quantized = k_scale is not None
    code = _check_launch(name, q, k_pages, v_pages, quantized, k_scale, v_scale, tables=tables,
                         tile_row=tile_row, tile_qpos0=tile_qpos0, tile_qlen=tile_qlen,
                         pads=pads)
    # the bf16 prefill tiles copy q rows by 16-byte cp.async too
    _check_aligned(name, q=q, k_pages=k_pages, v_pages=v_pages)
    t, h, d = q.shape
    _, bs, kh, _ = k_pages.shape
    nt, rows = t // RAGGED_Q_TILE, RAGGED_Q_TILE * (h // kh)
    buf, ptrs = None, (None, None, None)
    if out is None or nsplit > 1:
        # the partials alone leave a dead lane's acc zero (unwritten), as
        # combine_splits reads it
        buf, ptrs = _partials(q, nt, kh, nsplit, rows, d, zeroed=out is None)
    launched = ctypes.c_int(0)
    err = library().ragged_paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), tile_row.data_ptr(), tile_qpos0.data_ptr(), tile_qlen.data_ptr(),
        pads.data_ptr(), out.data_ptr() if out is not None else None, *ptrs,
        nt, tables.shape[1], bs, h, kh, d, window, nsplit, float(scale),
        float(logit_softcap or 0.0), code, int(quantized), _common.stream_ptr(q),
        ctypes.addressof(launched),
    )
    check(err, name)
    return launched.value, _partial_views(buf, nt, kh, nsplit, rows, d) if out is None else None


def ragged_paged_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, tile_row: torch.Tensor, tile_qpos0: torch.Tensor,
    tile_qlen: torch.Tensor, pads: torch.Tensor, window: int, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Mixed prefill + decode GQA attention straight off a paged KV pool.

    q [T, H, D], the packed token axis (T a multiple of
    ``RAGGED_Q_TILE``; each row's segment at tile-aligned positions);
    k_pages/v_pages [NB, BS, K, D] (one layer's pool slab); tables
    [R, MB] int32; per tile (T / RAGGED_Q_TILE entries, int32):
    ``tile_row`` the owning engine row, ``tile_qpos0`` the cache slot of
    the tile's first token, ``tile_qlen`` its live tokens (0 = dead
    tile); pads [R] int32; ``window`` this layer's sliding window as an
    int (a huge value such as ``1 << 30`` on a global layer) → [T, H, D].
    Token i of a tile sees slots ``[max(pad, slot_i - window + 1),
    slot_i]`` with ``slot_i = tile_qpos0 + i``.  int8 pool: as
    ``paged_decode_attention``.

    CPU tensors run ``ragged_paged_attention_plain``; CUDA tensors launch
    the kernel over ``ragged_split_plan``'s NSPLIT ranges of each tile's
    band and, when NSPLIT > 1, the combine, or raise.  ``launches`` counts
    the kernel's launches and ``combine_launches`` the combine's, as the C
    entry reports them.
    """
    name = "ragged_paged_attention"
    quantized = _check_ragged(name, q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen,
                              pads, k_scale, v_scale)
    window = min(int(window), 2**31 - 1)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, *scales):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, window,
            k_scale=k_scale, v_scale=v_scale, scale=scale, logit_softcap=logit_softcap,
        )
    out = torch.empty_like(q)
    launched, _ = _launch_ragged(name, q, k_pages, v_pages, tables, tile_row, tile_qpos0,
                                 tile_qlen, pads, window, k_scale, v_scale, scale, logit_softcap,
                                 ragged_split_plan(q, k_pages, tables, window), out)
    _common.count(ragged_paged_attention, "launches", int(launched >= 1))
    _common.count(ragged_paged_attention, "combine_launches", int(launched >= 2))
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.combine_launches = 0


def ragged_paged_attention_split(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, tile_row: torch.Tensor, tile_qpos0: torch.Tensor,
    tile_qlen: torch.Tensor, pads: torch.Tensor, window: int, *, nsplit: int,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ragged kernel alone, over ``nsplit`` ranges of each tile's band:
    its float32 partials (acc, m, l) as ``ragged_paged_attention_split_plain``
    returns them.  For the card tests and ``chip_smoke.py``; CPU tensors
    run the plain version."""
    name = "ragged_paged_attention_split"
    if nsplit < 1:
        raise ValueError(f"{name}: nsplit must be >= 1, got {nsplit}")
    quantized = _check_ragged(name, q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen,
                              pads, k_scale, v_scale)
    window = min(int(window), 2**31 - 1)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, *scales):
        return ragged_paged_attention_split_plain(
            q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, window,
            nsplit=nsplit, k_scale=k_scale, v_scale=v_scale, scale=scale,
            logit_softcap=logit_softcap,
        )
    launched, parts = _launch_ragged(name, q, k_pages, v_pages, tables, tile_row, tile_qpos0,
                                     tile_qlen, pads, window, k_scale, v_scale, scale,
                                     logit_softcap, nsplit, None)
    _common.count(ragged_paged_attention_split, "launches", launched)
    return parts


ragged_paged_attention_split.launches = 0

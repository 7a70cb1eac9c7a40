"""Decode-step attention kernels: the static cache slab and the paged pool.

Port of the three kernels of ``llm_np_cp_tpu/ops/pallas/decode_attention.py``,
each with its plain PyTorch version beside it:

- ``decode_attention`` (``csrc/decode_attention.cu``): one token per row
  over a contiguous [B, S, K, D] cache slab.  Mask-driven like the TPU
  kernel: the caller passes the same [B, S] bool mask the plain path uses
  (cache validity, causality, sliding window, ragged-batch pads), and only
  the kv blocks between each row's first and last visible slot are read.
  The TPU kernel's block-size search and cache padding exist for Mosaic's
  tiling rules and are not ported.
- ``paged_decode_attention`` (``csrc/paged_decode_attention.cu``): one
  token per row straight off the serving engine's paged pool through block
  tables; row b sees logical slots ``[pads[b], lengths[b])``.
- ``ragged_paged_attention`` (``csrc/ragged_paged_attention.cu``): the
  unified tick's mixed prefill + decode batch, packed in
  ``RAGGED_Q_TILE``-token query tiles, off the paged pool.

A query with nothing visible yields zeros in all three.  The paged
kernels use the classic online softmax where the TPU kernels keep an AMLA
ln2-grid running max (``csrc/paged_attention.cuh`` says why it does not
matter); the plain versions take the global max.
"""

from __future__ import annotations

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

# the paged kernels hold nq*G*D outputs of a block in 256 threads x 32
_PAGED_MAX_OUT = 8192


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
    kh = k.shape[2]
    g = h // kh
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale[..., None].to(q.dtype)
        v = v.to(q.dtype) * v_scale[..., None].to(q.dtype)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if logit_softcap is not None:
        s = _softcap(s, logit_softcap)
    vis = mask[:, None, None, :]
    s = torch.where(vis, s, NEG_INF)
    p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, 1, h, d).to(q.dtype)


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
    kernel or raise.
    """
    quantized = _check_int8(k, v, k_scale, v_scale)
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"decode_attention is q_len=1 only, got {one}")
    _, s, kh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if mask.shape != (b, s) or mask.dtype != torch.bool:
        raise ValueError(f"decode_attention: mask must be bool [{b}, {s}], got {mask.dtype} {tuple(mask.shape)}")
    scales = (k_scale, v_scale) if quantized else ()
    if quantized and (k_scale.shape != (b, s, kh) or v_scale.shape != (b, s, kh)):
        raise ValueError(f"decode_attention: scales must be [{b}, {s}, {kh}]")
    if _common.on_cpu(q, k, v, mask, *scales):
        return decode_attention_plain(
            q, k, v, mask, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    code = _common.dtype_code("decode_attention", q.dtype)
    if not quantized and k.dtype != q.dtype:
        raise TypeError(f"decode_attention: k/v dtype {k.dtype} != q dtype {q.dtype}")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("decode_attention: int8 scales must be float32")
    _common.check_head_dim("decode_attention", d)
    if (h // kh) * d > 2048:
        raise ValueError(f"decode_attention: query group x head_dim {(h // kh) * d} > 2048")
    _common.check_contiguous("decode_attention", q=q, k=k, v=v, mask=mask)
    if quantized:
        _common.check_contiguous("decode_attention", k_scale=k_scale, v_scale=v_scale)
    out = torch.empty_like(q)
    err = library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        mask.data_ptr(), out.data_ptr(), b, s, h, kh, d, float(scale),
        float(logit_softcap or 0.0), code, int(quantized), _common.stream_ptr(q),
    )
    check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ----------------------------------------------------------------------
# paged pool kernels
# ----------------------------------------------------------------------

def _gather_rows(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[NB, BS, *t] pool pages → the rows' contiguous [R, MB*BS, *t] views."""
    r, mb = tables.shape
    return pages[tables.long()].reshape(r, mb * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, pads: torch.Tensor, *,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float, logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather each row's blocks into a contiguous
    view and run ``decode_attention_plain`` with the mask
    ``pads <= pos < lengths`` (the kernel's numerics)."""
    s = tables.shape[1] * k_pages.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = (pos >= pads.long()[:, None]) & (pos < lengths.long()[:, None])
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=_gather_rows(k_scale, tables), v_scale=_gather_rows(v_scale, tables))
    return decode_attention_plain(
        q, _gather_rows(k_pages, tables), _gather_rows(v_pages, tables), mask,
        scale=scale, logit_softcap=logit_softcap, **scales,
    )


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


def _check_launch(name: str, q, k_pages, v_pages, quantized, k_scale, v_scale, rows: int,
                  **ints) -> int:
    """The kernel-side checks of both paged wrappers (``ints``: the int32
    index operands); returns the dtype code."""
    code = _common.dtype_code(name, q.dtype)
    if not quantized and k_pages.dtype != q.dtype:
        raise TypeError(f"{name}: pages dtype {k_pages.dtype} != q dtype {q.dtype}")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: int8 scale pages must be float32")
    d = q.shape[-1]
    _common.check_head_dim(name, d)
    if rows * d > _PAGED_MAX_OUT:
        raise ValueError(f"{name}: {rows} query rows x head_dim {d} > {_PAGED_MAX_OUT}")
    for arg, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    _common.check_contiguous(name, q=q, k_pages=k_pages, v_pages=v_pages, **ints)
    if quantized:
        _common.check_contiguous(name, k_scale=k_scale, v_scale=v_scale)
    return code


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
    the kernel or raise.
    """
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"paged_decode_attention is q_len=1 only, got {one}")
    quantized = _check_pages("paged_decode_attention", h, d, k_pages, v_pages, k_scale, v_scale)
    nb, bs, kh, _ = k_pages.shape
    if tables.ndim != 2 or tables.shape[0] != b or lengths.shape != (b,) or pads.shape != (b,):
        raise ValueError(
            f"paged_decode_attention: tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}, pads {tuple(pads.shape)} for batch {b}")
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, lengths, pads, *scales):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, tables, lengths, pads, k_scale=k_scale, v_scale=v_scale,
            scale=scale, logit_softcap=logit_softcap,
        )
    code = _check_launch("paged_decode_attention", q, k_pages, v_pages, quantized, k_scale,
                         v_scale, h // kh, tables=tables, lengths=lengths, pads=pads)
    out = torch.empty_like(q)
    err = library().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), pads.data_ptr(), out.data_ptr(),
        b, tables.shape[1], bs, h, kh, d, float(scale), float(logit_softcap or 0.0), code,
        int(quantized), _common.stream_ptr(q),
    )
    check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


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
    t = q.shape[0]
    lane = torch.arange(t, device=q.device)
    tile = lane // RAGGED_Q_TILE
    lane = lane % RAGGED_Q_TILE
    row = tile_row.long()[tile]
    slot = tile_qpos0.long()[tile] + lane
    live = lane < tile_qlen.long()[tile]
    s = tables.shape[1] * k_pages.shape[1]
    pos = torch.arange(s, device=q.device)[None, :]
    lower = torch.maximum(slot - int(window) + 1, pads.long()[row])
    mask = live[:, None] & (pos >= lower[:, None]) & (pos <= slot[:, None])
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=_gather_rows(k_scale, tables)[row],
                      v_scale=_gather_rows(v_scale, tables)[row])
    out = decode_attention_plain(
        q[:, None], _gather_rows(k_pages, tables)[row], _gather_rows(v_pages, tables)[row], mask,
        scale=scale, logit_softcap=logit_softcap, **scales,
    )
    return out[:, 0]


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
    the kernel or raise.
    """
    t, h, d = q.shape
    if t % RAGGED_Q_TILE:
        raise ValueError(
            f"packed token axis ({t}) must be a multiple of RAGGED_Q_TILE ({RAGGED_Q_TILE})")
    nt = t // RAGGED_Q_TILE
    for name, meta in (("tile_row", tile_row), ("tile_qpos0", tile_qpos0), ("tile_qlen", tile_qlen)):
        if meta.shape != (nt,):
            raise ValueError(
                f"tile metadata must have T/RAGGED_Q_TILE = {nt} entries, {name} has "
                f"{tuple(meta.shape)}")
    quantized = _check_pages("ragged_paged_attention", h, d, k_pages, v_pages, k_scale, v_scale)
    nb, bs, kh, _ = k_pages.shape
    if tables.ndim != 2 or pads.shape != (tables.shape[0],):
        raise ValueError(f"ragged_paged_attention: tables {tuple(tables.shape)} vs pads "
                         f"{tuple(pads.shape)}")
    window = min(int(window), 2**31 - 1)
    scales = (k_scale, v_scale) if quantized else ()
    if _common.on_cpu(q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, *scales):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, tables, tile_row, tile_qpos0, tile_qlen, pads, window,
            k_scale=k_scale, v_scale=v_scale, scale=scale, logit_softcap=logit_softcap,
        )
    code = _check_launch("ragged_paged_attention", q, k_pages, v_pages, quantized, k_scale,
                         v_scale, RAGGED_Q_TILE * (h // kh), tables=tables,
                         tile_row=tile_row, tile_qpos0=tile_qpos0, tile_qlen=tile_qlen, pads=pads)
    out = torch.empty_like(q)
    err = library().ragged_paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), tile_row.data_ptr(), tile_qpos0.data_ptr(), tile_qlen.data_ptr(),
        pads.data_ptr(), out.data_ptr(), nt, tables.shape[1], bs, h, kh, d, window,
        float(scale), float(logit_softcap or 0.0), code, int(quantized), _common.stream_ptr(q),
    )
    check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0

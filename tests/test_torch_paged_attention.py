"""The port's two block-table attention wrappers on CPU tensors (their
plain versions) against the JAX package's Pallas kernels
``paged_decode_attention`` and ``ragged_paged_attention`` in interpret
mode, in float32.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py`` holds
them against these plain versions there).  Here the plain versions are
held against the TPU kernels' semantics: block tables with scratch-0
padding, visibility from per-row (pad, length) or per-tile (row, first
slot, live count, window) scalars, a leading-block skip, softcap, int8
scale pages, and zeros where nothing is visible.  Ragged outputs are
compared on live lanes only: the port's dead lanes are zeros by
definition, and the kernels agree there too (pinned separately).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu.ops.pallas.decode_attention import (
    paged_decode_attention as j_paged,
    ragged_paged_attention as j_ragged,
)
from llm_np_cp_tpu_torch.cache import quantize_kv
from llm_np_cp_tpu_torch.ops.cuda.decode_attention import (
    RAGGED_Q_TILE,
    paged_decode_attention,
    ragged_paged_attention,
)

ATOL = 1e-5  # float32 on both sides; only summation order and the
# softmax's max (AMLA grid vs global) differ


def _np(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pages(rng, nbp, bs, kh, d, int8):
    """(k, v, k_scale, v_scale) pages as numpy: float32, or int8 + scales
    quantized by the JAX package's own quantize_kv."""
    k, v = _np(rng, (nbp, bs, kh, d), 2), _np(rng, (nbp, bs, kh, d))
    if not int8:
        return k, v, None, None
    kq, ks = jcache.quantize_kv(jnp.asarray(k))
    vq, vs = jcache.quantize_kv(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks, np.float32),
            np.asarray(vs, np.float32))


def _scales_kw(ks, vs, to):
    return {} if ks is None else dict(k_scale=to(ks), v_scale=to(vs))


# ----------------------------------------------------------------------
# paged_decode_attention
# ----------------------------------------------------------------------

PAGED_CASES = [
    # name, h, kh, d, bs, tables, lengths, pads, softcap, int8
    ("mha", 4, 4, 16, 16, [[1, 2, 3, 0], [4, 5, 0, 0], [7, 6, 5, 4]], [40, 17, 64], [3, 0, 10],
     None, False),
    ("gqa4", 8, 2, 16, 16, [[1, 2, 3, 0], [4, 5, 0, 0], [7, 6, 5, 4]], [40, 17, 64], [3, 0, 10],
     None, False),
    ("mqa_softcap", 4, 1, 8, 8, [[5, 1, 2], [3, 4, 0], [6, 7, 0]], [24, 9, 16], [2, 0, 0],
     20.0, False),
    ("int8", 8, 2, 16, 16, [[1, 2, 3, 0], [4, 5, 0, 0], [7, 6, 5, 4]], [40, 17, 64], [3, 0, 10],
     None, True),
    # pads spanning whole blocks: the first visible block is not block 0
    ("leading_block_skip", 8, 2, 16, 8, [[1, 2, 3, 4], [5, 6, 7, 0], [9, 8, 7, 6]],
     [30, 20, 32], [17, 9, 24], None, False),
    # a sliding window enters as an effective left pad (the engine's
    # row_pads = max(pads, lengths - window)), int8 + softcap on top
    ("window_as_pad_int8_softcap", 4, 2, 16, 8, [[2, 3, 4, 5], [6, 7, 8, 9], [1, 0, 0, 0]],
     [31, 25, 8], [31 - 12, 25 - 12, 0], 50.0, True),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_plain_matches_pallas(case):
    _, h, kh, d, bs, tables, lengths, pads, softcap, int8 = case
    rng = np.random.default_rng(h * 31 + kh * 7 + d)
    b = len(tables)
    q = _np(rng, (b, 1, h, d), 2)
    k, v, ks, vs = _pages(rng, 10, bs, kh, d, int8)
    tables = np.asarray(tables, np.int32)
    lengths = np.asarray(lengths, np.int32)
    pads = np.asarray(pads, np.int32)
    kw = dict(scale=d ** -0.5, logit_softcap=softcap)
    want = j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                   jnp.asarray(lengths), jnp.asarray(pads), interpret=True,
                   **_scales_kw(ks, vs, jnp.asarray), **kw)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*_t(q, k, v, tables, lengths, pads),
                                 **_scales_kw(ks, vs, lambda a: _t(a)[0]), **kw)
    assert paged_decode_attention.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_nothing_visible_gives_zeros():
    """A row whose pads reach its length sees nothing: zeros, as the TPU
    kernel's _finalize writes."""
    rng = np.random.default_rng(3)
    q = _np(rng, (2, 1, 4, 8))
    k, v = _np(rng, (4, 8, 2, 8)), _np(rng, (4, 8, 2, 8))
    tables = np.asarray([[1, 2], [3, 0]], np.int32)
    lengths = np.asarray([12, 5], np.int32)
    pads = np.asarray([12, 0], np.int32)
    want = j_paged(*(jnp.asarray(a) for a in (q, k, v, tables, lengths, pads)), scale=0.3,
                   interpret=True)
    got = paged_decode_attention(*_t(q, k, v, tables, lengths, pads), scale=0.3)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_argument_checks():
    q = torch.zeros(1, 1, 4, 8)
    pages = torch.zeros(2, 8, 2, 8, dtype=torch.int8)
    scales = torch.zeros(2, 8, 2)
    args = (torch.zeros(1, 1, dtype=torch.int32), torch.tensor([4], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="k_scale"):
        paged_decode_attention(q, pages, pages, *args, scale=0.35)
    with pytest.raises(ValueError, match="k_scale"):
        paged_decode_attention(q, pages, pages, *args, k_scale=scales, scale=0.35)
    with pytest.raises(ValueError, match="k_scale"):
        paged_decode_attention(q, pages.float(), pages.float(), *args, k_scale=scales,
                               v_scale=scales, scale=0.35)
    with pytest.raises(ValueError, match="q_len=1"):
        paged_decode_attention(torch.zeros(1, 2, 4, 8), pages.float(), pages.float(), *args,
                               scale=0.35)
    with pytest.raises(ValueError, match="query heads"):
        paged_decode_attention(torch.zeros(1, 1, 3, 8), pages.float(), pages.float(), *args,
                               scale=0.35)


# ----------------------------------------------------------------------
# ragged_paged_attention
# ----------------------------------------------------------------------

def _ragged_layout(segments, n_dead_tiles=0):
    """Pack ``[(row, first cache slot, n tokens)]`` the way the serve
    engine's packer does: each segment starts on a tile boundary, and
    ``n_dead_tiles`` padding tiles (qlen 0, row 0) trail the batch.
    Returns (T, tile_row, tile_qpos0, tile_qlen, live token mask)."""
    qt = RAGGED_Q_TILE
    rows, qpos0, qlen, live = [], [], [], []
    for row, slot0, n in segments:
        for k in range(-(-n // qt)):
            rows.append(row)
            qpos0.append(slot0 + k * qt)
            m = min(qt, n - k * qt)
            qlen.append(m)
            live += [True] * m + [False] * (qt - m)
    for _ in range(n_dead_tiles):
        rows.append(0)
        qpos0.append(0)
        qlen.append(0)
        live += [False] * qt
    as32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return len(live), as32(rows), as32(qpos0), as32(qlen), np.asarray(live)


RAGGED_CASES = [
    # name, h, kh, d, bs, softcap, window, int8
    ("gqa", 8, 2, 16, 8, None, 1 << 30, False),
    ("mha_softcap", 4, 4, 16, 8, 30.0, 1 << 30, False),
    ("int8", 8, 2, 16, 8, None, 1 << 30, True),
    ("sliding_window", 4, 2, 16, 8, None, 12, False),
    ("window_softcap_int8", 8, 4, 8, 16, 50.0, 20, True),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=[c[0] for c in RAGGED_CASES])
def test_ragged_plain_matches_pallas(case):
    _, h, kh, d, bs, softcap, window, int8 = case
    rng = np.random.default_rng(h * 13 + kh + d + bs)
    # four engine rows: a decode row with a leading pad spanning whole
    # blocks, a prefill slice mid-prompt, a completing prefill slice, a
    # second decode row; a dead tile trails the batch
    tables = np.asarray([[3, 4, 5, 6, 0, 0], [7, 8, 9, 1, 0, 0], [10, 11, 2, 0, 0, 0],
                         [12, 13, 14, 15, 16, 0]], np.int32)
    pads = np.asarray([2 * bs + 1, 3, 0, 5], np.int32)
    segments = [(0, 3 * bs + 4, 1), (1, 3 + 5, 13), (2, 9, 11), (3, 4 * bs + 2, 1)]
    t, tile_row, tile_qpos0, tile_qlen, live = _ragged_layout(segments, n_dead_tiles=1)
    q = _np(rng, (t, h, d), 2)
    k, v, ks, vs = _pages(rng, 17, bs, kh, d, int8)
    meta = (tables, tile_row, tile_qpos0, tile_qlen, pads)
    kw = dict(scale=d ** -0.5, logit_softcap=softcap)
    want = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    *(jnp.asarray(a) for a in meta), jnp.int32(window), interpret=True,
                    **_scales_kw(ks, vs, jnp.asarray), **kw)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*_t(q, k, v, *meta), window,
                                 **_scales_kw(ks, vs, lambda a: _t(a)[0]), **kw)
    assert ragged_paged_attention.launches == before
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=ATOL)
    # dead lanes and the dead tile: zeros (as the kernel gives them)
    assert not got.numpy()[~live].any()
    np.testing.assert_allclose(np.asarray(want)[~live], 0.0, atol=ATOL)


def test_ragged_decode_rows_match_paged():
    """A tile holding one decode token per row is the paged decode step
    in another layout: the two wrappers must agree."""
    rng = np.random.default_rng(9)
    h, kh, d, bs = 8, 2, 16, 8
    tables = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    lengths = np.asarray([20, 9, 24], np.int32)
    pads = np.asarray([3, 0, 9], np.int32)
    k, v, _, _ = _pages(rng, 9, bs, kh, d, False)
    q1 = _np(rng, (3, 1, h, d))
    t, tile_row, tile_qpos0, tile_qlen, live = _ragged_layout(
        [(r, int(lengths[r]) - 1, 1) for r in range(3)])
    q = np.zeros((t, h, d), np.float32)
    q[live] = q1[:, 0]
    got = ragged_paged_attention(*_t(q, k, v, tables, tile_row, tile_qpos0, tile_qlen, pads),
                                 1 << 30, scale=0.25)
    want = paged_decode_attention(*_t(q1, k, v, tables, lengths, pads), scale=0.25)
    np.testing.assert_allclose(got.numpy()[live], want.numpy()[:, 0], atol=ATOL)


def test_ragged_int8_pool_with_port_quantizer():
    """The port's own quantize_kv feeds the int8 path the same way."""
    rng = np.random.default_rng(5)
    h, kh, d, bs = 4, 2, 16, 8
    kf, vf = torch.from_numpy(_np(rng, (6, bs, kh, d))), torch.from_numpy(_np(rng, (6, bs, kh, d)))
    kq, ks = quantize_kv(kf)
    vq, vs = quantize_kv(vf)
    tables = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
    pads = np.asarray([0, 2], np.int32)
    t, tile_row, tile_qpos0, tile_qlen, live = _ragged_layout([(0, 10, 9), (1, 11, 1)])
    q = _np(rng, (t, h, d))
    meta = (tables, tile_row, tile_qpos0, tile_qlen, pads)
    want = j_ragged(jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                    *(jnp.asarray(a) for a in meta), jnp.int32(1 << 30),
                    k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
                    scale=0.25, interpret=True)
    got = ragged_paged_attention(torch.from_numpy(q), kq, vq, *_t(*meta), 1 << 30,
                                 k_scale=ks, v_scale=vs, scale=0.25)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=ATOL)


def test_ragged_argument_checks():
    pages = torch.zeros(4, 8, 2, 8)
    meta = [torch.zeros(1, dtype=torch.int32)] * 3
    tables, pads = torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="RAGGED_Q_TILE"):
        ragged_paged_attention(torch.zeros(12, 4, 8), pages, pages, tables, *meta, pads, 8,
                               scale=1.0)
    with pytest.raises(ValueError, match="tile metadata"):
        ragged_paged_attention(torch.zeros(16, 4, 8), pages, pages, tables, *meta, pads, 8,
                               scale=1.0)
    with pytest.raises(ValueError, match="k_scale"):
        ragged_paged_attention(torch.zeros(8, 4, 8), pages.to(torch.int8), pages.to(torch.int8),
                               tables, *meta, pads, 8, scale=1.0)

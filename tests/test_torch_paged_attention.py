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

import itertools
from functools import lru_cache

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
from llm_np_cp_tpu_torch.ops.attention import NEG_INF
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
from llm_np_cp_tpu_torch.ops.cuda.decode_attention import (
    RAGGED_Q_TILE,
    paged_decode_attention,
    ragged_paged_attention,
)
from llm_np_cp_tpu_torch.serve import pool_geometry


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
# paged_decode_attention, split-KV: the plain split + combine
# ----------------------------------------------------------------------

H100_SMS = 132


@lru_cache(maxsize=None)
def _paged_case(name):
    """A PAGED_CASES entry's numpy inputs (test_paged_plain_matches_pallas's
    seed), attention keywords and scale pages, and the JAX kernel's output
    in interpret mode (computed once per case)."""
    _, h, kh, d, bs, tables, lengths, pads, softcap, int8 = next(
        c for c in PAGED_CASES if c[0] == name)
    rng = np.random.default_rng(h * 31 + kh * 7 + d)
    q = _np(rng, (len(tables), 1, h, d), 2)
    k, v, ks, vs = _pages(rng, 10, bs, kh, d, int8)
    arrays = (q, k, v, np.asarray(tables, np.int32), np.asarray(lengths, np.int32),
              np.asarray(pads, np.int32))
    kw = dict(scale=d ** -0.5, logit_softcap=softcap)
    want = j_paged(*(jnp.asarray(a) for a in arrays), interpret=True,
                   **_scales_kw(ks, vs, jnp.asarray), **kw)
    return arrays, (ks, vs), kw, np.asarray(want)


def _torch_scales(ks, vs):
    return _scales_kw(ks, vs, lambda a: _t(a)[0])


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_split_combine_matches_pallas(case, nsplit):
    """The paged split kernel's plain version composed with the combine's
    equals the TPU kernel in interpret mode, for any number of splits."""
    arrays, (ks, vs), kw, want = _paged_case(case[0])
    q = arrays[0]
    acc, m, l = da.paged_decode_attention_split_plain(*_t(*arrays), nsplit=nsplit,
                                                      **_torch_scales(ks, vs), **kw)
    b, _, h, d = q.shape
    kh = arrays[1].shape[2]
    assert acc.shape == (b, kh, nsplit, h // kh, d) and m.shape == l.shape == acc.shape[:-1]
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    got = da.combine_splits_plain(acc, m, l, torch.float32).reshape(q.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("nsplit", [2, 7, 16])
def test_paged_split_empty_rows_and_splits(nsplit):
    """A row with nothing visible (pads == lengths, or pads past lengths)
    gives zeros, and a split that gets no tile of its row's band holds
    l = 0, m = NEG_INF and acc = 0: a one-tile band has one live split."""
    rng = np.random.default_rng(40 + nsplit)
    h, kh, d, bs, mb = 8, 2, 16, 8, 40  # 320 slots: five 64-slot tiles
    tables = rng.permutation(np.arange(1, 4 * mb + 1)).reshape(4, mb).astype(np.int32)
    lengths = np.asarray([300, 50, 150, 100], np.int32)
    pads = np.asarray([3, 50, 130, 200], np.int32)  # rows 1, 3: nothing; row 2: tile 2 only
    q = _np(rng, (4, 1, h, d), 2)
    k, v, _, _ = _pages(rng, 4 * mb + 1, bs, kh, d, False)
    args = _t(q, k, v, tables, lengths, pads)
    acc, m, l = da.paged_decode_attention_split_plain(*args, nsplit=nsplit, scale=0.25)
    for row in (1, 3):
        assert not l[row].any() and bool((m[row] == NEG_INF).all()) and not acc[row].any()
    live = l[2, 0, :, 0] > 0
    assert int(live.sum()) == 1
    assert bool((m[2][:, ~live] == NEG_INF).all()) and not acc[2][:, ~live].any()
    assert int((l[0, 0, :, 0] > 0).sum()) == min(nsplit, 5)  # row 0's band spans five tiles
    got = da.combine_splits_plain(acc, m, l, torch.float32).reshape(q.shape)
    assert not got[1].any() and not got[3].any()
    want = paged_decode_attention(*args, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("nsplit", [1, 3, 16])
def test_paged_split_bounds_are_the_kernels(nsplit):
    """The paged kernel cuts the band [max(pads, 0), min(lengths, MB*BS))
    into tiles (csrc/split_decode.cuh); the plain version cuts the band of
    the gathered mask pads <= pos < lengths with _split_bounds.  The two
    agree, with lengths past the table (clipped) and negative pads, and
    each row's split ranges cover its band exactly."""
    s, tile = 10 * 16, 64
    lengths = np.asarray([160, 200, 1, 50, 100, 0, 64, 130])
    pads = np.asarray([0, 20, 0, -5, 100, 0, 63, 129])
    pos = torch.arange(s)
    mask = (pos >= torch.from_numpy(pads)[:, None]) & (pos < torch.from_numpy(lengths)[:, None])
    want = da._split_bounds(mask, nsplit, tile).numpy()
    first, last = np.maximum(pads, 0), np.minimum(lengths, s) - 1
    for r in range(len(lengths)):
        t0, n = (first[r] // tile, last[r] // tile - first[r] // tile + 1) if last[r] >= first[r] \
            else (0, 0)
        bounds = [t0 + i * n // nsplit for i in range(nsplit + 1)]
        assert bounds == want[r].tolist(), r
        slots = [x for i in range(nsplit)
                 for x in range(max(bounds[i] * tile, first[r]), min(bounds[i + 1] * tile, last[r] + 1))]
        assert slots == list(range(first[r], last[r] + 1)), r


@pytest.mark.parametrize("b,width,want", [
    (8, 288, 2),  # serve leg B
    (8, 4096, 4),
    (1, 32768, 33),  # one long-context row: 2048 blocks of 16
])
def test_paged_split_plan_at_the_paged_shapes(b, width, want):
    """NSPLIT is planned over the table width (Llama-3.2-1B: 8 kv heads of
    4 query heads, D=64) on the H100's 132 SMs; serve leg B's tables are
    ``pool_geometry``'s 288 slots."""
    assert pool_geometry(200, 32, 8, 16, 64)[2] == 288
    assert da.split_plan(b, 8, width, 64, H100_SMS, 4) == want


def test_paged_split_wrappers_on_cpu_never_launch():
    """CPU tensors take the plain versions; no launch count moves."""
    arrays, (ks, vs), kw, _ = _paged_case("window_as_pad_int8_softcap")
    args, scales = _t(*arrays), _torch_scales(ks, vs)
    counts = lambda: (da.paged_decode_attention.launches,  # noqa: E731
                      da.paged_decode_attention.combine_launches,
                      da.paged_decode_attention_split.launches, da.combine_splits.launches)
    before = counts()
    parts = da.paged_decode_attention_split(*args, nsplit=3, **scales, **kw)
    for got, ref in zip(parts, da.paged_decode_attention_split_plain(*args, nsplit=3, **scales,
                                                                     **kw)):
        assert torch.equal(got, ref)
    da.combine_splits(*parts, torch.float32)
    da.paged_decode_attention(*args, **scales, **kw)
    assert counts() == before
    with pytest.raises(ValueError, match="nsplit"):
        da.paged_decode_attention_split(*args, nsplit=0, **scales, **kw)


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


# ----------------------------------------------------------------------
# the ragged kernel's split-KV and its prefill tiles (the CUDA kernel runs
# only on the card; here its plain split version and an emulation of its
# tensor-core loop are held against the TPU kernel)
# ----------------------------------------------------------------------

# Qwen-2's group of 7: the kernel takes two blocks (4 + 3 heads) a kv head
RAGGED_SPLIT_CASES = RAGGED_CASES + [("group7", 14, 2, 16, 8, None, 1 << 30, False)]


@lru_cache(maxsize=None)
def _ragged_case(name):
    """A RAGGED_SPLIT_CASES entry's numpy inputs (test_ragged_plain_matches_pallas's
    layout and seed), window, scale pages, keywords, live mask and the JAX
    kernel's output in interpret mode (computed once per case)."""
    _, h, kh, d, bs, softcap, window, int8 = next(c for c in RAGGED_SPLIT_CASES if c[0] == name)
    rng = np.random.default_rng(h * 13 + kh + d + bs)
    tables = np.asarray([[3, 4, 5, 6, 0, 0], [7, 8, 9, 1, 0, 0], [10, 11, 2, 0, 0, 0],
                         [12, 13, 14, 15, 16, 0]], np.int32)
    pads = np.asarray([2 * bs + 1, 3, 0, 5], np.int32)
    segments = [(0, 3 * bs + 4, 1), (1, 3 + 5, 13), (2, 9, 11), (3, 4 * bs + 2, 1)]
    t, tile_row, tile_qpos0, tile_qlen, live = _ragged_layout(segments, n_dead_tiles=1)
    q = _np(rng, (t, h, d), 2)
    k, v, ks, vs = _pages(rng, 17, bs, kh, d, int8)
    arrays = (q, k, v, tables, tile_row, tile_qpos0, tile_qlen, pads)
    kw = dict(scale=d ** -0.5, logit_softcap=softcap)
    want = j_ragged(*(jnp.asarray(a) for a in arrays), jnp.int32(window), interpret=True,
                    **_scales_kw(ks, vs, jnp.asarray), **kw)
    return arrays, window, (ks, vs), kw, live, np.asarray(want)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 5])
@pytest.mark.parametrize("case", RAGGED_SPLIT_CASES, ids=[c[0] for c in RAGGED_SPLIT_CASES])
def test_ragged_split_combine_matches_pallas(case, nsplit):
    """The ragged kernel's split plain version composed with the combine's,
    packed back to [T, H, D], equals the TPU kernel in interpret mode on
    live lanes, for any number of splits; dead lanes and the dead tile are
    exactly zero."""
    arrays, window, (ks, vs), kw, live, want = _ragged_case(case[0])
    t, h, d = arrays[0].shape
    kh = arrays[1].shape[2]
    acc, m, l = da.ragged_paged_attention_split_plain(*_t(*arrays), window, nsplit=nsplit,
                                                      **_torch_scales(ks, vs), **kw)
    rows = RAGGED_Q_TILE * (h // kh)
    assert acc.shape == (t // RAGGED_Q_TILE, kh, nsplit, rows, d)
    assert m.shape == l.shape == acc.shape[:-1]
    got = da.ragged_from_rows(da.combine_splits_plain(acc, m, l, torch.float32)).numpy()
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)
    assert not got[~live].any()
    # a lane that sees nothing holds l = 0 and m = NEG_INF in every split
    dead = ~torch.from_numpy(live).view(-1, RAGGED_Q_TILE)
    dl = l.view(*l.shape[:3], RAGGED_Q_TILE, -1).permute(0, 3, 1, 2, 4)[dead]
    dm = m.view(*m.shape[:3], RAGGED_Q_TILE, -1).permute(0, 3, 1, 2, 4)[dead]
    assert not dl.any() and bool((dm == NEG_INF).all())


@pytest.mark.parametrize("nsplit", [1, 2, 5])
def test_ragged_split_bounds_are_the_kernels(nsplit):
    """The kernel cuts each tile's band [max(pad, qpos0 - window + 1, 0),
    min(qpos0 + qlen, MB*BS) - 1] into nsplit ranges of whole DecodeTile
    tiles, clipped to the band (csrc/ragged_paged_attention.cu, as
    split_decode.cuh's attend); _ragged_split_bounds gives the same tiles,
    and the ranges cover the band exactly.  Dead tiles have no band."""
    s, tile = 10 * 16, 64
    qpos0 = np.asarray([0, 40, 150, 159, 63, 100, 0])
    qlen = np.asarray([8, 1, 8, 1, 3, 5, 0])
    pads = np.asarray([0, 20, 7, 159, 0])
    row = np.asarray([0, 1, 2, 3, 4, 1, 0])
    window = 50
    bounds = da._ragged_split_bounds(*_t(row, qpos0, qlen, pads), window, s, nsplit,
                                     tile).numpy()
    for i in range(len(qpos0)):
        first = max(pads[row[i]], qpos0[i] - window + 1, 0)
        last = min(qpos0[i] + qlen[i], s) - 1
        if qlen[i] == 0 or last < first:
            assert (bounds[i] == bounds[i, 0]).all(), i
            continue
        t0, n = first // tile, last // tile - first // tile + 1
        assert bounds[i].tolist() == [t0 + z * n // nsplit for z in range(nsplit + 1)], i
        slots = [x for z in range(nsplit)
                 for x in range(max(bounds[i, z] * tile, first),
                                min(bounds[i, z + 1] * tile, last + 1))]
        assert slots == list(range(first, last + 1)), i


NO_WINDOW = 1 << 30


@pytest.mark.parametrize("width,table,h,kh,d,window,want", [
    (192, 288, 32, 8, 64, NO_WINDOW, 1),   # serve leg A's widest tick: 24 tiles x 8 kv heads
    (64, 288, 32, 8, 64, NO_WINDOW, 1),    # its decode-only tick: 5 kv tiles, < 4 a split
    (192, 352, 32, 8, 64, NO_WINDOW, 1),   # chip_smoke's serve-shaped pool (22 blocks of 16)
    (64, 1152, 32, 8, 64, NO_WINDOW, 4),   # 8 decode rows at up to 1152: 18 tiles
    (64, 4096, 32, 8, 64, NO_WINDOW, 4),   # 8 decode rows at up to 4096
    (8, 32768, 32, 8, 64, NO_WINDOW, 33),  # one decode row at 32768
    (568, 4096, 32, 8, 64, NO_WINDOW, 1),  # the long mixed tick: 71 tiles fill the card
    (192, 352, 32, 8, 128, NO_WINDOW, 1),  # Llama-3.1-8B widths
    (64, 576, 32, 8, 128, NO_WINDOW, 2),   # its decode-only tick at 576: 9 tiles
    (192, 352, 8, 4, 256, 128, 1),         # Gemma-2 widths: the window cuts bands to 135 slots
    (64, 288, 8, 4, 256, 4096, 2),         # Gemma-2 decode-only at 288: 9 tiles of 32
])
def test_ragged_split_plan_at_the_serve_shapes(width, table, h, kh, d, window, want, monkeypatch):
    """NSPLIT from the shapes alone on the H100's 132 SMs: split_plan's
    count of blocks for the packed width's q tiles over the longest band
    (the table width, or the window and a tile's 8 tokens), at least
    RAGGED_MIN_TILES kv tiles a split."""
    monkeypatch.setattr(da, "sm_count", lambda device: H100_SMS)
    q = torch.empty((width, h, d), device="meta")
    pages = torch.empty((1, 16, kh, d), device="meta")
    tables = torch.empty((8, table // 16), dtype=torch.int32, device="meta")
    assert da.ragged_split_plan(q, pages, tables, window) == want


def test_ragged_split_wrappers_on_cpu_never_launch():
    arrays, window, (ks, vs), kw, _, _ = _ragged_case("window_softcap_int8")
    args, scales = _t(*arrays), _torch_scales(ks, vs)
    counts = lambda: (da.ragged_paged_attention.launches,  # noqa: E731
                      da.ragged_paged_attention.combine_launches,
                      da.ragged_paged_attention_split.launches)
    before = counts()
    parts = da.ragged_paged_attention_split(*args, window, nsplit=3, **scales, **kw)
    for got, ref in zip(parts, da.ragged_paged_attention_split_plain(
            *args, window, nsplit=3, **scales, **kw)):
        assert torch.equal(got, ref)
    assert counts() == before
    with pytest.raises(ValueError, match="nsplit"):
        da.ragged_paged_attention_split(*args, window, nsplit=0, **scales, **kw)


def _emulate_ragged(q, k, v, tables, tile_row, tile_qpos0, tile_qlen, pads, window, scale,
                    softcap, nsplit, p_dtype, ks=None, vs=None):
    """The tensor-core path of the ragged kernel in numpy, float32: per
    (tile, kv head, block of <= 4 heads, split) the rows r = lane * gn +
    head padded to RT = 1 or 2 tiles of 16 (padding rows and dead lanes
    see nothing), kv tiles of the split plan's slots (``DecodeTile<D>::BS``),
    a warp per 16-slot chunk of each (8 warps: RT x chunks x column
    parts), slots outside the split zero, scores in the
    log2 domain with masked slots -inf and the running max guarded while a
    row has seen nothing, P rounded to ``p_dtype`` before the PV product,
    then the warps' states merged and written as partials (m back in the
    natural log).  Returns the output through the combine's plain
    version, packed as [T, H, D]."""
    t, h, d = q.shape
    _, bs, kh, _ = k.shape
    g_all = h // kh
    nt, tile = t // RAGGED_Q_TILE, da._tile(d)
    nc = tile // 16
    s_max = tables.shape[1] * bs
    if ks is not None:
        k = k.astype(np.float32) * ks[..., None]
        v = v.astype(np.float32) * vs[..., None]
    log2e = np.float32(np.log2(np.e))
    unit = np.float32(1.0) if softcap else np.float32(scale) * log2e
    rows8 = RAGGED_Q_TILE * g_all
    acc = np.zeros((nt, kh, nsplit, rows8, d), np.float32)
    m_out = np.full((nt, kh, nsplit, rows8), NEG_INF, np.float32)
    l_out = np.zeros((nt, kh, nsplit, rows8), np.float32)
    for ti, kv, g0 in itertools.product(range(nt), range(kh), range(0, g_all, 4)):
        qlen = int(tile_qlen[ti])
        if qlen == 0:
            continue
        gn = min(4, g_all - g0)
        rows = RAGGED_Q_TILE * gn
        rpad = 16 if rows <= 16 else 32
        row, qpos0 = int(tile_row[ti]), int(tile_qpos0[ti])
        first = max(int(pads[row]), qpos0 - window + 1, 0)
        last = min(qpos0 + qlen, s_max) - 1
        r = np.arange(rpad)
        tok, head = r // gn, g0 + r % gn
        live = (r < rows) & (tok < qlen)
        qr = np.where(live[:, None], q[ti * RAGGED_Q_TILE + np.minimum(tok, qlen - 1),
                                       kv * g_all + np.minimum(head, g_all - 1)], 0)
        qr = qr.astype(np.float32)
        slot = qpos0 + tok
        for z in range(nsplit):
            lo = hi = 0
            if last >= first:
                t0, n = first // tile, last // tile - first // tile + 1
                lo = max((t0 + z * n // nsplit) * tile, first)
                hi = min((t0 + (z + 1) * n // nsplit) * tile, last + 1)
            vlo = np.maximum(np.maximum(int(pads[row]), slot - window + 1), lo)
            vhi = np.where(live, np.minimum(slot, hi - 1), vlo - 1)
            states = []
            for c in range(nc):
                m = np.full(rpad, -np.inf, np.float32)
                l = np.zeros(rpad, np.float32)
                o = np.zeros((rpad, d), np.float32)
                for j in range(lo // tile, (hi - 1) // tile + 1 if hi > lo else lo // tile):
                    cols = j * tile + c * 16 + np.arange(16)
                    ok = (cols >= lo) & (cols < hi)
                    pool = tables[row, np.minimum(cols, s_max - 1) // bs]
                    kc = np.where(ok[:, None], k[pool, cols % bs, kv], 0)
                    vc = np.where(ok[:, None], v[pool, cols % bs, kv], 0)
                    x = qr @ kc.T
                    if softcap:
                        x = np.tanh(x * np.float32(scale / softcap)) * np.float32(softcap * log2e)
                    x = np.where((cols[None] >= vlo[:, None]) & (cols[None] <= vhi[:, None]), x,
                                 -np.inf)
                    m_new = np.maximum(m, x.max(axis=1) * unit)
                    dead = m_new == -np.inf
                    with np.errstate(invalid="ignore"):
                        alpha = np.where(dead, 1, np.exp2(m - m_new))
                    base = np.where(dead, 0, m_new)
                    p = np.exp2(x * unit - base[:, None]).astype(np.float32)
                    l = l * alpha + p.sum(axis=1)
                    pr = torch.from_numpy(p).to(p_dtype).float().numpy()
                    o = o * alpha[:, None] + pr @ vc
                    m = m_new
                states.append((m, l, o))
            ms = np.stack([s_[0] for s_ in states])
            ls = np.stack([s_[1] for s_ in states])
            mx = np.where(ls > 0, ms, -np.inf).max(axis=0)
            with np.errstate(invalid="ignore"):
                w = np.where(ls > 0, np.exp2(ms - mx), 0)
            den = (w * ls).sum(axis=0)
            num = sum(w[c][:, None] * states[c][2] for c in range(len(states)))
            for rr in np.nonzero(live)[0]:
                pr_ = tok[rr] * g_all + head[rr]
                acc[ti, kv, z, pr_] = num[rr]
                l_out[ti, kv, z, pr_] = den[rr]
                m_out[ti, kv, z, pr_] = mx[rr] / log2e if den[rr] > 0 else NEG_INF
    out = da.combine_splits_plain(*_t(acc, m_out, l_out), torch.float32)
    return da.ragged_from_rows(out).numpy()


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("case", RAGGED_SPLIT_CASES, ids=[c[0] for c in RAGGED_SPLIT_CASES])
def test_emulated_ragged_tiles_match_pallas(case, nsplit, p_dtype):
    """The tensor-core tiles' loop (emulated) against the TPU kernel, one
    to three splits of each tile's band: float32 P within summation order
    (2e-5); bf16 P within one rounding of each weight (2^-9 relative),
    averaged over the row's visible slots (1e-2, as the flash kernel's
    emulation)."""
    arrays, window, (ks, vs), kw, live, want = _ragged_case(case[0])
    got = _emulate_ragged(*arrays, window, kw["scale"], kw["logit_softcap"], nsplit, p_dtype,
                          ks, vs)
    np.testing.assert_allclose(got[live], want[live],
                               atol=2e-5 if p_dtype == torch.float32 else 1e-2)
    assert not got[~live].any()

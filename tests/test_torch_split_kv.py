"""Split-KV decode attention on the CPU: the split plan, and the plain
versions of the split kernel and of the combine, composed, against the
one-pass ``decode_attention_plain`` in float32.

The composition sums the same products in another order (per split, then
across splits, each split's exp taken against its own max), so it agrees
with the one-pass version to a few float32 ulps: within 1e-6 absolute
plus 1e-6 relative.  The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``); the JAX kernel in interpret mode is held
against the same composition in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from llm_np_cp_tpu_torch.cache import quantize_kv
from llm_np_cp_tpu_torch.ops.attention import NEG_INF
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-6, atol=1e-6)
H100_SMS = 132


# ----------------------------------------------------------------------
# split_plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,kh,s,d,sms,want",
    [
        (4, 8, 4096, 64, H100_SMS, 8),       # 32 blocks → 8 splits: 256 blocks, two per SM
        (4, 8, 256, 64, H100_SMS, 2),        # main path: 4 tiles, two per split
        (1, 8, 32768, 64, H100_SMS, 33),     # long context, one row: 264 blocks
        (1, 4, 300, 256, H100_SMS, 5),       # D=256: 32-slot tiles, 10 of them
        (64, 8, 4096, 64, H100_SMS, 1),      # 512 blocks already fill the card
        (33, 4, 8192, 64, H100_SMS, 2),      # one block per SM → two
        (1, 1, 64, 64, H100_SMS, 1),         # one tile: nothing to split
        (1, 1, 65, 128, H100_SMS, 1),        # two tiles: at least two a split
        (2, 2, 100_000, 64, 16, 8),          # a small card
    ],
)
def test_split_plan(b, kh, s, d, sms, want):
    got = da.split_plan(b, kh, s, d, sms)
    tiles = -(-s // (32 if d == 256 else 64))
    assert got == want
    assert 1 <= got <= max(1, tiles // 2) <= tiles
    if 1 < got < tiles // 2:  # not held back by the tiles: as many blocks as fit
        assert b * kh * got <= 2 * sms < b * kh * (got + 1)


@pytest.mark.parametrize("b,kh", [(1, 1), (2, 8), (8, 8), (16, 8), (17, 8), (300, 8)])
def test_split_plan_one_split_when_rows_fill_the_card(b, kh):
    """No split where two splits would not fit on the card at once; more
    splits never exceed the tiles however small the batch."""
    n = da.split_plan(b, kh, 4096, 64, H100_SMS)
    assert (n == 1) == (b * kh > H100_SMS)
    assert n <= 4096 // 64 // 2


@pytest.mark.parametrize("g,want", [(1, 8), (4, 8), (7, 4), (8, 4), (16, 2)])
def test_split_plan_counts_query_head_blocks(g, want):
    """A block takes 4 query heads: G > 4 multiplies the blocks per split."""
    assert da.split_plan(4, 8, 4096, 64, H100_SMS, g) == want


# ----------------------------------------------------------------------
# plain split + combine == one-pass plain
# ----------------------------------------------------------------------

def _inputs(seed, b=4, s=300, h=8, kh=2, d=64, int8=False):
    rng = np.random.default_rng(seed)
    t = lambda shape, sc=1.0: torch.from_numpy((sc * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    q, k, v = t((b, 1, h, d), 2.0), t((b, s, kh, d), 2.0), t((b, s, kh, d))
    mask = torch.zeros((b, s), dtype=torch.bool)
    mask[0, 5:s - 40] = True                     # left pad + unfilled tail
    # row 1 stays fully masked → zeros
    mask[2, s - 1] = True                         # visible only in its last slot
    mask[3, 130:150] = True                       # short fill in a long row
    mask[3, torch.from_numpy(rng.random(s) > 0.9)] = True  # and scattered holes
    scales = {}
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, mask, scales


VARIANTS = {
    "d64": dict(),
    "int8": dict(int8=True),
    "softcap25": dict(softcap=25.0),
    "d128": dict(d=128, h=14),
    "d256_int8_softcap": dict(d=256, h=4, kh=2, int8=True, softcap=25.0),
}


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_then_combine_equals_one_pass(variant, nsplit):
    kw = dict(VARIANTS[variant])
    softcap = kw.pop("softcap", None)
    q, k, v, mask, scales = _inputs(nsplit, **kw)
    attn = dict(scale=q.shape[-1] ** -0.5, logit_softcap=softcap, **scales)
    acc, m, l = da.decode_attention_split_plain(q, k, v, mask, nsplit=nsplit, **attn)
    b, kh = k.shape[0], k.shape[2]
    g, d = q.shape[2] // kh, q.shape[3]
    assert acc.shape == (b, kh, nsplit, g, d) and m.shape == l.shape == (b, kh, nsplit, g)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    out = da.combine_splits_plain(acc, m, l, q.dtype).reshape(q.shape)
    want = da.decode_attention_plain(q, k, v, mask, **attn)
    torch.testing.assert_close(out, want, **TOL)
    assert not out[1].any()  # fully masked row → zeros
    assert bool((l[1] == 0).all()) and bool((m[1] == NEG_INF).all())


@pytest.mark.parametrize("nsplit", [3, 7, 16])
def test_empty_splits_write_neutral_partials(nsplit):
    """Row 3's short fill spans three tiles: with more splits than that,
    the splits that get no tile (or no visible slot) hold l = 0,
    m = NEG_INF and acc = 0, and the combine ignores them."""
    q, k, v, mask, _ = _inputs(0, s=1024)
    mask[3] = False
    mask[3, 130:300] = True  # tiles 2..4 of 16
    acc, m, l = da.decode_attention_split_plain(q, k, v, mask, nsplit=nsplit, scale=0.125)
    empty = l[3, 0, :, 0] == 0
    assert int((~empty).sum()) == min(nsplit, 3)
    assert bool((m[3][:, empty] == NEG_INF).all()) and not acc[3][:, empty].any()
    out = da.combine_splits_plain(acc, m, l, torch.float32).reshape(q.shape)
    torch.testing.assert_close(out, da.decode_attention_plain(q, k, v, mask, scale=0.125), **TOL)


def test_split_bounds_follow_the_visible_band():
    """Split ranges cut the row's own band [first, last], not the slab."""
    mask = torch.zeros((2, 640), dtype=torch.bool)
    mask[0, 130:400] = True      # tiles 2..6 (five)
    mask[1, 639] = True          # tile 9 only
    bounds = da._split_bounds(mask, 3, 64)
    assert bounds[0].tolist() == [2, 3, 5, 7]
    assert bounds[1].tolist() == [9, 9, 9, 10]
    empty = da._split_bounds(torch.zeros((1, 64), dtype=torch.bool), 2, 64)
    assert empty[0, 0] == empty[0, -1]


def test_combine_plain_rules():
    """Hand-made partials: a dead split with a large m never enters, and a
    row whose splits are all dead gives zeros."""
    acc = torch.tensor([[[[2.0]], [[9.0]], [[1.0]]]])  # [1, N=3, G=1, D=1]
    m = torch.tensor([[[0.0], [50.0], [1.0]]])
    l = torch.tensor([[[1.0], [0.0], [2.0]]])
    out = da.combine_splits_plain(acc, m, l, torch.float32)
    w0, w2 = np.exp(-1.0), 1.0
    assert out.shape == (1, 1, 1)
    np.testing.assert_allclose(out.item(), (w0 * 2.0 + w2 * 1.0) / (w0 * 1.0 + w2 * 2.0), rtol=1e-6)
    dead = da.combine_splits_plain(acc, torch.full_like(m, NEG_INF), torch.zeros_like(l),
                                   torch.bfloat16)
    assert dead.dtype == torch.bfloat16 and not dead.any()


# ----------------------------------------------------------------------
# the wrappers on CPU tensors
# ----------------------------------------------------------------------

def test_wrappers_take_the_plain_path_on_cpu():
    q, k, v, mask, _ = _inputs(5)
    launches = (da.decode_attention.launches, da.decode_attention.combine_launches,
                da.decode_attention_split.launches, da.combine_splits.launches)
    parts = da.decode_attention_split(q, k, v, mask, nsplit=4, scale=0.125)
    want = da.decode_attention_split_plain(q, k, v, mask, nsplit=4, scale=0.125)
    for got, ref in zip(parts, want):
        assert torch.equal(got, ref)
    out = da.combine_splits(*parts, torch.float32)
    assert torch.equal(out, da.combine_splits_plain(*want, torch.float32))
    da.decode_attention(q, k, v, mask, scale=0.125)
    assert (da.decode_attention.launches, da.decode_attention.combine_launches,
            da.decode_attention_split.launches, da.combine_splits.launches) == launches


def test_split_wrapper_argument_checks():
    q, k, v, mask, _ = _inputs(6, s=64)
    with pytest.raises(ValueError, match="nsplit"):
        da.decode_attention_split(q, k, v, mask, nsplit=0, scale=1.0)
    with pytest.raises(ValueError, match="mask"):
        da.decode_attention_split(q, k, v, mask[:, :10], nsplit=2, scale=1.0)
    acc = torch.zeros(2, 3, 4, 64)
    with pytest.raises(ValueError, match="combine_splits"):
        da.combine_splits(acc, torch.zeros(2, 3, 5), torch.zeros(2, 3, 5), torch.float32)

"""The flash kernel's tile plan and tile classes on the CPU.

``csrc/flash_attention.cu`` runs only on the card; what decides which kv
tiles a warp skips, masks or runs unmasked is mirrored in Python
(``kv_band``, ``tile_class``) and held here against a brute-force causal
+ window + S mask, and against the JAX kernel's ``_kv_block_bounds``.
A numpy emulation of the tensor-core kernel's loop (per-warp classes,
online softmax in the log2 domain, P rounded before the PV product) is
held against the JAX Pallas kernel in interpret mode.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu.ops.pallas.flash_attention import _kv_block_bounds
from llm_np_cp_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_plan_fits_the_card(d, dtype):
    plan = fa.flash_plan(4096, d, dtype)
    assert 0 < plan.smem_bytes <= fa.MAX_SMEM_BYTES
    assert plan.q_tiles == -(-4096 // plan.bq)
    assert plan.mma == (dtype == torch.bfloat16)
    assert plan.warps * 32 <= 1024
    if plan.mma:
        assert plan.warp_rows in (16, 32) and plan.bq == plan.warp_rows * plan.warps
        assert plan.bkv % 16 == 0 and plan.grid(2, 8) == (16, plan.q_tiles)
        # Q once, K and V twice (double-buffered), bf16
        assert plan.smem_bytes == 2 * d * (plan.bq + 4 * plan.bkv)
    else:
        assert plan.grid(2, 8) == (plan.q_tiles, 16)
    assert fa.flash_plan(4096, d, dtype) is plan  # cached: no host cost per call


@pytest.mark.parametrize("d,dtype,exc", [(32, torch.bfloat16, ValueError),
                                         (96, torch.float32, ValueError),
                                         (64, torch.float16, TypeError)])
def test_flash_plan_refuses(d, dtype, exc):
    with pytest.raises(exc, match="flash_attention"):
        fa.flash_plan(128, d, dtype)


def _visible(s, window):
    r = np.arange(s)[:, None]
    c = np.arange(s)[None, :]
    vis = c <= r
    if window:
        vis &= r - c < window
    return vis


SWEEP = list(itertools.product(
    (1, 7, 16, 63, 64, 65, 200, 257),  # S
    (None, 1, 5, 16, 64, 100),          # window
    # (BQ, BKV, q rows a warp)
    ((16, 16, 16), (32, 16, 16), (64, 32, 16), (128, 64, 32), (64, 64, 16), (64, 32, 32)),
))


@pytest.mark.parametrize("s,window,tiles", SWEEP[::4] + SWEEP[1::4])
def test_tile_classes_match_brute_force(s, window, tiles):
    """Every warp's class of every kv tile in its q tile's band is what
    the brute-force mask says (rows >= S not counting), and no visible
    (row, column) lies outside the band or in a skipped tile."""
    bq, bkv, wr = tiles
    vis = _visible(s, window)
    covered = np.zeros_like(vis)
    for q0 in range(0, s, bq):
        jmin, jmax = fa.kv_band(q0, bq, bkv, s, window)
        jw_min, jw_max = (int(x) for x in _kv_block_bounds(q0 // bq, bq, bkv, window))
        assert jmin == jw_min and jmax == min(jw_max, (s - 1) // bkv)
        for r0 in range(q0, q0 + bq, wr):
            rows = slice(r0, min(r0 + wr, s))
            for j in range(jmin, jmax + 1):
                cols = slice(j * bkv, min(j * bkv + bkv, s))
                block = vis[rows, cols]
                full = block.size > 0 and block.all() and j * bkv + bkv <= s
                want = 0 if not block.any() else (2 if full else 1)
                assert fa.tile_class(r0, wr, j * bkv, bkv, s, window) == want, (
                    q0, r0, j)
                if want:
                    covered[rows, cols] = True
    assert not (vis & ~covered).any()


def _emulate(q, k, v, scale, softcap, window, bq, bkv, wr, p_dtype):
    """The tensor-core kernel's loop in numpy, float32: per q tile the
    band, per warp of ``wr`` rows each tile's class (skip / mask / no mask),
    scores in the log2 domain (x * unit, masked slots -inf, the running
    max guarded while a row has seen nothing), P rounded to ``p_dtype``
    before the PV product, l == 0 guarded."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    out = np.zeros_like(q)
    log2e = np.float32(np.log2(np.e))
    unit = np.float32(1.0) if softcap else np.float32(scale) * log2e
    vis = _visible(s, window)
    for bi, hi in itertools.product(range(b), range(h)):
        kh = hi // g
        for q0 in range(0, s, bq):
            jmin, jmax = fa.kv_band(q0, bq, bkv, s, window)
            for r0 in range(q0, min(q0 + bq, s), wr):
                rows = np.arange(r0, min(r0 + wr, s))
                m = np.full(len(rows), -np.inf, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), d), np.float32)
                for j in range(jmin, jmax + 1):
                    cls = fa.tile_class(r0, wr, j * bkv, bkv, s, window)
                    if cls == 0:
                        continue
                    cols = np.arange(j * bkv, min(j * bkv + bkv, s))
                    x = q[bi, rows, hi] @ k[bi, cols, kh].T
                    if softcap:
                        x = np.tanh(x * (scale / softcap)) * (softcap * log2e)
                    if cls == 1:
                        x = np.where(vis[np.ix_(rows, cols)], x, -np.inf)
                    m_new = np.maximum(m, x.max(axis=1) * unit)
                    dead = m_new == -np.inf
                    with np.errstate(invalid="ignore"):
                        alpha = np.where(dead, 1, np.exp2(m - m_new))
                    base = np.where(dead, 0, m_new)
                    p = np.exp2(x * unit - base[:, None]).astype(np.float32)
                    l = l * alpha + p.sum(axis=1)
                    pr = torch.from_numpy(p).to(p_dtype).float().numpy()
                    acc = acc * alpha[:, None] + pr @ v[bi, cols, kh]
                    m = m_new
                out[bi, rows, hi] = acc / np.where(l == 0, 1, l)[:, None]
    return out


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kh,softcap,window,tiles", [
    (100, 4, 2, None, None, (32, 16, 16)),  # ragged tail
    (90, 2, 1, 30.0, 24, (64, 16, 32)),     # softcap + a window that ends mid-tile
    (37, 4, 1, None, 5, (64, 32, 16)),      # one q tile, window shorter than a warp
])
def test_emulated_kernel_matches_pallas(p_dtype, s, h, kh, softcap, window, tiles):
    rng = np.random.default_rng(s)
    d = 16
    q = (2 * rng.standard_normal((1, s, h, d))).astype(np.float32)
    k = (2 * rng.standard_normal((1, s, kh, d))).astype(np.float32)
    v = rng.standard_normal((1, s, kh, d)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d ** -0.5,
                              logit_softcap=softcap, window=window, block_q=32, block_kv=32,
                              interpret=True))
    got = _emulate(q, k, v, d ** -0.5, softcap, window, *tiles, p_dtype)
    # float32: summation order only; bf16 P: one rounding of each weight
    # (2^-9 relative), averaged over the row's visible slots
    np.testing.assert_allclose(got, want, atol=2e-5 if p_dtype == torch.float32 else 1e-2)

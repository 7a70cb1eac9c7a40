"""The port's slab kernel wrappers (flash and decode attention, the
sampling epilogue with float and int8 heads, softmax) on CPU tensors
(their plain versions) against the JAX package's Pallas kernels in
interpret mode, in float32.

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``
holds each one against its plain version there.  Here the plain versions
are held against the TPU kernels' own semantics (masking, re-zeroed
fully-masked rows, int8 dequantisation, first-occurrence argmax), and the
wrappers' CPU dispatch, argument checks and launcher bindings are pinned.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from llm_np_cp_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from llm_np_cp_tpu.ops.pallas.sample_epilogue import sample_epilogue as j_epilogue
from llm_np_cp_tpu.ops.pallas.softmax import softmax as j_softmax
from llm_np_cp_tpu.quant import quantize_array as j_quantize_array
from llm_np_cp_tpu_torch import quant as tq
from llm_np_cp_tpu_torch.ops.cuda import build
from llm_np_cp_tpu_torch.ops.cuda.decode_attention import (
    combine_splits,
    decode_attention,
    decode_attention_split,
)
from llm_np_cp_tpu_torch.ops.cuda.flash_attention import flash_attention
from llm_np_cp_tpu_torch.ops.cuda.sample_epilogue import sample_epilogue
from llm_np_cp_tpu_torch.ops.cuda.softmax import softmax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5  # float32 on both sides; only summation order differs


def _np(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ----------------------------------------------------------------------
# flash_attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,s,h,kh,d,softcap,window",
    [
        (2, 64, 4, 2, 16, None, None),     # GQA
        (1, 100, 4, 1, 16, None, None),    # ragged tail: S not a block multiple
        (1, 64, 2, 2, 32, 20.0, None),     # softcap
        (2, 80, 4, 2, 16, None, 24),       # sliding window
        (1, 150, 8, 2, 16, 30.0, 40),      # all together
    ],
)
def test_flash_plain_matches_pallas(b, s, h, kh, d, softcap, window):
    rng = np.random.default_rng(s + h)
    q, k, v = _np(rng, (b, s, h, d), 2), _np(rng, (b, s, kh, d), 2), _np(rng, (b, s, kh, d))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d ** -0.5,
                   logit_softcap=softcap, window=window, block_q=32, block_kv=32,
                   interpret=True)
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          scale=d ** -0.5, logit_softcap=softcap, window=window)
    assert flash_attention.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16), scale=1.0)


# ----------------------------------------------------------------------
# decode_attention
# ----------------------------------------------------------------------

def _decode_inputs(rng, b=3, s=70, h=8, kh=2, d=16):
    q = _np(rng, (b, 1, h, d), 2)
    k = _np(rng, (b, s, kh, d), 2)
    v = _np(rng, (b, s, kh, d))
    mask = np.zeros((b, s), bool)
    mask[0, 5:60] = True          # left pad + unfilled tail
    mask[1, rng.random(s) > 0.4] = True  # ragged holes
    # row 2 stays fully masked: both sides must give zeros
    return q, k, v, mask


@pytest.mark.parametrize("softcap", [None, 25.0])
def test_decode_plain_matches_pallas(softcap):
    rng = np.random.default_rng(1)
    q, k, v, mask = _decode_inputs(rng)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                    scale=0.25, logit_softcap=softcap, block_s=32, interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(mask), scale=0.25, logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[2].any()  # fully masked row → zeros, not the mean of V


def test_decode_int8_plain_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v, mask = _decode_inputs(rng)
    kq, ks = jcache.quantize_kv(jnp.asarray(k))
    vq, vs = jcache.quantize_kv(jnp.asarray(v))
    want = j_decode(jnp.asarray(q), kq, vq, jnp.asarray(mask), k_scale=ks, v_scale=vs,
                    scale=0.25, block_s=32, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = decode_attention(torch.from_numpy(q), t(kq), t(vq), torch.from_numpy(mask),
                           k_scale=t(ks), v_scale=t(vs), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 16])
@pytest.mark.parametrize("softcap,int8", [(None, False), (25.0, False), (None, True)])
def test_decode_split_combine_matches_pallas(nsplit, softcap, int8):
    """The split kernel's plain version over ``nsplit`` ranges of each
    row's band, then the combine's, against the one-pass TPU kernel."""
    rng = np.random.default_rng(3 + nsplit)
    q, k, v, mask = _decode_inputs(rng, s=200)
    jkw, tkw = {}, {}
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if int8:
        jk, ks = jcache.quantize_kv(jk)
        jv, vs = jcache.quantize_kv(jv)
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = {name: torch.from_numpy(np.array(a)) for name, a in jkw.items()}
    want = j_decode(jnp.asarray(q), jk, jv, jnp.asarray(mask), scale=0.25,
                    logit_softcap=softcap, block_s=32, interpret=True, **jkw)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    parts = decode_attention_split(t(q), t(jk), t(jv), t(mask), nsplit=nsplit, scale=0.25,
                                   logit_softcap=softcap, **tkw)
    got = combine_splits(*parts, torch.float32).reshape(q.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[2].any()


def test_decode_argument_checks():
    q = torch.zeros(1, 1, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    mask = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="int8"):
        decode_attention(q, kv.to(torch.int8), kv.to(torch.int8), mask, scale=1.0)
    with pytest.raises(ValueError, match="q_len=1"):
        decode_attention(torch.zeros(1, 2, 4, 16), kv, kv, mask, scale=1.0)
    with pytest.raises(ValueError, match="mask"):
        decode_attention(q, kv, kv, mask.float(), scale=1.0)


# ----------------------------------------------------------------------
# sample_epilogue
# ----------------------------------------------------------------------

# (tied, softcap, unit_offset, N, V): N=5 and V=300, a multi-tile vocab
# with a ragged tail; then N=9 (the kernel's second row pass) with an odd V
# (an untied head whose rows are not 16-byte aligned: the scalar loads)
EPILOGUE_CASES = [(True, None, False, 5, 300), (False, None, False, 5, 300),
                  (True, 2.0, True, 5, 300), (False, 30.0, True, 5, 300),
                  (True, None, False, 9, 301), (False, None, False, 9, 301),
                  (False, 30.0, True, 9, 777)]
EPILOGUE_IDS = ["True-None-False", "False-None-False", "True-2.0-True", "False-30.0-True",
                "n9-v301-tied", "n9-v301-untied", "n9-v777-untied-softcap30-unit"]


@pytest.mark.parametrize("tied,softcap,unit_offset,n,v", EPILOGUE_CASES, ids=EPILOGUE_IDS)
def test_epilogue_plain_matches_pallas(tied, softcap, unit_offset, n, v):
    rng = np.random.default_rng(3)
    h = 64
    x = _np(rng, (n, h))
    gamma = _np(rng, (h,), 0.3) + (0.0 if unit_offset else 1.0)
    w = _np(rng, (v, h) if tied else (h, v), 0.5)
    kw = dict(tied=tied, eps=1e-6, unit_offset=unit_offset, logit_softcap=softcap)
    want = j_epilogue(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(w), block_v=128,
                      interpret=True, **kw)
    got = sample_epilogue(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(w), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_epilogue_exact_tie_takes_first_index():
    """Columns 7, 150 and 299 (three vocab tiles) give identical logits:
    both kernels' first-occurrence rule picks 7.  A tiny softcap saturates
    every large logit to the same value too."""
    rng = np.random.default_rng(4)
    n, h, v = 3, 32, 300
    x = np.abs(_np(rng, (n, h))) + 0.1
    w = _np(rng, (v, h), 0.01)
    w[[7, 150, 299]] = 1.0
    gamma = np.ones(h, np.float32)
    for softcap in (None, 1e-3):
        kw = dict(tied=True, eps=1e-6, logit_softcap=softcap)
        want = np.asarray(j_epilogue(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(w),
                                     block_v=128, interpret=True, **kw))
        got = sample_epilogue(torch.from_numpy(x), torch.from_numpy(gamma),
                              torch.from_numpy(w), **kw).numpy()
        np.testing.assert_array_equal(got, want)
        if softcap is None:
            assert (got == 7).all()


@pytest.mark.parametrize("tied,softcap,unit_offset,n,v", EPILOGUE_CASES, ids=EPILOGUE_IDS)
def test_epilogue_int8_plain_matches_pallas(tied, softcap, unit_offset, n, v):
    """int8 heads (quant.py "q" payloads, quantized by the JAX package):
    the payload as float, the float32 product times the per-column scale,
    then softcap and argmax — the TPU kernel's quantized=True branch."""
    rng = np.random.default_rng(5)
    h = 64
    x = _np(rng, (n, h))
    gamma = _np(rng, (h,), 0.3) + (0.0 if unit_offset else 1.0)
    wf = _np(rng, (v, h) if tied else (h, v), 0.5)
    wq = j_quantize_array(jnp.asarray(wf), axis=-1 if tied else -2)
    ws = np.array(wq["s"]).reshape(1, -1)
    kw = dict(tied=tied, eps=1e-6, unit_offset=unit_offset, logit_softcap=softcap)
    want = j_epilogue(jnp.asarray(x), jnp.asarray(gamma), wq["q"], w_scale=jnp.asarray(ws),
                      block_v=128, interpret=True, **kw)
    got = sample_epilogue(torch.from_numpy(x), torch.from_numpy(gamma),
                          torch.from_numpy(np.array(wq["q"])), w_scale=torch.from_numpy(ws),
                          **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own quantization gives the same payload, hence the same tokens
    tw = tq.quantize_array(torch.from_numpy(wf), axis=-1 if tied else -2)
    again = sample_epilogue(torch.from_numpy(x), torch.from_numpy(gamma), tw["q"],
                            w_scale=tw["s"].reshape(1, -1), **kw)
    np.testing.assert_array_equal(again.numpy(), np.asarray(want))


def test_epilogue_argument_checks():
    x, g = torch.zeros(2, 16), torch.ones(16)
    with pytest.raises(ValueError, match="hidden size"):
        sample_epilogue(x, g, torch.zeros(32, 8), tied=True, eps=1e-6)
    with pytest.raises(ValueError, match="w_scale"):
        sample_epilogue(x, g, torch.zeros(32, 16, dtype=torch.int8), tied=True, eps=1e-6)
    with pytest.raises(ValueError, match="w_scale"):
        sample_epilogue(x, g, torch.zeros(32, 16), tied=True, eps=1e-6,
                        w_scale=torch.ones(1, 32))
    with pytest.raises(ValueError, match="vocab"):
        sample_epilogue(x, g, torch.zeros(32, 16, dtype=torch.int8), tied=True, eps=1e-6,
                        w_scale=torch.ones(1, 31))


# ----------------------------------------------------------------------
# softmax
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((3, 5, 257), 10.0), ((4, 64), 1000.0), ((7, 3), 1.0)])
def test_softmax_plain_matches_pallas(shape, scale):
    """Leading axes flattened to rows (the 8-row tiles pad), and the large
    magnitudes of the JAX package's own stability test."""
    x = (scale * np.random.default_rng(6).standard_normal(shape)).astype(np.float32)
    want = np.asarray(j_softmax(jnp.asarray(x), interpret=True))
    before = softmax.launches
    got = softmax(torch.from_numpy(x))
    assert softmax.launches == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-5)


def _emulate_cluster_softmax(x: np.ndarray, chunks: int) -> np.ndarray:
    """The cluster kernel's arithmetic in numpy, float32: each of
    ``chunks`` blocks takes its running (max, sum of exp(x - max)) over its
    chunk of the row, the blocks' pairs merge (the larger max wins, the
    other sum rescaled by exp(its max - the larger); a chunk with max
    -inf never enters), and every element is exp(x - M) / S."""
    rows, n = x.shape
    size = -(-n // chunks)
    m_row = np.full(rows, -np.inf, np.float32)
    s_row = np.zeros(rows, np.float32)
    for c in range(chunks):
        part = x[:, c * size:(c + 1) * size]
        m_c = part.max(axis=1, initial=-np.inf).astype(np.float32)
        with np.errstate(invalid="ignore"):
            s_c = np.where(m_c == -np.inf, 0,
                           np.exp(part - m_c[:, None]).sum(axis=1)).astype(np.float32)
        mm = np.maximum(m_row, m_c)
        with np.errstate(invalid="ignore"):
            s_row = np.where(mm == -np.inf, 0,
                             np.where(m_row == -np.inf, 0, s_row * np.exp(m_row - mm))
                             + np.where(m_c == -np.inf, 0, s_c * np.exp(m_c - mm)))
        m_row = mm
    with np.errstate(invalid="ignore", divide="ignore"):
        return (np.exp(x - m_row[:, None]) / s_row[:, None]).astype(np.float32)


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1000, 4099])
def test_softmax_cluster_merge_matches_pallas(chunks, n):
    """The long-row kernel's merge of per-block (max, sum) pairs, for the
    1-8 blocks a row of its clusters, against the TPU kernel in interpret
    mode: -inf entries give 0, a chunk of nothing but -inf drops out of
    the merge, and a row all -inf gives NaN on both sides."""
    x = (6.0 * np.random.default_rng(n + chunks).standard_normal((5, n))).astype(np.float32)
    x[0, ::7] = -np.inf
    x[1] = -np.inf
    x[2, : n // 2] = -np.inf  # whole chunks of -inf
    x[3] = -np.inf
    x[3, n - 1] = 2.0
    want = np.asarray(j_softmax(jnp.asarray(x), interpret=True))
    got = _emulate_cluster_softmax(x, chunks)
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], atol=1e-6)
    assert got[3, n - 1] == 1.0


def test_softmax_keeps_bf16():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 33)).astype(np.float32))
    got = softmax(x.bfloat16())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.softmax(x.bfloat16().float(), -1).bfloat16())


# ----------------------------------------------------------------------
# build and bindings (the CUDA side is compiled only on the card)
# ----------------------------------------------------------------------

def test_launcher_signatures_match_sources():
    """Every ctypes signature names an ``extern "C"`` launcher in csrc/
    with the same number of parameters."""
    decls = {}
    for src in build.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" \w[\w\s*]*?\b(\w+)\(([^)]*)\)', src.read_text()):
            decls[m.group(1)] = [p for p in m.group(2).split(",") if p.strip()]
    for name, argtypes in build.SIGNATURES.items():
        assert name in decls, name
        assert len(decls[name]) == len(argtypes), name
    assert "llm_cuda_error_string" in decls


def test_build_is_lazy_and_named_by_sources():
    """Importing the wrappers builds nothing; the library name hashes the
    sources and flags."""
    assert build._LIB is None or torch.cuda.is_available()
    sources = build._sources()
    assert {p.name for p in sources} == {
        "flash_attention.cu", "decode_attention.cu", "sample_epilogue.cu",
        "paged_decode_attention.cu", "ragged_paged_attention.cu", "softmax.cu", "threefry.cu"}
    assert build._digest() == build._digest()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_mixed_devices_rejected():
    from llm_np_cp_tpu_torch.ops.cuda import _common

    assert _common.on_cpu(torch.zeros(1), torch.zeros(2))
    with pytest.raises(ValueError, match="device"):
        _common.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))

"""The port's three kernel wrappers on CPU tensors (their plain versions)
against the JAX package's Pallas kernels in interpret mode, in float32.

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
from llm_np_cp_tpu_torch.ops.cuda import build
from llm_np_cp_tpu_torch.ops.cuda.decode_attention import decode_attention
from llm_np_cp_tpu_torch.ops.cuda.flash_attention import flash_attention
from llm_np_cp_tpu_torch.ops.cuda.sample_epilogue import sample_epilogue

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

@pytest.mark.parametrize(
    "tied,softcap,unit_offset",
    [(True, None, False), (False, None, False), (True, 2.0, True), (False, 30.0, True)],
)
def test_epilogue_plain_matches_pallas(tied, softcap, unit_offset):
    rng = np.random.default_rng(3)
    n, h, v = 5, 64, 300  # multi-tile vocab with a ragged tail
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


def test_epilogue_argument_checks():
    x, g = torch.zeros(2, 16), torch.ones(16)
    with pytest.raises(ValueError, match="hidden size"):
        sample_epilogue(x, g, torch.zeros(32, 8), tied=True, eps=1e-6)
    with pytest.raises(NotImplementedError, match="quant"):
        sample_epilogue(x, g, torch.zeros(32, 16, dtype=torch.int8), tied=True, eps=1e-6,
                        w_scale=torch.ones(1, 32))


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
        "flash_attention.cu", "decode_attention.cu", "sample_epilogue.cu"}
    assert build._digest() == build._digest()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_mixed_devices_rejected():
    from llm_np_cp_tpu_torch.ops.cuda import _common

    assert _common.on_cpu(torch.zeros(1), torch.zeros(2))
    with pytest.raises(ValueError, match="device"):
        _common.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))

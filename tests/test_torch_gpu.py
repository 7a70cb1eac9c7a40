"""Each CUDA kernel of the port against its plain PyTorch version on the
card.  Marked ``gpu``: on a machine without a card every test skips (the
card is looked for inside the ``cuda`` fixture, never at import).  This
file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import pytest
import torch

from llm_np_cp_tpu_torch.cache import quantize_kv
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se

pytestmark = pytest.mark.gpu

# |kernel - plain| <= TOL * (1 + |plain|): two ulps of the output's type
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(out, ref, dtype):
    diff = (out.float() - ref.float()).abs()
    bound = TOL[dtype] * (1.0 + ref.float().abs())
    assert bool((diff <= bound).all()), f"max error {diff.max().item()}"


def _randn(shape, gen, dtype, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,h,kh,d,softcap,window",
    [
        (2, 128, 8, 2, 64, None, None),
        (1, 200, 4, 4, 128, None, None),   # ragged tail
        (1, 300, 4, 2, 256, 50.0, 64),     # Gemma-2: softcap + window, D=256
        (3, 7, 2, 1, 64, None, 3),
    ],
)
def test_flash_attention_kernel(cuda, dtype, b, s, h, kh, d, softcap, window):
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (_randn(sh, g, dtype, 2) for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    kw = dict(scale=d ** -0.5, logit_softcap=softcap, window=window)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_close(out, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s,h,kh,d", [(96, 8, 2, 64), (300, 8, 4, 256), (1000, 14, 2, 128)])
def test_decode_attention_kernel(cuda, dtype, int8, s, h, kh, d):
    g = torch.Generator(device="cuda").manual_seed(s + int8)
    b = 4
    q = _randn((b, 1, h, d), g, dtype, 2)
    k, v = _randn((b, s, kh, d), g, dtype, 2), _randn((b, s, kh, d), g, dtype)
    mask = torch.rand((b, s), generator=g, device="cuda") > 0.3
    mask[1] = False  # fully masked row → zeros
    mask[2, : s // 2] = False  # left pad
    kw = dict(scale=d ** -0.5, logit_softcap=30.0 if d == 256 else None)
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        kw.update(k_scale=ks, v_scale=vs)
    out = da.decode_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    _assert_close(out, da.decode_attention_plain(q, k, v, mask, **kw), dtype)
    assert not out[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,hd,vocab,tied,softcap,unit",
    [(4, 256, 1000, True, None, False), (3, 512, 3001, False, 30.0, True),
     (11, 128, 777, True, 5.0, True), (1, 64, 256, False, None, False)],
)
def test_sample_epilogue_kernel(cuda, dtype, n, hd, vocab, tied, softcap, unit):
    g = torch.Generator(device="cuda").manual_seed(vocab)
    x = _randn((n, hd), g, dtype)
    gamma = (0.1 * torch.randn((hd,), generator=g, device="cuda") + (0.0 if unit else 1.0)).to(dtype)
    w = _randn((vocab, hd) if tied else (hd, vocab), g, dtype, 0.1)
    kw = dict(tied=tied, eps=1e-6, unit_offset=unit, logit_softcap=softcap)
    got = se.sample_epilogue(x, gamma, w, **kw)
    want = se.sample_epilogue_plain(x, gamma, w, **kw)
    if not torch.equal(got, want):
        # only rows whose best two logits are within float32 noise may differ
        from llm_np_cp_tpu_torch.ops.norms import rms_norm

        xn = rms_norm(x, gamma, eps=1e-6, unit_offset=unit).float()
        logits = xn @ (w.float().T if tied else w.float())
        if softcap is not None:
            logits = torch.tanh(logits / softcap) * softcap
        picked = logits.gather(-1, got.long()[:, None])[:, 0]
        assert bool(((logits.amax(-1) - picked) <= 1e-4).all())


def test_sample_epilogue_exact_tie(cuda):
    """Identical columns in different vocab tiles: the lowest index wins."""
    x = torch.ones((2, 64), device="cuda")
    w = torch.zeros((1000, 64), device="cuda")
    w[[300, 20, 999]] = 1.0
    got = se.sample_epilogue(x, torch.ones(64, device="cuda"), w, tied=True, eps=1e-6)
    assert got.tolist() == [20, 20]


def test_kernel_argument_errors(cuda):
    q = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        qq = torch.zeros((1, 2, 8, 64), device="cuda").transpose(1, 2)
        fa.flash_attention(qq, qq, qq, scale=1.0)

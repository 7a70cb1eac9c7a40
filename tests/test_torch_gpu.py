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
from llm_np_cp_tpu_torch.ops.cuda import softmax as sm
from llm_np_cp_tpu_torch.ops.cuda import threefry as tf
from llm_np_cp_tpu_torch.quant import quant_einsum, quantize_array, quantize_params
from tick_clock import clocked

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _assert_close_rows(out, ref, dtype):
    """``_assert_close`` and, besides, within TOL times the largest |ref|
    of each head row (the last axis): over a long causal row the outputs
    are ~sqrt(e / S), below the 1 + |ref| floor."""
    _assert_close(out, ref, dtype)
    diff = (out.float() - ref.float()).abs()
    bound = TOL[dtype] * ref.float().abs().amax(dim=-1, keepdim=True)
    assert bool((diff <= bound).all()), f"max error {diff.max().item()} against the row bound"


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
        (2, 1, 4, 2, 64, None, None),      # one token
        (1, 1000, 4, 2, 64, 30.0, None),   # ragged tail past the last full q tile
        (1, 333, 4, 1, 256, None, 100),    # a window that ends mid kv tile
        (1, 517, 16, 4, 128, None, None),  # D=128, group 4, ragged tail
        (1, 4096, 32, 8, 64, None, None),  # Llama-3.2-1B widths, a long prompt
    ],
)
def test_flash_attention_kernel(cuda, dtype, b, s, h, kh, d, softcap, window):
    """bf16 is held to both the 1 + |ref| and the per-row bound."""
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (_randn(sh, g, dtype, 2) for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    kw = dict(scale=d ** -0.5, logit_softcap=softcap, window=window)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    check = _assert_close_rows if dtype == torch.bfloat16 else _assert_close
    check(out, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 96, 8, 2, 64), (4, 300, 8, 4, 256), (4, 1000, 14, 2, 128),
    (4, 4096, 32, 8, 64),   # Llama-3.2-1B widths, long cache: 8 splits (two blocks per SM)
    (1, 32768, 32, 8, 64),  # one long-context row: 33 splits
])
def test_decode_attention_kernel(cuda, dtype, int8, b, s, h, kh, d):
    """The split kernel (+ combine when split_plan gives NSPLIT > 1)
    against the one-pass plain version; ``launches`` counts every call,
    ``combine_launches`` the calls with NSPLIT > 1."""
    g = torch.Generator(device="cuda").manual_seed(s + int8)
    q = _randn((b, 1, h, d), g, dtype, 2)
    k, v = _randn((b, s, kh, d), g, dtype, 2), _randn((b, s, kh, d), g, dtype)
    mask = torch.rand((b, s), generator=g, device="cuda") > 0.3
    if b > 1:
        mask[1] = False  # fully masked row → zeros
        mask[2, : s // 2] = False  # left pad
        mask[3] = False
        mask[3, s // 3: s // 3 + 40] = True  # short fill in a long row
    kw = dict(scale=d ** -0.5, logit_softcap=30.0 if d == 256 else None)
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        kw.update(k_scale=ks, v_scale=vs)
    nsplit = da.split_plan(b, kh, s, d, da.sm_count(q.device), h // kh)
    if s >= 4096:
        assert nsplit > 1
    before = (da.decode_attention.launches, da.decode_attention.combine_launches)
    out = da.decode_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before[0] + 1
    assert da.decode_attention.combine_launches == before[1] + (nsplit > 1)
    _assert_close(out, da.decode_attention_plain(q, k, v, mask, **kw), dtype)
    if b > 1:
        assert not out[1].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nsplit", [1, 3, 8, 40])
def test_decode_split_kernel_partials(cuda, int8, nsplit):
    """The split kernel alone (no combine) against its plain version, in
    float32: the partials (acc, m, l) of every split, empty ones included
    (l = 0, m = NEG_INF, acc = 0)."""
    g = torch.Generator(device="cuda").manual_seed(nsplit)
    b, s, h, kh, d = 4, 1000, 8, 2, 128
    q = _randn((b, 1, h, d), g, torch.float32, 2)
    k, v = _randn((b, s, kh, d), g, torch.float32, 2), _randn((b, s, kh, d), g, torch.float32)
    mask = torch.rand((b, s), generator=g, device="cuda") > 0.3
    mask[1] = False
    mask[3] = False
    mask[3, 300:340] = True
    kw = dict(scale=d ** -0.5)
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        kw.update(k_scale=ks, v_scale=vs)
    before = (da.decode_attention_split.launches, da.decode_attention.launches,
              da.decode_attention.combine_launches)
    got = da.decode_attention_split(q, k, v, mask, nsplit=nsplit, **kw)
    torch.cuda.synchronize()
    assert (da.decode_attention_split.launches - 1, da.decode_attention.launches,
            da.decode_attention.combine_launches) == before
    want = da.decode_attention_split_plain(q, k, v, mask, nsplit=nsplit, **kw)
    for name, a, ref in zip("acc m l".split(), got, want):
        assert a.shape == ref.shape, name
        _assert_close(a, ref, torch.float32)
    assert not got[2][1].any() and not got[0][1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,nsplit,rows,d", [(32, 9, 4, 64), (8, 33, 4, 64), (3, 5, 7, 128),
                                             (2, 2, 2, 256), (5, 1, 4, 64)])
def test_combine_kernel(cuda, dtype, r, nsplit, rows, d):
    """The combine alone against its plain version on the same partials,
    with dead splits (l = 0, m = NEG_INF) and a row of all-dead splits."""
    from llm_np_cp_tpu_torch.ops.attention import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(r * nsplit)
    acc = _randn((r, nsplit, rows, d), g, torch.float32, 3)
    m = _randn((r, nsplit, rows), g, torch.float32, 4)
    l = 10 * torch.rand((r, nsplit, rows), generator=g, device="cuda") + 0.1
    dead = torch.rand((r, nsplit, rows), generator=g, device="cuda") < 0.3
    dead[0] = True
    acc[dead], m[dead], l[dead] = 0.0, NEG_INF, 0.0
    before = da.combine_splits.launches
    out = da.combine_splits(acc, m, l, dtype)
    torch.cuda.synchronize()
    assert da.combine_splits.launches == before + 1
    assert out.shape == (r, rows, d) and out.dtype == dtype
    _assert_close(out, da.combine_splits_plain(acc, m, l, dtype), dtype)
    assert not out[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,hd,vocab,tied,softcap,unit",
    [(4, 256, 1000, True, None, False), (3, 512, 3001, False, 30.0, True),
     (11, 128, 777, True, 5.0, True), (1, 64, 256, False, None, False),
     # untied 16-byte rows (the vector loads), N=8 and N=9 (a second row pass)
     (8, 2304, 4096, False, None, False), (9, 200, 1040, False, 30.0, True),
     # untied odd vocab (the scalar loads) and N=16; H=136 and H=200 are not
     # multiples of the warps' slices of H
     (16, 136, 3001, False, None, False), (1, 2048, 1001, False, None, True),
     # tied N=1, 8, 9, 16
     (1, 2048, 3000, True, None, False), (8, 2048, 5000, True, 30.0, False),
     (9, 96, 600, True, None, True), (16, 256, 2000, True, None, False),
     # tied at Gemma-2-27B's width: bf16 rows kept as bf16 in shared memory
     (8, 4608, 2000, True, 30.0, True)],
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


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n,tied,softcap", [(2, True, None), (4, False, 30.0), (8, True, 30.0)])
def test_sample_epilogue_returns_the_row_maximum(cuda, n, tied, softcap, int8):
    """``return_max``: the kernel's token and each row's largest logit
    (from the tiles' bests it writes) against the plain version's — what
    a tensor-parallel head merges its vocab shards by."""
    g = torch.Generator(device="cuda").manual_seed(n + 31)
    hd, vocab = 256, 3001 if not tied else 2000
    x = _randn((n, hd), g, torch.bfloat16)
    gamma = (0.1 * torch.randn((hd,), generator=g, device="cuda") + 1.0).bfloat16()
    w = _randn((vocab, hd) if tied else (hd, vocab), g, torch.bfloat16, 0.1)
    kw = dict(tied=tied, eps=1e-6, logit_softcap=softcap)
    if int8:
        wq = quantize_array(w, axis=-1 if tied else -2)
        w, kw["w_scale"] = wq["q"], wq["s"].reshape(1, -1)
    tok, best = se.sample_epilogue(x, gamma, w, return_max=True, **kw)
    want_tok, want_best = se.sample_epilogue_plain(x, gamma, w, return_max=True, **kw)
    assert torch.equal(tok, se.sample_epilogue(x, gamma, w, **kw))
    assert best.dtype == torch.float32 and best.shape == (n,)
    assert (best - want_best).abs().max().item() <= 1e-3
    same = tok == want_tok
    assert bool(same.all()) or bool(((want_best - best).abs() <= 1e-4)[~same].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,hd,vocab,tied,softcap,unit",
    [(4, 256, 1000, True, None, False), (3, 512, 3001, False, 30.0, True),
     (11, 128, 777, True, 5.0, True), (8, 64, 256, False, None, False),
     # untied 16-byte rows (the vector loads), N=8 and N=9 (a second row pass)
     (8, 2304, 4096, False, None, False), (9, 208, 1040, False, 30.0, True),
     # untied vocab not a multiple of 16 (the scalar loads) and N=16; H=208
     # and H=144 are not multiples of the warps' slices of H
     (16, 144, 1000, False, None, False), (1, 2048, 1001, False, None, True),
     # tied N=1, 8, 9, 16
     (1, 2048, 3000, True, None, False), (8, 2048, 5000, True, 30.0, False),
     (9, 96, 600, True, None, True), (16, 256, 2000, True, None, False),
     # tied at Gemma-2-27B's width, N=5 (three spare rows in the pass):
     # bf16 rows kept as bf16 in shared memory
     (5, 4608, 2000, True, None, False)],
)
def test_sample_epilogue_int8_kernel(cuda, dtype, n, hd, vocab, tied, softcap, unit):
    """int8 heads: the kernel's variant of its own (``launches_int8``)
    against the plain version over the same payload and scales."""
    g = torch.Generator(device="cuda").manual_seed(vocab + 1)
    x = _randn((n, hd), g, dtype)
    gamma = (0.1 * torch.randn((hd,), generator=g, device="cuda") + (0.0 if unit else 1.0)).to(dtype)
    wq = quantize_array(_randn((vocab, hd) if tied else (hd, vocab), g, torch.float32, 0.1),
                        axis=-1 if tied else -2)
    w, ws = wq["q"], wq["s"].reshape(1, -1)
    kw = dict(w_scale=ws, tied=tied, eps=1e-6, unit_offset=unit, logit_softcap=softcap)
    before, before_float = se.sample_epilogue.launches_int8, se.sample_epilogue.launches
    got = se.sample_epilogue(x, gamma, w, **kw)
    torch.cuda.synchronize()
    assert se.sample_epilogue.launches_int8 == before + 1
    assert se.sample_epilogue.launches == before_float
    want = se.sample_epilogue_plain(x, gamma, w, **kw)
    if not torch.equal(got, want):
        from llm_np_cp_tpu_torch.ops.norms import rms_norm

        xn = rms_norm(x, gamma, eps=1e-6, unit_offset=unit).float()
        logits = (xn @ (w.float().T if tied else w.float())) * ws
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


@pytest.mark.parametrize("dtype,vocab", [(torch.float32, 1000), (torch.bfloat16, 1001)])
def test_sample_epilogue_exact_tie_untied(cuda, dtype, vocab):
    """Untied: identical columns in different vocab tiles, through the
    vector loads (V * 4 bytes a multiple of 16) and the scalar ones (an
    odd V): the lowest index wins, after the warps' partial dots are
    summed."""
    x = torch.ones((2, 64), device="cuda", dtype=dtype)
    w = torch.zeros((64, vocab), device="cuda", dtype=dtype)
    w[:, [300, 20, vocab - 1]] = 1.0
    got = se.sample_epilogue(x, torch.ones(64, device="cuda", dtype=dtype), w, tied=False,
                             eps=1e-6)
    assert got.tolist() == [20, 20]


def _assert_softmax_close(out, ref, dtype):
    """Within 1e-6 in float32, within two bf16 ulps of the output's own
    magnitude in bf16; NaN exactly where the plain version has NaN."""
    nan = torch.isnan(ref.float())
    assert torch.equal(torch.isnan(out.float()), nan)
    diff = (out.float() - ref.float()).abs()[~nan]
    bound = 1e-6 if dtype == torch.float32 else 2.0 ** -6 * ref.float().abs()[~nan] + 1e-30
    assert bool((diff <= bound).all()), f"max error {diff.max().item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128256), (3, 5, 257), (512, 128), (2, 1), (5, 1025),
                                   (1, 3000), (16, 1024), (16384, 128), (4, 2047), (3, 70001)])
def test_softmax_kernel(cuda, dtype, shape):
    """Rows a few to a warp (short axes) and rows split over a cluster of
    blocks (long axes; odd widths take scalar loads) against the float32
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = _randn(shape, g, dtype, 4.0)
    before = sm.softmax.launches
    out = sm.softmax(x)
    torch.cuda.synchronize()
    assert sm.softmax.launches == before + 1 and out.dtype == dtype and out.shape == x.shape
    _assert_softmax_close(out, sm.softmax_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128256), (40, 128256), (66, 128256), (132, 128256),
                                   (1, 2 ** 21)])
def test_softmax_kernel_cluster_sizes(cuda, dtype, shape):
    """Vocab rows over clusters of 8, 4, 2 and 1 blocks (the launcher
    takes as many blocks a row as fill the 132 SMs, at most 8), and one
    row of 2M elements, longer than a cluster holds in registers (the
    two-read stream inside the same kernel)."""
    x = _randn(shape, torch.Generator(device="cuda").manual_seed(shape[0]), dtype, 4.0)
    out = sm.softmax(x)
    torch.cuda.synchronize()
    _assert_softmax_close(out, sm.softmax_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [128, 1000, 128256])
def test_softmax_kernel_inf_entries(cuda, dtype, n):
    """-inf entries give 0, a row all -inf gives NaN (as the plain
    version), a row -inf but for one entry gives a one-hot row; short
    rows and cluster rows."""
    g = torch.Generator(device="cuda").manual_seed(n)
    x = _randn((4, n), g, dtype, 4.0)
    x[0, ::3] = -float("inf")
    x[1] = -float("inf")
    x[2] = -float("inf")
    x[2, n // 2] = 1.0
    out = sm.softmax(x)
    torch.cuda.synchronize()
    _assert_softmax_close(out, sm.softmax_plain(x), dtype)
    assert bool(torch.isnan(out[1].float()).all()) and out[2, n // 2].item() == 1.0


def test_softmax_large_values(cuda):
    x = 1000.0 * torch.randn((4, 64), generator=torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    out = sm.softmax(x)
    assert bool(torch.isfinite(out).all())
    assert bool(((out.sum(-1) - 1.0).abs() <= 1e-5).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("key", ["q", "qa", "q4", "q4a"])
@pytest.mark.parametrize("rows", [1, 4, 40])
def test_quant_einsum_on_the_card(cuda, dtype, key, rows):
    """The card's products against the CPU's on the same payloads: the
    W8A8 / W4A8 int32 product (rows padded past cuBLAS's 16-row minimum)
    is exact, so float32 results are equal; the weight-only products
    differ by summation order only."""
    g = torch.Generator().manual_seed(rows)
    w = 0.05 * torch.randn((256, 512), generator=g)
    x = torch.randn((1, rows, 256), generator=g).to(dtype)
    p = quantize_params({"layers": {"q_proj": w[None]}}, embed=False,
                        bits=4 if key.startswith("q4") else 8, act_quant=key.endswith("a"))
    wq = {k: v[0] for k, v in p["layers"]["q_proj"].items()}
    assert key in wq
    want = quant_einsum("bsh,ho->bso", x, wq)
    got = quant_einsum("bsh,ho->bso", x.cuda(), {k: v.cuda() for k, v in wq.items()})
    assert got.dtype == torch.float32 and got.shape == (1, rows, 512)
    if key.endswith("a") and dtype == torch.float32:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to(tree, dev):
    """A param dict (quantized leaves are dicts too) on ``dev``."""
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["int8", "int8_a8", "int4", "int4_a8"])
def test_quantized_generate_on_the_card(cuda, mode):
    """A tiny float32 model quantized on the card: the Generator's decode
    tail is the int8-head epilogue (one launch per decode step, no
    float-head launch) and its tokens equal the CPU run's."""
    import numpy as np

    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2)
    kw = dict(bits=4 if mode.startswith("int4") else 8, act_quant=mode.endswith("_a8"))
    params = quantize_params(init_params(0, cfg, torch.float32, device="cpu"), **kw)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    out = {}
    for dev in ("cpu", "cuda"):
        gen = Generator(_to(params, dev), cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32, device=dev,
                        prefill_attn_impl="flash", decode_attn_impl="flash_decode")
        assert gen.epilogue_impl == "fused"
        before, before_float = se.sample_epilogue.launches_int8, se.sample_epilogue.launches
        out[dev] = gen.generate(prompts, 8).tokens
        if dev == "cuda":
            assert se.sample_epilogue.launches_int8 - before == 7
            assert se.sample_epilogue.launches == before_float
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


def test_kernel_argument_errors(cuda):
    q = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        qq = torch.zeros((1, 2, 8, 64), device="cuda").transpose(1, 2)
        fa.flash_attention(qq, qq, qq, scale=1.0)


# ----------------------------------------------------------------------
# the paged pool kernels (serve slice)
# ----------------------------------------------------------------------

def _pool(g, nbp, bs, kh, d, dtype, int8):
    k, v = _randn((nbp, bs, kh, d), g, dtype, 2), _randn((nbp, bs, kh, d), g, dtype)
    if not int8:
        return k, v, {}
    k, ks = quantize_kv(k)
    v, vs = quantize_kv(v)
    return k, v, dict(k_scale=ks, v_scale=vs)


def _tables(g, rows, mb, nbp):
    """Distinct random pool blocks per row (never scratch block 0)."""
    perm = torch.randperm(nbp - 1, generator=torch.Generator().manual_seed(nbp))[: rows * mb] + 1
    return perm.view(rows, mb).to(torch.int32).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,kh,d,bs,softcap", [(32, 8, 64, 16, None), (8, 2, 128, 8, None),
                                               (8, 4, 256, 16, 50.0)])
def test_paged_decode_attention_kernel(cuda, dtype, int8, h, kh, d, bs, softcap):
    g = torch.Generator(device="cuda").manual_seed(h + d + bs)
    b, mb = 5, 12
    k, v, scales = _pool(g, b * mb + 1, bs, kh, d, dtype, int8)
    tables = _tables(g, b, mb, b * mb + 1)
    s = mb * bs
    lengths = torch.tensor([s, s // 2 + 3, 1, 40, 17], dtype=torch.int32, device="cuda")
    pads = torch.tensor([0, 2 * bs + 1, 0, 40, 5], dtype=torch.int32, device="cuda")  # row 3: nothing
    q = _randn((b, 1, h, d), g, dtype, 2)
    kw = dict(scale=d ** -0.5, logit_softcap=softcap, **scales)
    nsplit = da.paged_split_plan(q, k, tables)
    before = (da.paged_decode_attention.launches, da.paged_decode_attention.combine_launches)
    out = da.paged_decode_attention(q, k, v, tables, lengths, pads, **kw)
    torch.cuda.synchronize()
    assert da.paged_decode_attention.launches == before[0] + 1
    assert da.paged_decode_attention.combine_launches == before[1] + (nsplit > 1)
    _assert_close(out, da.paged_decode_attention_plain(q, k, v, tables, lengths, pads, **kw), dtype)
    assert not out[3].any()


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False)])
def test_paged_decode_attention_long_row(cuda, dtype, int8):
    """One long-context row at Llama-3.2-1B widths: a table of 2048 blocks
    of 16 (32768 slots, 33 splits on an H100), the band from a left pad
    to a length short of the table's end."""
    g = torch.Generator(device="cuda").manual_seed(2048 + int8)
    h, kh, d, bs, mb = 32, 8, 64, 16, 2048
    k, v, scales = _pool(g, mb + 1, bs, kh, d, dtype, int8)
    tables = _tables(g, 1, mb, mb + 1)
    lengths = torch.tensor([mb * bs - 5], dtype=torch.int32, device="cuda")
    pads = torch.tensor([17], dtype=torch.int32, device="cuda")
    q = _randn((1, 1, h, d), g, dtype, 2)
    kw = dict(scale=d ** -0.5, **scales)
    nsplit = da.paged_split_plan(q, k, tables)
    assert nsplit > 1
    before = (da.paged_decode_attention.launches, da.paged_decode_attention.combine_launches)
    out = da.paged_decode_attention(q, k, v, tables, lengths, pads, **kw)
    torch.cuda.synchronize()
    assert (da.paged_decode_attention.launches, da.paged_decode_attention.combine_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(out, da.paged_decode_attention_plain(q, k, v, tables, lengths, pads, **kw), dtype)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nsplit", [1, 3, 8, 40])
def test_paged_decode_split_kernel_partials(cuda, int8, nsplit):
    """The paged split kernel alone (no combine) against its plain
    version, in float32: the partials (acc, m, l) of every split, empty
    ones included (l = 0, m = NEG_INF, acc = 0), with a fully padded row,
    a short band in a wide table and a length past the table (clipped)."""
    g = torch.Generator(device="cuda").manual_seed(300 + nsplit)
    b, h, kh, d, bs, mb = 4, 8, 2, 128, 16, 64
    k, v, scales = _pool(g, b * mb + 1, bs, kh, d, torch.float32, int8)
    tables = _tables(g, b, mb, b * mb + 1)
    s = mb * bs
    lengths = torch.tensor([s - 7, 90, 340, s + 50], dtype=torch.int32, device="cuda")
    pads = torch.tensor([5, 90, 300, 0], dtype=torch.int32, device="cuda")  # row 1: nothing
    q = _randn((b, 1, h, d), g, torch.float32, 2)
    kw = dict(scale=d ** -0.5, **scales)
    before = (da.paged_decode_attention_split.launches, da.paged_decode_attention.launches,
              da.paged_decode_attention.combine_launches)
    got = da.paged_decode_attention_split(q, k, v, tables, lengths, pads, nsplit=nsplit, **kw)
    torch.cuda.synchronize()
    assert (da.paged_decode_attention_split.launches - 1, da.paged_decode_attention.launches,
            da.paged_decode_attention.combine_launches) == before
    want = da.paged_decode_attention_split_plain(q, k, v, tables, lengths, pads, nsplit=nsplit,
                                                 **kw)
    for name, a, ref in zip("acc m l".split(), got, want):
        assert a.shape == ref.shape, name
        _assert_close(a, ref, torch.float32)
    assert not got[2][1].any() and not got[0][1].any()


def _ragged_meta(segments, dead_tiles=1):
    """Pack (row, first slot, tokens) segments as the engine does, with
    ``dead_tiles`` trailing dead tiles: (tile_row, qpos0, qlen) int32 on
    the card and the [T] live-lane mask."""
    qt = da.RAGGED_Q_TILE
    tile_row, qpos0, qlen, live = [], [], [], []
    for row, slot0, n in segments:
        for t in range(-(-n // qt)):
            m = min(qt, n - t * qt)
            tile_row.append(row), qpos0.append(slot0 + t * qt), qlen.append(m)
            live += [True] * m + [False] * (qt - m)
    for _ in range(dead_tiles):
        tile_row.append(0), qpos0.append(0), qlen.append(0)
        live += [False] * qt
    meta = [torch.tensor(a, dtype=torch.int32, device="cuda") for a in (tile_row, qpos0, qlen)]
    return meta, torch.tensor(live, device="cuda")


def _ragged_inputs(seed, dtype, int8, h, kh, d, bs, rows, mb, pads, segments):
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v, scales = _pool(g, rows * mb + 1, bs, kh, d, dtype, int8)
    tables = _tables(g, rows, mb, rows * mb + 1)
    meta, live = _ragged_meta(segments)
    q = _randn((live.numel(), h, d), g, dtype, 2)
    pads = torch.tensor(pads, dtype=torch.int32, device="cuda")
    return (q, k, v, tables, *meta, pads), scales, live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,kh,d,bs,softcap,window", [(32, 8, 64, 16, None, 1 << 30),
                                                      (8, 4, 256, 16, 50.0, 40),
                                                      (12, 2, 128, 8, None, 1 << 30),
                                                      (28, 4, 64, 16, None, 1 << 30),
                                                      (56, 8, 128, 16, 30.0, 50),
                                                      (8, 8, 64, 16, None, 1 << 30)])
def test_ragged_paged_attention_kernel(cuda, dtype, int8, h, kh, d, bs, softcap, window):
    """Every tile class in one launch (decode, prefill slices of 2-8 live
    lanes, a dead tile) against the plain version, at G = 4, 1, 6 and 7
    (Qwen-2: two blocks of 4 + 3 heads), D = 64 / 128 / 256; dead lanes
    exactly zero, and the combine launched when the plan splits."""
    args, scales, live = _ragged_inputs(
        h * d + bs, dtype, int8, h, kh, d, bs, 4, 10, [3, 2 * bs + 1, 0, 7],
        # (row, first slot, tokens): decode, long prefill slice, prefill, decode
        [(0, 70, 1), (1, 2 * bs + 1 + 9, 37), (2, 0, 16), (3, 7 + 50, 1)])
    q, k, _, tables = args[:4]
    kw = dict(scale=d ** -0.5, logit_softcap=softcap, **scales)
    nsplit = da.ragged_split_plan(q, k, tables, window)
    before = (da.ragged_paged_attention.launches, da.ragged_paged_attention.combine_launches)
    out = da.ragged_paged_attention(*args, window, **kw)
    torch.cuda.synchronize()
    assert (da.ragged_paged_attention.launches, da.ragged_paged_attention.combine_launches) == (
        before[0] + 1, before[1] + (nsplit > 1))
    ref = da.ragged_paged_attention_plain(*args, window, **kw)
    _assert_close(out, ref, dtype)
    assert not out[~live].any()


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False)])
@pytest.mark.parametrize("h,kh,d,window", [(32, 8, 64, 1 << 30), (32, 8, 128, 1 << 30),
                                           (8, 4, 256, 700)])
def test_ragged_paged_attention_long_bands(cuda, dtype, int8, h, kh, d, window):
    """Long bands at serve widths: decode rows at up to 2048 slots and a
    64-token prefill chunk ending at slot 1999, so the plan splits every
    band (a combine follows); held to the plain version per head row."""
    bs, mb = 16, 128
    args, scales, live = _ragged_inputs(
        d + int8, dtype, int8, h, kh, d, bs, 4, mb, [0, 5, 0, 31],
        [(0, 2047, 1), (1, 1936, 64), (2, 999, 1), (3, 1500, 1)])
    q, k, _, tables = args[:4]
    kw = dict(scale=d ** -0.5, **scales)
    assert da.ragged_split_plan(q, k, tables, window) > 1
    before = da.ragged_paged_attention.combine_launches
    out = da.ragged_paged_attention(*args, window, **kw)
    torch.cuda.synchronize()
    assert da.ragged_paged_attention.combine_launches == before + 1
    ref = da.ragged_paged_attention_plain(*args, window, **kw)
    _assert_close_rows(out[live], ref[live], dtype)
    assert not out[~live].any()


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False), (torch.float32, True)])
@pytest.mark.parametrize("nsplit", [1, 2, 5, 17])
@pytest.mark.parametrize("h,kh,d", [(12, 2, 128), (16, 4, 64)])
def test_ragged_split_kernel_partials(cuda, dtype, int8, nsplit, h, kh, d):
    """The ragged kernel alone (no combine) against its plain version: the
    partials (acc, m, l) of every split of every tile class where l > 0,
    l = 0 and m = NEG_INF elsewhere (dead lanes, the dead tile, splits
    past a short band); G = 6 (two blocks of 4 + 2 heads) at D = 128, and
    G = 4 at D = 64.  The combine of the kernel's partials is the output."""
    bs = 16
    args, scales, live = _ragged_inputs(
        40 + nsplit, dtype, int8, h, kh, d, bs, 4, 40, [3, 2 * bs + 1, 0, 7],
        [(0, 600, 1), (1, 2 * bs + 1 + 9, 37), (2, 300, 16), (3, 7 + 50, 1)])
    kw = dict(scale=d ** -0.5, **scales)
    before = (da.ragged_paged_attention_split.launches, da.ragged_paged_attention.launches)
    acc, m, l = da.ragged_paged_attention_split(*args, 1 << 30, nsplit=nsplit, **kw)
    torch.cuda.synchronize()
    assert (da.ragged_paged_attention_split.launches - 1, da.ragged_paged_attention.launches) == \
        before
    racc, rm, rl = da.ragged_paged_attention_split_plain(*args, 1 << 30, nsplit=nsplit, **kw)
    seen = rl > 0
    assert torch.equal(l > 0, seen)
    assert bool((m[~seen] == -3.4028234663852886e38).all())
    _assert_close(l[seen], rl[seen], torch.float32 if dtype == torch.float32 else dtype)
    _assert_close(m[seen], rm[seen], torch.float32 if dtype == torch.float32 else dtype)
    _assert_close(acc[seen], racc[seen], torch.float32 if dtype == torch.float32 else dtype)
    out = da.ragged_from_rows(da.combine_splits(acc, m, l, dtype))
    _assert_close(out, da.ragged_paged_attention_plain(*args, 1 << 30, **kw), dtype)
    assert not out[~live].any()


def test_paged_kernel_argument_errors(cuda):
    q = torch.zeros((1, 1, 4, 64), device="cuda")
    pages = torch.zeros((2, 8, 2, 64), device="cuda")
    tables = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        da.paged_decode_attention(q, pages, pages, tables, one, one, scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        da.paged_decode_attention(q.bfloat16(), pages, pages, tables.int(), one, one, scale=1.0)
    # the split kernel copies 16-byte vectors: a pool 4 bytes off is refused
    shifted = torch.zeros(pages.numel() + 1, device="cuda")[1:].view(pages.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.paged_decode_attention(q, shifted, pages, tables.int(), one, one, scale=1.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.paged_decode_attention_split(q, pages, shifted, tables.int(), one, one, nsplit=2,
                                        scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_refuses_misaligned_q(cuda, dtype):
    """The bf16 prefill tiles copy q rows in 16-byte vectors (cp.async): a
    contiguous q that starts off a 16-byte boundary is refused before any
    launch, by the wrapper and by the split kernel alone."""
    args, scales, _ = _ragged_inputs(5, dtype, False, 8, 2, 64, 16, 2, 4, [0, 0],
                                     [(0, 20, 1), (1, 0, 16)])
    q = args[0]
    shifted = torch.zeros(q.numel() + 1, dtype=dtype, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    counts = lambda: (da.ragged_paged_attention.launches,  # noqa: E731
                      da.ragged_paged_attention_split.launches)
    before = counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.ragged_paged_attention(shifted, *args[1:], 1 << 30, scale=0.125, **scales)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.ragged_paged_attention_split(shifted, *args[1:], 1 << 30, nsplit=2, scale=0.125,
                                        **scales)
    assert counts() == before
    out = da.ragged_paged_attention(q, *args[1:], 1 << 30, scale=0.125, **scales)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def test_serve_mixed_and_split_give_equal_tokens(cuda):
    """A short float32 serve run on the card: the unified tick (ragged
    kernel) and the split paged decode (paged kernel) emit the same
    tokens, through the kernels as many times as the ticks imply."""
    import numpy as np

    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2)
    params = init_params(0, cfg, torch.float32, device="cuda")
    trace = poisson_trace(np.random.default_rng(0), 8, rate_rps=40.0, prompt_len_range=(5, 40),
                          max_new_tokens=8, vocab_size=cfg.vocab_size)
    out = {}
    for leg, (mixed, impl) in {"mixed": ("on", "xla"), "split": ("off", "paged")}.items():
        eng = clocked(ServeEngine, params, cfg, mixed_step=mixed, decode_attn_impl=impl,
                      max_slots=4, num_blocks=40, block_size=16, max_seq_len=96,
                      prefill_chunk=16, cache_dtype=torch.float32)
        rag, pag = da.ragged_paged_attention.launches, da.paged_decode_attention.launches
        assert eng.replay_trace(trace)["finished"] == 8
        layers = cfg.num_hidden_layers
        if eng.mixed:
            assert da.ragged_paged_attention.launches - rag == layers * eng.n_dispatches
            assert eng.n_host_fetches == eng.n_dispatches
        else:
            assert da.paged_decode_attention.launches - pag == layers * eng.n_decode_dispatches
        out[leg] = {r.req_id: r.generated for r in eng.scheduler.finished}
    assert out["mixed"] == out["split"]


@pytest.mark.parametrize("pool,tie_tol", [(torch.float32, 1e-4), (torch.int8, 0.05)])
def test_serve_prefix_sharing_and_preemption_on_the_card(cuda, pool, tie_tol):
    """Repeated prompts through a tight pool on the card: prefix blocks
    are shared and requests are preempted and re-prefilled in both tick
    modes, and the two modes emit the same tokens — or part at a near-tie
    of the plain float32 logits (an int8 pool's quantization rounds the
    two modes' K/V apart by a step at most)."""
    import numpy as np

    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.serve import ServeEngine

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2)
    params = init_params(0, cfg, torch.float32, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [p for p in (rng.integers(1, 256, size=n) for n in (40, 35, 50)) for _ in range(3)]
    out = {}
    for leg, (mixed, impl) in {"mixed": ("on", "xla"), "split": ("off", "paged")}.items():
        eng = ServeEngine(params, cfg, mixed_step=mixed, decode_attn_impl=impl, max_slots=4,
                          num_blocks=12, block_size=16, max_seq_len=96, prefill_chunk=16,
                          cache_dtype=pool, enable_prefix_cache=True)
        for j, p in enumerate(prompts):
            eng.submit(p, 12, seed=j)
        eng.run_until_complete()
        assert eng.scheduler.n_preemptions > 0
        assert eng.metrics.snapshot()["prefix_blocks_hit"] > 0
        assert eng.pool.stats()["request_held"] == 0
        out[leg] = {r.req_id: r.generated for r in eng.scheduler.finished}
    assert out["mixed"].keys() == out["split"].keys() == set(range(len(prompts)))
    for rid, a in out["mixed"].items():
        b = out["split"][rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = torch.tensor(np.concatenate([prompts[rid], a[:j]]), device="cuda")[None]
        logits, _ = forward(params, ids, cfg, None, logits_last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        assert (top2[0] - top2[1]).item() <= tie_tol, (rid, j)


# ----------------------------------------------------------------------
# captured steps: each CUDA graph against the same step function run
# eagerly (graphs.eager_steps), and the launch counts of its replays
# ----------------------------------------------------------------------

def _tiny_llama(dtype):
    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.models.transformer import init_params

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2)
    return cfg, init_params(0, cfg, dtype, device="cuda")


def _counts():
    return dict(decode=da.decode_attention.launches, ragged=da.ragged_paged_attention.launches,
                epilogue=se.sample_epilogue.launches, paged=da.paged_decode_attention.launches,
                threefry=tf.threefry2x32.launches, categorical=tf.categorical.launches)


@pytest.mark.parametrize("attn", ["xla", "flash_decode"])
@pytest.mark.parametrize("fused", [True, False])
def test_decode_loop_replays_as_eager(cuda, attn, fused):
    """The decode loop's captured step (fused epilogue or the greedy
    logits tail) gives the eager step's tokens bit for bit, and every
    replay counts its kernels."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.generate import make_decode_loop_fn
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg, params = _tiny_llama(torch.bfloat16)
    loop = make_decode_loop_fn(cfg, Sampler("greedy"), attn_impl=attn, fused_epilogue=fused,
                               device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=g, device="cuda")
    steps = 24

    def run():
        cache = KVCache.init(cfg, 3, 128, torch.bfloat16, device="cuda")
        logits, cache = forward(params, prompts, cfg, cache, logits_last_only=True)
        toks, cache, n = loop(params, logits[:, -1].argmax(-1).int(), cache, None, steps)
        torch.cuda.synchronize()
        return toks, cache, n

    with graphs.eager_steps():
        want, _, _ = run()
    before = _counts()
    got, cache, n = run()
    after = _counts()
    (st,) = cache.steps.values()
    assert n == steps and st.run.graph is not None and st.run.replays == steps - 1
    assert torch.equal(got, want)
    layers = cfg.num_hidden_layers
    assert after["decode"] - before["decode"] == (layers * steps if attn == "flash_decode" else 0)
    assert after["epilogue"] - before["epilogue"] == (steps if fused else 0)


@pytest.mark.parametrize("kind", ["greedy", "min_p", "top_p", "cdf"])
def test_generator_replays_as_eager(cuda, kind):
    """``Generator.generate`` twice (the second call replays from its
    first step) and ``stream`` give the eager step's tokens; a sampled
    kind reads its step's key from the step's static key buffer at a
    step index on the card, so the captured stream equals the eager
    stream of its seed, and every min-p / top-p step launches the
    categorical kernel once."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg, params = _tiny_llama(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (4, 17), generator=g, device="cuda")
    kw = dict(sampler=Sampler(kind, temperature=0.9), prefill_attn_impl="flash",
              decode_attn_impl="flash_decode")
    with graphs.eager_steps():
        eager = Generator(params, cfg, **kw)
        want = eager.generate(prompts, 20, seed=7).tokens
        want_s = list(eager.stream(prompts[0], 9, seed=8))
    gen = Generator(params, cfg, **kw)
    assert gen.epilogue_impl == ("fused" if kind == "greedy" else "xla")
    before = _counts()
    for _ in range(2):
        assert (gen.generate(prompts, 20, seed=7).tokens == want).all()
    draws = _counts()["categorical"] - before["categorical"]
    assert draws == (2 * 20 if kind in ("min_p", "top_p") else 0)  # prefill + 19 steps
    assert list(gen.stream(prompts[0], 9, seed=8)) == want_s
    assert gen.compile_counts() == {"decode_step": 2}
    assert sum(s.replays for s in gen.graph_steps()) == 18 + 19 + 7


def test_serve_unified_tick_replays_as_eager(cuda):
    """The unified tick's bucket graphs give the eager tick's tokens; one
    graph per bucket used, none more on a second trace; every replay
    counts the ragged kernel once a layer and the epilogue once."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg, params = _tiny_llama(torch.bfloat16)
    trace = poisson_trace(np.random.default_rng(1), 12, rate_rps=40.0, prompt_len_range=(5, 60),
                          max_new_tokens=10, vocab_size=cfg.vocab_size)

    def engine():
        return ServeEngine(params, cfg, mixed_step="on", max_slots=4, num_blocks=64,
                           block_size=16, max_seq_len=96, prefill_chunk=16,
                           cache_dtype=torch.bfloat16)

    def serve_all(eng):
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
        eng.run_until_complete()
        return {r.req_id: r.generated for r in eng.scheduler.finished}

    with graphs.eager_steps():
        want = serve_all(engine())
    eng = engine()
    before = _counts()
    assert serve_all(eng) == want
    after = _counts()
    counts = eng.compile_counts()
    assert 0 < counts["mixed_step"] <= len(eng.mixed_buckets)
    assert after["ragged"] - before["ragged"] == cfg.num_hidden_layers * eng.n_dispatches
    assert after["epilogue"] - before["epilogue"] == eng.n_dispatches
    assert sum(s.replays for s in eng.graph_steps()) == eng.n_dispatches - counts["mixed_step"]
    serve_all(eng)
    assert eng.compile_counts() == counts


def test_serve_spec_tick_replays_as_eager(cuda):
    """The greedy spec tick (spec_k=4, verify slices beside prefill and
    plain decode rows) captured per bucket gives the eager tick's
    tokens (bf16: a verify row and a plain decode row may part at a
    near-tie, so the plain engine is not the yardstick here); one graph
    per bucket used, none
    more on a second trace however the draft widths churn; one fetch a
    tick, the ragged kernel once a layer and the epilogue once a tick."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg, params = _tiny_llama(torch.bfloat16)
    rng = np.random.default_rng(2)
    trace = poisson_trace(rng, 12, rate_rps=40.0, prompt_len_range=(5, 60),
                          max_new_tokens=12, vocab_size=cfg.vocab_size)
    prompts = [np.resize(rng.integers(1, cfg.vocab_size, size=6).astype(np.int32),
                         item["prompt"].size) for item in trace]

    def engine(spec_k):
        return ServeEngine(params, cfg, mixed_step="on", max_slots=4, num_blocks=64,
                           block_size=16, max_seq_len=96, prefill_chunk=16,
                           cache_dtype=torch.bfloat16, spec_k=spec_k)

    def serve_all(eng):
        for j, (item, p) in enumerate(zip(trace, prompts)):
            eng.submit(p, item["max_new_tokens"], seed=j, speculative=True)
        eng.run_until_complete()
        return {r.req_id: r.generated for r in eng.scheduler.finished}

    with graphs.eager_steps():
        want = serve_all(engine(4))
    eng = engine(4)
    before = _counts()
    assert serve_all(eng) == want
    after = _counts()
    assert eng.metrics.snapshot()["spec_accepted_tokens"] > 0
    counts = eng.compile_counts()
    assert 0 < counts["mixed_step"] <= len(eng.mixed_buckets)
    assert eng.n_host_fetches == eng.n_dispatches
    assert after["ragged"] - before["ragged"] == cfg.num_hidden_layers * eng.n_dispatches
    assert after["epilogue"] - before["epilogue"] == eng.n_dispatches
    serve_all(eng)
    assert eng.compile_counts() == counts


@pytest.mark.parametrize("kind", ["greedy", "min_p"])
def test_spec_round_replays_as_eager(cuda, kind):
    """The offline speculative round (int8 self-draft) captured once per
    shape gives the eager round's tokens — the round splits the key in
    its static buffer on the card, so a replay draws as the eager round;
    every later round is a replay; the draft and verify forwards take the
    plain path (no attention or epilogue kernel), and each round draws
    through the categorical kernel gamma + 2 times."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.speculative import SpeculativeGenerator

    cfg, params = _tiny_llama(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (3, 19), generator=g, device="cuda")
    kw = dict(gamma=3, sampler=Sampler(kind))
    with graphs.eager_steps():
        want = SpeculativeGenerator(params, cfg, **kw).generate(prompts, 20, seed=3).tokens
    spec = SpeculativeGenerator(params, cfg, **kw)
    before = _counts()
    for _ in range(2):
        assert (spec.generate(prompts, 20, seed=3).tokens == want).all()
    after = _counts()
    assert {k: after[k] - before[k] for k in ("decode", "ragged", "epilogue", "paged")} == dict(
        decode=0, ragged=0, epilogue=0, paged=0)
    assert spec.compile_counts() == {"spec_round": 1}
    (step,) = spec.graph_steps()
    assert step.replays == step.calls - 1 > 0
    prefills = 2 * 2 * (kind != "greedy")  # target and draft, two calls
    assert after["categorical"] - before["categorical"] == prefills + 5 * step.calls


@pytest.mark.parametrize("tied", [True, False])
def test_quant_einsum_plain_head_keeps_bf16(cuda, tied):
    """The plain head product takes the bf16 head as it is: float32
    results within bf16 accumulation noise of a float32 product, and no
    float32 copy of the head on the card."""
    g = torch.Generator(device="cuda").manual_seed(6)
    h, v = 512, 32000
    x = _randn((1, 4, h), g, torch.bfloat16)
    w = _randn((v, h) if tied else (h, v), g, torch.bfloat16, 0.05)
    spec = "bsh,vh->bsv" if tied else "bsh,hv->bsv"
    ref = x.float() @ (w.float().T if tied else w.float())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (1, 4, v)
    assert torch.cuda.max_memory_allocated() - base < w.numel() * 4 // 2
    # bf16 products are exact in float32; cuBLAS may reduce split-K
    # partials in bf16, so the bound is two bf16 ulps
    _assert_close(out, ref, torch.bfloat16)


# ----------------------------------------------------------------------
# threefry2x32 draws (jax.random's bits on the card)
# ----------------------------------------------------------------------

def _known_answers():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KNOWN_ANSWERS


def test_threefry_kernels_give_jax_words(cuda):
    """The hash on the card gives the words jax gives (constants made
    from jax by the CPU tests), and equals its plain version in every
    mode, for one key and for a key a row."""
    from llm_np_cp_tpu_torch import random as tr

    ka = _known_answers()
    key = tr.PRNGKey(ka["seed"], "cuda")
    u32 = lambda t: (t.cpu().long() & 0xFFFFFFFF).tolist()  # noqa: E731
    assert u32(tr.split(key, 3)) == ka["split3"]
    assert u32(tr.fold_in(key, ka["fold_data"])) == ka["fold_in"]
    assert u32(tr.random_bits(key, (8,))) == ka["bits8"]
    assert u32(tr.uniform(key, (8,)).view(torch.int32)) == ka["uniform8_words"]
    wide = tr.random_bits(key, tuple(ka["categorical_shape"])).reshape(-1)
    assert u32(wide[ka["wide_index"]]) == ka["bits_wide"]
    keys = tr.split(key, 5)
    data = torch.arange(5, dtype=torch.int32, device="cuda") * 977
    for mode in (tr.PAIR, tr.BITS, tr.UNIFORM):
        for k, n, cols, d in ((key, 1000, 1000, None), (keys, 5 * 33, 33, None),
                              (keys, 5, 1, data)):
            got = tf.threefry2x32(k, n, cols, d, mode, -2.0, 3.0).cpu()
            want = tr.words_plain(k.cpu(), n, cols, None if d is None else d.cpu(), mode,
                                  -2.0, 3.0)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,v", [(4, 128256), (8, 128256), (40, 128256), (8, 256000), (3, 100)])
def test_categorical_kernel_matches_plain(cuda, n, v):
    """The fused draw gives its plain version's tokens, under one key and
    under a key a row, and jax's on the known-answer logits."""
    from llm_np_cp_tpu_torch import random as tr

    g = torch.Generator(device="cuda").manual_seed(n + v)
    logits = _randn((n, v), g, torch.float32, 3.0)
    key = tr.PRNGKey(n, "cuda")
    for k in (key, tr.split(key, n)):
        before = tf.categorical.launches
        got = tf.categorical(k, logits)
        assert tf.categorical.launches == before + 1 and got.dtype == torch.int32
        assert torch.equal(got.cpu(), tr.categorical_plain(k.cpu(), logits.cpu()))
    ka = _known_answers()
    rows, cols = ka["categorical_shape"]
    flat = torch.arange(rows * cols, dtype=torch.int64, device="cuda")
    known = (((flat * 7919) % 1000).double() / 100.0 - 5.0).float().view(rows, cols)
    key = tr.PRNGKey(ka["seed"], "cuda")
    assert tr.categorical(key, known).tolist() == ka["categorical"]
    assert tr.categorical(tr.split(key, rows), known).tolist() == ka["categorical_rows"]


@pytest.mark.parametrize("row0", [1, 3])
def test_categorical_row_offset_draws_the_whole_batchs_bits(cuda, row0):
    """A data-parallel rank's rows: ``categorical(key, rows, row0)``
    gives the tokens of rows row0... of the whole batch's draw under one
    key, as its plain version does."""
    from llm_np_cp_tpu_torch import random as tr

    g = torch.Generator(device="cuda").manual_seed(row0)
    logits = _randn((6, 128256), g, torch.float32, 3.0)
    key = tr.PRNGKey(11, "cuda")
    whole = tf.categorical(key, logits)
    part = tf.categorical(key, logits[row0:row0 + 2].contiguous(), row0)
    assert torch.equal(part, whole[row0:row0 + 2])
    assert torch.equal(part.cpu(), tr.categorical_plain(key.cpu(), logits[row0:row0 + 2].cpu(),
                                                        row0))


@pytest.mark.parametrize("leg", ["mixed", "split_paged", "split_xla"])
def test_sampled_ticks_replay_as_eager(cuda, leg):
    """A min-p engine's steps — the unified tick per bucket, or the
    phase-split decode step — are captured like greedy ones: the
    captured run gives the eager run's tokens, warmup captures every
    step, each sampled tick draws through the categorical kernel once
    and derives its row keys in one threefry launch."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg, params = _tiny_llama(torch.bfloat16)
    trace = poisson_trace(np.random.default_rng(3), 10, rate_rps=40.0, prompt_len_range=(5, 50),
                          max_new_tokens=10, vocab_size=cfg.vocab_size)
    mixed, impl = {"mixed": ("on", "xla"), "split_paged": ("off", "paged"),
                   "split_xla": ("off", "xla")}[leg]

    def engine():
        return ServeEngine(params, cfg, sampler=Sampler("min_p", p_base=0.05), mixed_step=mixed,
                           decode_attn_impl=impl, max_slots=4, num_blocks=64, block_size=16,
                           max_seq_len=96, prefill_chunk=16, cache_dtype=torch.bfloat16)

    def serve_all(eng):
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
        eng.run_until_complete()
        return {r.req_id: r.generated for r in eng.scheduler.finished}

    with graphs.eager_steps():
        want = serve_all(engine())
    eng = engine()
    eng.warmup([8], 2)
    warm = eng.compile_counts()
    assert warm == ({"mixed_step": len(eng.mixed_buckets)} if mixed == "on"
                    else {"decode_step": 1})
    eng.n_dispatches = eng.n_decode_dispatches = 0
    before, g0 = _counts(), dict(graphs.TOTALS)
    got = {k - 1: v for k, v in serve_all(eng).items()}  # the warmup's request took id 0
    after = _counts()
    assert got == want
    assert eng.compile_counts() == warm and graphs.TOTALS["captures"] == g0["captures"]
    ticks = eng.n_dispatches if mixed == "on" else eng.n_decode_dispatches
    if mixed == "on":
        draws = ticks
    else:  # the decode ticks and each request's first token
        draws = ticks + len(trace)
    assert after["categorical"] - before["categorical"] == draws
    assert after["threefry"] - before["threefry"] == draws


# ----------------------------------------------------------------------
# the host-RAM KV tier on the card: pinned host blocks, the writer's own
# stream, captures beside a busy writer, restores before the replay
# ----------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_tier_spill_restore_roundtrip_on_the_card(cuda, int8):
    """A pool block spilled through pinned memory on the writer's stream
    and restored into another block id comes back bit-exact; the probe
    times a block's host→device copy with events."""
    from llm_np_cp_tpu_torch.cache import quantize_kv
    from llm_np_cp_tpu_torch.serve import HostTier

    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (2, 6, 16, 2, 64)  # [L, NB, BS, K, D]
    k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    pages = [k, v, None, None]
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        pages = [kq, vq, ks, vs]
    tier = HostTier(1 << 30)
    tier.ensure_probe([(tuple(a[:, 0].shape), a.dtype) for a in pages if a is not None],
                      device="cuda")
    assert tier.restore_s_per_block > 0 and tier.restore_gbps > 0
    clones = [a[:, 3].clone(memory_format=torch.contiguous_format) for a in pages if a is not None]
    assert tier.enqueue_spill(b"blk", *clones)
    assert tier.drain()
    host = tier._wentries[b"blk"]
    assert all(a.is_pinned() and not a.is_cuda for a in host if a is not None)
    (res,) = tier.take_restored([tier.enqueue_restore(b"blk", 5, "cuda")])
    blk, staged, dt, ready = res
    assert blk == 5 and dt > 0 and isinstance(ready, torch.cuda.Event)
    stream = torch.cuda.current_stream()
    stream.wait_event(ready)
    for page, a in zip(pages, staged):
        if page is not None:
            assert a.is_cuda
            page[:, 5].copy_(a)
            a.record_stream(stream)
    torch.cuda.synchronize()
    for page in pages:
        if page is not None:
            assert torch.equal(page[:, 5], page[:, 3])
    tier.close()


def _tier_engine(cfg, params, tier, dtype, **kw):
    from llm_np_cp_tpu_torch.serve import ServeEngine

    kw.setdefault("mixed_step", "on")
    return ServeEngine(params, cfg, max_slots=2, block_size=16, max_seq_len=96,
                       prefill_chunk=16, cache_dtype=dtype, enable_prefix_cache=True,
                       host_tier=tier, **kw)


def _serve_each(eng, prompts, max_new=8):
    """Each prompt in turn to completion, the tier drained after each."""
    for j, p in enumerate(prompts):
        eng.submit(p, max_new, seed=j)
        eng.run_until_complete()
        if eng.host_tier is not None:
            eng.host_tier.drain()
    return {r.req_id: r.generated for r in eng.scheduler.finished}


def test_tier_capture_while_spills_are_queued(cuda):
    """Every bucket is captured while the writer still has spills queued
    (queued behind a long product on the engine's stream, which their
    copies wait on): the captures succeed (the writer is held off the
    card meanwhile), the spills land bit-exact afterwards, and the
    captured tier-on engine emits the tokens the same engine gives with
    eager steps."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.serve import HostTier

    cfg, params = _tiny_llama(torch.bfloat16)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, size=48) for _ in range(5)] * 2
    tier = HostTier(4 << 30)
    tier.policy = "always"
    eng = _tier_engine(cfg, params, tier, torch.bfloat16, num_blocks=12)
    guard, seen = eng._capture_guard, []

    def watched():
        seen.append(len(tier._pending_spill_keys))
        return guard()

    eng._capture_guard = watched
    with graphs.eager_steps():  # the kernels built and cuBLAS warm, nothing captured
        _serve_each(eng, prompts[:1], 2)
    g = torch.Generator(device="cuda").manual_seed(1)
    big = [torch.randn((2, 1 << 20), generator=g, device="cuda") for _ in range(48)]
    x = torch.randn((4096, 4096), generator=g, device="cuda")
    for _ in range(40):  # ~0.1 s of float32 products ahead of the spills' events
        x = torch.tanh(x @ x)
    for i, a in enumerate(big):
        assert tier.enqueue_spill(b"big%d" % i, a, a + 1)
    for t_w in eng.mixed_buckets:
        eng._warm_mixed_bucket(t_w)
    assert eng.compile_counts()["mixed_step"] == len(eng.mixed_buckets) == len(seen)
    assert max(seen) > 0, "every capture began after the writer had emptied its queue"
    assert tier.drain()
    assert tier.stats()["spilled_blocks"] == 48
    for i in (0, 47):
        host = tier._wentries[b"big%d" % i]
        assert torch.equal(host.k, big[i].cpu()) and torch.equal(host.v, (big[i] + 1).cpu())
    got = _serve_each(eng, prompts)
    assert tier.stats()["restored_blocks"] > 0
    assert eng.compile_counts()["mixed_step"] == len(eng.mixed_buckets)
    assert sum(s.replays for s in eng.graph_steps()) > 0
    eager_tier = HostTier(4 << 30)
    eager_tier.policy = "always"
    with graphs.eager_steps():
        twin = _tier_engine(cfg, params, eager_tier, torch.bfloat16, num_blocks=12)
        _serve_each(twin, prompts[:1], 2)
        want = _serve_each(twin, prompts)
    assert got == want
    assert eager_tier.stats()["restored_blocks"] == tier.stats()["restored_blocks"]
    tier.close()
    eager_tier.close()


@pytest.mark.parametrize("mixed", ["on", "off"])
def test_tier_restore_lands_before_the_replay(cuda, mixed):
    """float32, a starved pool, prompts that come back after their prefix
    was reclaimed: the tier-on engine restores, and the captured step that
    attends the restored blocks emits the tier-off engine's tokens (or
    parts from them first at a near-tie of the plain logits)."""
    import numpy as np

    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.serve import HostTier

    cfg, params = _tiny_llama(torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, size=48) for _ in range(5)] * 2
    tier = HostTier(1 << 30)
    tier.policy = "always"
    extra = dict(num_blocks=12, mixed_step=mixed, decode_attn_impl="paged")
    on = _tier_engine(cfg, params, tier, torch.float32, **extra)
    off = _tier_engine(cfg, params, None, torch.float32, **extra)
    got, want = _serve_each(on, prompts), _serve_each(off, prompts)
    assert tier.stats()["restored_blocks"] > 0 and tier.stats()["restore_misses"] == 0
    assert sum(s.replays for s in on.graph_steps()) > 0
    assert on.pool.stats()["request_held"] == 0
    for rid, a in got.items():
        b = want[rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = torch.tensor(np.concatenate([prompts[rid], a[:j]]), device="cuda")[None]
        logits, _ = forward(params, ids, cfg, None, logits_last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        assert (top2[0] - top2[1]).item() <= 1e-4, (rid, j)
    tier.close()


def test_tier_cuda_error_raises_not_a_miss(cuda):
    """A restore staged onto a card that does not exist fails in CUDA on
    the writer thread: the engine side gets the error, not a miss, and
    the context stays usable."""
    from llm_np_cp_tpu_torch.serve import HostTier, HostTierError

    tier = HostTier(1 << 20)
    one = torch.ones((2, 16, 2, 64), device="cuda")
    tier.enqueue_spill(b"k", one, one)
    tier.drain()
    bad = torch.device("cuda", torch.cuda.device_count())
    ticket = tier.enqueue_restore(b"k", 1, bad)
    with pytest.raises(HostTierError):
        tier.take_restored([ticket])
    with pytest.raises(HostTierError):
        tier.check()
    assert tier.stats()["restore_misses"] == 0 and tier.stats()["restored_blocks"] == 0
    tier.close()
    assert torch.ones(3, device="cuda").sum().item() == 3.0


@pytest.mark.parametrize("mixed", ["on", "off"])
def test_traced_ticks_are_replays(cuda, mixed):
    """The observability plane over the captured ticks: after warm-up every
    tick is a graph replay (no capture, traced or not), one ``tick`` span
    a tick with its phases contiguous and summing to it, every graded tick
    at 0 < roofline_util < 1 against the card's constants, and tokens equal
    to the untraced run's (float32)."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.serve import ServeEngine
    from llm_np_cp_tpu_torch.serve.slo import TickSentinel
    from llm_np_cp_tpu_torch.serve.telemetry import TelemetryModel
    from llm_np_cp_tpu_torch.serve.tenants import TenantLedger
    from llm_np_cp_tpu_torch.serve.tracing import MIXED_TICK_PHASES, TICK_PHASES, TraceRecorder

    cfg, params = _tiny_llama(torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 30, 17, 44)]
    eng = ServeEngine(params, cfg, mixed_step=mixed, decode_attn_impl="paged", max_slots=4,
                      num_blocks=64, block_size=16, max_seq_len=96, prefill_chunk=16,
                      cache_dtype=torch.float32)
    eng.warmup([len(p) for p in prompts], 8)

    def serve_all():
        eng.scheduler.finished.clear()
        for j, p in enumerate(prompts):
            eng.submit(p, 8, seed=j)
        t0 = dict(graphs.TOTALS)
        eng.run_until_complete()
        return ({r.seed: r.generated for r in eng.scheduler.finished},
                {k: graphs.TOTALS[k] - t0[k] for k in t0})

    plain, plain_graphs = serve_all()
    eng.tracer, eng.sentinel = TraceRecorder(), TickSentinel()
    eng.telemetry, eng.tenants = TelemetryModel(cfg, params), TenantLedger()
    d0 = eng.n_decode_dispatches if mixed == "off" else eng.n_dispatches
    traced, traced_graphs = serve_all()
    dispatches = (eng.n_decode_dispatches if mixed == "off" else eng.n_dispatches) - d0
    assert traced == plain
    assert plain_graphs["captures"] == traced_graphs["captures"] == 0
    assert traced_graphs["replays"] == dispatches
    names = MIXED_TICK_PHASES if mixed == "on" else TICK_PHASES
    evs = eng.tracer.events()
    ticks = [(i, e) for i, e in enumerate(evs) if e["name"] == "tick" and e["ph"] == "X"]
    assert len(ticks) == eng.sentinel.ticks
    graded = 0
    for i, t in ticks:
        ph = evs[i + 1:i + 1 + len(names)]
        assert [p["name"] for p in ph] == list(names)
        assert ph[0]["ts"] == t["ts"]
        assert sum(p["dur"] for p in ph) <= t["dur"] + 1e-6
        if "roofline_util" in t["args"]:
            graded += 1
            assert 0.0 < t["args"]["roofline_util"] < 1.0 and t["args"]["mfu"] < 1.0
    assert graded == dispatches


def test_replica_captures_beside_a_replaying_peer(cuda):
    """Two replicas of one fleet on one card, each on its own stream and
    thread: while the peer serves (graph replays and host fetches), the
    other is built and captures every bucket (``capture_error_mode``
    thread_local, no device-wide synchronize), then serves.  Both sets of
    float32 streams equal each engine's run alone, and the ragged and
    epilogue launch counts are exact across both threads."""
    import threading

    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg, params = _tiny_llama(torch.float32)
    trace = poisson_trace(np.random.default_rng(5), 12, rate_rps=40.0, prompt_len_range=(5, 60),
                          max_new_tokens=24, vocab_size=cfg.vocab_size)

    def engine(warm=True):
        eng = ServeEngine(params, cfg, sampler=Sampler("greedy"), mixed_step="on", max_slots=4,
                          num_blocks=96, block_size=16, max_seq_len=128, prefill_chunk=16,
                          cache_dtype=torch.float32)
        if warm:
            eng.warmup([8], 2)
        return eng

    def serve_all(eng):
        reqs = [eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
                for j, item in enumerate(trace)]
        eng.run_until_complete()
        return [list(r.generated) for r in reqs]

    want = serve_all(engine())
    peer = engine()
    got, errors = {}, []
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    before, g0 = _counts(), dict(graphs.TOTALS)
    peer_warm = sum(peer.bucket_dispatches.values())
    go = threading.Event()

    def run_peer():
        try:
            with torch.cuda.stream(streams[0]):
                go.set()
                for rep in range(3):  # long enough to span the other's captures
                    got[f"peer{rep}"] = serve_all(peer)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=run_peer)
    t.start()
    go.wait(10.0)
    with torch.cuda.stream(streams[1]):
        other = engine()  # captures every bucket while the peer replays
        got["other"] = serve_all(other)
        torch.cuda.current_stream().synchronize()
    t.join(120.0)
    assert not errors, errors
    assert [got[f"peer{r}"] for r in range(3)] == [want] * 3 and got["other"] == want
    after = _counts()
    eager = graphs.TOTALS["eager"] - g0["eager"]
    replays = graphs.TOTALS["replays"] - g0["replays"]
    # every capture was the other engine's (the peer was warm), each after
    # one eager first call; a replay and an eager call each launch the
    # ragged kernel once a layer and the epilogue once
    assert graphs.TOTALS["captures"] - g0["captures"] == eager >= len(other.mixed_buckets)
    assert replays >= sum(peer.bucket_dispatches.values()) - peer_warm
    assert after["ragged"] - before["ragged"] == cfg.num_hidden_layers * (replays + eager)
    assert after["epilogue"] - before["epilogue"] == replays + eager


def test_capture_raises_on_host_sync(cuda):
    """A step that reads the card back while captured raises; nothing
    falls back to running it eagerly.  (Last in this file: it leaves a
    failed capture behind.)"""
    from llm_np_cp_tpu_torch import graphs

    x = torch.ones(4, device="cuda")
    seen = []
    step = graphs.CapturedStep(lambda: seen.append(x.sum().item()), torch.device("cuda"),
                               "host sync")
    with pytest.raises(RuntimeError, match="capturing host sync"):
        step()
    assert step.graph is None and not step.compiled and seen == [4.0]
    torch.cuda.synchronize()
    assert torch.ones(3, device="cuda").sum().item() == 3.0


def test_cli_greedy_runs_the_decode_kernel(cuda, monkeypatch):
    """``cli.run`` greedy on cuda at the tiny config: the decode kernel
    launched once a layer on each of the 7 decode steps (eager first step,
    then graph replays), the text a direct ``Generator``'s."""
    import numpy as np

    from llm_np_cp_tpu_torch import cli
    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    class Tok:
        eos_token_id = 199

        def __call__(self, text, return_tensors=None):
            return {"input_ids": np.asarray([[(ord(c) % 250) + 1 for c in text]], np.int32)}

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(0x4E00 + int(i)) for i in ids)

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2)
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    monkeypatch.setattr(cli, "_load", lambda args: (args.tokenizer, params, cfg))
    before = da.decode_attention.launches
    text = cli.run(["--sampler=greedy", "--no-stream", "--decode-attn=pallas", "--max-tokens=8",
                    "--prompt=hello there"], tokenizer=Tok())
    assert da.decode_attention.launches - before == cfg.num_hidden_layers * 7
    gen = Generator(params, cfg, sampler=Sampler("greedy"), stop_tokens=(Tok.eos_token_id,),
                    decode_attn_impl="flash_decode")
    want = gen.generate(Tok()("hello there")["input_ids"][0], 8).tokens[0]
    assert text == Tok().decode(want)


def _tiny_moe(dtype):
    """A tiny Mixtral-style model (8 experts, 2 a token, capacity 2.0)
    with weights of std 0.15, so routes and greedy tokens vary."""
    from llm_np_cp_tpu_torch.config import tiny_config
    from llm_np_cp_tpu_torch.models.transformer import init_params

    cfg = tiny_config("llama", head_dim=64, hidden_size=128, num_attention_heads=4,
                      num_key_value_heads=2, num_local_experts=8, num_experts_per_tok=2)
    params = init_params(0, cfg, dtype, device="cuda")
    for name, w in params["layers"].items():
        if not name.startswith("ln_"):
            params["layers"][name] = (w.float() * 7.5).to(dtype)
    return cfg, params


def test_moe_routing_is_tie_stable_on_the_card(cuda):
    """The stable selection takes the lower expert first on ties on CUDA
    tensors too (``torch.topk`` on CUDA does not promise it), and the
    layer on the card routes as on the CPU: same dispatch, outputs within
    float32 rounding."""
    from llm_np_cp_tpu_torch.ops import moe

    p = torch.full((5, 64), 1.0 / 64, device="cuda")
    p[1, 40:] = 2.0 / 64
    assert moe.top_k_stable(p, 2)[1].tolist() == [[0, 1], [40, 41], [0, 1], [0, 1], [0, 1]]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 33, 128, generator=g, device="cuda")
    x[0, 5] = 0.0  # every expert ties
    rw = 0.5 * torch.randn(128, 8, generator=g, device="cuda")
    ws = [0.1 * torch.randn(s, generator=g, device="cuda")
          for s in ((8, 128, 256), (8, 128, 256), (8, 256, 128))]
    _, gates = moe.route(x.reshape(-1, 128), rw, top_k=2)
    assert torch.nonzero(gates[5]).flatten().tolist() == [0, 1]
    _, cpu_gates = moe.route(x.reshape(-1, 128).cpu(), rw.cpu(), top_k=2)
    assert torch.equal((gates > 0).cpu(), cpu_gates > 0)
    out, aux = moe.moe_mlp(x, rw, *ws, act=torch.nn.functional.silu, top_k=2,
                           capacity_factor=1.0, group_size=16)
    ref, ref_aux = moe.moe_mlp(x.cpu(), rw.cpu(), *(w.cpu() for w in ws),
                               act=torch.nn.functional.silu, top_k=2, capacity_factor=1.0,
                               group_size=16)
    _assert_close(out.cpu(), ref, torch.float32)
    assert abs(aux.item() - ref_aux.item()) < 1e-5


@pytest.mark.parametrize("mode", [None, "int8_a8"])
def test_moe_generator_and_tick_replay_as_eager(cuda, mode):
    """An MoE model's captured decode step and unified tick give the eager
    steps' tokens (bf16, the default capacity, so routes can drop): the
    layer reads nothing back to the host, and every replay counts its
    kernels."""
    import numpy as np

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace

    cfg, params = _tiny_moe(torch.bfloat16)
    if mode is not None:
        params = quantize_params(params, bits=8, act_quant=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (4, 19), generator=g, device="cuda")
    kw = dict(sampler=Sampler("greedy"), prefill_attn_impl="flash",
              decode_attn_impl="flash_decode")
    with graphs.eager_steps():
        want = Generator(params, cfg, **kw).generate(prompts, 16).tokens
    gen = Generator(params, cfg, **kw)
    before = _counts()
    assert (gen.generate(prompts, 16).tokens == want).all()
    assert _counts()["decode"] - before["decode"] == cfg.num_hidden_layers * 15
    assert sum(s.replays for s in gen.graph_steps()) == 14
    assert len(set(np.asarray(want).ravel().tolist())) > 4

    trace = poisson_trace(np.random.default_rng(2), 10, rate_rps=40.0, prompt_len_range=(5, 40),
                          max_new_tokens=8, vocab_size=cfg.vocab_size)

    def serve_all(eng):
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
        eng.run_until_complete()
        return {r.req_id: r.generated for r in eng.scheduler.finished}

    def engine():
        return ServeEngine(params, cfg, mixed_step="on", max_slots=4, num_blocks=64,
                           block_size=16, max_seq_len=96, prefill_chunk=16,
                           cache_dtype=torch.bfloat16)

    with graphs.eager_steps():
        want = serve_all(engine())
    eng = engine()
    before = _counts()
    assert serve_all(eng) == want
    assert _counts()["ragged"] - before["ragged"] == cfg.num_hidden_layers * eng.n_dispatches
    counts = eng.compile_counts()
    assert sum(s.replays for s in eng.graph_steps()) == eng.n_dispatches - counts["mixed_step"]

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_np_cp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — card name and count, torch/CUDA versions, power limit, and
   the time to build the kernels from ``llm_np_cp_tpu_torch/csrc``.
2. kernels — each kernel against its plain PyTorch version on the card,
   in bfloat16, at the main path's shapes and at wider ones: max error
   against the stated tolerance, kernel / plain / library-call times
   (CUDA events over many launches after warm-up) and the bound.
3. main path — Llama-3.2-1B at full width and depth on seeded random
   bf16 weights: ``Generator.generate`` (flash prefill, decode kernel,
   fused epilogue), ``generate_ragged`` and ``stream``; launch counts
   must equal what the path implies, and a teacher-forced cache-less
   plain forward must agree with every chosen token.
4. profile — torch.profiler over one more ``generate``: device time by
   kernel and the device's busy share of the wall time.
5. the ``kernels`` summary line, the card's ``nvidia-smi`` name and power
   limit, and last the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when no CUDA card is visible.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and
# bf16 tensor-core rate — the bound of each kernel case.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# bf16 attention outputs: |kernel - plain| <= ATTN_TOL * (1 + |plain|),
# two bf16 ulps (2^-6 relative) at the output's own magnitude
ATTN_TOL = 2.0 ** -6
EPILOGUE_TOL = 1e-3  # float32 logits: summation order and norm rounding
# bf16 logits after 16 layers: the kernel path against plain references.
# The seeded model's logit std is ~0.9; the plain cached twin alone is up
# to ~0.04 from the cache-less reference, and a different rounding order
# in attention moves near-tied argmaxes by up to ~0.1.  Exactness is held
# by the float32 run below, where the gap must be ~0.
TEACHER_TOL = 0.15
# the same check with float32 weights, activations and cache: kernels and
# plain references then differ only in summation order
F32_TEACHER_TOL = 2e-3
F32_STEPS = 16

DECODE_STEPS = 64
STREAM_TOKENS = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attn_err(out, ref) -> tuple[float, bool]:
    """(max |out - ref|, whether every element is within ATTN_TOL * (1 + |ref|))."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= ATTN_TOL * (1.0 + ref.float().abs())).all())
    return diff.max().item(), ok


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def flash_cases(torch, F, fa, sdpa_gqa: bool) -> list[dict]:
    cases = []
    specs = [
        # name, B, S, H, K, D, softcap, window — main path shape first
        ("llama1b_main_4x128", 4, 128, 32, 8, 64, None, None),
        ("llama1b_prefill_1x512", 1, 512, 32, 8, 64, None, None),
        ("gemma2_2b_1x512_softcap50_window128", 1, 512, 8, 4, 256, 50.0, 128),
    ]
    for name, b, s, h, kh, d, cap, win in specs:
        g = torch.Generator(device="cuda").manual_seed(len(cases) + 1)
        q = torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
        k = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
        v = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
        scale = d ** -0.5
        kw = dict(scale=scale, logit_softcap=cap, window=win)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err, ok = attn_err(out, ref)
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), 50)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
        lib_ms = None
        if cap is None and win is None and sdpa_gqa:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), 50)
        pairs = sum(min(i + 1, win or s) for i in range(s))
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
        bms, by = bound(nbytes, 4.0 * b * h * d * pairs)
        cases.append(dict(kernel="flash_attention", case=name, max_abs_err=err,
                          tol=ATTN_TOL, within_tol=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bms, bound_by=by))
    return cases


def decode_mask(torch, b: int, s: int):
    """Ragged rows: left pads on two rows, one short row, one full row."""
    pads = [0, 17, 40, 3]
    ends = [s, s, s, s // 3]
    mask = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    for r in range(b):
        mask[r, pads[r]:ends[r]] = True
    return mask


def decode_cases(torch, F, da, quantize_kv, sdpa_gqa: bool) -> list[dict]:
    cases = []
    b, h, kh, d = 4, 32, 8, 64
    for s in (256, 4096):
        for int8 in (False, True):
            name = f"llama1b_b4_s{s}_{'int8' if int8 else 'bf16'}_ragged"
            g = torch.Generator(device="cuda").manual_seed(100 + s + int8)
            q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
            k = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
            v = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
            mask = decode_mask(torch, b, s)
            kw = dict(scale=d ** -0.5)
            if int8:
                k, ks = quantize_kv(k)
                v, vs = quantize_kv(v)
                kw.update(k_scale=ks, v_scale=vs)
            out = da.decode_attention(q, k, v, mask, **kw)
            torch.cuda.synchronize()
            ref = da.decode_attention_plain(q, k, v, mask, **kw)
            err, ok = attn_err(out, ref)
            ms = time_ms(torch, lambda: da.decode_attention(q, k, v, mask, **kw), 100)
            plain_ms = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, mask, **kw), 10)
            lib_ms = None
            if not int8 and sdpa_gqa:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                am = mask[:, None, None, :]
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=am, scale=kw["scale"], enable_gqa=True), 100)
            visible = int(mask.sum().item())
            per_slot = kh * d * k.element_size() * 2 + (kh * 4 * 2 if int8 else 0)
            nbytes = 2 * 2 * b * h * d + visible * per_slot + b * s
            bms, by = bound(nbytes, 4.0 * h * d * visible)
            cases.append(dict(kernel="decode_attention", case=name, max_abs_err=err,
                              tol=ATTN_TOL, within_tol=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bms, bound_by=by))
    return cases


def check_tokens(torch, logits, got, tol: float) -> float:
    """Every row whose top-two plain logits differ by more than ``tol``
    must match exactly; on the other rows the kernel's token must be one
    of the tied ones.  Returns the largest logit gap of a chosen token."""
    top2 = torch.topk(logits, 2, dim=-1).values
    best = top2[:, 0]
    chosen = logits.gather(-1, got.long()[:, None])[:, 0]
    gap = (best - chosen)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    clear = (top2[:, 0] - top2[:, 1]) > tol
    if bool((clear & (got != want)).any()) or bool((gap > tol).any()):
        raise AssertionError(f"epilogue tokens {got.tolist()} vs plain {want.tolist()}, gaps {gap.tolist()}")
    return gap.max().item()


def epilogue_cases(torch, se, norms) -> list[dict]:
    cases = []
    specs = [
        # name, N, H, V, tied, softcap, unit_offset — main path shape first
        ("llama1b_n4_tied", 4, 2048, 128256, True, None, False),
        ("gemma2_widths_n4_untied_softcap30_unitoffset", 4, 2304, 256000, False, 30.0, True),
    ]
    for name, n, hd, vocab, tied, cap, unit in specs:
        g = torch.Generator(device="cuda").manual_seed(7 + len(cases))
        x = torch.randn((n, hd), generator=g, device="cuda").bfloat16()
        gamma = (0.1 * torch.randn((hd,), generator=g, device="cuda") + (0.0 if unit else 1.0)).bfloat16()
        wshape = (vocab, hd) if tied else (hd, vocab)
        w = (0.02 * torch.randn(wshape, generator=g, device="cuda")).bfloat16()
        kw = dict(tied=tied, eps=1e-6, unit_offset=unit, logit_softcap=cap)
        got = se.sample_epilogue(x, gamma, w, **kw)
        torch.cuda.synchronize()
        xn = norms.rms_norm(x, gamma, eps=1e-6, unit_offset=unit)
        logits = xn.float() @ (w.float().T if tied else w.float())
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        err = check_tokens(torch, logits, got, EPILOGUE_TOL)
        plain = se.sample_epilogue_plain(x, gamma, w, **kw)
        if not torch.equal(plain, torch.argmax(logits, -1).to(torch.int32)):
            raise AssertionError("sample_epilogue_plain disagrees with its own logits")
        ms = time_ms(torch, lambda: se.sample_epilogue(x, gamma, w, **kw), 50)
        plain_ms = time_ms(torch, lambda: se.sample_epilogue_plain(x, gamma, w, **kw), 5)
        wt = w.T if tied else w
        lib_ms = time_ms(torch, lambda: torch.argmax(torch.matmul(xn, wt), dim=-1), 50)
        nbytes = vocab * hd * 2 + n * hd * 2 + hd * 2 + n * 4
        bms, by = bound(nbytes, 2.0 * n * hd * vocab)
        cases.append(dict(kernel="sample_epilogue", case=name, max_abs_err=err,
                          tol=EPILOGUE_TOL, within_tol=err <= EPILOGUE_TOL, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bms, bound_by=by))
    return cases


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------

def _gap_share(step_logits, tokens) -> tuple[float, float]:
    """(largest logit gap of a chosen token below its row max, share of
    steps where the chosen token is the row argmax)."""
    chosen = step_logits.gather(-1, tokens[..., None])[..., 0]
    gap = (step_logits.amax(dim=-1) - chosen).max().item()
    share = (step_logits.argmax(dim=-1) == tokens).float().mean().item()
    return gap, share


def teacher_forced(torch, forward, KVCache, params, cfg, prompt_ids, tokens,
                   attn_mask=None, pad_offsets=None, tol=TEACHER_TOL) -> dict:
    """Hold the kernel path's tokens against two plain references, both
    fed the same ids: (a) one cache-less plain forward over prompt +
    generated ids, (b) the plain cached twin of the kernel path (prefill,
    then one plain single-token forward per step).  Every chosen token's
    logit must be within ``tol`` of the row max of both; the twin's
    own argmax against (a) shows the bf16 noise floor of the check."""
    b, s = prompt_ids.shape
    n = tokens.shape[1]
    tokens = tokens.long()
    prompt_ids = prompt_ids.long()
    ids = torch.cat([prompt_ids, tokens[:, :-1]], dim=1)
    mask = None
    if attn_mask is not None:
        mask = torch.cat([attn_mask, torch.ones_like(tokens[:, :-1], dtype=torch.bool)], dim=1)
    logits, _ = forward(params, ids, cfg, None, attn_mask=mask, pad_offsets=pad_offsets)
    full = logits[:, s - 1:s - 1 + n]  # [B, n, V]
    del logits
    cache = KVCache.init(cfg, b, s + n, params["final_norm"].dtype)
    step, cache = forward(params, prompt_ids, cfg, cache, attn_mask=attn_mask,
                          pad_offsets=pad_offsets, logits_last_only=True)
    twin = [step[:, -1]]
    for j in range(n - 1):
        step, cache = forward(params, tokens[:, j:j + 1], cfg, cache, pad_offsets=pad_offsets,
                              logits_last_only=True)
        twin.append(step[:, -1])
    twin = torch.stack(twin, dim=1)
    gap_full, share_full = _gap_share(full, tokens)
    gap_twin, share_twin = _gap_share(twin, tokens)
    floor_gap, floor_share = _gap_share(full, twin.argmax(dim=-1))
    out = dict(exact_share_vs_cacheless=share_full, max_gap_vs_cacheless=gap_full,
               exact_share_vs_plain_twin=share_twin, max_gap_vs_plain_twin=gap_twin,
               plain_twin_exact_share_vs_cacheless=floor_share,
               plain_twin_max_gap_vs_cacheless=floor_gap,
               logit_std=full.float().std().item(), tol=tol)
    out["ok"] = bool(torch.isfinite(full).all() and torch.isfinite(twin).all()) and max(gap_full, gap_twin) <= tol
    return out


def main_path(torch, np, kernels: dict, card: str) -> tuple:
    """Drive the main path; returns (result line, the kernel Generator,
    its prompts) — the last two for the profile phase."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 128))
    ragged = [rng.integers(0, cfg.vocab_size, size=n) for n in (37, 128, 80, 101)]

    gen = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                    decode_attn_impl="flash_decode")
    # flash refuses ragged input (as in the JAX package): ragged prefill
    # takes the plain attention path, decode still uses the kernels
    gen_ragged = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="xla",
                           decode_attn_impl="flash_decode")
    if gen.epilogue_impl != "fused" or gen_ragged.epilogue_impl != "fused":
        raise AssertionError("greedy Generator did not select the fused epilogue")
    gen.generate(prompts, 4)  # warm-up: cuBLAS handles, allocator

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = gen.generate(prompts, DECODE_STEPS)
    res_r = gen_ragged.generate_ragged(ragged, DECODE_STEPS)
    streamed = list(gen.stream(prompts[0], STREAM_TOKENS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}

    steps = DECODE_STEPS - 1
    want = {
        "flash_attention": layers * 2,  # generate + stream prefill
        "decode_attention": layers * (2 * steps + STREAM_TOKENS - 1),
        "sample_epilogue": 2 * steps + STREAM_TOKENS - 1,
    }
    if launches != want:
        raise AssertionError(f"launch counts {launches} != implied {want}")
    if res.tokens.shape != (4, DECODE_STEPS) or res_r.tokens.shape != (4, DECODE_STEPS):
        raise AssertionError(f"token shapes {res.tokens.shape} / {res_r.tokens.shape}")
    if len(streamed) != STREAM_TOKENS:
        raise AssertionError(f"stream yielded {len(streamed)} tokens, want {STREAM_TOKENS}")

    dev = torch.device("cuda")
    tf = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(res.tokens, device=dev))
    ids, mask, pads = Generator.left_pad(ragged)
    tf_r = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(ids, device=dev),
        torch.as_tensor(res_r.tokens, device=dev), torch.as_tensor(mask, device=dev),
        torch.as_tensor(pads, device=dev).long())
    tf_s = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(prompts[:1], device=dev),
        torch.as_tensor([streamed], device=dev))

    # float32 twin of the kernel path (outside the counted window)
    params32 = {k: {n: t.float() for n, t in v.items()} if k == "layers" else v.float()
                for k, v in params.items()}
    gen32 = Generator(params32, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                      decode_attn_impl="flash_decode", cache_dtype=torch.float32)
    res32 = gen32.generate(prompts, F32_STEPS)
    tf32 = teacher_forced(
        torch, forward, KVCache, params32, cfg, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(res32.tokens, device=dev), tol=F32_TEACHER_TOL)
    del params32, gen32
    result = dict(
        phase="main_path", model="meta-llama/Llama-3.2-1B", layers=layers,
        weights="seeded random bf16", card=card, launches=launches, implied=want,
        generate=dict(batch=4, prompt_len=128, new_tokens=DECODE_STEPS,
                      ttft_s=res.ttft_s, decode_tok_s_per_seq=res.decode_tokens_per_s,
                      decode_tok_s=res.decode_tokens_per_s * 4,
                      teacher_forced=tf),
        generate_ragged=dict(batch=4, prompt_lens=[37, 128, 80, 101], new_tokens=DECODE_STEPS,
                             ttft_s=res_r.ttft_s, decode_tok_s_per_seq=res_r.decode_tokens_per_s,
                             teacher_forced=tf_r),
        stream=dict(tokens=len(streamed), teacher_forced=tf_s),
        float32=dict(batch=4, prompt_len=128, new_tokens=F32_STEPS, teacher_forced=tf32,
                     teacher_tol=F32_TEACHER_TOL),
        wall_s=wall, teacher_tol=TEACHER_TOL,
    )
    return result, gen, prompts


def profile_generate(torch, gen, prompts, card: str, steps: int = 32) -> dict:
    """torch.profiler over one ``generate`` (prefill + ``steps`` decode
    steps): device time summed by kernel name, and the device's busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    gen.generate(prompts, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(prompts, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's own "self device time" repeats the
        # time of the kernels it launched
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append(dict(name=e.key[:90], device_ms=dev_us / 1e3, count=e.count))
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) / 1e3
    by_kernel = {name: sum(r["device_ms"] for r in rows if marker in r["name"])
                 for name, marker in (("flash_attention", "flash_kernel"),
                                      ("decode_attention", "decode_kernel"),
                                      ("sample_epilogue", "epilogue_"))}
    return dict(phase="profile", card=card, generate_new_tokens=steps, batch=len(prompts),
                wall_s=wall, device_busy_s=busy, port_kernels_device_ms=by_kernel,
                device_busy_share=busy / wall if rows else None, top=rows[:15])


# ----------------------------------------------------------------------

KERNEL_META = {
    "flash_attention": ("llm_np_cp_tpu_torch/csrc/flash_attention.cu",
                        "llm_np_cp_tpu/ops/pallas/flash_attention.py:180"),
    "decode_attention": ("llm_np_cp_tpu_torch/csrc/decode_attention.cu",
                         "llm_np_cp_tpu/ops/pallas/decode_attention.py:930"),
    "sample_epilogue": ("llm_np_cp_tpu_torch/csrc/sample_epilogue.cu",
                        "llm_np_cp_tpu/ops/pallas/sample_epilogue.py:215"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every result line (and the ptxas report) to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from llm_np_cp_tpu_torch.cache import quantize_kv
    from llm_np_cp_tpu_torch.ops import norms
    from llm_np_cp_tpu_torch.ops.cuda import build
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se

    # plain versions and library calls in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: list[dict] = []

    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    dev_line = dict(phase="device", kind=card, count=torch.cuda.device_count(),
                    torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
                    build_s=build_s, build_cached=build.BUILD_INFO.get("cached"))
    emit(dev_line)
    results.append(dev_line)

    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    cases = (flash_cases(torch, F, fa, sdpa_gqa)
             + decode_cases(torch, F, da, quantize_kv, sdpa_gqa)
             + epilogue_cases(torch, se, norms))
    for c in cases:
        line = dict(phase="kernel_case", card=smi, **c)
        emit(line)
        results.append(line)
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"kernels outside tolerance: {bad}")

    kernels = {"flash_attention": fa.flash_attention, "decode_attention": da.decode_attention,
               "sample_epilogue": se.sample_epilogue}
    mp, gen, prompts = main_path(torch, np, kernels, smi)
    emit(mp)
    results.append(mp)
    prof = profile_generate(torch, gen, prompts, smi)
    emit(prof)
    results.append(prof)
    failed = [k for k, v in mp.items() if isinstance(v, dict) and not v.get("teacher_forced", {}).get("ok", True)]
    if failed:
        raise AssertionError(f"teacher-forced check failed for {failed}")

    summary = []
    for name, (source, replaces) in KERNEL_META.items():
        c = next(c for c in cases if c["kernel"] == name)  # the main-path shape
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=mp["launches"][name], max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], case=c["case"],
        ))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(results=results, kernels=summary,
                           ptxas=build.BUILD_INFO.get("ptxas")), f, indent=1)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

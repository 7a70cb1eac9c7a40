#!/usr/bin/env python3
"""Time one checkout's attention kernels and sampling epilogue on the card, kernels and end to end, to compare two.

    python tools/decode_attention_ab.py [--root DIR] [--label NAME]
        [--parts cases,paged_cases,ragged,ragged_nsplit,softmax,epilogue,flash,main_path,
                 busy,sampled,head,prefill,serve_leg_a,serve_leg_b,serve_leg_a_min_p,
                 serve_leg_b_min_p,sass]
        [--replays N]

Imports ``llm_np_cp_tpu_torch`` from DIR (default: the checkout this file
is in) and builds its kernels; the inputs, the timers and the main path's
and the serve leg's settings are this checkout's ``chip_smoke.py``'s, so
both versions see the same work.  Prints one JSON line with:

- ``cases``: ``decode_attention`` (the slab) at the shapes of
  ``chip_smoke.py``'s decode cases (Llama-3.2-1B widths: B=4 x S=256 and
  S=4096 with its ragged rows, bf16 and int8 cache, and one B=1 x S=32768
  row), in CUDA events over 100 calls after warm-up and as device time
  (torch.profiler, every kernel of the call, and the split kernel and the
  combine apart), SDPA beside each bf16 case;
- ``paged_cases``: ``paged_decode_attention`` on the inputs of
  ``chip_smoke.py``'s paged cases (``PAGED_SPECS`` through
  ``paged_inputs``), timed the same way, SDPA on the pre-gathered view and
  the gather beside each bf16 case without softcap;
- ``ragged``: ``ragged_paged_attention`` (the unified tick's kernel) on
  the inputs of ``chip_smoke.py``'s ragged cases (``RAGGED_SPECS``
  through ``ragged_inputs``: the serve shape, long decode rows, the long
  mixed tick, int8 pools, Gemma-2-2B and Llama-3.1-8B widths), timed the
  same way, SDPA on the rows' pre-gathered views beside each bf16 case
  without softcap and the gather timed apart; for the split-KV kernel
  also its NSPLIT, the device time of the kernel and of the combine
  apart, and, where NSPLIT > 1, the kernel alone at one split;
- ``ragged_nsplit``: the same cases and decode-only ticks of 8 rows at
  288-2304 slots (Llama-3.2-1B, Llama-3.1-8B and Gemma-2 widths), the
  device time of kernel + combine at each NSPLIT the band's kv tiles
  allow, the split plan overridden, beside the plan's own NSPLIT;
- ``softmax``: ``softmax`` on the inputs of ``chip_smoke.py``'s softmax
  cases (``SOFTMAX_SPECS`` through ``softmax_inputs``), timed the same
  way, ``torch.softmax`` beside each;
- ``epilogue``: ``sample_epilogue`` on the inputs of ``chip_smoke.py``'s
  epilogue cases (``EPILOGUE_SPECS`` and ``EPILOGUE_INT8_SPECS`` through
  ``epilogue_inputs``: float and int8 heads, tied and untied, with the
  planted best columns checked), timed the same way, the library call
  (``epilogue_library``: matmul + argmax) beside each;
- ``flash``: ``flash_attention`` (prefill) on the inputs of
  ``chip_smoke.py``'s flash cases (``FLASH_SPECS`` through
  ``flash_inputs``: Llama-3.2-1B's main path and 512- and 4096-token
  prompts, Llama-3.1-8B's D=128 at 2048, Gemma-2-2B's D=256 with softcap
  and window), timed the same way, SDPA beside each case without softcap
  or window;
- ``main_path``: the decode rate per sequence of ``Generator.generate``
  on Llama-3.2-1B (seeded random bf16 weights, B=4, 128-token prompts,
  ``chip_smoke.DECODE_STEPS`` new tokens, flash prefill and the slab
  decode kernel), one value per repeat after a warm-up;
- ``busy``: torch.profiler over one 32-token ``generate`` of the
  main path's Generator (``chip_smoke.profile_generate``): wall time,
  device busy time and the busy share;
- ``sampled``: the ``main_path`` rates with a min-p sampler, whose decode
  tail is ``final_logits`` (the plain head product) + the sampler;
- ``head``: the plain head product of that tail (``final_logits`` on
  4 rows over Llama-3.2-1B's tied bf16 head), timed as the kernel cases
  are, and the bytes it allocates above its inputs at its peak;
- ``prefill``: TTFT of ``Generator.generate`` on Llama-3.2-1B (seeded
  random bf16 weights, B=1 x ``chip_smoke.LONG_PROMPT`` tokens, flash
  prefill), one value per repeat after a warm-up, and their median;
- ``serve_leg_a`` / ``serve_leg_b``: served tok/s and TPOT p50 of
  ``ServeEngine.replay_trace`` on ``chip_smoke.py``'s 32-request trace in
  its leg A (unified tick, ragged kernel) or B (phase-split tick, paged
  decode), a fresh engine per replay (after its ``warmup``), and their
  medians; ``serve_leg_a_min_p`` / ``serve_leg_b_min_p``: the same with
  ``chip_smoke.py``'s min-p sampler;
- ``sass``: for each flash and ragged kernel of the library, its ``HMMA``
  (tensor core) and ``FFMA`` instructions in ``cuobjdump -sass`` and, when this
  process compiled the library, its ptxas report (registers, shared
  memory, spills).

Each library call's times are keyed ``library_ms`` and
``library_device_ms``.  ``--parts`` keeps some of the parts (default: all
but ``ragged_nsplit`` and ``sass``), ``--replays`` sets the serve leg's
replay count (default 3).  Run it for two checkouts in turns
(A, B, B, A) in one call: only times from one call on one card compare.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = [(4, 256, False), (4, 256, True), (4, 4096, False), (4, 4096, True), (1, 32768, False)]
REPEATS = 5
SERVE_REPLAYS = 3
PARTS = ("cases", "paged_cases", "ragged", "ragged_nsplit", "softmax", "epilogue", "flash",
         "main_path", "busy", "sampled", "head", "prefill", "serve_leg_a", "serve_leg_b",
         "serve_leg_a_min_p", "serve_leg_b_min_p", "sass")
# the kernels whose SASS ``sass`` counts, by symbol
SASS_KERNELS = ("flash_kernel", "ragged_kernel")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_cases(torch, F, cs, da, quantize_kv) -> list[dict]:
    h, kh, d = 32, 8, 64
    rows = []
    for b, s, int8 in CASES:
        # the inputs of chip_smoke.py's decode_cases
        g = torch.Generator(device="cuda").manual_seed(100 + s + int8)
        q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
        k = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
        v = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
        mask = cs.decode_mask(torch, b, s)
        kw = dict(scale=d ** -0.5)
        if int8:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            kw.update(k_scale=ks, v_scale=vs)
        out = da.decode_attention(q, k, v, mask, **kw)
        err, ok = cs.attn_err_rows(out, da.decode_attention_plain(q, k, v, mask, **kw))
        sdpa = None
        if not int8:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            am = mask[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=am, scale=kw["scale"], enable_gqa=True)
        call = lambda: da.decode_attention(q, k, v, mask, **kw)  # noqa: E731
        rows.append(dict(case=f"b{b}_s{s}_{'int8' if int8 else 'bf16'}", max_abs_err=err,
                         within_tol=ok, **timed(torch, cs, call, sdpa),
                         device_ms_by_kernel=cs.device_ms(torch, call, cs.DECODE_MARKERS)))
    return rows


def timed(torch, cs, call, library=None) -> dict:
    """CUDA-event ms and profiler device ms of ``call`` (and of
    ``library``, the one library call beside it)."""
    every_kernel = {"all": ""}
    row = dict(ms=cs.time_ms(torch, call, 100),
               device_ms=cs.device_ms(torch, call, every_kernel)["all"])
    if library is not None:
        row.update(library_ms=cs.time_ms(torch, library, 100),
                   library_device_ms=cs.device_ms(torch, library, every_kernel)["all"])
    return row


def epilogue_cases(torch, cs) -> list[dict]:
    from llm_np_cp_tpu_torch.ops import norms
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se
    from llm_np_cp_tpu_torch.quant import quantize_array

    rows = []
    for int8, specs in ((False, cs.EPILOGUE_SPECS), (True, cs.EPILOGUE_INT8_SPECS)):
        for i, spec in enumerate(specs):
            x, gamma, w, kw = cs.epilogue_inputs(torch, norms, quantize_array, spec, i, int8)
            got = se.sample_epilogue(x, gamma, w, **kw)
            planted_ok = got[:2].tolist() == [spec[3] - 1, 0]
            lib = cs.epilogue_library(torch, norms, x, gamma, w, kw)
            rows.append(dict(case=spec[0], planted_ok=planted_ok, **timed(
                torch, cs, lambda: se.sample_epilogue(x, gamma, w, **kw), lib)))
            del x, gamma, w, kw, lib
            torch.cuda.empty_cache()
    return rows


def paged_cases(torch, F, cs, da, quantize_kv) -> list[dict]:
    rows = []
    for i, (name, *_, cap, _, int8) in enumerate(cs.PAGED_SPECS):
        args, kw = cs.paged_inputs(torch, quantize_kv, i)
        q, k, v, tables, lens, pads = args
        out = da.paged_decode_attention(*args, **kw)
        err, ok = cs.attn_err_rows(out, da.paged_decode_attention_plain(*args, **kw))
        sdpa = None
        row = dict(case=name, max_abs_err=err, within_tol=ok,
                   nsplit=da.paged_split_plan(q, k, tables) if hasattr(da, "paged_split_plan")
                   else None)
        if not int8 and cap is None:
            views = (cs.gathered(k, tables), cs.gathered(v, tables))
            pos = torch.arange(views[0].shape[1], device=q.device)
            mask = ((pos >= pads[:, None]) & (pos < lens[:, None]))[:, None, :]
            sdpa = lambda: cs.sdpa_pregathered(torch, F, q, views, mask, kw["scale"])  # noqa: E731
            row["gather_ms"] = cs.time_ms(
                torch, lambda: (cs.gathered(k, tables), cs.gathered(v, tables)), 100)
        call = lambda: da.paged_decode_attention(*args, **kw)  # noqa: E731
        row.update(timed(torch, cs, call, sdpa),
                   device_ms_by_kernel=cs.device_ms(torch, call, cs.PAGED_MARKERS))
        rows.append(row)
    return rows


def ragged_cases(torch, F, cs, da, quantize_kv) -> list[dict]:
    rows = []
    for i, (name, *_, cap, _, int8, _, _, _, _) in enumerate(cs.RAGGED_SPECS):
        args, kw, live = cs.ragged_inputs(torch, quantize_kv, i)
        call = lambda: da.ragged_paged_attention(*args, **kw)  # noqa: E731
        out = call()
        err, ok = cs.attn_err_rows(out[live], da.ragged_paged_attention_plain(*args, **kw)[live])
        row = dict(case=name, max_abs_err=err, within_tol=ok and not bool(out[~live].any()))
        sdpa = None
        if not int8 and cap is None:
            sdpa, gather = cs.ragged_library(torch, F, args, kw, live)
            row["gather_ms"] = cs.time_ms(torch, gather, 100)
        row.update(timed(torch, cs, call, sdpa))
        if hasattr(da, "ragged_split_plan"):  # the split-KV kernel (not the scalar one)
            nsplit = da.ragged_split_plan(args[0], args[1], args[3], args[8])
            row.update(nsplit=nsplit, device_ms_by_kernel=cs.device_ms(
                torch, call, cs.RAGGED_MARKERS, attempts=1 if nsplit == 1 else 3))
            if nsplit > 1:  # the kernel alone at one split, no combine
                one = lambda: da.ragged_paged_attention_split(*args, nsplit=1, **kw)  # noqa: E731
                row["nsplit1_device_ms"] = cs.device_ms(torch, one, {"k": "ragged_kernel"})["k"]
        rows.append(row)
        del args, kw, out, sdpa
        torch.cuda.empty_cache()
    return rows


# decode-only ticks of 8 rows all at one length (segments, lengths, pads,
# width) for the NSPLIT sweep
def _decode8(length: int) -> tuple:
    return [(r, length - 1, 1) for r in range(8)], [length] * 8, [0] * 8, 64


SWEEP_SPECS = [
    (f"{tag}_decode8_{n}", h, kh, d, None, None, False, *_decode8(n))
    for tag, h, kh, d in (("llama1b", 32, 8, 64), ("llama8b_widths", 32, 8, 128),
                          ("gemma2_widths", 8, 4, 256))
    for n in (288, 576, 1152, 2304)
]
SWEEP_NSPLIT = (1, 2, 3, 4, 6, 8, 16)


def ragged_nsplit(torch, cs, da, quantize_kv) -> list[dict]:
    """Device ms of ``ragged_paged_attention`` (kernel + combine) with its
    split plan replaced by each NSPLIT of ``SWEEP_NSPLIT`` up to the
    band's kv tiles, on ``RAGGED_SPECS`` and ``SWEEP_SPECS``, beside the
    plan's own NSPLIT."""
    rows = []
    plan = da.ragged_split_plan
    specs = [(i, None) for i in range(len(cs.RAGGED_SPECS))] + [
        (100 + i, spec) for i, spec in enumerate(SWEEP_SPECS)]
    try:
        for i, spec in specs:
            args, kw, live = cs.ragged_inputs(torch, quantize_kv, i, spec)
            name, *_, d, _, _, _, _, lengths, _, _ = spec or cs.RAGGED_SPECS[i]
            call = lambda: da.ragged_paged_attention(*args, **kw)  # noqa: E731
            row = dict(case=name, planned=plan(args[0], args[1], args[3], args[8]), device_ms={})
            tiles = -(-max(lengths) // da._tile(d))
            for n in (n for n in SWEEP_NSPLIT if n <= tiles):
                da.ragged_split_plan = lambda *_, n=n: n
                dev = cs.device_ms(torch, call, cs.RAGGED_MARKERS, attempts=1 if n == 1 else 3)
                row["device_ms"][n] = dict(dev, total=sum(dev.values()))
                da.ragged_split_plan = plan
            rows.append(row)
            del args, kw, live
            torch.cuda.empty_cache()
    finally:
        da.ragged_split_plan = plan
    return rows


def softmax_cases(torch, cs) -> list[dict]:
    from llm_np_cp_tpu_torch.ops.cuda import softmax as sm

    rows = []
    for i, (name, _, dtype) in enumerate(cs.SOFTMAX_SPECS):
        x = cs.softmax_inputs(torch, i)
        diff = (sm.softmax(x).float() - sm.softmax_plain(x).float()).abs()
        rows.append(dict(case=name, max_abs_err=diff.max().item(), **timed(
            torch, cs, lambda: sm.softmax(x), lambda: torch.softmax(x, dim=-1))))
        del x
    return rows


def flash_cases(torch, F, cs) -> list[dict]:
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa

    rows = []
    for i, (name, *_, cap, win) in enumerate(cs.FLASH_SPECS):
        q, k, v, kw = cs.flash_inputs(torch, i)
        out = fa.flash_attention(q, k, v, **kw)
        err, ok = cs.flash_err(out, fa.flash_attention_plain(q, k, v, **kw))
        sdpa = None
        if cap is None and win is None:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, scale=kw["scale"], enable_gqa=True)
        rows.append(dict(case=name, max_abs_err=err, within_tol=ok, **timed(
            torch, cs, lambda: fa.flash_attention(q, k, v, **kw), sdpa)))
        del q, k, v, out, sdpa
        torch.cuda.empty_cache()
    return rows


def prefill_ttft(torch, np, cs) -> dict:
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, cs.LONG_PROMPT))
    gen = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                    decode_attn_impl="flash_decode")
    gen.generate(prompt, 1)  # warm-up: cuBLAS handles, allocator
    ttft = [gen.generate(prompt, 1).ttft_s for _ in range(REPEATS)]
    return dict(batch=1, prompt_len=cs.LONG_PROMPT, ttft_s=ttft, median=sorted(ttft)[len(ttft) // 2])


def sass_counts() -> dict:
    from llm_np_cp_tpu_torch.ops.cuda import build

    lib = build.build()
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in SASS_KERNELS) else None
            if name:
                counts[name] = dict(HMMA=0, FFMA=0)
        elif name:
            for op in ("HMMA", "FFMA"):
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    # ptxas's lines for each such entry (present when this process built it)
    ptxas = [blk for blk in (build.BUILD_INFO.get("ptxas") or "").split("Compiling entry function")
             if any(k in blk.split("\n", 1)[0] for k in SASS_KERNELS)]
    return dict(library=str(lib), sass=counts, ptxas=[blk.strip() for blk in ptxas])


def serve_leg(torch, np, cs, leg: str, replays: int, sampler: str = "greedy") -> dict:
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import init_params

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = cs.serve_trace(np, cfg, cs.SERVE_REQUESTS, cs.SERVE_NEW_TOKENS, seed=0)
    tok_s, tpot = [], []
    for _ in range(replays):
        eng = cs.serve_engine(params, cfg, torch.bfloat16, leg, sampler=sampler)
        eng.warmup([cs.SERVE_PROMPTS[0]], 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = eng.replay_trace(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if snap["finished"] != cs.SERVE_REQUESTS:
            raise AssertionError(f"leg {leg} finished {snap['finished']} of {cs.SERVE_REQUESTS}")
        tok_s.append(snap["total_generated_tokens"] / wall)
        tpot.append(snap["tpot_s_p50"])
        del eng
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return dict(leg=leg, sampler=sampler, requests=cs.SERVE_REQUESTS,
                new_tokens=cs.SERVE_NEW_TOKENS, tok_s=tok_s,
                tpot_s_p50=tpot, tok_s_median=med(tok_s), tpot_s_p50_median=med(tpot))


def main_generator(torch, np, kind: str = "greedy"):
    """The main path's Generator on Llama-3.2-1B (seeded random bf16
    weights, flash prefill, the slab decode kernel) with a ``kind``
    sampler, and its B=4 x 128-token prompts."""
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 128))
    gen = Generator(params, cfg, sampler=Sampler(kind), prefill_attn_impl="flash",
                    decode_attn_impl="flash_decode")
    return gen, prompts


def main_path_rates(torch, np, cs, kind: str = "greedy") -> dict:
    gen, prompts = main_generator(torch, np, kind)
    gen.generate(prompts, 4)  # warm-up: cuBLAS handles, allocator (and the step's graph)
    rates = [gen.generate(prompts, cs.DECODE_STEPS).decode_tokens_per_s for _ in range(REPEATS)]
    return dict(sampler=kind, batch=4, prompt_len=128, new_tokens=cs.DECODE_STEPS,
                decode_tok_s_per_seq=rates, median=sorted(rates)[len(rates) // 2])


def head_product(torch, cs) -> dict:
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import final_logits

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    g = torch.Generator(device="cuda").manual_seed(0)
    h, v = cfg.hidden_size, cfg.vocab_size
    params = {"final_norm": torch.ones(h, dtype=torch.bfloat16, device="cuda"),
              "embed_tokens": (0.02 * torch.randn((v, h), generator=g, device="cuda")).bfloat16()}
    x = torch.randn((4, 1, h), generator=g, device="cuda").bfloat16()
    call = lambda: final_logits(params, x, cfg)  # noqa: E731
    row = timed(torch, cs, call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    return dict(rows=4, hidden=h, vocab=v, **row,
                peak_bytes_above_inputs=torch.cuda.max_memory_allocated() - base)


def busy_share(torch, np, cs) -> dict:
    gen, prompts = main_generator(torch, np)
    prof = cs.profile_generate(torch, gen, prompts, cs.nvidia_smi_line())
    return {k: prof[k] for k in ("generate_new_tokens", "batch", "wall_s", "device_busy_s",
                                 "device_busy_share", "port_kernels_device_ms")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--parts", default=",".join(p for p in PARTS
                                                if p not in ("ragged_nsplit", "sass")))
    ap.add_argument("--replays", type=int, default=SERVE_REPLAYS)
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: choose from {','.join(PARTS)}")
    cs = load_chip_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_attention_ab: no CUDA card visible", file=sys.stderr)
        return 1
    from llm_np_cp_tpu_torch.cache import quantize_kv
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    run = dict(cases=lambda: kernel_cases(torch, F, cs, da, quantize_kv),
               paged_cases=lambda: paged_cases(torch, F, cs, da, quantize_kv),
               ragged=lambda: ragged_cases(torch, F, cs, da, quantize_kv),
               ragged_nsplit=lambda: ragged_nsplit(torch, cs, da, quantize_kv),
               softmax=lambda: softmax_cases(torch, cs),
               epilogue=lambda: epilogue_cases(torch, cs),
               flash=lambda: flash_cases(torch, F, cs),
               main_path=lambda: main_path_rates(torch, np, cs),
               busy=lambda: busy_share(torch, np, cs),
               sampled=lambda: main_path_rates(torch, np, cs, "min_p"),
               head=lambda: head_product(torch, cs),
               prefill=lambda: prefill_ttft(torch, np, cs),
               serve_leg_a=lambda: serve_leg(torch, np, cs, "A_mixed", args.replays),
               serve_leg_b=lambda: serve_leg(torch, np, cs, "B_split_paged", args.replays),
               serve_leg_a_min_p=lambda: serve_leg(torch, np, cs, "A_mixed", args.replays,
                                                   "min_p"),
               serve_leg_b_min_p=lambda: serve_leg(torch, np, cs, "B_split_paged", args.replays,
                                                   "min_p"),
               sass=sass_counts)
    print(json.dumps(dict(label=args.label, root=args.root, card=cs.nvidia_smi_line(),
                          **{part: run[part]() for part in parts})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

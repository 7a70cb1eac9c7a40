#!/usr/bin/env python3
"""Repeat the observe phase's profiled leg on the card and report how the
profiler's device records join the engine's ticks.

    python tools/profile_ticks.py [--legs N] [--out FILE]

Builds the kernels, then, with ``chip_smoke.py``'s settings (Llama-3.2-1B
at full width on seeded random bf16 weights, the http cell's engine and
its 32-request Poisson trace), replays the trace in real time into a
traced engine under ``torch.profiler`` N times (default 6).  Each leg is
read by ``chip_smoke.device_per_tick`` and printed as one JSON line: the
ticks, the graph launches, the launches none of whose kernel records
reached the profile, the ticks whose records the profiler placed outside
their window on the host's clock and by how much, and the kernel records
a launch carried (a histogram).  Needs a CUDA card.
"""
import argparse
import json
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", type=int, default=6)
    ap.add_argument("--out", help="also write every leg's line to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.cuda import build
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace, pool_geometry
    from llm_np_cp_tpu_torch.serve.telemetry import TelemetryModel
    from llm_np_cp_tpu_torch.serve.tracing import TraceRecorder

    if not torch.cuda.is_available():
        print("profile_ticks: no CUDA card visible", file=sys.stderr)
        return 1
    build.library()
    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = poisson_trace(np.random.default_rng(cs.HTTP_SEED), cs.HTTP_REQUESTS,
                          rate_rps=cs.HTTP_RATE, prompt_len_range=cs.HTTP_PROMPTS,
                          max_new_tokens=cs.HTTP_NEW, vocab_size=cfg.vocab_size,
                          seed_base=cs.HTTP_SEED)
    _, num_blocks, max_seq_len = pool_geometry(cs.HTTP_PROMPTS[1], cs.HTTP_NEW, cs.HTTP_SLOTS,
                                               cs.HTTP_BLOCK, cs.HTTP_CHUNK)
    eng = ServeEngine(params, cfg, sampler=Sampler("greedy"), max_slots=cs.HTTP_SLOTS,
                      num_blocks=num_blocks, block_size=cs.HTTP_BLOCK, max_seq_len=max_seq_len,
                      prefill_chunk=cs.HTTP_CHUNK, cache_dtype=torch.bfloat16,
                      device=torch.device("cuda"), mixed_step="on")
    eng.warmup([int(item["prompt"].size) for item in trace], cs.HTTP_NEW)
    torch.cuda.synchronize()
    card = cs.nvidia_smi_line()
    lines = []
    for leg in range(args.legs):
        eng.scheduler.finished.clear()
        # the telemetry puts each tick's dispatch → fetch wall in its args
        eng.tracer = TraceRecorder(ring=cs.OBSERVE_RING)
        eng.telemetry = TelemetryModel(cfg, params)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.replay_trace(trace, realtime=True)
            torch.cuda.synchronize()
        checks: list[str] = []
        out = cs.device_per_tick(np, prof, eng.tracer.events(), checks)
        per_launch = Counter(r.correlation_id() for r in prof.profiler.kineto_results.events()
                             if r.device_type() == DeviceType.CUDA
                             and not r.name().startswith("serve."))
        line = dict(leg=leg, card=card, whole=not checks,
                    records_per_launch=Counter(n for n in per_launch.values() if n > 2
                                               ).most_common(6),
                    **{k: out[k] for k in ("ticks", "ticks_with_device_work", "graph_launches",
                                           "launches_without_records", "device_records",
                                           "displaced_ticks", "displaced_ms_max",
                                           "device_span_ms_p50", "device_busy_ms_p50",
                                           "dispatch_to_fetch_ms_p50")})
        lines.append(line)
        print(json.dumps(line), flush=True)
        eng.tracer = eng.telemetry = None
        if args.out:
            with open(args.out, "w") as f:
                json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh phase alone, after the kernel cases at a
mesh rank's shapes, and print what they measured.

    python tools/mesh_phase.py [--out FILE]

The kernel cases are ``chip_smoke.py``'s cases named in ``CASES``: flash,
decode and its combine at 16 of Llama-3.2-1B's 32 heads, the epilogue on
half its tied head (float at N = 1, 2, 4, 8 and int8) with the row
maxima, the categorical draw of a data rank's rows 2..3 of 4, and a
model=4 rank's serve shapes (the ragged serve tick at 8 / 2 heads, the
paged int8 decode, the epilogue on a quarter of the head at N = 8).  A
name that matches no case fails the run.  Then
``chip_smoke.mesh_phase``: one spawned group of 4 ranks on cuda:0 over
gloo, its four generation legs, two serve legs and two training legs
(t1 / t2, against a 2-step one-rank ``train.run`` made here), their
checks.  Prints the torch / CUDA
versions, ``init_device_mesh``'s signature, the card's ``nvidia-smi``
name and power limit, one JSON line a kernel case, and a line a leg
(TTFT, decode rate, first divergence, the teacher-forced or support
check, rank 0's launches and collectives); ``--out`` keeps everything
as JSON.  Exits 1 when a check fails.  Needs a CUDA card.
"""
import argparse
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the kernel cases at the shapes the mesh phase's ranks launch
CASES = (
    "llama1b_tp2_rank_2x128",
    "llama1b_tp2_rank_b2_s256_bf16_ragged", "llama1b_tp2_rank_b1_s2176_bf16",
    "llama1b_tp2_shard_n1_tied", "llama1b_tp2_shard_n2_tied", "llama1b_tp2_shard_n4_tied",
    "llama1b_tp2_shard_n8_tied", "llama1b_tp2_shard_n2_tied_int8",
    "mesh_data_rank1_2x128256_row0_2",
    "llama1b_tp4_rank_mixed_6dec_2x64pf", "llama1b_tp4_rank_serve_b8_bs16_int8",
    "llama1b_tp4_shard_n8_tied",
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the cases and the phase's record to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh

    from llm_np_cp_tpu_torch import random as tr
    from llm_np_cp_tpu_torch.cache import quantize_kv
    from llm_np_cp_tpu_torch.ops import norms
    from llm_np_cp_tpu_torch.ops.cuda import build
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se
    from llm_np_cp_tpu_torch.ops.cuda import threefry as tfk
    from llm_np_cp_tpu_torch.quant import quantize_array

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA card visible", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(inspect.signature(init_device_mesh), flush=True)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    cases = (cs.flash_cases(torch, F, fa, sdpa_gqa, CASES)
             + cs.decode_cases(torch, F, da, quantize_kv, sdpa_gqa, CASES)
             + cs.combine_cases(torch, da, CASES)
             + cs.paged_cases(torch, F, da, quantize_kv, sdpa_gqa, CASES)
             + cs.ragged_cases(torch, F, da, quantize_kv, sdpa_gqa, CASES)
             + cs.epilogue_cases(torch, se, norms, quantize_array, False, CASES)
             + cs.epilogue_cases(torch, se, norms, quantize_array, True, CASES)
             + cs.threefry_cases(torch, tr, tfk, CASES))
    for c in cases:
        print(json.dumps(c), flush=True)
    missing = set(CASES) - {c["case"] for c in cases}
    if missing:
        print(f"mesh_phase: no case named {sorted(missing)}", file=sys.stderr)
        return 1
    me = cs.mesh_phase(torch, np, smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(cases=cases, mesh=me), f, indent=1, default=str)
    for name, leg in me["legs"].items():
        print(name, json.dumps({k: leg[k] for k in ("ttft_s", "decode_tok_s_per_seq", "wall_s",
                                                     "first_divergence", "check")}, default=str),
              json.dumps(leg["ranks"][0]["launches"]), json.dumps(leg["ranks"][0]["collectives"]),
              flush=True)
    for name, leg in me["serve"].items():
        print(name, json.dumps({k: leg[k] for k in (
            "mesh_desc", "steps", "ticks", "prefix_blocks_hit", "wall_s", "tok_s", "ttft_s_p50",
            "ttft_s_p99", "tpot_s_p50", "tpot_s_p99", "teacher_forced", "one_rank")}, default=str),
              json.dumps(leg["ranks"][0], default=str), flush=True)
    for name, leg in me["train"].items():
        print(name, json.dumps({k: leg[k] for k in ("losses", "one_rank_losses", "rel_diff",
                                                     "step_s")}, default=str),
              json.dumps(leg["ranks"][0], default=str), flush=True)
    print(json.dumps(dict(group_s=me["group_s"], phase_s=me["phase_s"], ok=me["ok"],
                          checks=me["checks"]), default=str), flush=True)
    bad = [c["case"] for c in cases if not c["within_tol"]]
    return 0 if me["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())

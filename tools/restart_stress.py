#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s restart phase alone, with the request journal's
writer held back, and print one JSON line a run.

    python tools/restart_stress.py [--root DIR] [--hold-back S ...] [--out FILE]

Each hold-back value (seconds, default ``0.05 0.01 0``) runs the phase
once in a child process whose journal writer sleeps that long before
every batch, and so do the writers of the ``serve`` children the phase
starts (a ``sitecustomize`` on their ``PYTHONPATH``): a disk whose writes
and fsyncs are slow, which widens the window between a token reaching
the journal and reaching its client.  ``--root`` runs the code of another
checkout (a parent commit unpacked with ``git archive``) in place of this
one.  A line holds the phase's checks, its ``kill`` record (streams
complete and resumed, journal replays), its teacher forcing against the
cache-less forward, the parity with the plain leg, and the journaled /
plain tok/s.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SITE = '''import os
import time

_hold = float(os.environ.get("LLM_JOURNAL_HOLD_BACK_S") or 0)
if _hold:
    from llm_np_cp_tpu_torch.serve import journal as _journal

    _write = _journal.RequestJournal._writer_batch

    def _held_back(self, batch):
        time.sleep(_hold)
        _write(self, batch)

    _journal.RequestJournal._writer_batch = _held_back
'''

CHILD = '''import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from llm_np_cp_tpu_torch.ops.cuda import build
build.library()
t0 = time.perf_counter()
r = cs.restart_phase(torch, np, cs.nvidia_smi_line())
legs = r["legs"]
print("RESULT " + json.dumps(dict(
    seconds=time.perf_counter() - t0, ok=r["ok"], checks=r["checks"], kill=r["kill"],
    teacher_forced=r["teacher_forced"], parity_ok=r["parity_vs_plain"]["ok"],
    journaled_over_plain_tok_s=r["journaled_over_plain_tok_s"],
    journal_fsync_p99_s=legs["journaled"]["journal_fsync_p99_s"]), default=str))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose code runs (default: this one)")
    ap.add_argument("--hold-back", type=float, nargs="+", default=[0.05, 0.01, 0.0])
    ap.add_argument("--out", help="also write every run's line to this JSON file")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    site = os.path.join(ROOT, "smoke_out", "hold_back")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SITE)
    lines = []
    for hold in args.hold_back:
        env = dict(os.environ, LLM_JOURNAL_HOLD_BACK_S=str(hold),
                   PYTHONPATH=os.pathsep.join([site, root]))
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        line = dict(root=root, hold_back_s=hold, rc=proc.returncode)
        if found:
            line.update(json.loads(found[-1][len("RESULT "):]))
        else:
            line["stderr_tail"] = proc.stderr[-2000:]
        print(json.dumps(line, default=str), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0 if all(ln.get("rc") == 0 for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())

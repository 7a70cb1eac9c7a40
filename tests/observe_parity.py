"""Paired runs of the port's and the JAX package's ``ServeEngine`` with the
whole observability plane attached — a ``TraceRecorder``, a
``TickSentinel``, a ``TelemetryModel`` given the same constants, a
``TenantLedger`` with fair-share prefill and an SLO policy, and the
metrics' ``SLOTracker`` — on the CPU in float32, for
``tests/test_torch_{tracing,telemetry,slo,tenants}.py``.

Each leg runs once a process (cached): the same seeded weights, the same
prompts (each with its trace id, tenant and seed), every request
submitted at once so that both engines plan the same ticks, and one
request aborted from its token callback at its third token.  The
``tier`` leg instead runs the host-tier tests' discipline (requests one
at a time over a starved pool, the tier drained after each), so that the
writer threads' timing cannot change a restore decision.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import slo as jslo
from llm_np_cp_tpu.serve import telemetry as jtel
from llm_np_cp_tpu.serve import tenants as jten
from llm_np_cp_tpu.serve import tracing as jtr
from llm_np_cp_tpu.serve.host_tier import HostTier as JHostTier
from llm_np_cp_tpu.serve.metrics import ServeMetrics as JServeMetrics
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import slo, telemetry, tenants, tracing
from llm_np_cp_tpu_torch.serve.host_tier import HostTier
from llm_np_cp_tpu_torch.serve.metrics import ServeMetrics

# the constants both telemetry models grade against (the port's defaults)
HBM_GBPS, PEAK_TFLOPS = 3350.0, 989.0
# loose targets: CPU walls are long, so verdicts here turn on aborts only
POLICY = dict(ttft_s=60.0, tpot_s=30.0)
TENANTS = ("team-a", "team-b", "default")
NEW_TOKENS = 6
# the spec leg's streams run long enough to draft past the window
SPEC_NEW_TOKENS = 12
# the request aborted from its own callback, and at which token
ABORT_RID, ABORT_AT = 2, 3
COST_KEYS = ("kind", "tokens", "kv_read_bytes", "kv_write_bytes", "weight_bytes", "flops")

# leg → engine keywords (both packages), how the leg is driven
LEGS = {
    "mixed": dict(mixed_step="on", enable_prefix_cache=True),
    "split": dict(mixed_step="off", decode_attn_impl="paged", enable_prefix_cache=True),
    # prompt lookup drafts on the JAX init's cycling streams; past a window
    # of 4 drafted tokens a floor above 1 sends every drafting stream back
    # to plain decode (spec-fallback)
    "spec": dict(mixed_step="on", spec_k=2, spec_min_accept=1.01, spec_window=4),
    "tier": dict(mixed_step="on", enable_prefix_cache=True, max_slots=2, num_blocks=12),
}


@functools.lru_cache(maxsize=None)
def models():
    """(port config, port params, JAX config, JAX params): the JAX
    package's own seeded init, handed to both packages as numpy (a random
    model whose greedy streams fall into cycles that prompt lookup
    drafts)."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg,
                                                    dtype=jnp.float32))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def recording(base):
    """``base`` (a package's ``TelemetryModel``) that keeps every graded
    tick's planned bill and every prefill record."""

    class Recording(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.costs: list[dict] = []
            self.prefills: list[dict] = []

        def finish(self, cost, device_time_s):
            self.costs.append({k: cost[k] for k in COST_KEYS})
            return super().finish(cost, device_time_s)

        def prefill_cost(self, eng, req, device_time_s):
            rec = super().prefill_cost(eng, req, device_time_s)
            self.prefills.append({k: v for k, v in rec.items() if k != "device_time_s"})
            return rec

    return Recording


def prompts(leg: str) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    if leg == "tier":
        # distinct prompts whose shareable prefix blocks outgrow the pool
        return [rng.integers(1, 50, size=24).astype(np.int32) for _ in range(6)]
    if leg == "spec":
        return [np.resize(rng.integers(1, 256, size=3), n).astype(np.int32)
                for n in (9, 12, 7, 14, 10)]
    base = rng.integers(1, 256, size=16).astype(np.int32)
    # two share a 16-token prefix (prefix-cache hits), the rest are fresh
    return [base, np.concatenate([base, rng.integers(1, 256, size=5).astype(np.int32)])] + [
        rng.integers(1, 256, size=n).astype(np.int32) for n in (5, 20, 11)]


def trace_id(rid: int) -> str:
    return f"{rid + 1:032x}"


def tenant(rid: int) -> str:
    return TENANTS[rid % len(TENANTS)]


def build(port: bool, leg: str, *, observed: bool = True, tier=None, **extra):
    """One engine of the leg, the observability plane attached (or not)."""
    cfg, tp, jcfg, jp = models()
    kw = dict(max_slots=4, num_blocks=48, block_size=8, max_seq_len=64)
    kw.update(LEGS[leg])
    kw.update(extra)
    if port:
        mods = dict(tracing=tracing, slo=slo, telemetry=telemetry, tenants=tenants)
        eng_cls, sampler, metrics_cls = serve.ServeEngine, Sampler("greedy"), ServeMetrics
        kw.update(cache_dtype=torch.float32, device="cpu")
        params, config = tp, cfg
    else:
        mods = dict(tracing=jtr, slo=jslo, telemetry=jtel, tenants=jten)
        eng_cls, sampler, metrics_cls = jserve.ServeEngine, JSampler("greedy"), JServeMetrics
        kw.update(cache_dtype=jnp.float32)
        params, config = jp, jcfg
    if observed:
        policy = mods["slo"].SLOPolicy(**POLICY)
        kw.update(
            tracer=mods["tracing"].TraceRecorder(),
            sentinel=mods["slo"].TickSentinel(warmup_ticks=4),
            telemetry=recording(mods["telemetry"].TelemetryModel)(
                config, params, hbm_gbps=HBM_GBPS, peak_tflops=PEAK_TFLOPS),
            tenants=mods["tenants"].TenantLedger(fairness=True, policy=policy))
    eng = eng_cls(params, config, sampler=sampler, host_tier=tier, **kw)
    if observed:
        eng.metrics = metrics_cls(clock=eng.clock, slo=mods["slo"].SLOTracker(policy))
    return eng


def drive(eng, leg: str) -> None:
    """Submit the leg's prompts and run them to completion."""
    ps = prompts(leg)
    if leg == "tier":
        for _ in range(2):
            for p in ps:
                rid = eng._next_id
                eng.submit(p, 4, trace_id=trace_id(rid), tenant=tenant(rid))
                eng.run_until_complete()
                eng.host_tier.drain()
        return

    def abort_at(req, tok, delta):
        if req.req_id == ABORT_RID and len(req.generated) == ABORT_AT:
            eng.abort(req.req_id)

    n_new = SPEC_NEW_TOKENS if leg == "spec" else NEW_TOKENS
    for rid, p in enumerate(ps):
        eng.submit(p, n_new, request_id=rid, seed=rid, trace_id=trace_id(rid),
                   tenant=tenant(rid), callback=abort_at, speculative=leg == "spec")
    eng.run_until_complete()


@functools.lru_cache(maxsize=None)
def run(leg: str, port: bool) -> dict:
    """One engine's run of the leg and what the tests read of it."""
    tier = None
    if leg == "tier":
        tier = HostTier(64 << 20) if port else JHostTier(64 << 20)
        tier.policy = "always"
    eng = build(port, leg, tier=tier)
    drive(eng, leg)
    reqs = sorted(list(eng.scheduler.finished) + list(eng.scheduler.aborted),
                  key=lambda r: r.req_id)
    out = dict(engine=eng, requests=reqs, tokens={r.req_id: list(r.generated) for r in reqs},
               events=eng.tracer.events(), costs=eng.telemetry.costs,
               prefills=eng.telemetry.prefills, snapshot=eng.metrics.snapshot(),
               tenants=eng.tenants.snapshot(), compile_counts=eng.compile_counts())
    if tier is not None:
        tier.close()
    return out


def request_track(events: list[dict], rid: int) -> list[tuple]:
    """A request's async track: (name, phase, args) in order, times out."""
    return [(e["name"], e["ph"], e.get("args", {})) for e in events
            if e.get("cat") == "request" and e.get("id") == rid]


def ticks(events: list[dict], names: tuple[str, ...]) -> list[tuple[dict, list[dict]]]:
    """Each ``tick`` span with the phase slices appended after it."""
    out, i = [], 0
    while i < len(events):
        ev = events[i]
        i += 1
        if ev.get("name") == "tick" and ev.get("ph") == "X":
            out.append((ev, events[i:i + len(names)]))
            i += len(names)
    return out

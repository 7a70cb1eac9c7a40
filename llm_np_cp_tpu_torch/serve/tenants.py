"""Multi-tenant accounting: tenant identity, per-tenant cost metering,
SLO burn and the fair-share admission order (port of
``llm_np_cp_tpu/serve/tenants.py``).

Host-side bookkeeping over the per-request cost fields that
``serve/telemetry.TelemetryModel`` fills: it adds no device operation,
no host sync and no capture.

- ``normalize_tenant``: the one validator every surface shares.  Tenant
  strings come from untrusted HTTP headers and bodies, so the charset is
  whitelisted to ``[A-Za-z0-9._-]`` and the length capped: a string that
  passes is Prometheus-label-safe and JSON-safe verbatim.
- ``TenantLedger``: per-engine accounting, fed at request terminals
  (``on_terminal``) and admission throttles (``on_throttle``) —
  requests, tokens, finish reasons, the four cost fields summed per
  tenant (they sum to the global ``ServeMetrics`` ledgers), and a lazy
  per-tenant ``SLOTracker`` when a policy is attached.  ``cost_shares``
  is the fairness sort key ``ServeEngine._fair_prefill_order`` hands the
  planner; ``max_inflight`` is the per-tenant cap whose excess raises
  ``scheduler.TenantThrottled`` (HTTP 429).
- ``aggregate_tenants``: summed counters and per-tenant burn rates
  recomputed from summed window totals (``GET /debug/tenants``).

The engine's ``tenants`` attribute is ``None`` unless a ledger is given,
and every hook is one ``is None`` check.  The scrape emits the top
``max_series`` tenants by accumulated cost and rolls the rest into one
``tenant="other"`` labelset, so a flood of tenant ids cannot blow up the
scrape.  Counters are mutated under the ledger's own lock: terminals land
from the engine's tick thread while the scrape and ``/debug/tenants``
read from the event loop.  ``clone_fresh`` carries the ledger across a
supervised restart, and the supervisor mutes it on the dead engine.
"""

from __future__ import annotations

import string
import threading
import time
from collections import Counter
from typing import Any, Callable, Iterable

from llm_np_cp_tpu_torch.serve.slo import SLOPolicy, SLOTracker, aggregate_slo

DEFAULT_TENANT = "default"
#: Hard cap on tenant-id length; also the charset whitelist below.
#: Everything that passes is Prometheus-label- and JSON-safe verbatim.
TENANT_MAX_LEN = 64
_TENANT_CHARS = frozenset(string.ascii_letters + string.digits + "._-")

#: The rollup label for tenants past the top-``max_series`` by cost.
OTHER_TENANT = "other"


def normalize_tenant(value: Any) -> str:
    """Validate/normalize one tenant id from an untrusted source.

    ``None`` and ``""`` mean "no tenant" → ``"default"``.  Anything
    else must be a string of at most ``TENANT_MAX_LEN`` characters
    drawn from ``[A-Za-z0-9._-]`` — the intersection of what Prometheus
    label values, JSON strings, and log lines can carry verbatim.
    Raises ``ValueError`` with an actionable message otherwise (the
    HTTP layer maps it to a 400)."""
    if value is None or value == "":
        return DEFAULT_TENANT
    if not isinstance(value, str):
        raise ValueError(
            f"tenant must be a string, got {type(value).__name__}"
        )
    if len(value) > TENANT_MAX_LEN:
        raise ValueError(
            f"tenant id exceeds {TENANT_MAX_LEN} characters "
            f"({len(value)})"
        )
    bad = set(value) - _TENANT_CHARS
    if bad:
        shown = "".join(sorted(bad))
        raise ValueError(
            f"tenant id contains disallowed characters {shown!r} "
            "(allowed: letters, digits, '.', '_', '-')"
        )
    return value


def _fresh_entry() -> dict[str, Any]:
    return {
        "requests": 0,
        "tokens": 0,
        "finish_reasons": Counter(),
        "kv_bytes_read": 0.0,
        "kv_bytes_written": 0.0,
        "weight_bytes_amortized": 0.0,
        "device_time_s": 0.0,
        "throttled": 0,
    }


class TenantLedger:
    """Per-engine multi-tenant accounting (see module docstring).

    ``fairness`` / ``max_inflight`` are read by the engine's admission
    paths (plain attribute reads — config, not state); the mutable
    counters live in ``_tenants`` under ``_lock``.
    """

    def __init__(
        self,
        *,
        fairness: bool = False,
        max_inflight: int | None = None,
        max_series: int = 20,
        policy: SLOPolicy | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(
                f"tenant max_inflight must be >= 1, got {max_inflight}"
            )
        if max_series < 1:
            raise ValueError(
                f"max_series must be >= 1, got {max_series}"
            )
        self.fairness = bool(fairness)
        self.max_inflight = max_inflight
        self.max_series = max_series
        self.policy = policy
        self.clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, dict[str, Any]] = {}
        self._slo: dict[str, SLOTracker] = {}

    # -- write (engine tick thread) ------------------------------------
    def _entry(self, tenant: str) -> dict[str, Any]:
        ent = self._tenants.get(tenant)
        if ent is None:
            ent = self._tenants[tenant] = _fresh_entry()
        return ent

    def on_terminal(self, req: Any) -> None:
        """Fold one terminal request into its tenant's ledger — called
        right after ``ServeMetrics.on_finish``/``on_abort``, so the
        per-tenant sums and the global ledgers see the same terminals."""
        tenant = getattr(req, "tenant", DEFAULT_TENANT)
        with self._lock:
            ent = self._entry(tenant)
            ent["requests"] += 1
            ent["tokens"] += len(req.generated)
            ent["finish_reasons"][req.finish_reason or "unknown"] += 1
            ent["kv_bytes_read"] += req.kv_bytes_read
            ent["kv_bytes_written"] += req.kv_bytes_written
            ent["weight_bytes_amortized"] += req.weight_bytes_amortized
            ent["device_time_s"] += req.device_time_s
            if self.policy is not None:
                tracker = self._slo.get(tenant)
                if tracker is None:
                    tracker = self._slo[tenant] = SLOTracker(
                        self.policy, clock=self.clock)
                tracker.observe(req)

    def on_throttle(self, tenant: str) -> None:
        """Count one per-tenant admission rejection (429)."""
        with self._lock:
            self._entry(tenant)["throttled"] += 1

    # -- admission-control read (engine tick thread) -------------------
    def cost_shares(
        self, live: Iterable[Any], *, use_bytes: bool = False,
    ) -> dict[str, float]:
        """Per-tenant accumulated cost — terminal totals plus the live
        requests' in-progress cost — the fairness sort key.  With
        telemetry attached (``use_bytes``) cost is device bytes + the
        amortized weight stream; otherwise processed tokens stand in
        (prefill progress + generated).  Raw sums, not normalized: the
        caller only orders by them."""
        with self._lock:
            if use_bytes:
                costs = {
                    t: e["kv_bytes_read"] + e["kv_bytes_written"]
                    + e["weight_bytes_amortized"]
                    for t, e in self._tenants.items()
                }
            else:
                costs = {
                    t: float(e["tokens"])
                    for t, e in self._tenants.items()
                }
        for req in live:
            tenant = getattr(req, "tenant", DEFAULT_TENANT)
            if use_bytes:
                cost = (req.kv_bytes_read + req.kv_bytes_written
                        + req.weight_bytes_amortized)
            else:
                cost = float(req.prefill_done + len(req.generated))
            costs[tenant] = costs.get(tenant, 0.0) + cost
        return costs

    # -- read (scrape / debug endpoints, any thread) -------------------
    def _cost(self, ent: dict[str, Any]) -> float:
        return (ent["kv_bytes_read"] + ent["kv_bytes_written"]
                + ent["weight_bytes_amortized"])

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time per-tenant view: counters, cost fields, cost
        share of the whole ledger, and the SLO snapshot when a policy
        is attached."""
        with self._lock:
            tenants = {
                t: dict(e, finish_reasons=dict(e["finish_reasons"]))
                for t, e in self._tenants.items()
            }
            slo = {t: tr.snapshot() for t, tr in self._slo.items()}
        total_cost = sum(self._cost(e) for e in tenants.values())
        total_tokens = sum(e["tokens"] for e in tenants.values())
        for t, ent in tenants.items():
            cost = self._cost(ent)
            # bytes when telemetry metered them, else token share — the
            # same fallback the fairness sort uses
            ent["cost_share"] = (
                cost / total_cost if total_cost > 0
                else ent["tokens"] / total_tokens if total_tokens > 0
                else 0.0
            )
            if t in slo:
                ent["slo"] = slo[t]
        return {
            "n_tenants": len(tenants),
            "tenants": tenants,
        }

    def slo_trackers(self) -> dict[str, SLOTracker]:
        """Per-tenant trackers (for fleet aggregation)."""
        with self._lock:
            return dict(self._slo)

    # -- Prometheus exposition -----------------------------------------
    def prometheus(self, prefix: str = "llm_serve",
                   const_labels: dict[str, str] | None = None) -> str:
        """Tenant-labeled series, cardinality-bounded: the top
        ``max_series`` tenants by accumulated cost keep their own
        labelsets; everything past that rolls up into
        ``tenant="other"`` (counters still conserve — the rollup sums,
        it never drops)."""
        snap = self.snapshot()["tenants"]
        ranked = sorted(
            snap.items(),
            key=lambda kv: (-self._cost(kv[1]), -kv[1]["tokens"], kv[0]),
        )
        keep = ranked[: self.max_series]
        overflow = ranked[self.max_series:]
        if overflow:
            other = _fresh_entry()
            for _, ent in overflow:
                for key in ("requests", "tokens", "kv_bytes_read",
                            "kv_bytes_written", "weight_bytes_amortized",
                            "device_time_s", "throttled"):
                    other[key] += ent[key]
            keep = keep + [(OTHER_TENANT, other)]

        extra = "".join(
            f',{k}="{v}"' for k, v in (const_labels or {}).items()
        )
        lines: list[str] = []

        def emit(name: str, mtype: str, help_: str,
                 samples: list[tuple[str, float]]) -> None:
            if not samples:
                return
            full = f"{prefix}_{name}"
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {mtype}")
            for tenant, value in samples:
                lines.append(
                    f'{full}{{tenant="{tenant}"{extra}}} {value:.10g}'
                )

        emit("tenant_requests_total", "counter",
             "Terminal requests per tenant",
             [(t, float(e["requests"])) for t, e in keep])
        emit("tenant_tokens_total", "counter",
             "Generated tokens per tenant",
             [(t, float(e["tokens"])) for t, e in keep])
        emit("tenant_device_bytes_total", "counter",
             "Attributed device bytes per tenant (KV read+write + "
             "amortized weight stream)",
             [(t, self._cost(e)) for t, e in keep])
        emit("tenant_device_time_total", "counter",
             "Attributed device seconds per tenant",
             [(t, e["device_time_s"]) for t, e in keep])
        throttled = [(t, float(e["throttled"]))
                     for t, e in keep if e["throttled"]]
        emit("tenant_throttled_total", "counter",
             "Admissions rejected by the per-tenant in-flight cap",
             throttled)
        if self.policy is not None:
            slo_keep = [(t, e["slo"]) for t, e in keep if "slo" in e]
            emit("tenant_slo_ok_total", "counter",
                 "SLO-attaining terminals per tenant",
                 [(t, float(s["slo_ok"])) for t, s in slo_keep])
            emit("tenant_slo_miss_total", "counter",
                 "SLO-missing terminals per tenant",
                 [(t, float(s["slo_miss"])) for t, s in slo_keep])
            emit("tenant_slo_attainment", "gauge",
                 "Fraction of timed terminals meeting the SLO, per "
                 "tenant",
                 [(t, s["slo_attainment"]) for t, s in slo_keep
                  if "slo_attainment" in s])
            emit("tenant_slo_goodput_tokens_total", "counter",
                 "Tokens of SLO-attaining requests per tenant",
                 [(t, float(s["goodput_tokens"])) for t, s in slo_keep])
            for label in ("5m", "1h"):
                key = f"slo_burn_rate_{label}"
                emit(f"tenant_{key}", "gauge",
                     f"Per-tenant SLO error-budget burn rate ({label} "
                     "window)",
                     [(t, s[key]) for t, s in slo_keep if key in s])
        return "\n".join(lines) + "\n" if lines else ""


def aggregate_tenants(
    ledgers: list["TenantLedger | None"],
) -> dict[str, Any]:
    """Fleet aggregation for ``ReplicaSet.snapshot`` and
    ``GET /debug/tenants``: per-tenant counters summed across replicas,
    SLO attainment/burn recomputed from the summed window totals via
    ``aggregate_slo`` (never a mean of per-replica ratios)."""
    live = [led for led in ledgers if led is not None]
    if not live:
        return {}
    merged: dict[str, dict[str, Any]] = {}
    trackers: dict[str, list[SLOTracker]] = {}
    for led in live:
        snap = led.snapshot()["tenants"]
        for tenant, ent in snap.items():
            agg = merged.get(tenant)
            if agg is None:
                agg = merged[tenant] = _fresh_entry()
                agg["finish_reasons"] = {}
            for key in ("requests", "tokens", "kv_bytes_read",
                        "kv_bytes_written", "weight_bytes_amortized",
                        "device_time_s", "throttled"):
                agg[key] += ent[key]
            for reason, n in ent["finish_reasons"].items():
                agg["finish_reasons"][reason] = (
                    agg["finish_reasons"].get(reason, 0) + n
                )
        for tenant, tracker in led.slo_trackers().items():
            trackers.setdefault(tenant, []).append(tracker)
    total_cost = sum(
        e["kv_bytes_read"] + e["kv_bytes_written"]
        + e["weight_bytes_amortized"] for e in merged.values()
    )
    total_tokens = sum(e["tokens"] for e in merged.values())
    for tenant, ent in merged.items():
        cost = (ent["kv_bytes_read"] + ent["kv_bytes_written"]
                + ent["weight_bytes_amortized"])
        ent["cost_share"] = (
            cost / total_cost if total_cost > 0
            else ent["tokens"] / total_tokens if total_tokens > 0
            else 0.0
        )
        per_tenant = trackers.get(tenant)
        if per_tenant:
            slo = aggregate_slo(list(per_tenant))
            slo.pop("policy", None)
            ent["slo"] = slo
    return {
        "n_tenants": len(merged),
        "tenants": merged,
    }

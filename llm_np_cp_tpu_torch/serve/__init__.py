"""Continuous-batching serving engine over a paged KV block pool (port of
``llm_np_cp_tpu/serve/``, its device paths and the host side they need).

Modules:
- ``block_pool``   — fixed-size KV blocks in one preallocated slab per
  layer, a refcounted free-list allocator, int8 scale pages.
- ``prefix_cache`` — refcounted prompt-prefix block sharing: chained
  content hashes → pool block ids (byte-identical keys to the JAX
  package's).
- ``scheduler``    — admission, the unified tick's token-budget planner,
  block growth and youngest-first preemption; pure Python/NumPy.
- ``metrics``      — TTFT, TPOT, queue depth, occupancy, prefix hit rate,
  the unified tick's prefill/decode token split.
- ``trace``        — Poisson request traces and the replay loop.
- ``spec``         — ``DraftState``: the host-side prompt-lookup draft
  stream of speculative serving.
- ``host_tier``    — ``HostTier``: the host-RAM KV block tier that LRU-
  reclaimed prefix blocks spill to and admissions restore from (pinned
  memory and a writer thread with its own stream on the card).
- ``engine``       — ``ServeEngine``: the unified ragged tick
  (``ragged_paged_attention``; with ``spec_k`` it verifies drafts in
  the same step) and the phase-split tick (chunked prefill, then a
  decode step over gathered views or ``paged_decode_attention``).
- ``http``         — the OpenAI-compatible streaming HTTP front end:
  ``EngineRunner`` (the engine's tick thread, which makes every CUDA
  call) and ``HttpServer`` (``/v1/completions`` unary and SSE, stream
  resume, ``/healthz``, ``/metrics``), ``run_server`` /
  ``serve_forever``, and the stdlib ``client``.  Imported on its own
  (``llm_np_cp_tpu_torch.serve.http``), as in the JAX package.
- ``tenants``      — ``normalize_tenant`` (the tenant-id validator the
  protocol uses), ``TenantLedger`` (per-tenant cost and SLO accounting,
  the in-flight cap, the fair-share prefill order) and
  ``aggregate_tenants``.
- ``tracing``      — ``TraceRecorder`` (request tracks and tick-phase
  spans as Chrome trace events, ``/debug/trace``) and the W3C
  ``traceparent`` helpers.
- ``slo``          — ``SLOPolicy`` / ``SLOTracker`` (goodput, attainment,
  burn rates), ``aggregate_slo`` and ``TickSentinel`` (per-phase tick
  anomalies).
- ``telemetry``    — ``TelemetryModel``: each tick's byte / FLOP bill
  against its dispatch → fetch wall (roofline utilization and MFU with
  the H100's constants) and per-request cost attribution.
- ``otel``         — ``OtlpExporter``: the trace plane shipped to an
  OTLP/HTTP JSON collector from a writer thread.
- ``faults``       — ``FaultInjector``: the seeded chaos schedule whose
  sites the engine, the HTTP runner, the journal and checkpoint loading
  trip; the runner's supervised restart rebuilds a dead engine
  (``ServeEngine.clone_fresh``) and replays its streams (``recover``).
- ``journal``      — ``RequestJournal``: the CRC-framed, fsync'd record of
  admissions, delivery watermarks and terminals that a restarted process
  replays (``scan_journal`` reads it).
- ``request_log``  — ``RequestLog``: one JSON line per terminal request
  (``read_request_log`` reads it).
- ``replica``      — the fleet: ``PrefixRouter`` (prefix-affinity routing),
  ``ReplicaSet`` (N engines from one loop) and ``ReplicaRunner`` (one
  supervised runner a replica under the HTTP server).
- ``lifecycle``    — rolling weight upgrades (``UpgradeAborted``,
  ``LifecycleController``), the ``Autoscaler`` and the ``ActionPolicy``
  auto-actions (shed prefill, shed load).

The command line over them is ``llm_np_cp_tpu_torch.cli`` (``serve-bench``,
``serve``).
"""

from llm_np_cp_tpu_torch.serve.block_pool import BlockPool, FreeList, PagedKV
from llm_np_cp_tpu_torch.serve.faults import FaultInjected, FaultInjector
from llm_np_cp_tpu_torch.serve.host_tier import HostBlock, HostTier, HostTierError
from llm_np_cp_tpu_torch.serve.engine import ServeEngine, pool_geometry, worst_case_slots
from llm_np_cp_tpu_torch.serve.journal import RequestJournal, scan_journal
from llm_np_cp_tpu_torch.serve.lifecycle import (
    ActionPolicy,
    Autoscaler,
    LifecycleController,
    UpgradeAborted,
)
from llm_np_cp_tpu_torch.serve.metrics import ServeMetrics
from llm_np_cp_tpu_torch.serve.otel import OtlpExporter
from llm_np_cp_tpu_torch.serve.prefix_cache import PrefixCache, prefix_block_keys
from llm_np_cp_tpu_torch.serve.replica import PrefixRouter, ReplicaRunner, ReplicaSet
from llm_np_cp_tpu_torch.serve.request_log import RequestLog, read_request_log
from llm_np_cp_tpu_torch.serve.scheduler import (
    QueueFull,
    Request,
    RequestState,
    Scheduler,
    TenantThrottled,
)
from llm_np_cp_tpu_torch.serve.slo import SLOPolicy, SLOTracker, TickSentinel, aggregate_slo
from llm_np_cp_tpu_torch.serve.spec import DraftState
from llm_np_cp_tpu_torch.serve.telemetry import TelemetryModel
from llm_np_cp_tpu_torch.serve.tenants import TenantLedger, aggregate_tenants, normalize_tenant
from llm_np_cp_tpu_torch.serve.trace import poisson_trace, replay_arrivals
from llm_np_cp_tpu_torch.serve.tracing import TraceRecorder

__all__ = [
    "ActionPolicy",
    "Autoscaler",
    "BlockPool",
    "DraftState",
    "FaultInjected",
    "FaultInjector",
    "FreeList",
    "HostBlock",
    "HostTier",
    "HostTierError",
    "LifecycleController",
    "OtlpExporter",
    "PagedKV",
    "PrefixCache",
    "PrefixRouter",
    "QueueFull",
    "ReplicaRunner",
    "ReplicaSet",
    "Request",
    "RequestJournal",
    "RequestLog",
    "RequestState",
    "SLOPolicy",
    "SLOTracker",
    "Scheduler",
    "ServeEngine",
    "ServeMetrics",
    "TelemetryModel",
    "TenantLedger",
    "TenantThrottled",
    "TickSentinel",
    "TraceRecorder",
    "UpgradeAborted",
    "aggregate_slo",
    "aggregate_tenants",
    "normalize_tenant",
    "poisson_trace",
    "pool_geometry",
    "prefix_block_keys",
    "read_request_log",
    "replay_arrivals",
    "scan_journal",
    "worst_case_slots",
]

"""Serving metrics (port of ``llm_np_cp_tpu/serve/metrics.py``, as far as
the engine records them).

Collected by ``ServeEngine`` per tick and per request, exported as one
flat dict (``snapshot()``):

- ``queue_depth_*``        — requests waiting (sampled per tick)
- ``ttft_s_*``             — arrival (realtime replay) or submit → first
                             emitted token, per request
- ``tpot_s_*``             — time per output token after the first
                             (time after the first token / tokens after
                             it), per request
- ``occupancy_*``          — fraction of allocatable blocks held
- ``active_slots_*``       — rows a tick's dispatch served
- ``preemptions``          — evict-on-OOM count (requeues)
- ``aborted`` / ``rejected`` — cancelled requests and queue-full rejects
- ``finish_reasons``       — terminal outcome counts by reason
- ``throughput_tok_s``     — total generated tokens / wall span
- ``prefix_hit_rate``      — prompt blocks reused from the prefix cache
                             / shareable prompt blocks requested
- ``mixed_prefill_tokens`` / ``mixed_decode_tokens`` — how the unified
                             tick's token budget was spent
- ``queue_wait_s_*`` / ``prefill_s_*`` — per-request phase splits
- ``spec_drafted_tokens`` / ``spec_accepted_tokens`` /
  ``spec_rejected_tokens`` / ``spec_rounds`` / ``spec_accept_rate`` /
  ``spec_accept_len_mean`` — speculative verify rounds, present only
  once a round ran.
- ``prefix_evicted_blocks`` / ``prefix_evicted_bytes`` — prefix-cache
  entries LRU reclaim dropped (always present).
- ``tier_spilled_*`` / ``tier_restored_*`` / ``tier_resident_bytes`` /
  ``tier_breakeven_ratio`` / ``tier_restore_s_*`` — the host-RAM KV
  tier's flow (``serve/host_tier.py``), present only once a tier is
  attached.

Percentiles are p50/p90/p99 over every sample (no windowing).  Left out
with the layers that use them: the operator text block and the
Prometheus format with its histograms (CLI, HTTP front end; the
speculative accept-length histogram and the tier's series with it), SLO
and roofline series.  Every record hook and
``snapshot()`` take one lock, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any

import numpy as np

from llm_np_cp_tpu_torch.serve.scheduler import Request


def _pcts(values: list[float], name: str) -> dict[str, float]:
    if not values:
        return {}
    arr = np.asarray(values, dtype=np.float64)
    return {
        f"{name}_p50": float(np.percentile(arr, 50)),
        f"{name}_p90": float(np.percentile(arr, 90)),
        f"{name}_p99": float(np.percentile(arr, 99)),
        f"{name}_mean": float(arr.mean()),
    }


class ServeMetrics:
    def __init__(self, clock=time.perf_counter) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self.t_start = clock()
        self.t_last: float | None = None
        self.n_submitted = 0
        self.n_finished = 0
        self.n_aborted = 0
        self.n_rejected = 0
        self.n_ticks = 0
        self.preemptions = 0
        self.total_generated = 0
        self.finish_reasons: Counter[str] = Counter()
        self.ttft_s: list[float] = []
        self.tpot_s: list[float] = []
        self.queue_wait_s: list[float] = []
        self.prefill_s: list[float] = []
        self.queue_depth: list[int] = []
        self.occupancy: list[float] = []
        self.active_slots: list[int] = []
        self.prefix_blocks_requested = 0
        self.prefix_blocks_hit = 0
        self.mixed_prefill_tokens = 0
        self.mixed_decode_tokens = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        # LRU prefix reclaim, and the host-RAM KV tier's flow (spills,
        # restores, restore latencies, the live gauges)
        self.prefix_evicted_blocks = 0
        self.prefix_evicted_bytes = 0.0
        self.tier_spilled_blocks = 0
        self.tier_spilled_bytes = 0.0
        self.tier_restored_blocks = 0
        self.tier_restored_bytes = 0.0
        self.tier_restore_s: list[float] = []
        self.tier_resident_bytes = 0.0
        self.tier_breakeven: float | None = None

    # -- record hooks (engine calls these) -----------------------------
    def on_submit(self, req: Request) -> None:
        with self._lock:
            if self.n_submitted == 0:
                # wall span starts at first traffic, not engine build
                self.t_start = self.clock()
            self.n_submitted += 1

    def on_reject(self) -> None:
        """A submit bounced off the queue-depth cap."""
        with self._lock:
            self.n_rejected += 1

    def on_tick(
        self, *, queue_depth: int, occupancy: float, active_slots: int,
        preemptions_total: int, prefill_tokens: int = 0, decode_tokens: int = 0,
    ) -> None:
        with self._lock:
            self.mixed_prefill_tokens += prefill_tokens
            self.mixed_decode_tokens += decode_tokens
            self.n_ticks += 1
            self.t_last = self.clock()
            self.queue_depth.append(queue_depth)
            self.occupancy.append(occupancy)
            self.active_slots.append(active_slots)
            self.preemptions = preemptions_total

    def on_prefix(self, *, requested: int, hits: int) -> None:
        """One prefill's prefix-cache outcome: ``requested`` shareable
        prompt blocks were looked up, ``hits`` were reused."""
        with self._lock:
            self.prefix_blocks_requested += requested
            self.prefix_blocks_hit += hits

    def on_prefix_evicted(self, *, blocks: int, nbytes: int) -> None:
        """LRU reclaim dropped ``blocks`` prefix-cache entries (their K/V
        bytes included) — with the host tier attached the same blocks
        also count as spills."""
        with self._lock:
            self.prefix_evicted_blocks += blocks
            self.prefix_evicted_bytes += nbytes

    def on_tier_spill(self, *, blocks: int, nbytes: int) -> None:
        """``blocks`` evicted prefix blocks were handed to the host tier's
        writer thread instead of being dropped."""
        with self._lock:
            self.tier_spilled_blocks += blocks
            self.tier_spilled_bytes += nbytes

    def on_tier_restore(self, *, blocks: int, nbytes: int, latency_s: float) -> None:
        """One admission's host-tier span landed back in the pool:
        ``blocks`` restored (``nbytes`` of K/V that did not re-prefill)
        after ``latency_s`` of writer-thread staging."""
        with self._lock:
            self.tier_restored_blocks += blocks
            self.tier_restored_bytes += nbytes
            self.tier_restore_s.append(latency_s)

    def on_tier_gauge(self, *, resident_bytes: int, breakeven: float | None) -> None:
        """Refresh the tier's live gauges: host bytes resident and the
        measured restore-vs-recompute breakeven ratio (>1 = restoring one
        block is cheaper than re-prefilling it; None until both sides are
        measured)."""
        with self._lock:
            self.tier_resident_bytes = float(resident_bytes)
            self.tier_breakeven = breakeven

    def on_spec(self, *, drafted: int, accepted: int) -> None:
        """One speculative verify round for one request: ``drafted``
        candidate tokens rode the tick's step, ``accepted`` of them
        matched the verifier's samples."""
        with self._lock:
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            self.spec_rounds += 1

    def on_token(self, req: Request) -> None:
        with self._lock:
            self.total_generated += 1

    def on_finish(self, req: Request) -> None:
        with self._lock:
            self.n_finished += 1
            self.finish_reasons[req.finish_reason or "length"] += 1
            self._record_latencies(req)

    def on_abort(self, req: Request) -> None:
        """Request cancelled.  Counted apart from ``finished`` — its TTFT
        still records if a token got out."""
        with self._lock:
            self.n_aborted += 1
            self.finish_reasons["aborted"] += 1
            self._record_latencies(req)

    def _record_latencies(self, req: Request) -> None:
        # caller holds the lock
        if req.submit_time is not None and req.first_token_time is not None:
            # realtime replay records the wall arrival, so TTFT includes
            # the wait before the tick loop noticed the request
            base = req.extra.get("arrival_wall", req.submit_time)
            self.ttft_s.append(req.first_token_time - base)
            n_after_first = len(req.generated) - 1
            span = (req.finish_time or self.clock()) - req.first_token_time
            if n_after_first > 0 and span > 0:
                self.tpot_s.append(span / n_after_first)
        if req.submit_time is not None and req.admit_time is not None:
            self.queue_wait_s.append(req.admit_time - req.submit_time)
        if req.prefill_s:
            self.prefill_s.append(req.prefill_s)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            span = (self.t_last or self.clock()) - self.t_start
            out: dict[str, Any] = {
                "submitted": self.n_submitted,
                "finished": self.n_finished,
                "aborted": self.n_aborted,
                "rejected": self.n_rejected,
                "ticks": self.n_ticks,
                "preemptions": self.preemptions,
                "total_generated_tokens": self.total_generated,
                "throughput_tok_s": self.total_generated / span if span > 0 else 0.0,
                "wall_s": span,
                "finish_reasons": dict(self.finish_reasons),
                "mixed_prefill_tokens": self.mixed_prefill_tokens,
                "mixed_decode_tokens": self.mixed_decode_tokens,
                "prefix_blocks_requested": self.prefix_blocks_requested,
                "prefix_blocks_hit": self.prefix_blocks_hit,
                "prefix_evicted_blocks": self.prefix_evicted_blocks,
                "prefix_evicted_bytes": self.prefix_evicted_bytes,
            }
            if (self.tier_spilled_blocks or self.tier_restored_blocks
                    or self.tier_breakeven is not None):
                # only once a tier is attached or active: zeros would
                # read as a wedged tier
                out["tier_spilled_blocks"] = self.tier_spilled_blocks
                out["tier_spilled_bytes"] = self.tier_spilled_bytes
                out["tier_restored_blocks"] = self.tier_restored_blocks
                out["tier_restored_bytes"] = self.tier_restored_bytes
                out["tier_resident_bytes"] = self.tier_resident_bytes
                out["tier_breakeven_ratio"] = self.tier_breakeven or 0.0
            if self.spec_rounds:
                # only once a verify round ran: a 0-acceptance series on
                # an engine that never speculated would read as broken
                out["spec_drafted_tokens"] = self.spec_drafted
                out["spec_accepted_tokens"] = self.spec_accepted
                out["spec_rejected_tokens"] = self.spec_drafted - self.spec_accepted
                out["spec_rounds"] = self.spec_rounds
                out["spec_accept_rate"] = (
                    self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0)
                out["spec_accept_len_mean"] = self.spec_accepted / self.spec_rounds
            # copy-on-read: percentile math sees frozen lists
            series = {
                "ttft_s": list(self.ttft_s),
                "tpot_s": list(self.tpot_s),
                "queue_wait_s": list(self.queue_wait_s),
                "prefill_s": list(self.prefill_s),
                "queue_depth": [float(q) for q in self.queue_depth],
                "occupancy": list(self.occupancy),
                "active_slots": [float(a) for a in self.active_slots],
                "tier_restore_s": list(self.tier_restore_s),
            }
        for name, values in series.items():
            out.update(_pcts(values, name))
        if out["prefix_blocks_requested"]:
            out["prefix_hit_rate"] = out["prefix_blocks_hit"] / out["prefix_blocks_requested"]
        return out

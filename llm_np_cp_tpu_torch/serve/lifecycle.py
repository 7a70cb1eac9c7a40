"""Fleet lifecycle: rolling weight swaps, elastic replicas, auto-actions
(port of ``llm_np_cp_tpu/serve/lifecycle.py``; plain Python, no tensor).

The orchestration over primitives the engine and the runner already
have — teacher-forced ``recover``, drain-to-peer, ``clone_fresh``, the
router's re-home, SLO burn rates and the tick sentinel:

- **Rolling checkpoint upgrade** (``ReplicaSet.rolling_upgrade`` /
  ``ReplicaRunner.rolling_upgrade`` in ``serve/replica.py``, the HTTP
  surface at ``POST /admin/upgrade``): drain one replica at a time to its
  peers, rebuild it on fresh weights with ``clone_fresh(params=...)``,
  and tag every request with the weight version it was admitted under —
  journal admissions and request-log lines carry ``weights_version``, so
  a stream that survives a mid-roll drain still reports one version end
  to end.  On the card a rebuilt replica captures the CUDA graphs of
  every bucket its source had captured before it rejoins routing (a
  graph replays its own engine's addresses; nothing is shared).
- **Elastic data parallelism** (``ReplicaSet.add_replica`` /
  ``remove_replica``): grow the fleet with a warmed clone that the router
  routes to first-sight, shrink it with a SIGTERM-style drain to peers.
  The optional ``Autoscaler`` here drives both from queue depth and the
  5m SLO burn rate.
- **Sentinel auto-actions** (``ActionPolicy``): a persistent
  ``host_sync`` regression named by the ``TickSentinel`` sheds prefill
  budget in ``plan_tick``; an SLO error-budget burn past threshold flips
  admission to 503-first load shedding with a burn-scaled
  ``Retry-After``.  Both release when the signal clears, are
  rate-limited, and are counted
  (``llm_serve_lifecycle_actions_total{action=}``) and traced
  (``lifecycle-action`` instants).

Threading: ``ActionPolicy`` is fed from the engine's tick thread
(``ServeEngine._actions_tick``) and read by the HTTP event loop (the 503
check, the scrape), so its verdict state and counters share one lock.
``LifecycleController``'s roll state is mutated only by its own methods.
``ServeEngine.actions`` is ``None`` unless a policy is given, and every
hook on it is one ``is None`` check.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable

from llm_np_cp_tpu_torch.serve.slo import aggregate_slo


class UpgradeAborted(RuntimeError):
    """A rolling upgrade stopped mid-roll (checkpoint read failed, or a
    loader raised).  The roll aborts CLEANLY: the replica being rolled
    was not yet drained, so it stays live on its old weights and the
    fleet never drops below N-1 capacity.  ``rolled`` names the
    replicas that already completed their swap (they stay on the new
    weights — a half-rolled fleet is mixed-version but fully serving,
    and the version tag on every request says which weights served
    it)."""

    def __init__(self, reason: str, *, rolled: list[int] | None = None,
                 version: int | None = None) -> None:
        super().__init__(reason)
        self.rolled = list(rolled or ())
        self.version = version


def load_upgrade_params(params_fn: Callable[[], Any], *, replica: int,
                        faults: Any = None, metrics: Any = None,
                        rolled: Any = (),
                        version: int | None = None) -> Any:
    """One replica's checkpoint read for a rolling upgrade: trip the
    ``upgrade_ckpt`` chaos site, then call the loader, converting any
    failure into a clean ``UpgradeAborted`` (the replica being rolled
    was not yet drained — it stays live on its old weights).  The ONE
    abort preamble shared by ReplicaSet/ReplicaRunner/EngineRunner
    rolls, so abort semantics cannot drift between them."""
    if faults is not None and faults.trip("upgrade_ckpt") is not None:
        if metrics is not None:
            metrics.on_lifecycle_action("upgrade_aborted")
        raise UpgradeAborted(
            f"chaos: injected checkpoint read failure rolling replica "
            f"{replica}", rolled=list(rolled), version=version,
        )
    try:
        return params_fn()
    except Exception as e:  # noqa: BLE001 — abort cleanly, stay serving
        if metrics is not None:
            metrics.on_lifecycle_action("upgrade_aborted")
        raise UpgradeAborted(
            f"checkpoint load failed rolling replica {replica}: {e}",
            rolled=list(rolled), version=version,
        ) from e


def cache_params_fn(params_fn: Callable[[], Any]) -> Callable[[], Any]:
    """Load the checkpoint ONCE per roll, not once per replica: the
    in-process replicas share one host, so an N-replica roll must not
    pay N full checkpoint reads for the same weights.  (The per-replica
    ``upgrade_ckpt`` chaos trip in ``load_upgrade_params`` is
    independent of this cache, so mid-roll read-failure drills still
    abort at the replica they target.)"""
    loaded: list = []

    def once() -> Any:
        if not loaded:
            loaded.append(params_fn())
        return loaded[0]

    return once


class ActionPolicy:
    """Closed-loop auto-actions from the sentinel/SLO signal plane.

    Two independent reversible actions, both rate-limited by
    ``min_flip_interval_s`` per action:

    - ``shed_prefill`` — engaged after ``engage_streak`` ticks where
      the tick sentinel named ``anomaly_phase`` (default ``host_sync``)
      an outlier within the current run of anomalous ticks; released
      after ``release_clean`` consecutive anomaly-free ticks.  While
      engaged, ``plan_budget`` shrinks the unified tick's prefill slack
      by ``shed_frac`` (decode rows are NEVER shed — the floor is
      ``max_slots``), trading admission latency for tick cadence while
      the host is struggling.
    - ``shed_load`` — engaged when the SLO error-budget burn rate over
      ``burn_window`` exceeds ``burn_threshold``; released once burn
      falls under ``burn_threshold * burn_clear_frac`` (hysteresis, so
      a burn hovering at the threshold does not flap).  While engaged
      the HTTP front-end answers NEW completions 503-first with
      ``Retry-After`` scaled from the burn (``retry_after()``), the
      standard load-shedding move: shed early at admission rather than
      miss every in-flight deadline.

    Engine-thread hook: ``on_tick(outliers, slo_tracker)`` once per
    tick (``ServeEngine._actions_tick``); returns the action flips this
    tick for the caller to count + trace.  Cross-thread reads
    (``shedding``/``retry_after``/``snapshot``) take the same lock.
    """

    def __init__(
        self,
        *,
        burn_threshold: float = 2.0,
        burn_window: str = "5m",
        burn_clear_frac: float = 0.5,
        anomaly_phase: str = "host_sync",
        engage_streak: int = 4,
        release_clean: int = 64,
        shed_frac: float = 0.5,
        min_flip_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}"
            )
        if not (0.0 < burn_clear_frac <= 1.0):
            raise ValueError(
                f"burn_clear_frac must be in (0, 1], got {burn_clear_frac}"
            )
        if engage_streak < 1 or release_clean < 1:
            raise ValueError(
                f"engage_streak/release_clean must be >= 1, got "
                f"{engage_streak}/{release_clean}"
            )
        if not (0.0 < shed_frac <= 1.0):
            raise ValueError(
                f"shed_frac must be in (0, 1], got {shed_frac}"
            )
        self.burn_threshold = burn_threshold
        self.burn_window = burn_window
        self.burn_clear_frac = burn_clear_frac
        self.anomaly_phase = anomaly_phase
        self.engage_streak = engage_streak
        self.release_clean = release_clean
        self.shed_frac = shed_frac
        self.min_flip_interval_s = min_flip_interval_s
        self.clock = clock
        self._lock = threading.Lock()
        # verdict state + counters (one lock): the
        # engine tick thread writes, the HTTP loop reads
        self.shed_prefill = False
        self.shed_load = False
        self.retry_after_s = 1.0
        self.last_burn = 0.0
        self.actions_total: Counter[str] = Counter()
        self._anom_streak = 0
        self._clean_ticks = 0
        self._last_flip: dict[str, float] = {}

    def spawn(self) -> "ActionPolicy":
        """A fresh policy with the same thresholds — what a NEW elastic
        replica gets (verdict state is per-engine, never shared across
        tick threads)."""
        return ActionPolicy(
            burn_threshold=self.burn_threshold,
            burn_window=self.burn_window,
            burn_clear_frac=self.burn_clear_frac,
            anomaly_phase=self.anomaly_phase,
            engage_streak=self.engage_streak,
            release_clean=self.release_clean,
            shed_frac=self.shed_frac,
            min_flip_interval_s=self.min_flip_interval_s,
            clock=self.clock,
        )

    # -- engine-thread hook --------------------------------------------
    def _can_flip(self, action: str, now: float) -> bool:
        # caller holds the lock.  Rate limit per action: a noisy signal
        # at the threshold cannot flap the action faster than
        # min_flip_interval_s
        last = self._last_flip.get(action)
        return last is None or now - last >= self.min_flip_interval_s

    def on_tick(self, outliers: list[dict], slo: Any) -> list[str]:
        """Fold one tick's signals in; returns the action flips (e.g.
        ``["shed_prefill_on"]``) for the engine to count + trace."""
        now = self.clock()
        anom = any(o.get("phase") == self.anomaly_phase for o in outliers)
        burn = (
            slo.burn_rate(self.burn_window) if slo is not None else 0.0
        )
        flipped: list[str] = []
        with self._lock:
            self.last_burn = burn
            if anom:
                self._anom_streak += 1
                self._clean_ticks = 0
            else:
                self._clean_ticks += 1
                if self._clean_ticks >= self.release_clean:
                    self._anom_streak = 0
            if (
                not self.shed_prefill
                and self._anom_streak >= self.engage_streak
                and self._can_flip("shed_prefill", now)
            ):
                self.shed_prefill = True
                self._last_flip["shed_prefill"] = now
                self.actions_total["shed_prefill_on"] += 1
                flipped.append("shed_prefill_on")
            elif (
                self.shed_prefill
                and self._clean_ticks >= self.release_clean
                and self._can_flip("shed_prefill", now)
            ):
                self.shed_prefill = False
                self._last_flip["shed_prefill"] = now
                self.actions_total["shed_prefill_off"] += 1
                flipped.append("shed_prefill_off")
            if (
                not self.shed_load
                and burn > self.burn_threshold
                and self._can_flip("shed_load", now)
            ):
                self.shed_load = True
                self._last_flip["shed_load"] = now
                self.actions_total["shed_load_on"] += 1
                flipped.append("shed_load_on")
            elif (
                self.shed_load
                and burn <= self.burn_threshold * self.burn_clear_frac
                and self._can_flip("shed_load", now)
            ):
                self.shed_load = False
                self._last_flip["shed_load"] = now
                self.actions_total["shed_load_off"] += 1
                flipped.append("shed_load_off")
            if self.shed_load:
                # Retry-After from the burn magnitude: the hotter the
                # burn, the longer clients should back off (bounded —
                # a 503 storm must stay retryable)
                self.retry_after_s = float(
                    min(30, max(1, round(burn / self.burn_threshold)))
                )
        return flipped

    def plan_budget(self, budget: int, floor: int) -> int:
        """The shed-prefill verdict applied to the unified tick's token
        budget: decode rows (``floor`` = max_slots) are never shed —
        only the prefill slack above them shrinks by ``shed_frac``."""
        with self._lock:
            if not self.shed_prefill:
                return budget
        return max(
            floor, floor + int((budget - floor) * (1.0 - self.shed_frac))
        )

    # -- cross-thread reads --------------------------------------------
    @property
    def shedding(self) -> bool:
        with self._lock:
            return self.shed_load

    def retry_after(self) -> float:
        with self._lock:
            return self.retry_after_s

    def state_args(self) -> dict[str, Any]:
        """Trace-instant args: the verdict state at a flip."""
        with self._lock:
            return {
                "shed_prefill": self.shed_prefill,
                "shed_load": self.shed_load,
                "burn": round(self.last_burn, 3),
                "retry_after_s": self.retry_after_s,
            }

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "shed_prefill": self.shed_prefill,
                "shed_load": self.shed_load,
                "burn": round(self.last_burn, 4),
                "retry_after_s": self.retry_after_s,
                "actions_total": dict(self.actions_total),
            }


class Autoscaler:
    """Elastic-DP policy: queue depth + burn rate → replica count.

    Pure verdicts (no fleet mutation — ``LifecycleController`` applies
    them): ``verdict()`` returns +1 (add a replica), -1 (drain one
    away), or 0, with a ``cooldown_s`` gap between verdicts so a scale
    action's effect is observed before the next one fires.  Scale-up
    triggers on EITHER signal (deep queues mean latency is already
    lost; a hot burn means the SLO is already missing); scale-down
    needs BOTH quiet (shallow queues AND burn well under the scale-up
    threshold) — growing is cheap, shrinking under pressure is not.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        scale_up_queue_depth: float = 4.0,
        scale_up_burn: float = 2.0,
        scale_down_queue_depth: float = 0.5,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}"
            )
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_queue_depth = scale_up_queue_depth
        self.scale_up_burn = scale_up_burn
        self.scale_down_queue_depth = scale_down_queue_depth
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._last_verdict_t: float | None = None

    def verdict(self, *, n_replicas: int, queue_depth_per_replica: float,
                burn_5m: float = 0.0) -> int:
        now = self.clock()
        if (
            self._last_verdict_t is not None
            and now - self._last_verdict_t < self.cooldown_s
        ):
            return 0
        if n_replicas < self.max_replicas and (
            queue_depth_per_replica >= self.scale_up_queue_depth
            or burn_5m > self.scale_up_burn
        ):
            self._last_verdict_t = now
            return 1
        if (
            n_replicas > self.min_replicas
            and queue_depth_per_replica <= self.scale_down_queue_depth
            and burn_5m < 0.5 * self.scale_up_burn
        ):
            self._last_verdict_t = now
            return -1
        return 0


class LifecycleController:
    """Direct-mode lifecycle driver over a ``ReplicaSet``: serializes
    rolling upgrades (one roll at a time — two concurrent rolls would
    drain the same peers out from under each other) and applies the
    ``Autoscaler``'s verdicts.  The HTTP fleet's equivalent lives in
    ``HttpServer`` (``POST /admin/upgrade`` / ``POST /admin/scale``),
    which serializes through its own lock.

    ``_roll_active``/``_roll_history`` are mutated only by controller
    methods.
    """

    def __init__(self, fleet: Any, *, autoscaler: Autoscaler | None = None,
                 ) -> None:
        self.fleet = fleet
        self.autoscaler = autoscaler
        self._roll_active = False
        self._roll_history: list[dict[str, Any]] = []

    @property
    def roll_active(self) -> bool:
        return self._roll_active

    @property
    def roll_history(self) -> list[dict[str, Any]]:
        return list(self._roll_history)

    def rolling_upgrade(self, params_fn: Callable[[], Any], *,
                        version: int | None = None,
                        steps_between: int = 1) -> dict[str, Any]:
        if self._roll_active:
            raise RuntimeError("a rolling upgrade is already in progress")
        self._roll_active = True
        try:
            out = self.fleet.rolling_upgrade(
                params_fn, version=version, steps_between=steps_between,
            )
            self._roll_history.append(out)
            return out
        finally:
            self._roll_active = False

    def autoscale_tick(self) -> int:
        """Evaluate the autoscaler against the fleet's live signals and
        apply its verdict.  Returns the verdict (+1/-1/0).  Call it
        from whatever cadence drives the fleet (the bench/test loop, or
        an operator cron) — it is cheap enough for every tick."""
        if self.autoscaler is None:
            return 0
        fleet = self.fleet
        alive = [i for i, a in enumerate(fleet.alive) if a]
        if not alive:
            return 0
        depth = sum(
            fleet.engines[i].scheduler.queue_depth for i in alive
        ) / len(alive)
        agg = aggregate_slo([
            getattr(fleet.engines[i].metrics, "slo", None) for i in alive
        ])
        burn = float(agg.get("slo_burn_rate_5m", 0.0))
        v = self.autoscaler.verdict(
            n_replicas=len(alive), queue_depth_per_replica=depth,
            burn_5m=burn,
        )
        if v > 0:
            self.fleet.add_replica()
        elif v < 0:
            # drain the least-loaded live replica — fewest streams to
            # move to peers
            idx = min(alive, key=lambda i: len(fleet.engines[i]._requests))
            self.fleet.remove_replica(idx)
        return v

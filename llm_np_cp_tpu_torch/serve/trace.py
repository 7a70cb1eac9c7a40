"""Synthetic request traces for the serving engine (port of
``llm_np_cp_tpu/serve/trace.py``).

A serving benchmark needs arrivals, not a batch: the load pattern that
exposes queueing, admission control, and preemption is requests landing
at random times with mixed prompt lengths.  The standard open-loop model
is a Poisson process (exponential inter-arrival gaps at a target
request rate).  ``poisson_trace`` draws exactly the JAX package's
sequence for a seed, so both engines replay the same trace.

Prompts are random token ids: serving throughput is content-independent
(decode cost depends on shapes only), and synthetic ids avoid needing a
tokenizer in CPU tests and bench children.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np


def replay_arrivals(
    target: Any,
    trace: list[dict[str, Any]],
    snapshot: Callable[[], dict[str, Any]],
    *,
    realtime: bool = False,
    max_ticks: int = 100_000,
    on_tick: Callable[[int], None] | None = None,
) -> dict[str, Any]:
    """The arrival-replay loop behind ``ServeEngine.replay_trace`` and
    ``ReplicaSet.replay_trace``.

    ``target`` provides ``clock``/``submit``/``step``; ``snapshot``
    renders the final metrics.  realtime=False (default, what tests and
    bench use on CPU): arrivals are released by a virtual clock that
    advances to the next arrival whenever the target is idle — the
    schedule stress is preserved without wall-clock sleeps.
    realtime=True sleeps until each arrival (live serving simulation).
    ``on_tick(i)`` (optional) runs after the i-th ``step()``: the hook a
    mid-trace rolling upgrade rides.
    """
    pending = sorted(trace, key=lambda t: t["arrival_s"])
    t0 = target.clock()
    virtual_now = 0.0
    for tick_i in range(max_ticks):
        now = target.clock() - t0 if realtime else virtual_now
        while pending and pending[0]["arrival_s"] <= now:
            item = pending.pop(0)
            req = target.submit(
                item["prompt"], item["max_new_tokens"],
                seed=item.get("seed", 0),
                callback=item.get("callback"),
                arrival_time=item["arrival_s"],
                speculative=item.get("speculative", False),
            )
            if realtime:
                # wall arrival: TTFT then counts the wait between
                # arrival and the tick loop noticing the request
                req.extra["arrival_wall"] = t0 + item["arrival_s"]
        had_work = target.step()
        if on_tick is not None:
            on_tick(tick_i)
            had_work = had_work or target.step()  # a roll may move work
        if not had_work and pending:
            nxt = pending[0]["arrival_s"]
            if realtime:
                time.sleep(max(0.0, nxt - (target.clock() - t0)))
            else:
                virtual_now = nxt
        elif not had_work and not pending:
            return snapshot()
        if not realtime:
            virtual_now = max(virtual_now, target.clock() - t0)
    raise RuntimeError(
        f"trace replay did not drain within {max_ticks} ticks"
    )


def poisson_trace(
    rng: np.random.Generator,
    n_requests: int,
    *,
    rate_rps: float,
    prompt_len_range: tuple[int, int],
    max_new_tokens: int | tuple[int, int],
    vocab_size: int,
    seed_base: int = 0,
    distinct_prompts: int | None = None,
) -> list[dict[str, Any]]:
    """``n_requests`` arrivals for ``ServeEngine.replay_trace``.

    rate_rps: mean arrival rate (requests/second); gaps are exponential.
    prompt_len_range / max_new_tokens: inclusive ranges sampled uniformly
    (an int ``max_new_tokens`` pins every request to that budget, which
    the engine-vs-offline parity tests need).
    distinct_prompts: if set, only this many distinct prompts are
    generated and requests cycle through them — the shared-prefix
    workload shape (many users asking the same things) that the
    refcounted prefix cache is built for.
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    lo, hi = prompt_len_range
    if not (1 <= lo <= hi):
        raise ValueError(f"bad prompt_len_range {prompt_len_range}")
    if distinct_prompts is not None and distinct_prompts < 1:
        raise ValueError(f"distinct_prompts must be >= 1, got {distinct_prompts}")
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_requests))

    def draw_mnt() -> int:
        if isinstance(max_new_tokens, tuple):
            mlo, mhi = max_new_tokens
            return int(rng.integers(mlo, mhi + 1))
        return int(max_new_tokens)

    def make_prompt() -> np.ndarray:
        plen = int(rng.integers(lo, hi + 1))
        return (
            rng.integers(1, vocab_size, size=plen, dtype=np.int64)
            .astype(np.int32)
        )

    pool = (
        [make_prompt() for _ in range(distinct_prompts)]
        if distinct_prompts is not None else None
    )
    trace: list[dict[str, Any]] = []
    for i in range(n_requests):
        if pool is not None:
            prompt = pool[i % len(pool)]
            mnt = draw_mnt()
        else:
            # draw order (plen, mnt, tokens) is the historical sequence —
            # a fixed seed must keep replaying the exact same trace
            # across versions
            plen = int(rng.integers(lo, hi + 1))
            mnt = draw_mnt()
            prompt = (
                rng.integers(1, vocab_size, size=plen, dtype=np.int64)
                .astype(np.int32)
            )
        trace.append({
            "arrival_s": float(arrivals[i]),
            "prompt": prompt,
            "max_new_tokens": mnt,
            "seed": seed_base + i,
        })
    return trace

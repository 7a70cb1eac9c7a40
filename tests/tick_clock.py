"""A deterministic engine clock for trace replays.

``replay_arrivals`` (``serve/trace.py`` in both packages) pulls its
virtual clock up to the engine's clock after every tick.  On
``time.perf_counter`` a slow tick (a test worker beside others on a
loaded host) therefore releases more arrivals at once, and two engines
replaying one trace get different schedules: their tokens agree, but
tick counts and the metrics that depend on the schedule do not.
``TickClock`` reads the watched engines' tick count instead (``DT``
seconds a tick), so arrivals are released by the trace alone.
"""

DT = 0.005


class TickClock:
    """``clock()`` = the most ticks any watched engine has run, times
    ``dt``.  Build an engine with ``clock=TickClock()`` and ``watch`` it
    (a fleet: watch every replica, share one clock)."""

    def __init__(self, dt: float = DT) -> None:
        self.dt = dt
        self.engines: list = []

    def watch(self, *engines) -> None:
        self.engines.extend(engines)

    def __call__(self) -> float:
        return max((e.metrics.n_ticks for e in self.engines), default=0) * self.dt


def clocked(build, *args, **kw):
    """``build(*args, clock=TickClock(), **kw)``, watched by its clock."""
    clk = TickClock()
    eng = build(*args, clock=clk, **kw)
    clk.watch(eng)
    return eng

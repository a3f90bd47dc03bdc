"""Metrics registry: counters / gauges / histograms / timers with one
``snapshot()`` read API (DESIGN.md §18.3), copied from the reference's
``repro/obs/metrics.py``. It gives the live coordinator a place to count
recovery work (detections, recoveries, restarts, executed microbatches,
step walls) that benchmarks and tests can read without reaching into
internals; :func:`instrument_drain` times a simulation's calendar-lane
drain.
"""
from __future__ import annotations

import time
from typing import Dict, Optional


class Counter:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def inc(self, by: int = 1) -> None:
        self.n += by


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming count/sum/min/max — enough for the benchmark tables
    without keeping samples around."""

    __slots__ = ("n", "total", "min", "max")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class Timer:
    """Wall-clock accumulator. Use as a context manager or wrap callables
    with :meth:`wrap`."""

    __slots__ = ("s", "n", "_t0")

    def __init__(self):
        self.s = 0.0
        self.n = 0
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.s += time.perf_counter() - self._t0
        self.n += 1

    def wrap(self, fn):
        if fn is None:
            return None

        def timed(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.s += time.perf_counter() - t0
                self.n += 1
        return timed


class MetricsRegistry:
    """Named instrument registry; ``snapshot()`` flattens everything into
    one ``{name: number}`` dict (histograms/timers expand to ``_n`` /
    ``_s`` / ``_mean`` ... suffixed keys)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._timers: Dict[str, Timer] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._hists.setdefault(name, Histogram())

    def timer(self, name: str) -> Timer:
        return self._timers.setdefault(name, Timer())

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, c in self._counters.items():
            out[k] = c.n
        for k, g in self._gauges.items():
            out[k] = g.value
        for k, h in self._hists.items():
            out[f"{k}_n"] = h.n
            out[f"{k}_sum"] = h.total
            out[f"{k}_mean"] = h.mean()
            if h.n:
                out[f"{k}_min"] = h.min
                out[f"{k}_max"] = h.max
        for k, t in self._timers.items():
            out[f"{k}_s"] = t.s
            out[f"{k}_n"] = t.n
        return out


def instrument_drain(sim, registry: Optional[MetricsRegistry] = None,
                     *, name: str = "drain") -> MetricsRegistry:
    """Wrap the calendar lane's drain path — the fused/generic loop plus
    its ``on_begin``/``on_end`` brackets (the ε-fair recompute/rebuild
    lives in the brackets, so they are part of the drain's cost) — with a
    registry timer; read the cost back as
    ``registry.snapshot()["<name>_s"]``. Call after the simulation is
    fully constructed: engine wiring installs the brackets at
    ``Simulation.__init__`` time. Rescan/event substrates
    have no calendar lane; no timer is registered then."""
    reg = registry if registry is not None else MetricsRegistry()
    q = getattr(sim.shuffle, "batches", None)
    if q is None:
        return reg
    t = reg.timer(name)
    q._drain_impl = t.wrap(q._drain_impl)
    q.on_begin = t.wrap(q.on_begin)
    q.on_end = t.wrap(q.on_end)
    return reg

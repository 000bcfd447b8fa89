"""Typed metrics registry: counters, gauges, histograms (a copy of
``repro.obs.metrics``, standard library only).

The FL stack's quantitative telemetry — wire bytes per direction,
rounds/sec, jit recompiles, residual norms, simulated fleet energy and
wall-clock — is recorded here rather than printed: the registry is the
single source the CSV/JSON exporters, the trace CLI and the benches read.

  counter    monotonically increasing total (``inc``).
  gauge      last-written value (``set``).
  histogram  streaming summary of observations (``observe``): count, sum,
             min, max — mean derives; bounded memory, no reservoir.

Instruments are create-on-first-use (``registry.counter("wire.up_bytes")``)
and a ``NOOP_METRICS`` singleton mirrors the surface with no-ops so the
instrumented call sites are unconditional. ``to_dict()`` is the versioned
export form that ``repro.obs.export.write_metrics_csv`` flattens and
``benchmarks.schemas.validate_metrics_csv`` checks.
"""
from __future__ import annotations

from typing import Any, Dict

METRICS_VERSION = 1


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return {"count": self.count, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.mean}


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def to_dict(self) -> Dict[str, Any]:
        """Versioned export form, deterministically key-ordered."""
        return {
            "version": METRICS_VERSION,
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].summary()
                           for k in sorted(self._histograms)},
        }


class _NoopInstrument:
    __slots__ = ()
    value = 0.0
    count = 0

    def inc(self, v=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


class NoopMetrics:
    """Same surface as ``MetricsRegistry``; records nothing."""

    _noop = _NoopInstrument()

    def counter(self, name):
        return self._noop

    def gauge(self, name):
        return self._noop

    def histogram(self, name):
        return self._noop

    def to_dict(self):
        return {"version": METRICS_VERSION, "counters": {}, "gauges": {},
                "histograms": {}}


NOOP_METRICS = NoopMetrics()

"""Metrics registry: counters, gauges, and histograms for the serve path.

This module is the single home for percentile/latency-summary math that
was previously duplicated between ``launch/serve.py`` (request latency
percentiles) and ``benchmarks/common.py`` (timing medians): both now call
:func:`percentile` / :func:`latency_summary` here, and ``ServeStats``
delegates its percentile extraction to the same helpers.

The registry itself is a flat name -> instrument map:

- :class:`Counter` — monotone float/int accumulator (``inc``),
- :class:`Gauge` — last-write-wins value (``set``),
- :class:`Histogram` — observations with fixed bucket boundaries *and*
  retained raw samples, so snapshots carry both cumulative ``le_*`` bucket
  counts (cheap, mergeable) and exact p50/p95/p99 (what the launcher and
  BENCH payloads report).

``MetricsRegistry.snapshot()`` returns a plain JSON-ready dict; the serve
launcher dumps it behind ``--metrics-out`` and every benchmark stamps it
into its ``BENCH_*.json`` via ``benchmarks.common.platform_payload``.

All instruments share their registry's lock. Observation cost is one lock
acquire + list append — negligible next to a serve round, and the obs-smoke
overhead gate covers the enabled path end to end.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Default histogram boundaries (seconds): spans µs-scale host packing
# through multi-second XLA compiles.
DEFAULT_BOUNDARIES = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0)


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (numpy's default method), on plain
    Python floats so callers need not hold an array. Empty input -> 0.0."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def latency_summary(xs, qs=(50, 95, 99)) -> dict:
    """The ``{"p50": ..., "p95": ..., "p99": ...}`` dict used for request
    latency and TTFT reporting."""
    return {f"p{q}": percentile(xs, q) for q in qs}


class Counter:
    """Monotone accumulator."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins value."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Observations with fixed cumulative buckets + retained samples.

    ``boundaries`` are upper edges; an observation lands in the first
    bucket whose edge is >= the value, with a final +inf bucket. Raw
    samples are retained so ``percentiles()`` is exact (matches
    ``numpy.percentile`` — verified in tests) rather than
    bucket-interpolated.
    """

    def __init__(self, name: str, lock: threading.Lock,
                 boundaries=DEFAULT_BOUNDARIES):
        self.name = name
        self._lock = lock
        self.boundaries = tuple(sorted(float(b) for b in boundaries))
        self.bucket_counts = [0] * (len(self.boundaries) + 1)
        self.samples: list[float] = []
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect_left(self.boundaries, v)] += 1
            self.samples.append(v)
            self.sum += v

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        with self._lock:
            xs = list(self.samples)
        return {f"p{q}": percentile(xs, q) for q in qs}

    def snapshot(self) -> dict:
        with self._lock:
            xs = list(self.samples)
            buckets = list(self.bucket_counts)
        out = {"count": len(xs), "sum": self.sum}
        if xs:
            out["min"] = min(xs)
            out["max"] = max(xs)
        out.update({f"p{q}": percentile(xs, q) for q in (50, 95, 99)})
        cum = 0
        le = {}
        for edge, n in zip(self.boundaries, buckets):
            cum += n
            le[f"le_{edge:g}"] = cum
        le["le_inf"] = cum + buckets[-1]
        out["buckets"] = le
        return out


class MetricsRegistry:
    """Flat, thread-safe name -> instrument registry.

    ``counter``/``gauge``/``histogram`` are get-or-create: the engine and
    executors call them on the hot path without pre-registration. Asking
    for an existing name with a different instrument kind raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, self._lock, **kw)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"not a {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  boundaries=DEFAULT_BOUNDARIES) -> Histogram:
        return self._get(name, Histogram, boundaries=boundaries)

    def snapshot(self) -> dict:
        """JSON-ready ``{"counters": ..., "gauges": ..., "histograms": ...}``."""
        with self._lock:
            items = list(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.snapshot()
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.snapshot()
            elif isinstance(inst, Histogram):
                out["histograms"][name] = inst.snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


# Process-default registry: engines and benches fall back to it when not
# handed an explicit one, so `platform_payload` can stamp whatever the run
# accumulated into BENCH payloads without plumbing.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT

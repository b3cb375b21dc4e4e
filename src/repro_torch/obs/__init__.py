"""repro_torch.obs — serve-path observability (DESIGN.md §6).

Three pieces, all zero-dependency and no-op when disabled:

- :mod:`~repro_torch.obs.tracer` — nested span/event recorder with Chrome
  trace-event JSON export (Perfetto-viewable),
- :mod:`~repro_torch.obs.metrics` — counter/gauge/histogram registry with exact
  percentile extraction (the single home of latency-summary math),
- :mod:`~repro_torch.obs.flight` — flight recorder dumping the last N round
  traces on request failure or quarantine.

:class:`Obs` bundles the three for the serve engine: ``ServeEngine(...,
obs=Obs(tracer=Tracer(enabled=True)))``. Fields left ``None`` fall back to
the process defaults (a disabled tracer, the default registry, no flight
recorder), so ``Obs()`` — or no ``obs`` at all — costs nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .flight import FlightRecorder
from .metrics import (MetricsRegistry, default_registry, latency_summary,
                      percentile)
from .tracer import (NULL_TRACER, Tracer, default_tracer,
                     validate_chrome_trace)

__all__ = [
    "Obs", "Tracer", "MetricsRegistry", "FlightRecorder",
    "default_tracer", "default_registry", "percentile", "latency_summary",
    "validate_chrome_trace", "NULL_TRACER",
]


@dataclass
class Obs:
    """The observability bundle a serve engine runs under."""

    tracer: Tracer = field(default_factory=default_tracer)
    metrics: MetricsRegistry = field(default_factory=default_registry)
    flight: FlightRecorder | None = None

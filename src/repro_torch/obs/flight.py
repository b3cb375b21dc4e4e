"""Flight recorder: post-mortem dumps of the last N round traces.

The serve engine keeps its tracer's per-round ring warm; when a request
reaches a terminal failure state (``FAILED`` / ``TIMED_OUT``) or a
quarantine event fires, the engine calls :meth:`FlightRecorder.dump`,
which snapshots the most recent ``ring`` round buckets plus the trigger
context into a dump record — in memory always, and as one JSON file per
dump when ``out_dir`` is set.

This is what turns a contained fault (DESIGN.md §5) into something
post-mortemable: the dump holds the exact phase spans and lifecycle
events of the rounds leading up to the failure, including any
``xla.compile`` / ``quarantine`` events, without recording a whole
session. Under ``--inject-faults`` the engine creates a recorder
automatically, so every injected failure leaves a dump.
"""

from __future__ import annotations

import json
import os

from .tracer import Tracer, _json_safe


class FlightRecorder:
    """Ring-buffer dump sink.

    ``ring`` is how many trailing round buckets each dump snapshots (and
    the ring depth the engine configures on an auto-created tracer);
    ``out_dir`` optionally persists each dump as
    ``flight_<seq>_<reason>.json``.
    """

    def __init__(self, ring: int = 8, out_dir: str | None = None):
        self.ring = int(ring)
        self.out_dir = out_dir
        self.dumps: list[dict] = []

    def dump(self, tracer: Tracer, reason: str, **info) -> dict:
        """Snapshot the tracer's recent rounds under ``reason`` (e.g.
        ``failed`` / ``timed_out`` / ``quarantine``) with trigger context
        (rid, error code, round...). Returns the dump record."""
        rec = {
            "seq": len(self.dumps),
            "reason": reason,
            "info": _json_safe(info),
            "rounds": tracer.recent_rounds(self.ring) if tracer.enabled
            else [],
            "events_dropped": tracer.n_dropped,
        }
        self.dumps.append(rec)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir, f"flight_{rec['seq']:04d}_{reason}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            rec["path"] = path
        return rec

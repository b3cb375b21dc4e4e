"""Zero-dependency span/event tracer for the serve path (DESIGN.md §6).

One :class:`Tracer` instance records a flat stream of *complete spans*
(named intervals with a start and a duration) and *instant events* (named
points), grouped into per-round buckets so the flight recorder can keep a
ring of the last N rounds without retaining a whole serving session.

Design constraints, in order:

- **Disabled must cost nothing measurable.** ``span()`` on a disabled
  tracer returns a shared no-op context manager and ``event()`` returns
  immediately — no allocation, no lock, no timestamp. The serve engine and
  the plan executors call these hooks unconditionally; the obs-smoke CI job
  gates the enabled-vs-disabled overhead at < 5% wall on the churn trace.
- **Thread-safe.** Span nesting state is thread-local (each thread has its
  own open-span stack); the event buffer is guarded by one lock. The
  sharded engine packs host-side index vectors while a dispatch is in
  flight, and tests hammer the tracer from many threads.
- **Perfetto-viewable output.** :meth:`to_chrome` emits the Chrome
  trace-event JSON format (``{"traceEvents": [...]}`` with ``ph: "X"``
  complete spans and ``ph: "i"`` instants, timestamps in microseconds), so
  a recorded serve trace opens directly in Perfetto / chrome://tracing.

Span taxonomy (what the serve stack records — see DESIGN.md §6 for the
full vocabulary):

- ``serve.run`` / ``serve.round`` — engine loop and one scheduler round,
- ``round.schedule`` / ``round.pack`` / ``round.lm`` / ``round.single`` /
  ``round.scatter`` / ``round.feed`` / ``round.feed_stage`` — engine-side
  round phases (planning, feed-graph packing, family sub-rounds, state
  scatter-back, token feed, prefill slot staging); pipelined rounds
  (DESIGN.md §9) stamp speculative ``round.schedule``/``round.pack`` spans
  with ``overlap`` and the commit-side residue with ``promoted``,
- ``plan.pack`` / ``plan.schedule`` / ``plan.lower`` / ``plan.h2d`` /
  ``plan.dispatch`` / ``plan.block`` — executor-side phases (host packing,
  host-to-device transfer, dispatch, block-until-ready device execution),
- ``xla.compile`` — one span per XLA executable build, attributed to its
  bucket signature (``bucket=<digest>``) and lowering seconds,
- ``interp.schedule`` / ``interp.exec`` — the interpreted floor,
- ``req.*`` instants — request lifecycle (queued, admitted, prefill, ttft,
  completed, failed, timed_out, rejected) plus ``quarantine`` bookings.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records itself into the tracer on exit."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach/overwrite args mid-span (e.g. a compile duration that is
        only known at the end of the guarded region)."""
        self.args.update(args)

    def __enter__(self):
        self._tr._enter()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tr._exit(self, self._t0, t1)
        return False


class Tracer:
    """Span/event recorder with per-round buckets.

    ``enabled`` may be flipped at any time (the benchmark helpers enable
    the process-default tracer after parsing ``--trace-out``). ``ring > 0``
    keeps only the last ``ring`` round buckets — the flight-recorder mode,
    bounding memory for always-on fault capture; ``ring=0`` keeps the whole
    session for ``--trace-out`` export.
    """

    def __init__(self, enabled: bool = False, ring: int = 0):
        self.enabled = bool(enabled)
        self.ring = int(ring)
        self._lock = threading.Lock()
        self._local = threading.local()
        # Buckets of (round_id | None, [event dict, ...]); the first bucket
        # (round None) holds anything recorded before the first round.
        self._buckets: deque = deque([[None, []]])
        self._tids: dict[int, int] = {}
        self._epoch = time.perf_counter()
        self._open = 0          # spans entered but not yet exited (all threads)
        self.n_dropped = 0      # events discarded by ring rotation

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str = "serve", **args):
        """Context manager timing a named region. No-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "serve", **args) -> None:
        """Record an instant event. No-op when disabled."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": 0, "tid": self._tid(), "args": args}
        with self._lock:
            self._buckets[-1][1].append(ev)

    def mark_round(self, round_id: int) -> None:
        """Open a new per-round bucket (subsequent events land in it). With
        ``ring > 0``, buckets beyond the ring are dropped oldest-first."""
        if not self.enabled:
            return
        with self._lock:
            self._buckets.append([int(round_id), []])
            while self.ring and len(self._buckets) > self.ring:
                self.n_dropped += len(self._buckets[0][1])
                self._buckets.popleft()

    def _tid(self) -> int:
        """Small stable per-thread id (Chrome tids render better small)."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _enter(self) -> None:
        self._stack().append(None)
        with self._lock:
            self._open += 1

    def _exit(self, span: _Span, t0: float, t1: float) -> None:
        st = self._stack()
        if st:
            st.pop()
        ev = {"name": span.name, "cat": span.cat, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6, "dur": (t1 - t0) * 1e6,
              "pid": 0, "tid": self._tid(), "args": span.args}
        with self._lock:
            self._open -= 1
            self._buckets[-1][1].append(ev)

    # -- introspection ------------------------------------------------------

    @property
    def events(self) -> list[dict]:
        """Flat copy of every retained event, in record order."""
        with self._lock:
            return [ev for _, evs in self._buckets for ev in evs]

    def spans(self, name: str | None = None) -> list[dict]:
        """Retained complete spans, optionally filtered by name."""
        return [e for e in self.events
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def open_spans(self) -> int:
        """Spans entered but not exited — 0 after any balanced run."""
        with self._lock:
            return self._open

    def depth(self) -> int:
        """Current thread's span nesting depth."""
        return len(self._stack())

    def recent_rounds(self, n: int) -> list[dict]:
        """The last ``n`` round buckets as ``{"round", "events"}`` dicts —
        what the flight recorder snapshots into a dump."""
        with self._lock:
            tail = list(self._buckets)[-n:]
            return [{"round": rid, "events": list(evs)} for rid, evs in tail]

    def clear(self) -> None:
        with self._lock:
            self._buckets = deque([[None, []]])
            self.n_dropped = 0

    # -- export -------------------------------------------------------------

    def to_chrome(self, process_name: str = "repro-serve") -> dict:
        """The Chrome trace-event JSON object (Perfetto-viewable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": process_name}}]
        with self._lock:
            meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                      "args": {"name": f"thread-{tid}"}}
                     for tid in sorted(self._tids.values())]
            evs = [dict(ev, args=_json_safe(ev["args"]))
                   for _, evs in self._buckets for ev in evs]
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def write(self, path: str, process_name: str = "repro-serve") -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)


def _json_safe(obj: Any):
    """Args must serialize: stringify anything JSON cannot carry."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def validate_chrome_trace(obj: Any) -> list[str]:
    """Schema check for an exported trace: returns a list of problems
    (empty = valid). Shared by tests and the obs-smoke gate."""
    problems: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' is not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i} has unknown phase {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i} missing name/pid/tid")
        if ph in ("X", "i") and not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} ({ev.get('name')}) has no numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev.get('name')}) has bad dur {dur!r}")
        args = ev.get("args", {})
        try:
            json.dumps(args)
        except TypeError:
            problems.append(f"event {i} args not JSON-serializable")
    return problems


# The process-default tracer: disabled until something (the benchmark
# helpers' --trace-out, a test) enables it. Engines and executors fall back
# to it when not handed an explicit tracer, so a single flag lights up the
# whole stack without threading a tracer through every constructor.
_DEFAULT = Tracer(enabled=False)

# Dedicated always-disabled instance for call sites that must never record
# (do not enable this one).
NULL_TRACER = Tracer(enabled=False)


def default_tracer() -> Tracer:
    return _DEFAULT

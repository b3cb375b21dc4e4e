"""Admission queue for the continuous-batching serve subsystem.

Requests carry a *virtual arrival time* measured in scheduler rounds (floats
allowed, e.g. ``i / rate`` for a Poisson-ish open loop). The engine advances
a round counter and admits every request whose arrival time has passed —
deterministic under test, and rate-convertible for trace-driven benchmarks.
Wall-clock timestamps (``t_admit`` / ``t_first`` / ``t_done``) are stamped by
the engine as requests move through, and feed the latency percentiles in
``ServeStats``.

Every request ends in exactly one terminal status: ``COMPLETED`` (full
result), ``TIMED_OUT`` (deadline passed; partial results kept), ``FAILED``
(validation / planning / execution error, structured payload in ``error``),
or ``REJECTED`` (shed by a bounded queue before admission). Deadlines are
absolute virtual times on the same clock as ``arrival`` — 1 round ≈ 1
virtual time unit.
"""

from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.graph import Graph
from repro_torch.obs.tracer import NULL_TRACER, Tracer

FAMILIES = ("lm", "tree", "lattice")

# Request lifecycle states. PENDING is the only non-terminal one.
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
TIMED_OUT = "TIMED_OUT"
REJECTED = "REJECTED"
TERMINAL = (COMPLETED, FAILED, TIMED_OUT, REJECTED)


class _RidCounter:
    """Process-wide request-id source with restore support: a restored
    engine calls :func:`reserve_rids` with the snapshot's rid ceiling so
    requests created after a restore can never collide with replayed ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0

    def take(self) -> int:
        with self._lock:
            rid = self._next
            self._next += 1
            return rid

    def reserve(self, above: int) -> None:
        with self._lock:
            self._next = max(self._next, int(above))


_rids = _RidCounter()


def reserve_rids(above: int) -> None:
    """Bump the process-wide rid counter to at least ``above``."""
    _rids.reserve(above)


@dataclass
class ServeRequest:
    """One servable request.

    ``lm`` requests carry a prompt and a generation budget and span many
    decode rounds; ``tree`` / ``lattice`` requests carry a single request
    graph and complete in the round they are executed.
    """

    family: str
    arrival: float = 0.0               # virtual time (rounds)
    prompt: list[int] | None = None    # lm
    max_new: int = 0                   # lm
    graph: Graph | None = None         # tree / lattice
    deadline: float | None = None      # absolute virtual time, or no SLO
    rid: int = field(default_factory=lambda: _rids.take())

    # lifecycle
    status: str = PENDING
    error: dict | None = None          # structured payload when not COMPLETED

    # engine-filled progress / results
    out: list[int] = field(default_factory=list)   # lm: generated tokens
    feed: list[int] | None = None      # lm, bucketed path: padded prompt
    n_fed: int = 0                     # ... tokens already fed through
    result: Any = None                 # tree / lattice: stacked O-node logits
    park: Any = None                   # lm: evacuated slot state awaiting a
    #                                    free slot ({field: host row})
    admit_round: int = -1
    done_round: int = -1
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown request family {self.family!r}")
        if self.family == "lm":
            if not self.prompt or self.max_new < 1:
                raise ValueError("lm requests need a prompt and max_new >= 1")
        elif self.graph is None:
            raise ValueError(f"{self.family} requests need a request graph")

    @property
    def done(self) -> bool:
        if self.family == "lm":
            return len(self.out) >= self.max_new
        return self.result is not None

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    def mark(self, status: str, code: str, detail: str,
             round_: int = -1) -> None:
        """Move to a terminal non-COMPLETED status with a structured error."""
        self.status = status
        self.error = {"code": code, "detail": detail, "round": int(round_)}


def lm_request(prompt: list[int], max_new: int, arrival: float = 0.0,
               deadline: float | None = None) -> ServeRequest:
    return ServeRequest("lm", arrival, prompt=list(prompt), max_new=max_new,
                        deadline=deadline)


def graph_request(family: str, graph: Graph, arrival: float = 0.0,
                  deadline: float | None = None) -> ServeRequest:
    return ServeRequest(family, arrival, graph=graph, deadline=deadline)


class AdmissionQueue:
    """Min-heap of pending requests ordered by (arrival, rid).

    With ``max_pending`` set, the queue is bounded: a submit that would
    exceed the cap is shed — the request is marked ``REJECTED`` with a
    ``QUEUE_FULL`` error and never enters the heap. Unbounded by default,
    preserving the original fire-hose semantics.

    Admission is **idempotent by rid**: a request id the queue has already
    accepted (or been seeded with after a checkpoint restore) is silently
    dropped — counted in ``duplicates``, never double-queued, never
    double-counted in ``submitted``. This is what makes checkpoint replay
    safe: a driver that re-submits its whole trace after a restore cannot
    double-admit the requests the snapshot already carries.
    """

    def __init__(self, max_pending: int | None = None,
                 tracer: Tracer | None = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._heap: list[tuple[float, int, ServeRequest]] = []
        self._seen: set[int] = set()   # rids ever accepted (or restored)
        self.max_pending = max_pending
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.submitted = 0
        self.rejected = 0
        self.duplicates = 0

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req: ServeRequest) -> bool:
        """Enqueue ``req``; returns False (and marks it REJECTED) when a
        bounded queue is full. A rid already accepted is a no-op returning
        True — the original admission stands."""
        if req.rid in self._seen:
            self.duplicates += 1
            self.tracer.event("req.duplicate", cat="req", rid=req.rid,
                              family=req.family)
            return True
        if (self.max_pending is not None
                and len(self._heap) >= self.max_pending):
            req.mark(REJECTED, "QUEUE_FULL",
                     f"admission queue at capacity ({self.max_pending})")
            self.rejected += 1
            self.tracer.event("req.rejected", cat="req", rid=req.rid,
                              family=req.family, code="QUEUE_FULL")
            return False
        heapq.heappush(self._heap, (req.arrival, req.rid, req))
        self._seen.add(req.rid)
        self.submitted += 1
        self.tracer.event("req.queued", cat="req", rid=req.rid,
                          family=req.family, arrival=req.arrival)
        return True

    def submit_many(self, reqs) -> list[ServeRequest]:
        """Submit all; returns the rejected ones (empty when unbounded)."""
        return [r for r in reqs if not self.submit(r)]

    def earliest_arrival(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def admit(self, now: float) -> list[ServeRequest]:
        """Pop every request with ``arrival <= now``, in (arrival, rid)
        order. Backpressure is the scheduler's job (slot exhaustion queues
        lm requests), not the queue's."""
        out: list[ServeRequest] = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def drain(self) -> list[ServeRequest]:
        """Pop every remaining request in (arrival, rid) order, regardless
        of arrival time. Used by the engine's graceful round-budget drain."""
        out: list[ServeRequest] = []
        while self._heap:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def pending(self) -> list[ServeRequest]:
        """Non-destructive (arrival, rid)-ordered view of queued requests —
        what a checkpoint snapshots."""
        return [r for _, _, r in sorted(self._heap, key=lambda t: t[:2])]

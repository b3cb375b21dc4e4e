"""Supervised asynchronous compile service (DESIGN.md §8).

Builds once took most of a serve run's wall on the loop itself: every
bucket-signature miss used to block the serve loop synchronously inside
``BucketedPlanExecutor``, so one slow — or hung — compile stalled every
in-flight request. :class:`CompileService` moves those builds onto a
bounded pool of background worker threads; the engine submits a job on a
signature miss, serves the round through the degradation ladder (coarser
already-compiled bucket, then the interpreted floor), and hot-swaps to
the compiled tier at a later round boundary once the executable lands in
the shared LRU cache.

Supervision is the point, not a bonus:

- **Timeout.** A compile thread stuck inside XLA cannot be killed from
  Python, so the per-job wall-clock timeout is enforced by *abandoning*
  the worker (it is a daemon thread; its eventual result, if any, is
  discarded as a "late land") and spawning a replacement so pool capacity
  never shrinks. Timeouts are detected by :meth:`poll`, which the engine
  calls at every round boundary.
- **Bounded retries with exponential backoff.** A failed or timed-out job
  re-queues after ``retry_backoff_s * 2**(attempt-1)`` seconds, up to
  ``max_retries`` retries.
- **Quarantine.** Every failure is also booked into the engine's shared
  :class:`~repro.serve.faults.Quarantine` under the same ``(family,
  bucket-spec)`` key the dispatch path checks, so a signature that keeps
  failing to compile stops being submitted *and* stops being waited on —
  its rounds settle at the interpreted floor. Exhausting the retry budget
  fires ``on_quarantine`` (the engine hangs a flight-recorder dump off
  it).
- **Containment.** Worker exceptions are caught at the job boundary; a
  crashing compile can never take down serving.

The service knows nothing about jax: a job's ``build`` callable (a
closure the engine makes over ``BucketedPlanExecutor.build_executable``)
does the actual lowering and returns the compile seconds, which feed
``ServeStats.lower_bg_s``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

# Job lifecycle states.
PENDING = "pending"          # queued (or in retry backoff), not yet running
RUNNING = "running"          # a worker is building it
LANDED = "landed"            # executable in the shared cache
QUARANTINED = "quarantined"  # retry budget exhausted; signature quarantined

_STAT_KEYS = ("submitted", "landed", "retries", "timeouts", "failures",
              "quarantined", "late_lands")


@dataclass(eq=False)   # identity semantics: jobs live in sets
class CompileJob:
    """One background build. ``build(job, span_args, abort_check)`` performs
    the compile (idempotent: a cache hit returns immediately) and returns the
    compile seconds; it may set ``job.qkey`` once the bucket signature is
    known so failures quarantine the same key the dispatch path checks.
    ``abort_check`` returns True once this attempt's worker was abandoned —
    a build that consults it before the expensive XLA step lets a timed-out
    thread die quickly instead of burning a wasted compile."""

    sig: str                                   # dedupe identity
    build: Callable[["CompileJob", dict, Callable[[], bool]], float]
    family: str = ""
    kind: str = "bucketed"                     # bucketed | warm
    qkey: Any = None                           # quarantine key (may be set late)
    describe: dict = field(default_factory=dict)  # re-submittable descriptor
    submit_round: int = 0
    submit_t: float = 0.0
    status: str = PENDING
    attempts: int = 0
    not_before: float = 0.0                    # retry backoff gate (monotonic)
    started_t: float = 0.0
    compile_s: float = 0.0
    error: str = ""
    worker: Any = None


class _Worker:
    __slots__ = ("thread", "abandoned")

    def __init__(self):
        self.thread = None
        self.abandoned = False


class CompileService:
    """Bounded worker pool building bucket executables off the serve loop.

    Thread model: ``submit``/``poll``/``drain`` run on the engine thread;
    ``_worker_main`` runs on pool threads. One condition variable guards
    all shared state. ``poll(round_)`` is the supervision heartbeat — it
    times out overdue jobs, promotes backoff-expired retries, updates the
    queue-depth gauge, and returns the jobs that landed since the last
    call so the engine can account hot-swaps.
    """

    def __init__(self, workers: int = 2, timeout_s: float = 30.0,
                 max_retries: int = 2, retry_backoff_s: float = 0.1,
                 quarantine: Any = None, metrics: Any = None,
                 on_quarantine: Callable[[CompileJob], None] | None = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.n_workers = int(workers)
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.quarantine = quarantine
        self.metrics = metrics
        self.on_quarantine = on_quarantine
        self._cv = threading.Condition()
        self._queue: deque[CompileJob] = deque()
        self._delayed: list[CompileJob] = []
        self._running: set[CompileJob] = set()
        self._landed_unclaimed: list[CompileJob] = []
        self._by_sig: dict[str, CompileJob] = {}
        self._workers: list[_Worker] = []
        self._abandoned: list[_Worker] = []
        self._stop = False
        self._round = 0
        self.total_compile_s = 0.0
        self.stats = {k: 0 for k in _STAT_KEYS}

    # -- engine-side API ------------------------------------------------------

    def submit(self, sig: str, build: Callable, *, family: str = "",
               kind: str = "bucketed", qkey: Any = None,
               describe: dict | None = None) -> bool:
        """Queue a build; returns False when ``sig`` is already in flight
        (pending, backing off, or running) — the dedupe that keeps one
        signature from being compiled N times by N degraded rounds."""
        with self._cv:
            if self._stop or sig in self._by_sig:
                return False
            job = CompileJob(sig=sig, build=build, family=family, kind=kind,
                             qkey=qkey, describe=dict(describe or {}),
                             submit_round=self._round,
                             submit_t=time.monotonic())
            self._by_sig[sig] = job
            self._queue.append(job)
            self.stats["submitted"] += 1
            self._count("compile.submitted")
            while len(self._workers) < self.n_workers:
                self._spawn_worker_locked()
            self._gauge_locked()
            self._cv.notify()
        return True

    def poll(self, round_: int | None = None,
             now: float | None = None) -> list[CompileJob]:
        """Supervision heartbeat: enforce timeouts, release backoff-expired
        retries, and return jobs landed since the last poll."""
        now = time.monotonic() if now is None else now
        with self._cv:
            if round_ is not None:
                self._round = int(round_)
            self._sweep_locked(now)
            landed = self._landed_unclaimed
            self._landed_unclaimed = []
            self._gauge_locked()
        return landed

    def pending_count(self) -> int:
        """Jobs not yet resolved (queued, backing off, or running)."""
        with self._cv:
            return len(self._by_sig)

    def in_flight(self, sig: str) -> bool:
        with self._cv:
            return sig in self._by_sig

    def pending_descriptors(self) -> list[dict]:
        """Re-submittable descriptors of unresolved jobs — what a
        checkpoint stores so a restore can resume interrupted compiles."""
        with self._cv:
            return [dict(j.describe) for j in self._by_sig.values()
                    if j.describe]

    def drain(self, timeout_s: float | None = None) -> bool:
        """Block until every job resolves (lands or quarantines) or the
        deadline passes. The default deadline covers a worst-case hung
        signature riding out its full timeout x retry budget, so drain
        always terminates — abandoned daemon threads are not waited on."""
        if timeout_s is None:
            timeout_s = (self.timeout_s * (self.max_retries + 1)
                         + self.retry_backoff_s * (2 ** self.max_retries)
                         + 5.0)
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                now = time.monotonic()
                self._sweep_locked(now)
                if not self._by_sig:
                    return True
                if now >= deadline:
                    return False
                self._cv.wait(min(0.05, max(deadline - now, 0.001)))

    def shutdown(self, timeout_s: float = 1.0) -> None:
        """Terminal stop: no new submissions, no further dequeues, and
        in-progress builds are abandoned (graceful completion is ``drain()``,
        which ``ServeEngine.run()`` calls first). All threads — including
        previously abandoned ones — are joined best-effort with a bounded
        timeout; only a build truly hung inside XLA stays an unjoinable
        daemon until process exit (by construction it cannot be killed from
        Python)."""
        with self._cv:
            self._stop = True
            # Abandon in-progress builds too: an abort-aware build (or an
            # injected hang polling ``ctx["abort"]``) exits within one poll
            # interval instead of keeping a thread alive into interpreter
            # teardown — where a daemon mid-native-code can abort the
            # process.
            for w in self._workers:
                w.abandoned = True
            self._cv.notify_all()
            workers = list(self._workers) + list(self._abandoned)
        for w in workers:
            if w.thread is not None:
                w.thread.join(timeout=timeout_s)

    def state(self) -> dict:
        with self._cv:
            return {"stats": dict(self.stats),
                    "total_compile_s": self.total_compile_s,
                    "in_flight": [dict(j.describe)
                                  for j in self._by_sig.values()
                                  if j.describe]}

    # -- supervision (engine thread, locked) ----------------------------------

    def _sweep_locked(self, now: float) -> None:
        for job in [j for j in self._running
                    if now - j.started_t > self.timeout_s]:
            self._running.discard(job)
            w = job.worker
            if w is not None:
                w.abandoned = True
                if w in self._workers:
                    self._workers.remove(w)
                self._abandoned.append(w)
                self._spawn_worker_locked()
            self.stats["timeouts"] += 1
            self._count("compile.timeouts")
            exc = TimeoutError(
                f"compile job {job.sig} exceeded {self.timeout_s:.3g}s "
                f"(attempt {job.attempts})")
            self._resolve_failure_locked(job, exc, now)
        if self._delayed:
            due = [j for j in self._delayed if j.not_before <= now]
            if due:
                self._delayed = [j for j in self._delayed
                                 if j.not_before > now]
                self._queue.extend(due)
                self._cv.notify_all()

    def _resolve_failure_locked(self, job: CompileJob, exc: BaseException,
                                now: float) -> None:
        job.error = repr(exc)
        if self.quarantine is not None:
            key = job.qkey if job.qkey is not None else ("compile", job.sig)
            self.quarantine.record_failure(key, self._round, exc)
        if job.attempts <= self.max_retries:
            job.status = PENDING
            job.worker = None
            job.not_before = (now + self.retry_backoff_s
                              * (2 ** (job.attempts - 1)))
            self._delayed.append(job)
            self.stats["retries"] += 1
            self._count("compile.retries")
        else:
            job.status = QUARANTINED
            self._by_sig.pop(job.sig, None)
            self.stats["quarantined"] += 1
            self._count("compile.quarantined")
            if self.on_quarantine is not None:
                try:
                    self.on_quarantine(job)
                except Exception:
                    pass   # observability must never break supervision

    # -- worker side ----------------------------------------------------------

    def _spawn_worker_locked(self) -> None:
        w = _Worker()
        t = threading.Thread(target=self._worker_main, args=(w,),
                             name=f"compile-worker-{len(self._workers)}",
                             daemon=True)
        w.thread = t
        self._workers.append(w)
        t.start()

    def _worker_main(self, worker: _Worker) -> None:
        while True:
            with self._cv:
                while (not self._queue and not self._stop
                       and not worker.abandoned):
                    self._cv.wait(0.1)
                if worker.abandoned:
                    return
                if not self._queue:
                    return   # stopping and nothing left
                job = self._queue.popleft()
                job.worker = worker
                job.attempts += 1
                job.status = RUNNING
                job.started_t = time.monotonic()
                self._running.add(job)
            span_args = {"bg": True,
                         "queue_wait_s":
                             round(job.started_t - job.submit_t, 6)}
            try:
                dt = float(job.build(job, span_args,
                                     lambda w=worker: w.abandoned) or 0.0)
            except BaseException as exc:   # containment boundary
                with self._cv:
                    # ``job.worker is worker`` distinguishes this attempt
                    # from a retry already running elsewhere after this
                    # worker was timed out and abandoned.
                    live = job.worker is worker and not worker.abandoned
                    if job.worker is worker:
                        self._running.discard(job)
                    if live:
                        self.stats["failures"] += 1
                        self._count("compile.failures")
                        self._resolve_failure_locked(
                            job, exc, time.monotonic())
                    self._cv.notify_all()
            else:
                with self._cv:
                    live = job.worker is worker and not worker.abandoned
                    if job.worker is worker:
                        self._running.discard(job)
                    job.compile_s = dt
                    self.total_compile_s += dt
                    if live:
                        job.status = LANDED
                        self._by_sig.pop(job.sig, None)
                        self._landed_unclaimed.append(job)
                        self.stats["landed"] += 1
                        self._count("compile.landed")
                    else:
                        # Abandoned after timeout but the build finished
                        # anyway: the executable is in the cache (harmless
                        # and even useful), but supervision already ruled.
                        self.stats["late_lands"] += 1
                    self._cv.notify_all()
            if worker.abandoned:
                return

    # -- observability --------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def _gauge_locked(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("compile.queue_depth").set(
                float(len(self._queue) + len(self._delayed)
                      + len(self._running)))

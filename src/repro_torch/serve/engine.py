"""Continuous-batching serve engine on compiled execution plans.

The port of the reference's round-driven engine over the typed-graph
executors, on one device:

- an :class:`~repro_torch.serve.queue.AdmissionQueue` feeds a
  :class:`~repro_torch.serve.scheduler.ContinuousScheduler` that folds newly
  arrived requests into in-flight waves (continuous batching) or drains
  wave-by-wave (the baseline discipline),
- each round's wave graph executes through the **bucketed compiled-plan
  path** (:class:`repro_torch.core.plan.BucketedPlanExecutor`: one graph
  replay per family per round — on the card each *bucket signature* is
  captured once as a CUDA graph, where the reference caches one XLA
  executable, so topology churn costs host-side index packing instead of a
  capture), with the per-topology :class:`repro_torch.core.plan.PlanExecutor`
  (``bucketed=False``) and the interpreted
  :class:`repro_torch.core.executor.DynamicExecutor` (``compiled=False``) as
  fallbacks,
- all three workload families are servable: autoregressive chain-LM decode
  (``lm``), tree classifiers (``tree``), lattice NER (``lattice``), mapped
  to workloads by ``repro_torch.models.workloads.SERVE_FAMILIES``,
- per-family batching policies come from an explicit dict, a persistent
  :class:`~repro_torch.serve.registry.PolicyRegistry` (auto-selected at
  construction), or default to the sufficient-condition heuristic,
- schedule and plan caches are **shared, FIFO-capped** objects keyed by
  (family namespace, topology fingerprint, policy fingerprint).

LM recurrent state lives in a fixed slot pool threaded through executor
``params`` (see ``models/chains.py:ChainLM``), so one captured graph serves
every decode round of a given (padded) width. A graph reads the pool at
the addresses it was captured over, so the engine updates the pool in
place (``index_fill_`` / ``index_copy_``) where the reference rebinds it.

The engine is fault-isolated rather than fail-stop: requests are validated
at admission and failures are contained at request granularity; rounds
degrade down a ladder (bucketed -> interpreted, with failing bucket
signatures quarantined under capped-retry backoff; a failed capture counts
as a failed compile) instead of aborting; per-request deadlines are
enforced at round boundaries; a bounded admission queue sheds load with an
explicit ``REJECTED`` status; and exceeding ``max_rounds`` drains
gracefully. Every request ends in exactly one terminal state.

With ``async_compile`` a bucket signature's build (its host pack, the eager
warm-up and the CUDA-graph capture) runs on a background worker of the
compile service (``serve/compiler.py``); the serve loop only probes the
caches, serves a round whose graph has not landed on a coarser bucket or
the interpreted floor, and hot-swaps at a later round boundary. Sessions
are checkpointed and restored through ``serve/resilience.py``; a restore
copies the slot pool into the engine's own, which its graphs read in
place. ``warmset()`` records the lm signatures served, which ``prewarm()``
builds again in the background.

Not ported yet, and raising ``NotImplementedError`` where asked for: more
than one shard and the data mesh (the sharded executor), shard loss and
regrowth and work stealing.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.batching import (SufficientConditionPolicy,
                                       policy_cache_key)
from repro_torch.core.cache import FIFOCache, LRUCache
from repro_torch.core.device import resolve_device
from repro_torch.core.executor import DynamicExecutor, ExecStats
from repro_torch.core.plan import (BucketedPlanExecutor, PlanExecutor,
                                   _sig_digest)
from repro_torch.kernels.gather_batch import gather_rows
from repro_torch.models.workloads import SERVE_FAMILIES, make_workload
from repro_torch.obs import FlightRecorder, Obs, Tracer
from repro_torch.obs.metrics import percentile

from .faults import (BAD_TOPOLOGY, DEADLINE_EXCEEDED, EXEC_ERROR,
                     ROUND_BUDGET_EXCEEDED, InjectedCrash, Quarantine,
                     validate_request)
from .queue import (COMPLETED, FAILED, TIMED_OUT, AdmissionQueue,
                    ServeRequest)
from .scheduler import (ContinuousScheduler, RoundPlan, bucket_len,
                        build_lm_feed_round_graph, build_lm_round_graph,
                        merge_request_graphs, next_feed_token)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {where}, a later slice "
        f"of the port")


SHARDING = ("the sharding slice (ShardedBucketedPlanExecutor, the data "
            "mesh, shard loss, regrowth and work stealing)")


@dataclass
class ServeStats:
    """Serving metrics: throughput, batching, cache behaviour, latency."""

    n_rounds: int = 0
    n_batches: int = 0
    n_launches: int = 0           # program runs across all families
    n_compiles: int = 0           # distinct program builds (compiled paths)
    tokens_out: int = 0           # lm tokens generated
    outputs_out: int = 0          # single-shot output vectors returned
    requests_done: int = 0
    wall_s: float = 0.0
    schedule_s: float = 0.0       # Alg. 1 walks (cache misses only)
    lower_s: float = 0.0          # plan lowering + build (and capture)
    exec_s: float = 0.0
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    sched_cache_hits: int = 0
    sched_cache_misses: int = 0
    bucket_cache_hits: int = 0    # bucketed path: executable-cache hits
    bucket_cache_misses: int = 0
    n_shards: int = 1
    n_sharded_dispatches: int = 0   # rounds served by one shard_map dispatch
    n_shard_fallback_rounds: int = 0  # rounds degraded to per-shard dispatch
    # Fault accounting. ``tier_rounds`` maps degradation tier ("bucketed" /
    # "plan" / "interpreted") to family-rounds served at that tier.
    requests_failed: int = 0      # terminal FAILED (validation / exec / drain)
    requests_timed_out: int = 0   # terminal TIMED_OUT (deadline passed)
    requests_rejected: int = 0    # shed by the bounded admission queue
    n_contained_errors: int = 0   # exceptions absorbed at a fault boundary
    n_quarantine_events: int = 0  # bucket-signature quarantine bookings
    # Durability & elasticity accounting (the mesh fields stay 0 on one
    # shard).
    n_checkpoints: int = 0        # snapshots written (periodic + crash)
    n_restores: int = 0           # engine lifetimes resumed from a snapshot
    n_resize_events: int = 0
    n_entries_evacuated: int = 0
    n_entries_stolen: int = 0
    # Async compile service accounting. ``lower_s`` keeps its meaning —
    # lowering and builds paid *on* the serve loop — while background
    # builds (pack, warm-up, capture) land in ``lower_bg_s``.
    lower_bg_s: float = 0.0       # background (off-loop) lowering + build
    n_hotswaps: int = 0           # sigs upgraded to bucketed after degraded rounds
    compile_jobs_submitted: int = 0
    compile_jobs_landed: int = 0
    compile_jobs_retried: int = 0
    compile_jobs_timed_out: int = 0
    compile_jobs_quarantined: int = 0
    tier_rounds: dict[str, int] = field(default_factory=dict)
    shard_tokens: list[int] = field(default_factory=list)  # lm tokens per shard
    latency_s: list[float] = field(default_factory=list)   # admit -> done
    ttft_s: list[float] = field(default_factory=list)      # admit -> first out
    # Round pipelining: rounds committed through the two-stage path,
    # next-round packs overlapped with an in-flight dispatch, and
    # speculative packs rolled back (round-t failure or clock drift).
    n_pipelined_rounds: int = 0
    n_overlapped_packs: int = 0
    n_spec_cancelled: int = 0
    n_merge_aligned_rounds: int = 0
    # CUDA graphs: bucket signatures captured, and replays of them.
    n_graph_captures: int = 0
    n_graph_replays: int = 0

    _SUMMED = ("n_batches", "n_launches", "n_compiles", "tokens_out",
               "outputs_out", "requests_done", "plan_cache_hits",
               "plan_cache_misses", "sched_cache_hits", "sched_cache_misses",
               "bucket_cache_hits", "bucket_cache_misses",
               "n_sharded_dispatches", "n_shard_fallback_rounds",
               "requests_failed", "requests_timed_out", "requests_rejected",
               "n_contained_errors", "n_quarantine_events", "n_checkpoints",
               "n_restores", "n_resize_events", "n_entries_evacuated",
               "n_entries_stolen", "n_hotswaps", "compile_jobs_submitted",
               "compile_jobs_landed", "compile_jobs_retried",
               "compile_jobs_timed_out", "compile_jobs_quarantined",
               "n_pipelined_rounds", "n_overlapped_packs",
               "n_spec_cancelled", "n_merge_aligned_rounds",
               "n_graph_captures", "n_graph_replays")
    _MAXED = ("n_rounds", "n_shards", "wall_s", "schedule_s", "lower_s",
              "lower_bg_s", "exec_s")

    @classmethod
    def merged(cls, parts) -> "ServeStats":
        """Fold several ServeStats into one: counters sum, latency samples
        concatenate, rounds and wall-clock fields take the max."""
        out = cls()
        for p in parts:
            for f in cls._MAXED:
                setattr(out, f, max(getattr(out, f), getattr(p, f)))
            for f in cls._SUMMED:
                setattr(out, f, getattr(out, f) + getattr(p, f))
            for tier, n in p.tier_rounds.items():
                out.tier_rounds[tier] = out.tier_rounds.get(tier, 0) + n
            out.latency_s.extend(p.latency_s)
            out.ttft_s.extend(p.ttft_s)
        return out

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)

    def latency_percentiles(self) -> dict[str, float]:
        return {"p50_latency_s": percentile(self.latency_s, 50),
                "p95_latency_s": percentile(self.latency_s, 95),
                "p99_latency_s": percentile(self.latency_s, 99),
                "p50_ttft_s": percentile(self.ttft_s, 50),
                "p95_ttft_s": percentile(self.ttft_s, 95)}

    def as_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("latency_s", "ttft_s")}
        d["tok_per_s"] = self.tok_per_s
        d.update(self.latency_percentiles())
        return d

    @property
    def tokens_per_round(self) -> float:
        return self.tokens_out / max(self.n_rounds, 1)


def _fused_zero(slots: np.ndarray, pools: list[torch.Tensor]) -> None:
    """Prefill staging: zero the fresh entries' slots in every state pool,
    in place (the reference's jitted ``p.at[slots].set(0.0)``)."""
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=pools[0].device)
    for p in pools:
        p.index_fill_(0, idx, 0.0)


def _fused_commit(y_arena, y_rows, slots, state_arenas, state_rows,
                  pools: list[torch.Tensor]) -> np.ndarray:
    """The lm round commit: argmax the entries' output rows into next
    tokens (the first index on ties, as ``jnp.argmax``) and copy their
    recurrent state into the slot pools in place. Returns the tokens on
    the host."""
    n = len(slots)
    # every row vector in one upload: y rows, slots, then each field's rows
    ix = torch.as_tensor(np.concatenate([y_rows, slots, *state_rows])
                         .astype(np.int32), device=y_arena.device)
    toks = torch.argmax(gather_rows(y_arena, ix[:n]), dim=-1)
    slot_ix = ix[n:2 * n].long()
    for k, (p, a) in enumerate(zip(pools, state_arenas)):
        r = ix[(2 + k) * n:(3 + k) * n]
        p.index_copy_(0, slot_ix, gather_rows(a, r).to(p.dtype))
    return toks.cpu().numpy()


class _ReadyRound:
    """Degenerate in-flight handle for rounds that ran eagerly (the
    interpreted floor): ``block()`` just hands back the result. Lets the
    pipelined commit path treat every tier uniformly."""

    pending = False

    def __init__(self, result):
        self._result = result

    def block(self):
        return self._result


@dataclass
class _Speculation:
    """A round packed ahead of its commit: the plan and feed graph for
    round ``round`` at predicted clock ``now``, plus the scheduler/queue
    snapshot (and request feed fields) to roll back to if round t fails or
    the prediction goes stale."""

    round: int
    now: float
    plan: RoundPlan
    graph: Any
    entries: list
    snap: tuple
    feed_undo: list


class _SpecUnsafe(Exception):
    """Raised inside the speculative pack when a condition is met that the
    serial loop would handle with side effects (park restore, admission
    timeout) — the speculation rolls back and round t+1 plans serially."""


class ServeEngine:
    """Round-driven continuous-batching engine over typed request graphs.

    ``families`` maps family name -> workload instance (must expose
    ``.impls``; the lm workload also ``init_slots``/``state_fields``).
    Omitted families are built on demand from ``SERVE_FAMILIES`` with
    ``model_size``/``seed``/``layout`` on ``device`` (``None`` = CUDA,
    raising when CUDA is absent; pass ``"cpu"`` to run on the CPU).
    ``capture`` is the bucketed executor's: on the card each bucket
    signature is captured once as a CUDA graph and replayed (False: every
    bucket runs eagerly on the card). ``async_compile`` moves those builds
    to ``compile_workers`` background threads (``serve/compiler.py``);
    ``checkpoint_dir``/``checkpoint_every`` write session snapshots that
    :meth:`restore` resumes from.
    """

    def __init__(self, families: dict[str, Any] | None = None, *,
                 compiled: bool = True, bucketed: bool = True,
                 continuous: bool = True,
                 max_slots: int = 16, model_size: int = 32, seed: int = 0,
                 layout: str = "planned", policies: dict[str, Any] | None = None,
                 registry: Any = None, plan_cache: FIFOCache | None = None,
                 schedule_cache: FIFOCache | None = None,
                 bucket_cache: FIFOCache | None = None,
                 bucket_ladder: tuple[int, ...] | None = (8,),
                 donate: bool = False,
                 n_shards: int = 1, mesh: Any = None,
                 max_rounds: int = 100_000,
                 queue_cap: int | None = None,
                 fault_injector: Any = None,
                 obs: Obs | None = None,
                 checkpoint_every: int = 0,
                 checkpoint_dir: str | None = None,
                 steal_threshold: int | None = None,
                 async_compile: bool = False,
                 compile_workers: int = 2,
                 compile_timeout_s: float = 30.0,
                 pipeline: bool = True,
                 device=None, capture: bool = True):
        if int(n_shards) > 1 or mesh is not None:
            raise _not_ported("serving on more than one shard", SHARDING)
        if steal_threshold is not None:
            raise _not_ported("work stealing", SHARDING)
        self.device = resolve_device(device)
        self.capture = bool(capture)
        self.compiled = compiled
        self.bucketed = bucketed
        self.n_shards = 1
        # Serving widths bucket with a floor (default 8): decode counts 1..8
        # and single-chain cell batches all land on one rung, so a server's
        # whole decode phase shares one captured graph. Past the floor the
        # ladder falls back to powers of two.
        self.bucket_ladder = bucket_ladder
        self.model_size = model_size
        self.seed = seed
        self.layout = layout
        self.donate = donate
        self.max_rounds = max_rounds
        ob = obs if obs is not None else Obs()
        self._metrics = ob.metrics
        self._flight = ob.flight
        if self._flight is None and fault_injector is not None:
            # Under fault injection every FAILED/TIMED_OUT request must
            # leave a post-mortem dump, even when the caller wired no
            # explicit recorder.
            self._flight = FlightRecorder()
        tracer = ob.tracer
        if self._flight is not None and not tracer.enabled:
            # The flight recorder needs a live ring even when full tracing
            # is off: a private ring-buffered tracer bounds memory to the
            # last N rounds.
            tracer = Tracer(enabled=True, ring=self._flight.ring + 1)
        self.tracer = tracer
        self.queue = AdmissionQueue(max_pending=queue_cap,
                                    tracer=self.tracer)
        self._injector = fault_injector
        self.quarantine = Quarantine(on_event=self._on_quarantine)
        # Async compile service: bucket builds (pack, eager warm-up, CUDA
        # graph capture) run on a supervised background worker pool; rounds
        # whose graph has not landed degrade (coarse bucket -> interpreted
        # floor) instead of blocking on the build, and hot-swap at a later
        # round boundary. Library default OFF; the serve launcher turns it
        # on.
        self.async_compile = bool(async_compile and compiled and bucketed)
        self.compile_workers = int(compile_workers)
        self.compile_timeout_s = float(compile_timeout_s)
        self._compiler = None
        if self.async_compile:
            from .compiler import CompileService
            self._compiler = CompileService(
                workers=self.compile_workers,
                timeout_s=self.compile_timeout_s,
                quarantine=self.quarantine, metrics=self._metrics,
                on_quarantine=self._on_compile_quarantine)
        # Sigs that served at least one degraded round while their build
        # was in flight — the first bucketed round after landing counts as
        # a hot-swap. ``_seen_lm_counts`` feeds the persisted warmset.
        self._awaiting: set[str] = set()
        self._seen_lm_counts: set[int] = set()
        # Round pipelining: while round t's bucket program is in flight on
        # the device, the next LM feed round is planned and packed on the
        # host. ``_spec`` holds the speculative (plan, graph, scheduler
        # snapshot) for round t+1; ``_promoted`` hands the packed graph to
        # ``_run_lm_round`` once the plan is promoted at commit. A bail-out
        # on any predicted completion/deadline/park keeps outputs
        # bit-identical to the serial loop.
        self.pipeline = bool(pipeline and compiled and bucketed)
        self._spec: Any = None
        self._promoted: Any = None
        self._interp_executors: dict[str, Any] = {}
        # The feed-graph path pads the *total* entry count itself, so the
        # scheduler's decode-count padding would only compound.
        self.scheduler = ContinuousScheduler(
            max_slots=max_slots, continuous=continuous,
            pad_decode=not (compiled and bucketed))
        self.stats = ServeStats()
        self._shard_stats = [ServeStats()]
        # Shared, capped caches. On the bucketed path ``plan_cache`` holds
        # host-side topology packs (cheap) and ``bucket_cache`` the built
        # bucket programs and their CUDA graphs, keyed by bucket signature
        # — the expensive entries, LRU-kept so hot buckets survive churn.
        self.plan_cache = plan_cache if plan_cache is not None else FIFOCache(64)
        self.schedule_cache = (schedule_cache if schedule_cache is not None
                               else FIFOCache(512))
        self.bucket_cache = (bucket_cache if bucket_cache is not None
                             else LRUCache(32))
        self._cache_base = (0, 0, 0, 0, 0, 0)
        self._families: dict[str, Any] = dict(families or {})
        self._policies = dict(policies or {})
        self._registry = registry
        self._executors: dict[str, Any] = {}
        self._exec_stats: dict[str, ExecStats] = {}
        self._pool: dict[str, torch.Tensor] | None = None
        self._now = 0.0
        self._round = 0
        # Durability: the request ledger holds every request ever submitted
        # (what a checkpoint snapshots); ``_base`` carries restored absolute
        # counters that fold-time recomputation would otherwise lose
        # (restored executors and caches restart from zero). The mesh
        # fields stay at one shard and are kept for the checkpoint format.
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_dir = checkpoint_dir
        self.steal_threshold = steal_threshold
        self.requests: dict[int, ServeRequest] = {}
        self.resize_log: list[dict] = []
        self._n_shards0 = self.n_shards
        self._excluded_devices: list[int] = []
        self._retired_shard_stats: list[ServeStats] = []
        self._base: dict[str, float] = {}
        self._run_t0: float | None = None

    # -- observability accessors ---------------------------------------------

    @property
    def metrics(self):
        """The engine's metrics registry (the process default unless an
        explicit ``Obs`` was passed)."""
        return self._metrics

    @property
    def flight(self):
        """The flight recorder, or None when faults cannot be recorded."""
        return self._flight

    # -- family plumbing -----------------------------------------------------

    def family(self, name: str):
        wl = self._families.get(name)
        if wl is None:
            wl = make_workload(SERVE_FAMILIES[name], self.model_size,
                               self.seed, self.layout, device=self.device)
            self._families[name] = wl
        return wl

    def policy_for(self, name: str):
        pol = self._policies.get(name)
        if pol is None and self._registry is not None:
            pol = self._registry.auto_select(name)
        if pol is None:
            pol = SufficientConditionPolicy()
        self._policies[name] = pol
        return pol

    def _executor(self, name: str):
        ex = self._executors.get(name)
        if ex is None:
            wl = self.family(name)
            # Namespace = family + impls identity: engines sharing a cache
            # but built around different weights must never serve each
            # other's compiled plans. Every cached artifact pins the impls
            # dict, so its id cannot be recycled while entries live.
            ns = (name, id(wl.impls))
            hook = (self._injector.on_compile if self._injector is not None
                    else None)
            if self.compiled and self.bucketed:
                ex = BucketedPlanExecutor(wl.impls, None, layout=self.layout,
                                          donate=self.donate,
                                          ladder=self.bucket_ladder,
                                          pack_cache=self.plan_cache,
                                          exe_cache=self.bucket_cache,
                                          namespace=ns, compile_hook=hook,
                                          tracer=self.tracer,
                                          device=self.device,
                                          capture=self.capture)
            elif self.compiled:
                ex = PlanExecutor(wl.impls, None, layout=self.layout,
                                  donate=self.donate, cache=self.plan_cache,
                                  namespace=ns, compile_hook=hook,
                                  tracer=self.tracer, device=self.device)
            else:
                ex = DynamicExecutor(wl.impls, None,
                                     schedule_cache=self.schedule_cache,
                                     namespace=ns, tracer=self.tracer,
                                     device=self.device)
            self._executors[name] = ex
            self._exec_stats.setdefault(name, ExecStats())
        return ex

    def _interp_executor(self, name: str):
        """The degradation floor: an interpreted ``DynamicExecutor`` over
        the same impls/weights as the compiled executor, sharing the
        engine's schedule cache. Never fault-injected, so a degraded retry
        always has a tier that can succeed."""
        if not self.compiled:
            return self._executor(name)
        iex = self._interp_executors.get(name)
        if iex is None:
            wl = self.family(name)
            iex = DynamicExecutor(wl.impls, None,
                                  schedule_cache=self.schedule_cache,
                                  namespace=(name, id(wl.impls)),
                                  tracer=self.tracer, device=self.device)
            self._interp_executors[name] = iex
        return iex

    def _primary_tier(self) -> str:
        if self.compiled and self.bucketed:
            return "bucketed"
        if self.compiled:
            return "plan"
        return "interpreted"

    def _note_tier(self, tier: str) -> None:
        self.stats.tier_rounds[tier] = self.stats.tier_rounds.get(tier, 0) + 1

    def _contained(self) -> None:
        """Count one exception absorbed at a fault boundary (stats field
        and metrics counter move together)."""
        self.stats.n_contained_errors += 1
        self._metrics.counter("serve.contained_errors").inc()

    def _on_quarantine(self, key: Any, fails: int, until: float,
                       error: str) -> None:
        """Quarantine booking callback: single site for the stats counter,
        metrics, tracer event, and flight-recorder dump."""
        self.stats.n_quarantine_events += 1
        self._metrics.counter("serve.quarantine_events").inc()
        sig = _sig_digest(key)
        self.tracer.event("quarantine", cat="fault", sig=sig, fails=fails,
                          until=until, error=error, round=self._round)
        if self._flight is not None:
            self._flight.dump(self.tracer, "quarantine", sig=sig,
                              fails=fails, until=until, error=error,
                              round=self._round)

    def _on_compile_quarantine(self, job) -> None:
        """A background build exhausted its retry budget: leave a
        flight-recorder dump carrying the job context. (The per-failure
        quarantine bookings already fired through ``_on_quarantine``; this
        dump marks the terminal give-up with attempt/error detail.)"""
        self.tracer.event("compile.quarantined", cat="compile", sig=job.sig,
                          family=job.family, attempts=job.attempts,
                          error=job.error, round=self._round)
        if self._flight is not None:
            self._flight.dump(self.tracer, "compile_quarantine",
                              sig=job.sig, family=job.family,
                              attempts=job.attempts, error=job.error,
                              round=self._round)

    def _poll_compiles(self) -> None:
        """Supervision heartbeat at the round boundary: collect landed
        builds (hot-swap happens on first use, in ``_exec_graph_async``),
        enforce job timeouts, release backoff-expired retries."""
        if self._compiler is None:
            return
        for job in self._compiler.poll(self._round):
            self.tracer.event("compile.landed", cat="compile", sig=job.sig,
                              family=job.family, attempts=job.attempts,
                              compile_s=round(job.compile_s, 6),
                              round=self._round)

    def _lm_pool(self):
        if self._pool is None:
            self._pool = self.family("lm").init_slots(self.scheduler.max_slots)
        return self._pool

    # -- request intake ------------------------------------------------------

    def submit(self, req: ServeRequest) -> ServeRequest:
        self.requests.setdefault(req.rid, req)
        self.queue.submit(req)
        return req

    def submit_many(self, reqs) -> list[ServeRequest]:
        """Submit all; returns the rejected ones (empty when unbounded)."""
        reqs = list(reqs)
        for r in reqs:
            self.requests.setdefault(r.rid, r)
        return self.queue.submit_many(reqs)

    # -- the serving loop ----------------------------------------------------

    def run(self) -> ServeStats:
        """Drive rounds until the queue is drained and all requests are done."""
        t0 = time.perf_counter()
        self._run_t0 = t0
        # Counter baselines: shared caches accumulate across engines, but
        # this engine's stats must report only its own hits/misses.
        self._cache_base = (self.plan_cache.hits, self.plan_cache.misses,
                            self.schedule_cache.hits,
                            self.schedule_cache.misses,
                            self.bucket_cache.hits,
                            self.bucket_cache.misses)
        with self.tracer.span("serve.run", n_shards=self.n_shards):
            while len(self.queue) or self.scheduler.has_work():
                if not self.scheduler.has_work():
                    # Idle with future arrivals: fast-forward the virtual
                    # clock.
                    nxt = self.queue.earliest_arrival()
                    if nxt is not None and nxt > self._now:
                        self._now = nxt
                self.step()
                if self._round > self.max_rounds:
                    # A live speculative pack must roll back before the
                    # budget drain, so drained requests see the same
                    # scheduler/queue state as the serial loop would.
                    self._cancel_spec()
                    self._drain_round_budget()
                    break
            if self._compiler is not None:
                # Drain-before-exit: every in-flight build resolves (lands
                # or quarantines) so no worker is left mid-build when the
                # caller tears the engine down. Hung builds ride out their
                # timeout x retry budget inside drain — it always returns.
                with self.tracer.span("serve.drain_compiles",
                                      cat="compile"):
                    self._compiler.drain()
                self._poll_compiles()
        self.stats.wall_s += time.perf_counter() - t0
        self._run_t0 = None
        self._fold_exec_stats()
        return self.stats

    def close(self) -> None:
        """Tear down background machinery (the compile worker pool).
        Idempotent; an engine without the async service is a no-op."""
        if self._compiler is not None:
            self._compiler.shutdown()

    def step(self) -> None:
        """One scheduler round: admit, build wave graphs, execute, feed back."""
        self._poll_compiles()
        if self._injector is not None:
            for kind, _ in self._injector.shard_events(self._round):
                if kind == "back":
                    self.regrow_shard()
            if self._injector.crash_due(self._round):
                if self.checkpoint_dir:
                    self.checkpoint(reason="crash")
                raise InjectedCrash(
                    f"injected process crash at round {self._round}")
        tr = self.tracer
        tr.mark_round(self._round)
        t_round = time.perf_counter()
        with tr.span("serve.round", round=self._round):
            # A plan speculatively packed during round t-1's in-flight
            # dispatch is promoted here if the world still matches the
            # prediction; otherwise (or with no speculation) the serial
            # schedule path runs.
            self._promoted = None
            plan = self._promote_spec()
            if plan is None:
                self._enforce_deadlines()
                with tr.span("round.schedule"):
                    plan = self.scheduler.plan_round(self.queue, self._now,
                                                     validate=self._validate)
            tw = time.perf_counter()
            for req, detail in plan.invalid:
                req.admit_round = self._round
                req.t_admit = tw
                self._fail(req, BAD_TOPOLOGY, detail)
            for req in plan.admitted:
                # Stamped at admission, so slot-wait shows up in latency.
                req.admit_round = self._round
                req.t_admit = tw
                tr.event("req.admitted", cat="req", rid=req.rid,
                         family=req.family, round=self._round)
                self._metrics.histogram("serve.queue_delay_rounds").observe(
                    max(self._now - req.arrival, 0.0))
            self._timeout_admitted(plan)
            for e in plan.prefills:
                if e.req is not None:
                    tr.event("req.prefill", cat="req", rid=e.req.rid,
                             slot=e.slot, round=self._round)
            if not plan.empty:
                with tr.span("round.lm"):
                    self._run_lm_round(plan)
                for fam, reqs in plan.singles.items():
                    with tr.span("round.single", family=fam, n=len(reqs)):
                        self._run_single_shot(fam, reqs)
                self.stats.n_rounds += 1
                self._metrics.counter("serve.rounds").inc()
                self._metrics.histogram("serve.round_s").observe(
                    time.perf_counter() - t_round)
            if self._injector is not None:
                # Injected slow round: burn extra virtual time so deadline
                # enforcement can be exercised deterministically.
                self._now += self._injector.round_delay(self._round)
        self._round += 1
        self._now = max(self._now + 1.0, float(self._round))
        if (self.checkpoint_every and self.checkpoint_dir
                and self._round % self.checkpoint_every == 0):
            self.checkpoint(reason="periodic")

    # -- durability ----------------------------------------------------------

    def checkpoint(self, path: str | None = None,
                   reason: str = "manual") -> str:
        """Write a versioned, fingerprinted snapshot of the whole session
        (atomic write; see serve/checkpoint.py). Returns the path."""
        from . import resilience
        from .checkpoint import checkpoint_path, write_checkpoint
        if path is None:
            if not self.checkpoint_dir:
                raise ValueError(
                    "no checkpoint destination: pass path= or construct the "
                    "engine with checkpoint_dir=")
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            path = checkpoint_path(self.checkpoint_dir, self._round)
        with self.tracer.span("ckpt.save", round=self._round, reason=reason):
            payload = resilience.snapshot_engine(self, reason)
            fp = write_checkpoint(path, payload)
        self.stats.n_checkpoints += 1
        self._metrics.counter("serve.checkpoints_written").inc()
        self.tracer.event("ckpt.written", cat="ckpt", path=path,
                          reason=reason, round=self._round, fingerprint=fp)
        return path

    @classmethod
    def restore(cls, source, families: dict[str, Any] | None = None,
                **kwargs) -> "ServeEngine":
        """Rebuild an engine mid-trace from a checkpoint path (or verified
        payload dict); ``run()`` then resumes where the snapshot left off.
        See ``resilience.restore_engine`` for the keyword overrides."""
        from . import resilience
        return resilience.restore_engine(source, families, **kwargs)

    def lose_shard(self, shard: int) -> None:
        raise _not_ported("lose_shard()", SHARDING)

    def regrow_shard(self) -> None:
        raise _not_ported("regrow_shard()", SHARDING)

    # -- fault boundaries ----------------------------------------------------

    def _validate(self, req: ServeRequest) -> str | None:
        """Admission gate: returns an error detail for unservable requests
        (scheduler routes them to ``plan.invalid``). A crash inside
        validation itself must not take the engine down either."""
        try:
            return validate_request(req, self.family(req.family).impls)
        except Exception as exc:
            return f"validation raised {exc!r}"

    def _fail(self, req: ServeRequest, code: str, detail: str,
              status: str = FAILED) -> None:
        """Move a request to a terminal failure status, reclaim its slot,
        and count it — the request-level containment primitive."""
        req.mark(status, code, detail, round_=self._round)
        req.done_round = self._round
        req.t_done = time.perf_counter()
        if status == TIMED_OUT:
            self.stats.requests_timed_out += 1
            self._metrics.counter("serve.requests_timed_out").inc()
            kind = "req.timed_out"
        else:
            self.stats.requests_failed += 1
            self._metrics.counter("serve.requests_failed").inc()
            kind = "req.failed"
        self.tracer.event(kind, cat="req", rid=req.rid, family=req.family,
                          code=code, round=self._round)
        if self._flight is not None:
            # Terminal failure => post-mortem dump of the trailing rounds.
            self._flight.dump(self.tracer, kind.split(".", 1)[1],
                              rid=req.rid, family=req.family, code=code,
                              detail=detail, round=self._round)
        if req.family == "lm":
            self.scheduler.evict(req)

    def _expired(self, req: ServeRequest) -> bool:
        return req.deadline is not None and self._now > req.deadline

    def _timeout(self, req: ServeRequest) -> None:
        self._fail(req, DEADLINE_EXCEEDED,
                   f"deadline {req.deadline} passed at virtual time "
                   f"{self._now}", status=TIMED_OUT)

    def _enforce_deadlines(self) -> None:
        """Round-boundary SLO check on every in-flight or slot-waiting
        request. Timed-out lm requests keep the tokens generated so far
        (partial results) and release their slot."""
        for req in [r for r in self.scheduler.active if self._expired(r)]:
            self._timeout(req)
        for req in [r for r in self.scheduler.waiting_lm
                    if self._expired(r)]:
            self._timeout(req)

    def _timeout_admitted(self, plan) -> None:
        """Requests whose deadline already passed at admission are timed
        out before any work is spent on them."""
        expired = [r for r in plan.admitted if self._expired(r)]
        if not expired:
            return
        rids = {r.rid for r in expired}
        plan.prefills = [e for e in plan.prefills
                         if e.req is None or e.req.rid not in rids]
        for fam in list(plan.singles):
            plan.singles[fam] = [r for r in plan.singles[fam]
                                 if r.rid not in rids]
            if not plan.singles[fam]:
                del plan.singles[fam]
        for req in expired:
            self._timeout(req)

    def _drain_round_budget(self) -> None:
        """Graceful drain at ``max_rounds``: every still-pending request is
        failed with a structured RoundBudgetExceeded payload."""
        pending = (list(self.scheduler.active)
                   + list(self.scheduler.waiting_lm) + self.queue.drain())
        for req in pending:
            if req.terminal or req.done:
                continue
            self._fail(req, ROUND_BUDGET_EXCEEDED,
                       f"engine drained after exceeding max_rounds="
                       f"{self.max_rounds} with the request unfinished")

    # -- the degradation ladder ----------------------------------------------

    def _exec_graph(self, fam: str, graph, params: Any = None,
                    coarse_fn=None):
        """Run one round graph down the degradation ladder; returns
        ``(result, tier)``. ``coarse_fn(count)`` (lm feed rounds only)
        rebuilds the round graph padded to a coarser count bucket — the
        async path's bridge tier while the native build is in flight.

        The primary tier (bucketed / per-topology plan) is skipped while
        its quarantine key — the bucket signature on the bucketed path, the
        topology fingerprint otherwise — is booked out; a failure (a failed
        build or capture among them) books it and the round falls to the
        interpreted ``DynamicExecutor`` floor. A success clears the key.
        Raises only if the floor itself fails — callers then isolate per
        request."""
        ex = self._executor(fam)   # also seeds self._exec_stats[fam]
        pol = self.policy_for(fam)
        es = self._exec_stats[fam]
        tier = self._primary_tier()
        if tier == "bucketed" and self._compiler is not None:
            return self._exec_graph_async(fam, ex, pol, es, graph, params,
                                          coarse_fn)
        if tier != "interpreted":
            qkey = None
            try:
                qkey = ((fam, ex.pack_for(graph, pol, es).spec)
                        if tier == "bucketed"
                        else (fam, graph.topology_key()))
                if not self.quarantine.blocks(qkey, self._round):
                    if self._injector is not None:
                        self._injector.on_exec(self._round, tier)
                    res = ex.run(graph, pol, es, params=params)
                    self.quarantine.clear(qkey)
                    return res, tier
            except Exception as exc:
                if qkey is not None:
                    self.quarantine.record_failure(qkey, self._round, exc)
                self._contained()
        res = self._interp_executor(fam).run(graph, pol, es, params=params)
        return res, "interpreted"

    # -- async tier selection -------------------------------------------------

    def _exec_graph_async(self, fam: str, ex, pol, es, graph,
                          params: Any = None, coarse_fn=None):
        """Non-blocking counterpart of the primary-tier branch: the serve
        loop only *probes* caches — every piece of lowering (schedule,
        pack, build and capture) runs on the compile service's workers.
        Ready native bucket -> ``bucketed``; not ready -> submit the build
        and bridge through a coarser already-built bucket (``coarse``), else
        the interpreted floor. The first bucketed round after degraded ones
        is the hot-swap."""
        jobsig = _sig_digest(("cjob", fam, graph.topology_key(),
                              policy_cache_key(pol)))
        pack = ex.pack_ready(graph, pol)
        blocked = (pack is not None
                   and self.quarantine.blocks((fam, pack.spec), self._round))
        if pack is not None and not blocked:
            qkey = (fam, pack.spec)
            if ex.executable_ready(pack, params):
                try:
                    if self._injector is not None:
                        self._injector.on_exec(self._round, "bucketed")
                    res = ex.run_packed(graph, pack, es, params=params)
                    self.quarantine.clear(qkey)
                    self._note_hotswap(jobsig, fam)
                    return res, "bucketed"
                except Exception as exc:
                    self.quarantine.record_failure(qkey, self._round, exc)
                    self._contained()
                    res = self._interp_executor(fam).run(graph, pol, es,
                                                         params=params)
                    return res, "interpreted"
        if not blocked:
            # This round serves degraded while the build is in flight:
            # remember the sig so its first bucketed round counts as a
            # hot-swap (submission itself dedupes inside the service).
            self._submit_compile_job(fam, ex, pol, graph, jobsig, params)
            self._awaiting.add(jobsig)
            cres = self._try_coarse(fam, ex, pol, es, graph, params,
                                    coarse_fn)
            if cres is not None:
                return cres, "coarse"
        res = self._interp_executor(fam).run(graph, pol, es, params=params)
        return res, "interpreted"

    def _try_coarse(self, fam: str, ex, pol, es, graph, params, coarse_fn):
        """Bridge tier: re-pad this round into a *coarser count bucket*
        whose graph already exists. ``coarse_fn(count)`` rebuilds the round
        graph padded to ``count`` entries (real entries keep their node ids,
        dummies append), so a count-8 round can ride a count-16 or count-32
        graph captured earlier (by a bigger round, a warm start, or a
        restore). Pure cache probes on the loop: a pack that was never built
        is simply a miss — no lowering happens here."""
        if coarse_fn is None:
            return None
        count = len(graph) // 4
        for mult in (2, 4):
            cg = coarse_fn(count * mult)
            if cg is None:
                continue
            cpack = ex.pack_ready(cg, pol)
            if cpack is None or not ex.executable_ready(cpack, params):
                continue
            ckey = (fam, cpack.spec)
            if self.quarantine.blocks(ckey, self._round):
                continue
            try:
                if self._injector is not None:
                    self._injector.on_exec(self._round, "coarse")
                res = ex.run_packed(cg, cpack, es, params=params)
                self.quarantine.clear(ckey)
                return res
            except Exception as exc:
                self.quarantine.record_failure(ckey, self._round, exc)
                self._contained()
                return None
        return None

    def _submit_compile_job(self, fam: str, ex, pol, graph, jobsig: str,
                            params: Any, kind: str = "bucketed") -> bool:
        """Queue the background build for ``graph``'s native bucket. The
        job closure owns *all* lowering: schedule + pack (host-side), then
        ``build_executable`` (on the card the eager warm-up and the CUDA
        graph capture, under the process-wide build lock); it returns the
        total background seconds for ``lower_bg_s``."""
        if self._compiler is None or self._compiler.in_flight(jobsig):
            return False
        describe = {}
        if fam == "lm" and len(graph) % 4 == 0:
            # Feed-round topology is determined by the padded entry count
            # alone (an R,E,C,O fragment per entry) — that one number is a
            # re-submittable descriptor for checkpoints and warmsets.
            describe = {"family": "lm", "count": len(graph) // 4}

        def build(job, span_args, abort):
            scratch = ExecStats()
            pack = ex.pack_for(graph, pol, scratch)
            # From here on failures quarantine the same key the dispatch
            # path checks.
            job.qkey = (fam, pack.spec)
            _, _, dt = ex.build_executable(pack, params,
                                           span_args=span_args,
                                           abort_check=abort)
            return scratch.lower_time + dt

        return self._compiler.submit(jobsig, build, family=fam, kind=kind,
                                     describe=describe)

    def _note_hotswap(self, jobsig: str | None, fam: str) -> None:
        """First bucketed round after degraded ones counts as a hot-swap
        (single site shared by the serial and pipelined paths)."""
        if jobsig is None or jobsig not in self._awaiting:
            return
        self._awaiting.discard(jobsig)
        self.stats.n_hotswaps += 1
        self._metrics.counter("compile.hotswaps").inc()
        self.tracer.event("compile.hotswap", cat="compile", sig=jobsig,
                          family=fam, round=self._round)

    # -- warm starts ----------------------------------------------------------

    def warmset(self) -> dict:
        """Bucket signatures seen by this engine as a re-submittable
        warm-start descriptor set (persisted in the launcher's cache
        directory; see ``launch/cache.py``). Only lm feed rounds are
        recorded: their topology is the padded entry count alone, so one
        integer rebuilds the graph and the build job. A CUDA graph cannot
        outlive its process, so a warm start captures these again."""
        return {"version": 1,
                "families": {"lm": {"counts": sorted(self._seen_lm_counts)}}}

    def prewarm(self, warmset: dict | None) -> int:
        """Pre-submit build jobs for previously seen bucket signatures (a
        ``warmset()`` payload or a checkpoint's in-flight descriptors).
        Returns the number of jobs submitted; no-op without the async
        service."""
        if self._compiler is None or not warmset:
            return 0
        counts = (warmset.get("families", {})
                  .get("lm", {}).get("counts", []))
        n = 0
        for c in counts:
            n += self._prewarm_lm(int(c))
        return n

    def _prewarm_lm(self, count: int) -> int:
        if count < 1:
            return 0
        # An all-dummy feed graph of ``count`` fragments has the same
        # topology — hence bucket signature — as any real round of that
        # padded entry count.
        g, _ = build_lm_feed_round_graph(RoundPlan(), count=count)
        if g is None:
            return 0
        ex = self._executor("lm")
        pol = self.policy_for("lm")
        params = {"slots": self._lm_pool()}
        self._seen_lm_counts.add(count)
        pack = ex.pack_ready(g, pol)
        if pack is not None and ex.executable_ready(pack, params):
            return 0
        jobsig = _sig_digest(("cjob", "lm", g.topology_key(),
                              policy_cache_key(pol)))
        return int(self._submit_compile_job("lm", ex, pol, g, jobsig,
                                            params, kind="warm"))

    # -- round pipelining ----------------------------------------------------
    #
    # While round t's bucket program is in flight on the device, the host
    # plans and packs round t+1. Completions, deadlines, and slot assignment
    # all depend only on host-side counters — never on token *values* — so
    # round t+1's plan is a pure function of state known at dispatch time
    # *unless* commit t completes a request or times one out. Speculation
    # bails out on any such prediction: a promoted plan is exactly the plan
    # the serial loop would have built.

    def _expired_at(self, req, now: float) -> bool:
        return req.deadline is not None and now > req.deadline

    def _spec_snapshot(self) -> tuple:
        q, s = self.queue, self.scheduler
        return (list(q._heap), list(s.active), dict(s.slot_of),
                [list(d) for d in s._free], list(s.waiting_lm))

    def _restore_spec_snapshot(self, snap: tuple, feed_undo: list) -> None:
        heap, active, slot_of, free, waiting = snap
        q, s = self.queue, self.scheduler
        q._heap[:] = heap
        s.active[:] = active
        s.slot_of.clear()
        s.slot_of.update(slot_of)
        for d, vals in zip(s._free, free):
            d.clear()
            d.extend(vals)
        s.waiting_lm.clear()
        s.waiting_lm.extend(waiting)
        for req, feed, n_fed in feed_undo:
            req.feed = feed
            req.n_fed = n_fed

    def _cancel_spec(self) -> None:
        """Roll back the speculative round t+1 pack (round-t failure, stale
        prediction, drain boundary)."""
        spec, self._spec = self._spec, None
        if spec is None:
            return
        self._restore_spec_snapshot(spec.snap, spec.feed_undo)
        self.stats.n_spec_cancelled += 1
        self.tracer.event("round.spec_cancelled", cat="round",
                          round=spec.round)

    def drain_inflight(self) -> None:
        """Quiesce cross-round in-flight state before an external observer
        reads the engine: the speculative next-round pack rolls back."""
        self._cancel_spec()

    def _speculate_next(self, plan: RoundPlan, entries: list) -> None:
        """Plan and pack round t+1 while round t is in flight. Bails (no
        speculation) when commit t could reshape the plan: a predicted
        completion frees a slot; an expired deadline evicts. ``entries`` is
        round t's live entry list — its counters predict commit t
        exactly."""
        if self._spec is not None:
            self._cancel_spec()
        for e in entries:
            req = e.req
            fed_only = (req.feed is not None
                        and req.n_fed + 1 < len(req.feed))
            if not fed_only and len(req.out) + 1 >= req.max_new:
                return
        round1 = self._round + 1
        delay = (self._injector.round_delay(self._round)
                 if self._injector is not None else 0.0)
        now1 = max(self._now + delay + 1.0, float(round1))
        sched = self.scheduler
        for req in list(sched.active) + list(sched.waiting_lm):
            if self._expired_at(req, now1):
                return
        snap = self._spec_snapshot()
        feed_undo: list = []
        try:
            with self.tracer.span("round.schedule", overlap=True,
                                  round=round1):
                nplan = sched.plan_round(self.queue, now1,
                                         validate=self._validate)
            for e in nplan.prefills:
                if e.req is not None and e.req.park:
                    raise _SpecUnsafe  # park restore has pool side effects
            for req in nplan.admitted:
                if self._expired_at(req, now1):
                    raise _SpecUnsafe  # serial would timeout-at-admission
            with self.tracer.span("round.pack", overlap=True, round=round1):
                for e in nplan.prefills:
                    req = e.req
                    if req is None or req.feed is not None:
                        continue
                    # build_lm_feed_round_graph reads the next feed token,
                    # so fresh prefills need their padded prompt staged now
                    # (recorded for rollback; _start_feed re-runs this
                    # idempotently at promotion).
                    feed_undo.append((req, req.feed, req.n_fed))
                    Lb = bucket_len(len(req.prompt),
                                    sched.prefill_bucket_min)
                    req.feed = ([0] * (Lb - len(req.prompt))
                                + list(req.prompt))
                    req.n_fed = 0
                graph, nentries = build_lm_feed_round_graph(nplan)
                if graph is not None and self._compiler is None:
                    # Warm the host-side pack (index vectors, bucket spec)
                    # now — at promotion the dispatch hits the plan cache.
                    # With the async service the workers own all lowering,
                    # so the loop keeps to pure cache probes.
                    ex = self._executor("lm")
                    ex.pack_for(graph, self.policy_for("lm"),
                                self._exec_stats["lm"])
        except _SpecUnsafe:
            self._restore_spec_snapshot(snap, feed_undo)
            return
        except Exception:
            # A planner/packer crash here would hit the serial loop too —
            # roll back and let round t+1 reproduce it on-loop, where the
            # normal containment ladder owns it.
            self._restore_spec_snapshot(snap, feed_undo)
            return
        self._spec = _Speculation(round1, now1, nplan, graph,
                                  list(nentries), snap, feed_undo)
        self.stats.n_overlapped_packs += 1

    def _promote_spec(self) -> RoundPlan | None:
        """Commit-boundary guard: hand the speculative plan to step() iff
        the world still matches the prediction. Anything else rolls back
        and round t+1 plans serially."""
        spec, self._spec = self._spec, None
        if spec is None:
            return None
        sched = self.scheduler
        stale = (spec.round != self._round or spec.now != self._now
                 or any(e.req.terminal for e in spec.entries)
                 or any(self._expired(r) for r in sched.active)
                 or any(self._expired(r) for r in sched.waiting_lm))
        if stale:
            self._restore_spec_snapshot(spec.snap, spec.feed_undo)
            self.stats.n_spec_cancelled += 1
            self.tracer.event("round.spec_cancelled", cat="round",
                              round=spec.round)
            return None
        self._promoted = (spec.graph, spec.entries)
        self.tracer.event("round.spec_promoted", cat="round",
                          round=spec.round, n=len(spec.entries))
        return spec.plan

    def _refresh_feed_aux(self, graph, entries) -> None:
        """Re-stamp each entry's embed-node token: the speculative pack ran
        before commit t, so decode entries' aux still holds the *previous*
        token. Topology keys hash only (type, inputs), so the pack and
        executable caches keyed off this graph are untouched."""
        for e in entries:
            # Fragment layout is R,E,C,O: the embed node precedes the cell.
            graph.nodes[e.cell_node - 1].attrs["aux"] = next_feed_token(e.req)

    def _dispatch_lm(self, graph, pool, coarse_fn):
        """Non-blocking counterpart of ``_exec_graph`` for the lm feed
        round: returns ``(handle, tier, qkey, jobsig)`` where ``handle``
        is in flight for real bucketed dispatches and pre-resolved
        (``_ReadyRound``) for the coarse and interpreted tiers, or ``None``
        when even the floor failed. Quarantine *clearing* and hot-swap
        accounting move to commit — a dispatch is not a success until its
        results materialize."""
        fam = "lm"
        ex = self._executor(fam)
        pol = self.policy_for(fam)
        es = self._exec_stats[fam]
        params = {"slots": pool}
        if self._compiler is not None:
            return self._dispatch_lm_async(fam, ex, pol, es, graph, params,
                                           coarse_fn)
        qkey = None
        try:
            pack = ex.pack_for(graph, pol, es)
            qkey = (fam, pack.spec)
            if not self.quarantine.blocks(qkey, self._round):
                if self._injector is not None:
                    self._injector.on_exec(self._round, "bucketed")
                handle = ex.dispatch_packed(graph, pack, es, params=params)
                return handle, "bucketed", qkey, None
        except Exception as exc:
            if qkey is not None:
                self.quarantine.record_failure(qkey, self._round, exc)
            self._contained()
        return self._floor_handle(fam, graph, params)

    def _dispatch_lm_async(self, fam, ex, pol, es, graph, params,
                           coarse_fn):
        """Async-compile twin of ``_exec_graph_async`` that dispatches
        instead of running: ready native bucket -> in-flight handle; not
        ready -> submit the build and serve this round eagerly through the
        coarse bridge or the interpreted floor (transitional tiers — no
        overlap is lost by not pipelining them)."""
        jobsig = _sig_digest(("cjob", fam, graph.topology_key(),
                              policy_cache_key(pol)))
        pack = ex.pack_ready(graph, pol)
        blocked = (pack is not None
                   and self.quarantine.blocks((fam, pack.spec),
                                              self._round))
        if pack is not None and not blocked:
            qkey = (fam, pack.spec)
            if ex.executable_ready(pack, params):
                try:
                    if self._injector is not None:
                        self._injector.on_exec(self._round, "bucketed")
                    handle = ex.dispatch_packed(graph, pack, es,
                                                params=params)
                    return handle, "bucketed", qkey, jobsig
                except Exception as exc:
                    self.quarantine.record_failure(qkey, self._round, exc)
                    self._contained()
                    return self._floor_handle(fam, graph, params)
        if not blocked:
            self._submit_compile_job(fam, ex, pol, graph, jobsig, params)
            self._awaiting.add(jobsig)
            cres = self._try_coarse(fam, ex, pol, es, graph, params,
                                    coarse_fn)
            if cres is not None:
                return _ReadyRound(cres), "coarse", None, None
        return self._floor_handle(fam, graph, params)

    def _floor_handle(self, fam, graph, params):
        """Interpreted floor as a pre-resolved handle; ``None`` if even the
        floor raises (the caller then isolates per entry)."""
        pol = self.policy_for(fam)
        es = self._exec_stats[fam]
        try:
            res = self._interp_executor(fam).run(graph, pol, es,
                                                 params=params)
        except Exception:
            return None
        return _ReadyRound(res), "interpreted", None, None

    def _run_lm_round_pipelined(self, plan, wl, pool, graph, entries,
                                coarse_fn) -> None:
        """Two-stage round: dispatch round t without blocking, overlap the
        host-side plan+pack of round t+1 with the in-flight device work,
        then commit — block on t's arenas, scatter, feed. A commit failure
        cancels the speculation *first*, so the containment ladder and the
        re-planned round t+1 both see rolled-back state. The commit reads
        round t's arenas before round t+1 is dispatched, so a replay of the
        same graph cannot overwrite them first."""
        rd = self._dispatch_lm(graph, pool, coarse_fn)
        if rd is None:
            self._contained()
            return self._isolate_lm_round(plan, wl, True)
        handle, tier, qkey, jobsig = rd
        if self.pipeline and handle.pending:
            self._speculate_next(plan, entries)
        try:
            if self._injector is not None:
                self._injector.on_commit(self._round)
        except Exception:
            # Injected commit fault: the round's results are abandoned, the
            # speculative t+1 rolls back, entries re-run isolated. No
            # quarantine — the bucket program did nothing wrong.
            self._cancel_spec()
            self._contained()
            return self._isolate_lm_round(plan, wl, True)
        try:
            res = handle.block()
            if qkey is not None:
                self.quarantine.clear(qkey)
        except Exception as exc:
            self._cancel_spec()
            if qkey is not None:
                self.quarantine.record_failure(qkey, self._round, exc)
            self._contained()
            return self._isolate_lm_round(plan, wl, True)
        self._note_tier(tier)
        self._note_hotswap(jobsig, "lm")
        if tier == "bucketed":
            self.stats.n_pipelined_rounds += 1
        with self.tracer.span("round.scatter"):
            toks = self._scatter_commit(res, entries, wl, pool)
        with self.tracer.span("round.feed"):
            self._feed_tokens(entries, toks, time.perf_counter(),
                              self._shard_stats[0])

    def _scatter_commit(self, res, entries, wl, pool):
        """Commit one lm round's results: next-token argmax plus the state
        copy into the slot pool, in place. Dummy pads carry no entry, so
        their slot-0 reads are never written back. Plan-backed results
        expose their arenas (``PlanResult.arena_rows``); the interpreted
        floor's ``ExecResult`` takes the per-field path."""
        o_ids = [e.o_node for e in entries]
        cell_ids = [e.cell_node for e in entries]
        slots = np.asarray([e.slot for e in entries], np.int32)
        fields = list(wl.state_fields)
        if hasattr(res, "arena_rows"):
            y_arena, y_rows = res.arena_rows("y", o_ids)
            arenas, rows = [], []
            for f in fields:
                a, r = res.arena_rows(f, cell_ids)
                arenas.append(a)
                rows.append(r)
            return _fused_commit(y_arena, y_rows, slots, arenas, rows,
                                 [pool[f] for f in fields])
        toks = torch.argmax(res.field("y", o_ids), dim=-1).cpu().numpy()
        slot_ix = torch.as_tensor(slots.astype(np.int64),
                                  device=pool[fields[0]].device)
        for f in fields:
            pool[f].index_copy_(0, slot_ix, res.field(f, cell_ids))
        return toks

    # -- per-family round execution -----------------------------------------

    def _start_feed(self, plan, wl, pool) -> None:
        """Token-level (iteration) scheduling setup: fresh requests zero
        their slot and will feed the padded prompt one token per round
        through the same decode fragment every request uses — the round
        topology depends only on the padded entry count, so the whole lm
        lifetime runs through one or two bucket signatures."""
        if not plan.prefills:
            return
        fresh = [e for e in plan.prefills if not e.req.park]
        parked = [e for e in plan.prefills if e.req.park]
        for e in fresh:
            req = e.req
            Lb = bucket_len(len(req.prompt),
                            self.scheduler.prefill_bucket_min)
            req.feed = ([0] * (Lb - len(req.prompt)) + list(req.prompt))
            req.n_fed = 0
        if fresh:
            # One batched zeroing per state field, in place.
            slots = np.asarray([e.slot for e in fresh], np.int32)
            _fused_zero(slots, [pool[f] for f in wl.state_fields])
        for e in parked:
            state, e.req.park = e.req.park, None
            for f in wl.state_fields:
                pool[f][e.slot].copy_(torch.as_tensor(np.asarray(state[f])))

    def _feed_tokens(self, entries, toks, now: float, st: ServeStats) -> None:
        for e, tok in zip(entries, toks):
            req = e.req
            if req.feed is not None and req.n_fed < len(req.feed):
                # Prefill round: logits only matter after the last prompt
                # token has been fed.
                req.n_fed += 1
                if req.n_fed < len(req.feed):
                    continue
            if not req.out:
                req.t_first = now
                self.tracer.event("req.ttft", cat="req", rid=req.rid,
                                  round=self._round)
            req.out.append(int(tok))
            st.tokens_out += 1
            self._metrics.counter("serve.tokens_out").inc()
            if req.done:
                self._finish(req, now, st)

    def _run_lm_round(self, plan) -> None:
        wl = self.family("lm")
        pool = self._lm_pool()
        feed_mode = self.compiled and self.bucketed
        promoted, self._promoted = self._promoted, None
        if promoted is not None:
            # The graph was packed during round t-1's in-flight dispatch;
            # only the cheap residue runs on-loop: slot zeroing for fresh
            # prefills and re-stamping feed tokens that round t-1's argmax
            # decided.
            graph, entries = promoted
            with self.tracer.span("round.feed_stage"):
                self._start_feed(plan, wl, pool)
            with self.tracer.span("round.pack", promoted=True):
                if graph is not None:
                    self._refresh_feed_aux(graph, entries)
                    self._seen_lm_counts.add(len(graph) // 4)
        else:
            if feed_mode:
                with self.tracer.span("round.feed_stage"):
                    self._start_feed(plan, wl, pool)
            with self.tracer.span("round.pack"):
                if feed_mode:
                    graph, entries = build_lm_feed_round_graph(plan)
                    if graph is not None:
                        # Padded entry count (4 nodes per R,E,C,O
                        # fragment): the warmset descriptor for this
                        # round's signature.
                        self._seen_lm_counts.add(len(graph) // 4)
                else:
                    graph = build_lm_round_graph(
                        plan,
                        prefill_bucket_min=self.scheduler
                        .prefill_bucket_min)
                    entries = [e for e in plan.prefills + plan.decodes
                               if e.req is not None]
        if graph is None:
            return
        coarse_fn = None
        if feed_mode and self._compiler is not None:
            # Bridge-tier rebuild: the same plan padded to a coarser count
            # bucket (real entries keep their node ids, dummies append), so
            # the scatter below reads the same o/cell nodes either way.
            def coarse_fn(count):
                return build_lm_feed_round_graph(plan, count=count)[0]
        if self.pipeline and feed_mode:
            return self._run_lm_round_pipelined(plan, wl, pool, graph,
                                                entries, coarse_fn)
        try:
            res, tier = self._exec_graph("lm", graph,
                                         params={"slots": pool},
                                         coarse_fn=coarse_fn)
            if self._injector is not None:
                # Commit-fault parity with the pipelined path: the serial
                # loop's commit boundary sits right after execution.
                self._injector.on_commit(self._round)
        except Exception:
            # Even the interpreted floor failed on the merged graph:
            # isolate per entry so one bad request cannot starve the rest.
            self._contained()
            return self._isolate_lm_round(plan, wl, feed_mode)
        self._note_tier(tier)
        with self.tracer.span("round.scatter"):
            toks = self._scatter_commit(res, entries, wl, pool)
        with self.tracer.span("round.feed"):
            self._feed_tokens(entries, toks, time.perf_counter(),
                              self._shard_stats[0])

    def _isolate_lm_round(self, plan, wl, feed_mode: bool) -> None:
        """Request-level lm isolation: re-run this round one live entry at
        a time on the interpreted floor. Entries that still fail are marked
        FAILED and evicted; the rest decode normally."""
        pool = self._lm_pool()
        self._executor("lm")   # seeds self._exec_stats["lm"]
        iex = self._interp_executor("lm")
        pol = self.policy_for("lm")
        es = self._exec_stats["lm"]
        self._note_tier("interpreted")
        for role, src in (("prefill", plan.prefills),
                          ("decode", plan.decodes)):
            for e in src:
                if e.req is None:
                    continue
                sub = RoundPlan()
                (sub.prefills if role == "prefill"
                 else sub.decodes).append(e)
                try:
                    if feed_mode:
                        g, _ = build_lm_feed_round_graph(sub)
                    else:
                        g = build_lm_round_graph(
                            sub,
                            prefill_bucket_min=self.scheduler
                            .prefill_bucket_min)
                    res = iex.run(g, pol, es, params={"slots": pool})
                    tok = torch.argmax(res.field("y", [e.o_node]),
                                       dim=-1).cpu().numpy()
                    slot = torch.as_tensor([e.slot], dtype=torch.int64,
                                           device=pool[wl.state_fields[0]]
                                           .device)
                    for f in wl.state_fields:
                        pool[f].index_copy_(0, slot,
                                            res.field(f, [e.cell_node]))
                    self._feed_tokens([e], tok, time.perf_counter(),
                                      self._shard_stats[0])
                except Exception as exc:
                    self._fail(e.req, EXEC_ERROR,
                               f"isolated lm round failed: {exc!r}")

    def _run_single_shot(self, fam: str, reqs: list[ServeRequest]) -> None:
        if not reqs:
            return
        graph, out_ids = merge_request_graphs(reqs)
        try:
            res, tier = self._exec_graph(fam, graph)
        except Exception:
            self._contained()
            return self._isolate_single_shot(fam, reqs)
        self._note_tier(tier)
        now = time.perf_counter()
        st = self._shard_stats[0]
        for req, ids in zip(reqs, out_ids):
            req.result = res.field("y", ids).cpu().numpy()
            req.t_first = now
            st.outputs_out += len(ids)
            self._finish(req, now, st)

    def _isolate_single_shot(self, fam: str, reqs: list[ServeRequest],
                             st: ServeStats | None = None) -> None:
        """Last-resort per-request execution on the interpreted floor: one
        failing request in a merged wave graph must not take the round's
        other requests with it."""
        st = st if st is not None else self._shard_stats[0]
        self._executor(fam)    # seeds self._exec_stats[fam]
        iex = self._interp_executor(fam)
        pol = self.policy_for(fam)
        es = self._exec_stats[fam]
        self._note_tier("interpreted")
        for req in reqs:
            try:
                graph, out_ids = merge_request_graphs([req])
                res = iex.run(graph, pol, es)
                now = time.perf_counter()
                req.result = res.field("y", out_ids[0]).cpu().numpy()
                req.t_first = now
                st.outputs_out += len(out_ids[0])
                self._finish(req, now, st)
            except Exception as exc:
                self._fail(req, EXEC_ERROR,
                           f"isolated execution failed: {exc!r}")

    def _finish(self, req: ServeRequest, now: float,
                st: ServeStats | None = None) -> None:
        st = st if st is not None else self._shard_stats[0]
        req.status = COMPLETED
        req.done_round = self._round
        req.t_done = now
        st.requests_done += 1
        st.latency_s.append(now - req.t_admit)
        st.ttft_s.append(req.t_first - req.t_admit)
        self._metrics.counter("serve.requests_completed").inc()
        if req.family != "lm" and req.result is not None:
            self._metrics.counter("serve.outputs_out").inc(len(req.result))
        self._metrics.histogram("serve.latency_s").observe(now - req.t_admit)
        self._metrics.histogram("serve.ttft_s").observe(
            req.t_first - req.t_admit)
        self.tracer.event("req.completed", cat="req", rid=req.rid,
                          family=req.family, round=self._round,
                          tokens=len(req.out))
        if req.family == "lm":
            self.scheduler.release(req)

    # -- stats ---------------------------------------------------------------

    def _fold_exec_stats(self) -> None:
        s = self.stats
        b = self._base   # restored absolute counters (empty unless restored)
        s.requests_rejected = self.queue.rejected
        # Idempotent: absolute recompute, not accumulation.
        agg = ServeStats.merged(self._shard_stats + self._retired_shard_stats)
        s.tokens_out = agg.tokens_out
        s.outputs_out = agg.outputs_out
        s.requests_done = agg.requests_done
        s.latency_s = agg.latency_s
        s.ttft_s = agg.ttft_s
        es_all = self._exec_stats.values()
        s.n_batches = b.get("n_batches", 0) + sum(
            es.n_batches for es in es_all)
        s.n_launches = b.get("n_launches", 0) + sum(
            es.n_launches for es in es_all)
        s.n_compiles = b.get("n_compiles", 0) + sum(
            es.n_compiles for es in es_all)
        s.schedule_s = b.get("schedule_s", 0.0) + sum(
            es.schedule_time for es in es_all)
        s.exec_s = b.get("exec_s", 0.0) + sum(es.exec_time for es in es_all)
        s.lower_s = b.get("lower_s", 0.0) + sum(
            es.lower_time for es in es_all)
        # Background builds live in their own bucket: async builds never
        # touch ExecStats.lower_time (rounds only run ready graphs), so
        # lower_s stays "time the serve loop paid".
        cst = self._compiler.stats if self._compiler is not None else {}
        s.lower_bg_s = b.get("lower_bg_s", 0.0) + (
            self._compiler.total_compile_s
            if self._compiler is not None else 0.0)
        s.compile_jobs_submitted = (b.get("compile_jobs_submitted", 0)
                                    + cst.get("submitted", 0))
        s.compile_jobs_landed = (b.get("compile_jobs_landed", 0)
                                 + cst.get("landed", 0))
        s.compile_jobs_retried = (b.get("compile_jobs_retried", 0)
                                  + cst.get("retries", 0))
        s.compile_jobs_timed_out = (b.get("compile_jobs_timed_out", 0)
                                    + cst.get("timeouts", 0))
        s.compile_jobs_quarantined = (b.get("compile_jobs_quarantined", 0)
                                      + cst.get("quarantined", 0))
        s.n_graph_captures = sum(getattr(ex, "n_captures", 0)
                                 for ex in self._executors.values())
        s.n_graph_replays = sum(getattr(ex, "n_replays", 0)
                                for ex in self._executors.values())
        ph, pm, sh, sm, bh, bm = self._cache_base
        s.plan_cache_hits = (self.plan_cache.hits - ph
                             + b.get("plan_cache_hits", 0))
        s.plan_cache_misses = (self.plan_cache.misses - pm
                               + b.get("plan_cache_misses", 0))
        s.sched_cache_hits = (self.schedule_cache.hits - sh
                              + b.get("sched_cache_hits", 0))
        s.sched_cache_misses = (self.schedule_cache.misses - sm
                                + b.get("sched_cache_misses", 0))
        s.bucket_cache_hits = (self.bucket_cache.hits - bh
                               + b.get("bucket_cache_hits", 0))
        s.bucket_cache_misses = (self.bucket_cache.misses - bm
                                 + b.get("bucket_cache_misses", 0))
        # Fold-time absolutes mirror into gauges (idempotent set, not
        # accumulation) so a metrics snapshot carries the same timing
        # decomposition as ServeStats.
        m = self._metrics
        m.gauge("serve.wall_s").set(s.wall_s)
        m.gauge("serve.schedule_s").set(s.schedule_s)
        m.gauge("serve.exec_s").set(s.exec_s)
        m.gauge("serve.lower_s").set(s.lower_s)
        m.gauge("serve.lower_bg_s").set(s.lower_bg_s)
        m.gauge("serve.n_compiles").set(s.n_compiles)


def serve_trace(reqs, **engine_kwargs) -> tuple[list[ServeRequest], ServeStats]:
    """Convenience one-shot: submit ``reqs``, run to completion."""
    eng = ServeEngine(**engine_kwargs)
    reqs = list(reqs)
    eng.submit_many(reqs)
    stats = eng.run()
    return reqs, stats

"""Durable serving: snapshot and restore of a single-shard engine.

- **Checkpointing** (:func:`snapshot_engine` / :func:`restore_engine`):
  a snapshot captures the *entire* serve session — request ledger with
  partial token streams and feed progress, admission-queue heap, scheduler
  pinning tables, the LM slot pool pulled to the host (bit-exact), virtual
  clock, quarantine bookings, ServeStats, and the compile service's
  in-flight builds and warm set — so a restored engine's ``run()`` resumes
  mid-trace and, because every engine decision is deterministic given that
  state (virtual clock, argmax token feedback, deterministic injector),
  produces outputs equivalent to an uninterrupted run. The document is the
  reference's (``serve/checkpoint.py`` is a verbatim copy): a checkpoint
  written by either package restores in the other.

- A restore **copies into** the engine's slot pool and never rebinds it:
  the captured CUDA graphs read the pool at the addresses they were
  captured over. It does so before the in-flight builds are submitted
  again.

- **Elastic mesh resize** and **work stealing** move slot rows between
  shards; they come with the sharding slice and raise here.
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from typing import Any

import torch

from .checkpoint import (CheckpointError, decode_array, decode_request,
                         encode_array, encode_request, read_checkpoint)
from .engine import SHARDING, ServeEngine, ServeStats, _not_ported
from .queue import reserve_rids

# ``_fold_exec_stats`` recomputes these absolutely from live executors and
# caches, which restart from zero after a restore — so restored values
# become additive baselines in ``engine._base``.
_BASE_FIELDS = ("n_batches", "n_launches", "n_compiles", "schedule_s",
                "exec_s", "lower_s", "lower_bg_s", "plan_cache_hits",
                "plan_cache_misses", "sched_cache_hits", "sched_cache_misses",
                "bucket_cache_hits", "bucket_cache_misses",
                "n_sharded_dispatches", "n_shard_fallback_rounds",
                "compile_jobs_submitted", "compile_jobs_landed",
                "compile_jobs_retried", "compile_jobs_timed_out",
                "compile_jobs_quarantined")


def _encode_stats(st: ServeStats) -> dict:
    d: dict[str, Any] = {}
    for f in st.__dataclass_fields__:
        v = getattr(st, f)
        d[f] = dict(v) if isinstance(v, dict) else (
            list(v) if isinstance(v, list) else v)
    return d


def _decode_stats(d: dict) -> ServeStats:
    st = ServeStats()
    for f in st.__dataclass_fields__:
        if f in d:
            setattr(st, f, d[f])
    return st


# -- snapshot -----------------------------------------------------------------


def snapshot_engine(eng: ServeEngine, reason: str = "periodic") -> dict:
    """Assemble the JSON-serializable snapshot payload for ``eng``.

    Folds exec stats first so the stats section is the same absolute view
    ``run()`` would have returned; ``wall_s`` includes the elapsed wall of
    an in-progress ``run()`` (crash checkpoints fire mid-run). In-flight
    speculation drains first: a snapshot must capture committed state
    only — the rolled-back round t+1 re-plans identically after restore.
    The slot pool is copied to the host after the work queued on it."""
    eng.drain_inflight()
    eng._fold_exec_stats()
    sched = eng.scheduler
    wall = eng.stats.wall_s
    if eng._run_t0 is not None:
        wall += time.perf_counter() - eng._run_t0
    stats_doc = _encode_stats(eng.stats)
    stats_doc["wall_s"] = wall
    return {
        "reason": reason,
        "config": {
            "compiled": eng.compiled, "bucketed": eng.bucketed,
            "continuous": sched.continuous,
            "model_size": eng.model_size, "seed": eng.seed,
            "layout": eng.layout,
            "bucket_ladder": (list(eng.bucket_ladder)
                              if eng.bucket_ladder else None),
            "donate": eng.donate, "max_rounds": eng.max_rounds,
            "queue_cap": eng.queue.max_pending,
            "n_shards": eng.n_shards, "n_shards0": eng._n_shards0,
            "checkpoint_every": eng.checkpoint_every,
            "checkpoint_dir": eng.checkpoint_dir,
            "steal_threshold": eng.steal_threshold,
            "excluded_devices": list(eng._excluded_devices),
            "async_compile": eng.async_compile,
            "compile_workers": eng.compile_workers,
            "compile_timeout_s": eng.compile_timeout_s,
            "pipeline": eng.pipeline,
            "capture": eng.capture,
        },
        "clock": {"round": eng._round, "now": eng._now},
        "requests": [encode_request(eng.requests[rid])
                     for rid in sorted(eng.requests)],
        "queue": {"pending": [r.rid for r in eng.queue.pending()],
                  "submitted": eng.queue.submitted,
                  "rejected": eng.queue.rejected,
                  "duplicates": eng.queue.duplicates},
        "scheduler": {"n_shards": sched.n_shards,
                      "slots_per_shard": sched.slots_per_shard,
                      "active": [r.rid for r in sched.active],
                      "waiting": [r.rid for r in sched.waiting_lm],
                      "slot_of": {str(rid): [s, sl] for rid, (s, sl)
                                  in sched.slot_of.items()},
                      "free": [list(d) for d in sched._free]},
        "pool": ({f: encode_array(v.cpu().numpy())
                  for f, v in eng._pool.items()}
                 if eng._pool is not None else None),
        "stats": {"engine": stats_doc,
                  "shards": [_encode_stats(p) for p in eng._shard_stats],
                  "retired": [_encode_stats(p)
                              for p in eng._retired_shard_stats]},
        "quarantine": eng.quarantine.state(),
        "rid_ceiling": (max(eng.requests) + 1) if eng.requests else 0,
        "resize_log": list(eng.resize_log),
        # Compile-service continuity: descriptors of builds still in flight
        # (re-submitted by restore so an interrupted capture resumes) plus
        # the seen-signature warmset. CUDA graphs themselves cannot be
        # snapshotted; this covers the *intent*.
        "compile": {
            "in_flight": (eng._compiler.pending_descriptors()
                          if eng._compiler is not None else []),
            "warm_counts": sorted(eng._seen_lm_counts),
        },
    }


# -- restore ------------------------------------------------------------------


def restore_engine(source, families: dict[str, Any] | None = None, *,
                   obs=None, fault_injector=None, mesh=None,
                   policies=None, registry=None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int | None = None,
                   steal_threshold: int | None = None,
                   async_compile: bool | None = None,
                   compile_workers: int | None = None,
                   compile_timeout_s: float | None = None,
                   device=None, capture: bool | None = None) -> ServeEngine:
    """Rebuild a :class:`ServeEngine` from a checkpoint.

    ``source`` is a checkpoint path (read + version-gated + fingerprint-
    verified) or an already-verified payload dict. ``families`` supplies
    the workload instances (weights are not checkpointed — the snapshot
    holds serving state, the model is reconstructed from config
    ``model_size``/``seed``/``layout`` when omitted). Keyword overrides
    replace the snapshotted durability config, letting a restored run
    checkpoint elsewhere or drop the crashing injector; ``device`` is the
    engine's (``None`` = CUDA) and ``capture`` defaults to the snapshot's
    (on for a checkpoint the reference wrote).

    A verification failure dumps the flight recorder (when ``obs`` wires
    one) before re-raising — the restore-mismatch post-mortem."""
    if isinstance(source, str):
        try:
            payload = read_checkpoint(source)
        except CheckpointError as e:
            if obs is not None and obs.flight is not None:
                tr = obs.tracer
                tr.event("ckpt.restore_mismatch", cat="ckpt", path=source,
                         error=str(e))
                obs.flight.dump(tr, "restore_mismatch", path=source,
                                error=str(e))
            raise
    else:
        payload = source

    cfg = payload["config"]
    sd = payload["scheduler"]
    spp = int(sd["slots_per_shard"])
    k = int(cfg["n_shards"])
    eng = ServeEngine(
        families,
        compiled=cfg["compiled"], bucketed=cfg["bucketed"],
        continuous=cfg["continuous"],
        max_slots=spp * k,
        model_size=cfg["model_size"], seed=cfg["seed"], layout=cfg["layout"],
        bucket_ladder=(tuple(cfg["bucket_ladder"])
                       if cfg["bucket_ladder"] else None),
        donate=cfg["donate"], max_rounds=cfg["max_rounds"],
        queue_cap=cfg["queue_cap"], n_shards=k, mesh=mesh,
        policies=policies, registry=registry,
        fault_injector=fault_injector, obs=obs,
        checkpoint_dir=(checkpoint_dir if checkpoint_dir is not None
                        else cfg["checkpoint_dir"]),
        checkpoint_every=(checkpoint_every if checkpoint_every is not None
                          else cfg["checkpoint_every"]),
        steal_threshold=(steal_threshold if steal_threshold is not None
                         else cfg["steal_threshold"]),
        async_compile=(async_compile if async_compile is not None
                       else cfg.get("async_compile", False)),
        compile_workers=(compile_workers if compile_workers is not None
                         else cfg.get("compile_workers", 2)),
        compile_timeout_s=(compile_timeout_s if compile_timeout_s is not None
                           else cfg.get("compile_timeout_s", 30.0)),
        pipeline=cfg.get("pipeline", True), device=device,
        capture=(capture if capture is not None
                 else cfg.get("capture", True)))
    with eng.tracer.span("ckpt.restore", round=payload["clock"]["round"],
                         reason=payload.get("reason", "")):
        eng._n_shards0 = int(cfg["n_shards0"])
        eng._excluded_devices = list(cfg["excluded_devices"])

        # Request ledger first — queue/scheduler sections reference it by
        # rid. Reserving the rid ceiling makes post-restore submissions
        # collision-free with replayed ones.
        for d in payload["requests"]:
            req = decode_request(d)
            eng.requests[req.rid] = req
        reserve_rids(int(payload["rid_ceiling"]))

        q = eng.queue
        for rid in payload["queue"]["pending"]:
            r = eng.requests[rid]
            heapq.heappush(q._heap, (r.arrival, r.rid, r))
        # Seed dedupe with *every* ledger rid (not just pending): a client
        # replaying its whole trace after restore must not double-admit.
        q._seen = set(eng.requests)
        q.submitted = int(payload["queue"]["submitted"])
        q.rejected = int(payload["queue"]["rejected"])
        q.duplicates = int(payload["queue"]["duplicates"])

        sched = eng.scheduler
        sched.slot_of = {int(rid): (int(v[0]), int(v[1]))
                         for rid, v in sd["slot_of"].items()}
        sched._free = [deque(int(s) for s in fr) for fr in sd["free"]]
        sched.active = [eng.requests[rid] for rid in sd["active"]]
        sched.waiting_lm = deque(eng.requests[rid] for rid in sd["waiting"])

        if payload["pool"] is not None:
            # In place: the engine's graphs read its own pool's addresses.
            pool = eng._lm_pool()
            for f, d in payload["pool"].items():
                pool[f].copy_(torch.from_numpy(decode_array(d)))

        sdoc = payload["stats"]
        eng.stats = _decode_stats(sdoc["engine"])
        eng._shard_stats = [_decode_stats(p) for p in sdoc["shards"]]
        eng._retired_shard_stats = [_decode_stats(p)
                                    for p in sdoc["retired"]]
        eng._base = {f: getattr(eng.stats, f) for f in _BASE_FIELDS}

        eng.quarantine.load_state(payload["quarantine"])
        eng._round = int(payload["clock"]["round"])
        eng._now = float(payload["clock"]["now"])
        eng.resize_log = list(payload["resize_log"])

        # Resume compile-service intent: the warmset reseeds the
        # seen-signature record, and builds that were in flight at snapshot
        # time are re-submitted (as warm jobs — the hot-swap ledger restarts
        # with the new service) so the interrupted work resumes before the
        # first post-restore round.
        cdoc = payload.get("compile", {})
        eng._seen_lm_counts.update(int(c)
                                   for c in cdoc.get("warm_counts", []))
        resub = sorted({int(d["count"]) for d in cdoc.get("in_flight", [])
                        if d.get("family") == "lm" and "count" in d})
        if resub:
            eng.prewarm({"families": {"lm": {"counts": resub}}})

        # Wall-clock stamps are process-local; rebase live requests' admit
        # and first-token times to "now" so post-restore latency samples
        # measure this process's wall, not a meaningless cross-process
        # difference. (Round-based accounting is untouched.)
        t = time.perf_counter()
        for req in eng.requests.values():
            if not req.terminal:
                if req.admit_round >= 0:
                    req.t_admit = t
                if req.out:
                    req.t_first = t
    eng.stats.n_restores += 1
    eng._metrics.counter("serve.restores").inc()
    eng.tracer.event("ckpt.restored", cat="ckpt", round=eng._round,
                     reason=payload.get("reason", ""))
    return eng


# -- the sharding slice -------------------------------------------------------


def resize_mesh(eng: ServeEngine, new_k: int,
                dead_shard: int | None = None) -> dict:
    raise _not_ported("resize_mesh()", SHARDING)


def steal_work(eng: ServeEngine, threshold: int) -> int:
    raise _not_ported("steal_work()", SHARDING)

"""Durable elastic serving: snapshot/restore, mesh resize, work stealing.

- **Checkpointing** (:func:`snapshot_engine` / :func:`restore_engine`):
  a snapshot captures the *entire* serve session — request ledger with
  partial token streams and feed progress, admission-queue heap, scheduler
  pinning tables, the (per-shard) LM slot pool pulled to the host
  (bit-exact), virtual
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
  again. A K-shard snapshot (and one taken on a shrunken mesh) restores
  into the stacked pool made for the configured replica count, or into
  the per-card pools of the restored mesh's cards: the snapshot's rows
  are in shard order and name no card, and the placement is the restoring
  engine's (``placement``, ``devices``), not the snapshot's.

- **Elastic mesh resize** (:func:`resize_mesh`): a lost replica's
  slot-pinned lm entries evacuate into survivors — one slot-row copy each
  — and the sharded executor rebuilds lazily over a K-1 mesh
  (``BucketSpec`` keys on ``n_shards``). Entries that don't fit a
  survivor's free slots are *parked*: their state rides on the request
  (``req.park``) and re-enters the pool, fully resumed, when a slot frees
  up. Recovery re-grows the mesh by the same path. The new layout is
  written into the same stacked pool in place, so the graphs captured at
  the old replica count replay again when the mesh grows back to it. Per
  card the layout goes through the host and lands in the new mesh's
  cards' own pools (each card's pool made once, so its graphs replay
  again too); a grown card's pool starts from the workload's initial
  state.

- **Work stealing** (:func:`steal_work`): the same one-row migration,
  triggered by a load-imbalance threshold instead of a death — the
  most-loaded shard's youngest request moves to the lightest shard with a
  free slot until the spread closes. Per card the row is copied between
  the two cards, after the source card's queued work (``Tensor.copy_``
  between cards orders itself against both cards' current streams).
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.plan import PerCard

from .checkpoint import (CheckpointError, decode_array, decode_request,
                         encode_array, encode_request, read_checkpoint)
from .engine import ServeEngine, ServeStats
from .queue import reserve_rids

# ``_fold_exec_stats`` recomputes these absolutely from live executors and
# caches, which restart from zero after a restore (and lose dispatch
# counters after a resize rebuild) — so restored values become additive
# baselines in ``engine._base``.
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


def _pool_rows(eng: ServeEngine) -> dict[str, np.ndarray] | None:
    """The slot pool on the host, ``(K, slots_per_shard, h)`` a field in
    shard order, whatever the placement (after the work queued on it)."""
    if eng._pool is None:
        return None
    out = {}
    for f, v in eng._pool.items():
        if isinstance(v, PerCard):
            out[f] = np.stack([t.cpu().numpy() for t in v])
        else:
            out[f] = v.cpu().numpy()
            if eng.n_shards == 1:
                out[f] = out[f][None]
    return out


def _load_pool(eng: ServeEngine, rows: dict[str, np.ndarray]) -> None:
    """Copy ``(K, slots_per_shard, h)`` rows into the engine's pool at its
    current K, in place (per card, each shard's rows onto its card)."""
    for f, v in rows.items():
        dst = eng._pool[f]
        if isinstance(dst, PerCard):
            for t, row in zip(dst, v):
                t.copy_(torch.from_numpy(row))
        else:
            dst.copy_(torch.from_numpy(v[0] if eng.n_shards == 1 else v))


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
    rows = _pool_rows(eng)
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
        # the reference's layout: (K, slots, h), one shard's (slots, h)
        "pool": ({f: encode_array(v[0] if eng.n_shards == 1 else v)
                  for f, v in rows.items()} if rows is not None else None),
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
                   device=None, capture: bool | None = None,
                   placement: str = "stacked",
                   devices=None) -> ServeEngine:
    """Rebuild a :class:`ServeEngine` from a checkpoint.

    ``source`` is a checkpoint path (read + version-gated + fingerprint-
    verified) or an already-verified payload dict. ``families`` supplies
    the workload instances (weights are not checkpointed — the snapshot
    holds serving state, the model is reconstructed from config
    ``model_size``/``seed``/``layout`` when omitted). Keyword overrides
    replace the snapshotted durability config, letting a restored run
    checkpoint elsewhere or drop the crashing injector; ``device`` is the
    engine's (``None`` = CUDA) and ``capture`` defaults to the snapshot's
    (on for a checkpoint the reference wrote). ``placement`` and
    ``devices`` (or ``mesh``) place the restored replicas, as
    :class:`ServeEngine` takes them; the snapshot's ``excluded_devices``
    then index the restoring machine's devices.

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
                 else cfg.get("capture", True)),
        placement=placement, devices=devices)
    with eng.tracer.span("ckpt.restore", round=payload["clock"]["round"],
                         reason=payload.get("reason", "")):
        eng._n_shards0 = int(cfg["n_shards0"])
        eng._excluded_devices = list(cfg["excluded_devices"])
        if mesh is None:
            eng._mesh = None   # rebuilt over the survivors

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
            eng._lm_pool()
            rows = {f: decode_array(d) for f, d in payload["pool"].items()}
            _load_pool(eng, {f: v[None] if k == 1 else v
                             for f, v in rows.items()})

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


# -- elastic mesh resize ------------------------------------------------------


def _survivor_id(excluded: list[int], shard: int) -> int:
    """The replica id of ``shard``: the mesh over K shards takes the first K
    ids not excluded, so shard s is the s-th of those."""
    i = n = 0
    while True:
        if i not in excluded:
            if n == shard:
                return i
            n += 1
        i += 1


def _place_pool(eng: ServeEngine, new_k: int, new_host: dict) -> None:
    """Write the resized pool into the engine's stacked pool in place,
    viewed at ``new_k`` shards; only a grow past the stack's rows (or a
    first resize of an unstacked one-shard pool) makes a new stack. Per
    card, into the pools of the (already resized) mesh's cards."""
    if eng.placement == "cards":
        eng._pool = eng._pool_view(new_k)
        _load_pool(eng, new_host)
        return
    stack = eng._pool_stack
    if stack is None or next(iter(stack.values())).shape[0] < new_k:
        eng._pool_stack = {
            f: torch.empty((new_k,) + v.shape[1:], dtype=eng._pool[f].dtype,
                           device=eng._pool[f].device)
            for f, v in new_host.items()}
    eng._pool = eng._pool_view(new_k)
    for f, v in new_host.items():
        eng._pool[f].copy_(torch.from_numpy(v[0] if new_k == 1 else v))


def resize_mesh(eng: ServeEngine, new_k: int,
                dead_shard: int | None = None) -> dict:
    """Resize the serve mesh to ``new_k`` shards at a round boundary.

    Shrink (``dead_shard`` given): survivors renumber past the dead shard,
    keeping their slot coordinates; the dead shard's slot-pinned entries
    evacuate — one host-side slot-row copy each — into survivors' free
    slots, and any overflow parks its state on the request and rejoins the
    waiting line (front, preserving admission order). Grow: every current
    shard keeps its rows, the new shard starts from the workload's initial
    slot state. Executors are dropped and rebuild lazily over the new mesh
    on the next run (``slots_per_shard`` is held fixed, so bucket
    signatures differ only in ``n_shards``, and the pool keeps its
    addresses: the old-K graphs stay in the LRU for a cheap regrow).

    Returns the resize-log event dict."""
    old_k = eng.n_shards
    if new_k == old_k:
        return {}
    if dead_shard is not None and not (0 <= dead_shard < old_k):
        raise ValueError(f"dead_shard {dead_shard} out of range for "
                         f"{old_k} shards")
    sched = eng.scheduler
    spp = sched.slots_per_shard
    wl = eng.family("lm")

    if dead_shard is None:
        def mapping(s):
            return s
    else:
        def mapping(s):
            if s == dead_shard:
                return None
            return s if s < dead_shard else s - 1

    with eng.tracer.span("mesh.resize", old=old_k, new=new_k,
                         dead=(-1 if dead_shard is None else dead_shard),
                         round=eng._round):
        # Pull the pool host-side in the *old* layout (a 1-shard pool has
        # no leading shard axis — normalize to one).
        host = _pool_rows(eng)

        displaced = sched.resize(new_k, mapping)

        new_host = None
        if host is not None:
            covered = {mapping(s) for s in range(old_k)} - {None}
            base = ({f: v.cpu().numpy()
                     for f, v in wl.init_slots(spp).items()}
                    if len(covered) < new_k else None)
            new_host = {}
            for f, v in host.items():
                out = np.empty((new_k,) + v.shape[1:], v.dtype)
                for s2 in range(new_k):
                    if s2 in covered:
                        continue
                    out[s2] = base[f]
                for s in range(old_k):
                    s2 = mapping(s)
                    if s2 is not None:
                        out[s2] = v[s]
                new_host[f] = out

        evacuated, parked_reqs = 0, []
        for req, old_s, old_slot in displaced:
            dest = sched.freest_shard()
            slot = sched.take_slot(dest) if dest is not None else None
            if slot is not None:
                sched.assign(req, dest, slot)
                if new_host is not None:
                    for f in new_host:
                        new_host[f][dest, slot] = host[f][old_s, old_slot]
                evacuated += 1
                eng.tracer.event("mesh.evacuate", cat="mesh", rid=req.rid,
                                 src=old_s, dst=dest, round=eng._round)
            else:
                if host is not None:
                    req.park = {f: host[f][old_s, old_slot].copy()
                                for f in host}
                parked_reqs.append(req)
                eng.tracer.event("mesh.park", cat="mesh", rid=req.rid,
                                 src=old_s, round=eng._round)
        if parked_reqs:
            # Front of the waiting line, original order: evacuees were
            # admitted before anything still waiting.
            sched.waiting_lm.extendleft(reversed(parked_reqs))

        # Per-shard stats follow the renumbering; a dead shard's stats are
        # retired (its tokens stay in the totals), a fresh shard starts at
        # zero.
        new_stats: list[ServeStats | None] = [None] * new_k
        for s in range(old_k):
            s2 = mapping(s)
            if s2 is not None:
                new_stats[s2] = eng._shard_stats[s]
            else:
                eng._retired_shard_stats.append(eng._shard_stats[s])
        eng._shard_stats = [st if st is not None else ServeStats()
                            for st in new_stats]

        # Replica bookkeeping: the mesh over K shards uses the first K
        # non-excluded replica ids, so dead shard s maps to the s-th of
        # those.
        if dead_shard is not None:
            eng._excluded_devices.append(
                _survivor_id(eng._excluded_devices, dead_shard))
        elif eng._excluded_devices:
            eng._excluded_devices.pop()

        # Executors rebuild lazily over the new mesh; their counters fold
        # from ``_base`` so pre-resize rounds stay counted.
        for f, attr in (("n_sharded_dispatches", "n_sharded_dispatches"),
                        ("n_shard_fallback_rounds", "n_fallback_rounds"),
                        ("n_graph_captures", "n_captures"),
                        ("n_graph_replays", "n_replays")):
            eng._base[f] = eng._base.get(f, 0) + sum(
                getattr(ex, attr, 0) for ex in eng._executors.values())
        eng._executors.clear()
        eng._mesh = None
        eng.n_shards = new_k
        eng.stats.n_shards = max(eng.stats.n_shards, new_k)
        # the new layout, on the new mesh (per card: its cards' pools)
        if new_host is not None:
            _place_pool(eng, new_k, new_host)

    ev = {"round": eng._round, "old": old_k, "new": new_k,
          "dead": dead_shard, "evacuated": evacuated,
          "parked": len(parked_reqs)}
    eng.resize_log.append(ev)
    eng.stats.n_resize_events += 1
    eng.stats.n_entries_evacuated += evacuated + len(parked_reqs)
    m = eng._metrics
    m.counter("serve.resize_events").inc()
    if evacuated + len(parked_reqs):
        m.counter("serve.entries_evacuated").inc(evacuated + len(parked_reqs))
    eng.tracer.event("mesh.resized", cat="mesh", old=old_k, new=new_k,
                     dead=(-1 if dead_shard is None else dead_shard),
                     evacuated=evacuated, parked=len(parked_reqs),
                     round=eng._round)
    return ev


# -- work stealing ------------------------------------------------------------


def steal_work(eng: ServeEngine, threshold: int) -> int:
    """Round-boundary re-balance: while the most-loaded shard exceeds the
    lightest shard (with a free slot) by more than ``max(threshold, 1)``,
    move the loaded shard's youngest request over — the same one-slot-row
    migration as evacuation, in place in the stacked pool. Returns entries
    moved."""
    sched = eng.scheduler
    if sched.n_shards < 2 or eng._pool is None:
        return 0
    wl = eng.family("lm")
    pool = eng._pool
    moved = 0
    while True:
        loads = sched.shard_load()
        hi = max(range(sched.n_shards), key=lambda s: (loads[s], -s))
        cands = [s for s in range(sched.n_shards)
                 if s != hi and sched._free[s]]
        if not cands:
            break
        lo = min(cands, key=lambda s: (loads[s], s))
        # A move only narrows the spread when it exceeds 1; a bare
        # threshold=0 check would oscillate a request back and forth.
        if loads[hi] - loads[lo] <= max(threshold, 1):
            break
        victims = [r for r in sched.active
                   if sched.slot_of[r.rid][0] == hi]
        if not victims:
            break
        req = max(victims, key=lambda r: r.rid)   # youngest: least sunk work
        old_shard, old_slot = sched.slot_of.pop(req.rid)
        new_slot = sched.take_slot(lo)
        sched.slot_of[req.rid] = (lo, new_slot)
        sched._free[old_shard].append(old_slot)
        for f in wl.state_fields:
            pool[f][lo][new_slot].copy_(pool[f][old_shard][old_slot])
        moved += 1
        eng.tracer.event("mesh.steal", cat="mesh", rid=req.rid,
                         src=old_shard, dst=lo, round=eng._round)
    if moved:
        eng.stats.n_entries_stolen += moved
        eng._metrics.counter("serve.entries_stolen").inc(moved)
    return moved

"""Serving launcher: trace- or rate-driven continuous batching.

The port of the reference's ``launch/serve.py``: drives the
``repro_torch.serve`` subsystem over a synthetic (or JSON) request trace
mixing the three servable families, optionally training + persisting FSM
batching policies first, and reports throughput, batching, cache, and
latency-percentile stats. It runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --rate 4 --families lm,tree,lattice --model-size 512

    # train FSM policies per family, persist them, then serve with them
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --registry runs/registry --train-policy --requests 16

    # crash at round 8 with a checkpoint, then resume from it
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --checkpoint-dir runs/ckpt --inject-faults crash=8
    PYTHONPATH=src python -m repro_torch.launch.serve --restore runs/ckpt

The defaults are the reference's: bucketed plans (on the card each bucket
signature is captured once as a CUDA graph), async compile (the captures
run on background workers), pipelined continuous rounds, one device.
``--cache-dir DIR`` holds ``warmset.json`` (``launch/cache.py``);
``--warm-start`` captures its signatures again in the background before
the first request arrives.

Trace JSON format (``--trace``): a list of entries
``{"family": "lm", "arrival": 0.5, "prompt": [1,2,3], "max_new": 8}`` —
single-shot entries use ``{"family": "tree", "arrival": ..., "size": 8}``
(the request graph is sampled with ``size`` leaves/chars).

``--legacy-arch qwen2-0.5b`` serves one wave through the wave-by-wave
TransformerLM engine (``repro_torch.serve.lm_wave``) on the reduced config
instead. Not ported yet, and refused: ``--devices > 1`` (the sharding
slice) and ``--checkpoint`` weights for the legacy path (the training
slice).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np

from repro_torch.core.rl import RLConfig, train_fsm
from repro_torch.models.workloads import SERVE_FAMILIES, make_workload
from repro_torch.obs import FlightRecorder, Obs
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.tracer import default_tracer
from repro_torch.serve import (InjectedCrash, PolicyRegistry, ServeEngine,
                               graph_request, latest_checkpoint, lm_request,
                               synth_trace)

SHARDING = ("the sharding slice (ShardedBucketedPlanExecutor and the data "
            "mesh), which is not ported yet")
TRAINING = "the training slice (train/checkpoint.py), which is not ported yet"


def load_trace(path: str, workloads, max_new_default: int):
    rng = random.Random(0)
    reqs = []
    with open(path) as f:
        entries = json.load(f)
    for e in entries:
        fam = e["family"]
        if fam not in workloads:
            raise ValueError(
                f"trace entry family {fam!r} not in served families "
                f"{sorted(workloads)} (check --families and the trace file)")
        arrival = float(e.get("arrival", 0.0))
        if fam == "lm":
            reqs.append(lm_request(e["prompt"],
                                   int(e.get("max_new", max_new_default)),
                                   arrival))
        elif fam == "tree":
            size = int(e.get("size", 6))
            g = workloads["tree"].sample_graph(rng, 1, leaves_lo=size,
                                               leaves_hi=size)
            reqs.append(graph_request("tree", g, arrival))
        else:
            size = int(e.get("size", 8))
            g = workloads["lattice"].sample_graph(rng, 1, lo=size, hi=size)
            reqs.append(graph_request("lattice", g, arrival))
    return reqs


def train_policies(registry: PolicyRegistry, families: list[str], workloads,
                   seed: int = 0, max_iters: int = 300) -> None:
    rng = random.Random(seed)
    for fam in families:
        wl = workloads[fam]
        if fam == "lm":
            graphs = [wl.sample_graph(rng, 2, lo=4, hi=10) for _ in range(3)]
        elif fam == "tree":
            graphs = [wl.sample_graph(rng, 2, leaves_lo=4, leaves_hi=8)
                      for _ in range(3)]
        else:
            graphs = [wl.sample_graph(rng, 2, lo=5, hi=10) for _ in range(3)]
        res = train_fsm(graphs, RLConfig(max_iters=max_iters, seed=seed))
        fp = registry.save_result(fam, res)
        print(f"trained {fam}: batches {res.best_batches} "
              f"(lb {res.lower_bound}, reached={res.reached_lower_bound}) "
              f"-> {fp}")


def legacy_wave(arch: str, requests: int, max_new: int, seed: int,
                device: str, checkpoint: str = "") -> int:
    import torch

    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.serve.lm_wave import ServeEngine as LMWaveEngine

    if checkpoint:
        raise NotImplementedError(
            f"--checkpoint {checkpoint}: restoring TransformerLM weights "
            f"comes with {TRAINING}")
    cfg = get_config(arch).reduced()
    model = TransformerLM(cfg, device=device)
    params = model.init_params(torch.Generator().manual_seed(seed))
    nrng = np.random.default_rng(seed)
    prompts = [list(nrng.integers(0, cfg.vocab, int(nrng.integers(4, 24))))
               for _ in range(requests)]
    outs, stats = LMWaveEngine(model, params,
                               device=device).generate(prompts, max_new)
    print(f"[legacy {arch}] {len(outs)} requests, {stats.tokens_out} tokens "
          f"in {stats.wall_s:.2f}s ({stats.tok_per_s:.1f} tok/s), "
          f"{stats.n_batches} batches")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.split("\n")[0])
    ap.add_argument("--families", default="lm,tree,lattice")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="arrivals per scheduler round")
    ap.add_argument("--arrivals", choices=["constant", "poisson", "burst"],
                    default="constant",
                    help="arrival process for the synthetic trace "
                         "(constant i/rate, Poisson exponential gaps, or "
                         "bursts of --burst-size at the same mean rate)")
    ap.add_argument("--burst-size", type=int, default=4,
                    help="requests per burst for --arrivals burst")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel replicas; only 1 until the sharding "
                         "slice is ported")
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves: cuda (the default) or "
                         "cpu (every kernel runs its plain PyTorch version)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--model-size", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=16)
    ap.add_argument("--mode", choices=["continuous", "wave"],
                    default="continuous")
    ap.add_argument("--plan",
                    choices=["bucketed", "compiled", "interpreted"],
                    default="bucketed",
                    help="bucketed: one program per bucket signature, "
                         "captured once as a CUDA graph on the card "
                         "(topology churn = host-side repack); compiled: "
                         "one per topology; interpreted: reference executor")
    ap.add_argument("--cache-dir", default="",
                    help="directory of the warm set (warmset.json) that "
                         "--warm-start reads and writes")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable round pipelining: run pack/dispatch/block "
                         "serially each round instead of overlapping "
                         "next-round host packing with the in-flight "
                         "device work")
    ap.add_argument("--no-async-compile", action="store_true",
                    help="build and capture bucket graphs synchronously on "
                         "the serve loop. By default --plan bucketed builds "
                         "them on background workers and serves misses "
                         "through the degradation ladder until the graph "
                         "lands")
    ap.add_argument("--compile-workers", type=int, default=2,
                    help="background build worker threads (async compile "
                         "only)")
    ap.add_argument("--compile-timeout", type=float, default=30.0,
                    help="per-build-job wall-clock timeout in seconds; a "
                         "job past it is abandoned and retried with "
                         "backoff, then quarantined")
    ap.add_argument("--warm-start", action="store_true",
                    help="pre-submit build jobs for the bucket signatures "
                         "recorded in the warm set in --cache-dir, and "
                         "record this run's signatures back (async compile "
                         "only; needs --cache-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request SLO in virtual ms (1 scheduler round "
                         "≈ 1 virtual ms): deadline = arrival + this; "
                         "requests past it return partial results with "
                         "status TIMED_OUT. 0 disables deadlines")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bound the admission queue: submits past this many "
                         "pending requests are shed with status REJECTED. "
                         "0 = unbounded")
    ap.add_argument("--inject-faults", default="", metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'compile_fail=2,exec_rounds=3:7,slow=5*4.0,"
                         "poison=2,crash=8' — fail the first N builds, "
                         "raise at the listed engine rounds, burn extra "
                         "virtual time at a round, mix in N malformed "
                         "request graphs, crash the process at a round "
                         "boundary (checkpoint first when --checkpoint-dir "
                         "is set)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="write versioned serve-session checkpoints here "
                         "(periodic via --checkpoint-every and on injected "
                         "crash); restore with --restore")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every N scheduler rounds (0 = only on "
                         "crash); needs --checkpoint-dir")
    ap.add_argument("--restore", default="", metavar="CKPT",
                    help="resume serving from this checkpoint file (or from "
                         "the latest in a checkpoint directory) instead of "
                         "submitting a fresh trace")
    ap.add_argument("--steal-threshold", type=int, default=-1,
                    help="work stealing between replicas; only -1 (off) "
                         "until the sharding slice is ported")
    ap.add_argument("--trace", default="", help="JSON trace file")
    ap.add_argument("--registry", default="", help="policy registry dir")
    ap.add_argument("--train-policy", action="store_true",
                    help="train + persist FSM policies before serving")
    ap.add_argument("--out", default="", help="write ServeStats JSON here")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "serve run here (open in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="",
                    help="write a metrics-registry snapshot JSON here")
    ap.add_argument("--flight-dir", default="",
                    help="write flight-recorder dumps (last-N-rounds trace "
                         "ring) to this directory on request failure, "
                         "timeout, or quarantine")
    ap.add_argument("--legacy-arch", default="",
                    help="serve one wave through the legacy TransformerLM "
                         "engine instead (e.g. qwen2-0.5b)")
    ap.add_argument("--checkpoint", default="",
                    help="restore TransformerLM weights (legacy path only; "
                         "comes with the training slice)")
    from repro_torch.launch.env import add_perf_profile_arg
    add_perf_profile_arg(ap)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's arguments, with the flag-compatibility checks
    failing fast (``SystemExit(2)``) before any policy training or trace
    construction."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.devices > 1:
        ap.error(f"--devices {args.devices}: serving more than one replica "
                 f"comes with {SHARDING}")
    if args.steal_threshold >= 0:
        ap.error(f"--steal-threshold: work stealing comes with {SHARDING}")
    if args.warm_start and not _use_async(args):
        ap.error("--warm-start needs async compile "
                 "(--plan bucketed without --no-async-compile)")
    if args.checkpoint and not args.legacy_arch:
        ap.error("--checkpoint applies to the --legacy-arch path; graph "
                 "workload weights are seeded via --seed")
    return args


def _use_async(args) -> bool:
    # Async compile is the bucketed-plan default.
    return args.plan == "bucketed" and not args.no_async_compile


def make_workloads(args) -> dict:
    families = [f.strip() for f in args.families.split(",") if f.strip()]
    return {f: make_workload(SERVE_FAMILIES[f], args.model_size, args.seed,
                             device=args.device) for f in families}


def make_trace(args, workloads) -> list:
    if args.trace:
        return load_trace(args.trace, workloads, args.max_new)
    return synth_trace(list(workloads), args.requests, args.rate,
                       args.max_new, workloads, args.seed,
                       arrivals=args.arrivals, burst_size=args.burst_size)


def make_engine(args, workloads, registry=None, obs=None,
                injector=None) -> ServeEngine:
    """The engine the launcher serves with, fresh or restored from
    ``--restore`` (a fresh one has no requests submitted yet)."""
    use_async = _use_async(args)
    if args.restore:
        src = args.restore
        if os.path.isdir(src):
            src = latest_checkpoint(src)
            if src is None:
                build_parser().error(
                    f"--restore {args.restore}: no checkpoints found")
        eng = ServeEngine.restore(
            src, workloads, obs=obs, fault_injector=injector,
            registry=registry,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every or None,
            async_compile=use_async,
            compile_workers=args.compile_workers,
            compile_timeout_s=args.compile_timeout, device=args.device)
        if args.no_pipeline:
            # The checkpoint config carries the pipeline flag; --no-pipeline
            # on the resume command line still wins (nothing has run yet).
            eng.pipeline = False
        print(f"# restored round {eng._round} from {src} "
              f"({len(eng.requests)} ledger requests, "
              f"{len(eng.queue)} still queued)")
        return eng
    return ServeEngine(workloads, compiled=args.plan != "interpreted",
                       bucketed=args.plan == "bucketed",
                       continuous=args.mode == "continuous",
                       max_slots=args.max_slots,
                       model_size=args.model_size,
                       seed=args.seed, registry=registry,
                       queue_cap=args.queue_cap or None,
                       fault_injector=injector, obs=obs,
                       checkpoint_dir=args.checkpoint_dir or None,
                       checkpoint_every=args.checkpoint_every,
                       async_compile=use_async,
                       compile_workers=args.compile_workers,
                       compile_timeout_s=args.compile_timeout,
                       pipeline=not args.no_pipeline, device=args.device)


def serve(args, workloads: dict | None = None
          ) -> tuple[int, ServeEngine | None]:
    """Serve as ``args`` say; returns the exit code (1 after an injected
    crash, else 0) and the engine (None for ``--legacy-arch``).
    ``workloads`` are the families' instances if the caller built them
    (as :func:`make_workloads` does), else they are built here."""
    if args.legacy_arch:
        return legacy_wave(args.legacy_arch, args.requests, args.max_new,
                           args.seed, args.device, args.checkpoint), None
    if args.warm_start and not args.cache_dir:
        print("# --warm-start without --cache-dir: nothing persisted from "
              "a prior run; continuing cold")
    if args.cache_dir:
        from repro_torch.launch.cache import audit_cache_dir
        audit_cache_dir(args.cache_dir)

    if workloads is None:
        workloads = make_workloads(args)
    families = list(workloads)
    registry = PolicyRegistry(args.registry) if args.registry else None
    if args.train_policy:
        if registry is None:
            build_parser().error("--train-policy needs --registry")
        train_policies(registry, families, workloads, args.seed)

    reqs = make_trace(args, workloads)
    injector = None
    if args.inject_faults:
        from repro_torch.serve.faults import FaultInjector, poison_requests
        injector = FaultInjector.from_spec(args.inject_faults)
        if injector.poison:
            fam = next((f for f in ("tree", "lattice") if f in workloads),
                       None)
            if fam is None:
                print("# poison=N needs a single-shot family "
                      "(tree/lattice) in --families; skipping poison")
            else:
                reqs += poison_requests(injector.poison, family=fam,
                                        arrival=1.0)
    if args.deadline_ms > 0:
        for r in reqs:
            r.deadline = r.arrival + args.deadline_ms

    # Observability wiring: --trace-out lights up the process-default
    # tracer, --flight-dir adds an on-disk flight recorder. The engine
    # still auto-creates an in-memory flight recorder under --inject-faults
    # even when none of these flags are given.
    tracer = default_tracer()
    if args.trace_out:
        tracer.enabled = True
    flight = FlightRecorder(out_dir=args.flight_dir) if args.flight_dir \
        else None
    obs = Obs(tracer=tracer, flight=flight)

    # Resume mid-trace from a snapshot: the checkpoint carries the queue,
    # partial token streams, slot pools, and virtual clock, so no fresh
    # trace is submitted (a replayed one would dedupe anyway).
    eng = make_engine(args, workloads, registry, obs, injector)
    if not args.restore:
        eng.submit_many(reqs)

    if args.warm_start and args.cache_dir:
        from repro_torch.launch.cache import load_warmset
        n_warm = eng.prewarm(load_warmset(args.cache_dir))
        if n_warm:
            print(f"# warm-start: pre-submitted {n_warm} build job(s) "
                  f"from {args.cache_dir}")

    t_serve0 = time.perf_counter()
    try:
        stats = eng.run()
    except InjectedCrash as exc:
        # The injected process crash: the crash checkpoint (if configured)
        # is already on disk — report where to resume from and exit loudly.
        where = (f"; resume with --restore {args.checkpoint_dir}"
                 if args.checkpoint_dir else
                 " (no --checkpoint-dir, so nothing was saved)")
        print(f"# {exc}{where}")
        eng.close()   # stop build workers for a clean interpreter exit
        return 1, eng

    pct = stats.latency_percentiles()
    print(f"{stats.requests_done} requests ({stats.tokens_out} tokens, "
          f"{stats.outputs_out} single-shot outputs) in {stats.wall_s:.2f}s "
          f"= {stats.tok_per_s:.1f} tok/s over {stats.n_rounds} rounds")
    print(f"batches {stats.n_batches}, device launches {stats.n_launches}, "
          f"builds {stats.n_compiles}, CUDA graphs "
          f"{stats.n_graph_captures} captured / {stats.n_graph_replays} "
          f"replayed; "
          f"plan cache {stats.plan_cache_hits}h/{stats.plan_cache_misses}m, "
          f"schedule cache {stats.sched_cache_hits}h/"
          f"{stats.sched_cache_misses}m, "
          f"bucket cache {stats.bucket_cache_hits}h/"
          f"{stats.bucket_cache_misses}m")
    print(f"latency p50/p95/p99 {pct['p50_latency_s'] * 1e3:.0f}/"
          f"{pct['p95_latency_s'] * 1e3:.0f}/"
          f"{pct['p99_latency_s'] * 1e3:.0f} ms, "
          f"ttft p50 {pct['p50_ttft_s'] * 1e3:.0f} ms")
    tiers = " ".join(f"{t}={n}" for t, n in
                     sorted(stats.tier_rounds.items())) or "none"
    print(f"tier rounds: {tiers}; failed {stats.requests_failed}, "
          f"timed out {stats.requests_timed_out}, "
          f"rejected {stats.requests_rejected}; "
          f"{stats.n_contained_errors} contained errors, "
          f"{stats.n_quarantine_events} quarantine events")
    if stats.n_pipelined_rounds or stats.n_spec_cancelled:
        print(f"pipeline: {stats.n_pipelined_rounds} overlapped round(s) "
              f"({stats.n_overlapped_packs} pack(s) hidden behind dispatch), "
              f"{stats.n_spec_cancelled} speculation(s) cancelled")
    if stats.n_checkpoints or stats.n_restores:
        print(f"durability: {stats.n_checkpoints} checkpoint(s), "
              f"{stats.n_restores} restore(s)")
    if eng.async_compile:
        firsts = [r.t_first - t_serve0 for r in eng.requests.values()
                  if r.t_first >= t_serve0]
        ttft = f"{min(firsts) * 1e3:.0f} ms" if firsts else "n/a"
        print(f"compile: {stats.compile_jobs_submitted} job(s) submitted, "
              f"{stats.compile_jobs_landed} landed, "
              f"{stats.n_hotswaps} hot-swap(s), "
              f"{stats.compile_jobs_retried} retried, "
              f"{stats.compile_jobs_timed_out} timed out, "
              f"{stats.compile_jobs_quarantined} quarantined; "
              f"lower {stats.lower_s:.2f}s on-loop / "
              f"{stats.lower_bg_s:.2f}s background; "
              f"cold-start ttft {ttft}")
    if args.warm_start and args.cache_dir:
        from repro_torch.launch.cache import save_warmset
        if save_warmset(args.cache_dir, eng.warmset()):
            print(f"# warmset saved in {args.cache_dir}")
    eng.close()
    if registry is not None and registry.diagnostics:
        for fam, bad in sorted(registry.diagnostics.items()):
            for d in bad:
                print(f"# registry[{fam}] skipped {d['path']}: {d['error']}")
    if eng.flight is not None and eng.flight.dumps:
        n = len(eng.flight.dumps)
        reasons = sorted({d["reason"] for d in eng.flight.dumps})
        where = f" in {args.flight_dir}" if args.flight_dir else " (in-memory)"
        print(f"# {n} flight dump(s){where}: {', '.join(reasons)}")
    if args.trace_out:
        tracer.write(args.trace_out)
        print(f"# wrote {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(default_registry().snapshot(), f, indent=1)
        print(f"# wrote {args.metrics_out}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats.as_dict(), f, indent=1)
        print(f"# wrote {args.out}")
    return 0, eng


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.launch.env import maybe_apply_perf_profile
    # May re-exec the process once to get tcmalloc into LD_PRELOAD.
    maybe_apply_perf_profile(args)
    return serve(args)[0]


if __name__ == "__main__":
    raise SystemExit(main())

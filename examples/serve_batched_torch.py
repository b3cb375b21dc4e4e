"""End-to-end walkthrough on the PyTorch port: continuous-batching serving
on compiled plans, ``examples/serve_batched.py`` over ``repro_torch``.

1. Train an FSM batching policy for the chain-LM family (ED-Batch Alg. 1 +
   Q-learning) and persist it to a policy registry on disk.
2. Serve a mixed trace — LM generation requests plus tree-classifier and
   lattice-NER requests arriving over time — with continuous batching: late
   arrivals fold into in-flight decode waves, each round's wave graph runs
   as one compiled-plan dispatch per family (on the card one CUDA-graph
   replay per bucket signature).
3. Compare against the wave-by-wave interpreted baseline (the old engine's
   discipline) on the same trace.

It runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_batched_torch.py [--requests 12]
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import random
import tempfile

from repro_torch.core.device import resolve_device
from repro_torch.core.rl import RLConfig, train_fsm
from repro_torch.models.workloads import SERVE_FAMILIES, make_workload
from repro_torch.serve import PolicyRegistry, ServeEngine, synth_trace


def build_trace(workloads, n, max_new, seed=0):
    # 2:1:1 lm:tree:lattice mix, 2 arrivals per scheduler round
    return synth_trace(["lm", "lm", "tree", "lattice"], n, 2.0, max_new,
                       workloads, seed, tree_leaves=(4, 7),
                       lattice_chars=(5, 9))


def main(argv=None):
    """Serve as the flags say; returns each discipline's ``ServeStats``
    and the trained FSM's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--model-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    workloads = {f: make_workload(SERVE_FAMILIES[f], args.model_size,
                                  device=device)
                 for f in ("lm", "tree", "lattice")}

    # 1. Train + persist an FSM policy for the lm family.
    rng = random.Random(0)
    train_graphs = [workloads["lm"].sample_graph(rng, 2, lo=4, hi=8)
                    for _ in range(3)]
    res = train_fsm(train_graphs, RLConfig(max_iters=200))
    registry = PolicyRegistry(tempfile.mkdtemp(prefix="edbatch_registry_"))
    fp = registry.save_result("lm", res)
    print(f"trained lm FSM: {res.best_batches} batches "
          f"(lower bound {res.lower_bound}) -> registry {fp}")

    # 2/3. Same trace through both disciplines.
    results = {}
    for label, kw in (("continuous+compiled",
                       dict(compiled=True, continuous=True)),
                      ("wave+interpreted",
                       dict(compiled=False, continuous=False))):
        eng = ServeEngine(workloads, registry=registry, max_slots=8,
                          device=device, **kw)
        reqs = build_trace(workloads, args.requests, args.max_new)
        eng.submit_many(reqs)
        stats = eng.run()
        results[label] = stats
        pct = stats.latency_percentiles()
        print(f"[{label}] {stats.requests_done} requests, "
              f"{stats.tokens_out} tokens in {stats.wall_s:.2f}s "
              f"({stats.tok_per_s:.1f} tok/s, {stats.lower_s:.1f}s of that "
              f"one-time plan lower+compile); {stats.n_rounds} rounds, "
              f"{stats.n_batches} batches, {stats.n_launches} launches; "
              f"latency p50 {pct['p50_latency_s'] * 1e3:.0f} ms / "
              f"p95 {pct['p95_latency_s'] * 1e3:.0f} ms")

    def steady_tok_s(s):   # what a long-running server sees (warm caches)
        return s.tokens_out / max(s.wall_s - s.lower_s - s.schedule_s, 1e-9)

    speed = (steady_tok_s(results["continuous+compiled"]) /
             max(steady_tok_s(results["wave+interpreted"]), 1e-9))
    print(f"continuous+compiled vs wave+interpreted (steady state, one-time "
          f"compiles and Alg. 1 walks amortized): {speed:.2f}x tokens/s — "
          f"benchmarks/bench_serve.py measures this properly with a warmup "
          f"pass")
    return results, res


if __name__ == "__main__":
    main()

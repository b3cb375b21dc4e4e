"""Quickstart: ED-Batch on a TreeLSTM in ~50 lines, on the PyTorch port:
``examples/quickstart.py`` over ``repro_torch``.

Builds a batch of random parse trees, learns the batching FSM by RL,
compares batch counts against the depth/agenda heuristics, runs the batched
forward pass with the PQ-planned cells, then compiles the whole schedule
into a single-dispatch execution plan: on the card one CUDA graph, replayed
once a run (the count printed is the card's replays). It runs on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import random

import numpy as np

from repro_torch.core.batching import agenda_schedule, depth_schedule, schedule
from repro_torch.core.device import resolve_device
from repro_torch.core.executor import DynamicExecutor, ExecStats
from repro_torch.core.plan import PlanExecutor
from repro_torch.core.rl import RLConfig, train_fsm
from repro_torch.models.workloads import make_workload


def run(device, model_size: int = 64, batch: int = 16,
        rl_iters: int = 600) -> dict:
    """The walkthrough on ``device``; prints the original's lines and
    returns their numbers."""
    rng = random.Random(0)
    wl = make_workload("TreeLSTM", model_size=model_size, device=device)
    out_stats = {}

    # 1) learn the batching FSM from a few small example graphs
    train_graphs = [wl.sample_graph(rng, 2) for _ in range(3)]
    res = train_fsm(train_graphs, RLConfig(max_iters=rl_iters))
    print(f"RL: {res.iters} iters, {res.train_time_s * 1e3:.0f} ms, "
          f"reached lower bound: {res.reached_lower_bound}")

    # 2) schedule a fresh minibatch with every algorithm
    g = wl.sample_graph(rng, batch)
    print(f"graph: {len(g)} nodes, lower bound {g.batch_lower_bound()}")
    out_stats["batches"] = {"depth": len(depth_schedule(g)),
                            "agenda": len(agenda_schedule(g)),
                            "fsm": len(schedule(g, res.policy))}
    print(f"  depth-based  (TF-Fold): {out_stats['batches']['depth']} batches")
    print(f"  agenda-based (DyNet)  : {out_stats['batches']['agenda']} "
          f"batches")
    print(f"  learned FSM (ED-Batch): {out_stats['batches']['fsm']} batches")

    # 3) execute with the PQ-planned cells
    ex = DynamicExecutor(wl.impls, None, device=device)
    out = ex.run(g, res.policy)
    y_ids = list(out.nodes_with_field("y"))
    ys = out.field("y", y_ids).cpu().numpy()
    print(f"executed: {len(y_ids)} per-node predictions, "
          f"all finite: {np.isfinite(ys).all()}")
    out_stats["cells"] = {}
    for cell_name, cell in wl.cells.items():
        s = cell.stats
        out_stats["cells"][cell_name] = (s.n_batches, s.n_mem_kernels,
                                         cell.zero_copy_fraction())
        print(f"  {cell_name}: {s.n_batches} compute batches, "
              f"{s.n_mem_kernels} memory kernels "
              f"(zero-copy fraction {cell.zero_copy_fraction():.0%})")

    # 4) compile the schedule + memory plan into one program: on the card
    # one captured CUDA graph
    pex = PlanExecutor(wl.impls, None, device=device)
    stats = ExecStats()
    pres = pex.run(g, res.policy, stats)      # lowers + builds + runs
    stats2 = ExecStats()
    replays = pex.n_replays
    pex.run(g, res.policy, stats2)            # steady state: 1 dispatch
    replays = pex.n_replays - replays
    # what the card did: graph replays; eager passes on the CPU
    dispatches = replays if device.type == "cuda" else stats2.n_launches
    ps = pex.plan_for(g, res.policy).stats
    ys2 = pres.field("y", y_ids).cpu().numpy()
    match = bool(np.allclose(ys, ys2, atol=1e-5))
    print(f"compiled plan: {ps.n_steps} batches -> {dispatches} device "
          f"dispatch, {ps.n_slice_reads} slice / {ps.n_gather_reads} gather "
          f"reads ({ps.layout} layout), matches interpreted: {match}")
    out_stats.update(
        rl_iters=res.iters, reached_lower_bound=res.reached_lower_bound,
        nodes=len(g), lower_bound=g.batch_lower_bound(),
        n_predictions=len(y_ids), finite=bool(np.isfinite(ys).all()),
        plan_stats=ps.as_dict(), dispatches=dispatches,
        n_launches=stats2.n_launches, n_captures=pex.n_captures,
        matches_interpreted=match)
    return out_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()

"""LatticeLSTM Chinese-NER-style demo (Fig. 7 topology) on the PyTorch
port: ``examples/lattice_ner.py`` over ``repro_torch``. Shows where the
FSM batching matters most — word-cell jump links that the depth/agenda
heuristics scatter across many small batches. It runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/lattice_ner_torch.py
    PYTHONPATH=src python examples/lattice_ner_torch.py --device cpu
"""
import argparse
import random

from repro_torch.core.batching import (SufficientConditionPolicy,
                                       agenda_schedule, depth_schedule,
                                       schedule)
from repro_torch.core.device import resolve_device
from repro_torch.core.executor import DynamicExecutor, ExecStats
from repro_torch.core.rl import RLConfig, train_fsm
from repro_torch.models.workloads import make_workload


def run(device, model_size: int = 64, batch: int = 16,
        rl_iters: int = 1000) -> dict:
    """The demo on ``device``; prints the original's lines and returns
    their numbers."""
    rng = random.Random(7)
    wl = make_workload("LatticeLSTM", model_size=model_size, device=device)
    res = train_fsm([wl.sample_graph(rng, 2) for _ in range(4)],
                    RLConfig(max_iters=rl_iters))
    g = wl.sample_graph(rng, batch)
    print(f"lattice batch: {len(g)} nodes")
    batches = {}
    for name, sched in [("depth", depth_schedule(g)),
                        ("agenda", agenda_schedule(g)),
                        ("sufficient-condition",
                         schedule(g, SufficientConditionPolicy())),
                        ("learned FSM", schedule(g, res.policy))]:
        batches[name] = len(sched)
        print(f"  {name:22s} {len(sched):4d} batches")

    stats = ExecStats()
    ex = DynamicExecutor(wl.impls, None, device=device)
    out = ex.run(g, res.policy, stats)
    out = ex.run(g, res.policy, stats)  # steady state
    tag_ids = list(out.nodes_with_field("y"))
    tags = out.field("y", tag_ids).argmax(-1).cpu().numpy()
    print(f"predicted {len(tags)} char tags; exec "
          f"{stats.exec_time / 2 * 1e3:.1f} ms/pass")
    return {"nodes": len(g), "batches": batches, "n_tags": len(tags),
            "n_batches_run": stats.n_batches, "rl_iters": res.iters}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()

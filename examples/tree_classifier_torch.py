"""End-to-end *training* of a dynamic DNN through the batched executor, on
the PyTorch port: ``examples/tree_classifier.py`` over ``repro_torch``.

A tiny TreeGRU sentiment-style classifier: labels are synthesized from a
hidden teacher rule (majority of leaf-token parities), so the loss genuinely
decreases. Gradients flow through the FSM-scheduled batched execution
(``DynamicExecutor``): every operand gather is the row-gather kernel, whose
backward kernel sums the output rows' gradients back into their sources.
It trains on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/tree_classifier_torch.py
    PYTHONPATH=src python examples/tree_classifier_torch.py --device cpu
"""
import argparse
import random

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.executor import DynamicExecutor
from repro_torch.core.rl import RLConfig, train_fsm
from repro_torch.models.workloads import make_workload


def labelled_roots(g):
    """The root O node of each tree of ``g`` and its teacher label.

    Trees were appended sequentially; each tree's segment starts at an E
    node that follows an O (or the graph's start), and its root is the last
    O in the segment."""
    o_nodes = [n.id for n in g.nodes if n.type == "O"]
    seg_start = [n.id for n in g.nodes if n.type == "E" and
                 (n.id == 0 or g.nodes[n.id - 1].type in ("O",))]
    roots, labels = [], []
    for s, e in zip(seg_start, seg_start[1:] + [len(g)]):
        os_in_seg = [i for i in o_nodes if s <= i < e]
        roots.append(os_in_seg[-1])
        toks = [n.attrs["aux"] for n in g.nodes[s:e] if n.type == "E"]
        labels.append(int(np.mean([t % 2 for t in toks]) > 0.5))
    return roots, labels


def batch_loss(ex, policy, params, graph, labels, root_ids):
    out = ex.run(graph, policy, params=params)
    logits = out.field("y", root_ids)            # (B, n_classes)
    logp = torch.log_softmax(logits, dim=-1)
    idx = torch.arange(len(labels), device=logits.device)
    return -logp[idx, labels].mean()


def train(ex, policy, params, sample, steps: int, lr: float = 0.05,
          log=print):
    """``steps`` SGD steps on fresh graphs from ``sample()``; returns the
    losses and the final params. Each step differentiates the loss through
    ``ex.run`` with ``torch.autograd.grad``."""
    losses = []
    for step in range(steps):
        g = sample()
        roots, labels = labelled_roots(g)
        labels = torch.as_tensor(labels, device=ex.device)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = batch_loss(ex, policy, leaves, g, labels, roots)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = {k: v.detach() - lr * gr
                  for (k, v), gr in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        if step % 5 == 0:
            log(f"step {step:3d} loss {losses[-1]:.4f}")
    return losses, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = random.Random(0)
    wl = make_workload("TreeGRU", model_size=32, device=device)
    res = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=400))
    ex = DynamicExecutor(wl.impls, None, device=device)

    # trainable leaves: the internal cell's parameter buffer
    internal = wl.cells["TreeGRU-Internal"]
    params = {"I": internal.init_params(np.random.default_rng(1),
                                        device=device)}
    losses, _ = train(ex, res.policy, params,
                      lambda: wl.sample_graph(rng, 8), args.steps)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'no improvement'})")
    return losses


if __name__ == "__main__":
    main()

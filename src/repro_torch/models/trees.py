"""Tree-based workloads: TreeLSTM, TreeGRU, MV-RNN, TreeLSTM-2Type.

Graphs follow Fig. 1: leaf embed nodes (E), leaf cells (L), internal cells
(I / I2), and a per-node output head (O) — the structure whose O nodes the
depth/agenda heuristics scatter across batches but the FSM executes in one.

Weights are drawn from ``np.random.default_rng(seed)`` in the reference's
order (embedding table, leaf cell, each internal cell, output head; for
MV-RNN the vector table, then the matrix table), so a workload here holds
bit-identical parameters.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.executor import NodeImpl, cell_impl, embed_impl, placed
from repro_torch.core.graph import Graph, Node
from repro_torch.core.subgraph import CompiledCell
from repro_torch.kernels.gather_batch import gather_rows
from .cells import (mv_cell, treegru_internal, treegru_leaf,
                    treelstm_internal, treelstm_leaf)
from .chains import _normal
from .data import TreeNode, random_tree

N_CLASSES = 5
VOCAB = 1000


def _tree_graph(trees: list[TreeNode], internal_types: int = 1) -> Graph:
    nodes: list[Node] = []

    def add(type_, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    def visit(t: TreeNode) -> int:
        if t.is_leaf:
            e = add("E", aux=t.token)
            cell = add("L", (e,))
        else:
            l = visit(t.left)
            r = visit(t.right)
            ty = "I" if internal_types == 1 else f"I{t.tag + 1}"
            cell = add(ty, (l, r))
        add("O", (cell,))
        return cell

    for t in trees:
        visit(t)
    return Graph(nodes)


def _out_impl(rng: np.random.Generator, hidden: int, h_field: str,
              device) -> NodeImpl:
    own = {"w": _normal(rng, (hidden, N_CLASSES), device),
           "b": torch.zeros(N_CLASSES, dtype=torch.float32, device=device)}

    def apply(params, inputs, aux):
        return {"y": inputs[0] @ placed(own["w"]) + placed(own["b"])}

    return NodeImpl("O", [(0, h_field)], {"y": (N_CLASSES,)}, apply,
                    params=own)


def _mv_embed_impl(vec: torch.Tensor, mat: torch.Tensor) -> NodeImpl:
    """MV-RNN leaves: a vector and a matrix per token, the same fields
    internal nodes produce. The matrix rows (``h * h`` floats each) go
    through the row gather like any other field."""
    own = {"vec": vec, "mat": mat}
    h = vec.shape[1]

    def apply(params, inputs, aux):
        return {"a_out": gather_rows(placed(own["vec"]), aux),
                "A_out": gather_rows(placed(own["mat"]), aux)}

    return NodeImpl("E", [], {"a_out": (h,), "A_out": (h, h)}, apply,
                    params=own)


class TreeWorkload:
    """name in {TreeLSTM, TreeGRU, MV-RNN, TreeLSTM-2Type}."""

    def __init__(self, name: str, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", device=None):
        dev = resolve_device(device)
        self.name = name
        self.model_size = model_size
        self.layout = layout
        self.device = dev
        rng = np.random.default_rng(seed)
        h = model_size
        self.impls: dict = {}
        if name in ("TreeLSTM", "TreeLSTM-2Type"):
            leaf = CompiledCell(treelstm_leaf(h, h), layout)
            table = _normal(rng, (VOCAB, h), dev)
            self.impls["E"] = embed_impl("E", table, "x")
            self.impls["L"] = cell_impl("L", leaf, [(0, "x")], ["x"],
                                        leaf.init_params(rng, device=dev))
            n_int = 2 if name == "TreeLSTM-2Type" else 1
            for k in range(n_int):
                internal = CompiledCell(treelstm_internal(h), layout)
                ty = "I" if n_int == 1 else f"I{k + 1}"
                self.impls[ty] = cell_impl(
                    ty, internal,
                    [(0, "h_out"), (1, "h_out"), (0, "c_out"), (1, "c_out")],
                    ["h_l", "h_r", "c_l", "c_r"],
                    internal.init_params(rng, device=dev))
            h_field = "h_out"
            self.cells = {"TreeLSTM-Leaf": leaf, "TreeLSTM-Internal": internal}
        elif name == "TreeGRU":
            leaf = CompiledCell(treegru_leaf(h, h), layout)
            internal = CompiledCell(treegru_internal(h), layout)
            table = _normal(rng, (VOCAB, h), dev)
            self.impls["E"] = embed_impl("E", table, "x")
            self.impls["L"] = cell_impl("L", leaf, [(0, "x")], ["x"],
                                        leaf.init_params(rng, device=dev))
            self.impls["I"] = cell_impl(
                "I", internal, [(0, "h_out"), (1, "h_out")], ["h_l", "h_r"],
                internal.init_params(rng, device=dev))
            h_field = "h_out"
            self.cells = {"TreeGRU-Leaf": leaf, "TreeGRU-Internal": internal}
        elif name == "MV-RNN":
            internal = CompiledCell(mv_cell(h), layout)
            vec = _normal(rng, (VOCAB, h), dev)
            # eye + 0.02 * normal, as the reference writes it, in place
            # (the float64 draw is 2 GB at width 512)
            mat = rng.standard_normal((VOCAB, h, h))
            mat *= 0.02
            mat += np.eye(h)
            mat = torch.as_tensor(mat.astype(np.float32), device=dev)
            self.impls["E"] = _mv_embed_impl(vec, mat)
            self.impls["I"] = cell_impl(
                "I", internal,
                [(0, "a_out"), (1, "a_out"), (0, "A_out"), (1, "A_out")],
                ["a_l", "a_r", "A_l", "A_r"],
                internal.init_params(rng, device=dev))
            h_field = "a_out"
            self.cells = {"MVCell": internal}
        else:
            raise ValueError(name)
        self.impls["O"] = _out_impl(rng, h, h_field, dev)

    def sample_graph(self, rng: random.Random, batch_size: int,
                     leaves_lo: int = 6, leaves_hi: int = 18) -> Graph:
        n_tags = 2 if self.name == "TreeLSTM-2Type" else 1
        trees = [random_tree(rng, rng.randint(leaves_lo, leaves_hi),
                             VOCAB, n_tags) for _ in range(batch_size)]
        if self.name == "MV-RNN":
            return _mvrnn_graph(trees)
        return _tree_graph(trees, internal_types=n_tags)


def _mvrnn_graph(trees: list[TreeNode]) -> Graph:
    nodes: list[Node] = []

    def add(type_, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    def visit(t: TreeNode) -> int:
        if t.is_leaf:
            cell = add("E", aux=t.token)
        else:
            l = visit(t.left)
            r = visit(t.right)
            cell = add("I", (l, r))
        add("O", (cell,))
        return cell

    for t in trees:
        visit(t)
    return Graph(nodes)

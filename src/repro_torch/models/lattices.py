"""Lattice-based workloads: LatticeLSTM (Chinese NER) and LatticeGRU (NMT).

Topology per Fig. 7: a chain of character cells with word-cell jump links.
A word cell W(i, j) reads the char state at i and merges into the char cell
at j+1 (type CW). The FSM policy learns to run all char cells of a wave
first and delay word cells — the depth/agenda heuristics interleave them
arbitrarily, costing up to 3.27x more batches (Fig. 9).

Weights are drawn from ``np.random.default_rng(seed)`` in the reference's
order, so a workload here holds bit-identical parameters. LatticeLSTM's
``C`` and ``W`` cells are plain LSTM cells, so the bucketed executor runs
them through the fused gather→cell kernel, with ``x`` read from an embed
arena and ``h``/``c`` from a cell's or the zero state's.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.executor import NodeImpl, cell_impl, embed_impl, placed
from repro_torch.core.graph import Graph, Node
from repro_torch.core.subgraph import CompiledCell
from .cells import gru_cell, lattice_char_gru, lattice_char_lstm, lstm_cell
from .chains import _normal, _zero_state_impl
from .data import random_lattice

CHAR_VOCAB = 1000
WORD_VOCAB = 5000
N_TAGS = 9


def _out_impl(wo: torch.Tensor) -> NodeImpl:
    own = {"wo": wo}

    def out_apply(params, inputs, aux):
        return {"y": inputs[0] @ placed(own["wo"])}

    return NodeImpl("O", [(0, "h_out")], {"y": (N_TAGS,)}, out_apply,
                    params=own)


def _lattice_graph(rng: random.Random, batch_size: int, lo: int,
                   hi: int) -> Graph:
    nodes: list[Node] = []

    def add(type_, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    for _ in range(batch_size):
        lat = random_lattice(rng, lo, hi, CHAR_VOCAB, WORD_VOCAB)
        prev = add("S")
        char_cells: list[int] = []
        pending_word: int | None = None
        for j, tok in enumerate(lat.chars):
            e = add("EC", aux=tok)
            if pending_word is not None:
                cell = add("CW", (prev, e, pending_word))
                pending_word = None
            else:
                cell = add("C", (prev, e))
            char_cells.append(cell)
            add("O", (cell,))
            w = lat.words[j]
            if w is not None:
                start, wtok = w
                ew = add("EW", aux=wtok)
                pending_word = add("W", (char_cells[start], ew))
            prev = cell
    return Graph(nodes)


class LatticeLSTM:
    name = "LatticeLSTM"

    def __init__(self, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        h = model_size
        self.model_size = h
        self.device = dev
        char = CompiledCell(lstm_cell(h, h), layout)
        charw = CompiledCell(lattice_char_lstm(h, h), layout)
        word = CompiledCell(lstm_cell(h, h), layout)
        ctab = _normal(rng, (CHAR_VOCAB, h), dev)
        wtab = _normal(rng, (WORD_VOCAB, h), dev)
        wo = _normal(rng, (h, N_TAGS), dev)

        self.impls = {
            "EC": embed_impl("EC", ctab, "x"),
            "EW": embed_impl("EW", wtab, "x"),
            "S": _zero_state_impl(h),
            "C": cell_impl("C", char, [(1, "x"), (0, "h_out"), (0, "c_out")],
                           ["x", "h", "c"], char.init_params(rng, device=dev)),
            # CW: (prev char cell, char embed, word cell)
            "CW": cell_impl("CW", charw,
                            [(1, "x"), (0, "h_out"), (0, "c_out"),
                             (2, "h_out"), (2, "c_out")],
                            ["x", "h", "c", "h_w", "c_w"],
                            charw.init_params(rng, device=dev)),
            # W: (char cell at word start, word embed)
            "W": cell_impl("W", word, [(1, "x"), (0, "h_out"), (0, "c_out")],
                           ["x", "h", "c"], word.init_params(rng, device=dev)),
            "O": _out_impl(wo),
        }
        self.cells = {"LSTMCell": char, "LatticeCharLSTM": charw}

    def sample_graph(self, rng: random.Random, batch_size: int,
                     lo: int = 10, hi: int = 26) -> Graph:
        return _lattice_graph(rng, batch_size, lo, hi)


class LatticeGRU:
    name = "LatticeGRU"

    def __init__(self, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        h = model_size
        self.model_size = h
        self.device = dev
        char = CompiledCell(gru_cell(h, h), layout)
        charw = CompiledCell(lattice_char_gru(h, h), layout)
        word = CompiledCell(gru_cell(h, h), layout)
        ctab = _normal(rng, (CHAR_VOCAB, h), dev)
        wtab = _normal(rng, (WORD_VOCAB, h), dev)
        wo = _normal(rng, (h, N_TAGS), dev)

        self.impls = {
            "EC": embed_impl("EC", ctab, "x"),
            "EW": embed_impl("EW", wtab, "x"),
            "S": _zero_state_impl(h, ("h_out",)),
            "C": cell_impl("C", char, [(1, "x"), (0, "h_out")],
                           ["x", "h"], char.init_params(rng, device=dev)),
            "CW": cell_impl("CW", charw,
                            [(1, "x"), (0, "h_out"), (2, "h_out")],
                            ["x", "h", "h_w"],
                            charw.init_params(rng, device=dev)),
            "W": cell_impl("W", word, [(1, "x"), (0, "h_out")],
                           ["x", "h"], word.init_params(rng, device=dev)),
            "O": _out_impl(wo),
        }
        self.cells = {"GRUCell": char, "LatticeCharGRU": charw}

    def sample_graph(self, rng: random.Random, batch_size: int,
                     lo: int = 10, hi: int = 26) -> Graph:
        return _lattice_graph(rng, batch_size, lo, hi)

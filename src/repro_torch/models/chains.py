"""Chain-based workloads: BiLSTM-Tagger and LSTM-NMT, plus ChainLM.

Chain topologies are the easy case (both the agenda heuristic and the FSM
find the optimal policy, §5.2); the speedup there comes from the PQ-planned
cells. We build them faithfully anyway — they are the paper's baselines.

Weights are drawn from ``np.random.default_rng(seed)`` in the reference's
order, so a workload here holds bit-identical parameters.
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
from .cells import lstm_cell
from .data import random_sentence

VOCAB = 1000
N_TAGS = 17
OUT_VOCAB = 500


def _normal(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(0.1 * rng.standard_normal(shape),
                                      np.float32), device=device)


def _zero_state_impl(hidden: int,
                     fields: tuple[str, ...] = ("h_out", "c_out")) -> NodeImpl:
    def apply(params, inputs, aux):
        k = aux.shape[0]
        z = torch.zeros((k, hidden), dtype=torch.float32, device=aux.device)
        return {f: z for f in fields}
    return NodeImpl("S", [], {f: (hidden,) for f in fields}, apply)


def _out_impl(in_slots, wo: torch.Tensor, bo: torch.Tensor) -> NodeImpl:
    own = {"wo": wo, "bo": bo}

    def out_apply(params, inputs, aux):
        x = inputs[0] if len(inputs) == 1 else torch.cat(inputs, dim=-1)
        return {"y": x @ placed(own["wo"]) + placed(own["bo"])}
    return NodeImpl("O", in_slots, {"y": (wo.shape[1],)}, out_apply,
                    params=own)


class BiLSTMTagger:
    name = "BiLSTM-Tagger"

    def __init__(self, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        h = model_size
        self.model_size = h
        self.device = dev
        fwd = CompiledCell(lstm_cell(h, h), layout)
        bwd = CompiledCell(lstm_cell(h, h), layout)
        table = _normal(rng, (VOCAB, h), dev)
        wo = _normal(rng, (2 * h, N_TAGS), dev)
        bo = torch.zeros(N_TAGS, dtype=torch.float32, device=dev)

        self.impls = {
            "E": embed_impl("E", table, "x"),
            "S": _zero_state_impl(h),
            "F": cell_impl("F", fwd, [(1, "x"), (0, "h_out"), (0, "c_out")],
                           ["x", "h", "c"], fwd.init_params(rng, device=dev)),
            "B": cell_impl("B", bwd, [(1, "x"), (0, "h_out"), (0, "c_out")],
                           ["x", "h", "c"], bwd.init_params(rng, device=dev)),
            "O": _out_impl([(0, "h_out"), (1, "h_out")], wo, bo),
        }
        self.cells = {"LSTMCell": fwd}

    def sample_graph(self, rng: random.Random, batch_size: int,
                     lo: int = 8, hi: int = 24) -> Graph:
        nodes: list[Node] = []

        def add(type_, inputs=(), aux=0):
            nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                              attrs={"aux": aux}))
            return len(nodes) - 1

        for _ in range(batch_size):
            sent = random_sentence(rng, lo, hi, VOCAB)
            embeds = [add("E", aux=t) for t in sent]
            s_f = add("S")
            s_b = add("S")
            fs = []
            prev = s_f
            for e in embeds:
                prev = add("F", (prev, e))
                fs.append(prev)
            bs = []
            prev = s_b
            for e in reversed(embeds):
                prev = add("B", (prev, e))
                bs.append(prev)
            bs.reverse()
            for f, b2 in zip(fs, bs):
                add("O", (f, b2))
        return Graph(nodes)


class ChainLM:
    """Autoregressive chain LM — the servable "chain LM decode" family.

    A language model as a dynamic dataflow graph: prefill is a chain of
    LSTM cells over the prompt tokens, decode is one cell per generated
    token. ``R`` (resume) nodes read a request's ``(h, c)`` out of a slot
    pool threaded through executor ``params`` (key ``"slots"``), indexed by
    slot id in ``aux``; the serve engine that drives decode rounds comes
    with the serve slice.
    """

    name = "ChainLM"
    state_fields = ("h_out", "c_out")

    def __init__(self, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", vocab: int = 256, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        h = model_size
        self.model_size = h
        self.vocab = vocab
        self.device = dev
        dec = CompiledCell(lstm_cell(h, h), layout)
        table = _normal(rng, (vocab, h), dev)
        wo = _normal(rng, (h, vocab), dev)
        bo = torch.zeros(vocab, dtype=torch.float32, device=dev)

        def slot_apply(params, inputs, aux):
            slots = params["slots"]       # engine-threaded, (max_slots, h)
            return {f: gather_rows(slots[f], aux) for f in ChainLM.state_fields}

        self.impls = {
            "E": embed_impl("E", table, "x"),
            "S": _zero_state_impl(h),
            "R": NodeImpl("R", [], {"h_out": (h,), "c_out": (h,)}, slot_apply),
            "C": cell_impl("C", dec, [(1, "x"), (0, "h_out"), (0, "c_out")],
                           ["x", "h", "c"], dec.init_params(rng, device=dev)),
            "O": _out_impl([(0, "h_out")], wo, bo),
        }
        self.cells = {"LSTMCell": dec}

    def init_slots(self, n_slots: int) -> dict[str, torch.Tensor]:
        return {f: torch.zeros((n_slots, self.model_size), dtype=torch.float32,
                               device=self.device)
                for f in self.state_fields}

    def sample_graph(self, rng: random.Random, batch_size: int,
                     lo: int = 4, hi: int = 16) -> Graph:
        """Offline view (scoring a known token sequence), for RL training:
        same types the serve rounds use, S -> (E, C)* -> O per sequence."""
        nodes: list[Node] = []

        def add(type_, inputs=(), aux=0):
            nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                              attrs={"aux": aux}))
            return len(nodes) - 1

        for _ in range(batch_size):
            toks = random_sentence(rng, lo, hi, self.vocab)
            prev = add("S")
            for t in toks:
                e = add("E", aux=t)
                prev = add("C", (prev, e))
                add("O", (prev,))
        return Graph(nodes)


class LSTMNMT:
    name = "LSTM-NMT"

    def __init__(self, model_size: int = 64, seed: int = 0,
                 layout: str = "planned", device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        h = model_size
        self.model_size = h
        self.device = dev
        enc = CompiledCell(lstm_cell(h, h), layout)
        dec = CompiledCell(lstm_cell(h, h), layout)
        src_table = _normal(rng, (VOCAB, h), dev)
        tgt_table = _normal(rng, (OUT_VOCAB, h), dev)
        wo = _normal(rng, (h, OUT_VOCAB), dev)
        bo = torch.zeros(OUT_VOCAB, dtype=torch.float32, device=dev)

        self.impls = {
            "Es": embed_impl("Es", src_table, "x"),
            "Et": embed_impl("Et", tgt_table, "x"),
            "S": _zero_state_impl(h),
            "ENC": cell_impl("ENC", enc, [(1, "x"), (0, "h_out"), (0, "c_out")],
                             ["x", "h", "c"], enc.init_params(rng, device=dev)),
            "DEC": cell_impl("DEC", dec, [(1, "x"), (0, "h_out"), (0, "c_out")],
                             ["x", "h", "c"], dec.init_params(rng, device=dev)),
            "O": _out_impl([(0, "h_out")], wo, bo),
        }
        self.cells = {"LSTMCell": enc}

    def sample_graph(self, rng: random.Random, batch_size: int,
                     lo: int = 8, hi: int = 20) -> Graph:
        nodes: list[Node] = []

        def add(type_, inputs=(), aux=0):
            nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                              attrs={"aux": aux}))
            return len(nodes) - 1

        for _ in range(batch_size):
            src = random_sentence(rng, lo, hi, VOCAB)
            tgt = random_sentence(rng, lo, hi, OUT_VOCAB)
            prev = add("S")
            for t in src:
                e = add("Es", aux=t)
                prev = add("ENC", (prev, e))
            for t in [0] + tgt[:-1]:  # teacher forcing from BOS
                e = add("Et", aux=t)
                prev = add("DEC", (prev, e))
                add("O", (prev,))
        return Graph(nodes)

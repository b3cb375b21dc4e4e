"""Registry of the paper's 8 workloads (Table 1), plus the servable
``ChainLM`` family and the serve subsystem's family -> workload mapping."""

from __future__ import annotations

from .chains import BiLSTMTagger, ChainLM, LSTMNMT
from .lattices import LatticeGRU, LatticeLSTM
from .trees import TreeWorkload


def make_workload(name: str, model_size: int = 64, seed: int = 0,
                  layout: str = "planned", device=None):
    """Build workload ``name`` on ``device`` (``None`` = CUDA, raising when
    CUDA is absent; pass ``"cpu"`` to run on the CPU)."""
    if name == "BiLSTM-Tagger":
        return BiLSTMTagger(model_size, seed, layout, device=device)
    if name == "LSTM-NMT":
        return LSTMNMT(model_size, seed, layout, device=device)
    if name == "ChainLM":
        return ChainLM(model_size, seed, layout, device=device)
    if name in TREE_WORKLOADS:
        return TreeWorkload(name, model_size, seed, layout, device=device)
    if name == "LatticeLSTM":
        return LatticeLSTM(model_size, seed, layout, device=device)
    if name == "LatticeGRU":
        return LatticeGRU(model_size, seed, layout, device=device)
    raise ValueError(name)


WORKLOADS = ["BiLSTM-Tagger", "LSTM-NMT", "TreeLSTM", "TreeGRU", "MV-RNN",
             "TreeLSTM-2Type", "LatticeLSTM", "LatticeGRU"]
CHAIN_WORKLOADS = ["BiLSTM-Tagger", "LSTM-NMT"]
TREE_WORKLOADS = ["TreeLSTM", "TreeGRU", "MV-RNN", "TreeLSTM-2Type"]
LATTICE_WORKLOADS = ["LatticeLSTM", "LatticeGRU"]

# Serve subsystem: request family -> default workload. "lm" is the
# autoregressive chain-LM decode family; "tree" and "lattice" serve
# single-shot classifier / NER request graphs.
SERVE_FAMILIES = {"lm": "ChainLM", "tree": "TreeLSTM", "lattice": "LatticeLSTM"}

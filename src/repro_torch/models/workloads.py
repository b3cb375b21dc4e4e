"""Registry of the paper's workloads (Table 1) plus the servable
``ChainLM`` family. This slice of the port builds the chain workloads; the
tree and lattice workloads come with a later slice."""

from __future__ import annotations

from .chains import BiLSTMTagger, ChainLM, LSTMNMT


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
    if name in TREE_WORKLOADS or name in LATTICE_WORKLOADS:
        raise NotImplementedError(
            f"{name!r} is not ported yet: tree and lattice workloads come "
            f"with the trees-and-lattices slice of the port")
    raise ValueError(name)


WORKLOADS = ["BiLSTM-Tagger", "LSTM-NMT", "TreeLSTM", "TreeGRU", "MV-RNN",
             "TreeLSTM-2Type", "LatticeLSTM", "LatticeGRU"]
CHAIN_WORKLOADS = ["BiLSTM-Tagger", "LSTM-NMT"]
TREE_WORKLOADS = ["TreeLSTM", "TreeGRU", "MV-RNN", "TreeLSTM-2Type"]
LATTICE_WORKLOADS = ["LatticeLSTM", "LatticeGRU"]

"""Roofline terms of a dry-run step on one NVIDIA H100, per device.

Per (arch x shape x mesh), in seconds:

    compute    = hlo_flops / peak           [PEAK_BF16 for a bf16 step,
                                             else PEAK_FLOPS]
    memory     = hlo_bytes / HBM_BW         [HBM3]
    collective = coll_bytes / LINK_BW       [NVLink 4; None: not counted]

What each term counts here (``launch/dryrun.py`` traces the step on the
``meta`` device, where the reference reads a compiled XLA program):

- ``hlo_flops``: each kernel launch's own FLOPs (``kernels/costs.py``:
  flash attention over the pairs its mask lets through, not the plain
  version's full score matrix) plus, for the ops outside the kernels, the
  FLOPs of ``torch.utils.flop_counter``'s formulas (matmuls and
  convolutions; XLA counts elementwise work too), divided by the chips:
  an even split, so work that is replicated on every device is
  undercounted.
- ``hlo_bytes``: each kernel launch's inputs read and outputs written
  once, plus the bytes of every other dispatched aten op's tensor inputs
  and outputs (views and metadata ops count zero), divided by the chips:
  an upper bound with no fusion outside the kernels, where XLA's figure
  is after fusion.
- ``coll_bytes``: one device's bytes of every collective the step
  issues, each counted by its output (the reference's count of its HLO's
  collectives), under the reference's kinds: all-gather, all-reduce,
  reduce-scatter, all-to-all and collective-permute. The step runs on
  the production mesh as DTensors over a fake process group, placed by
  the ``Partitioner``'s specs and the reference's activation constraints
  (``launch/spmd.py``, ``launch/dryrun.py``); DTensor's redistributions
  issue the collectives XLA's partitioner would. Both rematerialise each
  training repeat, so a training step's forward collectives come twice
  (and its forward FLOPs and bytes, above). Where the two differ: XLA
  fuses collectives, reshards by collective-permutes and picks its own
  layouts inside a repeat, where DTensor picks by its cost model (the
  port issues no collective-permute).
- ``bytes_per_device``: the temp bytes (the most bytes, on one device, of
  what the step makes and does not return, live at once) plus the
  argument bytes; XLA's memory analysis in the reference, the dry-run's
  trace of storages and their lifetimes in the port.
  ``dominant`` is taken over the three terms.

The peaks are the H100 SXM 80GB's data-sheet figures at its 700 W limit
(dense, no sparsity). A row's ``dtype`` picks its compute peak. A
bfloat16 step (the dry-run's, as the reference's) runs its products on
the tensor cores in bf16, the hand kernels' and the matmuls outside
them alike, so its compute term divides by ``PEAK_BF16``. A float32 step
runs them in fp32 with TF32 off, so its term divides by ``PEAK_FLOPS``,
the CUDA cores' fp32 rate; the tensor cores' TF32 rate and the 3xTF32
rate (a third of it: fp32-accurate products from three TF32 ones, as the
fp32 hand kernels compute them) are named beside it. A card set below
700 W (``nvidia-smi --query-gpu=power.limit``) runs slower.

MODEL_FLOPS uses 6·N_active·tokens for training and 2·N_active·tokens for
inference, with N_active the parameters less the inactive experts' share.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..train.optimizer import leaves

PEAK_FLOPS = 67e12        # fp32 FLOP/s on the CUDA cores (H100 SXM)
PEAK_BF16 = 989e12        # bf16 FLOP/s on the tensor cores, dense
PEAK_TF32 = 495e12        # TF32 FLOP/s on the tensor cores, dense
PEAK_3XTF32 = PEAK_TF32 / 3   # fp32-accurate products as 3xTF32
HBM_BW = 3.35e12          # HBM3 bytes/s
LINK_BW = 450e9           # NVLink 4 bytes/s each way, an H100 SXM's link
                          # rate (data sheet: 900 GB/s bidirectional per
                          # GPU), not a TPU's ICI


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float | None = None
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0
    bytes_per_device: float = 0.0
    dtype: str = "float32"     # of the step's products: picks the peak

    @property
    def peak_flops(self) -> float:
        return PEAK_BF16 if self.dtype == "bfloat16" else PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float | None:
        return None if self.coll_bytes is None else self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        terms = {k: v for k, v in terms.items() if v is not None}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "bytes_per_device": self.bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
        }


def count_params(spec_tree) -> int:
    return sum(int(np.prod(l.shape)) for l in leaves(spec_tree))


def count_active_params(spec_tree, cfg) -> int:
    """Total minus the inactive expert fraction (6·N_active·D convention)."""
    total = 0
    expert = 0

    def walk(tree):
        nonlocal total, expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("w_gate", "w_up", "w_down") and hasattr(v, "shape") \
                        and len(v.shape) >= 4:
                    expert += int(np.prod(v.shape))
                    total += int(np.prod(v.shape))
                else:
                    walk(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                walk(v)
        elif hasattr(tree, "shape"):
            total += int(np.prod(tree.shape))

    walk(spec_tree)
    if cfg.n_experts:
        frac = cfg.experts_per_token / cfg.n_experts
        return int(total - expert * (1 - frac))
    return total


def model_flops(cfg, spec_tree, shape_name: str, tokens: int) -> float:
    n_active = count_active_params(spec_tree, cfg)
    if shape_name.startswith("train"):
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens

"""Sharding policy: parameter / optimizer / input partition specs.

The reference's ``Partitioner`` (``src/repro/launch/sharding.py``) as
specs alone, for the dry-run on the production meshes
(``launch/mesh.py:make_production_mesh``): Megatron-style tensor
parallelism on the "model" axis, data parallelism on ("pod", "data"); MoE
expert weights are expert-parallel on "model"; optimizer moments take an
extra ZeRO-1-style shard over "data" where divisible.

:class:`PartitionSpec` is a tuple with the reference's constructor and
its canonical form (a one-axis tuple becomes the axis, an empty one None),
so ``tuple(spec)`` compares equal to the reference's. A :class:`Sharding`
pairs a spec with its mesh and gives one device's shard shape.
:meth:`Partitioner.constrain` is the reference's activation constraint:
the identity on a plain tensor (one device), a redistribution on the
dry-run's DTensors (``launch/spmd.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..arch.config import ArchConfig
from .mesh import batch_axes


def _canonical(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        return part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None, an axis name, or a tuple of names
    (the dim split over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))


P = PartitionSpec


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape: tuple[int, ...]) -> tuple[int, ...]:
        """One device's block: each dim divided by the product of the mesh
        axes the spec names for it (rounded up, as a padded shard)."""
        sizes = self.mesh.shape
        out = []
        for i, dim in enumerate(global_shape):
            part = self.spec[i] if i < len(self.spec) else None
            axes = () if part is None else \
                (part,) if isinstance(part, str) else part
            n = int(np.prod([sizes[a] for a in axes])) if axes else 1
            out.append(-(-dim // n))
        return tuple(out)


def _divisible(n: int, k: int) -> bool:
    return n % k == 0 and n >= k


class Partitioner:
    def __init__(self, mesh, cfg: ArchConfig, seq_parallel: bool = False,
                 fsdp: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        self.model_size = mesh.shape["model"]
        self.dp_axes = batch_axes(mesh)
        self.dp_size = int(np.prod([mesh.shape[a] for a in self.dp_axes]))
        self.data_size = mesh.shape["data"]
        # Megatron-style sequence parallelism: residuals sharded over the
        # "model" axis on the sequence dim
        self.seq_parallel = seq_parallel
        # FSDP/ZeRO-3: params (hence grads and the whole optimizer update)
        # additionally sharded over "data"
        self.fsdp = fsdp
        # no_tp: replicate params over "model" (that axis then serves as
        # extra sequence-data parallelism)
        self.no_tp = False

    def named(self, spec: PartitionSpec) -> Sharding:
        return Sharding(self.mesh, spec)

    # -- parameters ----------------------------------------------------------

    def _leaf_spec(self, path: str, shape: tuple[int, ...]) -> PartitionSpec:
        ms = self.model_size
        stacked = path.startswith("blocks/")
        # strip the leading repeat-stack dim from consideration
        dims = list(shape[1:] if stacked else shape)
        off = 1 if stacked else 0

        def mk(axis_idx: int) -> PartitionSpec:
            spec = [None] * len(shape)
            spec[axis_idx + off] = "model"
            return P(*spec)

        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("norm1", "norm2", "final_norm", "norm_scale", "A_log",
                    "D", "dt_bias", "router", "b_in", "b_out"):
            return P()
        if leaf == "embed":
            return P("model", None) if _divisible(shape[0], ms) else P()
        if leaf == "lm_head":
            return P(None, "model") if _divisible(shape[1], ms) else P()
        if leaf in ("w_gate", "w_up", "w_down") and len(dims) == 3:
            # MoE expert weights (E, D, F): expert-parallel on "model"
            return mk(0) if _divisible(dims[0], ms) else P()
        if leaf in ("wo", "w_down", "out_proj"):          # row-parallel
            return mk(0) if _divisible(dims[0], ms) else P()
        if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "in_proj",
                    "conv_w", "conv_b", "bq", "bk", "bv"):  # col-parallel
            last = len(dims) - 1
            if _divisible(dims[last], ms):
                return mk(last)
            return P()
        # fallback: largest divisible dim
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if _divisible(dims[i], ms):
                return mk(i)
        return P()

    def _walk(self, tree, fn, path=""):
        if isinstance(tree, dict):
            return {k: self._walk(v, fn, f"{path}{k}/") for k, v in
                    sorted(tree.items())}
        if isinstance(tree, (tuple, list)):
            out = [self._walk(v, fn, f"{path}{i}/") for i, v in
                   enumerate(tree)]
            return tuple(out) if isinstance(tree, tuple) else out
        return fn(path[:-1], tree)

    def _fsdp_extend(self, spec: PartitionSpec,
                     shape: tuple[int, ...]) -> PartitionSpec:
        """Add a "data" shard on the largest unsharded divisible dim."""
        s = list(spec) + [None] * (len(shape) - len(spec))
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if s[i] is None and _divisible(shape[i], self.data_size):
                s[i] = "data"
                break
        return P(*s)

    def param_specs(self, params_tree) -> Any:
        def f(path, leaf):
            spec = P() if self.no_tp else self._leaf_spec(path, leaf.shape)
            if self.fsdp:
                spec = self._fsdp_extend(spec, leaf.shape)
            return spec

        return self._walk(params_tree, f)

    def param_shardings(self, params_tree):
        return self.to_shardings(self.param_specs(params_tree))

    def opt_specs(self, params_tree) -> Any:
        """AdamW moments: params' spec + ZeRO-1 shard of the largest
        unsharded dim over "data" when divisible."""

        def f(path, leaf):
            base = self._leaf_spec(path, leaf.shape)
            spec = list(base) + [None] * (len(leaf.shape) - len(base))
            order = sorted(range(len(leaf.shape)),
                           key=lambda i: -leaf.shape[i])
            for i in order:
                if spec[i] is None and _divisible(leaf.shape[i],
                                                  self.data_size):
                    spec[i] = "data"
                    break
            return P(*spec)

        mom = self._walk(params_tree, f)
        return {"mu": mom, "nu": self._walk(params_tree, f), "step": P()}

    # -- inputs / activations -------------------------------------------------

    def batch_spec(self, batch_size: int) -> tuple:
        """Axes for a leading batch dim: as much data-parallel as divides."""
        if _divisible(batch_size, self.dp_size):
            return self.dp_axes
        if _divisible(batch_size, self.data_size):
            return ("data",)
        return ()

    def token_spec(self, batch_size: int) -> PartitionSpec:
        return P(self.batch_spec(batch_size) or None, None)

    def cache_specs(self, cache_tree, batch_size: int) -> Any:
        """Decode caches. attn k/v: (R, B, T, KV, Dh) — batch on data axes
        when divisible, else sequence on (data, model); ssm state/conv:
        batch + channel sharding."""
        bspec = self.batch_spec(batch_size)
        ms = self.model_size

        def f(path, leaf):
            shape = leaf.shape
            if path.endswith("/k") or path.endswith("/v"):
                T = shape[2]
                kv = shape[3]
                seq_ax = None
                head_ax = "model" if _divisible(kv, ms) else None
                if head_ax is None and _divisible(T, ms):
                    seq_ax = "model"
                if not bspec:
                    # batch unshardable (long_500k): spread seq over data too
                    if seq_ax == "model" and _divisible(T, ms * self.data_size):
                        return P(None, None, ("data", "model"), head_ax, None)
                    if _divisible(T, self.data_size):
                        return P(None, None, ("data",) if seq_ax is None
                                 else ("data", "model"), head_ax, None)
                return P(None, bspec or None, seq_ax, head_ax, None)
            if path.endswith("/state"):                 # (R, B, h, p, n)
                return P(None, bspec or None, None, None, None)
            if path.endswith("/conv"):                  # (R, B, K-1, ch)
                ch = shape[-1]
                return P(None, bspec or None, None,
                         "model" if _divisible(ch, ms) else None)
            return P()

        return self._walk(cache_tree, f)

    def activation_spec(self, shape: tuple[int, ...],
                        kind: str = "residual") -> PartitionSpec | None:
        """The reference's activation constraint of ``kind`` for a tensor of
        ``shape``, or None where it sets none (a scalar or a vector).
        kinds: residual (B,S,D) — batch on dp, and the sequence on "model"
        under ``seq_parallel`` where it divides; logits / one_hot (B,S,V)
        — batch on dp + vocab on model when divisible; nll (B,S); moe_buf
        (G,E,C,D) — groups on data + experts on model; moe_tokens
        (G,Sg[*K],D) — groups on data; any other rank-2+ tensor batch on
        dp."""
        ndim = len(shape)
        if kind == "moe_buf" and ndim == 4:
            g_ax = "data" if _divisible(shape[0], self.data_size) else None
            e_ax = "model" if _divisible(shape[1], self.model_size) else None
            return P(g_ax, e_ax, None, None)
        if kind == "moe_tokens" and ndim == 3:
            g_ax = "data" if _divisible(shape[0], self.data_size) else None
            return P(g_ax, None, None)
        bspec = self.batch_spec(shape[0]) or None
        if kind in ("logits", "one_hot") and ndim == 3:
            v = "model" if _divisible(shape[-1], self.model_size) else None
            return P(bspec, None, v)
        if kind == "nll" and ndim == 2:
            return P(bspec, None)
        if kind == "residual" and ndim == 3 and self.seq_parallel \
                and _divisible(shape[1], self.model_size):
            return P(bspec, "model", None)
        if ndim >= 2:
            return P(*([bspec] + [None] * (ndim - 1)))
        return None

    def constrain(self, x, kind: str = "residual"):
        """The reference's ``constrain``: ``x`` placed as
        :meth:`activation_spec` says. A plain tensor (one device) is
        returned as it is; a DTensor (the dry-run's production mesh) is
        redistributed to the spec's placements, the counterpart of
        ``with_sharding_constraint`` (``launch/spmd.py:constrain``)."""
        spec = self.activation_spec(tuple(x.shape), kind)
        return x if spec is None else self.place(x, spec)

    def place(self, x, spec: PartitionSpec):
        """``x`` constrained to ``spec``: the identity on a plain tensor."""
        if type(x) is torch.Tensor:
            return x
        from . import spmd
        return spmd.constrain(x, spec) if spmd.is_sharded(x) else x

    def local(self, fn, in_specs, out_spec):
        """``fn`` as a region that moves nothing between devices, its
        arguments placed by ``in_specs`` and its output by ``out_spec``
        (``launch/spmd.py:local``): ``shard_map``'s contract. ``fn``
        itself on plain tensors."""
        from . import spmd
        return spmd.local(fn, in_specs, out_spec)

    def block_specs(self, single_layer_tree) -> Any:
        """Specs for an unstacked single pattern-group param tree. Applies
        the same variant transforms (no_tp / fsdp) as param_specs."""
        return self.param_specs(single_layer_tree)

    def to_shardings(self, spec_tree):
        if isinstance(spec_tree, PartitionSpec):
            return self.named(spec_tree)
        if isinstance(spec_tree, dict):
            return {k: self.to_shardings(v) for k, v in spec_tree.items()}
        return type(spec_tree)(self.to_shardings(v) for v in spec_tree)

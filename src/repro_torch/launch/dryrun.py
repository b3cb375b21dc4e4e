"""Dry-run: the dynamic workloads' plans built and run once on the card,
and every (architecture x input shape) step reckoned on the production
mesh without running it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --dynamic [--device cpu] [--out r.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]

``--dynamic`` (:func:`dryrun_dynamic`) builds each Table-1 workload's
per-topology plan on ``--device`` (default the card), runs it once (on
the card: lowered, captured as a CUDA graph and replayed) and reports its
``PlanStats``. The arch sweep (:func:`dryrun_one`) builds the model, its
parameters, the AdamW state, the inputs and the decode caches as empty
tensors on the ``meta`` device at full width and depth, so nothing is
allocated, and traces the step once: the forward, and for a training shape
also the loss, the backward and the functional AdamW. A training step's
model checkpoints each repeat's block (``remat``, as the reference's
dry-run builds it; with ``--layer-remat`` each layer inside it too), so
the traced backward recomputes the blocks' forward. The kernel wrappers
take the card's route on meta, a plain version standing in for each
launch (``kernels/ref.py:stand_in``). Where the reference lowers and
compiles on 256 or 512 placeholder host devices, the step runs on the
production mesh's shape (``launch/mesh.py:ShapeMesh``) as DTensors over a
fake process group of its size (``launch/spmd.py``): every argument leaf
is a DTensor of its ``Partitioner`` spec (a dim split over two axes,
``("data", "model")`` or ``("pod", "data")``, is ``Shard`` of that dim on
both mesh dims, the first the outer split), the model constrains its
activations as the reference's (``Partitioner.constrain``), and DTensor
places every op, its local tensors empty on meta. Each row's fields
count:

- ``arg_bytes``: exact. One device's shard bytes of every argument of the
  step (parameters, the AdamW moments and ``step``, the inputs, the
  caches), from the ``Partitioner``'s specs and the leaves' dtypes, which
  are the reference's: the model in bf16 (parameters, caches and the
  image embeddings), the moments in fp32, tokens and positions int32.
- ``hlo_flops``: each kernel launch's own FLOPs (``kernels/costs.py``, as
  ``chip_smoke.py``'s bounds count them: flash attention over the causal
  pairs only) plus, for the ops outside the kernels, what
  ``torch.utils.flop_counter`` counts (matmuls, convolutions; no
  elementwise work), at the ops' global shapes, divided by the chips, an
  even split: work replicated on every device is undercounted. The
  compute term divides them by the bf16 tensor-core peak
  (``launch/roofline.py``).
- ``hlo_bytes``: each kernel launch's inputs read and outputs written
  once at its operands' element sizes, plus every other dispatched aten
  op's tensor input and output bytes (views and metadata ops zero), at
  global shapes, divided by the chips: an upper bound with no fusion
  outside the kernels. The placement moves neither count: DTensor's own
  ops (its redistributions' copies, its sharding rules' local ops) are not
  the step's, and a view's output keeps the strides it has unplaced, so
  the composite ops decide as they do on one device.
- ``coll_bytes`` and ``coll_breakdown``: the output bytes of every
  functional collective the placed step issues (``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single`` and DTensor's ``shard_dim_alltoall``), per device,
  under the reference's kinds (``wait_tensor`` and the like count
  nothing): the forward's, the backward's (its gradients reduced over the
  data axes once, each to its parameter's placements) and AdamW's (the
  ZeRO-1 moments' shards). A training row counts its blocks' forward
  collectives twice, once more in the backward's recomputation, as the
  reference's remat issues them (the FLOPs and bytes of the recomputed
  forward count too). The reference counts its compiled HLO's;
  ``launch/roofline.py`` names where the two differ (resharding permutes,
  fused collectives). Rules the placement adds to DTensor's
  (``launch/spmd.py``): a
  softmax or logsumexp over a split dim runs as its decomposition, reduced
  across the shards; a partial sum meeting the residual is reduced to the
  residual's layout; a row lookup into a vocab-split table is a masked
  lookup and a reduction; the kernels' plain versions run on their
  operands' local shards, attention split by batch and heads, the scan by
  batch (``on_shards``); the MoE's two gathers are regions that move
  nothing, its expert outputs gathered over "model" for the combine
  (``arch/layers.py:moe``); an op DTensor cannot place gathers its
  operands (tallied in the counter's ``resharded``).
- ``model_flops``: 6 (training) or 2 times the active parameters times
  the tokens (``launch/roofline.py``).
- ``output_bytes``: exact. One device's shard bytes of the step's output
  leaves (a training step's parameters, moments, step and loss; the
  logits and caches), as ``arg_bytes`` counts the arguments.
- ``peak_bytes``: ``arg_bytes`` plus the most bytes of the storages the
  step makes live at once on one device, from the same trace
  (:class:`StepCounter`'s memory term): each storage once, whatever views
  share it (a DTensor's by its local shard, a collective's output, a
  plain tensor inside a region that moves nothing by its device's
  share), from the op that makes it until its last reference dies. On
  meta tensors Python's reference counts give eager's own lifetimes, so
  autograd's saved tensors live until the backward frees them and remat's
  saving shows. A plain version standing in for a kernel adds only what
  outlives it (its outputs and what its autograd function saves), never
  the intermediates the kernel does not make; a view, an in-place or an
  ``out=`` op, and a write the placement leaves undone, make nothing.
  DTensor's own temporaries while it places an op are not seen.
- ``temp_bytes``: the same high-water mark over the storages that are not
  the step's outputs (XLA's temp: neither arguments nor outputs);
  ``bytes_per_device`` is ``temp_bytes + arg_bytes``, as the reference's.

``compile_s`` is the row's seconds (building the tree, placing it and the
trace). ``--seq-parallel`` places the residuals on "model" along the
sequence (the reference's ``seq_parallel``; ``+sp`` in the row's note),
``--layer-remat`` checkpoints each layer of a training step's blocks too
(``+lremat``). Importing this
module changes no environment; the fake process group lives for one row.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..arch.model import TransformerLM
from ..configs import ARCHS, get_config
from ..core.device import resolve_device
from ..kernels import ref
from ..train.optimizer import (AdamWConfig, adamw_update, init_opt_state,
                               leaves, unflatten)
from . import spmd
from .mesh import make_production_mesh
from .roofline import Roofline, model_flops
from .sharding import P, Partitioner

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

SLIDING_WINDOW_500K = 8192  # sub-quadratic variant for full-attention archs

META = torch.device("meta")

# ops that move no data: their outputs alias their inputs (views, by the
# schema) or are uninitialised, or they read only metadata
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_like,
            torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
            torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh,
            torch.ops.aten.sym_size, torch.ops.aten.sym_stride,
            torch.ops.aten.sym_numel, torch.ops.aten.sym_storage_offset,
            torch.ops.aten.is_same_size}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _aliases(func) -> bool:
    """Whether ``func``'s schema has an output alias an input (a view, an
    in-place or an ``out=`` op): such an output makes no storage."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _storages(tree):
    """The storages under a tree's tensors: a DTensor's local tensor's (one
    device's shard), a plain tensor's own."""
    for t in tree_leaves(tree):
        if isinstance(t, spmd.DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and t.layout == torch.strided:
            yield t.untyped_storage()


class StepCounter(TorchDispatchMode):
    """Counts a traced step's ``flops`` and ``bytes``. A kernel launch adds
    its own work (:meth:`add`, called by ``kernels/ref.py:stand_in``) and
    the ops of the plain version standing in for it are not counted
    (``muted``). Every other dispatched aten op adds its tensor inputs' and
    outputs' bytes (views and metadata ops zero: the bytes an unfused run
    would move) and the FLOPs ``torch.utils.flop_counter``'s formulas give
    it; an op without a formula is decomposed where it can be, as
    ``FlopCounterMode`` does. On DTensor operands (the step placed on a
    mesh) an op is counted at its global shapes, then placed
    (:meth:`_sharded`); the output bytes of every collective its placement
    issues add to ``collectives`` by the reference's kind.

    It also keeps the step's memory: every storage an op makes (a DTensor
    output's by its local shard; a collective's output; a plain tensor's
    times :func:`spmd.share`, its per-device share inside a region that
    moves nothing), once whatever views share it, from the op that makes
    it until its last reference dies (a weak reference's callback: on meta
    tensors Python's reference counts give eager's own lifetimes, autograd's
    saved tensors included). A plain version standing in for a kernel adds
    only what survives it (what it returns, and what its autograd function
    saves): its intermediates, which the kernel never makes, add nothing.
    DTensor's own temporaries while it places an op are not seen. The
    events (made, freed) are settled after the step (:meth:`settle`)."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0
        self.muted = False
        self.formulas = FlopCounterMode(display=False).flop_registry
        self.collectives = dict.fromkeys(spmd.REFERENCE_KINDS, 0)
        self.resharded: dict[str, int] = {}
        self._inner = 0          # nesting of DTensor's own dispatch
        self._yield = False
        # the memory term: (storage serial, +bytes made / -bytes freed)
        self.events: list[tuple[int, int]] = []
        self._live: dict[int, int] = {}   # live storage -> its serial
        self._refs: dict[int, weakref.ref] = {}
        self._pending: list = []          # what a stand-in made
        self.high_water = self.temp_high_water = self.output_bytes = 0

    def add(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def unmute(self) -> None:
        """The end of a stand-in: what it made and is still referenced
        (its outputs, what its autograd function saves) counts from now."""
        self.muted = False
        pending, self._pending = self._pending, []
        for ref_, nbytes in pending:
            st = ref_()
            if st is not None:
                self._made(st, nbytes)

    def _made(self, st, nbytes: int) -> None:
        key = st._cdata
        if key in self._live:
            return
        serial = len(self.events) + 1
        self._live[key] = serial
        self._refs[serial] = weakref.ref(
            st, lambda _, key=key, serial=serial, nbytes=nbytes:
            self._freed(key, serial, nbytes))
        self.events.append((serial, nbytes))

    def _freed(self, key: int, serial: int, nbytes: int) -> None:
        if self._live.get(key) == serial:
            del self._live[key]
        del self._refs[serial]
        self.events.append((serial, -nbytes))

    def _track(self, out, scale: float = 1.0) -> None:
        if spmd.ALIAS:
            return
        for st in _storages(out):
            if st._cdata in self._live:
                continue
            nbytes = int(st.nbytes() * scale)
            if self.muted:
                self._pending.append((weakref.ref(st), nbytes))
            else:
                self._made(st, nbytes)

    def settle(self, outputs) -> None:
        """After the step: ``high_water``, the most bytes of storages made
        in the step live at once; ``temp_high_water``, the same over those
        that are not the step's outputs; ``output_bytes``, one device's
        bytes of the output leaves."""
        out = {self._live.get(st._cdata) for st in _storages(outputs)}
        live = temp = 0
        for serial, delta in self.events:
            live += delta
            self.high_water = max(self.high_water, live)
            if serial not in out:
                temp += delta
                self.temp_high_water = max(self.temp_high_water, temp)
        self.output_bytes = sum(
            t.numel() * t.element_size()
            for t in (x._local_tensor if isinstance(x, spmd.DTensor) else x
                      for x in tree_leaves(outputs))
            if isinstance(t, torch.Tensor))
        self._refs.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._yield:
            # the re-entry of :meth:`_sharded`'s call: DTensor takes it
            self._yield = False
            return NotImplemented
        kind = spmd.collective_kind(func)
        if kind is not None:
            out = func(*args, **kwargs)
            self.collectives[kind] += _tensor_bytes(out)
            self._track(out)
            return out
        sharded = any(issubclass(t, spmd.DTensor) for t in types)
        if self.muted or self._inner or spmd.QUIET:
            out = self._sharded(func, args, kwargs) if sharded \
                else func(*args, **kwargs)
            if not self._inner and not _aliases(func):
                self._track(out, 1.0 if sharded or spmd.QUIET
                            else spmd.share())
            return out
        packet = func.overloadpacket
        if packet not in self.formulas:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._sharded(func, args, kwargs) if sharded \
            else func(*args, **kwargs)
        if packet in self.formulas:
            self.flops += self.formulas[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_DATA:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        if not _aliases(func):
            self._track(out, 1.0 if sharded else spmd.share())
        return out

    def on_shards(self, fn, args, labels, out_labels, shardable):
        """``fn`` placed by a sharding rule of dim labels
        (``kernels/ref.py:reckon``, :func:`spmd.on_shards`)."""
        return spmd.on_shards(fn, args, labels, out_labels, shardable)

    def _sharded(self, func, args, kwargs):
        """``func`` on DTensor operands, dispatched by DTensor with this
        mode still on: its local ops pass uncounted and its collectives
        are counted. Where DTensor cannot place the operands as they are,
        :func:`spmd.reshard_and_retry` takes over (its route tallied by op
        in ``resharded``); a failed attempt's collectives are not
        counted."""
        if func._schema.is_mutable and args and (
                type(args[0]) is torch.Tensor
                or func in spmd.WRITES_BY_INDEX):
            # a write into a tensor made inside the step (a replica), or
            # by index into a placed one (a decode cache): the rows'
            # owners write them where they lie
            key = f"{func} (in place, left undone)"
            self.resharded[key] = self.resharded.get(key, 0) + 1
            return args[0]
        self._inner += 1
        try:
            out = spmd.on_replicas(func, args, kwargs)
            if out is None:
                out = spmd.on_same_shards(func, args, kwargs)
            if out is not None:
                return out
            decomposed = spmd.decomposition(func)
            # the mode is pushed again around every redistribution made
            # here, so that their collectives reach it
            with self:
                if decomposed is not None:
                    return decomposed(*args, **kwargs)
                args = spmd.align_sum(func, args)
                out = spmd.lookup(func, args, lambda f, a: self._attempt(
                    a, kwargs, f, pushed=True))
            if out is not None:
                return out
            out = self._attempt(args, kwargs, func)
            with self:
                return spmd.restride(func, args, kwargs, out)
        except spmd.UNPLACEABLE as err:
            with self:
                out, how = spmd.reshard_and_retry(
                    lambda a, k: self._attempt(a, k, func, pushed=True),
                    func, args, kwargs, err)
                out = spmd.restride(func, args, kwargs, out)
            key = f"{func} ({how})"
            self.resharded[key] = self.resharded.get(key, 0) + 1
            return out
        finally:
            self._inner -= 1

    def _attempt(self, args, kwargs, func, pushed=False):
        counted = dict(self.collectives)
        self._yield = True
        try:
            if pushed:
                out = func(*args, **kwargs)
            else:
                with self:
                    out = func(*args, **kwargs)
            spmd.check_plain(out)
            return out
        except spmd.UNPLACEABLE:
            self.collectives = counted
            raise
        finally:
            self._yield = False

def count_step(fn, *args) -> StepCounter:
    """One call of ``fn(*args)`` under a :class:`StepCounter`, returned,
    its memory settled against the call's outputs. Tensors made inside the
    step (positions, masks, zeros) are replicas beside DTensor operands
    (``implicit_replication``)."""
    counter = StepCounter()
    outer, ref.RECKONER = ref.RECKONER, counter
    try:
        with counter, implicit_replication():
            out = fn(*args)
    finally:
        ref.RECKONER = outer
        spmd.BACKWARD = 1.0
    counter.settle(out)
    return counter


def count_placed(fn, args, shardings, mesh) -> StepCounter:
    """One call of ``fn(*args)`` with every argument leaf a DTensor of its
    ``Sharding`` on ``mesh`` (``launch/spmd.py:fake_mesh``, torn down on
    return), under a :class:`StepCounter`, returned."""
    with spmd.fake_mesh(mesh) as dmesh:
        placed = unflatten(args, [
            spmd.distribute(t, sh, dmesh)
            for t, sh in zip(leaves(args), leaves(shardings), strict=True)])
        return count_step(fn, *placed)


def trace_counts(fn, *args) -> tuple[int, int]:
    """``(flops, bytes)`` of one call of ``fn(*args)``, as
    :class:`StepCounter` counts them (all devices' work: nothing is
    divided)."""
    counter = count_step(fn, *args)
    return counter.flops, counter.bytes


def resolve_config(arch: str, shape: str):
    cfg = get_config(arch)
    note = ""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        cfg = cfg.with_sliding_window(SLIDING_WINDOW_500K)
        note = f"(SW{SLIDING_WINDOW_500K})"
    return cfg, note


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: str, shape: str, model: TransformerLM,
                part: Partitioner):
    """Empty meta stand-ins and shardings for every model input (int32
    tokens and positions, the image embeddings in the model's dtype, as
    the reference's)."""
    cfg = model.cfg
    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    i32 = torch.int32
    tok_sharding = part.named(part.token_spec(B))
    if info["kind"] in ("train", "prefill"):
        specs = {"tokens": _meta((B, S), i32)}
        shardings = {"tokens": tok_sharding}
        if info["kind"] == "train":
            specs["labels"] = _meta((B, S), i32)
            shardings["labels"] = tok_sharding
        if cfg.n_image_tokens:
            specs["image_embeds"] = _meta((B, cfg.n_image_tokens,
                                           cfg.d_model), model.dtype)
            shardings["image_embeds"] = part.named(
                P(part.batch_spec(B) or None, None, None))
        return specs, shardings
    # decode
    caches = model.cache_specs(B, S)
    specs = {"token": _meta((B,), i32), "caches": caches,
             "pos": _meta((), i32)}
    shardings = {
        "token": part.named(P(part.batch_spec(B) or None)),
        "caches": part.to_shardings(part.cache_specs(caches, B)),
        "pos": part.named(P()),
    }
    return specs, shardings


def _value_and_grad(model: TransformerLM, params, batch):
    """``(loss, grads)`` of ``model.loss`` at ``params``, as
    ``jax.value_and_grad``. On the production mesh each gradient takes its
    parameter's placements (a partial sum over the data axes reduced
    once), as XLA reduces a replicated parameter's gradient."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = model.loss(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    grads = [spmd.place(g, p.placements) if spmd.is_sharded(g) else g
             for g, p in zip(grads, flat)]
    return loss.detach(), unflatten(params, grads)


def build_step(arch: str, shape: str, model: TransformerLM,
               part: Partitioner, grad_accum: int = 1):
    """Returns ``(fn, args, arg_shardings)``: the step and its arguments
    as meta tensors, with one ``Sharding`` per argument leaf in the same
    tree structure."""
    kind = SHAPES[shape]["kind"]
    param_tree = model.param_specs()
    param_shardings = part.param_shardings(param_tree)
    in_specs, in_shardings = input_specs(arch, shape, model, part)

    if kind == "train":
        opt_cfg = AdamWConfig()
        opt_state = init_opt_state(param_tree)
        opt_shardings = part.to_shardings(part.opt_specs(param_tree))

        def train_step(params, opt_state, batch):
            if grad_accum > 1:
                # summed in fp32, divided, then cast to bf16, as the
                # reference accumulates its microbatches
                gsum, lsum = None, 0.0
                for i in range(grad_accum):
                    mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    loss, g = _value_and_grad(model, params, mb)
                    g = [a.float() for a in leaves(g)]
                    gsum = g if gsum is None else [
                        a + b for a, b in zip(gsum, g)]
                    lsum = lsum + loss
                grads = unflatten(params, [(g / grad_accum).bfloat16()
                                           for g in gsum])
                loss = lsum / grad_accum
            else:
                loss, grads = _value_and_grad(model, params, batch)
            params, opt_state, _ = adamw_update(opt_cfg, params, grads,
                                                opt_state)
            return params, opt_state, loss

        return (train_step, (param_tree, opt_state, in_specs),
                (param_shardings, opt_shardings, in_shardings))

    if kind == "prefill":
        def prefill_step(params, batch):
            return model.prefill(params, batch["tokens"],
                                 batch.get("image_embeds"))

        return (prefill_step, (param_tree, in_specs),
                (param_shardings, in_shardings))

    def serve_step(params, token, caches, pos):
        return model.decode_step(params, token, caches, pos)

    return (serve_step, (param_tree, in_specs["token"], in_specs["caches"],
                         in_specs["pos"]),
            (param_shardings, in_shardings["token"], in_shardings["caches"],
             in_shardings["pos"]))


def arg_bytes(args, shardings) -> int:
    """One device's bytes of every argument leaf: its shard's elements
    times its element size."""
    total = 0
    for t, sh in zip(leaves(args), leaves(shardings), strict=True):
        total += math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
    return total


def dryrun_one(arch: str, shape: str, *, multi_pod: bool = False,
               verbose: bool = True, seq_parallel: bool = False,
               layer_remat: bool = False, fsdp: bool = False,
               grad_accum: int = 1, no_tp: bool = False) -> dict:
    """Reckon one (arch, shape) step of the bf16 model, as the reference
    builds it (a training step with each repeat checkpointed, and with
    ``layer_remat`` each layer too), on the 16x16 (or 2x16x16) mesh on the
    meta device; a row of the reference's keys (module docstring)."""
    t0 = time.time()
    cfg, note = resolve_config(arch, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    part = Partitioner(mesh, cfg, seq_parallel=seq_parallel, fsdp=fsdp)
    part.no_tp = no_tp
    model = TransformerLM(cfg, torch.bfloat16, device=META,
                          remat=SHAPES[shape]["kind"] == "train")
    model.layer_remat = layer_remat
    model.partitioner = part
    note += (("+sp" if seq_parallel else "")
             + ("+lremat" if layer_remat else "") + ("+fsdp" if fsdp else "")
             + (f"+ga{grad_accum}" if grad_accum > 1 else "")
             + ("+notp" if no_tp else ""))
    fn, args, shardings = build_step(arch, shape, model, part, grad_accum)
    n_arg_bytes = arg_bytes(args, shardings)
    counter = count_placed(fn, args, shardings, mesh)
    flops, nbytes = counter.flops, counter.bytes
    coll = {k: v for k, v in counter.collectives.items() if v}
    info = SHAPES[shape]
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    chips = int(mesh.devices.size)
    rl = Roofline(
        arch=arch, shape=shape + note,
        mesh="x".join(map(str, mesh.devices.shape)), chips=chips,
        hlo_flops=flops / chips,
        hlo_bytes=nbytes / chips,
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=model_flops(cfg, args[0], shape, tokens),
        bytes_per_device=float(counter.temp_high_water + n_arg_bytes),
        dtype="bfloat16",
    )
    row = rl.row()
    row.update({
        "ok": True,
        "compile_s": round(time.time() - t0, 1),
        "temp_bytes": counter.temp_high_water,
        "arg_bytes": n_arg_bytes,
        "output_bytes": counter.output_bytes,
        "peak_bytes": n_arg_bytes + counter.high_water,
        "hlo_bytes": rl.hlo_bytes,
        "coll_bytes": rl.coll_bytes,
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape}{note} on {row['mesh']}: OK "
              f"compute {rl.t_compute*1e3:.2f}ms memory "
              f"{rl.t_memory*1e3:.2f}ms collective "
              f"{rl.t_collective*1e3:.2f}ms -> {rl.dominant}-bound; "
              f"useful {rl.useful_ratio:.2f}; args/dev "
              f"{n_arg_bytes / 2**30:.2f}GiB temp/dev "
              f"{row['temp_bytes'] / 2**30:.2f}GiB ({row['compile_s']}s "
              f"trace)"
              + "".join(f"; {n} x {how}"
                        for how, n in counter.resharded.items()),
              flush=True)
    return row


def dryrun_dynamic(workloads=None, model_size: int = 16, batch_size: int = 2,
                   seed: int = 0, verbose: bool = True, device=None,
                   skip=()) -> list[dict]:
    """Build the dynamic workloads' per-topology plans (core/plan.py) on
    ``device`` (None: the card) and report the lowering outcome per
    workload: step/arena counts, how many operands became contiguous
    slices vs gather fallbacks, and the lowering time. Each plan runs
    once: on the card it is lowered, captured as a CUDA graph and
    replayed, so ``n_compiles`` and ``compile_time_s`` count captures and
    their seconds (on the CPU, the eager build). The dynamic-graph
    counterpart of the static arch sweep. One rng draws every workload's
    graph in turn; a workload in ``skip`` has its graph drawn but no plan
    built and no row, so the others' rows stay those of the full sweep."""
    import random

    from ..core.batching import SufficientConditionPolicy
    from ..core.plan import PlanExecutor
    from ..models.workloads import WORKLOADS, make_workload

    device = resolve_device(device)
    rng = random.Random(seed)
    rows = []
    for name in workloads or WORKLOADS:
        t0 = time.time()
        try:
            wl = make_workload(name, model_size, seed, layout="planned",
                               device=device)
            g = wl.sample_graph(rng, batch_size)
            if name in skip:
                continue
            ex = PlanExecutor(wl.impls, None, device=device)
            policy = SufficientConditionPolicy()
            ex.run(g, policy)            # lower + capture + one replay
            stats = ex.plan_for(g, policy).stats
            row = {"workload": name, "ok": True, "nodes": len(g),
                   "wall_s": round(time.time() - t0, 2), **stats.as_dict()}
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            row = {"workload": name, "ok": False, "error": str(e)[:500]}
        rows.append(row)
        if verbose and row["ok"]:
            print(f"[dryrun-dynamic] {name}: {row['n_steps']} steps -> 1 "
                  f"dispatch, {row['n_arenas']} arenas ({row['layout']} "
                  f"layout), {row['n_slice_reads']} slice / "
                  f"{row['n_gather_reads']} gather reads, "
                  f"{row['n_gather_fallback_steps']} fallback steps, "
                  f"compile {row['compile_time_s']:.2f}s", flush=True)
    return rows


def _write(path: str, rows: list[dict], failures: int) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(f"wrote {path} ({len(rows)} rows, {failures} failures)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dynamic", action="store_true",
                    help="build the dynamic-workload execution plans "
                         "instead of the static arch x shape sweep")
    ap.add_argument("--device", default="cuda",
                    help="--dynamic's device (the arch sweep runs on meta)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="residuals sharded over model on the sequence")
    ap.add_argument("--layer-remat", action="store_true",
                    help="nested per-layer remat (perf variant)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 parameter sharding over data (perf variant)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatch gradient accumulation (perf variant)")
    ap.add_argument("--no-tp", action="store_true",
                    help="replicate params; model axis = seq-data parallel")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.dynamic:
        rows = dryrun_dynamic(device=args.device)
        failures = sum(1 for r in rows if not r["ok"])
        if args.out:
            _write(args.out, rows, failures)
        return 1 if failures else 0

    if args.all:
        combos = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("need --all or both --arch and --shape")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rows = []
    failures = 0
    for arch, shape in combos:
        for mp in meshes:
            try:
                rows.append(dryrun_one(arch, shape, multi_pod=mp,
                                       seq_parallel=args.seq_parallel,
                                       layer_remat=args.layer_remat,
                                       fsdp=args.fsdp,
                                       grad_accum=args.grad_accum,
                                       no_tp=args.no_tp))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                traceback.print_exc()
                rows.append({"arch": arch, "shape": shape,
                             "mesh": "2x16x16" if mp else "16x16",
                             "ok": False, "error": str(e)[:500]})
    if args.out:
        _write(args.out, rows, failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

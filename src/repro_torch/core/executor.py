"""Dynamic-graph batched executor (the DyNet-executor analogue, §4).

Executes a typed dataflow :class:`Graph` whose nodes are cell invocations /
embedding lookups / output projections, following a batch schedule produced
by any batching policy. Per-node outputs live in flat stores, one per field
signature (shape); each batch gathers its inputs by index, runs the node
type's batched implementation once, and scatters the outputs. Schedules are
cached per topology (trace-time scheduling — see DESIGN.md deviation #2).

Timing is decomposed exactly as the paper's Fig. 8: construction (graph
building, done by the workload), scheduling (batching analysis), and
execution (batched op launches).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell
from repro_torch.kernels.gather_batch import gather_rows
from repro_torch.obs.tracer import Tracer, default_tracer

from .batching import Policy, Schedule, policy_cache_key, resolve_schedule
from .cache import FIFOCache
from .device import Published, block, capturing, resolve_device
from .graph import Graph, TypeId


class NodeImpl:
    """Batched implementation of one node type.

    ``out_fields``: names/shapes of the node's output fields.
    ``apply(params, inputs, aux)``: inputs is a list of stacked (k, ...)
    tensors (one per input slot, gathered from predecessor fields);
    ``aux`` is a (k,) int32 tensor of per-node static attributes (token
    ids). Returns dict field -> (k, *shape).

    ``params``: the impl's own tensors by name (``pbuf``, ``table``, ``wo``,
    ``bo``), read on every call; :mod:`repro_torch.models.convert` installs
    weights there. Threaded ``params={impl name: buffer}`` passed to an
    executor override them.

    ``fused_gather`` (optional): a gather-free fast path used by the
    bucketed plan executor — ``fused_gather(params, bufs, idxs, aux)``
    receives the *source arenas* plus per-slot row-index vectors instead of
    pre-gathered inputs and returns the same output dict, letting a kernel
    feed the cell math straight from the arenas (see
    :mod:`repro_torch.kernels.fused_gather_cell`).
    """

    def __init__(self, name: str, in_slots: list[tuple[int, str]],
                 out_fields: dict[str, tuple[int, ...]],
                 apply: Callable[..., dict[str, torch.Tensor]],
                 fused_gather: Callable[..., dict[str, torch.Tensor]] | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        self.name = name
        self.in_slots = in_slots          # (pred position, field name)
        self.out_fields = out_fields
        self.apply = apply
        self.fused_gather = fused_gather
        self.params = params if params is not None else {}


@dataclass
class ExecStats:
    n_batches: int = 0
    n_launches: int = 0          # program runs (1/run on the plan path)
    n_compiles: int = 0          # program builds (plan paths only)
    schedule_time: float = 0.0
    exec_time: float = 0.0
    lower_time: float = 0.0      # plan lowering + program build (plan path only)


def _rows(ids, device: torch.device) -> torch.Tensor:
    """Row-index vector for :func:`gather_rows` (int32, on ``device``)."""
    return torch.as_tensor(np.asarray(ids, np.int32), device=device)


class ExecResult:
    """Per-field flat buffers (n_nodes, *shape) plus lazy per-node access."""

    def __init__(self, graph: Graph, impls, bufs: dict):
        self._graph = graph
        self._impls = impls
        self.bufs = bufs

    def node(self, i: int) -> dict[str, torch.Tensor]:
        impl = self._impls[self._graph.nodes[i].type]
        out = {}
        for f, shape in impl.out_fields.items():
            out[f] = self.bufs[(f, tuple(shape))][i]
        return out

    def nodes_with_field(self, fld: str):
        for n in self._graph.nodes:
            impl = self._impls.get(n.type)
            if impl and fld in impl.out_fields:
                yield n.id

    def field(self, fld: str, ids) -> torch.Tensor:
        shapes = set()
        for i in ids:
            impl = self._impls[self._graph.nodes[i].type]
            if fld not in impl.out_fields:
                raise KeyError(f"node {i} ({impl.name}) has no field {fld!r}")
            shapes.add(tuple(impl.out_fields[fld]))
        if len(shapes) != 1:
            raise ValueError(
                f"field {fld!r} has mixed shapes {sorted(shapes)} across the "
                f"requested nodes; select per-shape node subsets instead")
        buf = self.bufs[(fld, shapes.pop())]
        return gather_rows(buf, _rows(ids, buf.device))


class DynamicExecutor:
    def __init__(self, impls: dict[TypeId, NodeImpl], params: Any, *,
                 schedule_cache: FIFOCache | None = None,
                 namespace: Any = None, tracer: Tracer | None = None,
                 device=None):
        self.impls = impls
        self.params = params
        self.device = resolve_device(device)
        # FIFO-capped: keys hold policy fingerprints (or references), values
        # whole schedules. A shared cache (serve layer) is namespaced so
        # different impl sets never alias each other's topologies.
        self._schedule_cache = (schedule_cache if schedule_cache is not None
                                else FIFOCache(1024))
        self._ns = namespace
        self.tracer = tracer if tracer is not None else default_tracer()

    def run(self, graph: Graph, policy: Policy | Callable[[Graph], Schedule],
            stats: ExecStats | None = None,
            params: Any = None) -> ExecResult:
        stats = stats if stats is not None else ExecStats()
        t0 = time.perf_counter()
        # "sched" tags the entry kind, so a cache shared with the compiled
        # executors can never hand back (or be handed) the wrong artifact.
        key = ("sched", self._ns, graph.topology_key(),
               policy_cache_key(policy))
        with self.tracer.span("interp.schedule", cat="interp"):
            sched = self._schedule_cache.get(key)
            if sched is None:
                sched = resolve_schedule(graph, policy)
                self._schedule_cache[key] = sched
        stats.schedule_time += time.perf_counter() - t0

        t1 = time.perf_counter()
        params = params if params is not None else self.params
        dev = self.device
        N = len(graph)
        with self.tracer.span("interp.exec", cat="interp",
                              n_batches=len(sched)):
            # flat per-(field, shape) stores: (n_nodes, *shape) — one gather
            # per input operand and one scatter per output field per batch.
            bufs: dict[tuple, torch.Tensor] = {}
            nodes = graph.nodes
            for t, ids in sched:
                impl = self.impls[t]
                idx = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
                inputs = []
                for (slot, fld) in impl.in_slots:
                    src = [nodes[i].inputs[slot] for i in ids]
                    shapes = {tuple(self.impls[nodes[p].type].out_fields[fld])
                              for p in src}
                    if len(shapes) != 1:
                        raise ValueError(
                            f"batch of {t!r} slot {slot} field {fld!r} mixes "
                            f"element shapes {sorted(shapes)}; such batches "
                            f"cannot gather from one buffer")
                    inputs.append(gather_rows(bufs[(fld, shapes.pop())],
                                              _rows(src, dev)))
                aux = _rows([n.attrs.get("aux", 0)
                             for n in (nodes[i] for i in ids)], dev)
                out = impl.apply(params, inputs, aux)
                for f, shape in impl.out_fields.items():
                    k = (f, tuple(shape))
                    if k not in bufs:
                        bufs[k] = torch.zeros((N,) + tuple(shape),
                                              dtype=out[f].dtype, device=dev)
                    bufs[k].index_copy_(0, idx, out[f].to(bufs[k].dtype))
                stats.n_batches += 1
                stats.n_launches += 1
            block(dev)
        stats.exec_time += time.perf_counter() - t1
        return ExecResult(graph, self.impls, bufs)


def _param(params: Any, name: str, impl_params: dict, key: str):
    """Threaded ``params={name: tensor}`` override the impl's own tensor."""
    if isinstance(params, dict) and name in params:
        return params[name]
    return impl_params[key]


def cell_impl(name: str, compiled_cell, in_slots: list[tuple[int, str]],
              input_names: list[str], pbuf) -> NodeImpl:
    """Wrap a CompiledCell as a NodeImpl: cell inputs come from predecessor
    fields in order; outputs are the cell's outputs."""
    prog = compiled_cell.prog
    own = {"pbuf": pbuf}

    def apply(params, inputs, aux):
        # The reference pads the batch to a power of two only to keep jit
        # retraces rare; eager execution has nothing to retrace, and the
        # outputs are the same either way.
        buf = _param(params, name, own, "pbuf")
        return compiled_cell.apply(buf, dict(zip(input_names, inputs)))

    out_fields = {o: prog.vars[o].shape for o in prog.outputs}
    return NodeImpl(name, in_slots, out_fields, apply,
                    fused_gather=_lstm_fused_gather(name, compiled_cell,
                                                    input_names, own),
                    params=own)


_derived = threading.local()


@contextlib.contextmanager
def derived_copies():
    """Collect the weight copies that the fused LSTM path derives from its
    parameter buffers while the block runs on the calling thread. Yields a
    list that gains one ``(buffer, version, (w, b))`` for each use: the
    blocked ``w`` and ``b`` built from ``buffer`` at that version (the cell
    kernel's packed copy hangs off ``w``). Each cell keeps one such copy,
    for the last buffer it saw, so a captured CUDA graph that reads one
    must hold it itself. Another thread's uses are its own."""
    outer = getattr(_derived, "found", None)
    _derived.found = []
    try:
        yield _derived.found
    finally:
        _derived.found = outer


def _note(buf, version: int, w, b):
    """Report a use of ``(w, b)`` to the calling thread's
    :func:`derived_copies`, if one is open; returns them."""
    found = getattr(_derived, "found", None)
    if found is not None:
        found.append((buf, version, (w, b)))
    return w, b


def _lstm_fused_gather(name: str, compiled_cell, input_names, own: dict):
    """Fused gather→cell fast path for standard LSTM cells, or None.

    Extracts the four gate weight blocks from the cell's packed parameter
    buffer (wherever the PQ plan put them) into the ``(E+H, 4H)``
    gate-blocked layout the fused kernel expects. Eager PyTorch would copy
    that matrix on every step (8 MB at width 512), so the blocked ``w`` and
    ``b`` are built once per parameter buffer and cached; the cache holds
    the buffer itself and its version counter, so threaded params and
    in-place weight updates both rebuild it. The copy is queued on the
    current stream and published with it: a reader on another stream (the
    serve loop, while a capture worker built it) waits for the write
    (:class:`~repro_torch.core.device.Published`). A copy built while the
    stream captures a CUDA graph belongs to that graph and is not cached.
    """
    prog = compiled_cell.prog
    if prog.name != "LSTMCell" or input_names != ["x", "h", "c"]:
        return None
    E = prog.vars["x"].shape[0]
    H = prog.vars["h"].shape[0]
    w_off = {g: compiled_cell.offsets[f"W{g}"] for g in "ifgo"}
    b_off = {g: compiled_cell.offsets[f"b{g}"] for g in "ifgo"}
    cache: list = [None]   # (buffer, version, Published(w, b))

    def blocked(buf):
        hit = cache[0]
        if hit is None or hit[0] is not buf or hit[1] != buf._version:
            w = torch.cat(
                [buf[w_off[g]:w_off[g] + (E + H) * H].reshape(E + H, H)
                 for g in "ifgo"], dim=1)
            b = torch.cat([buf[b_off[g]:b_off[g] + H] for g in "ifgo"])
            if capturing(buf):   # the graph's own, written at each replay
                return _note(buf, buf._version, w, b)
            hit = cache[0] = (buf, buf._version, Published(w, b))
        return _note(buf, hit[1], *hit[2].get())

    def fused_gather(params, bufs, idxs, aux):
        w, b = blocked(_param(params, name, own, "pbuf"))
        h2, c2 = fused_gather_lstm_cell(bufs[0], bufs[1], bufs[2],
                                        idxs[0], idxs[1], idxs[2], w, b)
        return {"h_out": h2, "c_out": c2}

    return fused_gather


def embed_impl(name: str, table: torch.Tensor, field_name: str = "h") -> NodeImpl:
    own = {"table": table}

    def apply(params, inputs, aux):
        return {field_name: gather_rows(_param(params, name, own, "table"), aux)}
    return NodeImpl(name, [], {field_name: (table.shape[1],)}, apply,
                    params=own)


def affine_impl(name: str, w: torch.Tensor, b: torch.Tensor,
                in_field: str = "h", out_field: str = "h") -> NodeImpl:
    own = {"w": w, "b": b}

    def apply(params, inputs, aux):
        return {out_field: inputs[0] @ own["w"] + own["b"]}
    return NodeImpl(name, [(0, in_field)], {out_field: (w.shape[1],)}, apply,
                    params=own)

"""Compiled execution plans (DESIGN.md §2.3, deviations #3 and #4).

The interpreted :class:`~repro_torch.core.executor.DynamicExecutor`
re-walks its cached schedule in Python on every run — one gather per
operand and one scatter into a freshly zeroed full-size buffer per batch.
This module lowers a cached ``(Schedule, memory plan)`` pair into a *static
execution plan*, at two levels of specialization:

- **Arenas.**  Every node output lives in a per-``(field, elem_shape)``
  arena of shape ``(rows, *elem_shape)``.  Row assignment is the memory
  plan: the PQ-tree planner (:mod:`repro_torch.core.memplan`) runs once per
  topology over the schedule's batches, so planned operands occupy
  ascending contiguous row runs.  Universes beyond ``max_pq_vars`` are
  planned in chunks (``memplan.plan_rows_chunked``).

- **Per-topology plans** (:class:`CompiledPlan`, deviation #3).  Every
  batch's gather/scatter rows are fixed when the plan is built: contiguous
  runs read as views and write as slice copies, duplicated sources read as
  ``expand``, the rest go through the gather kernel
  (:func:`repro_torch.kernels.gather_batch.gather_rows`) and ``index_copy_``.

- **Bucketed plan families** (:class:`BucketedPlanExecutor`, deviation #4).
  Index vectors, aux ids, and step activity are runtime operands; batch
  widths, same-type step runs, and arena rows are padded up to bucket
  boundaries.  One built program serves every topology whose padded shape —
  the :class:`BucketSpec` — matches; a new topology costs host-side index
  packing only.  Inactive pad lanes/steps are masked by index redirection:
  their reads replicate real rows and their writes land on a reserved trash
  row.  Steps whose impl exposes a ``fused_gather`` path run the fused
  gather→cell kernel (:mod:`repro_torch.kernels.fused_gather_cell`)
  straight off the arenas.

- **Sharded bucketed execution** (:class:`ShardedBucketedPlanExecutor`):
  K data-parallel replicas of one bucket program over a leading replica
  axis on one card — the reference's ``shard_map`` over a ``("data",)``
  mesh. Every shard runs the single-device body verbatim over its row of
  the stacked static buffers, all inside one captured CUDA graph, so one
  replay serves all K.

Eager PyTorch has no whole-program compile: in this port a "compile" (the
``n_compiles`` / ``compile_time_s`` counters and the ``xla.compile`` span,
kept in their reference places) is the build of a program object — the
step structure plus its index tensors uploaded to the device.  On the
card a program is built once more: run once eagerly (a warm-up that builds
what is built once), then captured into a CUDA graph whose static input
buffers each run refills before one replay — the counterpart of the
reference's one XLA executable per topology (:class:`CompiledPlan`) and
per bucket signature (:class:`_Bucket`), by the rules of
:mod:`repro_torch.core.capture`.  ``capture=False``, the CPU, and a
per-topology run that autograd records run the same body eagerly.  The
interpreted executor remains the reference path.
"""

from __future__ import annotations

import hashlib
import threading
import time
import warnings
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.gather_batch import gather_rows
from repro_torch.obs.tracer import Tracer, default_tracer

from . import memplan
from .batching import Policy, Schedule, policy_cache_key, resolve_schedule
from .cache import FIFOCache, LRUCache
from .device import block, on_card, resolve_device
from .capture import CapturedGraph, build_lock, tensors_of
from .executor import ExecStats, NodeImpl, weights_on
from .graph import Graph, TypeId

ArenaKey = tuple[str, tuple[int, ...]]  # (field name, element shape)

SLICE, GATHER, BROADCAST, SCATTER = "slice", "gather", "broadcast", "scatter"


def _sig_digest(obj: Any) -> str:
    """Short stable digest of a cache key / bucket signature — the value
    ``xla.compile`` trace spans carry so a compile wall can be attributed
    to a specific bucket signature across runs and dumps."""
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:12]


# Public alias: serve-layer checkpointing keys quarantine entries by the same
# digest the tracer stamps on spans, so a serialized table stays attributable.
sig_digest = _sig_digest


def _call_compile_hook(hook: Callable, key: Any, ctx: dict) -> None:
    """Invoke a compile hook with the executable-cache key and, when the
    hook accepts it, a job-context dict (kind, signature digest, whether the
    build runs on a background compile worker). Single-argument hooks from
    before the async compile service keep working unchanged."""
    try:
        n_pos = _hook_arity(hook)
    except (TypeError, ValueError):
        n_pos = 1
    if n_pos >= 2:
        hook(key, ctx)
    else:
        hook(key)


def _hook_arity(hook: Callable) -> int:
    import inspect

    sig = inspect.signature(hook)
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return 2
    return n


def bucket_up(n: int, ladder: tuple[int, ...] | None = None) -> int:
    """Smallest bucket >= n: next power of two, or the first rung of a
    configured ladder (falling back to powers of two past its top). A
    ladder's first rung is a floor — ``bucket_up(1, (8,)) == 8`` — which is
    how serving collapses all small widths onto one executable."""
    if ladder:
        for b in ladder:
            if b >= n:
                return int(b)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class LoweredOperand:
    """One batch operand, resolved to arena rows at plan-compile time."""

    arena: ArenaKey
    mode: str                 # slice | gather | broadcast (reads); slice | scatter (writes)
    start: int = 0            # slice / broadcast: first row
    rows: tuple[int, ...] = ()  # gather / scatter: row per batch element


@dataclass(frozen=True)
class LoweredStep:
    """One schedule batch in canonical element order."""

    type: TypeId
    ids: tuple[int, ...]      # node ids, ordered by primary-output arena row
    k: int
    aux_start: int            # offset into the flat aux vector
    inputs: tuple[LoweredOperand, ...]
    outputs: tuple[tuple[str, LoweredOperand], ...]  # (field, write op)


@dataclass
class PlanStats:
    """Lowering outcome — the Table 2-style data-movement decomposition."""

    n_steps: int = 0
    n_arenas: int = 0
    layout: str = "schedule"        # "pq" | "pq-chunked" | "schedule"
    n_slice_reads: int = 0
    n_gather_reads: int = 0
    n_broadcast_reads: int = 0
    n_slice_writes: int = 0
    n_scatter_writes: int = 0
    n_gather_fallback_steps: int = 0  # steps with >= 1 gathered/scattered operand
    n_pq_planned_batches: int = 0     # batches the PQ pipeline kept zero-copy
    n_pq_erased_batches: int = 0
    n_pq_chunks: int = 0              # > 1 when the chunked planner ran
    pq_skipped: str = ""              # non-empty: PQ pipeline skipped (+ why)
    bucketed: bool = False            # lowered for the bucketed executor
    n_pad_steps: int = 0              # inactive steps added by run padding
    n_compiles: int = 0               # program builds charged to this plan
    lower_time_s: float = 0.0
    compile_time_s: float = 0.0

    @property
    def n_operands(self) -> int:
        return (self.n_slice_reads + self.n_gather_reads +
                self.n_broadcast_reads + self.n_slice_writes +
                self.n_scatter_writes)

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["n_operands"] = self.n_operands
        return d


@dataclass
class Lowering:
    """A schedule resolved against a memory plan: the shared front half of
    both compiled paths (per-topology constants vs bucketed operands)."""

    steps: list[LoweredStep]
    aux_perm: np.ndarray
    row_of: dict[tuple[ArenaKey, int], int]
    arena_rows: dict[ArenaKey, int]
    stats: PlanStats


# -- lowering (host-side, once per topology) ---------------------------------


def _out_arena(impl: NodeImpl, fld: str) -> ArenaKey:
    return (fld, tuple(impl.out_fields[fld]))


def _input_arena(graph: Graph, impls: dict[TypeId, NodeImpl], ids,
                 slot: int, fld: str) -> ArenaKey:
    """Arena read by input slot ``(slot, fld)`` — every predecessor must
    produce ``fld`` with one shape (the mixed-shape case cannot batch)."""
    keys = set()
    for i in ids:
        pred = graph.nodes[graph.nodes[i].inputs[slot]]
        impl = impls[pred.type]
        if fld not in impl.out_fields:
            raise KeyError(
                f"batch input slot {slot} reads field {fld!r} but "
                f"predecessor type {pred.type!r} does not produce it")
        keys.add((fld, tuple(impl.out_fields[fld])))
    if len(keys) != 1:
        raise ValueError(
            f"input slot {slot} field {fld!r} mixes element shapes "
            f"{sorted(k[1] for k in keys)}; such batches cannot be lowered")
    return keys.pop()


def _warn_pq_skipped(stats: PlanStats) -> None:
    warnings.warn(
        f"PQ memory planning skipped ({stats.pq_skipped}); falling back to "
        f"first-write row order — strided reads will gather "
        f"(n_pq_planned_batches stays 0)", RuntimeWarning, stacklevel=3)


def _layout_rows(graph: Graph, sched: Schedule, impls, layout: str,
                 max_pq_vars: int, pq_chunk: bool, stats: PlanStats
                 ) -> tuple[dict, dict]:
    """Row tables ``(arena, node) -> row`` plus per-arena row counts."""
    nodes = graph.nodes
    # Declaration order = first-write (schedule) order, also the fallback
    # layout when the PQ pipeline is disabled or fails. Kept grouped per
    # step so the chunked planner can cut on step boundaries.
    var_groups: list[list[tuple[ArenaKey, int]]] = []
    for t, ids in sched:
        impl = impls[t]
        grp: list[tuple[ArenaKey, int]] = []
        for f in impl.out_fields:
            key = _out_arena(impl, f)
            grp.extend((key, i) for i in sorted(ids))
        var_groups.append(grp)
    variables = [v for grp in var_groups for v in grp]
    order = variables

    if layout == "planned":
        batches = []
        for si, (t, ids) in enumerate(sched):
            impl = impls[t]
            ids_sorted = sorted(ids)
            operands: list[tuple] = []
            for f in impl.out_fields:
                key = _out_arena(impl, f)
                operands.append(tuple((key, i) for i in ids_sorted))
            for slot, fld in impl.in_slots:
                key = _input_arena(graph, impls, ids_sorted, slot, fld)
                operands.append(tuple(
                    (key, nodes[i].inputs[slot]) for i in ids_sorted))
            batches.append(memplan.Batch(
                name=f"s{si}", result=operands[0],
                sources=tuple(operands[1:])))
        if len(variables) <= max_pq_vars:
            try:
                plan, _ = memplan.plan_rows(variables, batches)
                order = plan.order
                stats.layout = "pq"
                stats.n_pq_planned_batches = len(plan.planned)
                stats.n_pq_erased_batches = len(plan.erased)
            except Exception:   # noqa: BLE001 — planner is best-effort
                stats.pq_skipped = "joint PQ planning raised"
                _warn_pq_skipped(stats)
        elif pq_chunk:
            cp = memplan.plan_rows_chunked(var_groups, batches, max_pq_vars)
            order = cp.order
            stats.layout = "pq-chunked"
            stats.n_pq_planned_batches = cp.n_planned
            stats.n_pq_erased_batches = cp.n_erased
            stats.n_pq_chunks = cp.n_chunks
            if cp.n_skipped_chunks:
                # Partial degradation is visible in the flag; only a fully
                # unplanned layout warrants the warning.
                stats.pq_skipped = (f"{cp.n_skipped_chunks}/{cp.n_chunks} "
                                    f"chunks fell back to declaration order")
                if cp.n_skipped_chunks == cp.n_chunks:
                    _warn_pq_skipped(stats)
        else:
            stats.pq_skipped = (
                f"{len(variables)} layout vars exceed "
                f"max_pq_vars={max_pq_vars} and chunked planning is off")
            _warn_pq_skipped(stats)
    # Split the joint order into per-arena row tables: an operand that is
    # globally contiguous stays contiguous after the split because all of
    # its variables live in one arena.
    row_of: dict[tuple[ArenaKey, int], int] = {}
    counters: dict[ArenaKey, int] = {}
    for key, node_id in order:
        row = counters.get(key, 0)
        counters[key] = row + 1
        row_of[(key, node_id)] = row
    return row_of, counters


def lower_schedule(graph: Graph, sched: Schedule,
                   impls: dict[TypeId, NodeImpl], *, layout: str = "planned",
                   max_pq_vars: int = 512, pq_chunk: bool = True) -> Lowering:
    """Resolve every batch operand of ``sched`` to arena rows + access modes.
    Shared by the per-topology and bucketed compilers."""
    stats = PlanStats(n_steps=len(sched))
    row_of, arena_rows = _layout_rows(graph, sched, impls, layout,
                                      max_pq_vars, pq_chunk, stats)
    nodes = graph.nodes
    steps: list[LoweredStep] = []
    aux_perm: list[int] = []
    st = stats
    for t, ids in sched:
        impl = impls[t]
        out_fields = list(impl.out_fields)
        primary = _out_arena(impl, out_fields[0])
        # Canonical element order: ascending rows of the primary output
        # arena, so the primary write is always one contiguous slice-assign
        # whenever the planner made its rows adjacent.
        ids_c = sorted(ids, key=lambda i: row_of[(primary, i)])
        fallback = False

        outputs: list[tuple[str, LoweredOperand]] = []
        for f in out_fields:
            key = _out_arena(impl, f)
            rows = [row_of[(key, i)] for i in ids_c]
            start = memplan.operand_run(
                {v: r for v, r in zip(ids_c, rows)}, ids_c)
            if start is not None:
                outputs.append((f, LoweredOperand(key, SLICE, start)))
                st.n_slice_writes += 1
            else:
                outputs.append((f, LoweredOperand(key, SCATTER,
                                                  rows=tuple(rows))))
                st.n_scatter_writes += 1
                fallback = True

        inputs: list[LoweredOperand] = []
        for slot, fld in impl.in_slots:
            key = _input_arena(graph, impls, ids_c, slot, fld)
            srcs = [nodes[i].inputs[slot] for i in ids_c]
            rows = [row_of[(key, s)] for s in srcs]
            if len(set(srcs)) == 1:
                inputs.append(LoweredOperand(key, BROADCAST, rows[0]))
                st.n_broadcast_reads += 1
                continue
            start = memplan.operand_run(
                dict(zip(srcs, rows)), srcs) if len(set(srcs)) == len(srcs) \
                else None
            if start is not None:
                inputs.append(LoweredOperand(key, SLICE, start))
                st.n_slice_reads += 1
            else:
                inputs.append(LoweredOperand(key, GATHER,
                                             rows=tuple(rows)))
                st.n_gather_reads += 1
                fallback = True

        if fallback:
            st.n_gather_fallback_steps += 1
        steps.append(LoweredStep(
            type=t, ids=tuple(ids_c), k=len(ids_c),
            aux_start=len(aux_perm),
            inputs=tuple(inputs), outputs=tuple(outputs)))
        aux_perm.extend(ids_c)
    stats.n_arenas = len(arena_rows)
    return Lowering(steps=steps, aux_perm=np.asarray(aux_perm, np.int32),
                    row_of=row_of, arena_rows=arena_rows, stats=stats)


def _kind(x: Any) -> Any:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype).removeprefix("torch."),
                x.device.type)
    if isinstance(x, dict):
        return ("dict", tuple((k, _kind(x[k])) for k in sorted(x, key=repr)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_kind(v) for v in x))
    return ("leaf", type(x).__name__)


def _params_kind(params: Any) -> tuple:
    """Both compiled executors key their built programs and arena pools per
    params kind — the nesting of dicts/lists plus each tensor's shape,
    dtype and device (e.g. eval with None vs training with a params dict)
    — so alternating runs each keep their own pool."""
    return ("params", _kind(params))


def _weights(impls: dict[TypeId, NodeImpl]) -> list[torch.Tensor]:
    """Every impl's own tensors, which a captured graph reads in place
    (directly, or through copies built once from them)."""
    return tensors_of([impls[n].params for n in sorted(impls, key=repr)])


def _static_key(impls: dict[TypeId, NodeImpl], *threaded: Any) -> tuple:
    """The part of a captured entry's key that its graph reads in place:
    ``"static"``, the data pointers of each of ``threaded``'s tensors, and
    the pointers and version counters of the impls' weights."""
    return (("static",)
            + tuple(tuple(t.data_ptr() for t in tensors_of(x))
                    for x in threaded)
            + (tuple((t.data_ptr(), t._version) for t in _weights(impls)),))


def _recording(params: Any, impls: dict[TypeId, NodeImpl]) -> bool:
    """Whether autograd records a run: grad mode on and a threaded or an
    impl's own parameter that requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in tensors_of(params)) or any(
        t.requires_grad for impl in impls.values()
        for t in tensors_of(impl.params))


def _node_aux_np(graph: Graph, perm: np.ndarray) -> np.ndarray:
    """Host-side flat aux vector: node ``aux`` attrs in plan order."""
    if perm.size == 0:
        return np.zeros(0, np.int32)
    aux_all = np.asarray([n.attrs.get("aux", 0) for n in graph.nodes],
                         np.int32)
    return aux_all[perm]


class PlanResult:
    """Arena-backed per-node access, mirroring ``ExecResult``'s API."""

    def __init__(self, graph: Graph, impls: dict[TypeId, NodeImpl],
                 arenas: dict[ArenaKey, torch.Tensor],
                 row_of: dict[tuple[ArenaKey, int], int]):
        self._graph = graph
        self._impls = impls
        self.arenas = arenas
        self._row_of = row_of

    def node(self, i: int) -> dict[str, torch.Tensor]:
        impl = self._impls[self._graph.nodes[i].type]
        out = {}
        for f, shape in impl.out_fields.items():
            key = (f, tuple(shape))
            out[f] = self.arenas[key][self._row_of[(key, i)]]
        return out

    def nodes_with_field(self, fld: str):
        for n in self._graph.nodes:
            impl = self._impls.get(n.type)
            if impl and fld in impl.out_fields:
                yield n.id

    def field(self, fld: str, ids) -> torch.Tensor:
        arena, rows = self.arena_rows(fld, ids)
        with on_card(arena.device):   # the gather launches on its card
            return gather_rows(arena, torch.as_tensor(rows,
                                                      device=arena.device))

    def arena_rows(self, fld: str, ids) -> tuple[torch.Tensor, np.ndarray]:
        """(arena, row-index vector) for ``fld`` at ``ids`` — the raw
        ingredients of :meth:`field`."""
        key, rows = self._key_rows(fld, ids)
        return self.arenas[key], rows

    def _key_rows(self, fld: str, ids) -> tuple[ArenaKey, np.ndarray]:
        keys = set()
        for i in ids:
            impl = self._impls[self._graph.nodes[i].type]
            if fld not in impl.out_fields:
                raise KeyError(f"node {i} ({impl.name}) has no field {fld!r}")
            keys.add((fld, tuple(impl.out_fields[fld])))
        if len(keys) != 1:
            raise ValueError(
                f"field {fld!r} has mixed shapes "
                f"{sorted(k[1] for k in keys)} across the requested nodes")
        key = keys.pop()
        return key, np.asarray([self._row_of[(key, i)] for i in ids],
                               np.int32)


def _write(arenas: dict, key: ArenaKey, rows: int, val: torch.Tensor
           ) -> torch.Tensor:
    """The arena ``key``, allocated zeroed at its first write (the first
    write decides the dtype; rows are never read before being written)."""
    buf = arenas.get(key)
    if buf is None:
        buf = torch.zeros((rows,) + key[1], dtype=val.dtype, device=val.device)
        arenas[key] = buf
    return buf


class _PlanEntry(CapturedGraph):
    """One executable of a per-topology plan: the device row vectors of its
    gathered reads and scattered writes (built once), the static aux buffer
    every run refills, the arena pool donation rotates and, on the card,
    the CUDA graph captured over them (by the rules of
    :class:`~repro_torch.core.capture.CapturedGraph`)."""

    def __init__(self, rows: dict, n_aux: int, device: torch.device):
        super().__init__(device)
        self.rows = rows
        self.aux = torch.zeros(n_aux, dtype=torch.int32, device=device)
        self.pool: dict = {}
        self.statics = [self.aux] + list(rows.values())


class CompiledPlan:
    """A schedule + memory plan lowered to one program whose row indices
    are fixed when it is built (one program per topology).

    ``capture`` (default on): on the card the program is captured once per
    executable key (:meth:`executable_key`) into a CUDA graph, after a
    warm-up run, and each run copies its aux vector into the entry's
    static buffer and replays the graph: one device dispatch a run, as the
    reference's one ``jax.jit`` dispatch. ``capture=False``, or the CPU,
    runs the same body eagerly over the same static buffers. While
    autograd records a run (a threaded or an impl's parameter requires
    grad) it runs eagerly and writes functionally, as the reference's
    ``.at[].set`` does: a replay records no autograd graph.

    ``donate=True`` reuses the arena pool in place: no per-run allocation,
    but running the plan overwrites the arenas returned by the *previous*
    run, so only enable it in throughput loops that consume each result
    immediately.  With ``donate=False`` every run gets fresh arenas (a
    replayed run, copies of the graph's).
    """

    def __init__(self, graph: Graph, sched: Schedule,
                 impls: dict[TypeId, NodeImpl], *, layout: str = "planned",
                 max_pq_vars: int = 512, pq_chunk: bool = True,
                 donate: bool = False,
                 compile_hook: Callable[[Any], None] | None = None,
                 tracer: Tracer | None = None, device=None,
                 capture: bool = True):
        t0 = time.perf_counter()
        self.impls = impls
        self.donate = donate
        self.device = resolve_device(device)
        self.capture = bool(capture)
        # Called with the cache key on every program-cache miss, before the
        # build runs; raising aborts the build with no cache entry written.
        # The serve fault injector hangs off this.
        self.compile_hook = compile_hook
        self.tracer = tracer if tracer is not None else default_tracer()
        low = lower_schedule(graph, sched, impls, layout=layout,
                             max_pq_vars=max_pq_vars, pq_chunk=pq_chunk)
        self.steps = low.steps
        self.aux_perm = low.aux_perm
        self.row_of = low.row_of
        self.arena_rows = low.arena_rows
        self.stats = low.stats
        self.stats.lower_time_s = time.perf_counter() - t0
        # Built programs + arena pools, keyed by executable_key so eval
        # (None) and training (dict) runs coexist. FIFO-capped.
        self._exes: FIFOCache = FIFOCache(4)
        self.n_dispatches = 0     # program runs made by execute()
        self.n_captures = 0       # CUDA graphs captured
        self.n_replays = 0        # and replayed

    # -- the program -------------------------------------------------------

    def _build(self) -> dict:
        """Device index tensors for every gathered read (int32, for the
        gather kernel) and scattered write (int64, for ``index_copy_``)."""
        dev = self.device
        rows = {}
        for si, step in enumerate(self.steps):
            for oi, opd in enumerate(step.inputs):
                if opd.mode == GATHER:
                    rows[("in", si, oi)] = torch.as_tensor(
                        np.asarray(opd.rows, np.int32), device=dev)
            for oi, (_, opd) in enumerate(step.outputs):
                if opd.mode == SCATTER:
                    rows[("out", si, oi)] = torch.as_tensor(
                        np.asarray(opd.rows, np.int64), device=dev)
        return rows

    def _body(self, params: Any, aux_flat: torch.Tensor,
              arenas: dict[ArenaKey, torch.Tensor], rows: dict
              ) -> dict[ArenaKey, torch.Tensor]:
        arenas = dict(arenas)
        # When autograd records, every write makes a new arena (as the
        # reference's functional updates do): a slice read earlier is a view
        # that a later step's backward may have saved, and an in-place write
        # to its arena would fail autograd's version check. The values are
        # the same either way.
        functional = _recording(params, self.impls)
        for si, step in enumerate(self.steps):
            impl = self.impls[step.type]
            k = step.k
            inputs = []
            for oi, opd in enumerate(step.inputs):
                buf = arenas[opd.arena]
                if opd.mode == SLICE:
                    inputs.append(buf[opd.start:opd.start + k])
                elif opd.mode == BROADCAST:
                    inputs.append(buf[opd.start:opd.start + 1].expand(
                        (k,) + tuple(buf.shape[1:])))
                else:
                    inputs.append(gather_rows(buf, rows[("in", si, oi)]))
            aux = aux_flat[step.aux_start:step.aux_start + k]
            out = impl.apply(params, inputs, aux)
            for oi, (f, opd) in enumerate(step.outputs):
                val = out[f]
                buf = _write(arenas, opd.arena, self.arena_rows[opd.arena], val)
                if functional and opd.mode == SLICE:
                    arenas[opd.arena] = buf.slice_scatter(
                        val.to(buf.dtype), 0, opd.start, opd.start + k)
                elif functional:
                    arenas[opd.arena] = buf.index_copy(
                        0, rows[("out", si, oi)], val.to(buf.dtype))
                elif opd.mode == SLICE:
                    buf[opd.start:opd.start + k] = val
                else:
                    buf.index_copy_(0, rows[("out", si, oi)],
                                    val.to(buf.dtype))
        return arenas

    # -- execution ---------------------------------------------------------

    def executable_key(self, params: Any) -> tuple:
        """The params kind, and the run mode: ``"recording"`` while autograd
        records (always eager), ``"eager"`` without ``capture``, else
        ``"static"`` with the data pointers of the threaded params'
        tensors and the pointers and version counters of the impls'
        weights, as :meth:`BucketedPlanExecutor.executable_key`: a graph
        reads the tensors it was captured over, so another tensor, or a
        weight updated in place, needs another entry."""
        key = _params_kind(params)
        if _recording(params, self.impls):
            return key + ("recording",)
        if not self.capture:
            return key + ("eager",)
        return key + _static_key(self.impls, params)

    def _ensure_executable(self, params: Any, aux: np.ndarray) -> _PlanEntry:
        """The entry for ``params``, built on a miss (or when the cached
        one is stale): on the card with ``capture`` and autograd not
        recording, a warm-up and a capture over ``aux``, under the build
        lock. The build's seconds go to
        ``stats.compile_time_s``; a failed capture raises and caches
        nothing."""
        key = self.executable_key(params)
        entry = self._exes.get(key)
        if entry is not None and entry.current():
            return entry
        if self.compile_hook is not None:
            _call_compile_hook(self.compile_hook, key,
                               {"kind": "plan", "sig": _sig_digest(key)})
        capture = (self.capture and self.device.type == "cuda"
                   and not _recording(params, self.impls))
        with self.tracer.span("xla.compile", cat="compile", kind="plan",
                              sig=_sig_digest(key), capture=capture) as sp:
            t0 = time.perf_counter()
            # The pool starts empty; an eager run allocates it at the
            # arenas' first writes, and with donation later runs reuse it.
            entry = _PlanEntry(self._build(), len(self.aux_perm), self.device)
            if capture:
                entry.pinned = tensors_of(params) + _weights(self.impls)
                entry.aux.copy_(torch.from_numpy(aux))
                with build_lock():
                    entry.capture_graph(
                        lambda: self._body(params, entry.aux, {}, entry.rows),
                        lambda _: self._body(params, entry.aux, {},
                                             entry.rows))
                self.n_captures += 1
            self._exes[key] = entry
            self.stats.n_compiles += 1
            dt = time.perf_counter() - t0
            self.stats.compile_time_s += dt
            sp.set(lower_s=dt)
        return entry

    def execute(self, graph: Graph, params: Any = None) -> PlanResult:
        """Run the plan on ``graph`` (same topology, any aux values) on the
        current stream, not synchronised: one graph replay where one was
        captured, else one eager pass."""
        with self.tracer.span("plan.h2d", cat="plan"):
            aux = _node_aux_np(graph, self.aux_perm)
        entry = self._ensure_executable(params, aux)
        with self.tracer.span("plan.dispatch", cat="plan"):
            if _recording(params, self.impls):
                # autograd may save what the run reads (an embedding's index
                # vector): a fresh aux, not the buffer the next run refills
                aux_flat = torch.as_tensor(aux, device=self.device)
            else:
                aux_flat = entry.aux.copy_(torch.from_numpy(aux))
            if entry.graph is None:
                arenas = self._body(params, aux_flat,
                                    entry.pool if self.donate else {},
                                    entry.rows)
            else:
                entry.replay()
                self.n_replays += 1
                arenas = (dict(entry.out) if self.donate else
                          {k: v.clone() for k, v in entry.out.items()})
        self.n_dispatches += 1
        if self.donate:
            entry.pool = arenas
        return PlanResult(graph, self.impls, arenas, self.row_of)


class PlanExecutor:
    """Drop-in counterpart of ``DynamicExecutor`` that runs compiled plans.

    Plans are cached per ``(topology, policy)`` exactly like the interpreted
    executor's schedules; a cache hit costs one aux upload and one program
    run: on the card with ``capture`` (the default) one replay of the
    plan's CUDA graph (:class:`CompiledPlan`).
    """

    def __init__(self, impls: dict[TypeId, NodeImpl], params: Any, *,
                 layout: str = "planned", max_pq_vars: int = 512,
                 pq_chunk: bool = True, donate: bool = False,
                 cache: FIFOCache | None = None, namespace: Any = None,
                 compile_hook: Callable[[Any], None] | None = None,
                 tracer: Tracer | None = None, device=None,
                 capture: bool = True):
        self.impls = impls
        self.params = params
        self.layout = layout
        self.max_pq_vars = max_pq_vars
        self.pq_chunk = pq_chunk
        self.donate = donate
        self.device = resolve_device(device)
        self.capture = bool(capture)
        self.compile_hook = compile_hook
        self.tracer = tracer if tracer is not None else default_tracer()
        self.n_captures = 0       # CUDA graphs captured by this executor
        self.n_replays = 0        # and replayed
        # FIFO-capped: each entry pins a policy, the lowered steps, built
        # programs (on the card captured graphs), and arena pools — an
        # unbounded topology stream must not grow host/device memory
        # forever.
        self._plans = cache if cache is not None else FIFOCache(32)
        self._ns = namespace

    def plan_for(self, graph: Graph,
                 policy: Policy | Callable[[Graph], Schedule],
                 stats: ExecStats | None = None) -> CompiledPlan:
        # "plan" tags the entry kind: a cache shared with a
        # BucketedPlanExecutor (same namespace/topology/policy) must never
        # hand this executor a BucketedPack, or vice versa.
        key = ("plan", self._ns, graph.topology_key(),
               policy_cache_key(policy))
        plan = self._plans.get(key)
        if plan is None:
            t0 = time.perf_counter()
            with self.tracer.span("plan.schedule", cat="plan"):
                sched = resolve_schedule(graph, policy)
            t1 = time.perf_counter()
            with self.tracer.span("plan.lower", cat="plan"):
                plan = CompiledPlan(graph, sched, self.impls,
                                    layout=self.layout,
                                    max_pq_vars=self.max_pq_vars,
                                    pq_chunk=self.pq_chunk,
                                    donate=self.donate,
                                    compile_hook=self.compile_hook,
                                    tracer=self.tracer, device=self.device,
                                    capture=self.capture)
            self._plans[key] = plan
            if stats is not None:
                stats.schedule_time += t1 - t0
                stats.lower_time += plan.stats.lower_time_s
        return plan

    def run(self, graph: Graph, policy: Policy | Callable[[Graph], Schedule],
            stats: ExecStats | None = None, params: Any = None) -> PlanResult:
        stats = stats if stats is not None else ExecStats()
        with self.tracer.span("plan.pack", cat="plan"):
            plan = self.plan_for(graph, policy, stats)
        compile_before = plan.stats.compile_time_s
        graphs_before = (plan.n_captures, plan.n_replays)
        t1 = time.perf_counter()
        res = plan.execute(graph, params if params is not None else self.params)
        with self.tracer.span("plan.block", cat="plan"):
            block(self.device)
        dt = time.perf_counter() - t1
        compiled_s = plan.stats.compile_time_s - compile_before
        if compiled_s > 0:
            # Fold the one-time program build (first run, or a new params
            # kind) into lower_time, not exec_time, so the Fig. 8
            # decomposition stays honest.
            stats.lower_time += compiled_s
            stats.n_compiles += 1
            dt = max(dt - compiled_s, 0.0)
        stats.exec_time += dt
        stats.n_batches += plan.stats.n_steps
        stats.n_launches += 1
        self.n_captures += plan.n_captures - graphs_before[0]
        self.n_replays += plan.n_replays - graphs_before[1]
        return res


# ---------------------------------------------------------------------------
# Bucketed plan families (deviation #4)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BucketStepSpec:
    """The build-time shape of one padded step: its type (selects the impl),
    padded width, and the arenas it touches. Index vectors are *not* here —
    they are runtime operands, which is the whole point."""

    type: TypeId
    width: int
    in_arenas: tuple[ArenaKey, ...]
    out_arenas: tuple[tuple[str, ArenaKey], ...]


@dataclass(frozen=True)
class BucketSpec:
    """The bucket signature: everything the built program specializes on.
    Two topologies with equal specs share one program.

    ``n_shards`` is 1 for the single-device program; the sharded executor
    (:class:`ShardedBucketedPlanExecutor`) re-keys the same signature at its
    replica count.
    """

    steps: tuple[BucketStepSpec, ...]
    arena_rows: tuple[tuple[ArenaKey, int], ...]   # padded rows, sorted
    n_shards: int = 1

    @property
    def n_index_lanes(self) -> int:
        return sum(s.width * (len(s.in_arenas) + len(s.out_arenas))
                   for s in self.steps)

    @property
    def n_aux_lanes(self) -> int:
        return sum(s.width for s in self.steps)


class BucketedPack:
    """One topology packed against its bucket: the runtime index operands
    plus the row table for result access. Cheap to build — host numpy and
    one upload.

    ``impls`` pins the impl dict for as long as the pack lives in a shared
    cache: cache keys namespace on ``id(impls)``, and an unpinned dict's id
    could be recycled onto a different workload's impls after GC."""

    def __init__(self, spec: BucketSpec, idxpack: torch.Tensor,
                 aux_perm: np.ndarray, row_of: dict, stats: PlanStats,
                 impls: dict[TypeId, NodeImpl] | None = None,
                 idxpack_np: np.ndarray | None = None):
        self.spec = spec
        self.idxpack = idxpack        # (n_index_lanes,) int32, on the device
        # The scatter lanes as int64, which ``index_copy_`` requires.
        self.idxpack_long = idxpack.long()
        self.idxpack_np = (idxpack_np if idxpack_np is not None
                           else idxpack.cpu().numpy())
        self.aux_perm = aux_perm      # (n_aux_lanes,) int32 node ids
        self.row_of = row_of
        self.stats = stats
        self.impls = impls


def _read_rows(opd: LoweredOperand, k: int) -> list[int]:
    if opd.mode == GATHER:
        return list(opd.rows)
    if opd.mode == BROADCAST:
        return [opd.start] * k
    return list(range(opd.start, opd.start + k))


def pack_bucketed(low: Lowering, *, ladder: tuple[int, ...] | None = None,
                  pad_steps: bool = True,
                  impls: dict[TypeId, NodeImpl] | None = None,
                  device=None) -> BucketedPack:
    """Pad a lowering up to bucket boundaries and pack its index operands
    (uploaded to ``device``).

    - every operand (slice, broadcast, or gather alike) becomes a runtime
      index vector of the step's padded width — uniform access maximizes
      spec sharing across topologies;
    - pad *lanes* replicate the last real lane on reads and target the
      arena's reserved trash row (the last padded row, never a real row) on
      writes;
    - pad *steps* (run-length padding of consecutive same-type steps)
      re-execute the run's last real step with all-trash writes, so a chain
      of 11 cells and a chain of 13 share the 16-step program.
    """
    # Rows pad to the bucket rung plus one reserved trash row *outside* the
    # rung, so an arena sitting exactly on a boundary (the common case for
    # bucketed widths) does not spill the whole spec into the next bucket.
    rows_p = {k: bucket_up(r, ladder) + 1 for k, r in low.arena_rows.items()}
    spec_steps: list[BucketStepSpec] = []
    idx_parts: list[np.ndarray] = []
    aux_perm: list[int] = []
    n_pad = 0

    def emit(step: LoweredStep, pad: bool) -> None:
        wp = bucket_up(step.k, ladder)
        in_keys = []
        in_idx = []
        for opd in step.inputs:
            rows = _read_rows(opd, step.k)
            rows += [rows[-1]] * (wp - step.k)
            in_idx.append(np.asarray(rows, np.int32))
            in_keys.append(opd.arena)
        out_keys = []
        out_idx = []
        for f, opd in step.outputs:
            trash = rows_p[opd.arena] - 1
            if pad:
                rows = [trash] * wp
            else:
                rows = (list(opd.rows) if opd.mode == SCATTER
                        else list(range(opd.start, opd.start + step.k)))
                rows += [trash] * (wp - step.k)
            out_idx.append(np.asarray(rows, np.int32))
            out_keys.append((f, opd.arena))
        idx_parts.extend(in_idx + out_idx)
        ids = list(step.ids) + [step.ids[-1]] * (wp - step.k)
        aux_perm.extend(ids)
        spec_steps.append(BucketStepSpec(
            type=step.type, width=wp, in_arenas=tuple(in_keys),
            out_arenas=tuple(out_keys)))

    # Group maximal runs of consecutive same-type steps; pad run lengths.
    i = 0
    while i < len(low.steps):
        j = i
        while j < len(low.steps) and low.steps[j].type == low.steps[i].type:
            j += 1
        run = low.steps[i:j]
        for s in run:
            emit(s, pad=False)
        if pad_steps:
            # Run lengths pad on the pure power-of-two ladder: a width
            # ladder's floor exists to merge small *batches*, and applying
            # it here would multiply every short run into `floor` steps.
            for _ in range(bucket_up(len(run)) - len(run)):
                emit(run[-1], pad=True)
                n_pad += 1
        i = j

    spec = BucketSpec(tuple(spec_steps),
                      tuple(sorted(rows_p.items(), key=repr)))
    stats = low.stats
    stats.bucketed = True
    stats.n_pad_steps = n_pad
    idxpack = (np.concatenate(idx_parts) if idx_parts
               else np.zeros(0, np.int32))
    return BucketedPack(spec,
                        torch.as_tensor(idxpack, device=resolve_device(device)),
                        np.asarray(aux_perm, np.int32), low.row_of, stats,
                        impls=impls, idxpack_np=idxpack)


class _BucketProgram:
    """The shape-polymorphic program for one bucket signature: step
    structure and widths are fixed, every index vector is an operand."""

    def __init__(self, spec: BucketSpec, impls: dict[TypeId, NodeImpl], *,
                 fused: Any = "auto"):
        self.spec = spec
        self.impls = impls
        self.fused = fused
        self.rows_p = dict(spec.arena_rows)

    def _fused_fn(self, impl: NodeImpl):
        # Only False turns the fused path off; "auto" (the default, kept for
        # parity with the reference, where it means "on the TPU only") and
        # True both take it everywhere: the kernel on the card, its plain
        # version on the CPU.
        fn = getattr(impl, "fused_gather", None)
        if fn is None or self.fused is False:
            return None
        return fn

    def body(self, params: Any, idxpack: torch.Tensor,
             idxpack_long: torch.Tensor, aux_pack: torch.Tensor,
             arenas: dict[ArenaKey, torch.Tensor]
             ) -> dict[ArenaKey, torch.Tensor]:
        arenas = dict(arenas)
        off = aoff = 0
        for bs in self.spec.steps:
            impl = self.impls[bs.type]
            w = bs.width
            idxs = []
            for _ in bs.in_arenas:
                idxs.append(idxpack[off:off + w])
                off += w
            aux = aux_pack[aoff:aoff + w]
            aoff += w
            fused = self._fused_fn(impl)
            if fused is not None:
                out = fused(params, [arenas[k] for k in bs.in_arenas], idxs,
                            aux)
            else:
                inputs = [gather_rows(arenas[k], ix)
                          for k, ix in zip(bs.in_arenas, idxs)]
                out = impl.apply(params, inputs, aux)
            for f, key in bs.out_arenas:
                val = out[f]
                buf = _write(arenas, key, self.rows_p[key], val)
                # Pad lanes all hit the trash row, where the winner of the
                # duplicate writes is unspecified; real rows are unique.
                buf.index_copy_(0, idxpack_long[off:off + w],
                                val.to(buf.dtype))
                off += w
        return arenas


class _Bucket(CapturedGraph):
    """One bucket signature's entry in the executable cache: its program,
    the impls it pins (shared caches namespace on ``id(impls)``), the arena
    pool donation rotates, the static input buffers every run refills and,
    on the card, the CUDA graph captured over them (by the rules of
    :class:`~repro_torch.core.capture.CapturedGraph`).

    The captured graph reads fixed addresses: the static buffers, the
    arenas its capture allocated (its outputs, ``out``), the impls' weights,
    the copies derived from weights before the capture (the fused cells'
    blocked and packed ``w``), and whatever the threaded ``params`` held at
    capture (the serve engine's slot pools, which the engine therefore
    updates in place). The executable key carries the weights' and the
    threaded tensors' data pointers and the weights' version counters; the
    entry keeps all of those tensors and the derived copies alive
    (``pinned``), and is stale (:meth:`current`) once a buffer it derived a
    copy from has changed in place. So no graph replays over memory another
    tensor owns, or over a copy of old weights. A replay overwrites
    ``out``: unless the executor donates, each run returns copies of it,
    as the reference's undonated runs return fresh arrays."""

    def __init__(self, prog: _BucketProgram, impls: dict,
                 device: torch.device, lead: tuple[int, ...] = (),
                 weights: Callable[[], dict] | None = None):
        super().__init__(device)
        self.prog = prog
        self.impls = impls
        # the impls' weights as this entry reads them: copies on its card
        # (``BucketedPlanExecutor.weight_copies``), or None for in place
        self.weights = weights
        self.pool: dict = {}
        self.loaded: BucketedPack | None = None
        spec = prog.spec
        # ``lead``: the sharded entry's leading shard axis
        self.idx = torch.zeros(lead + (spec.n_index_lanes,),
                               dtype=torch.int32, device=device)
        self.idx_long = torch.zeros(lead + (spec.n_index_lanes,),
                                    dtype=torch.int64, device=device)
        self.aux = torch.zeros(lead + (spec.n_aux_lanes,), dtype=torch.int32,
                               device=device)
        self.statics = [self.idx, self.idx_long, self.aux]

    def load(self, pack: BucketedPack, aux: np.ndarray) -> None:
        """Copy a run's operands into the static buffers; the index vectors
        only when they are another pack's than the last run's."""
        if self.loaded is not pack:
            self.idx.copy_(pack.idxpack)
            self.idx_long.copy_(pack.idxpack_long)
            self.loaded = pack
        self.aux.copy_(torch.from_numpy(aux))

    def _body(self, params: Any, arenas: dict) -> dict:
        """The program over the static buffers, writing into ``arenas``
        (allocated at their first writes where absent)."""
        with weights_on(None if self.weights is None else self.weights()):
            return self.prog.body(params, self.idx, self.idx_long, self.aux,
                                  arenas)

    def _static_arenas(self, warm: dict) -> dict:
        """The arenas a capture writes into, made before it from the
        warm-up's: none for one shard, whose capture allocates its own."""
        return {}

    def capture(self, params: Any) -> None:
        """Warm up, then capture the body into a CUDA graph
        (:meth:`~repro_torch.core.capture.CapturedGraph.capture_graph`):
        the warm-up's run is thrown away, and the entry pins the arenas
        the capture writes into. The caller holds the build lock
        (:func:`~repro_torch.core.capture.build_lock`)."""
        arenas = self.capture_graph(
            lambda: self._static_arenas(self._body(params, {})),
            lambda arenas: self._body(params, arenas))
        self.pinned.extend(arenas.values())

    def run(self, pack: BucketedPack, aux: np.ndarray, params: Any,
            donate: bool) -> dict[ArenaKey, torch.Tensor]:
        """One run of the bucket on ``pack``'s operands, queued on the
        current stream of its card: refill the static buffers, then replay
        the graph where one was captured, else run the body eagerly over
        them."""
        with on_card(self.device):
            self.load(pack, aux)
            if self.graph is None:
                return self._body(params, self.pool if donate else {})
            self.replay()
            if donate:
                return dict(self.out)
            return {k: v.clone() for k, v in self.out.items()}


class BucketedPlanExecutor:
    """Shape-polymorphic counterpart of :class:`PlanExecutor`.

    Per-topology work is host-side only: resolve the schedule, lower it,
    pack index vectors (all cached FIFO by topology fingerprint). The built
    program is cached by *bucket signature* — typically a handful of
    entries serve an unbounded topology stream.

    ``capture`` (default on): on the card each bucket signature's program
    is captured once into a CUDA graph, after a warm-up run, and each run
    refills its static input buffers and replays it. ``capture=False``
    runs every bucket eagerly on the card, over the same static buffers
    (the counterpart of running the reference under ``jax.disable_jit()``).
    On the CPU a bucket always runs eagerly.

    ``copy_weights``: the executor reads its impls' weights through copies
    on ``device``, made once for each version of them
    (:meth:`weight_copies`): a replica on a card the weights do not live
    on. ``placement`` (hashable) joins every executable key, so that two
    placements never share an entry.
    """

    def __init__(self, impls: dict[TypeId, NodeImpl], params: Any, *,
                 layout: str = "planned", max_pq_vars: int = 512,
                 pq_chunk: bool = True, donate: bool = False,
                 fused: Any = "auto",
                 ladder: tuple[int, ...] | None = None,
                 pad_steps: bool = True,
                 pack_cache: FIFOCache | None = None,
                 exe_cache: FIFOCache | None = None, namespace: Any = None,
                 compile_hook: Callable[[Any], None] | None = None,
                 tracer: Tracer | None = None, device=None,
                 capture: bool = True, copy_weights: bool = False,
                 placement: Any = None):
        self.impls = impls
        self.params = params
        self.layout = layout
        self.max_pq_vars = max_pq_vars
        self.pq_chunk = pq_chunk
        self.donate = donate
        self.fused = fused
        self.ladder = tuple(ladder) if ladder else None
        self.pad_steps = pad_steps
        self.device = resolve_device(device)
        self.capture = bool(capture)
        # Consulted with the program-cache key on every miss, before the
        # build; raising aborts the build with the cache untouched — the
        # serve degradation ladder's compile-failure injection point. A
        # failed capture raises the same way.
        self.compile_hook = compile_hook
        self.tracer = tracer if tracer is not None else default_tracer()
        # Packs are cheap (host-side numpy); programs and their arena pools
        # are LRU-kept so hot buckets survive topology churn.
        self._packs = pack_cache if pack_cache is not None else FIFOCache(256)
        self._exes = exe_cache if exe_cache is not None else LRUCache(32)
        self._ns = namespace
        self.n_bucket_compiles = 0
        self.compile_time_s = 0.0
        self.n_captures = 0       # CUDA graphs captured by this executor
        self.n_replays = 0        # and replayed
        self.copy_weights = bool(copy_weights)
        self.placement = placement
        self._copies: tuple | None = None    # (weights' key, copies)
        self._copies_lock = threading.Lock()

    def weight_copies(self) -> dict[int, torch.Tensor]:
        """The impls' weights copied to this executor's device, keyed by
        the ``id`` of each original (what ``core/executor.py:weights_on``
        takes); copied again once a weight's data pointer or version has
        moved, so an update reaches every card. The copy is queued on the
        card's current stream after the source card's pending work
        (``Tensor.to`` between cards orders itself against both cards'
        current streams)."""
        ws = _weights(self.impls)
        key = tuple((t.data_ptr(), t._version) for t in ws)
        with self._copies_lock:
            if self._copies is None or self._copies[0] != key:
                with on_card(self.device), torch.no_grad():
                    self._copies = (key, {id(t): t.detach().to(
                        self.device, copy=True) for t in ws})
            return self._copies[1]

    def _entry_weights(self) -> Callable[[], dict] | None:
        return self.weight_copies if self.copy_weights else None

    def _pack_key(self, graph: Graph,
                  policy: Policy | Callable[[Graph], Schedule],
                  ladder: tuple[int, ...] | None) -> tuple:
        # The effective ladder is part of the key: the async serve path
        # packs the same topology at coarser ladders to bridge onto an
        # already-built bucket while the native one is still building.
        return ("pack", self._ns, graph.topology_key(),
                policy_cache_key(policy), ladder)

    def pack_for(self, graph: Graph,
                 policy: Policy | Callable[[Graph], Schedule],
                 stats: ExecStats | None = None,
                 ladder: tuple[int, ...] | None = None) -> BucketedPack:
        lad = self.ladder if ladder is None else tuple(ladder)
        key = self._pack_key(graph, policy, lad)
        pack = self._packs.get(key)
        if pack is None:
            t0 = time.perf_counter()
            with self.tracer.span("plan.schedule", cat="plan"):
                sched = resolve_schedule(graph, policy)
            t1 = time.perf_counter()
            with self.tracer.span("plan.lower", cat="plan"):
                low = lower_schedule(graph, sched, self.impls,
                                     layout=self.layout,
                                     max_pq_vars=self.max_pq_vars,
                                     pq_chunk=self.pq_chunk)
                pack = pack_bucketed(low, ladder=lad,
                                     pad_steps=self.pad_steps,
                                     impls=self.impls, device=self.device)
            pack.stats.lower_time_s = time.perf_counter() - t1
            self._packs[key] = pack
            if stats is not None:
                stats.schedule_time += t1 - t0
                stats.lower_time += pack.stats.lower_time_s
        return pack

    def pack_ready(self, graph: Graph,
                   policy: Policy | Callable[[Graph], Schedule],
                   ladder: tuple[int, ...] | None = None
                   ) -> BucketedPack | None:
        """Cached pack for ``(graph, policy, ladder)`` or ``None`` — a pure
        probe: no lowering, no hit/miss accounting."""
        lad = self.ladder if ladder is None else tuple(ladder)
        return self._packs.peek(self._pack_key(graph, policy, lad))

    def executable_key(self, pack: BucketedPack, params: Any) -> tuple:
        """The reference's ``(namespace, spec, params kind)``, and the run
        mode. With ``capture`` also the data pointers of the threaded
        params' tensors, and the pointers and version counters of the
        impls' weights: a graph reads the tensors it was captured over, so
        another tensor (or a weight updated in place, whose blocked and
        packed copies a graph does not rebuild) needs another entry. The
        threaded params are runtime state read at each replay: the serve
        engine updates its slot pools in place, and they keep their key. A
        threaded weight buffer updated in place keeps its key too, but the
        entry captured over copies of it is stale (``_Bucket.current``) and
        is built again."""
        key = (self._ns, pack.spec, _params_kind(params))
        if self.placement is not None:
            key += (("placement", self.placement),)
        if not self.capture:
            return key + ("eager",)
        return key + _static_key(self.impls, params)

    def executable_ready(self, pack: BucketedPack, params: Any) -> bool:
        """True when the bucket program is already in the shared cache — a
        pure probe (no build, no LRU refresh, no counter bump)."""
        entry = self._exes.peek(self.executable_key(pack, params))
        return entry is not None and entry.current()

    def _ensure_executable(self, pack: BucketedPack, params: Any,
                           aux: np.ndarray | None = None
                           ) -> tuple[Any, _Bucket, float]:
        """Returns ``(key, entry, compile_s)``. The entry comes straight
        from the locked cache ``get`` (or the fresh build) — callers must
        not re-read the shared cache afterwards: a concurrent insert could
        evict the key between the check and the act."""
        return self.build_executable(pack, params, aux=aux)

    def build_executable(self, pack: BucketedPack, params: Any,
                         span_args: dict | None = None,
                         abort_check: Callable[[], bool] | None = None,
                         aux: np.ndarray | None = None
                         ) -> tuple[Any, _Bucket, float]:
        """Build (or fetch) the bucket program for ``pack``. ``span_args``
        are stamped onto the ``xla.compile`` span; ``abort_check`` is
        consulted after the compile hook and before the build (an abort
        raises, so nothing is cached). On the card with ``capture`` the
        build warms the program up and captures it on ``pack``'s indices
        and ``aux`` (zeros if None); a capture that fails raises like a
        failed compile, and nothing is cached."""
        key = self.executable_key(pack, params)
        entry = self._exes.get(key)
        if entry is not None and entry.current():
            return key, entry, 0.0
        ctx = {"kind": "bucketed", "sig": _sig_digest(pack.spec)}
        ctx.update(span_args or {})
        if abort_check is not None:
            ctx["abort"] = abort_check
        if self.compile_hook is not None:
            _call_compile_hook(self.compile_hook, key, ctx)
        if abort_check is not None and abort_check():
            raise RuntimeError(
                f"compile of bucket {_sig_digest(pack.spec)} aborted "
                f"(job abandoned before the build)")
        capture = self.capture and self.device.type == "cuda"
        with self.tracer.span("xla.compile", cat="compile", kind="bucketed",
                              bucket=_sig_digest(pack.spec),
                              steps=len(pack.spec.steps),
                              shards=pack.spec.n_shards, capture=capture,
                              **(span_args or {})) as sp, \
                build_lock(abort_check):
            # another worker may have built it while this one waited
            entry = self._exes.peek(key)
            if entry is not None and entry.current():
                return key, entry, 0.0
            t0 = time.perf_counter()
            prog = _BucketProgram(pack.spec, self.impls, fused=self.fused)
            entry = self._new_entry(prog, params, pack, aux, capture)
            self._exes[key] = entry
            dt = time.perf_counter() - t0
            sp.set(lower_s=dt)
            self.n_bucket_compiles += 1
            self.compile_time_s += dt
            pack.stats.n_compiles += 1
            pack.stats.compile_time_s += dt
        return key, entry, dt

    def _new_entry(self, prog: _BucketProgram, params: Any,
                   pack: BucketedPack | None, aux: np.ndarray | None,
                   capture: bool) -> _Bucket:
        """A single-device entry for ``prog`` on this executor's device,
        captured over ``pack``'s indices and ``aux`` (zeros where None)
        when ``capture``. The caller holds the build lock. The pool starts
        empty: an eager run allocates the arenas at their first writes,
        and with donation later runs reuse them."""
        entry = _Bucket(prog, self.impls, self.device,
                        weights=self._entry_weights())
        if self.capture:
            entry.pinned = tensors_of(params) + _weights(self.impls)
            if self.copy_weights:
                entry.pinned += list(self.weight_copies().values())
        if capture:
            if pack is not None:
                entry.load(pack, aux if aux is not None else
                           np.zeros(prog.spec.n_aux_lanes, np.int32))
            entry.capture(params)
            self.n_captures += 1
        return entry

    def run(self, graph: Graph, policy: Policy | Callable[[Graph], Schedule],
            stats: ExecStats | None = None, params: Any = None) -> PlanResult:
        stats = stats if stats is not None else ExecStats()
        with self.tracer.span("plan.pack", cat="plan"):
            pack = self.pack_for(graph, policy, stats)
        return self.run_packed(graph, pack, stats, params=params)

    def _refuse_grad(self, params: Any) -> None:
        """On the card a bucket replays a captured graph and runs the fused
        LSTM cells, whose kernels have no backward: raise when autograd
        would record the run (differentiate through ``DynamicExecutor`` or
        ``CompiledPlan`` instead). On the CPU the plain versions run and
        autograd differentiates them."""
        if self.device.type == "cuda" and _recording(params, self.impls):
            raise RuntimeError(
                "BucketedPlanExecutor: on the card its buckets replay "
                "captured graphs and run the fused LSTM cells, which have "
                "no backward kernel (it comes with the fused cells' "
                "backward, dW = [x; h]^T dgates with dx, dh and dc scattered "
                "back); run under torch.no_grad(), or differentiate through "
                "DynamicExecutor or CompiledPlan")

    def run_packed(self, graph: Graph, pack: BucketedPack,
                   stats: ExecStats | None = None,
                   params: Any = None) -> PlanResult:
        """Execute ``graph`` through an explicit pack — the pack need not be
        the graph's native one, only index/aux-compatible."""
        return self.dispatch_packed(graph, pack, stats, params=params).block()

    def dispatch_packed(self, graph: Graph, pack: BucketedPack,
                        stats: ExecStats | None = None,
                        params: Any = None) -> "InFlightDispatch":
        """Queue ``graph`` through ``pack`` on the current stream without
        synchronizing, and return an :class:`InFlightDispatch` handle at
        once. The caller overlaps host work and calls ``handle.block()``
        when it needs the arenas.

        Donation rotation and stat accounting are deferred to ``block()``:
        until the caller commits, the cached entry still owns the
        pre-dispatch pool."""
        stats = stats if stats is not None else ExecStats()
        tr = self.tracer
        params = params if params is not None else self.params
        self._refuse_grad(params)
        with tr.span("plan.h2d", cat="plan"):
            aux = _node_aux_np(graph, pack.aux_perm)
        key, entry, compile_s = self._ensure_executable(pack, params, aux)
        t1 = time.perf_counter()
        with tr.span("plan.dispatch", cat="plan"):
            arenas = entry.run(pack, aux, params, self.donate)
            if entry.graph is not None:
                self.n_replays += 1
            done = None
            if self.device.type == "cuda":
                with on_card(self.device):
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
        dispatch_s = time.perf_counter() - t1
        return InFlightDispatch(self, graph, pack, key, entry, arenas, stats,
                                dispatch_s, compile_s, done)


class InFlightDispatch:
    """Handle to a queued-but-unsynchronized bucket program run.

    ``block()`` waits on the CUDA event recorded after the launches,
    rotates the donation pool, books the exec stats (dispatch-call time +
    block-wait time — the overlap gap in between is *not* charged) and
    returns the :class:`PlanResult`. Idempotent: repeated calls return the
    same result."""

    def __init__(self, executor: BucketedPlanExecutor, graph: Graph,
                 pack: BucketedPack, key: tuple, entry: _Bucket,
                 arenas: dict, stats: ExecStats, dispatch_s: float,
                 compile_s: float, done: "torch.cuda.Event | None"):
        self._ex = executor
        self._graph = graph
        self._pack = pack
        self._key = key
        self._entry = entry
        self._arenas = arenas
        self._stats = stats
        self._dispatch_s = dispatch_s
        self._compile_s = compile_s
        self._done = done
        self._result: PlanResult | None = None

    @property
    def pending(self) -> bool:
        return self._result is None

    def block(self) -> PlanResult:
        if self._result is not None:
            return self._result
        ex = self._ex
        t0 = time.perf_counter()
        with ex.tracer.span("plan.block", cat="plan"):
            if self._done is not None:
                self._done.synchronize()
        wait_s = time.perf_counter() - t0
        if ex.donate:
            self._entry.pool = self._arenas
            ex._exes[self._key] = self._entry
        st = self._stats
        if self._compile_s > 0:
            # The build ran before the timed dispatch; charge it to
            # lower_time so the Fig. 8 decomposition stays honest.
            st.lower_time += self._compile_s
            st.n_compiles += 1
        st.exec_time += self._dispatch_s + wait_s
        st.n_batches += self._pack.stats.n_steps
        st.n_launches += 1
        self._result = PlanResult(self._graph, ex.impls, self._arenas,
                                  self._pack.row_of)
        return self._result


# ---------------------------------------------------------------------------
# Sharded bucketed execution (data-parallel replicas: stacked on one card,
# or one a card)
# ---------------------------------------------------------------------------


class PerCard(tuple):
    """One tensor a replica, replica ``s``'s on its own card: the per-card
    form of a tensor with a leading replica axis (the serve engine's slot
    pools on a per-card mesh). Row ``s`` of a sharded nest is element
    ``s`` (:func:`_shard_slice`)."""


def _merge_params(replicated: Any, per_shard: Any) -> Any:
    """Combine the replicated params with a shard's slice of the sharded
    params. Dicts merge key-wise (sharded keys win); otherwise exactly one
    side may be non-None."""
    if per_shard is None:
        return replicated
    if replicated is None:
        return per_shard
    if isinstance(replicated, dict) and isinstance(per_shard, dict):
        merged = dict(replicated)
        merged.update(per_shard)
        return merged
    raise TypeError(
        "params and shard_params can only be combined when both are dicts; "
        f"got {type(replicated).__name__} and {type(per_shard).__name__}")


def _shard_slice(x: Any, s: int) -> Any:
    """Row ``s`` of every tensor in a nest of dicts, lists and tuples: views,
    so a graph captured over them reads the stacked tensors in place
    (element ``s`` of a :class:`PerCard`)."""
    if isinstance(x, PerCard):
        return x[s]
    if isinstance(x, torch.Tensor):
        return x[s]
    if isinstance(x, dict):
        return {k: _shard_slice(v, s) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_shard_slice(v, s) for v in x)
    return x


class _ShardedBucket(_Bucket):
    """One sharded bucket signature's entry: the static buffers gain a
    leading shard axis (``(K, lanes)``), the body runs the single-device
    program once per shard over that shard's rows and its slice of the
    sharded params, and the arenas are stacked ``(K, rows, *row)``. On the
    card all K bodies are captured into one CUDA graph, so one replay
    serves every shard. The capture writes into stacked arenas made before
    it (zeroed at the start of every run, as a one-shard capture's fresh
    arenas are), which the entry pins."""

    def __init__(self, prog: _BucketProgram, impls: dict,
                 device: torch.device, n_shards: int):
        super().__init__(prog, impls, device, lead=(n_shards,))
        self.n_shards = n_shards
        self.loaded = [None] * n_shards

    def load(self, packs: list[BucketedPack], aux: np.ndarray) -> None:
        """Copy each shard's index vectors where its pack differs from the
        last run's, and every shard's aux in one copy."""
        for s, pack in enumerate(packs):
            if self.loaded[s] is not pack:
                self.idx[s].copy_(pack.idxpack)
                self.idx_long[s].copy_(pack.idxpack_long)
                self.loaded[s] = pack
        self.aux.copy_(torch.from_numpy(aux))

    def _body(self, params: Any, arenas: dict) -> dict:
        rep, sharded = params
        if not arenas:
            outs = [self.prog.body(_merge_params(rep, _shard_slice(sharded, s)),
                                   self.idx[s], self.idx_long[s], self.aux[s],
                                   {})
                    for s in range(self.n_shards)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        for v in arenas.values():
            v.zero_()
        for s in range(self.n_shards):
            self.prog.body(_merge_params(rep, _shard_slice(sharded, s)),
                           self.idx[s], self.idx_long[s], self.aux[s],
                           {k: v[s] for k, v in arenas.items()})
        return arenas

    def _static_arenas(self, warm: dict) -> dict:
        return {k: torch.zeros_like(v) for k, v in warm.items()}


class _CardBuckets:
    """One sharded bucket signature's entry on a per-card mesh: one
    single-device :class:`_Bucket` a replica, on that replica's card, each
    with its own static index and aux buffers, arenas, weight copies and
    captured graph, running the single-device program verbatim (the
    reference's shard body)."""

    def __init__(self, buckets: list[_Bucket]):
        self.buckets = buckets

    def current(self) -> bool:
        return all(b.current() for b in self.buckets)

    @property
    def graph(self):
        """The first replica's graph: every replica's is captured, or
        none."""
        return self.buckets[0].graph


class ShardPlanResult(PlanResult):
    """Shard ``shard``'s view of a sharded run. On a stacked mesh
    ``arenas`` are that shard's rows of the stacked arenas (``stacked``),
    which :meth:`stacked_rows` addresses flat, so a caller can read every
    shard's rows in one gather. On a per-card mesh (``cards``) they are
    that card's own arenas, and there is no stacked view."""

    def __init__(self, graph: Graph, impls: dict[TypeId, NodeImpl],
                 stacked: dict[ArenaKey, torch.Tensor] | None, shard: int,
                 row_of: dict[tuple[ArenaKey, int], int],
                 cards: dict[ArenaKey, torch.Tensor] | None = None):
        super().__init__(graph, impls,
                         cards if stacked is None else
                         {k: v[shard] for k, v in stacked.items()}, row_of)
        self.stacked = stacked
        self.shard = shard

    def stacked_rows(self, fld: str, ids) -> tuple[torch.Tensor, np.ndarray]:
        """(flat stacked arena ``(K * rows, *row)``, row-index vector into
        it) for ``fld`` at ``ids`` of this shard."""
        if self.stacked is None:
            raise ValueError("a per-card shard has no stacked arenas; read "
                             "its own with arena_rows")
        key, rows = self._key_rows(fld, ids)
        v = self.stacked[key]
        return v.view((-1,) + tuple(v.shape[2:])), rows + self.shard * v.shape[1]


class ShardedBucketedPlanExecutor(BucketedPlanExecutor):
    """Data-parallel counterpart of :class:`BucketedPlanExecutor`: the
    *same* bucket program runs once per shard — the reference's
    ``shard_map`` over a 1-D ``("data",)`` mesh (``launch/mesh.py``), in
    one of the mesh's two placements:

    - **stacked**: K shards' runtime operands (index packs, aux vectors,
      per-shard params such as the serve engine's stacked lm slot pool)
      are stacked on a leading replica axis, and K replicas live on the
      one card of the mesh. On the card the K bodies are captured into one
      CUDA graph: one replay, K replicas.
    - **cards**: one replica a card, as the reference places them. A
      sharded signature's entry holds one single-device entry a replica
      (:class:`_CardBuckets`) on its card, built and captured there with
      that card current; the replicated weights are copied to each card
      once a version (the first placement on the weights' own device reads
      them in place), the per-shard params are a :class:`PerCard` nest,
      and a run queues every card's replay before it waits on any. Each
      replica's single-device executor (``card_executors``) runs that
      shard's fallback rounds on its card.

    The per-shard computation is the single-device program verbatim, so
    shard results equal running each shard's graph through
    :class:`BucketedPlanExecutor` alone. Entries are cached by the bucket
    signature re-keyed at ``n_shards=K`` — the same LRU cache, build lock
    and capture rules as the single-device path. Replicated ``params`` (the
    weights) stay one copy; each shard reads its row of ``shard_params``.

    ``run_sharded`` requires every shard's pack to share one bucket
    signature (the serve scheduler pads shards to a common signature for
    lm rounds). When signatures diverge or some shards are idle, it
    degrades to per-shard sequential execution through the single-device
    path (still bucketed, still cached; counted in ``n_fallback_rounds``),
    each shard on its own card (:meth:`run_shard`). A shard's slice of
    ``shard_params`` is a view with its own address, so one signature may
    capture up to K single-device graphs there.
    """

    def __init__(self, impls: dict[TypeId, NodeImpl], params: Any, *,
                 mesh: Any = None, n_shards: int | None = None, **kwargs):
        super().__init__(impls, params, **kwargs)
        if mesh is None:
            from repro_torch.launch.mesh import make_data_mesh
            mesh = make_data_mesh(n_shards, device=self.device)
        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"sharded plan execution needs a 1-D data mesh, got axes "
                f"{mesh.axis_names}")
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size)
        if n_shards is not None and n_shards != self.n_shards:
            raise ValueError(f"mesh has {self.n_shards} devices, "
                             f"n_shards={n_shards}")
        self.n_sharded_dispatches = 0
        self.n_fallback_rounds = 0
        self.card_executors: list[BucketedPlanExecutor] | None = None
        if getattr(mesh, "placement", "stacked") == "cards":
            self.card_executors = self._card_executors(kwargs)

    def _card_executors(self, kwargs: dict) -> list[BucketedPlanExecutor]:
        """One single-device executor a replica, on its card, sharing this
        executor's caches and namespace; the placement (the replica's
        index into the mesh's devices, and the card) joins its keys. The
        first placement on this executor's device (where the impls'
        weights live) reads them in place, every other one its copies."""
        from repro_torch.launch.mesh import concrete

        home = concrete(self.device)
        first = next((i for i, d in enumerate(self.mesh.listed)
                      if d == home), None)
        return [BucketedPlanExecutor(
            self.impls, self.params,
            **dict(kwargs, device=card, pack_cache=self._packs,
                   exe_cache=self._exes, namespace=self._ns,
                   compile_hook=self.compile_hook, tracer=self.tracer,
                   copy_weights=i != first, placement=(i, str(card))))
            for i, card in zip(self.mesh.replicas, self.mesh.cards)]

    # -- sharded program ------------------------------------------------------

    def sharded_executable_key(self, sspec: BucketSpec, params: Any,
                               shard_params: Any) -> tuple:
        """The reference's ``(namespace, spec, params kind, shard params
        kind)``; with ``capture`` also the data pointers of every threaded
        tensor (replicated and sharded) and the weights' pointers and
        versions, as :meth:`BucketedPlanExecutor.executable_key`."""
        key = (self._ns, sspec, _params_kind(params),
               _params_kind(shard_params))
        if self.card_executors is not None:
            key += (("cards", tuple(ex.placement
                                    for ex in self.card_executors)),)
        if not self.capture:
            return key + ("eager",)
        return key + _static_key(self.impls, params, shard_params)

    def sharded_executable_ready(self, sspec: BucketSpec, params: Any,
                                 shard_params: Any) -> bool:
        """True when the sharded program is already cached — a pure probe
        (no build, no LRU refresh), the sharded twin of
        :meth:`BucketedPlanExecutor.executable_ready`."""
        entry = self._exes.peek(
            self.sharded_executable_key(sspec, params, shard_params))
        return entry is not None and entry.current()

    def build_sharded_executable(self, sspec: BucketSpec, params: Any,
                                 shard_params: Any,
                                 span_args: dict | None = None,
                                 abort_check: Callable[[], bool] | None = None,
                                 packs: list[BucketedPack] | None = None,
                                 aux: np.ndarray | None = None
                                 ) -> tuple[Any, _ShardedBucket, float]:
        """Build (or fetch) the sharded program for ``sspec``; returns
        ``(key, entry, compile_s)``. Safe from a background compile worker,
        by the rules of :meth:`BucketedPlanExecutor.build_executable`: the
        compile hook and ``abort_check`` run before the build, builds take
        turns under the process-wide build lock, and on the card the
        capture (after an eager warm-up on a side stream) holds only the
        calling thread to its rules and hands back the random generator
        when it fails. It captures over ``packs``' indices and ``aux``
        (``(K, n_aux_lanes)``) where given, else zeros."""
        key = self.sharded_executable_key(sspec, params, shard_params)
        entry = self._exes.get(key)
        if entry is not None and entry.current():
            return key, entry, 0.0
        ctx = {"kind": "sharded", "sig": _sig_digest(sspec)}
        ctx.update(span_args or {})
        if abort_check is not None:
            ctx["abort"] = abort_check
        if self.compile_hook is not None:
            _call_compile_hook(self.compile_hook, key, ctx)
        if abort_check is not None and abort_check():
            raise RuntimeError(
                f"compile of sharded bucket {_sig_digest(sspec)} aborted "
                f"(job abandoned before the build)")
        capture = self.capture and self.device.type == "cuda"
        with self.tracer.span("xla.compile", cat="compile", kind="sharded",
                              bucket=_sig_digest(sspec),
                              steps=len(sspec.steps),
                              shards=sspec.n_shards, capture=capture,
                              **(span_args or {})) as sp, \
                build_lock(abort_check):
            entry = self._exes.peek(key)
            if entry is not None and entry.current():
                return key, entry, 0.0
            t0 = time.perf_counter()
            if self.card_executors is not None:
                entry = self._build_cards(sspec, params, shard_params, packs,
                                          aux, capture)
            else:
                prog = _BucketProgram(sspec, self.impls, fused=self.fused)
                entry = _ShardedBucket(prog, self.impls, self.device,
                                       self.n_shards)
                if self.capture:
                    entry.pinned = (tensors_of(params)
                                    + tensors_of(shard_params)
                                    + _weights(self.impls))
                if capture:
                    if packs is not None:
                        entry.load(packs, aux if aux is not None else
                                   np.zeros((self.n_shards,
                                             sspec.n_aux_lanes), np.int32))
                    entry.capture((params, shard_params))
                    self.n_captures += 1
            self._exes[key] = entry
            dt = time.perf_counter() - t0
            sp.set(lower_s=dt)
        self.n_bucket_compiles += 1
        self.compile_time_s += dt
        return key, entry, dt

    def _build_cards(self, sspec: BucketSpec, params: Any,
                     shard_params: Any, packs: list[BucketedPack] | None,
                     aux: np.ndarray | None, capture: bool) -> _CardBuckets:
        """The per-card entry: replica ``s``'s single-device program (the
        spec at one shard) built, and captured on its card, by its card
        executor over its packs' indices, its row of ``aux`` and its
        params. The caller holds the build lock."""
        prog = _BucketProgram(replace(sspec, n_shards=1), self.impls,
                              fused=self.fused)
        buckets = []
        for s, cex in enumerate(self.card_executors):
            mine = _merge_params(params, _shard_slice(shard_params, s))
            before = cex.n_captures
            buckets.append(cex._new_entry(
                prog, mine, packs[s] if packs is not None else None,
                aux[s] if aux is not None else None, capture))
            self.n_captures += cex.n_captures - before
        return _CardBuckets(buckets)

    # -- execution ------------------------------------------------------------

    def run_shard(self, s: int, graph: Graph,
                  policy: Policy | Callable[[Graph], Schedule],
                  stats: ExecStats | None = None,
                  params: Any = None) -> PlanResult:
        """Shard ``s``'s graph alone through the single-device bucketed
        path, on its own card: the fallback rounds' and the serve
        engine's per-shard tier. ``params`` are the shard's own (the
        replicated params merged with its slice of the sharded ones)."""
        if self.card_executors is None:
            return super().run(graph, policy, stats, params=params)
        stats = stats if stats is not None else ExecStats()
        cex = self.card_executors[s]
        with self.tracer.span("plan.pack", cat="plan"):
            pack = self.pack_for(graph, policy, stats)
        counts = (cex.n_captures, cex.n_replays, cex.n_bucket_compiles,
                  cex.compile_time_s)
        try:
            return cex.run_packed(graph, pack, stats, params=params)
        finally:
            # the card executors' builds and replays are this executor's
            self.n_captures += cex.n_captures - counts[0]
            self.n_replays += cex.n_replays - counts[1]
            self.n_bucket_compiles += cex.n_bucket_compiles - counts[2]
            self.compile_time_s += cex.compile_time_s - counts[3]

    def _run_fallback(self, graphs, policy, stats: ExecStats, params: Any,
                      shard_params: Any) -> list[PlanResult | None]:
        self.n_fallback_rounds += 1
        results: list[PlanResult | None] = []
        for s, g in enumerate(graphs):
            if g is None:
                results.append(None)
                continue
            mine = _shard_slice(shard_params, s)
            results.append(self.run_shard(s, g, policy, stats,
                                          params=_merge_params(params, mine)))
        return results

    def run_sharded(self, graphs, policy: Policy | Callable[[Graph], Schedule],
                    stats: ExecStats | None = None, params: Any = None,
                    shard_params: Any = None) -> list[PlanResult | None]:
        """Run one graph per shard (``None`` = idle shard) in one replay.

        ``params`` is replicated across shards; ``shard_params`` is a nest
        whose tensors carry a leading ``n_shards`` axis (e.g. the serve
        engine's stacked lm slot pool), row ``s`` read by shard ``s``.
        Returns one :class:`ShardPlanResult` per shard, viewing that
        shard's rows of the stacked arenas (copies of the graph's, unless
        the executor donates). On a per-card mesh ``shard_params`` is a
        nest of :class:`PerCard` tensors, every card's replay is queued
        before the run waits on any card, and each result holds its card's
        own arenas.
        """
        stats = stats if stats is not None else ExecStats()
        tr = self.tracer
        params = params if params is not None else self.params
        self._refuse_grad((params, shard_params))
        if len(graphs) != self.n_shards:
            raise ValueError(f"expected {self.n_shards} graphs (one per "
                             f"shard, None for idle), got {len(graphs)}")
        with tr.span("plan.pack", cat="plan"):
            packs = [self.pack_for(g, policy, stats) if g is not None
                     else None for g in graphs]
        specs = {p.spec for p in packs if p is not None}
        if not specs:
            return [None] * self.n_shards
        if any(p is None for p in packs) or len(specs) != 1:
            return self._run_fallback(graphs, policy, stats, params,
                                      shard_params)

        sspec = replace(packs[0].spec, n_shards=self.n_shards)
        with tr.span("plan.h2d", cat="plan"):
            aux = np.stack([_node_aux_np(g, p.aux_perm)
                            for g, p in zip(graphs, packs)])
        key, entry, compile_s = self.build_sharded_executable(
            sspec, params, shard_params, packs=packs, aux=aux)
        if compile_s > 0:
            # Charged to the pack that triggered the build, as the
            # single-device path does.
            packs[0].stats.n_compiles += 1
            packs[0].stats.compile_time_s += compile_s
        t1 = time.perf_counter()
        cards = self.card_executors
        with tr.span("plan.dispatch", cat="plan"):
            if cards is None:
                arenas = entry.run(packs, aux, (params, shard_params),
                                   self.donate)
                if entry.graph is not None:
                    self.n_replays += 1
            else:
                # every card's replay queued before any card is waited on
                arenas = [b.run(p, aux[s], _merge_params(
                    params, _shard_slice(shard_params, s)), self.donate)
                    for s, (b, p) in enumerate(zip(entry.buckets, packs))]
                if entry.graph is not None:
                    self.n_replays += len(arenas)
        with tr.span("plan.block", cat="plan"):
            for dev in (dict.fromkeys(self.mesh.cards) if cards is not None
                        else (self.device,)):
                block(dev)
        dt = time.perf_counter() - t1
        if self.donate:
            if cards is None:
                entry.pool = arenas
            else:
                for b, a in zip(entry.buckets, arenas):
                    b.pool = a
        if compile_s > 0:
            stats.lower_time += compile_s
            stats.n_compiles += 1
        stats.exec_time += dt
        stats.n_batches += sum(p.stats.n_steps for p in packs)
        stats.n_launches += 1
        self.n_sharded_dispatches += 1
        if cards is not None:
            return [ShardPlanResult(g, self.impls, None, s, p.row_of,
                                    cards=arenas[s])
                    for s, (g, p) in enumerate(zip(graphs, packs))]
        return [ShardPlanResult(g, self.impls, arenas, s, p.row_of)
                for s, (g, p) in enumerate(zip(graphs, packs))]

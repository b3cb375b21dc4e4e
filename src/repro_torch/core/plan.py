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

Eager PyTorch has no whole-program compile: in this port a "compile" (the
``n_compiles`` / ``compile_time_s`` counters and the ``xla.compile`` span,
kept in their reference places) is the build of a program object — the
step structure plus its index tensors uploaded to the device.  A
per-topology run is one eager pass of that program on the current stream.
A bucket signature's program is built once more on the card: run once
eagerly (a warm-up that builds what is built once), then captured into a
CUDA graph whose static input buffers each run refills before one replay —
the counterpart of the reference's one XLA executable per bucket
signature (:class:`_Bucket`).  The interpreted executor remains the
reference path.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.gather_batch import gather_rows
from repro_torch.obs.tracer import Tracer, default_tracer

from . import memplan
from .batching import Policy, Schedule, policy_cache_key, resolve_schedule
from .cache import FIFOCache, LRUCache
from .device import block, resolve_device
from .executor import ExecStats, NodeImpl, derived_copies
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


def _tensors(x: Any) -> list[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples, in ``_kind``'s
    order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=repr) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _node_aux_np(graph: Graph, perm: np.ndarray) -> np.ndarray:
    """Host-side flat aux vector: node ``aux`` attrs in plan order."""
    if perm.size == 0:
        return np.zeros(0, np.int32)
    aux_all = np.asarray([n.attrs.get("aux", 0) for n in graph.nodes],
                         np.int32)
    return aux_all[perm]


def _node_aux(graph: Graph, perm: np.ndarray, device: torch.device
              ) -> torch.Tensor:
    """The flat per-run aux operand: node ``aux`` attrs in plan order."""
    return torch.as_tensor(_node_aux_np(graph, perm), device=device)


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
        return gather_rows(arena, torch.as_tensor(rows, device=arena.device))

    def arena_rows(self, fld: str, ids) -> tuple[torch.Tensor, np.ndarray]:
        """(arena, row-index vector) for ``fld`` at ``ids`` — the raw
        ingredients of :meth:`field`."""
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
        rows = np.asarray([self._row_of[(key, i)] for i in ids], np.int32)
        return self.arenas[key], rows


def _write(arenas: dict, key: ArenaKey, rows: int, val: torch.Tensor
           ) -> torch.Tensor:
    """The arena ``key``, allocated zeroed at its first write (the first
    write decides the dtype; rows are never read before being written)."""
    buf = arenas.get(key)
    if buf is None:
        buf = torch.zeros((rows,) + key[1], dtype=val.dtype, device=val.device)
        arenas[key] = buf
    return buf


class CompiledPlan:
    """A schedule + memory plan lowered to one program whose row indices
    are fixed when it is built (one program per topology).

    ``donate=True`` reuses the arena pool in place: no per-run allocation,
    but running the plan overwrites the arenas returned by the *previous*
    run, so only enable it in throughput loops that consume each result
    immediately.  With ``donate=False`` every run gets fresh arenas.
    """

    def __init__(self, graph: Graph, sched: Schedule,
                 impls: dict[TypeId, NodeImpl], *, layout: str = "planned",
                 max_pq_vars: int = 512, pq_chunk: bool = True,
                 donate: bool = False,
                 compile_hook: Callable[[Any], None] | None = None,
                 tracer: Tracer | None = None, device=None):
        t0 = time.perf_counter()
        self.impls = impls
        self.donate = donate
        self.device = resolve_device(device)
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
        # Built programs + arena pools, keyed by the params kind so eval
        # (None) and training (dict) runs coexist. FIFO-capped.
        self._exes: FIFOCache = FIFOCache(4)
        self.n_dispatches = 0     # program runs made by execute()

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
                if opd.mode == SLICE:
                    buf[opd.start:opd.start + k] = val
                else:
                    buf.index_copy_(0, rows[("out", si, oi)],
                                    val.to(buf.dtype))
        return arenas

    # -- execution ---------------------------------------------------------

    def _aux_flat(self, graph: Graph) -> torch.Tensor:
        return _node_aux(graph, self.aux_perm, self.device)

    def _ensure_executable(self, params: Any) -> tuple:
        key = _params_kind(params)
        entry = self._exes.get(key)
        if entry is not None:
            return key
        if self.compile_hook is not None:
            _call_compile_hook(self.compile_hook, key,
                               {"kind": "plan", "sig": _sig_digest(key)})
        with self.tracer.span("xla.compile", cat="compile", kind="plan",
                              sig=_sig_digest(key)) as sp:
            t0 = time.perf_counter()
            # The pool starts empty; the first run allocates it at the
            # arenas' first writes, and with donation later runs reuse it.
            self._exes[key] = (self._build(), {})
            self.stats.n_compiles += 1
            dt = time.perf_counter() - t0
            self.stats.compile_time_s += dt
            sp.set(lower_s=dt)
        return key

    def execute(self, graph: Graph, params: Any = None) -> PlanResult:
        """Run the plan on ``graph`` (same topology, any aux values): one
        eager pass on the current stream, not synchronised."""
        with self.tracer.span("plan.h2d", cat="plan"):
            aux_flat = self._aux_flat(graph)
        key = self._ensure_executable(params)
        rows, pool = self._exes[key]
        with self.tracer.span("plan.dispatch", cat="plan"):
            arenas = self._body(params, aux_flat,
                                pool if self.donate else {}, rows)
        self.n_dispatches += 1
        if self.donate:
            self._exes[key] = (rows, arenas)
        return PlanResult(graph, self.impls, arenas, self.row_of)


class PlanExecutor:
    """Drop-in counterpart of ``DynamicExecutor`` that runs compiled plans.

    Plans are cached per ``(topology, policy)`` exactly like the interpreted
    executor's schedules; a cache hit costs one aux upload and one program
    run.
    """

    def __init__(self, impls: dict[TypeId, NodeImpl], params: Any, *,
                 layout: str = "planned", max_pq_vars: int = 512,
                 pq_chunk: bool = True, donate: bool = False,
                 cache: FIFOCache | None = None, namespace: Any = None,
                 compile_hook: Callable[[Any], None] | None = None,
                 tracer: Tracer | None = None, device=None):
        self.impls = impls
        self.params = params
        self.layout = layout
        self.max_pq_vars = max_pq_vars
        self.pq_chunk = pq_chunk
        self.donate = donate
        self.device = resolve_device(device)
        self.compile_hook = compile_hook
        self.tracer = tracer if tracer is not None else default_tracer()
        # FIFO-capped: each entry pins a policy, the lowered steps, built
        # programs, and arena pools — an unbounded topology stream must not
        # grow host/device memory forever.
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
                                    tracer=self.tracer, device=self.device)
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
    (a later slice of the port) re-keys the same signature at its replica
    count.
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


def _release_generator(dev: torch.device) -> None:
    """A capture that fails inside its body ends without taking the card's
    default random generator out of capture mode, and the generator's next
    draw outside a capture raises. Give it a copy of its state, which is
    not in capture mode (no bucket program draws random numbers)."""
    gen = torch.cuda.default_generators[
        dev.index if dev.index is not None else torch.cuda.current_device()]
    gen.graphsafe_set_state(gen.clone_state())


class _Bucket:
    """One bucket signature's entry in the executable cache: its program,
    the impls it pins (shared caches namespace on ``id(impls)``), the arena
    pool donation rotates, the static input buffers every run refills and,
    on the card, the CUDA graph captured over them.

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
                 device: torch.device):
        self.prog = prog
        self.impls = impls
        self.pool: dict = {}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: dict[ArenaKey, torch.Tensor] | None = None
        self.counts: dict | None = None   # launch counts of one replay
        self.pinned: list[torch.Tensor] = []
        self.sources: list[tuple[torch.Tensor, int]] = []
        self.loaded: BucketedPack | None = None
        self.streams: set[int] = set()   # streams it was replayed on
        spec = prog.spec
        self.idx = torch.zeros(spec.n_index_lanes, dtype=torch.int32,
                               device=device)
        self.idx_long = torch.zeros(spec.n_index_lanes, dtype=torch.int64,
                                    device=device)
        self.aux = torch.zeros(spec.n_aux_lanes, dtype=torch.int32,
                               device=device)

    def load(self, pack: BucketedPack, aux: np.ndarray) -> None:
        """Copy a run's operands into the static buffers; the index vectors
        only when they are another pack's than the last run's."""
        if self.loaded is not pack:
            self.idx.copy_(pack.idxpack)
            self.idx_long.copy_(pack.idxpack_long)
            self.loaded = pack
        self.aux.copy_(torch.from_numpy(aux))

    def current(self) -> bool:
        """False once a buffer that a copy read by the graph was derived
        from has been updated in place since the capture."""
        return all(t._version == v for t, v in self.sources)

    def capture(self, params: Any) -> None:
        """Warm up, then capture the body into a CUDA graph. The warm-up
        runs the body once eagerly on a side stream, so that what is built
        once (the blocked and packed cell weights, the kernels' attributes)
        is built there and not captured into every replay; the entry pins
        those copies and records what they were derived from. Only the
        calling thread is held to the capture's rules (another thread may
        replay, copy to the host or allocate meanwhile), and its launch
        counts during the capture, though nothing ran, go to a tally of
        their own: the counts each replay adds. The caller holds the
        build lock (:func:`_build_lock`); the side stream has finished all
        of this when the method returns."""
        dev = self.idx.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with derived_copies() as found:
            with torch.cuda.stream(side):
                self.prog.body(params, self.idx, self.idx_long, self.aux, {})
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            try:
                # Not ``torch.cuda.graph``: when the capture is invalidated
                # its exit raises before it restores the current stream.
                with launches.captured() as counts, torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = self.prog.body(params, self.idx, self.idx_long,
                                             self.aux, {})
                    finally:
                        graph.capture_end()
            except BaseException:
                _release_generator(dev)
                raise
        # one entry a buffer: every step of both passes reports its copies
        for src, version, copies in {id(f[0]): f for f in found}.values():
            self.pinned.extend(copies)
            self.sources.append((src, version))
        self.counts = counts
        self.graph, self.out = graph, out

    def run(self, pack: BucketedPack, aux: np.ndarray, params: Any,
            donate: bool) -> dict[ArenaKey, torch.Tensor]:
        """One run of the bucket on ``pack``'s operands, queued on the
        current stream: refill the static buffers, then replay the graph
        where one was captured, else run the body eagerly over them. The
        first replay on a stream marks what the graph reads as used there,
        so that memory freed with the entry (on another thread, say) is
        not handed out while a replay may still read it."""
        self.load(pack, aux)
        if self.graph is None:
            return self.prog.body(params, self.idx, self.idx_long, self.aux,
                                  self.pool if donate else {})
        stream = torch.cuda.current_stream(self.idx.device)
        if stream.cuda_stream not in self.streams:
            for t in self.pinned + [self.idx, self.idx_long, self.aux]:
                t.record_stream(stream)
            self.streams.add(stream.cuda_stream)
        self.graph.replay()
        launches.add(self.counts)
        if donate:
            return dict(self.out)
        return {k: v.clone() for k, v in self.out.items()}


# One build at a time in the process: two capture workers never capture at
# once, and a worker that finds the entry built by another while it waited
# takes that one. Lowering and packing run outside it, in parallel.
_BUILD_LOCK = threading.Lock()


@contextlib.contextmanager
def _build_lock(abort_check: Callable[[], bool] | None = None):
    """Hold the process-wide build lock; a job abandoned while it waits (or
    once it has the lock) raises before it builds, so nothing is cached."""
    while not _BUILD_LOCK.acquire(timeout=0.05):
        if abort_check is not None and abort_check():
            raise RuntimeError("build aborted (job abandoned while waiting "
                               "for the build lock)")
    try:
        if abort_check is not None and abort_check():
            raise RuntimeError("build aborted (job abandoned before the "
                               "build)")
        yield
    finally:
        _BUILD_LOCK.release()


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
                 capture: bool = True):
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

    def _weights(self) -> list[torch.Tensor]:
        """Every impl's own tensors, which a captured graph reads in place
        (directly, or through copies built once from them)."""
        return _tensors([self.impls[n].params
                         for n in sorted(self.impls, key=repr)])

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
        if not self.capture:
            return key + ("eager",)
        return key + ("static",
                      tuple(t.data_ptr() for t in _tensors(params)),
                      tuple((t.data_ptr(), t._version)
                            for t in self._weights()))

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
                _build_lock(abort_check):
            # another worker may have built it while this one waited
            entry = self._exes.peek(key)
            if entry is not None and entry.current():
                return key, entry, 0.0
            t0 = time.perf_counter()
            prog = _BucketProgram(pack.spec, self.impls, fused=self.fused)
            # The pool starts empty: an eager run allocates the arenas at
            # their first writes, and with donation later runs reuse them.
            entry = _Bucket(prog, self.impls, self.device)
            if self.capture:
                entry.pinned = _tensors(params) + self._weights()
            if capture:
                entry.load(pack, aux if aux is not None else
                           np.zeros(pack.spec.n_aux_lanes, np.int32))
                entry.capture(params)
                self.n_captures += 1
            self._exes[key] = entry
            dt = time.perf_counter() - t0
            sp.set(lower_s=dt)
            self.n_bucket_compiles += 1
            self.compile_time_s += dt
            pack.stats.n_compiles += 1
            pack.stats.compile_time_s += dt
        return key, entry, dt

    def run(self, graph: Graph, policy: Policy | Callable[[Graph], Schedule],
            stats: ExecStats | None = None, params: Any = None) -> PlanResult:
        stats = stats if stats is not None else ExecStats()
        with self.tracer.span("plan.pack", cat="plan"):
            pack = self.pack_for(graph, policy, stats)
        return self.run_packed(graph, pack, stats, params=params)

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

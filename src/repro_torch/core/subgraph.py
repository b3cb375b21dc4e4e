"""Static-subgraph definition, batching, and memory-planned compilation (§3).

A :class:`CellProgram` is a small SSA op DAG (the paper's "static subgraph",
e.g. an LSTM cell), built by a tracing API. Compilation:

1. *Batching*: ops of the same type are grouped into batches. An exact
   branch-and-bound over maximal type-batches (the paper's "grid search",
   Table 4) finds the minimal batch count for small cells; the
   sufficient-condition policy handles larger ones.
2. *Memory planning*: variables are laid out by the PQ-tree planner
   (:mod:`repro_torch.core.memplan`) so batched operands are contiguous+aligned;
   the DyNet baseline layout is declaration order.
3. *Execution*: an eager PyTorch function over two flat buffers — a
   parameter buffer (packed once) and a per-instance state buffer
   (B, state_size). Contiguous operands read as views; unplanned operands
   are stacked (counted as memory kernels/bytes — the Table 2 metrics).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import memplan
from .graph import Graph, Node
from .batching import SufficientConditionPolicy, schedule as graph_schedule
from .device import resolve_device
from .memplan import Batch, batch_is_zero_copy, plan_memory
from .ops import OPS


@dataclass(frozen=True)
class CellVar:
    name: str
    shape: tuple[int, ...]
    space: str  # "param" | "state" (inputs, intermediates, outputs)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass(frozen=True)
class CellOp:
    kind: str
    out: str
    ins: tuple[str, ...]

    def type_key(self, vars: dict[str, CellVar]) -> tuple:
        return (self.kind, tuple(vars[i].shape for i in self.ins))


class CellProgram:
    """Tracing builder for a static subgraph."""

    def __init__(self, name: str):
        self.name = name
        self.vars: dict[str, CellVar] = {}
        self.order: list[str] = []          # declaration order (DyNet layout)
        self.ops: list[CellOp] = []
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self._n = 0

    def _add(self, var: CellVar) -> str:
        if var.name in self.vars:
            raise ValueError(f"duplicate var {var.name}")
        self.vars[var.name] = var
        self.order.append(var.name)
        return var.name

    def input(self, name: str, shape: Sequence[int]) -> str:
        self.inputs.append(name)
        return self._add(CellVar(name, tuple(shape), "state"))

    def param(self, name: str, shape: Sequence[int]) -> str:
        return self._add(CellVar(name, tuple(shape), "param"))

    def op(self, kind: str, *ins: str, name: str | None = None) -> str:
        spec = OPS[kind]
        if len(ins) != spec.arity:
            raise ValueError(f"{kind} expects {spec.arity} args, got {len(ins)}")
        shapes = [self.vars[i].shape for i in ins]
        out_shape = tuple(spec.infer_shape(*shapes))
        out = name or f"%{self._n}"
        self._n += 1
        self._add(CellVar(out, out_shape, "state"))
        self.ops.append(CellOp(kind, out, tuple(ins)))
        return out

    def mark_output(self, *names: str) -> None:
        self.outputs.extend(names)

    # -- batching ------------------------------------------------------------

    def op_graph(self) -> Graph:
        producer = {op.out: i for i, op in enumerate(self.ops)}
        nodes = []
        for i, op in enumerate(self.ops):
            preds = tuple(sorted({producer[x] for x in op.ins if x in producer}))
            nodes.append(Node(id=i, type=op.type_key(self.vars), inputs=preds, op=op.kind))
        return Graph(nodes)

    def batch_schedule(self, exact_limit: int = 18) -> list[list[int]]:
        """Minimal-batch schedule over the op DAG (ops by index)."""
        g = self.op_graph()
        if len(g) <= exact_limit:
            sched = _exact_min_batches(g)
            if sched is not None:
                return sched
        return [ids for _, ids in graph_schedule(g, SufficientConditionPolicy())]


def _exact_min_batches(g: Graph) -> list[list[int]] | None:
    """Branch-and-bound over maximal type-batches with executed-set memo."""
    n = len(g)
    if n > 24:
        return None
    best: dict = {"len": math.inf, "sched": None}
    memo: dict[int, int] = {}

    from .graph import GraphState

    def rec(state: GraphState, mask: int, acc: list[list[int]]) -> None:
        if state.done():
            if len(acc) < best["len"]:
                best["len"] = len(acc)
                best["sched"] = [list(b) for b in acc]
            return
        if len(acc) + 1 >= best["len"]:
            return
        seen = memo.get(mask)
        if seen is not None and seen <= len(acc):
            return
        memo[mask] = len(acc)
        for t in state.frontier_types():
            import copy
            s2 = copy.deepcopy(state)
            batch = s2.execute_type(t)
            m2 = mask
            for i in batch:
                m2 |= 1 << i
            acc.append(batch)
            rec(s2, m2, acc)
            acc.pop()

    rec(GraphState(g), 0, [])
    return best["sched"]


# -----------------------------------------------------------------------------
# Compilation
# -----------------------------------------------------------------------------


@dataclass
class OperandPlan:
    mode: str            # "slice" | "gather" | "broadcast"
    space: str           # "param" | "state"
    offset: int          # slice start (floats) when mode == "slice"
    indices: tuple[tuple[int, int], ...]  # (offset, size) per element otherwise
    k: int
    elem_shape: tuple[int, ...]
    bytes_moved: int     # per instance (state) or total (param)


@dataclass
class BatchPlan:
    kind: str
    op_ids: list[int]
    sources: list[OperandPlan]
    result: OperandPlan


@dataclass
class CellStats:
    n_batches: int
    n_mem_kernels: int          # gathers + scatters + broadcasts per invocation
    state_bytes_moved: int      # per instance
    param_bytes_moved: int      # per invocation (weight gathers — the big cost)

    def bytes_moved(self, batch_size: int) -> int:
        return self.state_bytes_moved * batch_size + self.param_bytes_moved


class CompiledCell:
    """A memory-planned, batched static subgraph, run eagerly."""

    def __init__(self, prog: CellProgram, layout: str = "planned",
                 dtype=torch.float32):
        self.prog = prog
        self.dtype = dtype
        sched = prog.batch_schedule()
        self.batches_ops: list[list[int]] = sched
        mem_batches = []
        for bi, ids in enumerate(sched):
            ops = [prog.ops[i] for i in ids]
            mem_batches.append(Batch(
                name=f"b{bi}",
                result=tuple(op.out for op in ops),
                sources=tuple(tuple(op.ins[j] for op in ops)
                              for j in range(len(ops[0].ins))),
            ))
        self.mem_batches = mem_batches
        if layout == "planned":
            plan = plan_memory(list(prog.order), mem_batches)
            self.var_order = plan.order
        elif layout == "declaration":
            self.var_order = list(prog.order)
        else:
            raise ValueError(layout)
        self.layout = layout
        # Split the joint order into per-space offset maps.
        self.offsets: dict[str, int] = {}
        sizes = {"param": 0, "state": 0}
        for v in self.var_order:
            var = prog.vars[v]
            self.offsets[v] = sizes[var.space]
            sizes[var.space] += var.size
        self.param_size = sizes["param"]
        self.state_size = sizes["state"]
        self.batch_plans = [self._plan_batch(b, ids)
                            for b, ids in zip(mem_batches, sched)]
        self.stats = self._stats()

    # -- operand planning ----------------------------------------------------

    def _operand_plan(self, names: Sequence[str], is_result: bool) -> OperandPlan:
        vars = self.prog.vars
        spaces = {vars[n].space for n in names}
        assert len(spaces) == 1, f"operand mixes spaces: {names}"
        space = spaces.pop()
        elem_shape = vars[names[0]].shape
        size = vars[names[0]].size
        k = len(names)
        idx = tuple((self.offsets[n], size) for n in names)
        nbytes = k * size * 4
        if k == 1:
            return OperandPlan("slice", space, self.offsets[names[0]], idx,
                               k, elem_shape, 0)
        if len(set(names)) == 1 and not is_result:
            return OperandPlan("broadcast", space, self.offsets[names[0]], idx,
                               k, elem_shape, nbytes)
        if len(set(names)) == len(names):
            # Contiguous AND aligned: memory order must match operand order
            # (batch elements are pre-sorted by result offset, so sources must
            # read out in increasing offsets — the paper's alignment constraint).
            pos = [self.offsets[n] for n in names]
            aligned = all(pos[i + 1] - pos[i] == size for i in range(k - 1))
            if aligned:
                return OperandPlan("slice", space, pos[0], idx, k, elem_shape, 0)
        return OperandPlan("gather", space, 0, idx, k, elem_shape, nbytes)

    def _plan_batch(self, mem_batch: Batch, op_ids: list[int]) -> BatchPlan:
        ops = [self.prog.ops[i] for i in op_ids]
        # Order batch elements by the memory position of the result operand so
        # a contiguous result is written with one dynamic_update_slice.
        order = sorted(range(len(ops)), key=lambda j: self.offsets[ops[j].out])
        ops = [ops[j] for j in order]
        op_ids = [op_ids[j] for j in order]
        sources = [self._operand_plan(tuple(op.ins[j] for op in ops), False)
                   for j in range(len(ops[0].ins))]
        result = self._operand_plan(tuple(op.out for op in ops), True)
        return BatchPlan(ops[0].kind, op_ids, sources, result)

    def _stats(self) -> CellStats:
        n_mem = 0
        state_bytes = 0
        param_bytes = 0
        for bp in self.batch_plans:
            for op in bp.sources + [bp.result]:
                if op.mode != "slice":
                    n_mem += 1
                    if op.space == "param":
                        param_bytes += op.bytes_moved
                    else:
                        state_bytes += op.bytes_moved
        return CellStats(len(self.batch_plans), n_mem, state_bytes, param_bytes)

    # -- packing ---------------------------------------------------------------

    def pack_params(self, params: dict[str, np.ndarray],
                    device=None) -> torch.Tensor:
        buf = np.zeros(self.param_size, np.float32)
        for name, var in self.prog.vars.items():
            if var.space == "param":
                buf[self.offsets[name]:self.offsets[name] + var.size] = \
                    np.asarray(params[name], np.float32).reshape(-1)
        return torch.as_tensor(buf, dtype=self.dtype,
                               device=resolve_device(device))

    def init_params(self, rng: np.random.Generator, scale: float = 0.1,
                    device=None) -> torch.Tensor:
        params = {n: scale * rng.standard_normal(v.shape)
                  for n, v in self.prog.vars.items() if v.space == "param"}
        return self.pack_params(params, device)

    # -- execution -------------------------------------------------------------

    def _read(self, pbuf, sbuf, op: OperandPlan):
        B = sbuf.shape[0]
        n = op.k * int(np.prod(op.elem_shape) or 1)
        if op.space == "param":
            if op.mode == "slice":
                return pbuf[op.offset:op.offset + n].reshape(
                    (op.k,) + op.elem_shape)
            if op.mode == "broadcast":
                one = pbuf[op.offset:op.offset + op.indices[0][1]]
                return one.reshape(op.elem_shape).expand(
                    (op.k,) + op.elem_shape)
            return torch.stack([pbuf[o:o + s].reshape(op.elem_shape)
                                for o, s in op.indices])
        if op.mode == "slice":
            return sbuf[:, op.offset:op.offset + n].reshape(
                (B, op.k) + op.elem_shape)
        if op.mode == "broadcast":
            one = sbuf[:, op.offset:op.offset + op.indices[0][1]]
            return one.reshape((B, 1) + op.elem_shape).expand(
                (B, op.k) + op.elem_shape)
        return torch.stack([sbuf[:, o:o + s].reshape((B,) + op.elem_shape)
                            for o, s in op.indices], dim=1)

    def _write(self, sbuf, op: OperandPlan, value) -> None:
        # In place: ``sbuf`` is the fresh buffer of one ``apply`` call, and
        # every view read from it is consumed before the next write.
        B = sbuf.shape[0]
        if op.mode == "slice":
            flat = value.reshape(B, -1)
            sbuf[:, op.offset:op.offset + flat.shape[1]] = flat
            return
        for j, (o, s) in enumerate(op.indices):
            sbuf[:, o:o + s] = value[:, j].reshape(B, s)

    def apply(self, pbuf, inputs: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
        """Run the batched cell on ``B`` instances: inputs are ``(B, *shape)``
        tensors, outputs ``(B, *shape)`` views of a fresh state buffer."""
        prog = self.prog
        B = next(iter(inputs.values())).shape[0]
        sbuf = torch.zeros((B, self.state_size), dtype=self.dtype,
                           device=pbuf.device)
        for name in prog.inputs:
            var = prog.vars[name]
            off = self.offsets[name]
            sbuf[:, off:off + var.size] = inputs[name].reshape(B, var.size)
        for bp in self.batch_plans:
            srcs = [self._read(pbuf, sbuf, s) for s in bp.sources]
            out = OPS[bp.kind].fn(*srcs)
            # op fns may return (1, k, ...) for pure-param ops; broadcast
            if out.shape[0] == 1 and B != 1:
                out = out.expand((B,) + out.shape[1:])
            self._write(sbuf, bp.result, out)
        return {name: sbuf[:, self.offsets[name]:
                           self.offsets[name] + prog.vars[name].size].reshape(
                               (B,) + prog.vars[name].shape)
                for name in prog.outputs}

    def reference_apply(self, pbuf, inputs: dict[str, torch.Tensor]):
        """Unbatched oracle: execute ops one by one straight off dicts."""
        env: dict[str, torch.Tensor] = {}
        B = next(iter(inputs.values())).shape[0]
        for name, var in self.prog.vars.items():
            if var.space == "param":
                off = self.offsets[name]
                env[name] = pbuf[off:off + var.size].reshape(var.shape)
        for name in self.prog.inputs:
            env[name] = inputs[name]
        for op in self.prog.ops:
            srcs = []
            for i in op.ins:
                v = env[i]
                if self.prog.vars[i].space == "param":
                    srcs.append(v[None])          # (k=1, *elem)
                else:
                    srcs.append(v[:, None])        # (B, k=1, *elem)
            out = OPS[op.kind].fn(*srcs)
            if out.shape[0] == 1 and B != 1:
                out = out.expand((B,) + out.shape[1:])
            env[op.out] = out[:, 0]
        return {n: env[n] for n in self.prog.outputs}

    def zero_copy_fraction(self) -> float:
        ok = sum(batch_is_zero_copy(self.var_order, b) for b in self.mem_batches)
        return ok / max(len(self.mem_batches), 1)

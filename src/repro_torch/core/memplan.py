"""PQ tree-based memory allocation (ED-Batch §3.2, Alg. 2 + App. B).

Input: the variable set of a static subgraph and its batches, each batch a
result operand plus source operands (all the same length = batch size).
Output: a total order of the variables (memory allocation order) such that
as many batch operands as possible are *contiguous and aligned*:

- Adjacency: each operand's variable set occupies a consecutive run.
- Alignment: corresponding positions of a batch's operands appear in the
  same relative order, so a single slice serves every operand of the batch.

Pipeline (Alg. 2): build the PQ tree from all operand adjacency constraints
(erasing infeasible batches, line 14) -> BroadcastConstraint: transplant each
operand's subtree structure onto its sibling operands through the positional
alignment map, to a fixpoint -> DecideNodesOrder: walk each batch's operand
*order skeletons* in lockstep and solve the induced (node, order)
equivalences with (a) a parity union-find over Q-node orientations and (b) a
bijection union-find over P-node permutations; where a P node must align with
an ordered structure it is restricted to a Q node (the isomorphism-making
restructuring of the paper's broadcast pass) -> GetLeafOrder: one DFS
emitting the layout.

Operands that cannot be planned (duplicated variables, infeasible adjacency,
or incompatible orders) fall back to explicit gather/scatter at execution —
exactly DyNet's behaviour, which the executor counts for the Table 2 ablation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable, Sequence

from .pqtree import LEAF, P, Q, PQNode, PQTree

Var = Hashable


@dataclass(frozen=True)
class Batch:
    """One batched op: ``result[i] = op(*[src[i] for src in sources])``."""

    name: str
    result: tuple[Var, ...]
    sources: tuple[tuple[Var, ...], ...]

    def operands(self) -> list[tuple[Var, ...]]:
        return [self.result, *self.sources]

    @property
    def size(self) -> int:
        return len(self.result)


def _plannable_operands(batch: Batch) -> list[tuple[Var, ...]]:
    """Operands that participate in layout constraints: duplicate-free ones.
    A fully-broadcast operand (one variable repeated) needs no gather
    regardless of layout; mixed-duplicate operands always gather."""
    return [op for op in batch.operands() if len(set(op)) == len(op)]


@dataclass
class Plan:
    order: list[Var]
    offsets: dict[Var, int]
    planned: list[Batch]
    erased: list[Batch]
    infeasible_adjacency: list[str] = field(default_factory=list)
    incompatible_order: list[str] = field(default_factory=list)


# --------------------------------------------------------------------------
# Anchoring an operand in the PQ tree
# --------------------------------------------------------------------------


def _operand_anchor(tree: PQTree, op: Sequence[Var]):
    """Locate the minimal structure spanning set(op): ``(node, run)`` where
    ``run == []`` means ``node``'s leaves are exactly set(op); otherwise
    ``node`` is a Q node and ``run`` is the consecutive slice of its children
    spanning exactly set(op). None if not representable (not consecutive)."""
    want = frozenset(op)
    node = tree.root
    while node.kind != LEAF:
        if frozenset(node.leaves()) == want:
            return (node, [])
        inside = [(i, c) for i, c in enumerate(node.children)
                  if not want.isdisjoint(frozenset(c.leaves()))]
        if len(inside) == 1:
            node = inside[0][1]
            continue
        leafsets = [frozenset(c.leaves()) for _, c in inside]
        if not all(ls <= want for ls in leafsets):
            return None
        if frozenset().union(*leafsets) != want:
            return None
        if node.kind != Q:
            return None
        idxs = [i for i, _ in inside]
        if idxs != list(range(idxs[0], idxs[-1] + 1)):
            return None
        return (node, [c for _, c in inside])
    return (node, []) if frozenset(node.leaves()) == want else None


# --------------------------------------------------------------------------
# Pass 1: BroadcastConstraint
# --------------------------------------------------------------------------


def _subtree_constraints(tree: PQTree, op: Sequence[Var]) -> list[frozenset[int]] | None:
    """GETSUBTREECONS (Alg. 4) in operand-index space: structural adjacency
    constraints of the operand's subtree, as position sets."""
    anchor = _operand_anchor(tree, op)
    if anchor is None:
        return None
    node, run = anchor
    pos = {v: i for i, v in enumerate(op)}
    cons: list[frozenset[int]] = []

    def leaf_idx(n: PQNode) -> frozenset[int]:
        return frozenset(pos[v] for v in n.leaves())

    def visit(n: PQNode) -> None:
        if n.kind == LEAF:
            return
        if n.kind == P:
            cons.append(leaf_idx(n))
        else:  # Q: adjacent sibling pairs pin the order up to reversal
            for a, b in zip(n.children, n.children[1:]):
                cons.append(leaf_idx(a) | leaf_idx(b))
        for c in n.children:
            visit(c)

    top = run if run else [node]
    if len(top) > 1:  # a Q run: its sibling pairs are constraints too
        for a, b in zip(top, top[1:]):
            cons.append(leaf_idx(a) | leaf_idx(b))
    for c in top:
        visit(c)
    return [c for c in cons if 1 < len(c) < len(op)]


def broadcast_constraints(tree: PQTree, batches: list[Batch],
                          max_rounds: int = 32) -> list[Batch]:
    """Transplant every operand's structure onto its batch siblings through
    the positional alignment map, reducing until a structural fixpoint."""
    alive = list(batches)
    for _ in range(max_rounds):
        sig = tree.root.signature()
        for batch in list(alive):
            ops = _plannable_operands(batch)
            all_cons: set[frozenset[int]] = set()
            ok = True
            for op in ops:
                cons = _subtree_constraints(tree, op)
                if cons is None:
                    ok = False
                    break
                all_cons.update(cons)
            if ok:
                for op in ops:
                    for idxset in all_cons:
                        if not tree.reduce(frozenset(op[i] for i in idxset)):
                            ok = False
                            break
                    if not ok:
                        break
            if not ok:
                alive.remove(batch)
        if tree.root.signature() == sig:
            break
    return alive


# --------------------------------------------------------------------------
# Pass 2: DecideNodesOrder via order skeletons
# --------------------------------------------------------------------------

ATOM, FREE, ORD = "atom", "free", "ord"


@dataclass
class _Skel:
    kind: str
    slots: frozenset[int]
    node: PQNode | None = None           # FREE: the P node; ORD: the Q node
    children: list["_Skel"] = field(default_factory=list)  # ORD: in stored order


class _NeedsRestrict(Exception):
    """A P node must be restricted to a Q node with the given child order."""

    def __init__(self, node: PQNode, ordered_children: list[PQNode]):
        self.node = node
        self.ordered_children = ordered_children


def _skeleton(tree: PQTree, op: Sequence[Var]) -> _Skel | None:
    anchor = _operand_anchor(tree, op)
    if anchor is None:
        return None
    pos = {v: i for i, v in enumerate(op)}

    def slots_of(n: PQNode) -> frozenset[int]:
        return frozenset(pos[v] for v in n.leaves())

    def build(n: PQNode) -> _Skel:
        if n.kind == LEAF:
            return _Skel(ATOM, slots_of(n))
        kids = [build(c) for c in n.children]
        kind = FREE if n.kind == P else ORD
        return _Skel(kind, slots_of(n), node=n, children=kids)

    node, run = anchor
    if not run:
        return build(node)
    # Q run: an ORD over the run, orientation tied to the whole Q node.
    kids = [build(c) for c in run]
    return _Skel(ORD, frozenset(pos[v] for v in op), node=node, children=kids)


class _ParityUF:
    """Union-find with XOR parity (Q-node orientations)."""

    def __init__(self) -> None:
        self.parent: dict[int, int] = {}
        self.par: dict[int, int] = {}

    def add(self, x: int) -> None:
        self.parent.setdefault(x, x)
        self.par.setdefault(x, 0)

    def find(self, x: int) -> tuple[int, int]:
        if self.parent[x] == x:
            return x, 0
        r, p = self.find(self.parent[x])
        self.parent[x] = r
        self.par[x] ^= p
        return r, self.par[x]

    def union(self, a: int, b: int, rel: int) -> bool:
        """Require parity(a) XOR parity(b) == rel."""
        self.add(a)
        self.add(b)
        ra, pa = self.find(a)
        rb, pb = self.find(b)
        if ra == rb:
            return (pa ^ pb) == rel
        self.parent[ra] = rb
        self.par[ra] = pa ^ pb ^ rel
        return True


class _BijectionUF:
    """Union-find whose edges carry child-index bijections (P permutations):
    find(n) -> (root, f) with f[i] = the root's child index corresponding to
    child i of n ("same layout position")."""

    def __init__(self) -> None:
        self.parent: dict[int, int] = {}
        self.edge: dict[int, tuple[int, ...]] = {}
        self.nodes: dict[int, PQNode] = {}

    def add(self, node: PQNode) -> None:
        i = id(node)
        if i not in self.parent:
            self.parent[i] = i
            self.edge[i] = tuple(range(len(node.children)))
            self.nodes[i] = node

    def find(self, i: int) -> tuple[int, tuple[int, ...]]:
        if self.parent[i] == i:
            return i, self.edge[i]
        r, fp = self.find(self.parent[i])
        f = tuple(fp[j] for j in self.edge[i])
        self.parent[i] = r
        self.edge[i] = f
        return r, f

    def union(self, a: PQNode, f_ab: tuple[int, ...], b: PQNode) -> bool:
        """Require: child i of ``a`` at the same layout slot as child f_ab[i]
        of ``b``."""
        self.add(a)
        self.add(b)
        ra, fa = self.find(id(a))
        rb, fb = self.find(id(b))
        if ra == rb:
            return all(fb[f_ab[i]] == fa[i] for i in range(len(f_ab)))
        inv_fa = [0] * len(fa)
        for i, v in enumerate(fa):
            inv_fa[v] = i
        self.parent[ra] = rb
        self.edge[ra] = tuple(fb[f_ab[inv_fa[j]]] for j in range(len(fa)))
        return True


def _couple(a: _Skel, b: _Skel, qs: _ParityUF, ps: _BijectionUF) -> bool:
    """Constrain node orders so operands a and b read out aligned."""
    if a.slots != b.slots:
        return False
    if a.kind == ATOM and b.kind == ATOM:
        return True
    if ATOM in (a.kind, b.kind):
        return False
    if a.kind == FREE and b.kind == ORD:
        return _couple_free_ord(a, b)
    if a.kind == ORD and b.kind == FREE:
        return _couple_free_ord(b, a)
    if a.kind == FREE and b.kind == FREE:
        by_slots = {c.slots: i for i, c in enumerate(b.children)}
        if len(a.children) != len(b.children):
            return False
        f = []
        for ca in a.children:
            j = by_slots.get(ca.slots)
            if j is None:
                return False
            f.append(j)
        if id(a.node) == id(b.node):
            if f != list(range(len(f))):
                return False
        elif not ps.union(a.node, tuple(f), b.node):
            return False
        return all(_couple(ca, b.children[f[i]], qs, ps)
                   for i, ca in enumerate(a.children))
    # ORD vs ORD
    sa = [c.slots for c in a.children]
    sb = [c.slots for c in b.children]
    if sa == sb:
        rel = 0
        pairs = list(zip(a.children, b.children))
    elif sa == list(reversed(sb)):
        rel = 1
        pairs = list(zip(a.children, reversed(b.children)))
    else:
        return False
    if id(a.node) == id(b.node):
        if rel != 0:
            return False
    elif not qs.union(id(a.node), id(b.node), rel):
        return False
    return all(_couple(ca, cb, qs, ps) for ca, cb in pairs)


def _couple_free_ord(free: _Skel, ordd: _Skel) -> bool:
    """A P node aligned against an ordered structure: restrict it to a Q node
    with matching child order (raises to restart skeleton extraction)."""
    if len(free.children) != len(ordd.children):
        return False
    # Skeleton children were built in node.children order — map by slot set.
    slot_to_child: dict[frozenset, PQNode] = {
        skel_child.slots: pq_child
        for skel_child, pq_child in zip(free.children, free.node.children)
    }
    if any(cb.slots not in slot_to_child for cb in ordd.children):
        return False
    new_children = [slot_to_child[cb.slots] for cb in ordd.children]
    raise _NeedsRestrict(free.node, new_children)


def decide_node_order(tree: PQTree, batches: list[Batch]):
    """Returns (parity_uf, bijection_uf, surviving_batches)."""
    alive = list(batches)
    for _ in range(256):  # bounded by the number of P nodes (each restrict P->Q)
        qs, ps = _ParityUF(), _BijectionUF()
        restricted = False
        next_alive: list[Batch] = []
        try:
            for batch in alive:
                ops = _plannable_operands(batch)
                skels = []
                ok = True
                for op in ops:
                    s = _skeleton(tree, op)
                    if s is None:
                        ok = False
                        break
                    skels.append(s)
                if ok and skels:
                    ref = skels[0]
                    for other in skels[1:]:
                        if not _couple(ref, other, qs, ps):
                            ok = False
                            break
                if ok:
                    next_alive.append(batch)
        except _NeedsRestrict as r:
            r.node.kind = Q
            r.node.children = r.ordered_children
            restricted = True
        if not restricted:
            return qs, ps, next_alive
    return qs, ps, next_alive  # pragma: no cover


def get_leaf_order(tree: PQTree, qs: _ParityUF, ps: _BijectionUF) -> list[Var]:
    """GETLEAFORDER: DFS with Q orientations from the parity UF and P
    permutations from the bijection UF (unconstrained nodes: stored order)."""
    out: list[Var] = []

    def emit(n: PQNode) -> None:
        if n.kind == LEAF:
            out.append(n.value)
            return
        children = n.children
        if n.kind == Q and id(n) in qs.parent:
            _, parity = qs.find(id(n))
            if parity:
                children = list(reversed(children))
        elif n.kind == P and id(n) in ps.parent:
            _, f = ps.find(id(n))
            slots: list[PQNode | None] = [None] * len(children)
            for i, c in enumerate(children):
                slots[f[i]] = c
            children = [c for c in slots if c is not None]
        for c in children:
            emit(c)

    emit(tree.root)
    return out


# --------------------------------------------------------------------------
# Main entry (Alg. 2 MAIN)
# --------------------------------------------------------------------------


def _pipeline(variables: Sequence[Var], candidates: list[Batch]):
    """adjacency -> broadcast -> order passes over a fresh tree."""
    tree = PQTree(variables)
    infeasible: list[str] = []
    alive: list[Batch] = []
    for b in candidates:
        if all(tree.reduce(set(op)) for op in _plannable_operands(b)):
            alive.append(b)
        else:
            infeasible.append(b.name)
    alive2 = broadcast_constraints(tree, alive)
    qs, ps, alive3 = decide_node_order(tree, alive2)
    return tree, qs, ps, alive3, infeasible


def _self_consistent(batch: Batch) -> bool:
    """Can this batch ever be zero-copy on its own? (e.g. sources (a,b) and
    (b,a) can never align — erase pre-emptively so its adjacency constraints
    don't poison other batches.)"""
    own_vars = sorted({v for op in _plannable_operands(batch) for v in op},
                      key=repr)
    if not own_vars:
        return True
    tree = PQTree(own_vars)
    if not all(tree.reduce(set(op)) for op in _plannable_operands(batch)):
        return False
    if not broadcast_constraints(tree, [batch]):
        return False
    _, _, alive = decide_node_order(tree, [batch])
    return bool(alive)


def plan_memory(variables: Sequence[Var], batches: Sequence[Batch],
                sizes: dict[Var, int] | None = None) -> Plan:
    erased: list[Batch] = []
    incompatible: list[str] = []
    candidates: list[Batch] = []
    for b in batches:
        if _self_consistent(b):
            candidates.append(b)
        else:
            erased.append(b)
            incompatible.append(b.name)
    # Replan whenever the order stage drops a batch: its already-committed
    # adjacency constraints would otherwise block feasible batches. The
    # victim is chosen greedily to maximize surviving planned batches.
    infeasible: list[str] = []
    for _ in range(len(candidates) + 1):
        tree, qs, ps, alive3, infeasible = _pipeline(variables, candidates)
        if len(alive3) == len(candidates):
            break
        # Some batch blocks others. Pick the victim (any candidate) whose
        # removal leaves the most jointly plannable batches.
        victim, victim_count = None, len(alive3)
        for v in candidates:
            trial = [b for b in candidates if b is not v]
            _, _, _, alive_t, _ = _pipeline(variables, trial)
            if len(alive_t) > victim_count:
                victim, victim_count = v, len(alive_t)
        if victim is None:
            # No single removal helps — keep the current best subset.
            victims = [b for b in candidates if b not in alive3]
            erased += victims
            incompatible += [b.name for b in victims]
            candidates = list(alive3)
            tree, qs, ps, alive3, infeasible = _pipeline(variables, candidates)
            break
        incompatible.append(victim.name)
        candidates = [b for b in candidates if b is not victim]
        erased.append(victim)
    order = get_leaf_order(tree, qs, ps)
    sizes = sizes or {}
    offsets: dict[Var, int] = {}
    off = 0
    for v in order:
        offsets[v] = off
        off += sizes.get(v, 1)
    return Plan(order=order, offsets=offsets, planned=alive3, erased=erased,
                infeasible_adjacency=infeasible, incompatible_order=incompatible)


# --------------------------------------------------------------------------
# Row tables (arena lowering; core/plan.py)
# --------------------------------------------------------------------------


def plan_rows(variables: Sequence[Var],
              batches: Sequence[Batch]) -> tuple[Plan, dict[Var, int]]:
    """Plan a layout of unit-size rows (one arena row per variable) and
    return the plan plus its row table ``var -> row``. This is the entry the
    compiled-plan executor uses: arenas are (rows, *elem) buffers, so offsets
    are row indices rather than flat element offsets."""
    plan = plan_memory(variables, batches)  # unit sizes: offsets ARE rows
    return plan, dict(plan.offsets)


@dataclass
class ChunkedPlan:
    """Result of :func:`plan_rows_chunked`."""

    order: list[Var]
    n_planned: int
    n_erased: int
    n_chunks: int
    chunk_sizes: list[int] = field(default_factory=list)
    n_skipped_chunks: int = 0    # fell back to declaration order


def plan_rows_chunked(var_groups: Sequence[Sequence[Var]],
                      batches: Sequence[Batch],
                      max_vars: int) -> ChunkedPlan:
    """Chunked joint planning for universes beyond the joint planner budget.

    ED-Batch runs Alg. 2 once per *static subgraph*; the graph-level plan
    (core/plan.py) wants one joint layout over every schedule batch, whose
    cost grows superlinearly in the variable count. This entry splits the
    declaration stream into contiguous chunks of at most ``max_vars``
    variables — cutting only on group (schedule-step) boundaries, so a
    batch's result operand always lands whole in one chunk — and plans each
    chunk independently. A batch is a planning candidate in the unique
    chunk containing *all* of its operand variables; batches spanning
    chunks keep the declaration order of their variables and fall back to
    gather/scatter at lowering, exactly like planner-erased batches.
    """
    chunks: list[list[Var]] = []
    cur: list[Var] = []
    for grp in var_groups:
        if cur and len(cur) + len(grp) > max_vars:
            chunks.append(cur)
            cur = []
        cur.extend(grp)
    if cur:
        chunks.append(cur)
    order: list[Var] = []
    planned = erased = skipped = 0
    for vars_c in chunks:
        if len(vars_c) > max_vars:
            # A single oversized group (one huge batch): planning it alone
            # would blow the budget the chunking exists to respect.
            order.extend(vars_c)
            skipped += 1
            continue
        inset = set(vars_c)
        cand = [b for b in batches
                if all(v in inset for op in b.operands() for v in op)]
        try:
            plan = plan_memory(vars_c, cand)
            order.extend(plan.order)
            planned += len(plan.planned)
            erased += len(plan.erased)
        except Exception:   # noqa: BLE001 — planner is best-effort
            order.extend(vars_c)
            skipped += 1
    return ChunkedPlan(order=order, n_planned=planned, n_erased=erased,
                       n_chunks=len(chunks),
                       chunk_sizes=[len(c) for c in chunks],
                       n_skipped_chunks=skipped)


def operand_run(row_of: dict[Var, int], op: Sequence[Var]) -> int | None:
    """The start row if ``op`` reads out as one ascending contiguous run of
    rows (stride exactly +1, duplicates disallowed) — i.e. the operand lowers
    to a static slice. ``None`` means it must gather."""
    rows = [row_of[v] for v in op]
    if any(rows[i + 1] - rows[i] != 1 for i in range(len(rows) - 1)):
        return None
    return rows[0]


# --------------------------------------------------------------------------
# Layout quality oracle (used by tests and the Table 2 ablation)
# --------------------------------------------------------------------------


def operand_is_contiguous(order: Sequence[Var], op: Sequence[Var]) -> bool:
    pos = {v: i for i, v in enumerate(order)}
    idx = sorted(pos[v] for v in set(op))
    return idx[-1] - idx[0] == len(idx) - 1


def batch_is_zero_copy(order: Sequence[Var], batch: Batch) -> bool:
    """True iff every non-broadcast operand is contiguous and all operands
    are mutually aligned (same relative order by position)."""
    pos = {v: i for i, v in enumerate(order)}
    ops = _plannable_operands(batch)
    for op in ops:
        if not operand_is_contiguous(order, op):
            return False
    if not ops:
        return True
    ref = ops[0]
    perm = sorted(range(len(ref)), key=lambda i: pos[ref[i]])
    for op in ops[1:]:
        if sorted(range(len(op)), key=lambda i: pos[op[i]]) != perm:
            return False
    return True

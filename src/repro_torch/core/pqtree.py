"""Booth–Lueker PQ trees (ED-Batch §3.2).

A PQ tree over a universe X represents a set of permutations of X closed
under (a) arbitrary reordering of P-node children and (b) reversal of Q-node
children. ``reduce(S)`` restricts the represented set to permutations where
S is consecutive (the consecutive-ones REDUCE), restructuring via the
classic templates (P1–P6, Q1–Q3), implemented here as a recursive pass over
the pertinent subtree. ``reduce`` is transactional: on infeasible
constraints the tree is left unchanged and False is returned (the memory
planner then erases that batch, per Alg. 2 line 14).
"""

from __future__ import annotations

import copy
from typing import Hashable, Iterable, Sequence

LEAF, P, Q = "leaf", "P", "Q"
EMPTY, FULL, PARTIAL = 0, 1, 2


class _Infeasible(Exception):
    pass


class PQNode:
    __slots__ = ("kind", "children", "value")

    def __init__(self, kind: str, children: list["PQNode"] | None = None,
                 value: Hashable = None):
        self.kind = kind
        self.children: list[PQNode] = children or []
        self.value = value

    def leaves(self) -> list[Hashable]:
        if self.kind == LEAF:
            return [self.value]
        out: list[Hashable] = []
        stack = list(reversed(self.children))
        while stack:
            n = stack.pop()
            if n.kind == LEAF:
                out.append(n.value)
            else:
                stack.extend(reversed(n.children))
        return out

    def signature(self):
        """Structure signature (used to detect restructuring fixpoints)."""
        if self.kind == LEAF:
            return self.value
        sig = tuple(c.signature() for c in self.children)
        return (self.kind, frozenset(sig) if self.kind == P else sig)

    def __repr__(self) -> str:
        if self.kind == LEAF:
            return repr(self.value)
        sep = ", " if self.kind == P else " < "
        return f"{'P' if self.kind == P else 'Q'}({sep.join(map(repr, self.children))})"


def _group(children: list[PQNode]) -> PQNode:
    """Wrap >=2 nodes in a fresh P node; a single node passes through."""
    return children[0] if len(children) == 1 else PQNode(P, children)


class PQTree:
    def __init__(self, universe: Iterable[Hashable]):
        leaves = [PQNode(LEAF, value=v) for v in universe]
        if not leaves:
            raise ValueError("empty universe")
        seen = set()
        for l in leaves:
            if l.value in seen:
                raise ValueError(f"duplicate leaf {l.value!r}")
            seen.add(l.value)
        self.universe = frozenset(seen)
        self.root: PQNode = leaves[0] if len(leaves) == 1 else PQNode(P, leaves)

    # -- public API ---------------------------------------------------------

    def frontier(self) -> list[Hashable]:
        return self.root.leaves()

    def reduce(self, S: Iterable[Hashable]) -> bool:
        """Restrict to permutations where S is consecutive. Transactional."""
        S = frozenset(S)
        if not S <= self.universe:
            raise ValueError(f"constraint {set(S) - self.universe} outside universe")
        if len(S) <= 1 or S == self.universe:
            return True
        backup = self.root
        try:
            root = copy.deepcopy(self.root)
            self.root = self._reduce_from(root, S)
            return True
        except _Infeasible:
            self.root = backup
            return False

    # -- reduction ----------------------------------------------------------

    def _reduce_from(self, root: PQNode, S: frozenset) -> PQNode:
        # Descend to the pertinent root: the deepest node containing all of S.
        parent: PQNode | None = None
        idx = -1
        node = root
        while node.kind != LEAF:
            holder = None
            for i, c in enumerate(node.children):
                k = _full_count(c, S)
                if k == len(S):
                    holder = (i, c)
                    break
                if k > 0:
                    holder = None
                    break
            if holder is None:
                break
            parent, idx, node = node, holder[0], holder[1]
        replacement = _reduce_pert_root(node, S)
        if parent is None:
            return replacement
        parent.children[idx] = replacement
        return root


def _full_count(node: PQNode, S: frozenset) -> int:
    if node.kind == LEAF:
        return 1 if node.value in S else 0
    return sum(_full_count(c, S) for c in node.children)


def _label_children(node: PQNode, S: frozenset) -> list[tuple[int, PQNode]]:
    out = []
    for c in node.children:
        k = _full_count(c, S)
        if k == 0:
            out.append((EMPTY, c))
        elif k == sum(1 for _ in c.leaves()):
            out.append((FULL, c))
        else:
            out.append(_reduce_internal(c, S))
    return out


def _reduce_internal(node: PQNode, S: frozenset) -> tuple[int, PQNode]:
    """Templates for non-root pertinent nodes. PARTIAL results are Q nodes
    whose children are ordered empty-end -> full-end."""
    if node.kind == LEAF:
        return (FULL if node.value in S else EMPTY), node
    labeled = _label_children(node, S)
    empties = [c for l, c in labeled if l == EMPTY]
    fulls = [c for l, c in labeled if l == FULL]
    partials = [c for l, c in labeled if l == PARTIAL]
    if node.kind == P:
        if len(partials) > 1:
            raise _Infeasible
        if not partials:
            if not fulls:
                return EMPTY, node                                  # P-all-empty
            if not empties:
                return FULL, node                                   # P1
            # P3: split into a partial Q [empty-group, full-group]
            return PARTIAL, PQNode(Q, [_group(empties), _group(fulls)])
        # P5: splice empties/fulls onto the partial child's ends
        q = partials[0]
        children = ([_group(empties)] if empties else []) + q.children + \
                   ([_group(fulls)] if fulls else [])
        return PARTIAL, PQNode(Q, children)
    # Q node: children sequence must read E* [partial] F* in some direction.
    for direction in (1, -1):
        seq = labeled if direction == 1 else list(reversed(labeled))
        new_children: list[PQNode] = []
        phase = 0          # 0 -> in empty run, 1 -> in full run
        used_partial = False
        ok = True
        for lab, c in seq:
            if lab == EMPTY:
                if phase == 1:
                    ok = False
                    break
                new_children.append(c)
            elif lab == FULL:
                phase = 1
                new_children.append(c)
            else:  # PARTIAL: acts as the E->F boundary, flattened inline
                if phase == 1 or used_partial:
                    ok = False
                    break
                used_partial = True
                phase = 1
                kids = c.children if direction == 1 else c.children
                new_children.extend(kids)
        if not ok:
            continue
        if not fulls and not partials:
            return EMPTY, node
        if not empties and not partials:
            return FULL, node
        return PARTIAL, PQNode(Q, new_children)                     # Q2
    raise _Infeasible


def _reduce_pert_root(node: PQNode, S: frozenset) -> PQNode:
    """Templates for the pertinent root (P2/P4/P6, Q2/Q3 root forms)."""
    if node.kind == LEAF:
        return node
    labeled = _label_children(node, S)
    empties = [c for l, c in labeled if l == EMPTY]
    fulls = [c for l, c in labeled if l == FULL]
    partials = [c for l, c in labeled if l == PARTIAL]
    if node.kind == P:
        if len(partials) > 2:
            raise _Infeasible
        if not partials:
            if not empties or not fulls:
                return node                                         # P1 at root
            node.children = empties + [_group(fulls)]               # P2
            return node
        if len(partials) == 1:                                      # P4
            q = partials[0]
            q.children = q.children + ([_group(fulls)] if fulls else [])
            _normalize_q(q)
            if not empties:
                return q
            node.children = empties + [q]
            return node
        # P6: two partials merge around the grouped full children
        q1, q2 = partials
        mid = [_group(fulls)] if fulls else []
        merged = PQNode(Q, q1.children + mid + list(reversed(q2.children)))
        _normalize_q(merged)
        if not empties:
            return merged
        node.children = empties + [merged]
        return node
    # Q root: pattern E* [partial] F* [partial-reversed] E* in some direction.
    for direction in (1, -1):
        seq = labeled if direction == 1 else list(reversed(labeled))
        new_children: list[PQNode] = []
        phase = 0          # 0 leading empties, 1 full block, 2 trailing empties
        n_partial = 0
        ok = True
        for lab, c in seq:
            if lab == EMPTY:
                if phase == 1:
                    phase = 2
                new_children.append(c)
            elif lab == FULL:
                if phase == 2:
                    ok = False
                    break
                phase = 1
                new_children.append(c)
            else:  # PARTIAL
                n_partial += 1
                if n_partial > 2:
                    ok = False
                    break
                if phase == 0:      # E->F boundary: empty end first
                    phase = 1
                    new_children.extend(c.children)
                elif phase == 1:    # F->E boundary: full end first
                    phase = 2
                    new_children.extend(reversed(c.children))
                else:
                    ok = False
                    break
        if ok:
            node.children = new_children
            _normalize_q(node)
            return node
    raise _Infeasible


def _normalize_q(node: PQNode) -> None:
    """Flatten any directly nested Q children (can arise from splicing)."""
    flat: list[PQNode] = []
    for c in node.children:
        if c.kind == Q:
            flat.extend(c.children)
        else:
            flat.append(c)
    node.children = flat


def satisfies(order: Sequence[Hashable], constraints: Iterable[Iterable[Hashable]]) -> bool:
    """Oracle: is every constraint set consecutive in ``order``?"""
    pos = {v: i for i, v in enumerate(order)}
    for S in constraints:
        idx = sorted(pos[v] for v in set(S))
        if idx and idx[-1] - idx[0] != len(idx) - 1:
            return False
    return True

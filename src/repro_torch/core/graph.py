"""Typed dataflow graphs for dynamic DNNs (ED-Batch §2.1).

A ``Graph`` is a DAG of typed operations. The batching problem (Alg. 1)
repeatedly picks an operation *type*, executes every frontier node of that
type as one batch, and removes them. ``GraphState`` maintains the mutable
per-schedule view with O(E) total update cost: the frontier, per-type frontier
counts, and the per-type *subgraph frontier* |Frontier(G^t)| used by the
reward (Eq. 1) and the sufficient-condition policy (Lemma 1).

``G^t`` is the subgraph induced on type-t nodes with the *direct* edges of G
(Fig. 2(c) of the paper): a type-t node is on Frontier(G^t) iff it has no
unexecuted direct type-t predecessor.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Iterable, Sequence

TypeId = Hashable


@dataclass(frozen=True)
class Node:
    """One operation instance in a dataflow graph."""

    id: int
    type: TypeId
    inputs: tuple[int, ...] = ()
    # Execution payload: op kind + static attributes (shape signature lives in
    # the type; two nodes share a type iff they can be batched together).
    op: str = ""
    attrs: dict[str, Any] = field(default_factory=dict, hash=False, compare=False)


class Graph:
    """An immutable typed DAG plus cached static analyses."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes: list[Node] = list(nodes)
        n = len(self.nodes)
        for i, node in enumerate(self.nodes):
            if node.id != i:
                raise ValueError(f"node ids must be dense 0..n-1, got {node.id} at {i}")
            for p in node.inputs:
                if not (0 <= p < i):
                    raise ValueError(f"node {i} has non-topological input {p}")
        self.succs: list[list[int]] = [[] for _ in range(n)]
        for node in self.nodes:
            for p in node.inputs:
                self.succs[p].append(node.id)
        self.types: list[TypeId] = sorted({nd.type for nd in self.nodes}, key=repr)
        self._depth: list[int] | None = None

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def depth(self) -> list[int]:
        """Topological depth per node; inputs to the network have depth 0."""
        if self._depth is None:
            d = [0] * len(self.nodes)
            for node in self.nodes:
                if node.inputs:
                    d[node.id] = 1 + max(d[p] for p in node.inputs)
            self._depth = d
        return self._depth

    def type_subgraph_depth(self, t: TypeId) -> int:
        """Longest chain (in nodes) within the direct-edge induced subgraph G^t."""
        best = 0
        chain: dict[int, int] = {}
        for node in self.nodes:
            if node.type != t:
                continue
            c = 1 + max((chain.get(p, 0) for p in node.inputs), default=0)
            chain[node.id] = c
            best = max(best, c)
        return best

    def batch_lower_bound(self) -> int:
        """App. A.3: |Batching*(G)| >= sum_t Depth(G^t)."""
        return sum(self.type_subgraph_depth(t) for t in self.types)

    def topology_key(self) -> int:
        """Hash identifying the topology class, for schedule caching."""
        acc = 0x811C9DC5
        for node in self.nodes:
            h = hash((node.type, node.inputs))
            acc = (acc ^ h) * 0x01000193 % (1 << 64)
        return acc


class GraphState:
    """Mutable scheduling view over a Graph (one batching episode)."""

    def __init__(self, graph: Graph):
        self.graph = graph
        n = len(graph)
        self.executed = [False] * n
        self.n_remaining = n
        self.indeg = [0] * n
        self.same_type_indeg = [0] * n
        for node in graph.nodes:
            self.indeg[node.id] = len(node.inputs)
            self.same_type_indeg[node.id] = sum(
                1 for p in node.inputs if graph.nodes[p].type == node.type
            )
        self.frontier: set[int] = {i for i in range(n) if self.indeg[i] == 0}
        self.frontier_count: dict[TypeId, int] = defaultdict(int)
        self.remaining_count: dict[TypeId, int] = defaultdict(int)
        self.remaining_depth_sum: dict[TypeId, float] = defaultdict(float)
        self.subgraph_frontier_count: dict[TypeId, int] = defaultdict(int)
        depth = graph.depth
        for node in graph.nodes:
            t = node.type
            self.remaining_count[t] += 1
            self.remaining_depth_sum[t] += depth[node.id]
            if self.same_type_indeg[node.id] == 0:
                self.subgraph_frontier_count[t] += 1
        for i in self.frontier:
            self.frontier_count[graph.nodes[i].type] += 1

    # -- queries -----------------------------------------------------------

    def done(self) -> bool:
        return self.n_remaining == 0

    def frontier_types(self) -> list[TypeId]:
        return sorted((t for t, c in self.frontier_count.items() if c > 0), key=repr)

    def frontier_of_type(self, t: TypeId) -> list[int]:
        nodes = self.graph.nodes
        return sorted(i for i in self.frontier if nodes[i].type == t)

    def readiness_ratio(self, t: TypeId) -> float:
        """|Frontier_t(G)| / |Frontier(G^t)| in (0, 1]; == 1 iff Lemma 1 holds.

        Eq. 1 of the paper prints the reciprocal, but the worked example
        (5/7 vs 1/1 on the tree of Fig. 1) and Lemma 1 fix this orientation:
        ready-in-G over ready-in-type-subgraph.
        """
        sub = self.subgraph_frontier_count[t]
        if sub == 0:
            return 0.0
        return self.frontier_count[t] / sub

    # -- mutation ----------------------------------------------------------

    def execute_type(self, t: TypeId) -> list[int]:
        """Execute one batch = all frontier nodes of type t. Returns the batch."""
        batch = self.frontier_of_type(t)
        if not batch:
            raise ValueError(f"no frontier nodes of type {t!r}")
        nodes = self.graph.nodes
        depth = self.graph.depth
        for i in batch:
            self.frontier.discard(i)
        self.frontier_count[t] -= len(batch)
        for i in batch:
            self.executed[i] = True
            self.n_remaining -= 1
            self.remaining_count[t] -= 1
            self.remaining_depth_sum[t] -= depth[i]
            if self.same_type_indeg[i] == 0:
                self.subgraph_frontier_count[t] -= 1
            for s in self.graph.succs[i]:
                self.indeg[s] -= 1
                if nodes[s].type == t:
                    self.same_type_indeg[s] -= 1
                    if self.same_type_indeg[s] == 0:
                        self.subgraph_frontier_count[t] += 1
                if self.indeg[s] == 0 and not self.executed[s]:
                    self.frontier.add(s)
                    self.frontier_count[nodes[s].type] += 1
        return batch


def validate_schedule(graph: Graph, batches: Iterable[tuple[TypeId, list[int]]]) -> None:
    """Assert a batch schedule is a legal, complete execution of ``graph``."""
    done = [False] * len(graph)
    for t, ids in batches:
        for i in ids:
            node = graph.nodes[i]
            assert node.type == t, f"node {i} type {node.type!r} in batch of {t!r}"
            assert not done[i], f"node {i} executed twice"
            for p in node.inputs:
                assert done[p], f"node {i} ran before its input {p}"
        for i in ids:
            done[i] = True
    assert all(done), f"{done.count(False)} nodes never executed"

"""State encodings for the FSM batching policy (ED-Batch §2.3).

Each encoding maps a GraphState to a hashable state. The paper evaluates
three; ``E_sort`` wins empirically (§5.3). ``E_sort_phase`` is the phase-
augmented extension the paper suggests for the App. A.4 failure case.
"""

from __future__ import annotations

from typing import Callable, Hashable

from .graph import GraphState

Encoder = Callable[[GraphState], Hashable]


def e_base(state: GraphState) -> Hashable:
    """{v.type | v in Frontier(G)} — the set of frontier types."""
    return frozenset(state.frontier_types())


def e_max(state: GraphState) -> Hashable:
    """E_base plus the most common frontier type (ties: lexicographic)."""
    types = state.frontier_types()
    if not types:
        return (frozenset(), None)
    top = max(types, key=lambda t: (state.frontier_count[t], repr(t)))
    return (frozenset(types), top)


def e_sort(state: GraphState) -> Hashable:
    """Frontier types sorted by occurrence count (desc, ties lexicographic)."""
    types = state.frontier_types()
    return tuple(sorted(types, key=lambda t: (-state.frontier_count[t], repr(t))))


def e_sort_phase(state: GraphState, buckets: int = 4) -> Hashable:
    """E_sort + committed-fraction bucket (App. A.4 extension)."""
    total = len(state.graph)
    frac = (total - state.n_remaining) / max(total, 1)
    phase = min(int(frac * buckets), buckets - 1)
    return (e_sort(state), phase)


ENCODERS: dict[str, Encoder] = {
    "base": e_base,
    "max": e_max,
    "sort": e_sort,
    "sort_phase": e_sort_phase,
}

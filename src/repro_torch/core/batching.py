"""Batching policies and the Alg. 1 scheduling driver.

Implements the two baseline heuristics the paper compares against
(TF-Fold depth-based, DyNet agenda-based), the sufficient-condition
heuristic of §5.3, and the generic driver that turns any frontier-type
policy into a batch schedule.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict
from typing import Callable, Hashable, Iterable, Protocol, Sequence

from .graph import Graph, GraphState, TypeId

Schedule = list[tuple[TypeId, list[int]]]

# FSM policy payload format version: written by to_payload, checked by
# from_payload, and re-exported by serve/registry.py (REGISTRY_VERSION) so
# the writer and both readers can never drift apart.
PAYLOAD_VERSION = 1


class Policy(Protocol):
    def next_type(self, state: GraphState) -> TypeId: ...


def schedule(graph: Graph, policy: Policy) -> Schedule:
    """Alg. 1: iteratively batch all frontier nodes of policy-chosen type."""
    state = GraphState(graph)
    out: Schedule = []
    while not state.done():
        t = policy.next_type(state)
        out.append((t, state.execute_type(t)))
    return out


def resolve_schedule(graph: Graph,
                     policy: "Policy | Callable[[Graph], Schedule]") -> Schedule:
    """Turn either a frontier-type policy or a whole-graph schedule function
    (e.g. :func:`depth_schedule`) into a concrete schedule."""
    if callable(policy) and not hasattr(policy, "next_type"):
        return policy(graph)
    return schedule(graph, policy)


def policy_cache_key(policy) -> Hashable:
    """Cache key for per-(topology, policy) schedule/plan caches.

    Policies that define ``cache_key()`` use it: stateless heuristics return
    a stable kind string (so shared serve caches hit across engine
    instances) and registry-loaded FSM policies return their content
    fingerprint (so a schedule cached before a process restart is reusable
    after it). Everything else — including a live, still-trainable FSM —
    keys by the policy object itself (identity hash, strong reference): a
    retrained FSM is a different object, and unlike ``id()`` the key cannot
    be reused by a new policy allocated at a garbage-collected one's
    address."""
    key = getattr(policy, "cache_key", None)
    if callable(key):
        return key()
    return policy


def _q_argmax(qs: dict[TypeId, float],
              valid: "Iterable[TypeId] | None" = None) -> TypeId | None:
    """The one tie-break used everywhere a Q-table picks a type: max Q value,
    ties toward the lexicographically largest ``repr``. ``FSMPolicy.next_type``
    and ``FSMPolicy.transitions`` both route through here so a serialized FSM
    replays exactly like the live policy."""
    cands = [(v, repr(t), t) for t, v in qs.items()
             if valid is None or t in valid]
    if not cands:
        return None
    return max(cands)[2]


class AgendaPolicy:
    """DyNet's agenda-based heuristic: pick the frontier type whose *remaining*
    nodes have minimal average topological depth (worked example, Fig. 1(c))."""

    def cache_key(self) -> Hashable:
        return "policy:agenda"            # stateless: all instances equivalent

    def next_type(self, state: GraphState) -> TypeId:
        def avg_depth(t: TypeId) -> float:
            return state.remaining_depth_sum[t] / state.remaining_count[t]

        return min(state.frontier_types(), key=lambda t: (avg_depth(t), repr(t)))


class SufficientConditionPolicy:
    """§5.3 heuristic: maximize the Lemma-1 readiness ratio (Eq. 1's second
    term); ties broken toward larger frontier batch then lexicographic."""

    def cache_key(self) -> Hashable:
        return "policy:sufficient"        # stateless: all instances equivalent

    def next_type(self, state: GraphState) -> TypeId:
        return max(
            state.frontier_types(),
            key=lambda t: (state.readiness_ratio(t), state.frontier_count[t]),
        )


class FSMPolicy:
    """A learned FSM: state-encoding + Q-table lookup, constant time per step.

    Falls back to the sufficient-condition heuristic on states never seen
    during training (rare once trained; keeps inference total).

    A policy trained by :func:`repro_torch.core.rl.train_fsm` carries the name of
    its state encoding, which makes it serializable: ``to_payload`` /
    ``from_payload`` round-trip the full Q-table (not just the transition
    function, so unseen-at-argmax frontier restrictions replay identically),
    and ``fingerprint`` is a stable content hash of that payload — the
    registry's on-disk identity and, once sealed, the schedule/plan cache
    key (see :func:`policy_cache_key`).
    """

    def __init__(self, q: dict[Hashable, dict[TypeId, float]], encoder,
                 encoding: str | None = None):
        self.q = q
        self.encoder = encoder
        self.encoding = encoding          # ENCODERS name; None = unserializable
        self._fallback = SufficientConditionPolicy()
        self._fingerprint: str | None = None   # set by seal()/from_payload

    def next_type(self, state: GraphState) -> TypeId:
        s = self.encoder(state)
        qs = self.q.get(s)
        if qs:
            t = _q_argmax(qs, set(state.frontier_types()))
            if t is not None:
                return t
        return self._fallback.next_type(state)

    def transitions(self) -> dict[Hashable, TypeId]:
        """The FSM itself: state -> chosen type (for inspection). Uses the
        same ``_q_argmax`` tie-break as ``next_type``."""
        out = {}
        for s, qs in self.q.items():
            t = _q_argmax(qs)
            if t is not None:
                out[s] = t
        return out

    # -- serialization (persistent policy registry) --------------------------

    def to_payload(self) -> dict:
        """JSON-serializable payload: version, encoding name, full Q-table.
        States/types are encoded by :func:`encode_state`; entries are sorted
        by their encoded form so the payload (and thus the fingerprint) is
        canonical regardless of dict insertion order."""
        if not self.encoding:
            raise ValueError(
                "policy has no encoding name; only FSMs trained via "
                "train_fsm (or built with encoding=...) can be serialized")
        q_enc = []
        for s, qs in self.q.items():
            row = sorted(([encode_state(t), float(v)] for t, v in qs.items()),
                         key=lambda e: json.dumps(e[0]))
            q_enc.append([encode_state(s), row])
        q_enc.sort(key=lambda e: json.dumps(e[0]))
        return {"version": PAYLOAD_VERSION, "encoding": self.encoding,
                "q": q_enc}

    @classmethod
    def from_payload(cls, payload: dict) -> "FSMPolicy":
        from .encodings import ENCODERS
        if payload.get("version") != PAYLOAD_VERSION:
            raise ValueError(f"unsupported FSM payload version "
                             f"{payload.get('version')!r}")
        name = payload["encoding"]
        if name not in ENCODERS:
            raise ValueError(f"unknown state encoding {name!r}")
        q: dict[Hashable, dict[TypeId, float]] = {}
        for s_enc, row in payload["q"]:
            q[decode_state(s_enc)] = {decode_state(t): float(v)
                                      for t, v in row}
        policy = cls(q, ENCODERS[name], name)
        policy._fingerprint = fingerprint_payload(payload)
        return policy

    def fingerprint(self) -> str:
        """Stable content hash of the serialized policy."""
        return fingerprint_payload(self.to_payload())

    def seal(self) -> str:
        """Freeze the policy for caching: compute and pin its fingerprint so
        ``policy_cache_key`` becomes content-based. Only call once training
        is finished — later Q-table mutations would not be reflected."""
        self._fingerprint = self.fingerprint()
        return self._fingerprint

    def cache_key(self) -> Hashable:
        return self._fingerprint if self._fingerprint is not None else self


# -- hashable-state codec (registry payloads) --------------------------------
#
# FSM states are the encoder outputs of core/encodings.py — nested tuples /
# frozensets of type ids — and type ids themselves are strings in every
# shipped workload. The codec is a small tagged-JSON scheme over exactly the
# hashables those encoders produce; frozensets are sorted by encoded form so
# encoding is deterministic.

def encode_state(x) -> list:
    if x is None:
        return ["n"]
    if isinstance(x, bool):               # before int: bool is an int subtype
        return ["b", x]
    if isinstance(x, str):
        return ["s", x]
    if isinstance(x, int):
        return ["i", x]
    if isinstance(x, float):
        return ["F", x]
    if isinstance(x, tuple):
        return ["t", [encode_state(v) for v in x]]
    if isinstance(x, frozenset):
        return ["f", sorted((encode_state(v) for v in x), key=json.dumps)]
    raise TypeError(f"cannot serialize FSM state component {x!r} "
                    f"({type(x).__name__})")


def decode_state(e: list):
    tag = e[0]
    if tag == "n":
        return None
    if tag in ("b", "s", "i", "F"):
        return e[1]
    if tag == "t":
        return tuple(decode_state(v) for v in e[1])
    if tag == "f":
        return frozenset(decode_state(v) for v in e[1])
    raise ValueError(f"bad state tag {tag!r}")


def fingerprint_payload(payload: dict) -> str:
    """Content fingerprint of a serialized policy: sha256 over the canonical
    JSON form of the policy-defining keys only (registry docs add metadata
    around the payload; metadata must not change the identity). Truncated to
    16 hex chars — 64 bits is plenty for a registry."""
    core = {k: payload[k] for k in ("version", "encoding", "q")}
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def depth_schedule(graph: Graph) -> Schedule:
    """TF-Fold depth-based batching: one batch per (topological depth, type).

    Not frontier-driven — depth groups are executed in depth order, which is
    always legal since every edge increases depth.
    """
    groups: dict[tuple[int, str], list[int]] = defaultdict(list)
    for node in graph.nodes:
        groups[(graph.depth[node.id], repr(node.type))].append(node.id)
    out: Schedule = []
    for (_, _), ids in sorted(groups.items()):
        out.append((graph.nodes[ids[0]].type, sorted(ids)))
    return out


def agenda_schedule(graph: Graph) -> Schedule:
    return schedule(graph, AgendaPolicy())


def num_batches(s: Schedule) -> int:
    return len(s)


def best_baseline_schedule(graph: Graph) -> Schedule:
    """What the paper reports for Vanilla/Cavs DyNet: the better of the
    agenda-based and depth-based algorithms per workload."""
    a, d = agenda_schedule(graph), depth_schedule(graph)
    return a if len(a) <= len(d) else d

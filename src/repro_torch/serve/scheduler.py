"""Continuous-batching scheduler: folds arrivals into in-flight waves.

The wave-as-graph formulation: each scheduler *round* builds one typed
dataflow graph per family containing

- a **prefill chain** per newly admitted lm request (``S -> (E, C)* -> O``,
  prompt left-padded into a power-of-two length bucket so the topology space
  stays small),
- a **decode fragment** per in-flight lm request (``R -> C -> O`` with an
  ``E`` feeding the cell), reading recurrent state from the slot pool, and
- the merged request graphs of every admitted single-shot (tree / lattice)
  request.

The batching policy (FSM / sufficient-condition / ...) then schedules that
graph exactly as Alg. 1 schedules an offline batch — late arrivals join
in-flight decode waves simply by appearing in the next round's graph.
Decode fragments are padded to a bucketed count with dummy fragments
(slot 0, token 0, writeback discarded) so long decode phases reuse one plan
per count bucket instead of compiling one per active-set size.

The bucketed engine path uses :func:`build_lm_feed_round_graph` instead:
token-level (iteration) scheduling where prefilling requests feed their
padded prompt through the same decode fragment one token per round, so
round topology depends only on the padded entry count and the whole lm
lifetime shares one or two bucketed executables (DESIGN.md deviation #4).

In ``continuous=False`` (wave) mode admission is gated on the engine being
idle: a wave is drained to completion before the next one is admitted —
the legacy ``serve/lm_wave.py`` discipline, kept as the baseline that
``benchmarks/bench_serve.py`` measures continuous batching against.

With ``n_shards > 1`` the scheduler is replica-aware: the slot pool splits
into per-shard pools, a prefilling lm request is pinned to a *home shard*
for its lifetime (recurrent state never crosses devices), and
``partition_singles`` balances single-shot graphs across shards by node
count. The engine pads every shard's round graph to the max count bucket
so all shards share one bucket signature per round (DESIGN.md §4).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.graph import Graph, Node
from repro_torch.core.plan import bucket_up

from .queue import AdmissionQueue, ServeRequest

SINGLE_SHOT_FAMILIES = ("tree", "lattice")

# Floor for the padded entry count of token-level lm round graphs. The
# engine's sharded path must pad every shard to the same rung, so it shares
# this constant with build_lm_feed_round_graph's default.
COUNT_BUCKET_MIN = 8


def bucket_len(n: int, min_bucket: int = 4,
               ladder: tuple[int, ...] | None = None) -> int:
    """Smallest bucket >= n (and >= min_bucket) on the shared plan ladder.

    Prompt-length bucketing and the bucketed plan compiler
    (``core.plan.bucket_up``) must agree on one ladder: the scheduler's
    buckets decide which round topologies exist, the plan layer's buckets
    decide which of those share an executable."""
    return max(min_bucket, bucket_up(n, ladder)) if n > 0 else min_bucket


@dataclass
class LMEntry:
    """One lm request's fragment in a round graph (dummy pads have req=None).

    ``shard`` is the request's *home shard*: assigned once at prefill time
    and pinned for the request's lifetime, so its recurrent slot state
    never crosses devices. Single-device serving uses shard 0 throughout.
    """

    req: ServeRequest | None
    slot: int
    shard: int = 0
    o_node: int = -1       # logits node (next-token argmax)
    cell_node: int = -1    # last cell (state written back to the slot)


@dataclass
class RoundPlan:
    """What one scheduler round executes, per family."""

    prefills: list[LMEntry] = field(default_factory=list)
    decodes: list[LMEntry] = field(default_factory=list)   # incl. dummy pads
    singles: dict[str, list[ServeRequest]] = field(default_factory=dict)
    admitted: list[ServeRequest] = field(default_factory=list)
    # admission-time validation rejects: (request, error detail)
    invalid: list[tuple[ServeRequest, str]] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.prefills or self.decodes or self.singles)


class ContinuousScheduler:
    """Slot accounting + admission discipline; graph building is below.

    With ``n_shards > 1`` the slot pool is partitioned into per-shard pools
    of ``max_slots // n_shards`` slots each. A prefilling request is
    assigned a home shard (the one with the most free slots, lowest index
    on ties) and keeps it until release — recurrent state stays device-
    local for the request's whole lifetime; only admission balances load.
    """

    def __init__(self, max_slots: int = 16, continuous: bool = True,
                 pad_decode: bool = True, prefill_bucket_min: int = 4,
                 n_shards: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if max_slots < n_shards:
            raise ValueError(
                f"max_slots={max_slots} < n_shards={n_shards}: every shard "
                f"needs at least one lm slot")
        self.max_slots = max_slots
        self.continuous = continuous
        self.pad_decode = pad_decode
        self.prefill_bucket_min = prefill_bucket_min
        self.n_shards = n_shards
        # Effective capacity is slots_per_shard * n_shards: rounds *down*
        # when max_slots does not divide (never above the configured cap).
        self.slots_per_shard = max_slots // n_shards
        self.active: list[ServeRequest] = []    # decoding next round
        self.slot_of: dict[int, tuple[int, int]] = {}   # rid -> (shard, slot)
        self._free = [deque(range(self.slots_per_shard))
                      for _ in range(n_shards)]
        self.waiting_lm: deque[ServeRequest] = deque()

    def has_work(self) -> bool:
        return bool(self.active or self.waiting_lm)

    def _has_free_slot(self) -> bool:
        return any(self._free)

    def _pick_shard(self) -> int:
        """Home shard for a fresh prefill: most free slots, lowest index on
        ties — keeps per-shard decode counts within one of each other."""
        return max(range(self.n_shards), key=lambda s: (len(self._free[s]), -s))

    def plan_round(self, queue: AdmissionQueue, now: float,
                   validate=None) -> RoundPlan:
        """Build this round's plan. ``validate(req) -> str | None`` is the
        engine's admission gate: a non-None return is an error detail, and
        the request lands in ``plan.invalid`` instead of taking a slot or
        joining a merged round graph (fault isolation at the cheapest
        possible boundary)."""
        plan = RoundPlan()
        # In-flight decodes first: every request admitted before this round
        # that still owes tokens decodes once this round.
        plan.decodes = [LMEntry(r, self.slot_of[r.rid][1],
                                self.slot_of[r.rid][0]) for r in self.active]

        # Admission: continuous mode folds arrivals into the running wave;
        # wave mode only admits into an idle engine (drain-then-refill).
        if self.continuous or not self.has_work():
            for req in queue.admit(now):
                detail = validate(req) if validate is not None else None
                if detail is not None:
                    plan.invalid.append((req, detail))
                    continue
                plan.admitted.append(req)
                if req.family == "lm":
                    self.waiting_lm.append(req)
                else:
                    plan.singles.setdefault(req.family, []).append(req)

        # Prefill as many waiting lm requests as there are free slots.
        while self.waiting_lm and self._has_free_slot():
            req = self.waiting_lm.popleft()
            shard = self._pick_shard()
            slot = self._free[shard].popleft()
            self.slot_of[req.rid] = (shard, slot)
            self.active.append(req)
            plan.prefills.append(LMEntry(req, slot, shard))

        # Pad the decode batch to a bucketed count: one cached plan per
        # count bucket instead of one per active-set size. (The bucketed
        # plan compiler additionally pads batch *widths*, so this graph-level
        # padding mainly keeps the per-topology pack cache small.)
        if self.pad_decode and plan.decodes:
            target = bucket_up(len(plan.decodes))
            plan.decodes.extend(
                LMEntry(None, 0) for _ in range(target - len(plan.decodes)))
        return plan

    # -- elastic resize / migration helpers (serve/resilience.py) ----------

    def shard_load(self) -> list[int]:
        """Active (slot-holding) request count per shard."""
        loads = [0] * self.n_shards
        for shard, _ in self.slot_of.values():
            loads[shard] += 1
        return loads

    def freest_shard(self) -> int | None:
        """Shard with the most free slots (lowest index ties); None when
        every pool is exhausted."""
        best = max(range(self.n_shards),
                   key=lambda s: (len(self._free[s]), -s))
        return best if self._free[best] else None

    def take_slot(self, shard: int) -> int | None:
        """Pop a free slot from ``shard``'s pool (None when exhausted)."""
        return self._free[shard].popleft() if self._free[shard] else None

    def assign(self, req: ServeRequest, shard: int, slot: int) -> None:
        """Pin ``req`` to (shard, slot) — the migration-path counterpart of
        the prefill-time assignment in ``plan_round``. The request must not
        currently hold a slot; it joins ``active`` if not already there."""
        assert req.rid not in self.slot_of, req.rid
        self.slot_of[req.rid] = (shard, slot)
        if not any(r.rid == req.rid for r in self.active):
            self.active.append(req)

    def resize(self, new_n_shards: int,
               mapping) -> list[tuple[ServeRequest, int, int]]:
        """Rebuild the per-shard slot pools for a new shard count.

        ``mapping(shard) -> int | None`` renumbers old shards to new ones
        (None = the shard is gone). Entries whose shard survives keep their
        slot number on the renumbered shard; entries on a dead shard are
        unpinned and returned as ``(req, old_shard, old_slot)`` for the
        caller (``resilience.resize_mesh``) to evacuate — the scheduler
        moves pinning tables, the caller moves slot state.

        ``slots_per_shard`` is intentionally held fixed across resizes so
        slot coordinates stay valid and bucket signatures (which see pool
        shapes) don't churn; total capacity scales with the shard count.
        """
        if new_n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {new_n_shards}")
        new_free = [deque(range(self.slots_per_shard))
                    for _ in range(new_n_shards)]
        new_slot_of: dict[int, tuple[int, int]] = {}
        displaced: list[tuple[ServeRequest, int, int]] = []
        by_rid = {r.rid: r for r in self.active}
        for rid, (shard, slot) in self.slot_of.items():
            s2 = mapping(shard)
            if s2 is None:
                displaced.append((by_rid[rid], shard, slot))
            else:
                new_slot_of[rid] = (s2, slot)
                new_free[s2].remove(slot)
        self.n_shards = new_n_shards
        self._free = new_free
        self.slot_of = new_slot_of
        self.max_slots = self.slots_per_shard * new_n_shards
        gone = {r.rid for r, _, _ in displaced}
        self.active = [r for r in self.active if r.rid not in gone]
        return displaced

    def release(self, req: ServeRequest) -> None:
        """Return a finished request's slot to its home shard's pool."""
        shard, slot = self.slot_of.pop(req.rid)
        self._free[shard].append(slot)
        self.active = [r for r in self.active if r.rid != req.rid]

    def evict(self, req: ServeRequest) -> None:
        """Forcibly remove a request from the scheduler, wherever it is:
        an in-flight decode loses its slot (reclaimed by its home shard),
        a queued lm request just leaves the waiting line. Idempotent, so
        failure paths can call it without tracking scheduler state."""
        if req.rid in self.slot_of:
            self.release(req)
        elif any(r.rid == req.rid for r in self.waiting_lm):
            self.waiting_lm = deque(
                r for r in self.waiting_lm if r.rid != req.rid)


# -- round-graph builders ----------------------------------------------------


def build_lm_round_graph(plan: RoundPlan, *, pad_token: int = 0,
                         prefill_bucket_min: int = 4) -> Graph | None:
    """One typed graph for this round's lm work; fills each entry's
    ``o_node`` / ``cell_node``. Prefill chains are emitted sorted by
    (bucket, rid) so rounds with the same bucket multiset share a topology."""
    if not (plan.prefills or plan.decodes):
        return None
    nodes: list[Node] = []

    def add(type_, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    def keyfn(e: LMEntry):
        return (bucket_len(len(e.req.prompt), prefill_bucket_min), e.req.rid)

    for e in sorted(plan.prefills, key=keyfn):
        L = bucket_len(len(e.req.prompt), prefill_bucket_min)
        toks = [pad_token] * (L - len(e.req.prompt)) + list(e.req.prompt)
        prev = add("S")
        for t in toks:
            emb = add("E", aux=t)
            prev = add("C", (prev, emb))
        e.cell_node = prev
        e.o_node = add("O", (prev,))

    for e in plan.decodes:
        last_tok = e.req.out[-1] if e.req is not None else pad_token
        r = add("R", aux=e.slot)
        emb = add("E", aux=last_tok)
        cell = add("C", (r, emb))
        e.cell_node = cell
        e.o_node = add("O", (cell,))
    return Graph(nodes)


def next_feed_token(req: ServeRequest, pad_token: int = 0) -> int:
    """The token a request feeds this round: the next (padded) prompt token
    while prefilling, else the argmax of its last logits."""
    feed = req.feed or []
    if req.n_fed < len(feed):
        return feed[req.n_fed]
    return req.out[-1] if req.out else pad_token


def build_lm_feed_round_graph(plan: RoundPlan, *, pad_token: int = 0,
                              count_bucket_min: int = COUNT_BUCKET_MIN,
                              count: int | None = None
                              ) -> tuple[Graph | None, list[LMEntry]]:
    """Token-level round graph (the bucketed engine's lm formulation).

    Every live request — freshly admitted or mid-decode — contributes the
    same ``R -> C -> O`` fragment; a prefilling request's ``E`` carries its
    next padded-prompt token instead of a generated one (iteration-level /
    Orca-style scheduling). Feeding the padded prompt through the decode
    cell one token per round computes bit-identical state to the merged
    prefill chain, because both run the same cell over the same padded
    token sequence from a zero state.

    The payoff is the executable-signature space: round topology depends on
    nothing but the padded entry count, so with the serve width ladder the
    whole lm lifetime — any prompt-length mix, any decode phase — runs
    through one or two bucketed executables. Entry count pads to
    ``count_bucket_min`` with dummy fragments (slot 0, token 0, writeback
    discarded), which also keeps the per-topology pack cache tiny.

    ``count`` overrides the padded entry count: the sharded engine passes
    the max bucket across shards so every shard's round graph — including
    idle shards, which get all-dummy graphs — shares one topology and
    therefore one bucket signature."""
    live = plan.prefills + plan.decodes
    if count is None:
        if not live:
            return None, []
        count = bucket_len(len(live), count_bucket_min)
    elif count < len(live):
        raise ValueError(f"count={count} < {len(live)} live entries")
    entries = live + [LMEntry(None, 0) for _ in range(count - len(live))]
    nodes: list[Node] = []

    def add(type_, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=type_, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    for e in entries:
        tok = (next_feed_token(e.req, pad_token) if e.req is not None
               else pad_token)
        r = add("R", aux=e.slot)
        emb = add("E", aux=tok)
        cell = add("C", (r, emb))
        e.cell_node = cell
        e.o_node = add("O", (cell,))
    return Graph(nodes), [e for e in entries if e.req is not None]


def partition_singles(reqs: list[ServeRequest],
                      n_shards: int) -> list[list[ServeRequest]]:
    """Balance single-shot request graphs across shards by node count
    (greedy longest-processing-time): biggest graph first onto the lightest
    shard, ties toward the lowest shard index. Deterministic for a given
    request list."""
    groups: list[list[ServeRequest]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    order = sorted(reqs, key=lambda r: (-len(r.graph), r.rid))
    for req in order:
        s = min(range(n_shards), key=lambda i: (loads[i], i))
        groups[s].append(req)
        loads[s] += len(req.graph)
    return groups


def _merge_graphs(graphs: list[Graph]) -> tuple[Graph, list[list[int]]]:
    """Id-offset merge of whole graphs into one wave graph; returns the
    merged graph and, per input graph, its output ("O") node ids. ``attrs``
    dicts are shared with the source nodes — single-shot attrs are never
    mutated after admission, so aliasing them is safe (and keeps dummy
    padding copies cheap)."""
    nodes: list[Node] = []
    out_ids: list[list[int]] = []
    for g in graphs:
        off = len(nodes)
        mine: list[int] = []
        for n in g.nodes:
            nodes.append(Node(id=n.id + off, type=n.type,
                              inputs=tuple(p + off for p in n.inputs),
                              op=n.op, attrs=n.attrs))
            if n.type == "O":
                mine.append(n.id + off)
        out_ids.append(mine)
    return Graph(nodes), out_ids


def merge_request_graphs(reqs: list[ServeRequest]) -> tuple[Graph, list[list[int]]]:
    """Fold single-shot request graphs into one wave graph (id-offset merge).
    Returns the merged graph and, per request, its output ("O") node ids."""
    return _merge_graphs([r.graph for r in reqs])


def align_single_shot_groups(groups: list[list[ServeRequest]]
                             ) -> list[tuple[Graph | None, list[list[int]]]]:
    """Pad every shard's single-shot merge toward one shared bucket
    signature (spec-aligned merging).

    When shard groups hold different topology mixes — or leave a shard
    idle — their merged wave graphs pack to different bucket specs, and
    the sharded executor degrades the round to per-shard dispatch. This
    rebuilds each shard's merge in a *canonical composition*: for every
    topology class seen this round (iterated in sorted topology-key
    order), each shard contributes its real requests of that class
    followed by dummy copies of a representative graph, up to the max
    per-shard count of the class. All K merged graphs then share one
    topology — hence one schedule, one pack, one bucket signature — and
    the round dispatches collectively; dummy outputs are computed but
    never read. Returned out_ids are in each group's original request
    order, so caller-side result extraction is unchanged."""
    keys: list[int] = []
    rep: dict[int, Graph] = {}
    counts: list[dict[int, int]] = []
    for grp in groups:
        c: dict[int, int] = {}
        for r in grp:
            k = r.graph.topology_key()
            if k not in rep:
                rep[k] = r.graph
                keys.append(k)
            c[k] = c.get(k, 0) + 1
        counts.append(c)
    keys.sort()
    target = {k: max(c.get(k, 0) for c in counts) for k in keys}
    built: list[tuple[Graph | None, list[list[int]]]] = []
    for grp, c in zip(groups, counts):
        by_key: dict[int, list[int]] = {k: [] for k in keys}
        for i, r in enumerate(grp):
            by_key[r.graph.topology_key()].append(i)
        graphs: list[Graph] = []
        owner: list[int | None] = []
        for k in keys:
            for i in by_key[k]:
                graphs.append(grp[i].graph)
                owner.append(i)
            for _ in range(target[k] - len(by_key[k])):
                graphs.append(rep[k])
                owner.append(None)
        graph, all_out = _merge_graphs(graphs)
        out_ids: list[list[int]] = [[] for _ in grp]
        for o, ids in zip(owner, all_out):
            if o is not None:
                out_ids[o] = ids
        built.append((graph, out_ids))
    return built

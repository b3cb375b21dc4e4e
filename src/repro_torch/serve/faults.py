"""Fault isolation + deterministic fault injection for the serve stack.

The serve engine used to be fail-stop: one malformed topology, one failed
bucket compile, or one exceeded round budget aborted the whole engine and
every in-flight slot with it. This module holds the machinery that turns
those into *request-level* or *round-level* events (DESIGN.md §5):

- **Error codes + request validation.** :func:`validate_request` is the
  admission-time topology check: node types must exist in the family's impl
  set, input arity must cover every impl slot, and every read field must be
  produced by the referenced predecessor. A request failing validation is
  marked ``FAILED`` with a structured error before it can poison a merged
  round graph.

- **Quarantine.** :class:`Quarantine` tracks bucket signatures whose
  compile or dispatch failed. A quarantined signature is retried after an
  exponential backoff (``backoff * 2**(fails-1)`` rounds); after
  ``max_retries`` consecutive failures it is quarantined permanently (until
  process restart). While quarantined, rounds that would use the signature
  run through the interpreted reference path instead.

- **Fault injection.** :class:`FaultInjector` deterministically arms
  compile failures (first-N compile attempts), executor exceptions (by
  engine round, never at the interpreted floor — so degraded retries
  succeed), and slow rounds (virtual-time penalties that trip deadlines).
  The engine/plan layers call its hooks only when an injector is installed;
  production serving pays a ``None`` check. :func:`poison_requests` builds
  structurally valid but semantically malformed request graphs, and
  :func:`corrupt_registry` plants a truncated policy payload — together the
  standard fault mix driven by ``benchmarks/bench_faults.py``.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np

from repro_torch.core.graph import Graph, Node

from .queue import ServeRequest, graph_request

# Structured error codes carried in ``ServeRequest.error["code"]``.
BAD_TOPOLOGY = "BAD_TOPOLOGY"              # failed admission-time validation
PLAN_ERROR = "PLAN_ERROR"                  # scheduling / lowering failed
EXEC_ERROR = "EXEC_ERROR"                  # execution failed even isolated
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"    # virtual deadline passed
QUEUE_FULL = "QUEUE_FULL"                  # admission queue shed the request
ROUND_BUDGET_EXCEEDED = "ROUND_BUDGET_EXCEEDED"  # engine drained at max_rounds
SHARD_LOST = "SHARD_LOST"                  # replica died; evacuation impossible


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` hooks; indistinguishable from a real
    failure to the containment machinery (that is the point)."""


class InjectedCrash(RuntimeError):
    """A fault-injected *process* crash: unlike :class:`InjectedFault` this
    deliberately escapes every containment boundary — the engine writes a
    crash checkpoint (when a checkpoint dir is configured) and lets it
    propagate out of ``run()``, modeling the process dying mid-trace. The
    chaos harness catches it and restores from the checkpoint."""


def make_error(code: str, detail: str, round_: int) -> dict:
    """The structured error payload attached to failed/timed-out/rejected
    requests: JSON-serializable, stable keys."""
    return {"code": code, "detail": detail, "round": int(round_)}


# -- admission-time topology validation --------------------------------------


def validate_request(req: ServeRequest, impls: dict) -> str | None:
    """Validate one request against its family's impl set; returns an error
    detail string, or ``None`` when the request is servable.

    Checks what the executors would otherwise die on mid-round: unknown node
    types, input arity below an impl's highest read slot, and reads of a
    field the referenced predecessor does not produce. Structural DAG
    invariants (dense ids, topological inputs) are enforced by ``Graph``
    itself at construction and need no re-check here.
    """
    if req.family == "lm":
        if not req.prompt:
            return "lm request has an empty prompt"
        for t in req.prompt:
            if not isinstance(t, (int, np.integer)) or t < 0:
                return f"lm prompt token {t!r} is not a non-negative int"
        if req.max_new < 1:
            return f"lm max_new must be >= 1, got {req.max_new}"
        return None
    g = req.graph
    if g is None or len(g) == 0:
        return "empty request graph"
    for n in g.nodes:
        impl = impls.get(n.type)
        if impl is None:
            return (f"node {n.id} has unknown type {n.type!r} for family "
                    f"{req.family!r} (known: {sorted(map(repr, impls))})")
        if impl.in_slots:
            need = 1 + max(slot for slot, _ in impl.in_slots)
            if len(n.inputs) < need:
                return (f"node {n.id} ({n.type!r}) has {len(n.inputs)} "
                        f"inputs but its impl reads slot {need - 1}")
            for slot, fld in impl.in_slots:
                pred = g.nodes[n.inputs[slot]]
                pimpl = impls.get(pred.type)
                if pimpl is None or fld not in pimpl.out_fields:
                    return (f"node {n.id} ({n.type!r}) slot {slot} reads "
                            f"field {fld!r} from node {pred.id} "
                            f"({pred.type!r}), which does not produce it")
    return None


# -- quarantine ---------------------------------------------------------------


class Quarantine:
    """Capped-retry quarantine for failing bucket signatures.

    ``record_failure`` books a signature out for ``backoff * 2**(fails-1)``
    rounds; ``blocks`` answers whether a round should bypass it (and run
    interpreted instead). More than ``max_retries`` consecutive failures
    quarantine the signature permanently; any successful run clears it.

    ``on_event`` (optional) is called after every booking with
    ``(key, fails, until, error_repr)`` — the engine hangs its stats
    counter, metrics, tracer event, and flight-recorder dump off it, so
    quarantine accounting lives in exactly one place.

    Entries are keyed internally by the key's *signature digest* (the same
    ``sig_digest`` the engine stamps into quarantine tracer events), which
    makes the table serializable: keys are tuples of family names, bucket
    specs, and topology fingerprints whose reprs are deterministic across
    processes, so a digest booked before a checkpoint still blocks the
    same signature after a restore. Backoff deadlines are *round numbers*
    on the virtual clock, so they survive serialization unchanged
    (DESIGN.md §7).
    """

    def __init__(self, backoff: int = 4, max_retries: int = 2,
                 on_event: Any = None):
        if backoff < 1:
            raise ValueError(f"backoff must be >= 1, got {backoff}")
        self.backoff = backoff
        self.max_retries = max_retries
        self.on_event = on_event
        self._entries: dict[str, dict] = {}   # digest -> booking
        self.events = 0          # total failures recorded

    @staticmethod
    def _dig(key: Any) -> str:
        from repro_torch.core.plan import sig_digest
        return sig_digest(key)

    def __len__(self) -> int:
        return len(self._entries)

    def blocks(self, key: Any, round_: int) -> bool:
        e = self._entries.get(self._dig(key))
        return e is not None and round_ < e["until"]

    def record_failure(self, key: Any, round_: int, exc: BaseException) -> None:
        e = self._entries.setdefault(self._dig(key),
                                     {"fails": 0, "until": 0, "error": "",
                                      "key": repr(key)})
        e["fails"] += 1
        e["error"] = repr(exc)
        if e["fails"] > self.max_retries:
            e["until"] = float("inf")
        else:
            e["until"] = round_ + self.backoff * (2 ** (e["fails"] - 1))
        self.events += 1
        if self.on_event is not None:
            self.on_event(key, e["fails"], e["until"], repr(exc))

    def clear(self, key: Any) -> None:
        self._entries.pop(self._dig(key), None)

    def permanent(self) -> int:
        """How many signatures are quarantined for good."""
        return sum(1 for e in self._entries.values()
                   if e["until"] == float("inf"))

    # serialization (serve/checkpoint.py) -------------------------------------

    def state(self) -> dict:
        """JSON-serializable snapshot. ``until = null`` encodes the
        permanent (infinite) quarantine, which JSON cannot carry as a
        float."""
        return {"backoff": self.backoff, "max_retries": self.max_retries,
                "events": self.events,
                "entries": [
                    {"digest": d, "fails": e["fails"],
                     "until": (None if e["until"] == float("inf")
                               else e["until"]),
                     "error": e["error"], "key": e.get("key", "")}
                    for d, e in sorted(self._entries.items())]}

    def load_state(self, st: dict) -> None:
        """Restore a ``state()`` snapshot (booking table + event counter;
        the backoff/max_retries config stays this instance's own)."""
        self.events = int(st.get("events", 0))
        self._entries = {
            x["digest"]: {"fails": int(x["fails"]),
                          "until": (float("inf") if x["until"] is None
                                    else x["until"]),
                          "error": x.get("error", ""),
                          "key": x.get("key", "")}
            for x in st.get("entries", [])}


# -- deterministic fault injection -------------------------------------------


class FaultInjector:
    """Deterministic fault source, consulted by engine/plan hooks.

    - ``compile_fail``: fail the first N executable compiles (any bucket
      signature / params kind), modeling a flaky or resource-starved
      compiler. Retries past N succeed, so quarantine backoff can recover.
    - ``compile_hang``: ``(N, seconds)`` — the first N compile attempts
      sleep for ``seconds`` of wall time before proceeding, modeling a hung
      XLA build. On the synchronous path this stalls the serve loop (the
      failure mode the async compile service exists to remove); on the
      async path the sleep lands on a background worker and the service's
      per-job timeout abandons it.
    - ``compile_slow``: like ``compile_hang`` but intended to stay *under*
      the service timeout — a slow-but-successful build.
    - ``exec_fail_rounds``: engine rounds whose first non-interpreted
      dispatch raises (once per listed round). The interpreted floor is
      never injected, so the degradation ladder always has a way out —
      which is exactly the recovery property under test.
    - ``commit_fail_rounds``: engine rounds whose *commit* (the lazy
      ``block_until_ready`` on an in-flight dispatch) raises, once per
      listed round. Fires after the dispatch already succeeded — i.e.
      while a pipelined engine may hold a speculatively packed round t+1 —
      which is exactly the cancellation path under test. The serial
      engine fires it at the equivalent point (after dispatch, before
      scatter) so both paths see the same fault.
    - ``slow_rounds``: per-round virtual-time penalties (round -> extra
      virtual ms), applied before the engine's deadline check so deadline
      enforcement can be exercised deterministically.
    - ``poison``: how many malformed requests the trace builder should mix
      in (consumed by the launcher/benchmark, not by engine hooks).
    - ``crash_rounds``: rounds at which the engine raises
      :class:`InjectedCrash` *before* any round work — modeling the process
      dying at a round boundary. The engine writes a crash checkpoint
      first (when configured), so the chaos harness can restore and prove
      output equivalence.
    - ``shard_lost``: ``{round: shard}`` replica failures — the engine
      evacuates the shard's slot-pinned lm entries and resizes the mesh to
      K-1 at that round boundary (DESIGN.md §7).
    - ``shard_back_rounds``: rounds at which a lost replica recovers — the
      engine re-grows the mesh one shard (capped at the original K).
    """

    def __init__(self, compile_fail: int = 0, exec_fail_rounds=(),
                 slow_rounds: dict[int, float] | None = None,
                 poison: int = 0, crash_rounds=(),
                 shard_lost: dict[int, int] | None = None,
                 shard_back_rounds=(),
                 compile_hang: tuple[int, float] | None = None,
                 compile_slow: tuple[int, float] | None = None,
                 commit_fail_rounds=()):
        self.compile_fail = int(compile_fail)
        self.compile_hang = ((int(compile_hang[0]), float(compile_hang[1]))
                             if compile_hang else (0, 0.0))
        self.compile_slow = ((int(compile_slow[0]), float(compile_slow[1]))
                             if compile_slow else (0, 0.0))
        self.fired_hang = 0
        self.fired_slow = 0
        self.exec_fail_rounds = frozenset(int(r) for r in exec_fail_rounds)
        self.commit_fail_rounds = frozenset(int(r)
                                            for r in commit_fail_rounds)
        self.slow_rounds = {int(k): float(v)
                            for k, v in (slow_rounds or {}).items()}
        self.poison = int(poison)
        self.crash_rounds = frozenset(int(r) for r in crash_rounds)
        self.shard_lost = {int(k): int(v)
                           for k, v in (shard_lost or {}).items()}
        self.shard_back_rounds = frozenset(int(r)
                                           for r in shard_back_rounds)
        self.fired_compile = 0
        self.fired_exec = 0
        self.fired_commit = 0
        self.fired_crash = 0
        self._exec_armed = set(self.exec_fail_rounds)
        self._commit_armed = set(self.commit_fail_rounds)
        self._crash_armed = set(self.crash_rounds)
        self._shard_armed = dict(self.shard_lost)
        self._back_armed = set(self.shard_back_rounds)

    # hooks ------------------------------------------------------------------

    def on_compile(self, key: Any, ctx: dict | None = None) -> None:
        """Called by the plan executors on an executable-cache miss, before
        the XLA compile runs. ``ctx`` (when the executor passes it) carries
        job context — kind, signature digest, ``bg=True`` when the build
        runs on a background compile worker, and ``abort`` (a callable)
        when the attempt can be abandoned: injected sleeps poll it so a
        timed-out worker thread exits promptly instead of riding out the
        full hang as a leaked daemon."""
        abort = (ctx or {}).get("abort")
        n_hang, hang_s = self.compile_hang
        if self.fired_hang < n_hang:
            self.fired_hang += 1
            self._sleep(hang_s, abort)
        else:
            n_slow, slow_s = self.compile_slow
            if self.fired_slow < n_slow:
                self.fired_slow += 1
                self._sleep(slow_s, abort)
        if self.fired_compile < self.compile_fail:
            self.fired_compile += 1
            raise InjectedFault(
                f"injected compile failure #{self.fired_compile}")

    @staticmethod
    def _sleep(seconds: float, abort=None) -> None:
        if abort is None:
            time.sleep(seconds)
            return
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline and not abort():
            time.sleep(min(0.02, seconds))

    def on_exec(self, round_: int, tier: str) -> None:
        """Called by the engine before a round dispatch at ``tier``."""
        if tier == "interpreted":
            return
        if round_ in self._exec_armed:
            self._exec_armed.discard(round_)
            self.fired_exec += 1
            raise InjectedFault(
                f"injected executor failure at round {round_} ({tier})")

    def on_commit(self, round_: int) -> None:
        """Called by the engine at round commit (after dispatch succeeded,
        before results are consumed), once per armed round."""
        if round_ in self._commit_armed:
            self._commit_armed.discard(round_)
            self.fired_commit += 1
            raise InjectedFault(
                f"injected commit failure at round {round_}")

    def round_delay(self, round_: int) -> float:
        return self.slow_rounds.get(round_, 0.0)

    def crash_due(self, round_: int) -> bool:
        """One-shot crash check at a round boundary (armed per round, so a
        restored engine resuming at the same round re-crashes only if its
        own injector arms it again)."""
        if round_ in self._crash_armed:
            self._crash_armed.discard(round_)
            self.fired_crash += 1
            return True
        return False

    def shard_events(self, round_: int):
        """Replica-elasticity events due at ``round_``, one-shot:
        ``("lost", shard)`` then ``("back", None)`` entries."""
        out = []
        if round_ in self._shard_armed:
            out.append(("lost", self._shard_armed.pop(round_)))
        if round_ in self._back_armed:
            self._back_armed.discard(round_)
            out.append(("back", None))
        return out

    # spec parsing -----------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse a ``--inject-faults`` spec string.

        Comma-separated ``key=value`` pairs; list values are colon-separated,
        slow-round entries are ``round*delay`` pairs, shard-loss entries are
        ``round*shard`` pairs::

            compile_fail=2,exec_rounds=3:7,slow=5*4.0:9*2.0,poison=2
            crash=8,shard_lost=5*1,shard_back=12,commit=4
            compile_hang=1*10.0,compile_slow=2*0.5

        ``compile_hang``/``compile_slow`` take a single ``N*seconds`` pair:
        the first N compile attempts sleep for that many wall seconds.
        """
        kw: dict[str, Any] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad fault spec entry {part!r} "
                                 f"(expected key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k == "compile_fail":
                kw["compile_fail"] = int(v)
            elif k in ("compile_hang", "compile_slow"):
                if "*" in v:
                    n, s = v.split("*")
                else:
                    n, s = "1", v
                kw[k] = (int(n), float(s))
            elif k == "exec_rounds":
                kw["exec_fail_rounds"] = [int(x) for x in v.split(":") if x]
            elif k == "commit":
                kw["commit_fail_rounds"] = [int(x) for x in v.split(":") if x]
            elif k == "slow":
                slow = {}
                for entry in v.split(":"):
                    if not entry:
                        continue
                    r, d = entry.split("*")
                    slow[int(r)] = float(d)
                kw["slow_rounds"] = slow
            elif k == "poison":
                kw["poison"] = int(v)
            elif k == "crash":
                kw["crash_rounds"] = [int(x) for x in v.split(":") if x]
            elif k == "shard_lost":
                lost = {}
                for entry in v.split(":"):
                    if not entry:
                        continue
                    r, s = entry.split("*")
                    lost[int(r)] = int(s)
                kw["shard_lost"] = lost
            elif k == "shard_back":
                kw["shard_back_rounds"] = [int(x) for x in v.split(":") if x]
            else:
                raise ValueError(
                    f"unknown fault spec key {k!r} (known: compile_fail, "
                    f"compile_hang, compile_slow, exec_rounds, commit, "
                    f"slow, poison, crash, shard_lost, shard_back)")
        return cls(**kw)


# -- malformed-request generators ---------------------------------------------

POISON_KINDS = ("unknown-type", "missing-input", "bad-field")


def poison_requests(n: int, family: str = "tree", arrival: float = 0.0,
                    kinds=POISON_KINDS) -> list[ServeRequest]:
    """``n`` structurally valid but semantically malformed request graphs.

    Each passes ``Graph``'s DAG checks (so it can be *submitted*) but fails
    admission validation — or, if validation were bypassed, would crash the
    executor mid-round: an unknown node type, a cell missing an input slot,
    or a read of a field its predecessor does not produce.
    """
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        if kind == "unknown-type":
            nodes = [Node(id=0, type="E", attrs={"aux": 1}),
                     Node(id=1, type="?bogus?", inputs=(0,)),
                     Node(id=2, type="O", inputs=(1,))]
        elif kind == "missing-input":
            # "I" (tree internal cell) reads two child slots; give it one.
            nodes = [Node(id=0, type="E", attrs={"aux": 1}),
                     Node(id=1, type="L", inputs=(0,)),
                     Node(id=2, type="I", inputs=(1,)),
                     Node(id=3, type="O", inputs=(2,))]
        else:  # bad-field: "O" reads field "h", but "E" produces "x" only
            nodes = [Node(id=0, type="E", attrs={"aux": 1}),
                     Node(id=1, type="O", inputs=(0,))]
        out.append(graph_request(family, Graph(nodes), arrival))
    return out


def corrupt_registry(root: str, family: str,
                     name: str = "0badc0de") -> str:
    """Plant a truncated JSON payload in a policy registry family dir; the
    hardened loader must skip it with a warning instead of raising."""
    d = os.path.join(root, family)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        f.write('{"version": 1, "family": "' + family + '", "q": [[')
    return path

"""Tabular Q-learning of the batching FSM (ED-Batch §2.3).

The agent schedules training graphs episode by episode. Per step the reward
is Eq. 1:  r = -1 + alpha * readiness_ratio(type)  — the -1 charges each
batch, the ratio term (Lemma 1) pulls toward types whose whole type-subgraph
frontier is ready. N-step bootstrapped Q updates propagate a decision's
effect to earlier states. Training stops early once the greedy policy hits
the App. A.3 lower bound (checked every ``check_every`` iterations), matching
the paper's protocol (Table 3: tens to ~1000 trials, sub-minute).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Hashable, Sequence

from .batching import FSMPolicy, Schedule, schedule
from .encodings import ENCODERS, Encoder
from .graph import Graph, GraphState, TypeId


@dataclass
class RLConfig:
    alpha: float = 0.5          # Eq. 1 ratio weight
    lr: float = 0.2             # Q-table step size
    gamma: float = 1.0          # undiscounted: total batch count is the objective
    nstep: int = 4              # N-step bootstrapping horizon
    epsilon0: float = 0.5       # initial exploration
    epsilon_decay: float = 0.995
    epsilon_min: float = 0.02
    max_iters: int = 1000
    check_every: int = 50
    seed: int = 0
    encoding: str = "sort"


@dataclass
class RLResult:
    policy: FSMPolicy            # the final policy (greedy over the Q-table)
    iters: int
    train_time_s: float
    best_batches: int            # best greedy batch count seen at any check
    final_batches: int           # greedy batch count of the returned policy
    lower_bound: int
    reached_lower_bound: bool    # best_batches <= lower_bound
    history: list[int] = field(default_factory=list)


def _greedy_batches(graphs: Sequence[Graph], policy: FSMPolicy) -> int:
    return sum(len(schedule(g, policy)) for g in graphs)


def train_fsm(graphs: Sequence[Graph], config: RLConfig | None = None) -> RLResult:
    """Learn a batching FSM for the topology family of ``graphs``."""
    cfg = config or RLConfig()
    enc: Encoder = ENCODERS[cfg.encoding]
    rng = random.Random(cfg.seed)
    q: dict[Hashable, dict[TypeId, float]] = {}
    policy = FSMPolicy(q, enc, encoding=cfg.encoding)
    lb = sum(g.batch_lower_bound() for g in graphs)
    eps = cfg.epsilon0
    best = _greedy_batches(graphs, policy)
    history: list[int] = []
    t0 = time.perf_counter()
    iters_run = 0

    for it in range(1, cfg.max_iters + 1):
        iters_run = it
        g = graphs[rng.randrange(len(graphs))]
        state = GraphState(g)
        # Episode rollout with epsilon-greedy action selection.
        traj: list[tuple[Hashable, TypeId, float]] = []
        while not state.done():
            s = enc(state)
            valid = state.frontier_types()
            qs = q.setdefault(s, {})
            for t in valid:
                qs.setdefault(t, 0.0)
            if rng.random() < eps:
                a = valid[rng.randrange(len(valid))]
            else:
                a = max(valid, key=lambda t: (qs[t], repr(t)))
            r = -1.0 + cfg.alpha * state.readiness_ratio(a)
            state.execute_type(a)
            traj.append((s, a, r))
        # N-step backward updates (terminal value 0).
        n = cfg.nstep
        T = len(traj)
        for i in range(T - 1, -1, -1):
            ret = 0.0
            for k in range(i, min(i + n, T)):
                ret += (cfg.gamma ** (k - i)) * traj[k][2]
            j = i + n
            if j < T:
                s_boot = traj[j][0]
                boot = max(q[s_boot].values(), default=0.0)
                ret += (cfg.gamma ** n) * boot
            s, a, _ = traj[i]
            q[s][a] += cfg.lr * (ret - q[s][a])
        eps = max(cfg.epsilon_min, eps * cfg.epsilon_decay)

        if it % cfg.check_every == 0:
            cur = _greedy_batches(graphs, policy)
            history.append(cur)
            best = min(best, cur)
            if cur <= lb:
                break

    final = _greedy_batches(graphs, policy)
    best = min(best, final)
    # ``best`` is the min over every greedy evaluation (initial, periodic
    # checks, final); a policy that regressed after its best checkpoint must
    # not report the regressed count as "best", nor derive the lower-bound
    # flag from it. ``final_batches`` is what the *returned* policy scores.
    return RLResult(
        policy=policy,
        iters=iters_run,
        train_time_s=time.perf_counter() - t0,
        best_batches=best,
        final_batches=final,
        lower_bound=lb,
        reached_lower_bound=best <= lb,
        history=history,
    )

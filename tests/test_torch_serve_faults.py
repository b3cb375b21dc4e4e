"""Fault-isolated serving on the port (``repro_torch.serve``) against the
reference (``repro.serve``) on the CPU, mirroring ``tests/test_faults.py``:
admission-time validation of poisoned requests, a compile failure injected
through the executors' ``compile_hook`` (on the card the hook also guards
the CUDA-graph capture, which fails the same way) that quarantines its
bucket signature and serves the round on the interpreted floor until the
backoff ends, executor and commit faults contained at round level,
deadlines keeping partial tokens, the bounded queue's structured
rejections and the graceful round-budget drain. Under the same injected
faults both engines must end every request in the same status with the
same tokens (tree and lattice outputs within 1e-4) and book the same
containment."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.core.cache import FIFOCache as JFIFOCache  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core.cache import FIFOCache  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve.queue import (COMPLETED, FAILED, REJECTED,  # noqa: E402
                                     TIMED_OUT)

MODEL_SIZE = 8


def _workloads(make, **kw):
    return {"lm": make("ChainLM", MODEL_SIZE, **kw),
            "tree": make("TreeLSTM", MODEL_SIZE, **kw),
            "lattice": make("LatticeLSTM", MODEL_SIZE, **kw)}


@pytest.fixture(scope="module")
def stacks():
    """Per package: serve module, faults module, workloads, the host caches
    shared by the module's engines (bucket caches stay per engine, so each
    injected compile failure meets a cache miss) and engine arguments."""
    return {
        "jax": (jserve, jfaults, _workloads(jmake_workload),
                dict(plan_cache=JFIFOCache(256),
                     schedule_cache=JFIFOCache(512)), {}),
        "torch": (serve, faults, _workloads(make_workload, device="cpu"),
                  dict(plan_cache=FIFOCache(256),
                       schedule_cache=FIFOCache(512)), {"device": "cpu"}),
    }


def _mixed_trace(mod, wls, seed=0):
    """Two lm requests, a tree and a lattice (``tests/test_faults.py``)."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    return [mod.lm_request(list(map(int, nrng.integers(0, 256, 4))), 3,
                           arrival=0.0),
            mod.lm_request(list(map(int, nrng.integers(0, 256, 5))), 3,
                           arrival=1.0),
            mod.graph_request("tree", wls["tree"].sample_graph(
                rng, 1, leaves_lo=3, leaves_hi=5), arrival=0.0),
            mod.graph_request("lattice", wls["lattice"].sample_graph(
                rng, 1, lo=4, hi=6), arrival=1.0)]


def _serve(stack, make_reqs, injector=None, **kw):
    """Serve the requests ``make_reqs(serve module, faults module,
    workloads)`` builds, with the injector ``injector(faults module)``
    builds; returns the engine, the requests, the rejected and the stats."""
    mod, fmod, wls, caches, extra = stack
    reqs = make_reqs(mod, fmod, wls)
    if injector is not None:
        kw["fault_injector"] = injector(fmod)
    eng = mod.ServeEngine(dict(wls), max_slots=4, **caches, **extra, **kw)
    rejected = eng.submit_many(reqs)
    return eng, reqs, rejected, eng.run()


def _both(stacks, make_reqs, injector=None, **kw):
    return (_serve(stacks["jax"], make_reqs, injector, **kw),
            _serve(stacks["torch"], make_reqs, injector, **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.family, a.status) == (b.family, b.status)
        assert (a.error or {}).get("code") == (b.error or {}).get("code")
        if a.family == "lm":
            assert a.out == b.out
        elif a.status == COMPLETED:
            np.testing.assert_allclose(a.result, np.asarray(b.result),
                                       rtol=0, atol=1e-4)


def _assert_same_containment(stats, jstats):
    for f in ("n_rounds", "tier_rounds", "n_contained_errors",
              "n_quarantine_events", "requests_done", "requests_failed",
              "requests_timed_out", "requests_rejected", "n_spec_cancelled"):
        assert getattr(stats, f) == getattr(jstats, f), f


def test_poisoned_requests_fail_healthy_complete(stacks):
    def reqs(mod, fmod, wls):
        return _mixed_trace(mod, wls) + fmod.poison_requests(3, arrival=0.0)

    (_, jreqs, _, jstats), (_, got, _, stats) = _both(stacks, reqs)
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    for r in got[-3:]:
        assert r.status == FAILED and r.error["code"] == faults.BAD_TOPOLOGY
    assert all(r.status == COMPLETED for r in got[:-3])
    assert stats.requests_failed == 3 and stats.n_contained_errors == 0


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined",
                                                         "serial"])
def test_compile_failure_quarantines_then_recovers(stacks, pipeline):
    """The first build fails in the compile hook: its signature is booked
    out, the round runs on the interpreted floor, and after the backoff
    the bucketed tier serves again."""
    def reqs(mod, fmod, wls):
        return _mixed_trace(mod, wls)

    def inj(fmod):
        return fmod.FaultInjector(compile_fail=1)

    (jeng, jreqs, _, jstats), (eng, got, _, stats) = _both(
        stacks, reqs, inj, pipeline=pipeline)
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    assert all(r.status == COMPLETED for r in got)
    assert stats.n_quarantine_events >= 1 and stats.n_contained_errors >= 1
    assert stats.tier_rounds.get("interpreted", 0) >= 1
    assert stats.tier_rounds.get("bucketed", 0) >= 1
    assert eng.quarantine.permanent() == jeng.quarantine.permanent() == 0


@pytest.mark.parametrize("kind", ["exec", "commit"])
def test_round_faults_are_contained(stacks, kind):
    """An executor failure (rounds 0 and 1) or a commit failure (round 2,
    while a speculative round 3 may be packed) is contained at round
    level: every request completes with the tokens of a clean run."""
    def reqs(mod, fmod, wls):
        return _mixed_trace(mod, wls)

    def inj(fmod):
        if kind == "exec":
            return fmod.FaultInjector(exec_fail_rounds=(0, 1))
        return fmod.FaultInjector(commit_fail_rounds=(2,))

    (_, jreqs, _, jstats), (_, got, _, stats) = _both(stacks, reqs, inj)
    _, clean, _, _ = _serve(stacks["torch"], reqs)
    _assert_same(got, jreqs)
    _assert_same(got, clean)
    _assert_same_containment(stats, jstats)
    assert all(r.status == COMPLETED for r in got)
    assert stats.n_contained_errors >= 1


def test_exec_poison_isolated_without_validation(stacks):
    """With the admission gate off, a request that crashes even the
    interpreted floor fails alone; its round-mate completes."""
    out = []
    for name in ("jax", "torch"):
        mod, fmod, wls, caches, extra = stacks[name]
        healthy = mod.graph_request("tree", wls["tree"].sample_graph(
            random.Random(0), 1, leaves_lo=3, leaves_hi=5), arrival=0.0)
        bad = fmod.poison_requests(3, arrival=0.0)[2]   # bad-field kind
        eng = mod.ServeEngine(dict(wls), max_slots=4, **caches, **extra)
        eng._validate = lambda req: None
        eng.submit_many([healthy, bad])
        out.append(([healthy, bad], eng.run()))
    (jreqs, jstats), (got, stats) = out
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    assert got[0].status == COMPLETED and got[1].status == FAILED
    assert got[1].error["code"] == faults.EXEC_ERROR


def test_deadline_timeout_keeps_partial_tokens(stacks):
    def reqs(mod, fmod, wls):
        return [mod.lm_request([5, 6, 7], 10, arrival=0.0, deadline=30.0),
                mod.lm_request([5, 6, 7], 4, arrival=0.0)]

    def inj(fmod):
        return fmod.FaultInjector(slow_rounds={6: 100.0})

    (_, jreqs, _, jstats), (_, got, _, stats) = _both(stacks, reqs, inj)
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    slo, free = got
    assert free.status == COMPLETED and len(free.out) == 4
    assert slo.status == TIMED_OUT
    assert slo.error["code"] == faults.DEADLINE_EXCEEDED
    assert 0 < len(slo.out) < slo.max_new


def test_bounded_queue_sheds_with_structured_rejection(stacks):
    def reqs(mod, fmod, wls):
        return _mixed_trace(mod, wls)

    (_, jreqs, jrej, jstats), (_, got, rejected, stats) = _both(
        stacks, reqs, queue_cap=2)
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    assert len(rejected) == len(jrej) == len(got) - 2
    for r in rejected:
        assert r.status == REJECTED and r.error["code"] == faults.QUEUE_FULL


def test_round_budget_drains_gracefully(stacks):
    def reqs(mod, fmod, wls):
        return [mod.lm_request([1, 2, 3], 50, arrival=0.0),
                mod.lm_request([4, 5], 50, arrival=0.0)]

    (_, jreqs, _, jstats), (_, got, _, stats) = _both(stacks, reqs,
                                                      max_rounds=3)
    _assert_same(got, jreqs)
    _assert_same_containment(stats, jstats)
    for r in got:
        assert r.status == FAILED
        assert r.error["code"] == faults.ROUND_BUDGET_EXCEEDED
        assert "max_rounds=3" in r.error["detail"]

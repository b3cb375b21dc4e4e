"""The port's durable serving (``repro_torch.serve.resilience``) and the
launcher's cache directory (``repro_torch.launch.cache``) on the CPU,
mirroring the single-shard tests of ``tests/test_resilience.py``:
admission dedupe across restore, quarantine bookings surviving a round
trip, kill and restore equal to an uninterrupted run, the restore-mismatch
post-mortem, and the cache-directory audit. The checkpoint document is the
reference's, so a checkpoint written by either package at an injected
crash is restored by the other, which finishes with the writer's
uninterrupted outputs (lm tokens equal, tree and lattice outputs within
1e-4). A restore copies the slot pool into the engine's own tensors."""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve.faults import FaultInjector as JFaultInjector  # noqa: E402
from repro_torch.launch.cache import (QUARANTINE_SUBDIR,  # noqa: E402
                                      audit_cache_dir)
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch.obs import FlightRecorder, MetricsRegistry, Obs, Tracer  # noqa: E402
from repro_torch.serve import (InjectedCrash, ServeEngine,  # noqa: E402
                               latest_checkpoint, lm_request, reserve_rids,
                               synth_trace)
from repro_torch.serve.checkpoint import CheckpointError  # noqa: E402
from repro_torch.serve.faults import FaultInjector, Quarantine  # noqa: E402
from repro_torch.serve.queue import COMPLETED, AdmissionQueue  # noqa: E402
from repro_torch.serve.resilience import (restore_engine,  # noqa: E402
                                          snapshot_engine)

MODEL_SIZE = 8
FAMILIES = ["lm", "tree", "lattice"]
SIZES = dict(tree_leaves=(3, 5), lattice_chars=(4, 6))


def _workloads(make, **kw):
    return {"lm": make("ChainLM", MODEL_SIZE, **kw),
            "tree": make("TreeLSTM", MODEL_SIZE, **kw),
            "lattice": make("LatticeLSTM", MODEL_SIZE, **kw)}


@pytest.fixture(scope="module")
def workloads():
    return _workloads(make_workload, device="cpu")


@pytest.fixture(scope="module")
def jworkloads():
    return _workloads(jmake_workload)


def _trace(wls, mod=None, n=8, rate=3.0, max_new=3, seed=0):
    synth = synth_trace if mod is None else mod.synth_trace
    reqs = synth(FAMILIES, n, rate, max_new, wls, seed, **SIZES)
    for r in reqs:
        r.deadline = r.arrival + 500.0
    return reqs


def _ledger(eng):
    """rid-sorted request ledger (two runs of one trace draw different
    rids, so ledgers are compared by position)."""
    return [eng.requests[rid] for rid in sorted(eng.requests)]


def _assert_equivalent(led, clean_led, exact=True):
    assert len(led) == len(clean_led)
    for a, b in zip(led, clean_led):
        assert a.status == b.status
        if a.status != COMPLETED:
            continue
        if a.family == "lm":
            assert a.out == b.out
        elif exact:
            assert np.array_equal(a.result, b.result)
        else:
            np.testing.assert_allclose(np.asarray(a.result),
                                       np.asarray(b.result), rtol=0,
                                       atol=1e-4)


def _engine(wls, **kw):
    return ServeEngine(dict(wls), compiled=True, bucketed=True,
                       continuous=True, max_slots=4, device="cpu", **kw)


# -- admission dedupe + rid reservation ---------------------------------------


def test_queue_dedupes_by_rid_and_reserves_ceiling():
    q = AdmissionQueue()
    r = lm_request([1, 2], 2, arrival=0.0)
    assert q.submit(r) and q.submit(r)           # dupe swallowed, not queued
    assert q.submitted == 1 and q.duplicates == 1
    assert len(q.pending()) == 1

    reserve_rids(r.rid + 1000)
    fresh = lm_request([1], 1, arrival=0.0)
    assert fresh.rid >= r.rid + 1000             # replay-collision-free


# -- quarantine serialization -------------------------------------------------


def test_quarantine_backoff_expiry_survives_roundtrip():
    q = Quarantine(backoff=4, max_retries=3)
    q.record_failure(("lm", "sig-a"), 10, RuntimeError("boom"))
    st = q.state()
    json.dumps(st)

    q2 = Quarantine(backoff=4, max_retries=3)
    q2.load_state(st)
    assert q2.blocks(("lm", "sig-a"), 13)
    assert not q2.blocks(("lm", "sig-a"), 14)
    assert q2.events == 1
    q2.record_failure(("lm", "sig-a"), 14, RuntimeError("boom"))
    assert q2.blocks(("lm", "sig-a"), 21)
    assert not q2.blocks(("lm", "sig-a"), 22)


def test_quarantine_permanent_cap_survives_roundtrip():
    q = Quarantine(backoff=2, max_retries=1)
    q.record_failure("sig", 0, RuntimeError("x"))
    q.record_failure("sig", 5, RuntimeError("x"))   # past cap: permanent
    assert q.permanent() == 1
    st = q.state()
    assert st["entries"][0]["until"] is None
    q2 = Quarantine(backoff=2, max_retries=1)
    q2.load_state(st)
    assert q2.permanent() == 1
    assert q2.blocks("sig", 10**9)
    assert math.isinf(q2._entries[next(iter(q2._entries))]["until"])


def test_quarantine_survives_engine_snapshot_restore(workloads):
    eng = _engine(workloads)
    eng.quarantine.record_failure(("tree", "sig-x"), 2, RuntimeError("boom"))
    restored = restore_engine(snapshot_engine(eng), dict(workloads),
                              device="cpu")
    assert restored.quarantine.blocks(("tree", "sig-x"), 3)
    assert restored.quarantine.events == 1


# -- kill + restore equivalence ------------------------------------------------


@pytest.mark.parametrize("async_compile", [False, True],
                         ids=["sync", "async"])
def test_kill_restore_reproduces_uninterrupted_run(workloads, tmp_path,
                                                   async_compile):
    trace = _trace(workloads, seed=3)
    clean = _engine(workloads)
    clean.submit_many(trace)
    clean_stats = clean.run()

    trace2 = _trace(workloads, seed=3)
    eng = _engine(workloads, fault_injector=FaultInjector(crash_rounds=[4]),
                  checkpoint_dir=str(tmp_path), checkpoint_every=2,
                  async_compile=async_compile)
    eng.submit_many(trace2)
    with pytest.raises(InjectedCrash):
        eng.run()
    eng.close()
    assert latest_checkpoint(str(tmp_path)) is not None

    r_eng = ServeEngine.restore(latest_checkpoint(str(tmp_path)),
                                dict(workloads), device="cpu")
    assert r_eng._round == 4 and r_eng.async_compile == async_compile
    r_eng.submit_many(trace2)        # full-trace replay: all dupes swallowed
    r_stats = r_eng.run()
    r_eng.close()
    assert r_eng.queue.duplicates >= len(trace2)
    assert r_stats.requests_failed == 0
    assert r_stats.n_restores == 1 and r_stats.n_checkpoints >= 1
    assert r_stats.tokens_out == clean_stats.tokens_out
    # An async run serves its first rounds on the interpreted floor, whose
    # sums associate differently from the bucketed tier's.
    _assert_equivalent(_ledger(r_eng), _ledger(clean),
                       exact=not async_compile)


def test_restore_copies_into_the_engines_pool(workloads, monkeypatch):
    """The restore writes the checkpoint's slot pool into the tensors the
    engine made (a captured graph reads them at fixed addresses), never
    rebinding them."""
    eng = _engine(workloads)
    eng.submit_many(_trace(workloads, n=4, seed=1))
    for _ in range(3):
        eng.step()
    payload = snapshot_engine(eng)
    made = {}
    lm_pool = ServeEngine._lm_pool

    def recording(self):
        pool = lm_pool(self)
        made.setdefault("ptrs", {f: t.data_ptr() for f, t in pool.items()})
        return pool

    monkeypatch.setattr(ServeEngine, "_lm_pool", recording)
    restored = restore_engine(payload, dict(workloads), device="cpu")
    assert {f: t.data_ptr() for f, t in restored._pool.items()} == \
        made["ptrs"]
    for f, t in eng._pool.items():
        assert torch.equal(restored._pool[f], t)


def test_restore_mismatch_dumps_flight_recorder(workloads, tmp_path):
    eng = _engine(workloads)
    p = str(tmp_path / "c.json")
    eng.checkpoint(path=p)
    doc = json.load(open(p))
    doc["payload"]["clock"]["round"] = 99        # tamper
    json.dump(doc, open(p, "w"))

    obs = Obs(tracer=Tracer(enabled=True, ring=4),
              metrics=MetricsRegistry(), flight=FlightRecorder(ring=2))
    with pytest.raises(CheckpointError):
        ServeEngine.restore(p, dict(workloads), obs=obs, device="cpu")
    assert obs.flight.dumps
    assert obs.flight.dumps[-1]["reason"] == "restore_mismatch"
    assert obs.flight.dumps[-1]["info"]["path"] == p


# -- across packages -------------------------------------------------------------


def _crash_and_checkpoint(eng, trace, tmp_path):
    eng.submit_many(trace)
    with pytest.raises(Exception, match="injected process crash"):
        eng.run()
    path = latest_checkpoint(str(tmp_path))
    assert path is not None
    return path


def test_jax_checkpoint_restores_in_the_port(workloads, jworkloads,
                                             tmp_path):
    """A checkpoint the JAX engine wrote at an injected crash, restored by
    the port's engine: it finishes with the JAX engine's uninterrupted
    outputs."""
    clean = jserve.ServeEngine(dict(jworkloads), max_slots=4)
    clean.submit_many(_trace(jworkloads, jserve, seed=3))
    clean.run()
    jeng = jserve.ServeEngine(dict(jworkloads), max_slots=4,
                              fault_injector=JFaultInjector(crash_rounds=[4]),
                              checkpoint_dir=str(tmp_path))
    path = _crash_and_checkpoint(jeng, _trace(jworkloads, jserve, seed=3),
                                 tmp_path)
    eng = ServeEngine.restore(path, dict(workloads), device="cpu")
    assert eng._round == 4
    stats = eng.run()
    assert stats.n_restores == 1 and stats.requests_failed == 0
    _assert_equivalent(_ledger(eng), _ledger(clean), exact=False)


def test_port_checkpoint_restores_in_jax(workloads, jworkloads, tmp_path):
    """A checkpoint the port's engine wrote at an injected crash, restored
    by the JAX engine: it finishes with the port's uninterrupted outputs,
    and the JAX engine's own."""
    clean = _engine(workloads)
    clean.submit_many(_trace(workloads, seed=3))
    clean.run()
    jclean = jserve.ServeEngine(dict(jworkloads), max_slots=4)
    jclean.submit_many(_trace(jworkloads, jserve, seed=3))
    jclean.run()
    eng = _engine(workloads, fault_injector=FaultInjector(crash_rounds=[4]),
                  checkpoint_dir=str(tmp_path))
    path = _crash_and_checkpoint(eng, _trace(workloads, seed=3), tmp_path)
    jeng = jserve.ServeEngine.restore(path, dict(jworkloads))
    assert jeng._round == 4
    stats = jeng.run()
    assert stats.n_restores == 1 and stats.requests_failed == 0
    _assert_equivalent(_ledger(jeng), _ledger(clean), exact=False)
    _assert_equivalent(_ledger(jeng), _ledger(jclean), exact=False)


# -- the launcher's cache directory ----------------------------------------------


def test_audit_cache_dir_quarantines_corrupt_entries(tmp_path):
    good = tmp_path / "entry_good"
    good.write_bytes(b"warm")
    (tmp_path / "entry_torn").write_bytes(b"")   # zero-byte: crash residue
    with pytest.warns(RuntimeWarning, match="quarantined corrupt"):
        moved = audit_cache_dir(str(tmp_path))
    assert len(moved) == 1 and QUARANTINE_SUBDIR in moved[0]
    assert good.exists()
    assert not (tmp_path / "entry_torn").exists()
    assert (tmp_path / QUARANTINE_SUBDIR / "entry_torn").exists()
    assert audit_cache_dir(str(tmp_path / "missing")) == []

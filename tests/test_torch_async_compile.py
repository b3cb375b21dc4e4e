"""The port's async compile service (``repro_torch.serve.compiler``) and
the serve engine's async tier on the CPU, mirroring
``tests/test_async_compile.py``: service dedupe, retries, timeouts and
quarantine; the coarse bridge; hot-swapped output equal to the sync
engine's; hang containment; the warm set; checkpoint continuity for
in-flight builds; pool drain and shutdown.

On the CPU a background build is the host pack and the bucket entry (the
card adds the eager warm-up and the CUDA-graph capture, under the build
lock). The async engine's lm tokens equal the port's sync engine's and the
JAX package's sync engine's on the same numpy-seeded weights; single-shot
outputs equal the sync engine's bit for bit once every round runs at the
bucketed tier, and agree within 1e-6 on a first pass, whose early rounds
run on the interpreted floor (its sums associate differently), and within
1e-4 of the reference."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.launch.cache import (load_warmset, save_warmset,  # noqa: E402
                                      warmset_path)
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch.serve import ServeEngine, lm_request  # noqa: E402
from repro_torch.serve.compiler import CompileService  # noqa: E402
from repro_torch.serve.faults import FaultInjector, Quarantine  # noqa: E402
from repro_torch.serve.queue import COMPLETED  # noqa: E402
from repro_torch.serve.resilience import snapshot_engine  # noqa: E402
from repro_torch.serve.scheduler import (RoundPlan,  # noqa: E402
                                         build_lm_feed_round_graph)

MODEL_SIZE = 8
SIZES = dict(tree_leaves=(3, 5), lattice_chars=(4, 6))


@pytest.fixture(scope="module")
def workloads():
    return {"lm": make_workload("ChainLM", MODEL_SIZE, device="cpu")}


@pytest.fixture(scope="module")
def reference_tokens():
    """The JAX package's sync engine's tokens for each ``_lm_trace`` seed."""
    wls = {"lm": jmake_workload("ChainLM", MODEL_SIZE)}
    out = {}
    for n, seed in ((4, 0), (3, 0), (3, 1)):
        reqs = _lm_trace(n=n, seed=seed, mod=jserve)
        eng = jserve.ServeEngine(wls, compiled=True, bucketed=True,
                                 continuous=True, max_slots=4)
        eng.submit_many(reqs)
        eng.run()
        out[(n, seed)] = _tokens(reqs)
    return out


def _lm_trace(n=4, max_new=3, seed=0, mod=None):
    request = lm_request if mod is None else mod.lm_request
    rng = np.random.default_rng(seed)
    return [request(list(map(int, rng.integers(0, 256, 4 + i % 3))),
                    max_new, arrival=float(i)) for i in range(n)]


def _engine(workloads, **kw):
    kw.setdefault("compiled", True)
    kw.setdefault("bucketed", True)
    kw.setdefault("continuous", True)
    kw.setdefault("max_slots", 4)
    return ServeEngine(workloads, device="cpu", **kw)


def _tokens(reqs):
    return [tuple(r.out) for r in reqs]


# -- CompileService unit behavior (fake builds) ---------------------------------


def test_service_dedupes_and_lands():
    svc = CompileService(workers=1, timeout_s=5.0)
    ev = threading.Event()

    def build(job, span_args, abort):
        ev.wait(1.0)
        return 0.01

    assert svc.submit("sig-a", build)
    assert not svc.submit("sig-a", build), "in-flight sig must dedupe"
    assert svc.in_flight("sig-a")
    ev.set()
    assert svc.drain(timeout_s=5.0)
    landed = svc.poll()
    assert [j.sig for j in landed] == ["sig-a"]
    assert svc.stats["landed"] == 1 and svc.stats["submitted"] == 1
    assert svc.pending_count() == 0
    assert svc.submit("sig-a", lambda j, s, a: 0.0)
    svc.drain(timeout_s=5.0)
    svc.shutdown()


def test_service_retries_then_quarantines():
    q = Quarantine(backoff=2, max_retries=2)
    quarantined = []
    svc = CompileService(workers=1, timeout_s=5.0, max_retries=2,
                         retry_backoff_s=0.01, quarantine=q,
                         on_quarantine=quarantined.append)

    def build(job, span_args, abort):
        job.qkey = ("lm", ("spec", job.sig))
        raise RuntimeError("boom")

    svc.submit("sig-b", build, family="lm")
    assert svc.drain(timeout_s=10.0)
    assert svc.stats["failures"] == 3      # 1 initial + 2 retries
    assert svc.stats["retries"] == 2
    assert svc.stats["quarantined"] == 1
    assert [j.sig for j in quarantined] == ["sig-b"]
    assert q.blocks(("lm", ("spec", "sig-b")), round_=10 ** 9)
    svc.shutdown()


def test_service_timeout_abandons_and_retry_lands():
    svc = CompileService(workers=1, timeout_s=0.2, max_retries=2,
                         retry_backoff_s=0.01)
    calls = []

    def build(job, span_args, abort):
        calls.append(job.attempts)
        if len(calls) == 1:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not abort():
                time.sleep(0.01)
            raise RuntimeError("abandoned")
        return 0.01

    svc.submit("sig-c", build)
    assert svc.drain(timeout_s=10.0)
    assert svc.stats["timeouts"] == 1
    assert svc.stats["retries"] == 1
    assert svc.stats["landed"] == 1
    assert len(calls) == 2
    svc.shutdown()
    for w in svc._workers + svc._abandoned:
        assert not w.thread.is_alive()


# -- coarse bridging precondition ---------------------------------------------


def test_coarse_count_pad_shares_spec(workloads):
    eng = _engine(workloads, async_compile=False)
    ex = eng._executor("lm")
    pol = eng.policy_for("lm")
    g8, _ = build_lm_feed_round_graph(RoundPlan(), count=8)
    g16, _ = build_lm_feed_round_graph(RoundPlan(), count=16)
    assert g8.topology_key() != g16.topology_key()
    assert ex.pack_for(g8, pol).spec != ex.pack_for(g16, pol).spec
    assert ex.pack_for(g8, pol).spec != ex.pack_for(g8, pol,
                                                    ladder=(16,)).spec


def test_coarse_bridge_serves_while_native_compiles(workloads,
                                                     reference_tokens):
    eng = _engine(workloads, async_compile=True)
    assert eng.prewarm({"families": {"lm": {"counts": [16]}}}) == 1
    assert eng._compiler.drain(timeout_s=60.0)
    a1 = _lm_trace(n=3)
    eng.submit_many(a1)
    eng.run()
    assert eng.stats.tier_rounds.get("coarse", 0) >= 1
    assert eng.stats.tier_rounds.get("interpreted", 0) == 0
    a2 = _lm_trace(n=3, seed=1)
    eng.submit_many(a2)
    eng.run()
    eng.close()
    assert eng.stats.tier_rounds.get("bucketed", 0) >= 1
    assert eng.stats.n_hotswaps >= 1
    assert _tokens(a1) == reference_tokens[(3, 0)]
    assert _tokens(a2) == reference_tokens[(3, 1)]


# -- engine integration --------------------------------------------------------


def test_async_bit_identical_to_sync_with_hotswap(workloads,
                                                  reference_tokens):
    reqs_a = _lm_trace()
    sync = _engine(workloads, async_compile=False)
    sync.submit_many(reqs_a)
    sync.run()

    reqs_b = _lm_trace()
    eng = _engine(workloads, async_compile=True, compile_workers=2,
                  compile_timeout_s=30.0)
    eng.submit_many(reqs_b)
    eng.step()
    assert eng._compiler.stats["submitted"] >= 1
    assert eng._compiler.drain(timeout_s=60.0)
    eng.run()
    eng.close()

    assert _tokens(reqs_b) == _tokens(reqs_a) == reference_tokens[(4, 0)]
    assert all(r.status == COMPLETED for r in reqs_b)
    assert eng.stats.tier_rounds.get("interpreted", 0) >= 1
    assert eng.stats.tier_rounds.get("bucketed", 0) >= 1
    assert eng.stats.n_hotswaps >= 1
    assert eng.stats.compile_jobs_landed >= 1
    assert eng.stats.lower_s == 0.0
    assert eng.stats.lower_bg_s > 0.0


def test_async_mixed_trace_matches_sync_and_reference():
    """All three families: the async engine against the port's sync engine
    and the JAX package's. A second pass through the same engines runs
    every round bucketed and equals the sync engine bit for bit."""
    def wls(make, **kw):
        return {"lm": make("ChainLM", MODEL_SIZE, **kw),
                "tree": make("TreeLSTM", MODEL_SIZE, **kw),
                "lattice": make("LatticeLSTM", MODEL_SIZE, **kw)}

    def trace(mod, w, start=0.0):
        reqs = mod.synth_trace(["lm", "tree", "lattice"], 9, 3.0, 4, w, 11,
                               **SIZES)
        for r in reqs:
            r.arrival += start
        return reqs

    jw = wls(jmake_workload)
    jeng = jserve.ServeEngine(jw, max_slots=4)
    want = trace(jserve, jw)
    jeng.submit_many(want)
    jeng.run()
    tw = wls(make_workload, device="cpu")
    engines = {"sync": ServeEngine(dict(tw), max_slots=4, device="cpu"),
               "async": ServeEngine(dict(tw), max_slots=4, device="cpu",
                                    async_compile=True)}
    passes = {}
    for name, eng in engines.items():
        for k in range(2):
            reqs = trace(tserve, tw, eng._now)
            tiers = dict(eng.stats.tier_rounds)
            eng.submit_many(reqs)
            eng.run()
            passes[name, k] = (reqs, {t: n - tiers.get(t, 0) for t, n in
                                      eng.stats.tier_rounds.items()
                                      if n > tiers.get(t, 0)})
        eng.close()
    assert passes["async", 0][1].get("interpreted", 0) >= 1
    assert set(passes["async", 1][1]) == {"bucketed"}
    for k in range(2):
        got, sync = passes["async", k][0], passes["sync", k][0]
        for a, s, j in zip(got, sync, want):
            assert a.status == s.status == j.status == COMPLETED
            if a.family == "lm":
                assert a.out == s.out == j.out
                continue
            np.testing.assert_allclose(a.result, np.asarray(j.result),
                                       rtol=0, atol=1e-4)
            if k == 1:
                assert np.array_equal(a.result, s.result)
            else:
                np.testing.assert_allclose(a.result, s.result, rtol=0,
                                           atol=1e-6)


def test_compile_hang_contained_within_timeout(workloads):
    reqs_clean = _lm_trace(n=3)
    clean = _engine(workloads, async_compile=False)
    clean.submit_many(reqs_clean)
    clean.run()

    reqs = _lm_trace(n=3)
    inj = FaultInjector(compile_hang=(1, 10.0))
    eng = _engine(workloads, async_compile=True, compile_workers=1,
                  compile_timeout_s=2.0, fault_injector=inj)
    eng.submit_many(reqs)
    t0 = time.monotonic()
    eng.run()
    wall = time.monotonic() - t0
    eng.close()

    assert wall < 8.0
    assert eng.stats.compile_jobs_timed_out >= 1
    assert eng.stats.compile_jobs_retried >= 1
    assert eng.stats.compile_jobs_landed >= 1
    assert eng.stats.compile_jobs_quarantined == 0
    assert all(r.status == COMPLETED for r in reqs)
    assert _tokens(reqs) == _tokens(reqs_clean)


def test_compile_fail_quarantines_and_dumps_flight(workloads):
    reqs = _lm_trace(n=3)
    inj = FaultInjector(compile_fail=99)   # every attempt fails
    eng = _engine(workloads, async_compile=True, compile_workers=1,
                  compile_timeout_s=5.0, fault_injector=inj)
    eng.submit_many(reqs)
    eng.run()
    eng.close()
    assert eng.stats.compile_jobs_quarantined >= 1
    assert all(r.status == COMPLETED for r in reqs)
    assert eng.stats.tier_rounds.get("bucketed", 0) == 0
    assert eng.flight is not None
    assert "compile_quarantine" in {d["reason"] for d in eng.flight.dumps}


def test_warmset_roundtrip_and_prewarm(tmp_path, workloads):
    reqs = _lm_trace()
    eng = _engine(workloads, async_compile=True)
    eng.submit_many(reqs)
    eng.run()
    ws = eng.warmset()
    eng.close()
    counts = ws["families"]["lm"]["counts"]
    assert counts, "served lm rounds must record their padded counts"

    cache_dir = str(tmp_path / "cache")
    assert save_warmset(cache_dir, ws) == warmset_path(cache_dir)
    assert load_warmset(cache_dir) == ws
    with open(warmset_path(cache_dir), "w") as f:
        f.write('{"version": 1, "families": {')
    with pytest.warns(RuntimeWarning):
        assert load_warmset(cache_dir) == {}
    assert load_warmset(str(tmp_path / "missing")) == {}

    eng2 = _engine(workloads, async_compile=True)
    assert eng2.prewarm(ws) >= 1
    assert eng2._compiler.drain(timeout_s=60.0)
    eng2.submit_many(_lm_trace())
    eng2.run()
    eng2.close()
    assert eng2.stats.tier_rounds.get("interpreted", 0) == 0
    assert eng2.stats.n_hotswaps == 0


def test_checkpoint_restore_resubmits_inflight(workloads):
    reqs = _lm_trace(n=3)
    inj = FaultInjector(compile_hang=(1, 60.0))
    eng = _engine(workloads, async_compile=True, compile_workers=1,
                  compile_timeout_s=120.0, fault_injector=inj)
    eng.submit_many(reqs)
    eng.step()
    assert eng._compiler.pending_count() == 1
    payload = snapshot_engine(eng, reason="test")
    eng.close()

    assert payload["config"]["async_compile"] is True
    inflight = payload["compile"]["in_flight"]
    assert inflight and inflight[0]["family"] == "lm"
    assert payload["compile"]["warm_counts"]

    eng2 = ServeEngine.restore(payload, workloads, device="cpu")
    assert eng2.async_compile
    assert eng2._compiler.pending_count() >= 1
    eng2.run()
    eng2.close()
    assert all(eng2.requests[r.rid].status == COMPLETED for r in reqs)
    assert eng2.stats.compile_jobs_landed >= 1


def test_run_drains_pool_and_close_stops_workers(workloads):
    eng = _engine(workloads, async_compile=True, compile_workers=2)
    eng.submit_many(_lm_trace())
    eng.run()
    assert eng._compiler.pending_count() == 0
    svc = eng._compiler
    eng.close()
    for w in svc._workers + svc._abandoned:
        assert w.thread is None or not w.thread.is_alive()
    assert not svc.submit("post-close", lambda j, s, a: 0.0)


def test_fault_spec_parses_hang_and_slow():
    inj = FaultInjector.from_spec("compile_hang=2*7.5,compile_slow=0.25")
    assert inj.compile_hang == (2, 7.5)
    assert inj.compile_slow == (1, 0.25)
    with pytest.raises(ValueError, match="compile_hang"):
        FaultInjector.from_spec("bogus_key=1")


def test_two_builds_of_one_signature_build_once(workloads):
    """Two jobs whose topologies share a bucket signature race to build
    it: the build lock lets one build and the other take its entry."""
    eng = _engine(workloads, async_compile=False)
    ex = eng._executor("lm")
    pol = eng.policy_for("lm")
    params = {"slots": eng._lm_pool()}
    graphs = []
    for k in range(2):
        g, _ = build_lm_feed_round_graph(RoundPlan(), count=8)
        g.nodes[1].attrs["aux"] = k
        graphs.append(g)
    packs = [ex.pack_for(g, pol) for g in graphs]
    assert packs[0].spec == packs[1].spec
    got = []
    threads = [threading.Thread(
        target=lambda p=p: got.append(ex.build_executable(p, params)))
        for p in packs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert ex.n_bucket_compiles == 1
    assert got[0][1] is got[1][1]
    assert sorted(dt == 0.0 for _, _, dt in got) == [False, True]


def test_launch_counts_from_many_threads_lose_no_update():
    """Wrappers count launches from the loop and from build workers at
    once: every count lands, and a thread's capture tally stays its own."""
    import sys

    from repro_torch.kernels import counting, launches
    from repro_torch.kernels.gather_batch import gather_rows

    start = launches.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tallies = []

    def work(capture):
        if capture:
            with launches.captured() as d:
                for _ in range(2000):
                    counting.count(gather_rows, (1, 4))
            tallies.append(d)
        else:
            for _ in range(2000):
                counting.count(gather_rows, (1, 4))

    try:
        threads = [threading.Thread(target=work, args=(i % 4 == 0,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        d = launches.delta(start, launches.snapshot())
        assert d["gather_rows"] == 12 * 2000
        assert d["gather_shapes"] == {(1, 4): 12 * 2000}
        assert [t["gather_rows"] for t in tallies] == [2000] * 4
    finally:
        sys.setswitchinterval(interval)
        launches.restore(start)

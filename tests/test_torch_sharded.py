"""The port's sharded bucketed execution (``repro_torch.core.plan``,
``repro_torch.launch.mesh``) and its K-shard serve engine on the CPU,
mirroring ``tests/test_sharded.py`` at model size 8.

The port runs K replicas over a leading replica axis on one device, so no
forced devices are needed. Per-shard results must equal the port's
single-device :class:`BucketedPlanExecutor` bit for bit (the per-shard
body is the single-device program verbatim, at the same shapes) and be
within 1e-4 of the reference's single-device executor on the same
numpy-seeded weights. The K-shard engine's outputs must not depend on K
and equal the reference's engine; its stacked slot pool keeps its
addresses across a restore, a shrink and a regrow.
"""

import random
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.core.batching import SufficientConditionPolicy as JPolicy  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.graph import Node as JNode  # noqa: E402
from repro.core.plan import BucketedPlanExecutor as JBucketed  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core.batching import SufficientConditionPolicy  # noqa: E402
from repro_torch.core.executor import DynamicExecutor, ExecStats  # noqa: E402
from repro_torch.core.graph import Graph, Node  # noqa: E402
from repro_torch.core.plan import (BucketedPlanExecutor,  # noqa: E402
                                   ShardedBucketedPlanExecutor,
                                   ShardPlanResult)
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.serve import ServeEngine, lm_request  # noqa: E402
from repro_torch.serve.resilience import (restore_engine,  # noqa: E402
                                          snapshot_engine)

POLICY = SufficientConditionPolicy()
N_SHARDS = 4
MODEL_SIZE = 8
CPU = {"device": "cpu"}


def permute_aux(graph, salt: int, mod: int = 500, graph_cls=Graph,
                node_cls=Node):
    """Same topology, different aux payload per shard."""
    return graph_cls([node_cls(id=n.id, type=n.type, inputs=n.inputs,
                               op=n.op,
                               attrs={"aux": (n.attrs.get("aux", 0) * 7
                                              + salt) % mod})
                      for n in graph.nodes])


def chain_graph(wl, lengths, seed=0):
    nodes = []

    def add(t, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=t, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    rng = random.Random(seed)
    for L in lengths:
        prev = add("S")
        for _ in range(L):
            e = add("E", aux=rng.randrange(wl.vocab))
            prev = add("C", (prev, e))
            add("O", (prev,))
    return Graph(nodes)


def assert_bit_equal(graph, ref, res):
    for n in graph.nodes:
        a, b = ref.node(n.id), res.node(n.id)
        assert a.keys() == b.keys()
        for f in a:
            assert torch.equal(a[f], b[f]), (n.id, f)


def assert_close(graph, ref, res, atol):
    for n in graph.nodes:
        a, b = ref.node(n.id), res.node(n.id)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_allclose(
                np.asarray(a[f]), np.asarray(b[f]), rtol=0, atol=atol,
                err_msg=f"node {n.id} ({graph.nodes[n.id].type}) field {f}")


# -- the mesh -----------------------------------------------------------------


def test_data_mesh_takes_the_first_surviving_replicas():
    mesh = make_data_mesh(3, **CPU)
    assert mesh.axis_names == ("data",) and mesh.devices.size == 3
    assert list(mesh.devices) == [0, 1, 2]
    assert list(make_data_mesh(2, exclude=(0, 2), **CPU).devices) == [1, 3]
    assert make_data_mesh(**CPU).devices.size == 1
    with pytest.raises(ValueError, match="n_devices"):
        make_data_mesh(0, **CPU)


# -- sharded executor vs single-device bucketed executor ---------------------


@pytest.mark.parametrize("name,args", [
    ("BiLSTM-Tagger", dict(lo=4, hi=7)),
    ("TreeLSTM", dict(leaves_lo=4, leaves_hi=5)),
    ("LatticeLSTM", dict(lo=6, hi=8)),
])
def test_sharded_matches_single_device(name, args):
    """K same-topology graphs (different aux payloads) run as one sharded
    run; each shard equals the port's single-device bucketed executor bit
    for bit and the reference's within 1e-4."""
    wl = make_workload(name, MODEL_SIZE, **CPU)
    jwl = jmake_workload(name, MODEL_SIZE)
    base = wl.sample_graph(random.Random(0), 1, **args)
    jbase = jwl.sample_graph(random.Random(0), 1, **args)
    graphs = [permute_aux(base, s) for s in range(N_SHARDS)]
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=N_SHARDS, **CPU)
    stats = ExecStats()
    results = ex.run_sharded(graphs, POLICY, stats)
    assert ex.n_sharded_dispatches == 1
    assert ex.n_fallback_rounds == 0
    assert stats.n_launches == 1           # one run for all K shards
    single = BucketedPlanExecutor(wl.impls, None, **CPU)
    jsingle = JBucketed(jwl.impls, None)
    for s, (g, res) in enumerate(zip(graphs, results)):
        assert isinstance(res, ShardPlanResult) and res.shard == s
        assert_bit_equal(g, single.run(g, POLICY), res)
        jg = permute_aux(jbase, s, graph_cls=JGraph, node_cls=JNode)
        assert_close(g, jsingle.run(jg, JPolicy()), res, 1e-4)


def test_sharded_same_bucket_different_topologies():
    """Chains of 5/6/7/5 share one bucket signature: still one run."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    graphs = [chain_graph(wl, (L,), seed=s)
              for s, L in enumerate((5, 6, 7, 5))]
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=N_SHARDS, **CPU)
    results = ex.run_sharded(graphs, POLICY)
    assert ex.n_sharded_dispatches == 1 and ex.n_fallback_rounds == 0
    single = BucketedPlanExecutor(wl.impls, None, **CPU)
    ref = DynamicExecutor(wl.impls, None, **CPU)
    for g, res in zip(graphs, results):
        assert_bit_equal(g, single.run(g, POLICY), res)
        assert_close(g, ref.run(g, POLICY), res, 1e-5)


def test_sharded_spec_mismatch_falls_back():
    """Shards in different buckets (or idle) degrade to per-shard runs
    through the inherited single-device path, counted in
    ``n_fallback_rounds``."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    graphs = [chain_graph(wl, (5,)), chain_graph(wl, (12,)),
              None, chain_graph(wl, (5,), seed=3)]
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=N_SHARDS, **CPU)
    results = ex.run_sharded(graphs, POLICY)
    assert ex.n_fallback_rounds == 1 and ex.n_sharded_dispatches == 0
    assert results[2] is None
    ref = DynamicExecutor(wl.impls, None, **CPU)
    for g, res in zip(graphs, results):
        if g is not None:
            assert_close(g, ref.run(g, POLICY), res, 1e-5)
    assert ex.run_sharded([None] * N_SHARDS, POLICY) == [None] * N_SHARDS
    with pytest.raises(ValueError, match="one per shard"):
        ex.run_sharded(graphs[:2], POLICY)


def test_sharded_executables_keyed_by_shard_count():
    """The bucket signature carries n_shards: a sharded build and a
    single-device build of the same topology are distinct cache entries."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=N_SHARDS, **CPU)
    g = chain_graph(wl, (5,))
    ex.run_sharded([permute_aux(g, s, wl.vocab) for s in range(N_SHARDS)],
                   POLICY)
    ex.run(g, POLICY)          # inherited single-device path
    shard_counts = sorted(key[1].n_shards for key in ex._exes)
    assert shard_counts == [1, N_SHARDS]
    with pytest.raises(ValueError, match="mesh has 2 devices"):
        ShardedBucketedPlanExecutor(wl.impls, None, n_shards=3,
                                    mesh=make_data_mesh(2, **CPU), **CPU)


def test_sharded_shard_params_slot_pool():
    """Per-shard params (the serve slot pool pattern): each shard's R nodes
    read its own row of the stacked pool; the key carries the pool's
    address, so another pool is another entry."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    nodes = []

    def add(t, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=t, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    r = add("R", aux=1)                    # read slot 1 of the home shard
    e = add("E", aux=7)
    c = add("C", (r, e))
    add("O", (c,))
    g = Graph(nodes)

    nrng = np.random.default_rng(0)
    pool = {f: torch.as_tensor(nrng.standard_normal(
                (N_SHARDS, 2, MODEL_SIZE)), dtype=torch.float32)
            for f in wl.state_fields}
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=N_SHARDS, **CPU)
    results = ex.run_sharded([g] * N_SHARDS, POLICY,
                             shard_params={"slots": pool})
    assert ex.n_sharded_dispatches == 1
    single = BucketedPlanExecutor(wl.impls, None, **CPU)
    for s, res in enumerate(results):
        mine = {f: v[s] for f, v in pool.items()}
        assert_bit_equal(g, single.run(g, POLICY, params={"slots": mine}),
                         res)
        # flat addressing of the stacked arenas reads the same rows
        flat, rows = res.stacked_rows("y", [3])
        assert torch.equal(flat[rows], res.field("y", [3]))
    pack = ex.pack_for(g, POLICY)
    sspec = replace(pack.spec, n_shards=N_SHARDS)
    assert ex.sharded_executable_ready(sspec, None, {"slots": pool})
    other = {"slots": {f: v.clone() for f, v in pool.items()}}
    assert not ex.sharded_executable_ready(sspec, None, other)


def test_sharded_donated_runs_reuse_their_arenas():
    """With donation a run writes into the previous run's stacked arenas
    (zeroed first), with the same results."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    g = chain_graph(wl, (5,))
    graphs = [permute_aux(g, s, wl.vocab) for s in range(2)]
    ex = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=2, donate=True,
                                     **CPU)
    first = ex.run_sharded(graphs, POLICY)[0].stacked
    want = {k: v.clone() for k, v in first.items()}
    second = ex.run_sharded(graphs, POLICY)[0].stacked
    for k, v in second.items():
        assert v is first[k]
        assert torch.equal(v, want[k])


# -- sharded serve engine -----------------------------------------------------


def _workloads(make, **kw):
    return {"lm": make("ChainLM", MODEL_SIZE, **kw),
            "tree": make("TreeLSTM", MODEL_SIZE, **kw),
            "lattice": make("LatticeLSTM", MODEL_SIZE, **kw)}


@pytest.fixture(scope="module")
def workloads():
    return _workloads(make_workload, **CPU)


def mixed_trace(wls, mod, seed=0):
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    reqs = [mod.lm_request(list(map(int, nrng.integers(0, 256, 3 + i % 4))),
                           max_new=4, arrival=i * 0.5) for i in range(8)]
    reqs.append(mod.graph_request(
        "tree", wls["tree"].sample_graph(rng, 1, leaves_lo=3, leaves_hi=5),
        arrival=0.0))
    reqs.append(mod.graph_request(
        "lattice", wls["lattice"].sample_graph(rng, 1, lo=4, hi=6),
        arrival=1.0))
    return reqs


def _serve(wls, n_shards, **kw):
    eng = ServeEngine(dict(wls), compiled=True, bucketed=True,
                      continuous=True, max_slots=8, n_shards=n_shards,
                      **CPU, **kw)
    reqs = mixed_trace(wls, tserve)
    eng.submit_many(reqs)
    stats = eng.run()
    eng.close()
    return reqs, stats, eng


@pytest.fixture(scope="module")
def by_k(workloads):
    return {k: _serve(workloads, k) for k in (1, 2, N_SHARDS)}


def _assert_same(got, want, exact=True):
    for a, b in zip(got, want):
        assert a.status == b.status == "COMPLETED"
        if a.family == "lm":
            assert a.out == b.out
        elif exact:
            assert np.array_equal(a.result, b.result)
        else:
            np.testing.assert_allclose(a.result, np.asarray(b.result),
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [2, N_SHARDS])
def test_engine_outputs_identical_across_replica_counts(by_k, k):
    """Replica scaling is invisible to request outputs (bit for bit on the
    CPU); lm rounds run as one sharded run and tokens balance across
    shards."""
    base, s1, _ = by_k[1]
    shard, sk, eng = by_k[k]
    _assert_same(shard, base)
    assert sk.requests_done == s1.requests_done
    assert sk.tokens_out == s1.tokens_out
    assert sk.n_shards == k
    assert sk.n_sharded_dispatches > 0
    assert set(sk.tier_rounds) == {"sharded"}
    assert sum(sk.shard_tokens) == sk.tokens_out
    assert max(sk.shard_tokens) - min(sk.shard_tokens) <= 8
    assert eng.pipeline is False


def test_engine_matches_the_reference_engine(by_k):
    """The port's K-shard engine gives the reference's single-device
    engine's outputs (tokens equal, tree and lattice within 1e-4)."""
    jwls = _workloads(jmake_workload)
    jeng = jserve.ServeEngine(dict(jwls), max_slots=8)
    jreqs = mixed_trace(jwls, jserve)
    jeng.submit_many(jreqs)
    jeng.run()
    _assert_same(by_k[N_SHARDS][0], jreqs, exact=False)


def test_async_compile_gives_the_same_outputs(workloads, by_k):
    reqs, stats, _ = _serve(workloads, N_SHARDS, async_compile=True)
    _assert_same(reqs, by_k[1][0])
    assert stats.compile_jobs_submitted >= 1
    assert stats.n_sharded_dispatches > 0


def test_engine_rejects_sharding_off_bucketed_path(workloads):
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(dict(workloads), compiled=False, n_shards=2, **CPU)


def _pool_ptrs(eng):
    return {f: t.data_ptr() for f, t in eng._pool.items()}


def test_stacked_pool_keeps_its_addresses_across_shrink_and_regrow(
        workloads):
    """The stack is made once for the configured replica count; every
    mesh size views it, so a resize writes rows in place."""
    eng = ServeEngine(dict(workloads), max_slots=8, n_shards=2, **CPU)
    eng.submit_many([lm_request([1, 2, 3], 6, arrival=0.0)
                     for _ in range(4)])
    for _ in range(3):
        eng.step()
    pool = eng._lm_pool()
    assert all(v.shape[:2] == (2, 4) for v in pool.values())
    ptrs = _pool_ptrs(eng)
    kept = {f: v[0].clone() for f, v in pool.items()}
    home0 = [sl for s, sl in eng.scheduler.slot_of.values() if s == 0]
    assert home0
    eng.lose_shard(1)
    assert eng.n_shards == 1 and eng._excluded_devices == [1]
    assert all(v.shape == (4, MODEL_SIZE) for v in eng._pool.values())
    assert _pool_ptrs(eng) == ptrs
    for f, v in kept.items():           # shard 0 kept its rows
        assert torch.equal(eng._pool[f][home0], v[home0])
    eng.regrow_shard()
    assert eng.n_shards == 2 and not eng._excluded_devices
    assert _pool_ptrs(eng) == ptrs
    eng.regrow_shard()                  # already at full strength
    assert eng.stats.n_resize_events == 2
    eng.run()
    assert all(r.status == "COMPLETED" for r in eng.requests.values())


def test_k_shard_restore_copies_into_the_stacked_pool(workloads):
    """A K-shard snapshot restores into the stacked pool the restored
    engine made (bit-exact), and a snapshot on a shrunken mesh into row 0
    of a stack made for the configured replica count."""
    eng = ServeEngine(dict(workloads), max_slots=8, n_shards=2, **CPU)
    eng.submit_many(mixed_trace(workloads, tserve))
    for _ in range(3):
        eng.step()
    r = restore_engine(snapshot_engine(eng), dict(workloads), **CPU)
    assert r.n_shards == 2 and r._pool_stack is not None
    for f, t in eng._pool.items():
        assert torch.equal(r._pool[f], t)
        assert r._pool[f].data_ptr() == r._pool_stack[f].data_ptr()
    eng.lose_shard(0)
    r = restore_engine(snapshot_engine(eng), dict(workloads), **CPU)
    assert r.n_shards == 1 and r._n_shards0 == 2
    assert r._excluded_devices == [0]
    for f, t in eng._pool.items():
        assert r._pool[f].shape == t.shape
        assert torch.equal(r._pool[f], t)
        assert r._pool_stack[f].shape[0] == 2
    r.run()
    assert r.n_shards == 1
    assert all(q.status == "COMPLETED" for q in r.requests.values())


def test_engine_takes_a_mesh(workloads, by_k):
    """A caller's mesh serves as the engine's own (its replica ids are
    bookkeeping); one of the wrong size is refused when the executor is
    made."""
    reqs, stats, eng = _serve(workloads, 2,
                              mesh=make_data_mesh(2, exclude=(0,), **CPU))
    _assert_same(reqs, by_k[1][0])
    assert list(eng._mesh.devices) == [1, 2]
    assert stats.n_sharded_dispatches > 0
    bad = ServeEngine(dict(workloads), max_slots=8, n_shards=2,
                      mesh=make_data_mesh(3, **CPU), **CPU)
    with pytest.raises(ValueError, match="mesh has 3 devices"):
        bad._executor("lm")

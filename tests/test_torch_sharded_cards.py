"""Replicas one a device (``launch/mesh.py`` placement ``"cards"``) on the
CPU, at model size 8, with meshes whose devices name ``cpu`` two and three
times: each placement has its own buffers, entries, weight copies and
slot pool, as a card of its own would.

The per-card executor's shards must be bit-equal to the port's
single-device :class:`BucketedPlanExecutor` and to the stacked mesh at the
same K, and within 1e-4 of the reference's single-device executor on the
same numpy-seeded weights; a round whose signatures differ falls back per
shard, each on its own placement. The per-card engine's outputs (lm
tokens, tree and lattice outputs, statuses) equal K = 1's, the stacked
engine's and the reference engine's, through a shard loss and regrowth,
work stealing and a snapshot and restore. Too few devices raise the
reference's ``RuntimeError``, and so does ``launch.serve --placement
cards`` on a machine without the cards.
"""

import random
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core.batching import SufficientConditionPolicy as JPolicy  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.graph import Node as JNode  # noqa: E402
from repro.core.plan import BucketedPlanExecutor as JBucketed  # noqa: E402
from repro.launch.mesh import make_data_mesh as jmake_data_mesh  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core.batching import SufficientConditionPolicy  # noqa: E402
from repro_torch.core.executor import DynamicExecutor  # noqa: E402
from repro_torch.core.graph import Graph, Node  # noqa: E402
from repro_torch.core.plan import (BucketedPlanExecutor, PerCard,  # noqa: E402
                                   ShardedBucketedPlanExecutor)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.resilience import (restore_engine,  # noqa: E402
                                          snapshot_engine)

POLICY = SufficientConditionPolicy()
MODEL_SIZE = 8
CPU = {"device": "cpu"}


def cpus(k):
    return ("cpu",) * k


def permute_aux(graph, salt: int, mod: int = 500, graph_cls=Graph,
                node_cls=Node):
    """Same topology, different aux payload per shard."""
    return graph_cls([node_cls(id=n.id, type=n.type, inputs=n.inputs,
                               op=n.op,
                               attrs={"aux": (n.attrs.get("aux", 0) * 7
                                              + salt) % mod})
                      for n in graph.nodes])


def chain_graph(wl, length, seed=0):
    rng = random.Random(seed)
    nodes = []

    def add(t, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=t, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    prev = add("S")
    for _ in range(length):
        prev = add("C", (prev, add("E", aux=rng.randrange(wl.vocab))))
        add("O", (prev,))
    return Graph(nodes)


def assert_bit_equal(graph, want, got):
    for n in graph.nodes:
        a, b = want.node(n.id), got.node(n.id)
        assert a.keys() == b.keys()
        for f in a:
            assert torch.equal(a[f], b[f]), (n.id, f)


# -- the mesh -----------------------------------------------------------------


def test_per_card_mesh_places_a_replica_on_each_listed_device():
    mesh = make_data_mesh(2, devices=cpus(2))
    assert mesh.placement == "cards" and mesh.axis_names == ("data",)
    assert mesh.devices.size == 2 and list(mesh.devices) == [0, 1]
    assert mesh.cards == (torch.device("cpu"),) * 2
    # exclude holds indices into the list: the survivors in order
    mesh = make_data_mesh(2, devices=cpus(3), exclude=(1,))
    assert list(mesh.devices) == [0, 2]
    assert make_data_mesh(devices=cpus(3), exclude=(0,)).devices.size == 2
    # the stacked placement is the default and ignores the card count
    assert make_data_mesh(5, **CPU).placement == "stacked"
    with pytest.raises(ValueError, match="placement"):
        make_data_mesh(2, placement="rows", **CPU)


@pytest.mark.parametrize("k,exclude", [(2, ()), (2, (0,))])
def test_too_few_devices_raise_the_references_error(k, exclude):
    """The reference's ``RuntimeError`` over its one CPU device, and the
    port's over one listed device: the same words (the reference adds how
    to force host devices)."""
    assert len(jax.devices()) == 1
    with pytest.raises(RuntimeError) as want:
        jmake_data_mesh(k, exclude=exclude)
    with pytest.raises(RuntimeError) as got:
        make_data_mesh(k, exclude=exclude, devices=cpus(1))
    assert str(want.value).startswith(str(got.value))
    # no card here: the default devices are none, never a stacked fallback
    with pytest.raises(RuntimeError, match="found 0"):
        make_data_mesh(2, placement="cards")


# -- the per-card executor ----------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name,args", [
    ("BiLSTM-Tagger", dict(lo=4, hi=7)),
    ("TreeLSTM", dict(leaves_lo=4, leaves_hi=5)),
    ("LatticeLSTM", dict(lo=6, hi=8)),
])
def test_per_card_shards_equal_single_device_and_stacked(name, args, k):
    wl = make_workload(name, MODEL_SIZE, **CPU)
    base = wl.sample_graph(random.Random(0), 1, **args)
    graphs = [permute_aux(base, s) for s in range(k)]
    ex = ShardedBucketedPlanExecutor(
        wl.impls, None, mesh=make_data_mesh(k, devices=cpus(k)), **CPU)
    results = ex.run_sharded(graphs, POLICY)
    assert ex.n_sharded_dispatches == 1 and ex.n_fallback_rounds == 0
    # the first placement reads the weights in place, the others copies
    assert [c.copy_weights for c in ex.card_executors] == \
        [False] + [True] * (k - 1)
    own = {id(t) for impl in wl.impls.values() for t in impl.params.values()}
    copies = ex.card_executors[1].weight_copies()
    assert set(copies) == own
    assert all(c.data_ptr() != t.data_ptr() for impl in wl.impls.values()
               for t in impl.params.values() for c in [copies[id(t)]])
    stacked = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=k,
                                          **CPU).run_sharded(graphs, POLICY)
    single = BucketedPlanExecutor(wl.impls, None, **CPU)
    jwl = jmake_workload(name, MODEL_SIZE)
    jbase = jwl.sample_graph(random.Random(0), 1, **args)
    jsingle = JBucketed(jwl.impls, None)
    for s, (g, res) in enumerate(zip(graphs, results)):
        assert res.shard == s and res.stacked is None
        assert_bit_equal(g, single.run(g, POLICY), res)
        assert_bit_equal(g, stacked[s], res)
        want = jsingle.run(permute_aux(jbase, s, graph_cls=JGraph,
                                       node_cls=JNode), JPolicy())
        for n in g.nodes:
            for f, v in res.node(n.id).items():
                np.testing.assert_allclose(np.asarray(want.node(n.id)[f]),
                                           v.numpy(), rtol=0, atol=1e-4)


def test_per_card_slot_pools_and_weight_updates_reach_every_card():
    """Each shard's R node reads its own card's pool (a ``PerCard`` nest);
    a weight updated in place is copied to every card again."""
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    nodes = []

    def add(t, inputs=(), aux=0):
        nodes.append(Node(id=len(nodes), type=t, inputs=tuple(inputs),
                          attrs={"aux": aux}))
        return len(nodes) - 1

    c = add("C", (add("R", aux=1), add("E", aux=7)))
    add("O", (c,))
    g = Graph(nodes)
    nrng = np.random.default_rng(0)
    pool = {f: PerCard(torch.as_tensor(nrng.standard_normal(
        (2, MODEL_SIZE)), dtype=torch.float32) for _ in range(3))
        for f in wl.state_fields}
    ex = ShardedBucketedPlanExecutor(
        wl.impls, None, mesh=make_data_mesh(3, devices=cpus(3)), **CPU)
    single = BucketedPlanExecutor(wl.impls, None, **CPU)
    for update in (True, False):
        results = ex.run_sharded([g] * 3, POLICY,
                                 shard_params={"slots": pool})
        for s, res in enumerate(results):
            mine = {f: v[s] for f, v in pool.items()}
            assert_bit_equal(g, single.run(g, POLICY,
                                           params={"slots": mine}), res)
            with pytest.raises(ValueError, match="per-card"):
                res.stacked_rows("y", [3])
        if update:
            wl.impls["O"].params["wo"].mul_(2.0)    # reaches every card
    pack = ex.pack_for(g, POLICY)
    sspec = replace(pack.spec, n_shards=3)
    assert ex.sharded_executable_ready(sspec, None, {"slots": pool})
    stacked = ShardedBucketedPlanExecutor(wl.impls, None, n_shards=3, **CPU)
    # a stacked K and a per-card K never share an entry
    assert ex.sharded_executable_key(sspec, None, {"slots": pool}) != \
        stacked.sharded_executable_key(sspec, None, {"slots": pool})


def test_diverging_signatures_fall_back_per_shard_on_their_own_devices():
    wl = make_workload("ChainLM", MODEL_SIZE, **CPU)
    graphs = [chain_graph(wl, 5), chain_graph(wl, 12), None,
              chain_graph(wl, 5, seed=3)]
    ex = ShardedBucketedPlanExecutor(
        wl.impls, None, mesh=make_data_mesh(4, devices=cpus(4)), **CPU)
    results = ex.run_sharded(graphs, POLICY)
    assert ex.n_fallback_rounds == 1 and ex.n_sharded_dispatches == 0
    assert results[2] is None
    ref = DynamicExecutor(wl.impls, None, **CPU)
    for g, res in zip(graphs, results):
        if g is not None:
            for n in g.nodes:
                for f, v in ref.run(g, POLICY).node(n.id).items():
                    torch.testing.assert_close(res.node(n.id)[f], v,
                                               rtol=0, atol=1e-5)
    # each shard that ran built its entry on its own placement
    placed = {key[3][1] for key in ex._exes
              if len(key) > 3 and key[3][:1] == ("placement",)}
    assert placed == {(0, "cpu"), (1, "cpu"), (3, "cpu")}
    assert ex.n_bucket_compiles == 3


# -- the per-card engine ------------------------------------------------------


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


def _serve(wls, n_shards, max_slots=12, trace=mixed_trace, **kw):
    eng = ServeEngine(dict(wls), max_slots=max_slots, n_shards=n_shards,
                      **CPU, **kw)
    reqs = trace(wls, tserve)
    eng.submit_many(reqs)
    stats = eng.run()
    eng.close()
    return reqs, stats, eng


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


@pytest.fixture(scope="module")
def runs(workloads):
    return {"k1": _serve(workloads, 1),
            "stacked2": _serve(workloads, 2),
            "cards2": _serve(workloads, 2, devices=cpus(2)),
            "cards3": _serve(workloads, 3, devices=cpus(3))}


@pytest.mark.parametrize("name", ["stacked2", "cards2", "cards3"])
def test_engine_outputs_do_not_depend_on_k_or_placement(runs, name):
    reqs, stats, eng = runs[name]
    _assert_same(reqs, runs["k1"][0])
    assert set(stats.tier_rounds) == {"sharded"}
    assert stats.n_sharded_dispatches > 0
    if name.startswith("cards"):
        k = eng.n_shards
        pools = eng._lm_pool()
        assert all(isinstance(v, PerCard) and len(v) == k
                   and all(t.shape == (12 // k, MODEL_SIZE) for t in v)
                   for v in pools.values())
        assert len({t.data_ptr() for v in pools.values() for t in v}) == \
            2 * k
        assert stats.n_graph_captures == 0     # the CPU runs eagerly


def test_per_card_engine_matches_the_reference_engine(runs):
    jwls = _workloads(jmake_workload)
    jeng = jserve.ServeEngine(dict(jwls), max_slots=12)
    jreqs = mixed_trace(jwls, jserve)
    jeng.submit_many(jreqs)
    jeng.run()
    _assert_same(runs["cards2"][0], jreqs, exact=False)


def test_one_replica_per_card_serves_through_the_sharded_path(workloads,
                                                              runs):
    reqs, stats, eng = _serve(workloads, 1, devices=cpus(1))
    _assert_same(reqs, runs["k1"][0])
    assert set(stats.tier_rounds) == {"sharded"} and eng.pipeline is False


def test_shrink_and_regrow_give_the_stacked_outputs(workloads):
    """A shard lost at round 3 and regrown at round 7: the dead card's
    rows evacuate into the survivors' pools, the regrown card starts from
    the initial state, and the outputs are the stacked placement's."""
    def lossy():
        return FaultInjector(shard_lost={3: 1}, shard_back_rounds=[7])

    want, _, st_eng = _serve(workloads, 2, fault_injector=lossy())
    got, _, eng = _serve(workloads, 2, devices=cpus(2),
                         fault_injector=lossy())
    _assert_same(got, want)
    assert [(e["old"], e["new"]) for e in eng.resize_log] == \
        [(2, 1), (1, 2)] == [(e["old"], e["new"])
                             for e in st_eng.resize_log]
    # each listed device's pool was made once and kept its address
    assert sorted(eng._card_pools) == [0, 1]
    for i, p in eng._card_pools.items():
        for f, t in p.items():
            assert eng._pool[f][i] is t


def steal_trace(wls, mod):
    return [mod.lm_request([i + 1, i + 2], 3 + (i % 3) * 2,
                           arrival=float(i)) for i in range(10)]


def test_work_stealing_gives_the_stacked_outputs(workloads):
    lm = {"lm": workloads["lm"]}
    want, wst, _ = _serve(lm, 2, max_slots=4, trace=steal_trace,
                          steal_threshold=0)
    got, gst, _ = _serve(lm, 2, max_slots=4, trace=steal_trace,
                         steal_threshold=0, devices=cpus(2))
    clean, _, _ = _serve(lm, 2, max_slots=4, trace=steal_trace,
                         devices=cpus(2))
    assert gst.n_entries_stolen == wst.n_entries_stolen >= 1
    _assert_same(got, want)
    _assert_same(got, clean)


@pytest.mark.parametrize("lose", [False, True])
def test_snapshot_and_restore_under_per_card_placement(workloads, runs,
                                                       lose):
    """A per-card engine's snapshot (on its full or shrunken mesh)
    restores into per-card pools and finishes with the uninterrupted
    outputs; the stacked engine's snapshot restores per card too (its
    rows name no card)."""
    for placement in ({"devices": cpus(2)}, {}):
        eng = ServeEngine(dict(workloads), max_slots=12, n_shards=2, **CPU,
                          **placement)
        reqs = mixed_trace(workloads, tserve)
        eng.submit_many(reqs)
        for _ in range(3):
            eng.step()
        if lose:
            eng.lose_shard(0)
        doc = snapshot_engine(eng)
        r = restore_engine(doc, dict(workloads), devices=cpus(2), **CPU)
        assert r.placement == "cards" and r.n_shards == (1 if lose else 2)
        assert r._excluded_devices == ([0] if lose else [])
        assert list(r._data_mesh().devices) == ([1] if lose else [0, 1])
        for f, v in eng._pool.items():
            got = torch.stack(list(r._pool[f]))
            want = torch.stack(list(v)) if isinstance(v, PerCard) else v
            assert torch.equal(got, want.reshape(got.shape))
        r.run()
        ledger = [r.requests[q.rid] for q in reqs]
        _assert_same(ledger, runs["k1"][0])


# -- the launcher -------------------------------------------------------------


def test_launcher_placement_cards_exits_with_the_mesh_error(capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["--device", "cpu", "--model-size", "8", "--devices",
                       "2", "--placement", "cards"])
    assert e.value.code == 2
    assert "need 2 devices for mesh {'data': 2}, found 0" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        launcher.main(["--device", "cpu", "--placement", "cards", "--plan",
                       "compiled"])

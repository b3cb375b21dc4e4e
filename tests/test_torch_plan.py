"""Port parity for ``core/plan.py``: the host lowering and bucket packing
reproduce the JAX package exactly (row tables, steps, aux permutation,
stats, bucket signature, index pack), and the per-topology and bucketed
executors match the JAX package within 1e-4, the reference's own
cross-tier bar (DESIGN.md §5).

Arenas are compared with each arena's trash row excluded: pad lanes all
scatter there, and which duplicate write wins is unspecified."""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as jbatching  # noqa: E402
from repro.core.executor import DynamicExecutor as JDynamicExecutor  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.graph import Node as JNode  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core import plan  # noqa: E402
from repro_torch.core.executor import DynamicExecutor, ExecStats  # noqa: E402
from repro_torch.core.graph import Graph, Node  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402

SIZE = 8
POLICIES = {
    "agenda": (jbatching.AgendaPolicy(), batching.AgendaPolicy()),
    "depth": (jbatching.depth_schedule, batching.depth_schedule),
    "sufficient": (jbatching.SufficientConditionPolicy(),
                   batching.SufficientConditionPolicy()),
}
JPOL, POL = POLICIES["sufficient"]


@pytest.fixture(scope="module")
def tagger():
    """(jax workload, jax graph, port workload, port graph)."""
    jwl = jmake_workload("BiLSTM-Tagger", SIZE, 0)
    wl = make_workload("BiLSTM-Tagger", SIZE, 0, device="cpu")
    args = dict(lo=4, hi=8)
    return (jwl, jwl.sample_graph(random.Random(0), 2, **args),
            wl, wl.sample_graph(random.Random(0), 2, **args))


@pytest.fixture(scope="module")
def jax_bucketed(tagger):
    """The reference bucketed run (fused Pallas kernel, interpret mode)."""
    jwl, jg, _, _ = tagger
    ex = jplan.BucketedPlanExecutor(jwl.impls, None, fused=True,
                                    fused_interpret=True)
    return ex.run(jg, JPOL), ex.pack_for(jg, JPOL)


def _chains(lengths, graph_cls, node_cls):
    nodes = []

    def add(type_, inputs=(), aux=0):
        nodes.append(node_cls(id=len(nodes), type=type_,
                              inputs=tuple(inputs), attrs={"aux": aux}))
        return len(nodes) - 1

    rng = random.Random(0)
    for L in lengths:
        prev = add("S")
        for _ in range(L):
            e = add("E", aux=rng.randrange(256))
            prev = add("C", (prev, e))
            add("O", (prev,))
    return graph_cls(nodes)


def _lowering_view(low):
    stats = low.stats.as_dict()
    for k in ("lower_time_s", "compile_time_s"):
        stats.pop(k)
    return (low.row_of, low.arena_rows, low.aux_perm.tolist(),
            [dataclasses.astuple(s) for s in low.steps], stats)


def assert_nodes_close(graph, want, got, tol=1e-4):
    for n in graph.nodes:
        a, b = want.node(n.id), got.node(n.id)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_allclose(
                b[f].numpy(), np.asarray(a[f]), rtol=tol, atol=tol,
                err_msg=f"node {n.id} ({n.type}) field {f}")


@pytest.mark.parametrize("layout", ["planned", "declaration"])
@pytest.mark.parametrize("pname", sorted(POLICIES))
def test_lower_schedule_identical(tagger, pname, layout):
    jwl, jg, wl, g = tagger
    jpol, pol = POLICIES[pname]
    jlow = jplan.lower_schedule(jg, jbatching.resolve_schedule(jg, jpol),
                                jwl.impls, layout=layout)
    low = plan.lower_schedule(g, batching.resolve_schedule(g, pol), wl.impls,
                              layout=layout)
    assert _lowering_view(low) == _lowering_view(jlow)


def test_chunked_lowering_identical():
    jwl = jmake_workload("ChainLM", SIZE, 0)
    wl = make_workload("ChainLM", SIZE, 0, device="cpu")
    jg, g = _chains((6, 6, 6), JGraph, JNode), _chains((6, 6, 6), Graph, Node)
    jlow = jplan.lower_schedule(jg, jbatching.resolve_schedule(jg, JPOL),
                                jwl.impls, max_pq_vars=24)
    low = plan.lower_schedule(g, batching.resolve_schedule(g, POL), wl.impls,
                              max_pq_vars=24)
    assert low.stats.layout == "pq-chunked" and low.stats.n_pq_chunks > 1
    assert _lowering_view(low) == _lowering_view(jlow)


@pytest.mark.parametrize("ladder", [None, (8,)])
@pytest.mark.parametrize("lengths", [(4,), (5,), (4, 7)])
def test_pack_bucketed_identical(lengths, ladder):
    jwl = jmake_workload("ChainLM", SIZE, 0)
    wl = make_workload("ChainLM", SIZE, 0, device="cpu")
    jg, g = _chains(lengths, JGraph, JNode), _chains(lengths, Graph, Node)
    jpack = jplan.pack_bucketed(
        jplan.lower_schedule(jg, jbatching.resolve_schedule(jg, JPOL),
                             jwl.impls), ladder=ladder)
    pack = plan.pack_bucketed(
        plan.lower_schedule(g, batching.resolve_schedule(g, POL), wl.impls),
        ladder=ladder, device="cpu")
    assert dataclasses.astuple(pack.spec) == dataclasses.astuple(jpack.spec)
    assert pack.idxpack.dtype == torch.int32
    np.testing.assert_array_equal(pack.idxpack.numpy(), jpack.idxpack_np)
    np.testing.assert_array_equal(pack.idxpack_np, jpack.idxpack_np)
    np.testing.assert_array_equal(pack.aux_perm, jpack.aux_perm)
    assert pack.row_of == jpack.row_of
    assert pack.stats.n_pad_steps == jpack.stats.n_pad_steps


@pytest.mark.parametrize("pname", sorted(POLICIES))
def test_plan_executor_matches_jax(tagger, pname):
    jwl, jg, wl, g = tagger
    jpol, pol = POLICIES[pname]
    want = JDynamicExecutor(jwl.impls, None).run(jg, jpol)
    for donate in (False, True):
        ex = plan.PlanExecutor(wl.impls, None, donate=donate, device="cpu")
        stats = ExecStats()
        for _ in range(2):
            got = ex.run(g, pol, stats)
        assert stats.n_launches == 2 and stats.n_compiles == 1
        assert_nodes_close(g, want, got)


def test_plan_executor_arenas_match_jax(tagger):
    jwl, jg, wl, g = tagger
    jres = jplan.PlanExecutor(jwl.impls, None).run(jg, JPOL)
    res = plan.PlanExecutor(wl.impls, None, device="cpu").run(g, POL)
    assert res.arenas.keys() == jres.arenas.keys()
    for key, arena in res.arenas.items():
        np.testing.assert_allclose(arena.numpy(), np.asarray(jres.arenas[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(key))


def _assert_arenas_match(res, jres, pack):
    rows_p = dict(pack.spec.arena_rows)
    idx = pack.idxpack_np
    off = 0
    for bs in pack.spec.steps:      # real output rows are unique
        off += bs.width * len(bs.in_arenas)
        for _, key in bs.out_arenas:
            lanes = idx[off:off + bs.width]
            real = lanes[lanes != rows_p[key] - 1]
            assert len(set(real.tolist())) == len(real)
            off += bs.width
    assert res.arenas.keys() == jres.arenas.keys()
    for key, arena in res.arenas.items():
        trash = rows_p[key] - 1
        np.testing.assert_allclose(arena.numpy()[:trash],
                                   np.asarray(jres.arenas[key])[:trash],
                                   rtol=1e-4, atol=1e-4, err_msg=str(key))


@pytest.mark.parametrize("kw", [dict(), dict(fused=False), dict(donate=True),
                                dict(fused=False, donate=True)],
                         ids=["fused", "unfused", "fused-donate",
                              "unfused-donate"])
def test_bucketed_matches_jax(tagger, jax_bucketed, kw):
    jwl, jg, wl, g = tagger
    jres, jpack = jax_bucketed
    ex = plan.BucketedPlanExecutor(wl.impls, None, device="cpu", **kw)
    stats = ExecStats()
    for _ in range(2):              # the second run reuses a donated pool
        res = ex.run(g, POL, stats)
    assert stats.n_launches == 2 and stats.n_compiles == 1
    pack = ex.pack_for(g, POL)
    assert dataclasses.astuple(pack.spec) == dataclasses.astuple(jpack.spec)
    assert_nodes_close(g, jres, res)
    _assert_arenas_match(res, jres, pack)


@pytest.mark.parametrize("fused", ["auto", False])
def test_bucketed_threaded_params_match_jax(tagger, fused):
    jwl, jg, wl, g = tagger
    rng = np.random.default_rng(7)
    jcell = jwl.cells["LSTMCell"]
    jparams = {"F": jcell.init_params(rng), "B": jcell.init_params(rng)}
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    want = JDynamicExecutor(jwl.impls, None).run(jg, JPOL, params=jparams)
    ex = plan.BucketedPlanExecutor(wl.impls, None, fused=fused, device="cpu")
    assert_nodes_close(g, want, ex.run(g, POL, params=params))
    # the baked weights still serve runs without threaded params
    assert_nodes_close(g, JDynamicExecutor(jwl.impls, None).run(jg, JPOL),
                       ex.run(g, POL))


def test_fused_weight_cache_follows_in_place_updates(tagger):
    """The gate-blocked weights are cached per parameter buffer; loading new
    weights in place must rebuild them."""
    _, _, _, g = tagger
    jwl1 = jmake_workload("BiLSTM-Tagger", SIZE, 1)
    wl = make_workload("BiLSTM-Tagger", SIZE, 0, device="cpu")
    ex = plan.BucketedPlanExecutor(wl.impls, None, device="cpu")
    ex.run(g, POL)
    arrays = {}
    for name in ("F", "B"):
        fn = jwl1.impls[name].apply
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        arrays[(name, "pbuf")] = np.asarray(cells["pbuf"].cell_contents)
    params_from_numpy(wl, arrays)
    jwl0 = jmake_workload("BiLSTM-Tagger", SIZE, 0)
    for name in ("F", "B"):
        jwl0.impls[name] = jwl1.impls[name]
    jg = jwl0.sample_graph(random.Random(0), 2, lo=4, hi=8)
    assert_nodes_close(g, JDynamicExecutor(jwl0.impls, None).run(jg, JPOL),
                       ex.run(g, POL))


def test_topologies_share_bucket_program():
    wl = make_workload("ChainLM", SIZE, 0, device="cpu")
    ex = plan.BucketedPlanExecutor(wl.impls, None, device="cpu")
    stats = ExecStats()
    for L in (5, 6, 7):
        g = _chains((L,), Graph, Node)
        ref = DynamicExecutor(wl.impls, None, device="cpu").run(g, POL)
        res = ex.run(g, POL, stats)
        for n in g.nodes:
            for f, v in ref.node(n.id).items():
                torch.testing.assert_close(res.node(n.id)[f], v,
                                           rtol=1e-5, atol=1e-5)
    assert ex.n_bucket_compiles == 1 and stats.n_compiles == 1
    assert len(ex._packs) == 3


def test_in_flight_dispatch_blocks_once(tagger):
    _, _, wl, g = tagger
    ex = plan.BucketedPlanExecutor(wl.impls, None, device="cpu")
    pack = ex.pack_for(g, POL)
    stats = ExecStats()
    handle = ex.dispatch_packed(g, pack, stats)
    assert handle.pending
    res = handle.block()
    assert not handle.pending and handle.block() is res
    assert stats.n_launches == 1
    assert ex.executable_ready(pack, None)

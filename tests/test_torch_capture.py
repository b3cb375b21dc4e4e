"""The port's per-topology ``CompiledPlan`` over its static buffers
(``repro_torch.core.plan``, captured on the card by the rules of
``repro_torch.core.capture``) against the JAX package's jitted
``CompiledPlan`` on the CPU, where the port runs the same body eagerly:

- two graphs of one topology with different aux values through one plan:
  arenas within 1e-4 of the reference's (DESIGN.md §5), host artifacts
  (row table, steps, aux permutation, stats, the aux operand) exact, one
  build for both;
- the executable key follows what a graph reads: the threaded tensors'
  pointers, the weights' pointers and versions; ``capture=False`` and a
  run that autograd records key apart;
- an entry whose derived copies are stale is built again;
- undonated runs return arenas of their own, donated ones the pool.
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as jbatching  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.graph import Node as JNode  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core import plan  # noqa: E402
from repro_torch.core.executor import ExecStats  # noqa: E402
from repro_torch.core.graph import Graph, Node  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402

SIZE = 8
JPOL, POL = (jbatching.SufficientConditionPolicy(),
             batching.SufficientConditionPolicy())


def _reaux(graph, graph_cls, node_cls, seed: int):
    """``graph``'s topology with other aux values (E nodes' token ids)."""
    rng = random.Random(seed)
    return graph_cls([node_cls(id=n.id, type=n.type, inputs=n.inputs,
                               attrs={**n.attrs, "aux": rng.randrange(256)}
                               if "aux" in n.attrs else dict(n.attrs))
                      for n in graph.nodes])


@pytest.fixture(scope="module")
def two_graphs():
    """(jax workload, jax graphs, port workload, port graphs): a tagger
    minibatch and the same topology with other tokens."""
    jwl = jmake_workload("BiLSTM-Tagger", SIZE, 0)
    wl = make_workload("BiLSTM-Tagger", SIZE, 0, device="cpu")
    args = dict(lo=4, hi=8)
    jg = jwl.sample_graph(random.Random(0), 2, **args)
    g = wl.sample_graph(random.Random(0), 2, **args)
    jgs = [jg, _reaux(jg, JGraph, JNode, 1)]
    gs = [g, _reaux(g, Graph, Node, 1)]
    assert gs[0].topology_key() == gs[1].topology_key()
    assert [n.attrs for n in gs[1].nodes] == [n.attrs for n in jgs[1].nodes]
    assert [n.attrs for n in gs[0].nodes] != [n.attrs for n in gs[1].nodes]
    return jwl, jgs, wl, gs


def _lowering_view(p):
    stats = p.stats.as_dict()
    for k in ("lower_time_s", "compile_time_s"):
        stats.pop(k)
    return (p.row_of, p.arena_rows, p.aux_perm.tolist(),
            [dataclasses.astuple(s) for s in p.steps], stats)


@pytest.mark.parametrize("capture", [True, False])
@pytest.mark.parametrize("donate", [False, True])
def test_static_aux_plan_matches_jax_on_one_topology(two_graphs, donate,
                                                     capture):
    jwl, jgs, wl, gs = two_graphs
    jex = jplan.PlanExecutor(jwl.impls, None, donate=donate)
    ex = plan.PlanExecutor(wl.impls, None, donate=donate, device="cpu",
                           capture=capture)
    stats = ExecStats()
    for jg, g in zip(jgs, gs):
        jres = jex.run(jg, JPOL)
        res = ex.run(g, POL, stats)
        assert res.arenas.keys() == jres.arenas.keys()
        for key, arena in res.arenas.items():
            np.testing.assert_allclose(
                arena.numpy(), np.asarray(jres.arenas[key]), rtol=1e-4,
                atol=1e-4, err_msg=str(key))
        p, jp = ex.plan_for(g, POL), jex.plan_for(jg, JPOL)
        entry = p._exes.peek(p.executable_key(None))
        assert entry.graph is None                   # no card here
        np.testing.assert_array_equal(entry.aux.numpy(),
                                      np.asarray(jp._aux_flat(jg)))
    assert _lowering_view(p) == _lowering_view(jp)
    assert p is ex.plan_for(gs[0], POL)              # one plan, one build
    assert p.stats.n_compiles == jp.stats.n_compiles == 1
    assert (stats.n_launches, stats.n_compiles) == (2, 1)
    assert ex.n_captures == ex.n_replays == 0


def test_executable_key_follows_what_a_graph_reads(two_graphs):
    _, _, wl, gs = two_graphs
    p = plan.PlanExecutor(wl.impls, None, device="cpu").plan_for(gs[0], POL)
    eager = plan.PlanExecutor(wl.impls, None, device="cpu",
                              capture=False).plan_for(gs[0], POL)
    key = p.executable_key(None)
    assert key[-3] == "static" and eager.executable_key(None)[-1] == "eager"
    name, impl = next((n, i) for n, i in wl.impls.items() if i.params)
    field = sorted(impl.params)[0]
    weight = impl.params[field]
    weight.mul_(1.0)                                 # a version, same data
    assert p.executable_key(None) != key
    moved = p.executable_key(None)
    impl.params[field] = weight.clone()              # another tensor
    try:
        assert p.executable_key(None) not in (key, moved)
    finally:
        impl.params[field] = weight
    assert p.executable_key(None) == moved
    threaded = {name: {field: weight.clone()}}
    other = {name: {field: weight.clone()}}
    assert p.executable_key(threaded) != p.executable_key(other)
    trained = {name: {field: weight.clone().requires_grad_(True)}}
    assert p.executable_key(trained)[-1] == "recording"
    with torch.no_grad():
        assert p.executable_key(trained)[-3] == "static"


def test_stale_plan_entry_is_built_again(two_graphs):
    _, _, wl, gs = two_graphs
    ex = plan.PlanExecutor(wl.impls, None, device="cpu")
    ex.run(gs[0], POL)
    p = ex.plan_for(gs[0], POL)
    entry = p._exes.peek(p.executable_key(None))
    buf = torch.zeros(3)
    entry.sources = [(buf, buf._version)]
    assert entry.current()
    ex.run(gs[1], POL)
    assert p._exes.peek(p.executable_key(None)) is entry
    buf.add_(1.0)
    assert not entry.current()
    want = ex.run(gs[1], POL)
    rebuilt = p._exes.peek(p.executable_key(None))
    assert rebuilt is not entry and rebuilt.current()
    assert p.stats.n_compiles == 2
    again = plan.PlanExecutor(wl.impls, None, device="cpu").run(gs[1], POL)
    for key, arena in want.arenas.items():
        assert torch.equal(arena, again.arenas[key])


@pytest.mark.parametrize("donate", [False, True])
def test_undonated_results_are_copies(two_graphs, donate):
    _, _, wl, gs = two_graphs
    ex = plan.PlanExecutor(wl.impls, None, donate=donate, device="cpu")
    first = ex.run(gs[0], POL)
    kept = {k: v.clone() for k, v in first.arenas.items()}
    second = ex.run(gs[1], POL)
    shared = [first.arenas[k].data_ptr() == second.arenas[k].data_ptr()
              for k in kept]
    if donate:
        assert all(shared)
    else:
        assert not any(shared)
        assert all(torch.equal(first.arenas[k], v) for k, v in kept.items())
    assert any(not torch.equal(second.arenas[k], v) for k, v in kept.items())

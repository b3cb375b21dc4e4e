"""Port workloads against the JAX package: bit-identical parameters from the
same seed, weights carried across with ``params_from_numpy``, and the
interpreted executor's per-node outputs under all four batching policies."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as jbatching  # noqa: E402
from repro.core.executor import DynamicExecutor as JDynamicExecutor  # noqa: E402
from repro.core.rl import RLConfig as JRLConfig  # noqa: E402
from repro.core.rl import train_fsm as jtrain_fsm  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.executor import DynamicExecutor  # noqa: E402
from repro_torch.core.rl import RLConfig, train_fsm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.workloads import (CHAIN_WORKLOADS,  # noqa: E402
                                          LATTICE_WORKLOADS, TREE_WORKLOADS,
                                          make_workload)

NAMES = CHAIN_WORKLOADS + ["ChainLM"]
SIZE = 8
GRAPH_ARGS = dict(lo=4, hi=7)


def jax_arrays(jwl) -> dict:
    """The reference's weights, read out of its impl closures."""
    out = {}
    for name, impl in jwl.impls.items():
        fn = impl.apply
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
            if var in ("pbuf", "table", "wo", "bo"):
                out[(name, var)] = np.asarray(cell.cell_contents)
    return out


def port_arrays(wl) -> dict:
    return {(name, k): v.numpy() for name, impl in wl.impls.items()
            for k, v in impl.params.items()}


def assert_nodes_close(graph, want, got, tol=1e-4):
    for n in graph.nodes:
        a, b = want.node(n.id), got.node(n.id)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_allclose(
                b[f].numpy(), np.asarray(a[f]), rtol=tol, atol=tol,
                err_msg=f"node {n.id} ({n.type}) field {f}")


@pytest.mark.parametrize("name", NAMES)
def test_parameters_bit_identical(name):
    want = jax_arrays(jmake_workload(name, SIZE, 3))
    got = port_arrays(make_workload(name, SIZE, 3, device="cpu"))
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def _policies(jwl, wl):
    graphs = [(jwl.sample_graph(random.Random(s), 2, **GRAPH_ARGS),
               wl.sample_graph(random.Random(s), 2, **GRAPH_ARGS))
              for s in (11, 12)]
    jfsm = jtrain_fsm([j for j, _ in graphs], JRLConfig(max_iters=150, seed=0))
    fsm = train_fsm([t for _, t in graphs], RLConfig(max_iters=150, seed=0))
    assert fsm.policy.q == jfsm.policy.q
    return {
        "agenda": (jbatching.AgendaPolicy(), batching.AgendaPolicy()),
        "depth": (jbatching.depth_schedule, batching.depth_schedule),
        "sufficient": (jbatching.SufficientConditionPolicy(),
                       batching.SufficientConditionPolicy()),
        "fsm": (jfsm.policy, fsm.policy),
    }


@pytest.mark.parametrize("name", NAMES)
def test_interpreted_matches_jax_under_all_policies(name):
    jwl = jmake_workload(name, SIZE, 0)
    wl = make_workload(name, SIZE, 0, device="cpu")
    jg = jwl.sample_graph(random.Random(0), 2, **GRAPH_ARGS)
    g = wl.sample_graph(random.Random(0), 2, **GRAPH_ARGS)
    assert g.topology_key() == jg.topology_key()
    for pname, (jpol, pol) in _policies(jwl, wl).items():
        assert (batching.resolve_schedule(g, pol)
                == jbatching.resolve_schedule(jg, jpol)), pname
        want = JDynamicExecutor(jwl.impls, None).run(jg, jpol)
        got = DynamicExecutor(wl.impls, None, device="cpu").run(g, pol)
        assert_nodes_close(g, want, got)


def test_weights_carried_across():
    """Seed-0 reference weights loaded into a seed-1 port workload give the
    reference's seed-0 outputs."""
    name = "BiLSTM-Tagger"
    jwl = jmake_workload(name, SIZE, 0)
    wl = make_workload(name, SIZE, 1, device="cpu")
    arrays = jax_arrays(jwl)
    assert not all(np.array_equal(port_arrays(wl)[k], v)
                   for k, v in arrays.items())
    params_from_numpy(wl, arrays)
    got_arrays = port_arrays(wl)
    for key, want in arrays.items():
        np.testing.assert_array_equal(got_arrays[key], want)
    g = wl.sample_graph(random.Random(5), 2, **GRAPH_ARGS)
    jg = jwl.sample_graph(random.Random(5), 2, **GRAPH_ARGS)
    assert_nodes_close(
        g, JDynamicExecutor(jwl.impls, None).run(
            jg, jbatching.SufficientConditionPolicy()),
        DynamicExecutor(wl.impls, None, device="cpu").run(
            g, batching.SufficientConditionPolicy()))


def test_params_from_numpy_rejects_unknown_and_misshapen():
    wl = make_workload("ChainLM", SIZE, 0, device="cpu")
    with pytest.raises(KeyError):
        params_from_numpy(wl, {("C", "table"): np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        params_from_numpy(wl, {("E", "table"): np.zeros((3, 3), np.float32)})


@pytest.mark.parametrize("name", TREE_WORKLOADS + LATTICE_WORKLOADS)
def test_trees_and_lattices_wait_for_their_slice(name):
    with pytest.raises(NotImplementedError, match="later|slice"):
        make_workload(name, SIZE, device="cpu")


def test_chainlm_resume_reads_threaded_slots():
    """``R`` nodes gather a request's state out of the threaded slot pool."""
    wl = make_workload("ChainLM", SIZE, 0, device="cpu")
    from repro_torch.core.graph import Graph, Node

    g = Graph([Node(id=0, type="R", attrs={"aux": 2}),
               Node(id=1, type="E", attrs={"aux": 7}),
               Node(id=2, type="C", inputs=(0, 1)),
               Node(id=3, type="O", inputs=(2,))])
    slots = wl.init_slots(4)
    slots["h_out"][2] = 1.0
    slots["c_out"][2] = -1.0
    res = DynamicExecutor(wl.impls, None, device="cpu").run(
        g, batching.SufficientConditionPolicy(), params={"slots": slots})
    assert torch.equal(res.node(0)["h_out"], slots["h_out"][2])
    assert torch.equal(res.node(0)["c_out"], slots["c_out"][2])
    assert torch.isfinite(res.node(3)["y"]).all()


def test_embed_and_affine_impls_match_jax():
    import jax.numpy as jnp

    from repro.core.executor import affine_impl as jaffine_impl
    from repro.core.executor import embed_impl as jembed_impl
    from repro_torch.core.executor import affine_impl, embed_impl

    rng = np.random.default_rng(4)
    table = rng.standard_normal((10, 6)).astype(np.float32)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    aux = np.asarray([9, 0, 9, 4], np.int32)
    got = embed_impl("E", torch.from_numpy(table)).apply(
        None, [], torch.from_numpy(aux))["h"]
    want = jembed_impl("E", jnp.asarray(table)).apply(None, [],
                                                      jnp.asarray(aux))["h"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = affine_impl("A", torch.from_numpy(w), torch.from_numpy(b)).apply(
        None, [torch.from_numpy(x)], None)["h"]
    want = jaffine_impl("A", jnp.asarray(w), jnp.asarray(b)).apply(
        None, [jnp.asarray(x)], None)["h"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

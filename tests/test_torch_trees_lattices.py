"""Port parity for the tree and lattice workloads (TreeLSTM, TreeGRU,
MV-RNN, TreeLSTM-2Type, LatticeLSTM, LatticeGRU) against the JAX package:
bit-identical parameters and graphs from the same seeds, identical
schedules and batch counts under every policy, the interpreted executor's
outputs within 1e-4 (the reference's cross-tier bar, DESIGN.md §5), and
for the serve families' defaults (TreeLSTM, LatticeLSTM) identical host
lowerings and bucket packs and per-topology and bucketed outputs within
1e-4 of the reference's. Also the dense fused LSTM cell against the
reference's Pallas kernel in interpret mode, and the trees-and-lattices
phase of ``chip_smoke.py`` at small width.

Graphs stay as small as ``tests/test_plan.py``'s (4-6 leaves, 6-10
characters): joint PQ planning of mid-sized graphs takes minutes on the
host, in both packages."""

import dataclasses
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batching as jbatching  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.executor import DynamicExecutor as JDynamicExecutor  # noqa: E402
from repro.core.rl import RLConfig as JRLConfig  # noqa: E402
from repro.core.rl import train_fsm as jtrain_fsm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import batching, plan  # noqa: E402
from repro_torch.core.executor import DynamicExecutor, ExecStats  # noqa: E402
from repro_torch.core.graph import validate_schedule  # noqa: E402
from repro_torch.core.rl import RLConfig, train_fsm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.workloads import (LATTICE_WORKLOADS,  # noqa: E402
                                          SERVE_FAMILIES, TREE_WORKLOADS,
                                          WORKLOADS, make_workload)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 8
NAMES = TREE_WORKLOADS + LATTICE_WORKLOADS
GRAPH_ARGS = {name: (dict(lo=6, hi=10) if name in LATTICE_WORKLOADS
                     else dict(leaves_lo=4, leaves_hi=6)) for name in NAMES}
# The reference's own RL budgets (tests/test_workloads.py).
RL_ITERS = {name: 800 if name in LATTICE_WORKLOADS else 600 for name in NAMES}
PLANNED = ["TreeLSTM", "LatticeLSTM"]
# The arrays the reference's impl closures hold, by closure variable name.
ARRAY_NAMES = ("pbuf", "table", "wo", "bo", "w", "b", "vec", "mat")


def jax_arrays(jwl) -> dict:
    out = {}
    for name, impl in jwl.impls.items():
        fn = impl.apply
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
            if var in ARRAY_NAMES:
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


def _graphs(jwl, wl, name, seed, batch=2):
    return (jwl.sample_graph(random.Random(seed), batch, **GRAPH_ARGS[name]),
            wl.sample_graph(random.Random(seed), batch, **GRAPH_ARGS[name]))


@pytest.fixture(scope="module")
def setups():
    """name -> (jax workload, port workload, {policy: (jax, port)}, (jax
    graph, port graph)). As in the reference's Fig. 9 tests, the FSMs learn
    on three 2-instance graphs and the graph is the next 8-instance draw of
    the same generator (seed 2 for trees, 3 for lattices)."""
    out = {}
    for name in NAMES:
        jwl, wl = jmake_workload(name, SIZE, 0), make_workload(
            name, SIZE, 0, device="cpu")
        seed = 3 if name in LATTICE_WORKLOADS else 2
        jrng, rng = random.Random(seed), random.Random(seed)
        jfsm = jtrain_fsm([jwl.sample_graph(jrng, 2) for _ in range(3)],
                          JRLConfig(max_iters=RL_ITERS[name]))
        fsm = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                        RLConfig(max_iters=RL_ITERS[name]))
        assert fsm.iters == jfsm.iters
        assert fsm.policy.q == jfsm.policy.q
        out[name] = (jwl, wl, {
            "agenda": (jbatching.AgendaPolicy(), batching.AgendaPolicy()),
            "depth": (jbatching.depth_schedule, batching.depth_schedule),
            "sufficient": (jbatching.SufficientConditionPolicy(),
                           batching.SufficientConditionPolicy()),
            "fsm": (jfsm.policy, fsm.policy),
        }, (jwl.sample_graph(jrng, 8), wl.sample_graph(rng, 8)))
    return out


def test_registry_builds_every_workload():
    assert SERVE_FAMILIES == {"lm": "ChainLM", "tree": "TreeLSTM",
                              "lattice": "LatticeLSTM"}
    for name in WORKLOADS + ["ChainLM"]:
        assert make_workload(name, SIZE, device="cpu").impls


@pytest.mark.parametrize("name", NAMES)
def test_parameters_bit_identical(name):
    want = jax_arrays(jmake_workload(name, SIZE, 3))
    got = port_arrays(make_workload(name, SIZE, 3, device="cpu"))
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


@pytest.mark.parametrize("name", NAMES)
def test_sample_graph_identical(name):
    jwl = jmake_workload(name, SIZE, 0)
    wl = make_workload(name, SIZE, 0, device="cpu")
    for seed, batch in ((0, 2), (5, 8)):
        jg = jwl.sample_graph(random.Random(seed), batch)
        g = wl.sample_graph(random.Random(seed), batch)
        assert [(n.id, n.type, n.inputs, n.attrs) for n in g.nodes] == \
            [(n.id, n.type, n.inputs, n.attrs) for n in jg.nodes]


@pytest.mark.parametrize("name", NAMES)
def test_schedules_identical_under_all_policies(setups, name):
    """The counterpart of the reference's Fig. 9 tests
    (``tests/test_workloads.py``): the same 8-instance graph gets the same
    schedule, hence the same batch count, under every policy, and the FSM
    holds the reference's claims."""
    jwl, wl, policies, (jg, g) = setups[name]
    counts = {}
    for pname, (jpol, pol) in policies.items():
        sched = batching.resolve_schedule(g, pol)
        validate_schedule(g, sched)
        assert sched == jbatching.resolve_schedule(jg, jpol), pname
        counts[pname] = len(sched)
    assert counts["fsm"] < counts["depth"]
    if name in LATTICE_WORKLOADS:
        assert counts["depth"] / counts["fsm"] > 1.3
    elif name != "TreeLSTM-2Type":
        assert counts["fsm"] == g.batch_lower_bound()
        assert counts["fsm"] <= counts["agenda"]
    else:
        assert counts["fsm"] <= round(1.35 * counts["agenda"])


@pytest.mark.parametrize("name", NAMES)
def test_interpreted_matches_jax_under_all_policies(setups, name):
    jwl, wl, policies, _ = setups[name]
    jg, g = _graphs(jwl, wl, name, 0)
    assert g.topology_key() == jg.topology_key()
    jex = JDynamicExecutor(jwl.impls, None)
    ex = DynamicExecutor(wl.impls, None, device="cpu")
    for pname, (jpol, pol) in policies.items():
        want = jex.run(jg, jpol)
        assert_nodes_close(g, want, ex.run(g, pol))


@pytest.mark.parametrize("name", NAMES)
def test_weights_carried_across(name):
    """Seed-0 reference weights loaded into a seed-1 port workload give the
    reference's seed-0 outputs: every array name of the new impls (the
    tree head's w/b, MV-RNN's vec/mat, the lattice head's wo) is carried."""
    jwl = jmake_workload(name, SIZE, 0)
    wl = make_workload(name, SIZE, 1, device="cpu")
    arrays = jax_arrays(jwl)
    params_from_numpy(wl, arrays)
    got = port_arrays(wl)
    assert got.keys() == arrays.keys()
    for key, want in arrays.items():
        np.testing.assert_array_equal(got[key], want)
    jg, g = _graphs(jwl, wl, name, 5)
    pol, jpol = (batching.SufficientConditionPolicy(),
                 jbatching.SufficientConditionPolicy())
    assert_nodes_close(g, JDynamicExecutor(jwl.impls, None).run(jg, jpol),
                       DynamicExecutor(wl.impls, None, device="cpu").run(g, pol))


def _lowering_view(low):
    stats = low.stats.as_dict()
    for k in ("lower_time_s", "compile_time_s"):
        stats.pop(k)
    return (low.row_of, low.arena_rows, low.aux_perm.tolist(),
            [dataclasses.astuple(s) for s in low.steps], stats)


@pytest.mark.parametrize("pname", ["agenda", "depth", "sufficient", "fsm"])
@pytest.mark.parametrize("name", PLANNED)
def test_lower_schedule_identical(setups, name, pname):
    jwl, wl, policies, _ = setups[name]
    jpol, pol = policies[pname]
    jg, g = _graphs(jwl, wl, name, 0)
    jlow = jplan.lower_schedule(jg, jbatching.resolve_schedule(jg, jpol),
                                jwl.impls)
    low = plan.lower_schedule(g, batching.resolve_schedule(g, pol), wl.impls)
    assert _lowering_view(low) == _lowering_view(jlow)


@pytest.mark.parametrize("ladder", [None, (8,)])
@pytest.mark.parametrize("name", PLANNED)
def test_pack_bucketed_identical(setups, name, ladder):
    jwl, wl, policies, _ = setups[name]
    jpol, pol = policies["fsm"]
    jg, g = _graphs(jwl, wl, name, 1)
    jpack = jplan.pack_bucketed(
        jplan.lower_schedule(jg, jbatching.resolve_schedule(jg, jpol),
                             jwl.impls), ladder=ladder)
    pack = plan.pack_bucketed(
        plan.lower_schedule(g, batching.resolve_schedule(g, pol), wl.impls),
        ladder=ladder, device="cpu")
    assert dataclasses.astuple(pack.spec) == dataclasses.astuple(jpack.spec)
    np.testing.assert_array_equal(pack.idxpack.numpy(), jpack.idxpack_np)
    np.testing.assert_array_equal(pack.aux_perm, jpack.aux_perm)
    assert pack.row_of == jpack.row_of
    assert pack.stats.as_dict() == jpack.stats.as_dict() | {
        "lower_time_s": pack.stats.lower_time_s,
        "compile_time_s": pack.stats.compile_time_s}


@pytest.mark.parametrize("name", PLANNED)
def test_plan_executor_matches_jax(setups, name):
    jwl, wl, policies, _ = setups[name]
    jpol, pol = policies["fsm"]
    jg, g = _graphs(jwl, wl, name, 0)
    jres = jplan.PlanExecutor(jwl.impls, None).run(jg, jpol)
    ex = plan.PlanExecutor(wl.impls, None, donate=True, device="cpu")
    stats = ExecStats()
    for _ in range(2):
        res = ex.run(g, pol, stats)
    assert stats.n_launches == 2 and stats.n_compiles == 1
    assert_nodes_close(g, jres, res)
    assert res.arenas.keys() == jres.arenas.keys()
    for key, arena in res.arenas.items():
        np.testing.assert_allclose(arena.numpy(), np.asarray(jres.arenas[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(key))


@pytest.mark.parametrize("fused", ["auto", False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", PLANNED)
def test_bucketed_matches_jax(setups, name, fused):
    """Against the reference's bucketed run with its fused Pallas cell in
    interpret mode; arenas compared with the trash row excluded (pad lanes
    all scatter there, and the winner of duplicate writes is unspecified)."""
    jwl, wl, policies, _ = setups[name]
    jpol, pol = policies["fsm"]
    jg, g = _graphs(jwl, wl, name, 0)
    jex = jplan.BucketedPlanExecutor(jwl.impls, None, fused=True,
                                     fused_interpret=True)
    jres, jpack = jex.run(jg, jpol), jex.pack_for(jg, jpol)
    ex = plan.BucketedPlanExecutor(wl.impls, None, fused=fused, donate=True,
                                   device="cpu")
    for _ in range(2):              # the second run reuses the donated pool
        res = ex.run(g, pol)
    pack = ex.pack_for(g, pol)
    assert dataclasses.astuple(pack.spec) == dataclasses.astuple(jpack.spec)
    assert_nodes_close(g, jres, res)
    rows_p = dict(pack.spec.arena_rows)
    idx, off = pack.idxpack_np, 0
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


# (B, K, H, block_m, block_n, block_k): tests/test_kernels.py's shapes and
# one of benchmarks/table5_cortex_proxy.py's (B = 16, K = 2H).
@pytest.mark.parametrize("B,K,H,bm,bn,bk", [
    (8, 64, 32, 8, 16, 32),
    (4, 32, 32, 4, 32, 16),
    (16, 128, 64, 8, 32, 64),
    (16, 256, 128, 128, 128, 128),
])
def test_fused_lstm_cell_matches_pallas(B, K, H, bm, bn, bk):
    rng = np.random.default_rng(B + K + H)
    xh = rng.standard_normal((B, K)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, 4 * H))).astype(np.float32)
    b = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
    c = rng.standard_normal((B, H)).astype(np.float32)
    want = jops.fused_lstm_cell(*(jnp.asarray(a) for a in (xh, w, b, c)),
                                block_m=bm, block_n=bn, block_k=bk,
                                interpret=True)
    got = ops.fused_lstm_cell(*(torch.from_numpy(a) for a in (xh, w, b, c)),
                              block_m=bm, block_n=bn, block_k=bk)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)


def test_ops_names_the_port_wrappers():
    from repro_torch.kernels import (flash_attention, fused_cell,
                                     fused_gather_cell, gather_batch, ssd_scan)

    assert sorted(ops.__all__) == ["flash_attention", "fused_gather_lstm_cell",
                                   "fused_lstm_cell", "gather_rows",
                                   "ssd_scan"]
    assert all(callable(getattr(jops, n)) for n in ops.__all__)
    assert ops.flash_attention is flash_attention.flash_attention
    assert ops.fused_gather_lstm_cell is fused_gather_cell.fused_gather_lstm_cell
    assert ops.gather_rows is gather_batch.gather_rows
    assert ops.ssd_scan is ssd_scan.ssd_scan
    before = fused_cell.fused_lstm_cell.launches
    xh, w, b, c = torch.ones(2, 6), torch.ones(6, 8), torch.ones(8), \
        torch.ones(2, 2)
    for got, want in zip(ops.fused_lstm_cell(xh, w, b, c, block_m=8),
                         fused_cell.fused_lstm_cell(xh, w, b, c)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_cell.fused_lstm_cell.launches == before   # CPU: plain


def test_dense_cell_on_gathered_rows_is_the_gather_cell():
    rng = np.random.default_rng(1)
    B, E, H, n = 8, 16, 16, 20
    x, h, c = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
               for d in (E, H, H))
    w = torch.from_numpy((0.1 * rng.standard_normal((E + H, 4 * H)))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(4 * H)).astype(np.float32))
    ix, ih, ic = (torch.from_numpy(rng.integers(-n, n, B).astype(np.int32))
                  for _ in range(3))
    dense = ops.fused_lstm_cell(torch.cat([x[ix], h[ih]], dim=1), w, b, c[ic])
    gathered = ops.fused_gather_lstm_cell(x, h, c, ix, ih, ic, w, b)
    for d, g_ in zip(dense, gathered):
        torch.testing.assert_close(d, g_, rtol=0, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_trees_lattices_phase_runs_on_cpu(name):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rl_iters, run = smoke.TREES_LATTICES[name]
    report = smoke.run_slice("cpu", name, model_size=SIZE, batch=2,
                             rl_iters=rl_iters, graph_args=GRAPH_ARGS[name],
                             **dict(run, timed_reps=1))
    assert report["max_abs_err_executors"] <= 1e-4
    assert report["max_abs_err_any_vs_cpu"] <= 1e-4
    assert set(report["ms_per_run"]) == set(run["executors"])
    assert report["n_batches"] > 0

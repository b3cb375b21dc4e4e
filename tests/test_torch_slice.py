"""The port's batched-execution path as a whole, on the CPU at small width,
against the JAX package: the same graphs from the same seed, an FSM
learned on both sides (identical Q-table and schedules), and the outputs of
the interpreted, per-topology and bucketed executors within 1e-4 of the
reference's. Also runs the slice function that ``chip_smoke.py`` drives on
the card."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jplan  # noqa: E402
from repro.core.batching import resolve_schedule as jresolve  # noqa: E402
from repro.core.executor import DynamicExecutor as JDynamicExecutor  # noqa: E402
from repro.core.rl import RLConfig as JRLConfig  # noqa: E402
from repro.core.rl import train_fsm as jtrain_fsm  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import plan  # noqa: E402
from repro_torch.core.batching import resolve_schedule  # noqa: E402
from repro_torch.core.executor import DynamicExecutor  # noqa: E402
from repro_torch.core.rl import RLConfig, train_fsm  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE = 16
ARGS = dict(lo=4, hi=8)


@pytest.fixture(scope="module")
def slice_setup():
    jwl = jmake_workload("BiLSTM-Tagger", SIZE, 0)
    wl = make_workload("BiLSTM-Tagger", SIZE, 0, device="cpu")
    jrng, rng = random.Random(0), random.Random(0)
    jtrain = [jwl.sample_graph(jrng, 2, **ARGS) for _ in range(3)]
    train = [wl.sample_graph(rng, 2, **ARGS) for _ in range(3)]
    jfsm = jtrain_fsm(jtrain, JRLConfig(max_iters=600, seed=0))
    fsm = train_fsm(train, RLConfig(max_iters=600, seed=0))
    jgraphs = [jwl.sample_graph(jrng, 2, **ARGS) for _ in range(2)]
    graphs = [wl.sample_graph(rng, 2, **ARGS) for _ in range(2)]
    return jwl, wl, jfsm, fsm, jgraphs, graphs


def test_fsm_learned_identically(slice_setup):
    _, _, jfsm, fsm, jgraphs, graphs = slice_setup
    assert fsm.iters == jfsm.iters
    assert fsm.policy.q == jfsm.policy.q
    assert fsm.policy.fingerprint() == jfsm.policy.fingerprint()
    for jg, g in zip(jgraphs, graphs):
        assert g.topology_key() == jg.topology_key()
        assert (resolve_schedule(g, fsm.policy)
                == jresolve(jg, jfsm.policy))


def test_three_executors_match_jax(slice_setup):
    jwl, wl, jfsm, fsm, jgraphs, graphs = slice_setup
    jexecs = [JDynamicExecutor(jwl.impls, None),
              jplan.PlanExecutor(jwl.impls, None, donate=True),
              jplan.BucketedPlanExecutor(jwl.impls, None, fused=True,
                                         fused_interpret=True)]
    execs = [DynamicExecutor(wl.impls, None, device="cpu"),
             plan.PlanExecutor(wl.impls, None, donate=True, device="cpu"),
             plan.BucketedPlanExecutor(wl.impls, None, device="cpu")]
    for jg, g in zip(jgraphs + jgraphs[:1], graphs + graphs[:1]):
        want = jexecs[0].run(jg, jfsm.policy)
        ids = list(want.nodes_with_field("y"))
        y_want = np.asarray(want.field("y", ids))
        for jex, ex in zip(jexecs, execs):
            np.testing.assert_allclose(
                np.asarray(jex.run(jg, jfsm.policy).field("y", ids)), y_want,
                rtol=1e-5, atol=1e-5)
            got = ex.run(g, fsm.policy)
            assert list(got.nodes_with_field("y")) == ids
            np.testing.assert_allclose(got.field("y", ids).numpy(), y_want,
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=type(ex).__name__)
            for n in g.nodes:
                for f, v in want.node(n.id).items():
                    np.testing.assert_allclose(
                        got.node(n.id)[f].numpy(), np.asarray(v),
                        rtol=1e-4, atol=1e-4)


def test_chip_smoke_slice_runs_on_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    report = smoke.run_slice("cpu", model_size=SIZE, batch=2, n_fresh=2,
                             timed_reps=1, graph_args=ARGS)
    assert report["max_abs_err_executors"] <= 1e-4
    assert report["max_abs_err_vs_cpu"] == 0.0
    assert set(report["ms_per_run"]) == {"interpreted", "per_topology",
                                         "per_topology_eager", "bucketed"}
    assert report["max_abs_err_replay_vs_eager"] == 0.0
    assert report["plan_stats"]["n_steps"] == report["n_batches"]

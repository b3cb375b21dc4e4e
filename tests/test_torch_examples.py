"""The port's main-path examples (``examples/quickstart_torch.py``,
``lattice_ner_torch.py``, ``serve_batched_torch.py``) on the CPU against
the same calls through the JAX package: batch counts, cell and plan
statistics, and served request, token, round and batch counts must be
equal. The JAX examples themselves are not run (their XLA compiles take
minutes); their host-side calls are, and the serve walkthrough at a small
size through both engines."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.batching import SufficientConditionPolicy as JSufficient  # noqa: E402
from repro.core.batching import agenda_schedule as jagenda  # noqa: E402
from repro.core.batching import depth_schedule as jdepth  # noqa: E402
from repro.core.batching import schedule as jschedule  # noqa: E402
from repro.core.plan import PlanExecutor as JPlanExecutor  # noqa: E402
from repro.core.rl import RLConfig as JRLConfig  # noqa: E402
from repro.core.rl import train_fsm as jtrain_fsm  # noqa: E402
from repro.models.workloads import SERVE_FAMILIES as JFAMILIES  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve import PolicyRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMES = ("lower_time_s", "compile_time_s", "n_compiles")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _y_nodes(wl, g) -> int:
    return sum("y" in wl.impls[n.type].out_fields for n in g.nodes)


def test_quickstart_matches_the_reference(capsys):
    got = _example("quickstart_torch").run(torch.device("cpu"))
    out = capsys.readouterr().out
    rng = random.Random(0)
    jwl = jmake_workload("TreeLSTM", model_size=64)
    res = jtrain_fsm([jwl.sample_graph(rng, 2) for _ in range(3)],
                     JRLConfig(max_iters=600))
    g = jwl.sample_graph(rng, 16)
    assert (got["rl_iters"], got["reached_lower_bound"]) == \
        (res.iters, res.reached_lower_bound)
    assert (got["nodes"], got["lower_bound"]) == \
        (len(g), g.batch_lower_bound())
    assert got["batches"] == {"depth": len(jdepth(g)),
                              "agenda": len(jagenda(g)),
                              "fsm": len(jschedule(g, res.policy))}
    assert got["n_predictions"] == _y_nodes(jwl, g) and got["finite"]
    assert got["cells"] == {
        name: (c.stats.n_batches, c.stats.n_mem_kernels,
               c.zero_copy_fraction()) for name, c in jwl.cells.items()}
    jstats = JPlanExecutor(jwl.impls, None).plan_for(
        g, res.policy).stats.as_dict()
    mine = got["plan_stats"]
    assert {k: v for k, v in mine.items() if k not in TIMES} == \
        {k: v for k, v in jstats.items() if k not in TIMES}
    # one build, then one eager pass a run on the CPU
    assert got["dispatches"] == got["n_launches"] == 1
    assert got["n_captures"] == 0 and got["matches_interpreted"]
    assert f"-> 1 device dispatch, {mine['n_slice_reads']} slice" in out


def test_lattice_ner_matches_the_reference(capsys):
    got = _example("lattice_ner_torch").run(torch.device("cpu"))
    assert "char tags; exec" in capsys.readouterr().out
    rng = random.Random(7)
    jwl = jmake_workload("LatticeLSTM", model_size=64)
    res = jtrain_fsm([jwl.sample_graph(rng, 2) for _ in range(4)],
                     JRLConfig(max_iters=1000))
    g = jwl.sample_graph(rng, 16)
    assert got["rl_iters"] == res.iters and got["nodes"] == len(g)
    fsm = len(jschedule(g, res.policy))
    assert got["batches"] == {
        "depth": len(jdepth(g)), "agenda": len(jagenda(g)),
        "sufficient-condition": len(jschedule(g, JSufficient())),
        "learned FSM": fsm}
    assert got["n_tags"] == _y_nodes(jwl, g)
    assert got["n_batches_run"] == 2 * fsm


COUNTS = ("requests_done", "tokens_out", "n_rounds", "n_batches",
          "n_launches")


def test_serve_batched_matches_the_reference(tmp_path):
    """The walkthrough at 6 requests of 3 new tokens, width 8: the trained
    FSM and both disciplines' served counts equal the reference engine's
    on the same trace."""
    args = dict(requests=6, max_new=3, model_size=8)
    ex = _example("serve_batched_torch")
    results, res = ex.main(["--device", "cpu", "--requests",
                            str(args["requests"]), "--max-new",
                            str(args["max_new"]), "--model-size",
                            str(args["model_size"])])
    jwls = {f: jmake_workload(JFAMILIES[f], args["model_size"])
            for f in ("lm", "tree", "lattice")}
    rng = random.Random(0)
    jres = jtrain_fsm([jwls["lm"].sample_graph(rng, 2, lo=4, hi=8)
                       for _ in range(3)], JRLConfig(max_iters=200))
    assert (res.best_batches, res.lower_bound) == \
        (jres.best_batches, jres.lower_bound)
    registry = JRegistry(str(tmp_path))
    registry.save_result("lm", jres)
    for label, kw in (("continuous+compiled",
                       dict(compiled=True, continuous=True)),
                      ("wave+interpreted",
                       dict(compiled=False, continuous=False))):
        eng = JServeEngine(jwls, registry=registry, max_slots=8, **kw)
        reqs = jsynth_trace(["lm", "lm", "tree", "lattice"], args["requests"],
                            2.0, args["max_new"], jwls, 0, tree_leaves=(4, 7),
                            lattice_chars=(5, 9))
        eng.submit_many(reqs)
        jstats = eng.run()
        stats = results[label]
        assert {f: getattr(stats, f) for f in COUNTS} == \
            {f: getattr(jstats, f) for f in COUNTS}, label
        assert stats.requests_done == args["requests"]
        assert np.isfinite(stats.tok_per_s)

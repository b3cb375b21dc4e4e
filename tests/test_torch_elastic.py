"""The port's elastic K-shard serve engine against the reference's, on the
CPU.

The reference's multi-shard scenarios (``tests/test_resilience.py``: shard
loss with evacuation, parked entries resuming their streams, work
stealing, a crash restored on a shrunken mesh that then grows back) run
once through the JAX package in a subprocess that sees four forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), and in
this process through the port, whose K replicas share the CPU. Each run
reports its host artifacts: the resize log, evacuated, parked and stolen
counts, the per-round slot assignments, terminal statuses, tokens, the
tree and lattice outputs and the per-shard ``ServeStats`` fields that hold
no times. They must be equal, floats within 1e-4. The same subprocess
restores two checkpoints the port wrote (at K = 2, and on a mesh shrunk to
one replica) and writes two of its own, which the port restores: each
restored run finishes with the writer's uninterrupted outputs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MODEL_SIZE = 8
FAMILIES = ["lm", "tree", "lattice"]
# Graphs small enough to stay out of the joint PQ planner's slow window.
SIZES = dict(tree_leaves=(3, 5), lattice_chars=(4, 6))
# ServeStats fields that hold times (or samples of them), left out of the
# comparison.
TIMED = {"wall_s", "schedule_s", "lower_s", "lower_bg_s", "exec_s",
         "latency_s", "ttft_s"}
# Engine-level fields compared between the packages.
ENGINE_FIELDS = ("n_rounds", "n_batches", "n_launches", "tokens_out",
                 "outputs_out", "requests_done", "requests_failed",
                 "n_shards", "n_sharded_dispatches", "n_shard_fallback_rounds",
                 "n_resize_events", "n_entries_evacuated", "n_entries_stolen",
                 "n_checkpoints", "n_restores", "tier_rounds", "shard_tokens")


class _Pkg:
    """One package's serve stack, imported by name (``repro`` or
    ``repro_torch``); the port's runs are asked for the CPU."""

    def __init__(self, name: str):
        import importlib

        self.name = name
        self.serve = importlib.import_module(f"{name}.serve")
        self.faults = importlib.import_module(f"{name}.serve.faults")
        self.workloads_mod = importlib.import_module(
            f"{name}.models.workloads")
        self.kw = {"device": "cpu"} if name == "repro_torch" else {}
        self.wls = {fam: self.workloads_mod.make_workload(
            self.workloads_mod.SERVE_FAMILIES[fam], MODEL_SIZE, **self.kw)
            for fam in FAMILIES}

    def engine(self, families=FAMILIES, **kw):
        return self.serve.ServeEngine(
            {f: self.wls[f] for f in families}, compiled=True, bucketed=True,
            continuous=True, max_slots=4, n_shards=2, **self.kw, **kw)

    def restore(self, path, **kw):
        return self.serve.ServeEngine.restore(path, dict(self.wls),
                                              **self.kw, **kw)

    def trace(self, n=10, seed=5):
        reqs = self.serve.synth_trace(FAMILIES, n, 3.0, 3, self.wls, seed,
                                      **SIZES)
        for r in reqs:
            r.deadline = r.arrival + 500.0
        return reqs

    def lm(self, prompt, max_new, arrival):
        return self.serve.lm_request(prompt, max_new, arrival=arrival)


def _stats_doc(st) -> dict:
    return {f: getattr(st, f) for f in st.__dataclass_fields__
            if f not in TIMED}


def _report(eng, slots=None) -> dict:
    """An engine's host artifacts after its run (requests by position in
    rid order: two processes draw different rids)."""
    led = [eng.requests[rid] for rid in sorted(eng.requests)]
    eng._fold_exec_stats()
    return {
        "resize_log": list(eng.resize_log),
        "excluded": list(eng._excluded_devices),
        "n_shards": eng.n_shards,
        "engine": {f: getattr(eng.stats, f) for f in ENGINE_FIELDS},
        "shards": [_stats_doc(p) for p in eng._shard_stats],
        "retired": [_stats_doc(p) for p in eng._retired_shard_stats],
        "statuses": [r.status for r in led],
        "tokens": [list(r.out) for r in led],
        "results": [None if r.result is None
                    else np.asarray(r.result).tolist() for r in led],
        "slots": slots,
    }


def _run(eng, reqs=None) -> dict:
    """Run ``eng`` to the end (submitting ``reqs``), recording the slot
    assignment table after every round."""
    if reqs is not None:
        eng.submit_many(reqs)
    pos = {rid: i for i, rid in enumerate(sorted(eng.requests))}
    slots = []
    step = eng.step

    def recorded():
        step()
        slots.append(sorted([pos[rid], s, sl] for rid, (s, sl)
                            in eng.scheduler.slot_of.items()))

    eng.step = recorded
    eng.run()
    return _report(eng, slots)


def _crash(eng, reqs) -> None:
    eng.submit_many(reqs)
    try:
        eng.run()
    except Exception as exc:
        assert "injected process crash" in str(exc)
    else:
        raise AssertionError("the injected crash did not happen")
    eng.close()


def scenarios(pkg_name: str, tmp: str, foreign: dict | None = None) -> dict:
    """The multi-shard scenarios through one package: their reports, the
    checkpoints it wrote (paths), and the reports of restoring the other
    package's checkpoints in ``foreign``."""
    pkg = _Pkg(pkg_name)
    FI = pkg.faults.FaultInjector
    latest = pkg.serve.latest_checkpoint
    out, ckpts = {}, {}

    out["clean_mixed"] = _run(pkg.engine(), pkg.trace())
    out["shard_loss"] = _run(pkg.engine(fault_injector=FI(shard_lost={3: 1})),
                             pkg.trace())

    def parked_trace():
        return [pkg.lm([i + 1, i + 2, i + 3], 6, float(i // 4))
                for i in range(8)]

    out["clean_parked"] = _run(pkg.engine(["lm"]), parked_trace())
    out["parked"] = _run(pkg.engine(["lm"],
                                    fault_injector=FI(shard_lost={4: 1})),
                         parked_trace())

    def steal_trace():
        return [pkg.lm([i + 1, i + 2], 3 + (i % 3) * 2, float(i))
                for i in range(10)]

    out["clean_steal"] = _run(pkg.engine(["lm"]), steal_trace())
    out["steal"] = _run(pkg.engine(["lm"], steal_threshold=0), steal_trace())

    # a crash on a mesh shrunk to one replica, restored, then regrown
    d = os.path.join(tmp, f"{pkg_name}_shrunk")
    out["clean_shrunk"] = _run(pkg.engine(), pkg.trace(seed=7))
    eng = pkg.engine(fault_injector=FI(shard_lost={3: 0}, crash_rounds=[5]),
                     checkpoint_dir=d, checkpoint_every=2)
    _crash(eng, pkg.trace(seed=7))
    ckpts["shrunk"] = latest(d)
    r_eng = pkg.restore(ckpts["shrunk"],
                        fault_injector=FI(shard_back_rounds=[7]))
    out["restored_shrunk_mesh"] = {"n_shards": r_eng.n_shards,
                                   "excluded": list(r_eng._excluded_devices)}
    out["shrunk"] = _run(r_eng)

    # a crash at K = 2, restored at K = 2
    d = os.path.join(tmp, f"{pkg_name}_k2")
    eng = pkg.engine(fault_injector=FI(crash_rounds=[4]), checkpoint_dir=d)
    _crash(eng, pkg.trace(seed=3))
    ckpts["k2"] = latest(d)
    out["clean_k2"] = _run(pkg.engine(), pkg.trace(seed=3))

    for name, path in (foreign or {}).items():
        kw = {"fault_injector": FI(shard_back_rounds=[7])} \
            if name == "shrunk" else {}
        out[f"foreign_{name}"] = _run(pkg.restore(path, **kw))
    return {"reports": out, "checkpoints": ckpts}


# -- the two packages ---------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's scenarios in this process, then the reference's in one
    subprocess with four forced host devices, which also restores the
    port's checkpoints; finally the port restores the reference's."""
    tmp = str(tmp_path_factory.mktemp("elastic"))
    port = scenarios("repro_torch", tmp)
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "import test_torch_elastic as t\n"
            f"out = t.scenarios('repro', {tmp!r}, "
            f"{port['checkpoints']!r})\n"
            "print('REPORT ' + json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("REPORT "))
    ref = json.loads(line[len("REPORT "):])
    pkg = _Pkg("repro_torch")
    foreign = {}
    for name, path in ref["checkpoints"].items():
        kw = {"fault_injector": pkg.faults.FaultInjector(
            shard_back_rounds=[7])} if name == "shrunk" else {}
        foreign[name] = _run(pkg.restore(path, **kw))
    return {"port": port["reports"], "ref": ref["reports"],
            "port_restores_ref": foreign}


def _assert_same(got: dict, want: dict, label: str) -> None:
    """Host artifacts equal, floats within 1e-4. The per-shard stats are
    compared on the reference's fields; the port's own are its CUDA-graph
    counts."""
    for key in ("resize_log", "excluded", "n_shards", "engine", "statuses",
                "tokens", "slots"):
        assert got[key] == want[key], (label, key, got[key], want[key])
    for key in ("shards", "retired"):
        assert len(got[key]) == len(want[key]), (label, key)
        for a, b in zip(got[key], want[key]):
            assert set(a) - set(b) == {"n_graph_captures", "n_graph_replays"}
            assert {f: a[f] for f in b} == b, (label, key, a, b)
    assert len(got["results"]) == len(want["results"])
    for a, b in zip(got["results"], want["results"]):
        assert (a is None) == (b is None), label
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-4, err_msg=label)


SCENARIOS = ["clean_mixed", "shard_loss", "clean_parked", "parked",
             "clean_steal", "steal", "clean_shrunk", "shrunk", "clean_k2"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_matches_reference_k_shard_engine(runs, name):
    _assert_same(runs["port"][name], runs["ref"][name], name)


def test_scenarios_exercise_the_elastic_paths(runs):
    """What the reference's own tests assert of these runs holds for the
    port: one shrink at round 3 that evacuates, parked entries, at least
    one steal, the restored engine on the shrunken mesh regrowing, and
    every run equal to its clean counterpart."""
    p = runs["port"]
    ev = p["shard_loss"]["resize_log"][0]
    assert (ev["old"], ev["new"], ev["round"]) == (2, 1, 3)
    assert p["shard_loss"]["engine"]["n_entries_evacuated"] == \
        ev["evacuated"] + ev["parked"]
    assert p["parked"]["resize_log"][0]["parked"] >= 1
    assert p["steal"]["engine"]["n_entries_stolen"] >= 1
    assert p["restored_shrunk_mesh"] == runs["ref"]["restored_shrunk_mesh"]
    assert p["restored_shrunk_mesh"]["n_shards"] == 1
    assert p["restored_shrunk_mesh"]["excluded"]
    assert p["shrunk"]["n_shards"] == 2 and not p["shrunk"]["excluded"]
    for run, clean in (("shard_loss", "clean_mixed"),
                       ("parked", "clean_parked"), ("steal", "clean_steal"),
                       ("shrunk", "clean_shrunk")):
        assert all(s == "COMPLETED" for s in p[run]["statuses"])
        assert p[run]["tokens"] == p[clean]["tokens"], run
        for a, b in zip(p[run]["results"], p[clean]["results"]):
            assert a == b, run


@pytest.mark.parametrize("name,clean", [("k2", "clean_k2"),
                                        ("shrunk", "clean_shrunk")])
@pytest.mark.parametrize("direction", ["port_restores_ref", "ref_restores_port"])
def test_checkpoints_restore_across_packages(runs, direction, name, clean):
    """A K = 2 checkpoint, and one taken on a mesh shrunk to one replica,
    written by one package and restored by the other: the restored run
    finishes with the writer's uninterrupted outputs (tokens equal, tree
    and lattice outputs within 1e-4)."""
    if direction == "port_restores_ref":
        got, want = runs["port_restores_ref"][name], runs["ref"][clean]
    else:
        got, want = runs["ref"][f"foreign_{name}"], runs["port"][clean]
    assert all(s == "COMPLETED" for s in got["statuses"])
    assert got["statuses"] == want["statuses"]
    assert got["tokens"] == want["tokens"]
    for a, b in zip(got["results"], want["results"]):
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-4)
    assert got["engine"]["n_restores"] == 1
    if name == "shrunk":
        assert got["n_shards"] == 2 and not got["excluded"]

"""The port's serve launcher (``python -m repro_torch.launch.serve``) on the
CPU at model size 8: its defaults (bucketed plans, async compile,
pipelined continuous rounds, one device) give the JAX engine's tokens; an
injected crash exits 1 and ``--restore`` finishes with an uninterrupted
run's outputs; the warm set round-trips through ``--cache-dir``;
``--devices 2`` is refused; ``--legacy-arch`` serves one wave; importing
the launcher loads no jax; and ``--perf-profile`` re-execs the process at
most once (``launch/env.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.models.workloads import SERVE_FAMILIES as JFAMILIES  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.launch import env  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.cache import load_warmset  # noqa: E402
from repro_torch.serve.queue import COMPLETED  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--model-size", "8"]


def _ledger(eng):
    return [eng.requests[rid] for rid in sorted(eng.requests)]


def test_defaults_serve_every_request(tmp_path, capsys):
    out = tmp_path / "stats.json"
    assert launcher.main(CPU + ["--out", str(out)]) == 0
    stats = json.loads(out.read_text())
    assert stats["requests_done"] == 24 and stats["requests_failed"] == 0
    assert stats["compile_jobs_landed"] >= 1 and stats["lower_s"] == 0.0
    assert set(stats["tier_rounds"]) <= {"bucketed", "coarse", "interpreted"}
    printed = capsys.readouterr().out
    assert "24 requests" in printed and "compile: " in printed


def test_defaults_give_the_reference_engines_tokens():
    """The launcher's engine (async, pipelined) against the JAX engine the
    reference launcher builds, on the same trace and seeded weights."""
    args = launcher.parse_args(CPU + ["--families", "lm", "--requests", "8"])
    code, eng = launcher.serve(args)
    assert code == 0
    wls = {"lm": jmake_workload(JFAMILIES["lm"], 8, 0)}
    reqs = jserve.synth_trace(["lm"], 8, 4.0, 12, wls, 0)
    jeng = jserve.ServeEngine(wls, max_slots=16)
    jeng.submit_many(reqs)
    jeng.run()
    got = _ledger(eng)
    assert [r.status for r in got] == [COMPLETED] * 8
    assert [r.out for r in got] == [r.out for r in _ledger(jeng)]


def test_crash_then_restore_finishes_the_run(tmp_path):
    base = CPU + ["--families", "lm,tree", "--requests", "8"]
    clean = launcher.serve(launcher.parse_args(base))[1]
    ckpt = str(tmp_path / "ckpt")
    assert launcher.main(base + ["--checkpoint-dir", ckpt,
                                 "--inject-faults", "crash=4"]) == 1
    assert os.listdir(ckpt)
    code, eng = launcher.serve(launcher.parse_args(base + ["--restore",
                                                           ckpt]))
    assert code == 0 and eng.stats.n_restores == 1
    got, want = _ledger(eng), _ledger(clean)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.status == b.status == COMPLETED
        if a.family == "lm":
            assert a.out == b.out
        else:
            np.testing.assert_allclose(a.result, b.result, rtol=0, atol=1e-6)


def test_warm_set_round_trips_through_the_cache_dir(tmp_path, capsys):
    cache = str(tmp_path / "cache")
    base = CPU + ["--families", "lm", "--requests", "6", "--warm-start",
                  "--cache-dir", cache]
    assert launcher.main(base) == 0
    ws = load_warmset(cache)
    assert ws["families"]["lm"]["counts"]
    capsys.readouterr()
    assert launcher.main(base) == 0
    assert "warm-start: pre-submitted" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launcher.parse_args(CPU + ["--warm-start", "--no-async-compile"])


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--steal-threshold", "1"]],
                         ids=["devices", "steal_threshold"])
def test_sharded_flags_are_refused(flags, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(CPU + flags)
    assert e.value.code == 2
    assert "sharding slice" in capsys.readouterr().err


def test_legacy_arch_serves_one_wave(capsys):
    assert launcher.main(CPU + ["--legacy-arch", "qwen2-0.5b",
                                "--requests", "2", "--max-new", "2"]) == 0
    assert "[legacy qwen2-0.5b] 2 requests, 4 tokens" in \
        capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="training slice"):
        launcher.main(CPU + ["--legacy-arch", "qwen2-0.5b",
                             "--checkpoint", "w.npz"])


def test_import_loads_no_jax():
    code = ("import sys\nimport repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def clean_env(monkeypatch):
    """The variables the profile sets, put back after the test."""
    for name in ("REPRO_TORCH_PERF_PROFILE", "LD_PRELOAD",
                 "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"):
        monkeypatch.setenv(name, "")
    return monkeypatch


def test_perf_profile_reexecs_at_most_once(clean_env):
    monkeypatch = clean_env
    monkeypatch.setattr(env, "find_tcmalloc", lambda: "/lib/libtcmalloc.so.4")
    calls = []
    monkeypatch.setattr(env.os, "execv", lambda *a: calls.append(a))
    env.apply_perf_profile()
    assert len(calls) == 1
    assert os.environ["LD_PRELOAD"] == "/lib/libtcmalloc.so.4"
    # the re-exec'd process (marker set, tcmalloc preloaded) goes on
    prof = env.apply_perf_profile()
    monkeypatch.setenv("LD_PRELOAD", "")
    env.apply_perf_profile()             # the marker alone stops a second
    assert len(calls) == 1
    assert prof["applied"] and prof["tcmalloc"]
    assert not any("xla" in k or "jax" in k for k in prof)


def test_perf_profile_without_tcmalloc_runs_in_place(clean_env):
    monkeypatch = clean_env
    monkeypatch.setattr(env, "find_tcmalloc", lambda: None)
    monkeypatch.setattr(env.os, "execv",
                        lambda *a: pytest.fail("re-exec without tcmalloc"))
    prof = env.apply_perf_profile()
    assert prof["applied"] and not prof["tcmalloc"]

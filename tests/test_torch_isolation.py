"""The PyTorch port stands alone: importing ``repro_torch`` loads neither jax
nor the JAX package, no port file imports either, the framework-free host
modules stay copies of their ``repro`` originals (same code, same text but
for at most one docstring line), and entry points
raise instead of falling back to the CPU when CUDA is absent and no device
was given."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# Framework-free modules the port copies instead of importing.
VERBATIM = ["core/graph.py", "core/cache.py", "core/batching.py",
            "core/encodings.py", "core/rl.py", "core/pqtree.py",
            "core/memplan.py", "models/data.py", "obs/tracer.py",
            "obs/metrics.py", "obs/flight.py", "obs/__init__.py",
            "serve/queue.py", "serve/traces.py", "serve/registry.py",
            "serve/checkpoint.py", "serve/faults.py", "serve/scheduler.py",
            "serve/compiler.py", "arch/config.py"] + sorted(
    str(p.relative_to(ROOT / "src" / "repro"))
    for p in (ROOT / "src" / "repro" / "configs").glob("*.py"))


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _code(source: str) -> str:
    """The module's code without its docstrings: a copy may reword a
    docstring that speaks of the reference's own history."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_in_step(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    copy = (PORT / rel).read_text().replace("repro_torch.", "repro.")
    assert _code(copy) == _code(original)
    differing = [(a, b) for a, b in zip(copy.splitlines(),
                                        original.splitlines()) if a != b]
    assert len(copy.splitlines()) == len(original.splitlines())
    assert len(differing) <= 1, differing


# The reference's ``launch/jaxcache.py`` functions that ``launch/cache.py``
# copies (the XLA cache itself has no counterpart).
CACHE_FUNCTIONS = ["QUARANTINE_SUBDIR", "WARMSET_NAME", "warmset_path",
                   "load_warmset", "save_warmset", "audit_cache_dir"]


def _definitions(path: Path) -> dict:
    """Top-level functions and assignments of a module, by name, as
    ``_code`` dumps them."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out[node.targets[0].id] = node
    return {name: _code(ast.unparse(node)) for name, node in out.items()}


@pytest.mark.parametrize("name", CACHE_FUNCTIONS)
def test_cache_functions_copied_unchanged(name):
    original = _definitions(ROOT / "src" / "repro" / "launch" / "jaxcache.py")
    copy = _definitions(PORT / "launch" / "cache.py")
    assert copy[name] == original[name]
    assert "enable_compilation_cache" not in copy


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import BucketedPlanExecutor, PlanExecutor
    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import engine as serve_engine
    from repro_torch.launch.serve import main as launch_serve
    from repro_torch.serve.lm_wave import ServeEngine, serve_wave

    cfg = get_config("qwen2-0.5b").reduced(d_model=32)

    def engine():
        # a model built for the CPU, but the engine itself asked for no device
        model = TransformerLM(cfg, device="cpu")
        return ServeEngine(model, model.init_params(torch.Generator()))

    return {
        "make_workload": lambda: make_workload("BiLSTM-Tagger", 8),
        "make_workload tree": lambda: make_workload("MV-RNN", 8),
        "make_workload lattice": lambda: make_workload("LatticeLSTM", 8),
        "DynamicExecutor": lambda: DynamicExecutor({}, None),
        "PlanExecutor": lambda: PlanExecutor({}, None),
        "BucketedPlanExecutor": lambda: BucketedPlanExecutor({}, None),
        "TransformerLM": lambda: TransformerLM(get_config("qwen2-0.5b")),
        "ServeEngine": engine,
        "serve_wave": lambda: serve_wave(TransformerLM(cfg, device="cpu"), {},
                                         [[1, 2]]),
        "serve engine": lambda: serve_engine.ServeEngine(),
        "serve launcher": lambda: launch_serve(["--model-size", "8",
                                                "--requests", "1"]),
    }


@pytest.mark.parametrize("name", ["make_workload", "make_workload tree",
                                  "make_workload lattice", "DynamicExecutor",
                                  "PlanExecutor", "BucketedPlanExecutor",
                                  "TransformerLM", "ServeEngine",
                                  "serve_wave", "serve engine",
                                  "serve launcher"])
def test_entry_points_default_to_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_explicit_cpu_device_is_honoured(no_cuda):
    from repro_torch.models.workloads import make_workload

    wl = make_workload("BiLSTM-Tagger", 8, device="cpu")
    assert wl.device == torch.device("cpu")
    assert all(t.device.type == "cpu"
               for impl in wl.impls.values() for t in impl.params.values())


def test_explicit_cpu_device_is_honoured_by_the_lm_server(no_cuda):
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.serve.lm_wave import ServeEngine

    model = TransformerLM(get_config("mamba2-130m").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    devices = set()
    tree_map(lambda t: devices.add(t.device.type), params)
    assert model.device == torch.device("cpu") and devices == {"cpu"}
    outs, _ = ServeEngine(model, params, cache_len=32,
                          device="cpu").generate([[1] * 16], max_new=2)
    assert len(outs[0]) == 2


def _run_smoke(cwd: Path, script: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

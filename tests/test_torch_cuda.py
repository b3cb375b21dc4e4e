"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_gather_cell import \
    fused_gather_lstm_cell  # noqa: E402
from repro_torch.kernels.gather_batch import gather_rows  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype,k", [
    ((2048, 512), torch.float32, 256),
    ((512, 17), torch.float32, 100),
    ((300, 4, 24), torch.float32, 77),
    ((1000, 512), torch.bfloat16, 64),
    ((257, 33), torch.float16, 40),
])
def test_gather_kernel_bit_equal(cuda, shape, dtype, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn(shape, generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, shape[0], (k,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[: k // 4] = idx[0]
    before = gather_rows.launches
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


def test_gather_kernel_negative_indices_count_from_the_end(cuda):
    src = torch.randn((50, 33), device=cuda)
    idx = torch.tensor([-1, -50, 0, 49, -7], dtype=torch.int32, device=cuda)
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(src, idx))
    assert torch.equal(out[0], src[49]) and torch.equal(out[1], src[0])


# An index outside [-N, N) fails a device-side assert, which leaves the
# process's CUDA context unusable, so each case runs in a process of its own.
_OUT_OF_RANGE = {
    "gather too large": "gather_rows(torch.zeros((8, 4), device='cuda'), "
                        "i32([8]))",
    "gather too negative": "gather_rows(torch.zeros((8, 4), device='cuda'), "
                           "i32([-9]))",
    "fused ix": "cell(i32([16]), i32([0]), i32([0]))",
    "fused ih": "cell(i32([0]), i32([-17]), i32([0]))",
    "fused ic": "cell(i32([0]), i32([0]), i32([16]))",
}
_OUT_OF_RANGE_PRELUDE = """
import torch
from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell
from repro_torch.kernels.gather_batch import gather_rows

def i32(v):
    return torch.tensor(v, dtype=torch.int32, device='cuda')

def cell(ix, ih, ic):
    z = torch.zeros((16, 8), device='cuda')
    return fused_gather_lstm_cell(z, z, z, ix, ih, ic,
                                  torch.zeros((16, 32), device='cuda'),
                                  torch.zeros((32,), device='cuda'))

"""


@pytest.mark.parametrize("case", sorted(_OUT_OF_RANGE))
def test_kernels_raise_on_an_index_out_of_range(cuda, case):
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (_OUT_OF_RANGE_PRELUDE + _OUT_OF_RANGE[case]
            + "\ntorch.cuda.synchronize()\nprint('NO ERROR')\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode != 0, proc.stdout
    assert "NO ERROR" not in proc.stdout
    assert "device-side assert" in proc.stderr, proc.stderr[-2000:]


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((8, 4), device=cuda)
    idx = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gather_rows(src, idx.long())                 # int64 indices
    with pytest.raises(ValueError):
        gather_rows(src.t(), idx)                    # not contiguous
    with pytest.raises(ValueError):
        gather_rows(src, idx.cpu())                  # indices on the host


def _inputs(B, E, H, n, device):
    rng = np.random.default_rng(B)
    arrays = [rng.standard_normal((n, E)), rng.standard_normal((n, H)),
              rng.standard_normal((n, H)), rng.integers(0, n, B),
              rng.integers(0, n, B), rng.integers(0, n, B),
              0.05 * rng.standard_normal((E + H, 4 * H)),
              0.1 * rng.standard_normal(4 * H)]
    return [torch.as_tensor(a, dtype=torch.int32 if i in (3, 4, 5)
                            else torch.float32, device=device)
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("B,E,H", [(1, 512, 512), (16, 512, 512),
                                   (32, 512, 512), (7, 24, 20)])
def test_fused_kernel_within_1e4(cuda, B, E, H):
    args = _inputs(B, E, H, 600, cuda)
    before = fused_gather_lstm_cell.launches
    h2, c2 = fused_gather_lstm_cell(*args)
    hr, cr = ref.fused_gather_lstm_cell_ref(*args)
    torch.cuda.synchronize()
    assert fused_gather_lstm_cell.launches == before + 1
    assert float((h2 - hr).abs().max()) <= 1e-4
    assert float((c2 - cr).abs().max()) <= 1e-4


def test_fused_kernel_duplicate_and_pad_lanes(cuda):
    args = _inputs(6, 64, 64, 4, cuda)
    args[3] = torch.tensor([0, 0, 0, 3, 3, 3], dtype=torch.int32, device=cuda)
    args[4] = torch.tensor([1, 1, 2, 2, 3, 3], dtype=torch.int32, device=cuda)
    args[5] = torch.tensor([0, 1, 2, 3, 3, 3], dtype=torch.int32, device=cuda)
    h2, c2 = fused_gather_lstm_cell(*args)
    hr, cr = ref.fused_gather_lstm_cell_ref(*args)
    torch.cuda.synchronize()
    assert float((h2 - hr).abs().max()) <= 1e-4
    assert float((c2 - cr).abs().max()) <= 1e-4


def test_fused_kernel_negative_indices_count_from_the_end(cuda):
    args = _inputs(4, 64, 64, 10, cuda)
    args[3] = torch.tensor([-1, -10, 0, 9], dtype=torch.int32, device=cuda)
    args[4] = torch.tensor([-2, 3, -10, -1], dtype=torch.int32, device=cuda)
    args[5] = torch.tensor([-10, -1, 4, -3], dtype=torch.int32, device=cuda)
    h2, c2 = fused_gather_lstm_cell(*args)
    hr, cr = ref.fused_gather_lstm_cell_ref(*args)
    torch.cuda.synchronize()
    assert float((h2 - hr).abs().max()) <= 1e-4
    assert float((c2 - cr).abs().max()) <= 1e-4


def test_bucketed_slice_on_card(cuda):
    """A small BiLSTM-Tagger minibatch through all three executors on the
    card agrees with the plain-PyTorch run on the CPU."""
    import random

    from repro_torch.core.batching import SufficientConditionPolicy
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import BucketedPlanExecutor, PlanExecutor
    from repro_torch.models.workloads import make_workload

    policy = SufficientConditionPolicy()
    ref_wl = make_workload("BiLSTM-Tagger", 64, 0, device="cpu")
    wl = make_workload("BiLSTM-Tagger", 64, 0, device=cuda)
    g = wl.sample_graph(random.Random(0), 2, lo=4, hi=8)
    want = DynamicExecutor(ref_wl.impls, None, device="cpu").run(g, policy)
    ids = list(want.nodes_with_field("y"))
    y_want = want.field("y", ids)
    before = fused_gather_lstm_cell.launches
    for ex in (DynamicExecutor(wl.impls, None, device=cuda),
               PlanExecutor(wl.impls, None, device=cuda),
               BucketedPlanExecutor(wl.impls, None, device=cuda)):
        y = ex.run(g, policy).field("y", ids).cpu()
        assert float((y - y_want).abs().max()) <= 1e-4, type(ex).__name__
    assert fused_gather_lstm_cell.launches > before

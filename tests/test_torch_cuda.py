"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_cell import fused_lstm_cell  # noqa: E402
from repro_torch.kernels.fused_gather_cell import \
    fused_gather_lstm_cell  # noqa: E402
from repro_torch.kernels.gather_batch import gather_rows  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402


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


@pytest.mark.parametrize("k", [1, 2, 255, 256, 257, 4096])
def test_gather_kernel_at_row_counts_around_its_tiles(cuda, k):
    """Path-width rows (2 KB of float32) at row counts around the block's
    rows and the grid's sizing: bit-equal, one launch."""
    g = torch.Generator(device=cuda).manual_seed(k)
    src = torch.randn((max(2 * k, 64), 512), generator=g, device=cuda)
    idx = torch.randint(-src.shape[0], src.shape[0], (k,), generator=g,
                        device=cuda, dtype=torch.int32)
    before = gather_rows.launches
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


def test_gather_kernel_past_the_grid_cap(cuda):
    """More row tiles than the grid holds: one float per row, 256 rows per
    block, so 2^24 + 1000 rows need the row-tile loop."""
    from repro_torch.kernels.gather_batch import GRID_CAP, gather_geometry

    k = 256 * GRID_CAP + 1000
    geo = gather_geometry(k, 4, 4)
    assert geo["row_tiles"] > geo["grid"][0] == GRID_CAP
    src = torch.arange(1000, dtype=torch.float32, device=cuda)[:, None]
    idx = torch.randint(-1000, 1000, (k,), device=cuda, dtype=torch.int32)
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


def test_gather_kernel_long_rows_past_the_grid_cap(cuda):
    """1 KB rows, 65535 x 4 + 100 of them: more row tiles than the grid
    holds, so the row-tile loop runs with 16-byte units."""
    from repro_torch.kernels.gather_batch import GRID_CAP, gather_geometry

    k = 4 * GRID_CAP + 100
    geo = gather_geometry(k, 1024, 16)
    assert geo["row_tiles"] > geo["grid"][0] == GRID_CAP
    g = torch.Generator(device=cuda).manual_seed(1)
    src = torch.randn((1000, 256), generator=g, device=cuda)
    idx = torch.randint(-1000, 1000, (k,), generator=g, device=cuda,
                        dtype=torch.int32)
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


@pytest.mark.parametrize("row_floats", [256, 500, 2048, 2052, 1 << 18])
def test_gather_kernel_long_rows(cuda, row_floats):
    """Rows of 1 KB up to MV-RNN's 1 MB matrices: one unit tile a row, or
    many (a ragged last one), eight 16-byte units a thread."""
    g = torch.Generator(device=cuda).manual_seed(row_floats)
    src = torch.randn((40, row_floats), generator=g, device=cuda)
    idx = torch.randint(-40, 40, (37,), generator=g, device=cuda,
                        dtype=torch.int32)
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


_GATHER_DTYPES = [torch.uint8, torch.int8, torch.bool, torch.int16,
                  torch.float16, torch.bfloat16, torch.int32, torch.float32,
                  torch.int64, torch.float64, torch.complex64]


@pytest.mark.parametrize("dtype", _GATHER_DTYPES, ids=str)
@pytest.mark.parametrize("width,offset", [(3, 0), (5, 1), (16, 1), (64, 0),
                                          (129, 3)])
def test_gather_kernel_every_dtype_odd_rows_unaligned_views(cuda, dtype,
                                                             width, offset):
    """Every element size, rows of odd byte counts, and sources that start
    ``offset`` elements into their storage (so not on a 16-byte boundary
    where offset > 0): bit-equal to ``src[idx]``."""
    n, k = 97, 300
    rng = np.random.default_rng(width + offset)
    flat = torch.as_tensor(rng.integers(0, 100, n * width + offset),
                           device=cuda).to(dtype)
    src = flat[offset:].view(n, width)
    assert src.is_contiguous()
    idx = torch.as_tensor(rng.integers(-n, n, k), dtype=torch.int32,
                          device=cuda)
    out = gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(src, idx))


def _cell_case(B, E, H, n, device, offset=0, seed=0):
    """Sources of n rows (as views ``offset`` floats into their storage),
    indices with duplicates, pad lanes (repeats of one row) and negative
    ones, and the (E+H, 4H) weights."""
    rng = np.random.default_rng(seed)

    def view(rows, cols):
        flat = torch.as_tensor(rng.standard_normal(rows * cols + offset),
                               dtype=torch.float32, device=device)
        return flat[offset:].view(rows, cols)

    x_src, h_src, c_src = view(n, E), view(n, H), view(n, H)
    idx = []
    for _ in range(3):
        i = rng.integers(-n, n, B)
        i[: B // 3] = i[0]                  # duplicates
        if B >= 4:
            i[B - B // 4:] = n - 1          # pad lanes
        idx.append(torch.as_tensor(i, dtype=torch.int32, device=device))
    w = torch.as_tensor(0.05 * rng.standard_normal((E + H, 4 * H)),
                        dtype=torch.float32, device=device)
    b = torch.as_tensor(0.1 * rng.standard_normal(4 * H),
                        dtype=torch.float32, device=device)
    return [x_src, h_src, c_src, *idx, w, b]


def _check_cells(args):
    """The gather cell, and the dense cell on the gathered rows, against
    the plain version within 1e-4 (max abs error)."""
    x_src, h_src, c_src, ix, ih, ic, w, b = args
    before = (fused_gather_lstm_cell.launches, fused_lstm_cell.launches)
    h2, c2 = fused_gather_lstm_cell(*args)
    hr, cr = ref.fused_gather_lstm_cell_ref(*args)
    xh = torch.cat([x_src[ix.long()], h_src[ih.long()]], dim=1)
    h3, c3 = fused_lstm_cell(xh, w, b, c_src[ic.long()].contiguous())
    torch.cuda.synchronize()
    assert (fused_gather_lstm_cell.launches, fused_lstm_cell.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, want in ((h2, hr), (c2, cr), (h3, hr), (c3, cr)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("B", [1, 7, 8, 9, 15, 16, 17, 32, 33, 64, 65])
def test_cell_kernels_at_every_row_tile_edge(cuda, B):
    """Both cells at E = H = 512 for B around the n8 tiles and past the 64
    rows a CTA holds."""
    _check_cells(_cell_case(B, 512, 512, 300, cuda, seed=B))


@pytest.mark.parametrize("E,H", [(512, 512), (24, 40), (520, 500), (3, 5),
                                 (1024, 1024)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("B", [5, 16, 33])
def test_cell_kernels_ragged_widths_unaligned_views(cuda, E, H, offset, B):
    """Widths whose K = E + H leaves a ragged chunk and uneven K slices
    over the cluster (520 + 500, 3 + 5), H not a multiple of the 8 hidden
    units of a cluster (500, 5, 3), more chunks a CTA than its ring holds
    (1024 + 1024), and sources one float into their storage (4-byte
    copies); duplicate, pad and negative indices."""
    _check_cells(_cell_case(B, E, H, 50, cuda, offset=offset, seed=E + H))


def test_cell_kernels_are_deterministic(cuda):
    """The cluster's partial sums meet in a fixed order: two launches on the
    same inputs give the same bits."""
    args = _cell_case(16, 512, 512, 300, cuda, seed=1)
    first = fused_gather_lstm_cell(*args)
    again = fused_gather_lstm_cell(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


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


def _rel_err(got, want) -> float:
    """Max abs error relative to the largest magnitude of the result."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _attn_inputs(B, Sq, Skv, H, KV, D, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=device)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


# (B, Sq, Skv, H, KV, D, causal, window): the Qwen2-0.5B prefill shapes
# (14 query heads over 2 KV heads, D = 64) and the edge cases.
_ATTN_CASES = {
    "path S=96 B=2": (2, 96, 96, 14, 2, 64, True, 0),
    "path S=32 B=1": (1, 32, 32, 14, 2, 64, True, 0),
    "path S=48 B=4": (4, 48, 48, 14, 2, 64, True, 0),
    "path S=256 B=1": (1, 256, 256, 14, 2, 64, True, 0),
    "ragged S=100": (2, 100, 100, 14, 2, 64, True, 0),
    "window 16, S=130": (1, 130, 130, 4, 2, 64, True, 16),
    "window 1": (1, 40, 40, 2, 1, 32, True, 1),
    "cross Sq=40 Skv=77": (2, 40, 77, 6, 3, 64, False, 0),
    "non-causal square": (1, 64, 64, 2, 2, 16, False, 0),
    "D=128": (1, 70, 70, 4, 1, 128, True, 0),
    "D=16 MHA": (3, 33, 33, 4, 4, 16, True, 0),
}


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_flash_attention_kernel_within_1e4(cuda, case):
    B, Sq, Skv, H, KV, D, causal, window = _ATTN_CASES[case]
    q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _rel_err(out, want) <= 1e-4


def _edge_cases():
    """(Sq, Skv, D, G, causal, window) at the tile edges: query rows around
    a warp's 16 and a block's 64, keys around an m16n8k8 column tile of 8
    and a K/V tile of 64, each head dim, plain and grouped heads, causal
    and cross; then windows, one of them with rows that see no key."""
    cases = {}
    i = 0
    for Sq in (1, 15, 17, 100):
        for Skv in (1, 8, 9, 77):
            for causal in (True, False):
                D, G = (16, 32, 128)[i % 3], (1, 7)[i % 2]
                cases[f"Sq={Sq} Skv={Skv} D={D} G={G} "
                      f"{'causal' if causal else 'cross'}"] = (
                    Sq, Skv, D, G, causal, 0)
                i += 1
    cases["P V relayout D=16 Skv=8"] = (8, 8, 16, 1, True, 0)
    cases["window 16 S=100 G=7"] = (100, 100, 32, 7, True, 16)
    cases["window 8 Sq=100 Skv=77"] = (100, 77, 64, 1, True, 8)
    cases["window 4 Sq=17 Skv=9, rows with no key"] = (17, 9, 16, 7, True, 4)
    return cases


_ATTN_EDGES = _edge_cases()


@pytest.mark.parametrize("case", sorted(_ATTN_EDGES))
def test_flash_attention_kernel_at_tile_edges(cuda, case):
    Sq, Skv, D, G, causal, window = _ATTN_EDGES[case]
    KV = 2
    q, k, v = _attn_inputs(2, Sq, Skv, KV * G, KV, D, cuda, seed=Sq + Skv)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out).all()
    assert _rel_err(out, want) <= 1e-4


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q, k, v as slices of one packed projection, as strides allow."""
    B, S, H, KV, D = 2, 50, 4, 2, 64
    rng = np.random.default_rng(3)
    packed = torch.as_tensor(rng.standard_normal((B, S, (H + 2 * KV) * D)),
                             dtype=torch.float32, device=cuda)
    q = packed[..., :H * D].view(B, S, H, D)
    k = packed[..., H * D:(H + KV) * D].view(B, S, KV, D)
    v = packed[..., (H + KV) * D:].view(B, S, KV, D)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert _rel_err(out, want) <= 1e-4


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 2, 1, 8, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)                      # D = 8
    q, k, v = _attn_inputs(1, 8, 8, 2, 1, 16, cuda)
    with pytest.raises(ValueError, match="float32"):
        flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, *_attn_inputs(1, 8, 8, 3, 3, 16, cuda)[1:])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def _ssd_inputs(b, l, h, p, g, n, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, l, h, p)),
              np.abs(rng.standard_normal((b, l, h))) * 0.5,
              -np.abs(rng.standard_normal(h)) * 0.5,
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, l, g, n))]
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


# (b, l, h, p, g, n, chunk): the Mamba2-130m prefill shapes (24 heads,
# p = 64, n = 128, chunk 128, one group) and smaller ones with groups.
_SSD_CASES = {
    "path l=128 b=1": (1, 128, 24, 64, 1, 128, 128),
    "path l=256 b=3": (3, 256, 24, 64, 1, 128, 128),
    "path l=256 b=4": (4, 256, 24, 64, 1, 128, 128),
    "groups 2, chunk 16": (2, 64, 8, 16, 2, 16, 16),
    "ragged p=24, n=40, chunk 32": (1, 96, 4, 24, 1, 40, 32),
}


@pytest.mark.parametrize("case", sorted(_SSD_CASES))
def test_ssd_scan_kernel_within_1e4(cuda, case):
    b, l, h, p, g, n, chunk = _SSD_CASES[case]
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda)
    before = ssd_scan.launches
    y, final = ssd_scan(x, dt, A, B, C, chunk)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert _rel_err(y, y_ref) <= 1e-4
    assert _rel_err(final, final_ref) <= 1e-4


# (chunk, n, p, groups): the tile edges of the scan's products: chunks of
# one 8-row tile, of 24 rows (a half 16-row tile) and the path's 128;
# state sizes of 16, 40 (five column tiles, 16-byte rows) and 128; p of
# 24 (a part of the block's 32 rows) and 64; one group and two.
_SSD_EDGES = [(q, n, p, g) for q in (8, 24, 128) for n in (16, 40, 128)
              for p in (24, 64) for g in (1, 2)]


@pytest.mark.parametrize("chunk,n,p,g", _SSD_EDGES)
def test_ssd_scan_kernel_at_tile_edges(cuda, chunk, n, p, g):
    x, dt, A, B, C = _ssd_inputs(2, 2 * chunk, 4, p, g, n, cuda,
                                 seed=chunk + n + p + g)
    y, final = ssd_scan(x, dt, A, B, C, chunk)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-4
    assert _rel_err(final, final_ref) <= 1e-4


@pytest.mark.parametrize("case", ["path", "ragged"])
def test_ssd_scan_kernel_from_an_initial_state(cuda, case):
    """A random initial state, against the plain version given the same;
    and a sequence scanned in two halves, the second from the first's
    final state, equals the whole."""
    b, l, h, p, g, n, chunk = ((2, 256, 24, 64, 1, 128, 128)
                               if case == "path" else
                               (2, 48, 4, 24, 2, 40, 24))
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda, seed=11)
    s0 = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (b, h, p, n)), dtype=torch.float32, device=cuda)
    y, final = ssd_scan(x, dt, A, B, C, chunk, init_state=s0)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
    half = l // 2
    y1, s1 = ssd_scan(x[:, :half], dt[:, :half], A, B[:, :half],
                      C[:, :half], chunk, init_state=s0)
    y2, s2 = ssd_scan(x[:, half:], dt[:, half:], A, B[:, half:],
                      C[:, half:], chunk, init_state=s1)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-4
    assert _rel_err(final, final_ref) <= 1e-4
    assert _rel_err(torch.cat([y1, y2], dim=1), y_ref) <= 1e-4
    assert _rel_err(s2, final_ref) <= 1e-4


def test_ssm_block_from_a_state_on_card_matches_cpu(cuda):
    """``ssm_block(..., state=S)`` on the card, through the scan kernel,
    against the same call on the CPU."""
    import dataclasses

    from repro_torch.arch.model import tree_map
    from repro_torch.arch.ssm import init_ssm, ssm_block
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              ssm_chunk=16)
    p = init_ssm(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal((2, 48, cfg.d_model)),
                        dtype=torch.float32)
    s0 = torch.as_tensor(0.5 * rng.standard_normal(
        (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
        dtype=torch.float32)
    want, want_state = ssm_block(p, x, cfg, state=s0)
    before = ssd_scan.launches
    out, state = ssm_block(tree_map(lambda t: t.to(cuda), p), x.to(cuda), cfg,
                           state=s0.to(cuda))
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert _rel_err(out.cpu(), want) <= 1e-4
    assert _rel_err(state.cpu(), want_state) <= 1e-4


def test_ssd_scan_kernel_reads_slices_of_a_packed_projection(cuda):
    """x, B and C as views into one (b, l, channels) tensor, as the SSM
    block's split of its convolved projection gives them."""
    b, l, h, p, n = 2, 64, 4, 16, 16
    rng = np.random.default_rng(5)
    xbc = torch.as_tensor(rng.standard_normal((b, l, h * p + 2 * n)),
                          dtype=torch.float32, device=cuda)
    x = xbc[..., :h * p].view(b, l, h, p)
    B = xbc[..., h * p:h * p + n].view(b, l, 1, n)
    C = xbc[..., h * p + n:].view(b, l, 1, n)
    _, dt, A, _, _ = _ssd_inputs(b, l, h, p, 1, n, cuda, seed=6)
    y, final = ssd_scan(x, dt, A, B, C, 16)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, 16)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-4
    assert _rel_err(final, final_ref) <= 1e-4


# (n, p, groups, packed): operands the kernel stages 4 bytes at a time:
# rows of B (n = 33) or of x (p = 21, 37; two blocks of p) that are not
# whole 16-byte chunks, and x, B and C as views into one projection at an
# odd offset, at the path's widths.
_SSD_4_BYTE = {
    "B, n=33 p=20": (33, 20, 1, False),
    "x, n=32 p=21": (32, 21, 1, False),
    "B and x, n=33 p=37 groups 2": (33, 37, 2, False),
    "packed at an odd offset, n=128 p=64": (128, 64, 1, True),
}


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("case", sorted(_SSD_4_BYTE))
def test_ssd_scan_kernel_copies_4_bytes_at_a_time(cuda, case, from_state):
    n, p, g, packed = _SSD_4_BYTE[case]
    b, l, h, chunk = (2, 256, 8, 128) if packed else (2, 48, 4, 24)
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda, seed=n + p)
    if packed:
        rng = np.random.default_rng(7)
        xbc = torch.as_tensor(rng.standard_normal((b, l, 1 + h * p
                                                   + 2 * g * n)),
                              dtype=torch.float32, device=cuda)
        o = 1 + h * p
        x = xbc[..., 1:o].view(b, l, h, p)
        B = xbc[..., o:o + g * n].view(b, l, g, n)
        C = xbc[..., o + g * n:].view(b, l, g, n)
    s0 = (torch.as_tensor(np.random.default_rng(8).standard_normal(
        (b, h, p, n)), dtype=torch.float32, device=cuda)
        if from_state else None)
    y, final = ssd_scan(x, dt, A, B, C, chunk, init_state=s0)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-4
    assert _rel_err(final, final_ref) <= 1e-4


def test_ssd_scan_rejects_what_it_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 16, 1, 16, cuda)
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, A, B, C, 16, init_state=torch.zeros(
            (1, 2, 16, 8), device=cuda))               # wrong shape
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, A, B, C, 16, init_state=torch.zeros(
            (1, 2, 16, 16), device=cuda).double())
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, B, C, 12)                   # does not divide 32
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x.double(), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros((1, 32, 1, 256), device=cuda)
        ssd_scan(x, dt, A, big, big, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C,
                 16)


# -- bf16 ---------------------------------------------------------------
# One bar for every bf16 comparison: the truth is the plain version in fp32
# on the same bf16-exact inputs; the kernel's error against it must be at
# most twice the plain bf16 version's, and within the reference's bf16
# kernel test's 3e-2 of the largest |truth|.


def _bf16_bar(got, plain, truth) -> None:
    truth = truth.float()
    err = float((got.float() - truth).abs().max())
    assert err <= 2 * float((plain.float() - truth).abs().max())
    assert err <= 3e-2 * float(truth.abs().max())


_ATTN_BF16_CASES = {
    "path S=32 B=2": (2, 32, 32, 14, 2, 64, True, 0),
    "path S=96 B=4": (4, 96, 96, 14, 2, 64, True, 0),
    "ragged S=37": (3, 37, 37, 14, 2, 64, True, 0),
    "window 5 S=71": (1, 71, 71, 4, 2, 32, True, 5),
    "cross Sq=9 Skv=133 D=128": (2, 9, 133, 8, 2, 128, False, 0),
    "Sq=3 Skv=5 D=16 G=3": (2, 3, 5, 3, 1, 16, True, 0),
    "vision cross Sq=64 Skv=1024 D=128 G=4": (2, 64, 1024, 32, 8, 128,
                                              False, 0),
}


@pytest.mark.parametrize("case", sorted(_ATTN_BF16_CASES))
def test_flash_attention_bf16_on_the_bf16_bar(cuda, case):
    from repro_torch.kernels.flash_attention import (flash_attention_bf16,
                                                     flash_attention_forward)

    B, Sq, Skv, H, KV, D, causal, window = _ATTN_BF16_CASES[case]
    q, k, v = (t.bfloat16() for t in _attn_inputs(B, Sq, Skv, H, KV, D,
                                                  cuda))
    before = (flash_attention.launches, flash_attention_bf16.launches)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert (flash_attention.launches, flash_attention_bf16.launches) == \
        (before[0], before[1] + 1)
    truth = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                    window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _bf16_bar(out, ref.flash_attention_ref(q, k, v, causal, window), truth)
    again, lse = flash_attention_forward(q, k, v, causal, window, True)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and lse.dtype == torch.float32
    assert _rel_err(lse, ref.flash_attention_lse_ref(
        q.float(), k.float(), causal, window)) <= 1e-4


_SSD_BF16_CASES = {
    "path l=128 b=3": (3, 128, 24, 64, 1, 128, 128),
    "path l=256 b=3": (3, 256, 24, 64, 1, 128, 128),
    "chunk 24 p=24 n=40 groups 2": (2, 72, 4, 24, 2, 40, 24),
    "chunk 8 p=8 n=16": (1, 40, 3, 8, 1, 16, 8),
    "chunk 56 p=40 n=24": (2, 112, 2, 40, 1, 24, 56),
    "chunk 96 p=64 n=64": (1, 192, 2, 64, 1, 64, 96),
}


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("case", sorted(_SSD_BF16_CASES))
def test_ssd_scan_bf16_on_the_bf16_bar(cuda, case, from_state):
    from repro_torch.kernels.ssd_scan import ssd_scan_bf16, ssd_scan_forward

    b, l, h, p, g, n, chunk = _SSD_BF16_CASES[case]
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda)
    x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
    s0 = (torch.as_tensor(np.random.default_rng(1).standard_normal(
        (b, h, p, n)), dtype=torch.bfloat16, device=cuda)
        if from_state else None)
    before = (ssd_scan.launches, ssd_scan_bf16.launches)
    y, final = ssd_scan(x, dt, A, B, C, chunk, s0)
    assert (ssd_scan.launches, ssd_scan_bf16.launches) == \
        (before[0], before[1] + 1)
    up = [t.float() for t in (x, dt, B, C)]
    s32 = None if s0 is None else s0.float()
    y_t, final_t = ref.ssd_scan_ref(up[0], up[1], A, up[2], up[3], chunk,
                                    s32)
    y_p, final_p = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
    torch.cuda.synchronize()
    assert (y.dtype, final.dtype) == (torch.bfloat16, torch.float32)
    _bf16_bar(y, y_p, y_t)
    _bf16_bar(final, final_p, final_t)
    again, final2, states = ssd_scan_forward(x, dt, A, B, C, chunk, s0,
                                             with_states=True)
    torch.cuda.synchronize()
    assert torch.equal(again, y) and torch.equal(final2, final)
    assert _rel_err(states, ref.ssd_chunk_states(
        up[0], up[1], A, up[2], chunk, s32)) <= 3e-2


def test_bf16_kernels_refuse_strides_off_16_bytes(cuda):
    """TMA reads the bf16 operands: a stride that is not a multiple of 16
    bytes, or a base pointer off 16 bytes, is refused by the wrapper,
    which allocates nothing for it (no copy)."""
    q, k, v = (t.bfloat16() for t in _attn_inputs(1, 8, 8, 2, 1, 16, cuda))
    packed = torch.zeros((1, 8, 2 * 16 + 4), dtype=torch.bfloat16,
                         device=cuda)
    odd = packed[..., :32].view(1, 8, 2, 16)   # a stride of 36 elements
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        flash_attention(odd, k, v)
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 16, 1, 16, cuda)
    x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
    wide = torch.zeros((1, 32, 20), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        ssd_scan(x, dt, A, wide[..., :16].view(1, 32, 1, 16), C, 16)
    xp = torch.zeros((1, 32, 2 * 16 + 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        ssd_scan(xp[..., :32].view(1, 32, 2, 16), dt, A, B, C, 16)
    # strides in multiples of 8 elements, the base 8 bytes past 16
    flat = torch.zeros(2048 + 8, dtype=torch.bfloat16, device=cuda)
    q_off = flat[4:4 + 256].view(1, 8, 2, 16)
    x_off = flat[4:4 + 1024].view(1, 32, 2, 16)
    # the backwards: a dO or dy whose base is off 16 bytes
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    out, lse = flash_attention_forward(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="16-byte aligned pointer"):
        flash_attention_backward(q, k, v, out, q_off, lse)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan_backward(x, dt, A, B, C, 16, None, x_off)
    assert torch.cuda.memory_allocated(cuda) == before
    with pytest.raises(ValueError, match="16-byte aligned pointer"):
        flash_attention(q_off, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, flat[4:4 + 128].view(1, 8, 1, 16))
    with pytest.raises(ValueError, match="16-byte aligned pointer"):
        ssd_scan(x_off, dt, A, B, C, 16)
    with pytest.raises(ValueError, match="16-byte aligned pointer"):
        ssd_scan(x, dt, A, B, flat[4:4 + 512].view(1, 32, 1, 16), 16)
    assert torch.cuda.memory_allocated(cuda) == before


@pytest.mark.parametrize("kernel", ["flash_attention_bf16",
                                    "ssd_scan_bf16",
                                    "flash_attention_backward_bf16",
                                    "ssd_scan_backward_bf16"])
def test_bf16_kernels_two_runs_are_bit_equal(cuda, kernel):
    """No atomic sum: the same inputs give the same bits, at the waves'
    larger prefill shapes and at the vision model's cross shape; the
    backwards at the bf16 trainers' shapes (and attention's at the cross
    shape), called directly."""
    if kernel == "flash_attention_backward_bf16":
        from repro_torch.kernels.flash_attention import (
            flash_attention_backward, flash_attention_forward)
        for B, Sq, Skv, H, KV, D, causal in ((8, 128, 128, 14, 2, 64, True),
                                             (2, 128, 1024, 32, 8, 128,
                                              False)):
            q, k, v, dout = (t.bfloat16() for t in (
                *_attn_inputs(B, Sq, Skv, H, KV, D, cuda, 3),
                _attn_inputs(B, Sq, Sq, H, H, D, cuda, 4)[0]))
            out, lse = flash_attention_forward(q, k, v, causal, 0,
                                               with_lse=True)
            runs = [flash_attention_backward(q, k, v, out, dout, lse, causal)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs))
        return
    if kernel == "ssd_scan_backward_bf16":
        from repro_torch.kernels.ssd_scan import ssd_scan_backward
        x, dt, A, B, C = _ssd_inputs(8, 128, 24, 64, 1, 128, cuda, 3)
        x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
        dy = _ssd_inputs(8, 128, 24, 64, 1, 128, cuda, 4)[0].bfloat16()
        runs = [ssd_scan_backward(x, dt, A, B, C, 128, None, dy)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(runs[0][:5],
                                                      runs[1][:5]))
        return
    if kernel == "flash_attention_bf16":
        for B, Sq, Skv, H, KV, D, causal in ((4, 96, 96, 14, 2, 64, True),
                                             (2, 64, 1024, 32, 8, 128,
                                              False)):
            q, k, v = (t.bfloat16() for t in _attn_inputs(
                B, Sq, Skv, H, KV, D, cuda, 3))
            runs = [flash_attention(q, k, v, causal=causal)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(runs[0], runs[1])
    else:
        x, dt, A, B, C = _ssd_inputs(3, 256, 24, 64, 1, 128, cuda, 3)
        x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
        runs = [ssd_scan(x, dt, A, B, C, 128) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])


def test_fp16_and_mixed_dtypes_are_refused(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 2, 1, 16, cuda)
    for args in ((q.half(), k.half(), v.half()), (q.bfloat16(), k, v),
                 (q, k.bfloat16(), v.bfloat16())):
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            flash_attention(*args)
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 16, 1, 16, cuda)
    for args in ((x.half(), dt.half(), A, B.half(), C.half()),
                 (x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16()),
                 (x.bfloat16(), dt.bfloat16(), A.bfloat16(), B.bfloat16(),
                  C.bfloat16())):
        with pytest.raises(ValueError, match="float32"):
            ssd_scan(*args, 16)


# (B, Sq, Skv, H, KV, D, causal, window): the trainer's attention
# (Qwen2-0.5B at 8 x 128), a window, the vision model's cross shape and the
# edges: a ragged tail, a cluster of 8 ranks of two heads (G = 16), small
# head dims and rows that see no key.
_ATTN_BF16_BWD_CASES = {
    "trainer B=8 S=128 G=7": (8, 128, 128, 14, 2, 64, True, 0),
    "window 16 S=200 G=7": (1, 200, 200, 14, 2, 64, True, 16),
    "vision cross Sq=128 Skv=1024 D=128 G=4": (2, 128, 1024, 32, 8, 128,
                                               False, 0),
    "ragged S=37 G=1": (2, 37, 37, 4, 4, 64, True, 0),
    "G=16 S=128": (1, 128, 128, 16, 1, 64, True, 0),
    "D=32 cross Sq=40 Skv=77 G=3": (2, 40, 77, 6, 2, 32, False, 0),
    "window 4 Sq=17 Skv=9 D=16, rows with no key": (1, 17, 9, 14, 2, 16,
                                                   True, 4),
}


def _attn_bf16_grads(fn, q, k, v, dout, causal, window):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fn(*leaves, causal, window).backward(dout)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("case", sorted(_ATTN_BF16_BWD_CASES))
def test_flash_attention_bf16_backward_on_the_bf16_bar(cuda, case):
    """The bf16 backward kernel through autograd: dq, dk and dv bf16, each
    on the bf16 bar (the truth autograd of the fp32 plain attention on the
    upcast inputs, the plain one autograd of the plain bf16 attention),
    two runs bit-equal, counted on the bf16 wrapper alone."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_bf16)

    B, Sq, Skv, H, KV, D, causal, window = _ATTN_BF16_BWD_CASES[case]
    q, k, v = (t.bfloat16() for t in _attn_inputs(B, Sq, Skv, H, KV, D,
                                                  cuda, 5))
    dout = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (B, Sq, H, D)), dtype=torch.bfloat16, device=cuda)
    before = (flash_attention_backward.launches,
              flash_attention_backward_bf16.launches)
    got = _attn_bf16_grads(flash_attention, q, k, v, dout, causal, window)
    assert (flash_attention_backward.launches,
            flash_attention_backward_bf16.launches) == \
        (before[0], before[1] + 1)
    again = _attn_bf16_grads(flash_attention, q, k, v, dout, causal, window)
    plain = _attn_bf16_grads(ref.flash_attention_ref, q, k, v, dout, causal,
                             window)
    truth = ref.flash_attention_backward_ref(
        q.float(), k.float(), v.float(), dout.float(), causal, window)
    torch.cuda.synchronize()
    for a, b, p, t in zip(got, again, plain, truth):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
        _bf16_bar(a, p, t)


_SSD_BF16_BWD_CASES = {  # (b, l, h, p, g, n, chunk, init, dfinal)
    "trainer b=8 l=128": (8, 128, 24, 64, 1, 128, 128, False, False),
    "two chunks, init state, final grad (3, 256)": (3, 256, 24, 64, 1, 128,
                                                    128, True, True),
    "groups 2, two chunks": (2, 256, 8, 64, 2, 128, 128, False, False),
    "ragged p=24 n=40 chunk 24 groups 2, init": (2, 48, 4, 24, 2, 40, 24,
                                                 True, False),
}


@pytest.mark.parametrize("case", sorted(_SSD_BF16_BWD_CASES))
def test_ssd_scan_bf16_backward_on_the_bf16_bar(cuda, case):
    """The bf16 backward kernels through autograd: dx, ddt, dB, dC bf16,
    dA and the initial state's gradient fp32, each on the bf16 bar (the
    truth autograd of the fp32 plain scan on the upcast inputs, the plain
    one autograd of the plain bf16 scan), two runs bit-equal, counted on
    the bf16 wrapper alone."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_backward,
                                              ssd_scan_backward_bf16)

    b, l, h, p, g, n, chunk, init, dfin = _SSD_BF16_BWD_CASES[case]
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda, 7)
    x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
    rng = np.random.default_rng(8)
    dy = torch.as_tensor(rng.standard_normal((b, l, h, p)),
                         dtype=torch.bfloat16, device=cuda)
    s0 = (torch.as_tensor(rng.standard_normal((b, h, p, n)),
                          dtype=torch.float32, device=cuda) if init else None)
    dfinal = (torch.as_tensor(rng.standard_normal((b, h, p, n)),
                              dtype=torch.float32, device=cuda)
              if dfin else None)

    def grads(fn, up=False):
        ins = [t.detach().clone().float() if up and t.dtype ==
               torch.bfloat16 else t.detach().clone()
               for t in (x, dt, A, B, C) + ((s0,) if init else ())]
        for t in ins:
            t.requires_grad_(True)
        y, final = fn(*ins[:5], chunk, ins[5] if init else None)
        outs, gs = [y], [dy.float() if up else dy]
        if dfin:
            outs.append(final)
            gs.append(dfinal)
        return torch.autograd.grad(outs, ins, gs)

    before = (ssd_scan_backward.launches, ssd_scan_backward_bf16.launches)
    got = grads(ssd_scan)
    assert (ssd_scan_backward.launches, ssd_scan_backward_bf16.launches) \
        == (before[0], before[1] + 1)
    again = grads(ssd_scan)
    plain = grads(ref.ssd_scan_ref)
    truth = grads(ref.ssd_scan_ref, up=True)
    torch.cuda.synchronize()
    want = [torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16,
            torch.bfloat16] + ([torch.float32] if init else [])
    assert [t.dtype for t in got] == want
    for a, c, pl, t in zip(got, again, plain, truth):
        assert torch.equal(a, c)
        _bf16_bar(a, pl, t)


def test_a_bf16_backward_of_mixed_dtypes_raises(cuda):
    """The bf16 backwards take all-bf16 operands (lse, A, the states and
    the final state's gradient fp32): a dout or dy of another dtype is
    refused, saying so."""
    from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                     flash_attention_forward)
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    q, k, v = (t.bfloat16() for t in _attn_inputs(1, 8, 8, 2, 1, 16, cuda))
    out, lse = flash_attention_forward(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="must all be bfloat16.*dout "
                                         "torch.float32"):
        flash_attention_backward(q, k, v, out, out.float(), lse)
    with pytest.raises(ValueError, match="must all be bfloat16.*out "
                                         "torch.float32"):
        flash_attention_backward(q, k, v, out.float(), out, lse)
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 16, 1, 16, cuda)
    x, dt, B, C = (t.bfloat16() for t in (x, dt, B, C))
    with pytest.raises(ValueError, match="dy must be a bfloat16"):
        ssd_scan_backward(x, dt, A, B, C, 16, None, x.float())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ssd_scan_backward(x, dt.float(), A, B, C, 16, None, x)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m"])
def test_bf16_train_step_replays_equal_eager_and_runs_the_bf16_kernels(
        cuda, name):
    """A reduced bf16 LM trained three steps through ``StaticTrainStep``:
    the captured steps' losses and every parameter leaf bit-equal to the
    same steps run eagerly, the leaves staying bf16, and each step
    launching the bf16 forward and backward kernels once a layer (the
    replays' counts added by the capture), the fp32 ones not at all."""
    import dataclasses

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.kernels.launches import WRAPPERS
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig, leaves

    cfg = get_config(name).reduced()
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=32)
    kernels = (("ssd_scan_bf16", "ssd_scan_backward_bf16") if cfg.ssm_state
               else ("flash_attention_bf16",
                     "flash_attention_backward_bf16"))
    fp32 = ("ssd_scan", "ssd_scan_backward", "flash_attention",
            "flash_attention_backward")
    model = TransformerLM(cfg, torch.bfloat16, device=cuda)
    params = tree_map(lambda t: t.to(cuda), TransformerLM(
        cfg, torch.bfloat16, device="cpu").init_params(
            torch.Generator().manual_seed(0)))
    corpus = SyntheticCorpus(PipelineConfig(vocab=cfg.vocab, seq_len=64,
                                            batch_size=2, seed=0))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    runs = {}
    for capture in (True, False):
        step = StaticTrainStep(model, opt, params, capture=capture)
        before = {k: WRAPPERS[k].launches for k in kernels + fp32}
        losses = [float(step(corpus.batch(i))["loss"]) for i in range(3)]
        moved = {k: WRAPPERS[k].launches - before[k]
                 for k in kernels + fp32}
        assert moved == {k: 3 * cfg.n_layers if k in kernels else 0
                         for k in kernels + fp32}, moved
        runs[capture] = (losses, leaves(step.state()[0]))
    assert all(np.isfinite(runs[True][0]))
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_argmax_of_tied_bf16_logits_takes_the_first_index_on_the_card(cuda):
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0], [0.5] * 4,
                           [1.0, 1.0 + 2.0 ** -10, 0.0, 0.0]],
                          device=cuda).bfloat16()
    assert torch.argmax(logits, -1).tolist() == [1, 0, 0]


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m"])
def test_bf16_wave_replays_equal_eager_and_run_the_bf16_kernel(cuda, name):
    """A reduced bf16 LM served on the card: the captured engine's tokens
    equal the eager engine's, the pool is bf16, and the wave launches the
    bf16 kernel and not the fp32 one."""
    import dataclasses

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bf16
    from repro_torch.kernels.ssd_scan import ssd_scan_bf16
    from repro_torch.serve.lm_wave import ServeEngine

    cfg = get_config(name).reduced()
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=32)
    model = TransformerLM(cfg, torch.bfloat16, device=cuda)
    params = tree_map(lambda t: t.to(cuda), TransformerLM(
        cfg, torch.bfloat16, device="cpu").init_params(
            torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (32, 64, 32)]
    fp32, kernel = ((ssd_scan, ssd_scan_bf16) if cfg.ssm_state
                    else (flash_attention, flash_attention_bf16))
    before = (fp32.launches, kernel.launches)
    eng = ServeEngine(model, params, cache_len=80, device=cuda)
    outs, _ = eng.generate(prompts, 5)
    assert fp32.launches == before[0] and kernel.launches > before[1]
    assert eng.generate(prompts, 5)[0] == outs            # replayed
    eager, _ = ServeEngine(model, params, cache_len=80, device=cuda,
                           capture=False).generate(prompts, 5)
    assert eager == outs
    assert {t.dtype for c in eng._decode(3).pool
            for t in c.values()} == {torch.bfloat16}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m"])
def test_lm_wave_on_card_matches_cpu(cuda, name):
    """A reduced LM served on the card gives the CPU run's tokens and batch
    counts, and the wave goes through the model's kernel."""
    import dataclasses

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.serve.lm_wave import ServeEngine

    cfg = get_config(name).reduced()
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=32)
    cpu = TransformerLM(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (32, 64, 32)]
    kernel = ssd_scan if cfg.ssm_state else flash_attention
    before = kernel.launches
    outs, stats = ServeEngine(card, tree_map(lambda t: t.to(cuda), params),
                              cache_len=80, device=cuda).generate(prompts, 5)
    assert kernel.launches > before
    want, want_stats = ServeEngine(cpu, params, cache_len=80,
                                   device="cpu").generate(prompts, 5)
    assert outs == want
    assert (stats.n_prefill_batches, stats.n_decode_batches) == \
        (want_stats.n_prefill_batches, want_stats.n_decode_batches) == (2, 4)


def _cell_inputs(B, K, H, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32, device=device)
            for scale, shape in ((1.0, (B, K)), (0.05, (K, 4 * H)),
                                 (0.1, (4 * H,)), (1.0, (B, H)))]


# (B, K, H): the tagger's cell at width 512 (the path shape), table5's
# shapes, the reference tests' shapes and ragged ones.
_DENSE_CASES = {
    "path": (16, 1024, 512),
    "table5 H=64": (16, 128, 64),
    "table5 H=128": (16, 256, 128),
    "table5 H=256": (16, 512, 256),
    "reference B=8": (8, 64, 32),
    "reference B=4": (4, 32, 32),
    "reference B=16": (16, 128, 64),
    "B=1": (1, 1024, 512),
    "ragged B=37 K=333 H=100": (37, 333, 100),
    "ragged B=5 K=7 H=13": (5, 7, 13),
    "K=1 H=1": (3, 1, 1),
}


@pytest.mark.parametrize("case", sorted(_DENSE_CASES))
def test_dense_cell_kernel_within_1e4(cuda, case):
    xh, w, b, c = _cell_inputs(*_DENSE_CASES[case], cuda)
    before = fused_lstm_cell.launches
    h2, c2 = fused_lstm_cell(xh, w, b, c)
    hr, cr = ref.fused_lstm_cell_ref(xh, w, b, c)
    torch.cuda.synchronize()
    assert fused_lstm_cell.launches == before + 1
    assert _rel_err(h2, hr) <= 1e-4
    assert _rel_err(c2, cr) <= 1e-4


def test_dense_cell_on_gathered_rows_is_the_gather_cell(cuda):
    """The card counterpart of the reference's composition test: the dense
    cell on concat[x[ix], h[ih]] and c[ic] is the gather cell."""
    B, E, H, n = 16, 512, 512, 300
    g = torch.Generator(device=cuda).manual_seed(0)
    x, h, c = (torch.randn((n, d), generator=g, device=cuda)
               for d in (E, H, H))
    _, w, b, _ = _cell_inputs(1, E + H, H, cuda)
    ix, ih, ic = (torch.randint(-n, n, (B,), generator=g, device=cuda,
                                dtype=torch.int32) for _ in range(3))
    xh = torch.cat([x[ix.long()], h[ih.long()]], dim=1)
    h2, c2 = fused_lstm_cell(xh, w, b, c[ic.long()].contiguous())
    h3, c3 = fused_gather_lstm_cell(x, h, c, ix, ih, ic, w, b)
    torch.cuda.synchronize()
    assert _rel_err(h2, h3) <= 1e-4
    assert _rel_err(c2, c3) <= 1e-4


def test_dense_cell_rejects_what_it_does_not_take(cuda):
    xh, w, b, c = _cell_inputs(4, 24, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_lstm_cell(xh.double(), w, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        fused_lstm_cell(xh, w.t().contiguous().t(), b, c)
    with pytest.raises(ValueError, match="must be"):
        fused_lstm_cell(xh, w[:, :30], b, c)            # 4H not a multiple
    with pytest.raises(ValueError, match="must be"):
        fused_lstm_cell(xh, w, b, c[:3])
    with pytest.raises(ValueError, match="float32"):
        fused_lstm_cell(xh, w, b.cpu(), c)


@pytest.mark.parametrize("name,args", [
    ("TreeLSTM", dict(leaves_lo=4, leaves_hi=6)),
    ("MV-RNN", dict(leaves_lo=4, leaves_hi=6)),
    ("LatticeLSTM", dict(lo=6, hi=10)),
])
def test_tree_and_lattice_on_card_match_cpu(cuda, name, args):
    """Small tree and lattice minibatches through the interpreted and
    bucketed executors on the card agree with the plain run on the CPU,
    through the gather kernel (and the fused cell on LatticeLSTM)."""
    import random

    from repro_torch.core.batching import SufficientConditionPolicy
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import BucketedPlanExecutor
    from repro_torch.models.workloads import make_workload

    policy = SufficientConditionPolicy()
    ref_wl = make_workload(name, 64, 0, device="cpu")
    wl = make_workload(name, 64, 0, device=cuda)
    g = wl.sample_graph(random.Random(0), 2, **args)
    want = DynamicExecutor(ref_wl.impls, None, device="cpu").run(g, policy)
    ids = list(want.nodes_with_field("y"))
    y_want = want.field("y", ids)
    gathers, cells = gather_rows.launches, fused_gather_lstm_cell.launches
    for ex in (DynamicExecutor(wl.impls, None, device=cuda),
               BucketedPlanExecutor(wl.impls, None, device=cuda)):
        y = ex.run(g, policy).field("y", ids).cpu()
        assert float((y - y_want).abs().max()) <= 1e-4, type(ex).__name__
    assert gather_rows.launches > gathers
    if name == "LatticeLSTM":
        assert fused_gather_lstm_cell.launches > cells


# -- CUDA graphs: one capture per bucket signature, then replays -------------


def _bucket_case(name, device):
    """(impls, graphs of one bucket signature, params, policy) for a
    tagger, a TreeLSTM and a ChainLM decode bucket at width 64. The ChainLM
    graphs are feed rounds of 8 entries over a slot pool of 8."""
    import random

    from repro_torch.core.batching import SufficientConditionPolicy
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve.scheduler import (RoundPlan,
                                             build_lm_feed_round_graph)

    policy = SufficientConditionPolicy()
    if name == "ChainLM":
        wl = make_workload("ChainLM", 64, 0, device=device)
        rng = np.random.default_rng(0)
        pool = {f: torch.as_tensor(rng.standard_normal((8, 64)),
                                   dtype=torch.float32, device=device)
                for f in wl.state_fields}
        graphs = []
        for k in range(2):
            g, _ = build_lm_feed_round_graph(RoundPlan(), count=8)
            for n in g.nodes:
                if n.type == "R":
                    n.attrs["aux"] = (n.id // 4 + k) % 8      # slot
                elif n.type == "E":
                    n.attrs["aux"] = int(rng.integers(0, wl.vocab))
            graphs.append(g)
        return wl.impls, graphs, {"slots": pool}, policy
    wl = make_workload(name, 64, 0, device=device)
    args = (dict(lo=4, hi=8) if name == "BiLSTM-Tagger"
            else dict(leaves_lo=4, leaves_hi=6))
    g = wl.sample_graph(random.Random(0), 2, **args)
    return wl.impls, [g, g], None, policy


def _outputs(res, graph):
    return {(n.id, f): t.clone() for n in graph.nodes
            for f, t in res.node(n.id).items()}


@pytest.mark.parametrize("name", ["BiLSTM-Tagger", "TreeLSTM", "ChainLM"])
def test_replay_equals_eager_bit_for_bit(cuda, name):
    """The captured bucket replays what the eager run computes, bit for
    bit, on every node output (the trash rows excluded), on the run that
    captures and on later replays; one capture per signature."""
    from repro_torch.core.plan import BucketedPlanExecutor

    impls, graphs, params, policy = _bucket_case(name, cuda)
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    for g in graphs + graphs:
        got = _outputs(ex.run(g, policy), g)
        want = _outputs(eager.run(g, policy), g)
        for k, t in want.items():
            assert torch.equal(got[k], t), k
    assert ex.n_captures == 1 and ex.n_replays == 4
    assert eager.n_captures == eager.n_replays == 0


@pytest.mark.parametrize("donate", [False, True])
def test_replay_results_are_copies_unless_donated(cuda, donate):
    """A replay overwrites the arenas the capture allocated. Undonated runs
    return copies, as the reference's return fresh arrays: a result stays
    as it was after later replays. With donation, as on the eager path, a
    run overwrites the previous run's arenas."""
    from repro_torch.core.plan import BucketedPlanExecutor

    impls, graphs, params, policy = _bucket_case("ChainLM", cuda)
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), donate=donate,
                              device=cuda)
    first = ex.run(graphs[0], policy)
    kept = _outputs(first, graphs[0])
    second = ex.run(graphs[1], policy)
    torch.cuda.synchronize()
    assert ex.n_replays == 2
    now = _outputs(first, graphs[0])
    same = all(torch.equal(now[k], t) for k, t in kept.items())
    assert same is not donate
    shared = any(first.arenas[k].data_ptr() == second.arenas[k].data_ptr()
                 for k in first.arenas)
    assert shared is donate


def test_in_place_pool_update_is_seen_by_the_next_replay(cuda):
    """The graph reads the slot pool at its captured addresses: an
    in-place update is read by the next replay (no new capture), and the
    result equals an eager run over the updated pool."""
    from repro_torch.core.plan import BucketedPlanExecutor

    impls, graphs, params, policy = _bucket_case("ChainLM", cuda)
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    g = graphs[0]
    before = _outputs(ex.run(g, policy), g)
    for t in params["slots"].values():
        t.mul_(-0.5).add_(0.25)
    got = _outputs(ex.run(g, policy), g)
    want = _outputs(eager.run(g, policy), g)
    assert ex.n_captures == 1 and ex.n_replays == 2
    assert all(torch.equal(got[k], t) for k, t in want.items())
    assert not all(torch.equal(got[k], t) for k, t in before.items())


def test_replays_add_to_the_launch_counters(cuda):
    """Each replay adds the launches (and gather shapes) of one eager run
    of the bucket; the capture itself adds nothing."""
    from collections import Counter

    from repro_torch.core.plan import BucketedPlanExecutor

    impls, graphs, params, policy = _bucket_case("BiLSTM-Tagger", cuda)
    g = graphs[0]
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    eager.run(g, policy)                     # builds what is built once

    def counts(fn):
        before = (gather_rows.launches, fused_gather_lstm_cell.launches,
                  Counter(gather_rows.shapes))
        fn()
        return (gather_rows.launches - before[0],
                fused_gather_lstm_cell.launches - before[1],
                gather_rows.shapes - before[2])

    one = counts(lambda: eager.run(g, policy))
    assert one[0] > 0 and one[1] > 0
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    first = counts(lambda: ex.run(g, policy))   # warm-up + capture + replay
    assert first[:2] == (2 * one[0], 2 * one[1])
    three = counts(lambda: [ex.run(g, policy) for _ in range(3)])
    assert three[:2] == (3 * one[0], 3 * one[1])
    assert three[2] == Counter({k: 3 * n for k, n in one[2].items()})


def test_engines_with_other_weights_do_not_alias_a_shared_bucket_cache(cuda):
    """Two engines on the card sharing one pack cache and one bucket cache,
    built around different weights, each give the tokens they give alone:
    neither replays the other's graph."""
    from repro_torch.core.cache import FIFOCache
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    def run(wl, **caches):
        eng = ServeEngine({"lm": wl}, max_slots=4, device=cuda, **caches)
        reqs = [lm_request([1, 2, 3], 4), lm_request([7, 5], 4)]
        eng.submit_many(reqs)
        stats = eng.run()
        return [r.out for r in reqs], stats

    a, b = (make_workload("ChainLM", 64, seed, device=cuda) for seed in (0, 1))
    alone = [run(a)[0], run(b)[0]]
    shared = dict(plan_cache=FIFOCache(8), bucket_cache=FIFOCache(8))
    out_a, stats_a = run(a, **shared)
    out_b, stats_b = run(b, **shared)
    assert [out_a, out_b] == alone and out_a != out_b
    assert stats_a.n_graph_captures >= 1 and stats_b.n_graph_captures >= 1
    assert stats_b.n_graph_replays > stats_b.n_graph_captures


def test_capture_failure_is_a_compile_failure(cuda, monkeypatch):
    """A capture that fails raises like a failed compile: the engine books
    the signature into quarantine and serves the round on the interpreted
    floor (never a silent eager fallback), and every request completes
    with the tokens of a clean run."""
    from repro_torch.core import plan
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    wl = make_workload("ChainLM", 64, 0, device=cuda)

    def run():
        eng = ServeEngine({"lm": wl}, max_slots=4, device=cuda)
        reqs = [lm_request([1, 2, 3], 4), lm_request([7, 5], 4)]
        eng.submit_many(reqs)
        return [r for r in reqs], eng.run()

    clean, clean_stats = run()
    assert clean_stats.n_quarantine_events == clean_stats.n_contained_errors \
        == 0 and set(clean_stats.tier_rounds) == {"bucketed"}

    def broken(self, params):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(plan._Bucket, "capture", broken)
    reqs, stats = run()
    assert all(r.status == "COMPLETED" for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in clean]
    assert stats.n_quarantine_events >= 1 and stats.n_contained_errors >= 1
    assert stats.tier_rounds.get("interpreted", 0) >= 1
    assert stats.n_graph_captures == 0


def test_threaded_weights_replay_the_copies_they_were_captured_over(cuda):
    """A graph captured over threaded cell weights reads the blocked and
    packed copies built from them, and a cell keeps such copies for the
    last buffer it saw only. The entry holds its own: runs with threaded
    weights P, the cells' own, P again (with what the cells let go of
    handed out again full of NaN in between), and P after an in-place
    update each equal the eager run bit for bit."""
    from repro_torch.core.executor import derived_copies
    from repro_torch.core.plan import BucketedPlanExecutor
    from repro_torch.kernels.fused_cell import packed_weights

    impls, graphs, _, policy = _bucket_case("BiLSTM-Tagger", cuda)
    g = graphs[0]
    cells = [impl for impl in impls.values() if impl.fused_gather is not None]
    assert cells
    threaded = {c.name: c.params["pbuf"] * 0.5 + 0.01 for c in cells}
    ex = BucketedPlanExecutor(impls, None, ladder=(8,), device=cuda)
    eager = BucketedPlanExecutor(impls, None, ladder=(8,), device=cuda,
                                 capture=False)

    def check(params):
        got = _outputs(ex.run(g, policy, params=params), g)
        want = _outputs(eager.run(g, policy, params=params), g)
        for k, t in want.items():
            assert torch.equal(got[k], t), k
        return got

    with derived_copies() as found:
        eager.run(g, policy, params=threaded)
    sizes = {(t.shape, t.dtype) for _, _, (w, b) in found
             for t in (w, b, packed_weights(w))}
    del found
    first = check(threaded)
    own = check(None)
    assert any(not torch.equal(first[k], t) for k, t in own.items())
    junk = [torch.full(shape, float("nan"), dtype=dtype, device=cuda)
            for shape, dtype in sizes for _ in range(4)]
    again = check(threaded)
    assert all(torch.equal(again[k], t) for k, t in first.items())
    assert (ex.n_captures, ex.n_replays) == (2, 3)
    for t in threaded.values():
        t.mul_(0.5)
    check(threaded)
    assert (ex.n_captures, ex.n_replays) == (3, 4)   # the stale entry rebuilt
    del junk


def test_failure_inside_a_capture_is_a_compile_failure(cuda, monkeypatch):
    """A body that syncs the host only while it is captured (``.item()``)
    fails inside the capture itself. The build raises; the capture's
    launch counts are set back (only the eager warm-up's stay); nothing is
    cached; the current stream is the one before, the random generator
    draws again, and the stream and the allocator serve the next runs;
    and an engine quarantines the signature and serves every round on the
    interpreted floor with the tokens of a clean run."""
    from repro_torch.core.plan import BucketedPlanExecutor
    from repro_torch.kernels import launches
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    impls, graphs, params, policy = _bucket_case("ChainLM", cuda)
    g = graphs[0]
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    want = _outputs(eager.run(g, policy), g)
    before = launches.snapshot()
    eager.run(g, policy)
    one = launches.delta(before, launches.snapshot())

    def syncing(fn):
        def fused(params, bufs, idxs, aux):
            if torch.cuda.is_current_stream_capturing():
                idxs[0].sum().item()
            return fn(params, bufs, idxs, aux)
        return fused

    for impl in impls.values():
        if impl.fused_gather is not None:
            monkeypatch.setattr(impl, "fused_gather",
                                syncing(impl.fused_gather))
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    stream = torch.cuda.current_stream(cuda)
    before = launches.snapshot()
    with pytest.raises(RuntimeError):
        ex.run(g, policy)
    assert launches.delta(before, launches.snapshot()) == one
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda) == stream
    torch.randn(4, device=cuda)          # the generator left capture mode
    pack = ex.pack_for(g, policy)
    assert ex._exes.peek(ex.executable_key(pack, params)) is None
    assert ex.n_captures == ex.n_bucket_compiles == 0
    got = _outputs(eager.run(g, policy), g)
    assert all(torch.equal(got[k], t) for k, t in want.items())
    torch.cuda.synchronize()

    def run(wl):
        eng = ServeEngine({"lm": wl}, max_slots=4, device=cuda)
        reqs = [lm_request([1, 2, 3], 4), lm_request([7, 5], 4)]
        eng.submit_many(reqs)
        return reqs, eng.run()

    clean, _ = run(make_workload("ChainLM", 64, 0, device=cuda))
    wl = make_workload("ChainLM", 64, 0, device=cuda)
    for impl in wl.impls.values():
        if impl.fused_gather is not None:
            impl.fused_gather = syncing(impl.fused_gather)
    reqs, stats = run(wl)
    assert all(r.status == "COMPLETED" for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in clean]
    assert stats.n_quarantine_events >= 1 and stats.n_contained_errors >= 1
    assert stats.tier_rounds.get("interpreted", 0) >= 1
    assert stats.n_graph_captures == 0


def _grad_cases(device):
    def t(*shape):
        return torch.randn(shape, device=device)

    idx = torch.zeros(4, dtype=torch.int32, device=device)
    return {
        "gather_rows": (lambda a: gather_rows(a[0], idx), [t(8, 16)]),
        "fused_gather_lstm_cell": (
            lambda a: fused_gather_lstm_cell(a[0], a[1], a[2], idx, idx, idx,
                                             a[3], a[4]),
            [t(8, 16), t(8, 16), t(8, 16), t(32, 64), t(64)]),
        "fused_lstm_cell": (lambda a: fused_lstm_cell(*a),
                            [t(4, 32), t(32, 64), t(64), t(4, 16)]),
        "flash_attention": (lambda a: flash_attention(*a),
                            [t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)]),
        "ssd_scan": (lambda a: ssd_scan(a[0], a[1], a[2], a[3], a[4], 8),
                     [t(1, 16, 2, 8), t(1, 16, 2).abs(), -t(2).abs(),
                      t(1, 16, 1, 8), t(1, 16, 1, 8)]),
    }


@pytest.mark.parametrize("name", ["fused_gather_lstm_cell",
                                  "fused_lstm_cell"])
def test_cuda_routes_raise_under_grad_mode(cuda, name):
    """These kernels have no backward: with grad mode on and an input that
    requires grad, each CUDA route raises instead of returning a result
    with no autograd graph, naming the fused cells' backward; under no_grad
    it runs."""
    fn, args = _grad_cases(cuda)[name]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*fused cells"):
        fn(args)
    with torch.no_grad():
        fn(args)
    fn([a.detach() for a in args])
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["gather_rows", "ssd_scan"])
def test_gather_and_scan_routes_differentiate_under_grad_mode(cuda, name):
    """The row gather and the SSD scan have backward kernels: under grad
    mode with an input that requires grad each CUDA route records its
    autograd Function (the forward counted once, the backward once), and
    under no_grad or with detached inputs it runs the forward alone."""
    from repro_torch.kernels.gather_batch import gather_rows_backward
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    fwd_fn, bwd_fn = {"gather_rows": (gather_rows, gather_rows_backward),
                      "ssd_scan": (ssd_scan, ssd_scan_backward)}[name]
    fn, args = _grad_cases(cuda)[name]
    args[0].requires_grad_(True)
    fwd, bwd = fwd_fn.launches, bwd_fn.launches
    out = fn(args)
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad
    out.sum().backward()
    torch.cuda.synchronize()
    assert args[0].grad is not None and torch.isfinite(args[0].grad).all()
    assert (fwd_fn.launches, bwd_fn.launches) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        res = fn(args)
        assert not (res[0] if isinstance(res, tuple) else res).requires_grad
    res = fn([a.detach() for a in args])
    assert not (res[0] if isinstance(res, tuple) else res).requires_grad
    torch.cuda.synchronize()
    assert bwd_fn.launches == bwd + 1


def test_flash_attention_route_differentiates_under_grad_mode(cuda):
    """Flash attention has a backward kernel: under grad mode with an input
    that requires grad the CUDA route records the autograd Function (the
    forward counted once, the backward once), and under no_grad or with
    detached inputs it runs the forward alone."""
    from repro_torch.kernels.flash_attention import flash_attention_backward

    fn, args = _grad_cases(cuda)["flash_attention"]
    args[0].requires_grad_(True)
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    out = fn(args)
    assert out.requires_grad
    out.sum().backward()
    torch.cuda.synchronize()
    assert args[0].grad is not None and torch.isfinite(args[0].grad).all()
    assert (flash_attention.launches, flash_attention_backward.launches) == \
        (fwd + 1, bwd + 1)
    with torch.no_grad():
        assert not fn(args).requires_grad
    assert not fn([a.detach() for a in args]).requires_grad
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == bwd + 1


# -- flash attention's backward kernel -------------------------------------


def _attn_grads(q, k, v, dout, causal, window):
    """The card's gradients through the autograd Function."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


def _grad_err(got, want, top: float = 0.0) -> float:
    """Max abs error over the largest |gradient| of the plain version, or
    over ``top`` where that gradient is zero (with one key the softmax is
    constant and dq is 0: the error is held to the largest |gradient| of
    dq, dk and dv)."""
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              or top or 1e-30)


# (B, Sq, Skv, H, KV, D, causal, window): the trainer's shape, S around the
# tiles (1, 37, 200), G = 1 and 7, both large head dims, windows (with
# rows that see no key), and cross attention.
_BWD_CASES = {
    "trainer B=8 S=128 G=7": (8, 128, 128, 14, 2, 64, True, 0),
    "S=1 G=7": (2, 1, 1, 14, 2, 64, True, 0),
    "S=37 G=1": (2, 37, 37, 4, 4, 64, True, 0),
    "S=200 G=7": (1, 200, 200, 14, 2, 64, True, 0),
    "S=37 D=128 G=7": (1, 37, 37, 7, 1, 128, True, 0),
    "S=200 D=128 G=1": (1, 200, 200, 2, 2, 128, True, 0),
    "S=130 D=16 G=2": (2, 130, 130, 4, 2, 16, True, 0),
    "S=70 D=32 G=7": (1, 70, 70, 14, 2, 32, True, 0),
    "window 16 S=200 G=7": (1, 200, 200, 14, 2, 64, True, 16),
    "window 1 S=37": (1, 37, 37, 2, 1, 32, True, 1),
    "window 4 Sq=17 Skv=9, rows with no key": (1, 17, 9, 14, 2, 16, True, 4),
    "window 8 Sq=100 Skv=77": (1, 100, 77, 2, 2, 64, True, 8),
    "causal Sq=1 Skv=77": (2, 1, 77, 14, 2, 64, True, 0),
    "cross Sq=40 Skv=77": (2, 40, 77, 6, 3, 64, False, 0),
    "cross Sq=17 Skv=9 D=128": (1, 17, 9, 2, 2, 128, False, 0),
    # dk/dv clusters of 3 and 4 ranks (phi4-mini's head map, D = 128),
    # beyond one cluster (16 heads: 8 ranks of 2), and cross at G = 7
    "G=3 D=128 S=128": (2, 128, 128, 24, 8, 128, True, 0),
    "G=4 D=128 S=128": (1, 128, 128, 32, 8, 128, True, 0),
    "G=16 S=128": (1, 128, 128, 16, 1, 64, True, 0),
    "cross G=7 Sq=40 Skv=77": (2, 40, 77, 14, 2, 64, False, 0),
}


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_flash_attention_backward_kernel_within_1e4(cuda, case):
    from repro_torch.kernels.flash_attention import flash_attention_backward

    B, Sq, Skv, H, KV, D, causal, window = _BWD_CASES[case]
    q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, cuda, seed=Sq + 3 * Skv)
    dout = _attn_inputs(B, Sq, Sq, H, H, D, cuda, seed=7)[0]
    before = flash_attention_backward.launches
    out, grads = _attn_grads(q, k, v, dout, causal, window)
    want = ref.flash_attention_backward_ref(q, k, v, dout, causal, window)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    assert _rel_err(out, ref.flash_attention_ref(q, k, v, causal,
                                                 window)) <= 1e-4
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip("qkv", grads, want):
        assert torch.isfinite(g).all(), name
        assert _grad_err(g, w, top) <= 1e-4, (name, _grad_err(g, w, top))


def test_flash_attention_backward_is_bit_equal_between_runs(cuda):
    """No atomics: the dk/dv cluster sums its ranks in a fixed order, so two
    runs at the trainer's shape give the same gradients bit for bit."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    q, k, v = _attn_inputs(8, 128, 128, 14, 2, 64, cuda, seed=11)
    dout = _attn_inputs(8, 128, 128, 14, 14, 64, cuda, seed=12)[0]
    out, lse = flash_attention_forward(q, k, v, True, 0, with_lse=True)
    first = flash_attention_backward(q, k, v, out, dout, lse)
    second = flash_attention_backward(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), name


def test_flash_attention_backward_reads_strided_views(cuda):
    """q, k, v as slices of one packed projection, and a dO that is not
    contiguous (the kernel gets a contiguous copy): the gradients flow
    back into the packed tensor."""
    B, S, H, KV, D = 2, 50, 14, 2, 64
    rng = np.random.default_rng(5)
    packed = torch.as_tensor(rng.standard_normal((B, S, (H + 2 * KV) * D)),
                             dtype=torch.float32, device=cuda)
    packed.requires_grad_(True)
    q = packed[..., :H * D].view(B, S, H, D)
    k = packed[..., H * D:(H + KV) * D].view(B, S, KV, D)
    v = packed[..., (H + KV) * D:].view(B, S, KV, D)
    dout = torch.as_tensor(rng.standard_normal((B, H, S, D)),
                           dtype=torch.float32, device=cuda).transpose(1, 2)
    assert not q.is_contiguous() and not dout.is_contiguous()
    flash_attention(q, k, v).backward(dout)
    want = ref.flash_attention_backward_ref(q, k, v, dout)
    torch.cuda.synchronize()
    got = [packed.grad[..., :H * D].view(B, S, H, D),
           packed.grad[..., H * D:(H + KV) * D].view(B, S, KV, D),
           packed.grad[..., (H + KV) * D:].view(B, S, KV, D)]
    for name, g, w in zip("qkv", got, want):
        assert _grad_err(g, w) <= 1e-4, name


def test_flash_attention_lse_leaves_the_output_bit_equal(cuda):
    """The forward with the rows' log-sum-exp writes the same output bit for
    bit, and the lse agrees with the plain one (-1e30 for rows that see no
    key)."""
    from repro_torch.kernels.flash_attention import flash_attention_forward

    for B, Sq, Skv, H, KV, D, causal, window in (
            (8, 128, 128, 14, 2, 64, True, 0), (1, 17, 9, 14, 2, 16, True, 4),
            (2, 40, 77, 6, 3, 128, False, 0)):
        q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, cuda)
        plain, none = flash_attention_forward(q, k, v, causal, window)
        out, lse = flash_attention_forward(q, k, v, causal, window,
                                           with_lse=True)
        want = ref.flash_attention_lse_ref(q, k, causal, window)
        torch.cuda.synchronize()
        assert none is None and torch.equal(out, plain)
        assert lse.shape == (B, H, Sq)
        seen = want > -1e29
        assert torch.equal(lse[~seen], want[~seen])
        assert float((lse[seen] - want[seen]).abs().max()) <= 1e-4


def test_transformer_loss_gradients_on_the_card_match_the_cpu(cuda):
    """Qwen2 (reduced) loss and gradients on the card, through the flash
    forward and backward kernels, against the plain CPU run."""
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.train.optimizer import leaves, unflatten

    cfg = get_config("qwen2-0.5b").reduced()
    cpu = TransformerLM(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 37)),
             "labels": rng.integers(0, cfg.vocab, (2, 37))}

    def grads(model, p, device):
        flat = [t.to(device).requires_grad_(True) for t in leaves(p)]
        loss = model.loss(unflatten(p, flat),
                          {k: torch.as_tensor(a, device=device)
                           for k, a in batch.items()})
        return loss, torch.autograd.grad(loss, flat)

    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    loss, got = grads(card, params, cuda)
    torch.cuda.synchronize()
    assert flash_attention.launches - fwd == cfg.n_layers
    assert flash_attention_backward.launches - bwd == cfg.n_layers
    want_loss, want = grads(cpu, tree_map(lambda t: t.clone(), params), "cpu")
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for g, w in zip(got, want):
        assert _grad_err(g.cpu(), w) <= 2e-3


def test_mamba2_loss_gradients_on_the_card_match_the_cpu(cuda):
    """Mamba2 (reduced, two chunks of the sequence) loss and gradients on
    the card, through the SSD scan's forward and backward kernels, against
    the plain CPU run."""
    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    from repro_torch.train.optimizer import leaves, unflatten

    cfg = get_config("mamba2-130m").reduced()
    cpu = TransformerLM(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=cuda)
    rng = np.random.default_rng(0)
    L = 2 * cfg.ssm_chunk
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, L)),
             "labels": rng.integers(0, cfg.vocab, (2, L))}

    def grads(model, device):
        flat = [t.to(device).requires_grad_(True) for t in leaves(params)]
        loss = model.loss(unflatten(params, flat),
                          {k: torch.as_tensor(a, device=device)
                           for k, a in batch.items()})
        return loss, torch.autograd.grad(loss, flat)

    fwd, bwd = ssd_scan.launches, ssd_scan_backward.launches
    loss, got = grads(card, cuda)
    torch.cuda.synchronize()
    assert ssd_scan.launches - fwd == cfg.n_layers
    assert ssd_scan_backward.launches - bwd == cfg.n_layers
    want_loss, want = grads(cpu, "cpu")
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for g, w in zip(got, want):
        assert _grad_err(g.cpu(), w) <= 2e-3


def test_mamba2_trains_through_the_launcher_on_the_card(cuda):
    """``launch.train.main`` on a reduced Mamba2 on the card: finite losses,
    the scan's forward and backward kernels launched once a layer a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    from repro_torch.launch import train as train_launcher

    cfg = get_config("mamba2-130m").reduced()
    fwd, bwd = ssd_scan.launches, ssd_scan_backward.launches
    state = train_launcher.main(["--arch", "mamba2-130m", "--reduced",
                                 "--steps", "3", "--batch", "2", "--seq",
                                 str(2 * cfg.ssm_chunk), "--log-every", "1"],
                                log_fn=lambda line: None)
    assert len(state.history) == 3 and np.isfinite(state.history).all()
    assert ssd_scan.launches - fwd == 3 * cfg.n_layers
    assert ssd_scan_backward.launches - bwd == 3 * cfg.n_layers


# -- the SSD scan's backward kernel -----------------------------------------


def _ssd_grads_card(x, dt, A, B, C, chunk, s0, dy, dfinal):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C) + ((s0,) if s0 is not None else ())]
    y, final = ssd_scan(*leaves[:5], chunk,
                        leaves[5] if s0 is not None else None)
    outs, grads = [y], [dy]
    if dfinal is not None:
        outs.append(final)
        grads.append(dfinal)
    return torch.autograd.grad(outs, leaves, grads)


# (b, l, h, p, g, n, chunk, initial state, final-state gradient): the
# trainer's shape, the prefill's two chunks with a state in and a gradient
# out, two groups, n < 128 with l = chunk, ragged tiles.
_SSD_BWD_CASES = {
    "trainer b=8 l=128": (8, 128, 24, 64, 1, 128, 128, False, False),
    "two chunks, init state, final grad": (3, 256, 24, 64, 1, 128, 128,
                                           True, True),
    "groups 2": (2, 64, 8, 16, 2, 16, 16, False, True),
    "n=40 l=chunk": (1, 128, 4, 64, 1, 40, 128, False, False),
    "ragged p=21 n=33 chunk 24 groups 2, init": (2, 48, 4, 21, 2, 33, 24,
                                                 True, False),
}


@pytest.mark.parametrize("case", sorted(_SSD_BWD_CASES))
def test_ssd_scan_backward_kernel_within_1e4(cuda, case):
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    b, l, h, p, g, n, chunk, init, dfin = _SSD_BWD_CASES[case]
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, cuda, seed=l + n)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda)
    s0 = t(b, h, p, n) if init else None
    dy = t(b, l, h, p)
    dfinal = t(b, h, p, n) if dfin else None
    before = ssd_scan_backward.launches
    got = _ssd_grads_card(x, dt, A, B, C, chunk, s0, dy, dfinal)
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, chunk, s0, dy, dfinal)
    torch.cuda.synchronize()
    assert ssd_scan_backward.launches == before + 1
    for name, gg, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                           want):
        assert torch.isfinite(gg).all(), name
        assert _grad_err(gg, w) <= 1e-4, (name, _grad_err(gg, w))


def test_ssd_scan_backward_is_bit_equal_between_runs(cuda):
    """No floating-point atomics: the group and dA sums run in a fixed
    order, so two runs give the same gradients bit for bit."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_backward,
                                              ssd_scan_forward)

    x, dt, A, B, C = _ssd_inputs(3, 256, 24, 64, 1, 128, cuda, seed=4)
    dy = _ssd_inputs(3, 256, 24, 64, 1, 128, cuda, seed=5)[0]
    s0 = torch.randn((3, 24, 64, 128), device=cuda)
    _, _, states = ssd_scan_forward(x, dt, A, B, C, 128, s0,
                                    with_states=True)
    first = ssd_scan_backward(x, dt, A, B, C, 128, s0, dy, None, states)
    second = ssd_scan_backward(x, dt, A, B, C, 128, s0, dy, None, states)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ssd_scan_states_leave_the_outputs_bit_equal(cuda):
    """The forward that also writes the chunks' start states writes the
    same y and final state bit for bit, and the states agree with the
    plain ones."""
    from repro_torch.kernels.ssd_scan import ssd_scan_forward

    x, dt, A, B, C = _ssd_inputs(3, 256, 24, 64, 1, 128, cuda, seed=8)
    s0 = torch.randn((3, 24, 64, 128), device=cuda)
    y, final, none = ssd_scan_forward(x, dt, A, B, C, 128, s0)
    y2, final2, states = ssd_scan_forward(x, dt, A, B, C, 128, s0,
                                          with_states=True)
    want = ref.ssd_chunk_states(x, dt, A, B, 128, s0)
    torch.cuda.synchronize()
    assert none is None and torch.equal(y, y2) and torch.equal(final, final2)
    assert _rel_err(states, want) <= 1e-4


def test_ssd_scan_backward_reads_slices_of_a_packed_projection(cuda):
    """x, B and C as views of one packed projection, as the SSM block
    gives them: the gradients flow back into the packed tensor."""
    b, l, h, p, n = 2, 256, 24, 64, 128
    rng = np.random.default_rng(7)
    xbc = torch.as_tensor(rng.standard_normal((b, l, 1 + h * p + 2 * n)),
                          dtype=torch.float32, device=cuda)
    xbc.requires_grad_(True)
    o = 1 + h * p
    x = xbc[..., 1:o].view(b, l, h, p)
    B = xbc[..., o:o + n].view(b, l, 1, n)
    C = xbc[..., o + n:].view(b, l, 1, n)
    _, dt, A, _, _ = _ssd_inputs(b, l, h, p, 1, n, cuda, seed=6)
    dy = torch.as_tensor(rng.standard_normal((b, l, h, p)),
                         dtype=torch.float32, device=cuda)
    y, _ = ssd_scan(x, dt, A, B, C, 128)
    y.backward(dy)
    want = ref.ssd_scan_bwd_ref(x.detach(), dt, A, B.detach(), C.detach(),
                                128, None, dy)
    torch.cuda.synchronize()
    got = [xbc.grad[..., 1:o].view(b, l, h, p),
           xbc.grad[..., o:o + n].view(b, l, 1, n),
           xbc.grad[..., o + n:].view(b, l, 1, n)]
    for gg, w in zip(got, (want[0], want[3], want[4])):
        assert _grad_err(gg, w) <= 1e-4


# -- the row gather's backward kernel ----------------------------------------


# (src shape, K, indices): the path's rows (2 KB) at K = 1, 16, 256, 512,
# repeated and negative indices, MV-RNN's flat (d, d) rows, and a row
# length that takes the 4-byte unit path; the one-launch path's edges (K
# at its threshold, 2048, and one above it, which sorts; a last block of
# fewer rows; every index on one row; the bucketed trash row, -1); K past
# one sort tile.
_GATHER_BWD_CASES = {
    "K=1": ((2048, 512), 1, "perm"),
    "K=16": ((2048, 512), 16, "perm"),
    "K=256": ((2048, 512), 256, "perm"),
    "K=512": ((2048, 512), 512, "perm"),
    "K=256 repeats and negatives": ((2048, 512), 256, "repeats"),
    "flat (d, d) rows": ((300, 24, 24), 77, "repeats"),
    "4-byte rows D=17": ((512, 17), 100, "repeats"),
    "K=2048 at the one-launch threshold": ((2048, 512), 2048, "random"),
    "K=2049 one above, sorted": ((2048, 512), 2049, "random"),
    "n_src not a multiple of a block's rows": ((2047, 512), 300, "repeats"),
    "every index on one row": ((2048, 512), 256, "one row"),
    "trash row": ((1001, 512), 256, "trash"),
    "K=5000 repeats": ((400, 8), 5000, "repeats"),
}


def _gather_bwd_indices(g, n, K, kind):
    if kind == "perm":
        return torch.randperm(n, generator=g, device="cuda")[:K].to(
            torch.int32)
    idx = torch.randint(0, n, (K,), generator=g, device="cuda",
                        dtype=torch.int32)
    if kind == "one row":
        idx[:] = idx[0]
    elif kind == "trash":
        idx[torch.rand((K,), generator=g, device="cuda") < 0.5] = -1
    elif kind == "repeats":
        idx[: K // 3] = idx[0]
        idx[K // 3] = -1
        idx[K // 3 + 1] = -n
    return idx


@pytest.mark.parametrize("case", sorted(_GATHER_BWD_CASES))
def test_gather_backward_kernel_against_its_plain_version(cuda, case):
    """Bit-equal to the plain version on the CPU, whose index_add_ sums in
    ascending k as both of the kernel's paths do; where no index repeats
    bit-equal to the plain version on the card too, and within 1e-6 of
    the largest |gradient| where indices repeat (index_add_ sums on the
    card in another order each run); where hundreds of indices pile on
    one row (every index on one row, the trash row) that order alone moves
    the card's sum by up to about 1e-6, so those are held to the CPU's
    bits only; two runs bit-equal."""
    from repro_torch.kernels.gather_batch import gather_rows_backward

    shape, K, kind = _GATHER_BWD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(K)
    idx = _gather_bwd_indices(g, shape[0], K, kind)
    dout = torch.randn((K,) + shape[1:], generator=g, device=cuda)
    before = gather_rows_backward.launches
    got = gather_rows_backward(dout, idx, shape[0])
    again = gather_rows_backward(dout, idx, shape[0])
    want = ref.gather_rows_bwd_ref(dout, idx, shape[0])
    torch.cuda.synchronize()
    assert gather_rows_backward.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), ref.gather_rows_bwd_ref(
        dout.cpu(), idx.cpu(), shape[0]))
    if kind == "perm":
        assert torch.equal(got, want)
    elif kind in ("repeats", "random"):
        assert _grad_err(got, want) <= 1e-6


def test_gather_backward_through_an_in_place_written_buffer(cuda):
    """The Function saves idx only: a buffer gathered from and then written
    in place (as DynamicExecutor writes its stores) still differentiates."""
    src = torch.randn((20, 16), device=cuda, requires_grad=True)
    buf = src * 2.0
    idx = torch.tensor([3, 3, -1, 0], dtype=torch.int32, device=cuda)
    out = gather_rows(buf, idx)
    buf.index_copy_(0, torch.tensor([5], device=cuda),
                    torch.ones((1, 16), device=cuda))
    out.sum().backward()
    want = torch.zeros((20, 16), device=cuda)
    want[3] = 4.0
    want[19] = 2.0
    want[0] = 2.0
    torch.cuda.synchronize()
    assert torch.equal(src.grad, want)


# -- gradients through the dynamic-graph executors ---------------------------


def test_dynamic_executor_gradients_on_the_card_match_the_cpu(cuda):
    """TreeGRU (model_size 32, four trees) through DynamicExecutor with
    threaded params: the loss and the gradient of the internal cell's
    buffer on the card against the CPU, and CompiledPlan's on the card
    against DynamicExecutor's; BucketedPlanExecutor refuses under grad,
    naming the fused cells' backward."""
    import random

    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import BucketedPlanExecutor, CompiledPlan
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.kernels.gather_batch import gather_rows_backward
    from repro_torch.models.workloads import make_workload

    rng = random.Random(0)
    cpu_wl = make_workload("TreeGRU", 32, 0, device="cpu")
    card_wl = make_workload("TreeGRU", 32, 0, device=cuda)
    policy = train_fsm([cpu_wl.sample_graph(rng, 2) for _ in range(3)],
                       RLConfig(max_iters=60)).policy
    g = cpu_wl.sample_graph(rng, 4)
    roots = [n.id for n in g.nodes if n.type == "O"][-2:]
    pbuf = cpu_wl.cells["TreeGRU-Internal"].init_params(
        np.random.default_rng(1), device="cpu")

    def grad(run, device):
        leaf = pbuf.detach().clone().to(device).requires_grad_(True)
        y = run({"I": leaf}).field("y", roots)
        loss = (y * torch.linspace(-1, 1, y.numel(), device=device)
                .view_as(y)).sum()
        return float(loss.detach()), torch.autograd.grad(loss, leaf)[0]

    before = gather_rows_backward.launches
    card_ex = DynamicExecutor(card_wl.impls, None, device=cuda)
    loss, got = grad(lambda p: card_ex.run(g, policy, params=p), cuda)
    torch.cuda.synchronize()
    assert gather_rows_backward.launches > before
    cpu_ex = DynamicExecutor(cpu_wl.impls, None, device="cpu")
    want_loss, want = grad(lambda p: cpu_ex.run(g, policy, params=p), "cpu")
    assert abs(loss - want_loss) <= 1e-4 * max(abs(want_loss), 1.0)
    assert _grad_err(got.cpu(), want) <= 2e-3
    plan = CompiledPlan(g, resolve_schedule(g, policy), card_wl.impls,
                        max_pq_vars=48, device=cuda)
    plan_loss, plan_got = grad(lambda p: plan.execute(g, params=p), cuda)
    assert abs(plan_loss - loss) <= 1e-4 * max(abs(loss), 1.0)
    assert _grad_err(plan_got, got) <= 1e-4
    bucketed = BucketedPlanExecutor(card_wl.impls, None, device=cuda)
    with pytest.raises(RuntimeError, match="fused cells' backward"):
        bucketed.run(g, policy, params={"I": pbuf.to(cuda).requires_grad_()})


# -- background capture: a worker thread builds while the loop serves ------


def _lm_buckets(cuda, counts=(8, 16)):
    """ChainLM impls, slot-pool params, policy and one feed-round graph per
    padded entry count in ``counts`` (one bucket signature each)."""
    from repro_torch.serve.scheduler import (RoundPlan,
                                             build_lm_feed_round_graph)

    impls, graphs, params, policy = _bucket_case("ChainLM", cuda)
    rng = np.random.default_rng(1)
    out = [graphs[0]]
    for count in counts[1:]:
        g, _ = build_lm_feed_round_graph(RoundPlan(), count=count)
        for n in g.nodes:
            if n.type == "R":
                n.attrs["aux"] = (n.id // 4) % 8
            elif n.type == "E":
                n.attrs["aux"] = int(rng.integers(0, 256))
        out.append(g)
    return impls, out, params, policy


def _slow_capture(monkeypatch, impls, inside, release, fail_once=False,
                  pause=0.0):
    """Make the cells' fused path, while its thread captures, signal
    ``inside``, wait for ``release`` and sleep ``pause`` s (and with
    ``fail_once`` then sync the host, which invalidates the capture, the
    first time)."""
    import time

    failed = []

    def wrap(fn):
        def fused(params, bufs, idxs, aux):
            if torch.cuda.is_current_stream_capturing():
                inside.set()
                assert release.wait(30)
                time.sleep(pause)
                if fail_once and not failed:
                    failed.append(1)
                    idxs[0].sum().item()
            return fn(params, bufs, idxs, aux)
        return fused

    for impl in impls.values():
        if impl.fused_gather is not None:
            monkeypatch.setattr(impl, "fused_gather", wrap(impl.fused_gather))


def _capture_beside_the_loop(cuda, monkeypatch):
    """A worker captures bucket B while the main thread replays bucket A
    three times, copies each result to the host and allocates 256 MB.
    Returns what each thread saw, the launch counts over the window and one
    run's counts of each bucket."""
    import threading

    from repro_torch.core.plan import BucketedPlanExecutor
    from repro_torch.kernels import launches

    impls, (ga, gb), params, policy = _lm_buckets(cuda)
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    want = {}
    one = {}
    for name, g in (("a", ga), ("b", gb)):
        eager.run(g, policy)
        before = launches.snapshot()
        want[name] = _outputs(eager.run(g, policy), g)
        one[name] = launches.delta(before, launches.snapshot())
    ex.run(ga, policy)                       # A captured on this thread
    pack_b = ex.pack_for(gb, policy)
    inside, release = threading.Event(), threading.Event()
    _slow_capture(monkeypatch, impls, inside, release)
    errors = []

    def worker():
        try:
            ex.build_executable(pack_b, params)
        except BaseException as exc:   # reported by the test
            errors.append(exc)

    torch.cuda.synchronize()
    before = launches.snapshot()
    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(30)
        got_a = []
        for _ in range(3):
            res = _outputs(ex.run(ga, policy), ga)
            got_a.append({k: v.cpu() for k, v in res.items()})
            big = torch.empty(64 << 20, device=cuda)
            big.fill_(1.0)
            assert big[-1].item() == 1.0
            del big
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()
    torch.cuda.synchronize()
    window = launches.delta(before, launches.snapshot())
    got_b = _outputs(ex.run(gb, policy), gb)
    return dict(errors=errors, got_a=got_a, got_b=got_b, want=want,
                window=window, one=one, ex=ex)


def test_capture_on_a_worker_beside_replays_copies_and_allocation(
        cuda, monkeypatch):
    """The worker's capture is held to the capture's rules on its thread
    only: while it is open the main thread replays another bucket, copies
    the results to the host and allocates. The capture lands, and both
    buckets equal their eager runs bit for bit."""
    run = _capture_beside_the_loop(cuda, monkeypatch)
    assert not run["errors"], run["errors"]
    assert run["ex"].n_captures == 2
    for got in run["got_a"]:
        assert all(torch.equal(got[k], t.cpu())
                   for k, t in run["want"]["a"].items())
    assert all(torch.equal(run["got_b"][k], t)
               for k, t in run["want"]["b"].items())


def test_launch_counters_equal_what_ran_beside_a_capture(cuda, monkeypatch):
    """Over the window of a worker's capture the counters move by what
    ran: the main thread's three replays of A and the worker's eager
    warm-up of B; the capture itself adds nothing, and takes nothing
    away."""
    run = _capture_beside_the_loop(cuda, monkeypatch)
    assert not run["errors"], run["errors"]
    one, window = run["one"], run["window"]
    for name in ("gather_rows", "fused_gather_lstm_cell"):
        assert one["a"][name] > 0 and one["b"][name] > 0
        assert window[name] == 3 * one["a"][name] + one["b"][name], name
    assert window["gather_shapes"] == Counter(
        {k: 3 * n for k, n in one["a"]["gather_shapes"].items()}) \
        + one["b"]["gather_shapes"]


def test_weight_copies_built_on_a_worker_stream_are_waited_for(cuda):
    """A worker builds a cell's blocked and packed weights on its own
    stream behind a long ``_sleep`` (in memory it first filled with NaN and
    freed); the main thread then runs the cell on its stream through the
    same cache while the worker's stream still sleeps. It waits for the
    copies: both runs equal an untouched twin's bit for bit."""
    import threading

    from repro_torch.core.executor import derived_copies
    from repro_torch.kernels.fused_cell import packed_weights

    def cell_of(impls):
        return next(i for i in impls.values() if i.fused_gather is not None)

    impls0, _, _, _ = _lm_buckets(cuda, counts=(8,))
    impls, _, _, _ = _lm_buckets(cuda, counts=(8,))
    g = torch.Generator(device=cuda).manual_seed(0)
    H = cell_of(impls0).out_fields["h_out"][0]
    # the buffer holds the (E + H) x 4H gate weights and the 4H biases
    E = cell_of(impls0).params["pbuf"].numel() // (4 * H) - H - 1
    bufs = [torch.randn((40, n), generator=g, device=cuda)
            for n in (E, H, H)]
    idxs = [torch.randint(0, 40, (16,), generator=g, device=cuda,
                          dtype=torch.int32) for _ in range(3)]
    with derived_copies() as found:
        want = cell_of(impls0).fused_gather(None, bufs, idxs, None)
    sizes = {(t.shape, t.dtype) for _, _, (w, b) in found
             for t in (w, b, packed_weights(w))}
    del found
    torch.cuda.synchronize()
    theirs = []

    def worker():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            junk = [torch.full(shape, float("nan"), dtype=dtype, device=cuda)
                    for shape, dtype in sizes for _ in range(4)]
            del junk
            torch.cuda._sleep(2_000_000_000)
            theirs.append(cell_of(impls).fused_gather(None, bufs, idxs, None))

    t = threading.Thread(target=worker)
    t.start()
    t.join(60)            # the worker queued its work and is gone
    assert not t.is_alive()
    mine = cell_of(impls).fused_gather(None, bufs, idxs, None)
    torch.cuda.synchronize()
    for got in (mine, theirs[0]):
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_two_workers_capturing_at_once_both_land(cuda, monkeypatch):
    """Three workers start builds together: two signatures, one of them
    twice. The builds take turns under the build lock; each signature is
    captured once (the duplicate takes the entry its twin built), both
    land, and each replays what its eager run computes."""
    import threading

    from repro_torch.core.plan import BucketedPlanExecutor

    impls, (ga, gb), params, policy = _lm_buckets(cuda)
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    want = [_outputs(eager.run(g, policy), g) for g in (ga, gb)]
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    packs = [ex.pack_for(g, policy) for g in (ga, ga, gb)]
    inside, release = threading.Event(), threading.Event()
    release.set()
    _slow_capture(monkeypatch, impls, inside, release, pause=0.2)
    start = threading.Barrier(3)
    got, errors = [None] * 3, []

    def worker(i):
        try:
            start.wait(10)
            got[i] = ex.build_executable(packs[i], params)[1]
        except BaseException as exc:   # reported by the test
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors, errors
    assert ex.n_captures == 2 and got[0] is got[1] is not got[2]
    assert all(e.graph is not None for e in got)
    for g, w in zip((ga, gb), want):
        res = _outputs(ex.run(g, policy), g)
        assert all(torch.equal(res[k], t) for k, t in w.items())
    assert ex.n_captures == 2


def test_an_abandoned_capture_leaves_the_card_usable(cuda, monkeypatch):
    """A build job times out inside its capture and is abandoned (no
    retry); the capture then fails (a host sync invalidates it) on the
    abandoned worker. The late failure is not counted, and the card still
    draws random numbers and captures on the loop's thread."""
    import threading
    import time

    from repro_torch.core.plan import BucketedPlanExecutor
    from repro_torch.serve.compiler import CompileService

    impls, (ga, gb), params, policy = _lm_buckets(cuda)
    eager = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda,
                                 capture=False)
    want = [_outputs(eager.run(g, policy), g) for g in (ga, gb)]
    ex = BucketedPlanExecutor(impls, params, ladder=(8,), device=cuda)
    pack = ex.pack_for(ga, policy)
    inside, release = threading.Event(), threading.Event()
    _slow_capture(monkeypatch, impls, inside, release, fail_once=True)
    svc = CompileService(workers=1, timeout_s=0.5, max_retries=0)

    def build(job, span_args, abort):
        return ex.build_executable(pack, params, abort_check=abort)[2]

    stream = torch.cuda.current_stream(cuda)
    svc.submit("a", build)
    assert inside.wait(30)
    deadline = time.monotonic() + 30
    while not svc.stats["timeouts"] and time.monotonic() < deadline:
        svc.poll()
        time.sleep(0.05)
    assert svc.stats["timeouts"] == svc.stats["quarantined"] == 1
    release.set()
    svc._abandoned[0].thread.join(30)     # its capture has failed by now
    assert not svc._abandoned[0].thread.is_alive()
    assert svc.poll() == [] and svc.stats["failures"] == 0
    assert svc.stats["landed"] == svc.stats["late_lands"] == 0
    svc.shutdown()
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda) == stream
    torch.randn(4, device=cuda)          # the generator left capture mode
    assert ex.n_captures == 0
    for g, w in zip((ga, gb), want):     # both captured here, anew
        res = _outputs(ex.run(g, policy), g)
        assert all(torch.equal(res[k], t) for k, t in w.items())
    assert ex.n_captures == 2
    torch.cuda.synchronize()


# -- the sharded bucketed path ------------------------------------------------


def _sharded_case(cuda, counts=(8, 16), k=2):
    """ChainLM impls, a stacked (k, 8, 64) slot pool, the policy and, per
    padded entry count in ``counts``, one feed-round graph per shard (one
    sharded bucket signature each; the shards read other slots and
    tokens)."""
    from repro_torch.serve.scheduler import (RoundPlan,
                                             build_lm_feed_round_graph)

    impls, _, params, policy = _bucket_case("ChainLM", cuda)
    rng = np.random.default_rng(2)
    pool = {f: torch.stack([v] + [torch.as_tensor(
        rng.standard_normal(v.shape), dtype=v.dtype, device=cuda)
        for _ in range(k - 1)]) for f, v in params["slots"].items()}
    rounds = []
    for count in counts:
        graphs = []
        for s in range(k):
            g, _ = build_lm_feed_round_graph(RoundPlan(), count=count)
            for n in g.nodes:
                if n.type == "R":
                    n.attrs["aux"] = (n.id // 4 + s) % 8
                elif n.type == "E":
                    n.attrs["aux"] = int(rng.integers(0, 256))
            graphs.append(g)
        rounds.append(graphs)
    return impls, rounds, {"slots": pool}, policy


def _shard_outputs(results, graphs):
    return [_outputs(r, g) for r, g in zip(results, graphs)]


def test_sharded_replay_equals_the_single_shard_replays(cuda):
    """One replay runs both shards' bodies: each shard equals the
    single-device captured run over its row of the pool (the same kernels
    at the same shapes) within 1e-6, and an eager sharded run bit for
    bit."""
    from repro_torch.core.plan import (BucketedPlanExecutor,
                                       ShardedBucketedPlanExecutor)

    impls, (graphs, _), sp, policy = _sharded_case(cuda)
    ex = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                     device=cuda)
    eager = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                        device=cuda, capture=False)
    single = BucketedPlanExecutor(impls, None, ladder=(8,), device=cuda)
    ex.run_sharded(graphs, policy, shard_params=sp)
    got = _shard_outputs(ex.run_sharded(graphs, policy, shard_params=sp),
                         graphs)
    assert ex.n_captures == 1 and ex.n_replays == 2
    want = _shard_outputs(eager.run_sharded(graphs, policy, shard_params=sp),
                          graphs)
    for s, g in enumerate(graphs):
        mine = {"slots": {f: v[s] for f, v in sp["slots"].items()}}
        one = _outputs(single.run(g, policy, params=mine), g)
        for key, t in got[s].items():
            assert torch.equal(t, want[s][key]), (s, key)
            assert float((t - one[key]).abs().max()) <= 1e-6, (s, key)


def test_per_card_replays_on_cuda0_twice_equal_the_stacked_replay(cuda):
    """Replicas one a card with both placements naming cuda:0: each
    captures a graph of its own (the second reads its own copy of the
    weights) and replays it, and each shard's outputs equal the stacked
    K = 2 replay's bit for bit, over the same slot rows."""
    from repro_torch.core.plan import PerCard, ShardedBucketedPlanExecutor
    from repro_torch.launch.mesh import make_data_mesh

    impls, (graphs, _), sp, policy = _sharded_case(cuda)
    stacked = ShardedBucketedPlanExecutor(impls, None, n_shards=2,
                                          ladder=(8,), device=cuda)
    cards = ShardedBucketedPlanExecutor(
        impls, None, ladder=(8,), device=cuda,
        mesh=make_data_mesh(2, devices=("cuda:0", "cuda:0")))
    mine = {"slots": {f: PerCard(v[s].clone() for s in range(2))
                      for f, v in sp["slots"].items()}}
    for _ in range(2):       # the first run captures, the second replays
        want = _shard_outputs(stacked.run_sharded(graphs, policy,
                                                  shard_params=sp), graphs)
        got = _shard_outputs(cards.run_sharded(graphs, policy,
                                               shard_params=mine), graphs)
        for s in range(2):
            assert all(torch.equal(got[s][k], t)
                       for k, t in want[s].items()), s
    assert cards.n_captures == 2 and cards.n_replays == 4
    assert [c.copy_weights for c in cards.card_executors] == [False, True]


def test_per_card_engine_on_cuda0_twice_gives_the_stacked_tokens(cuda):
    """An engine placed per card on cuda:0 twice serves the stacked
    engine's tokens, through a shard loss and a regrowth after which its
    K = 2 graphs replay again (each placement's pool kept its address)."""
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    wls = {"lm": make_workload("ChainLM", 64, 0, device=cuda)}

    def engine(**kw):
        eng = ServeEngine(dict(wls), max_slots=8, n_shards=2, device=cuda,
                          **kw)
        reqs = [lm_request([i + 1, i + 2, i + 3], 10, arrival=0.0)
                for i in range(6)]
        eng.submit_many(reqs)
        return eng, reqs

    clean, clean_reqs = engine()
    clean.run()
    eng, reqs = engine(devices=("cuda:0", "cuda:0"))
    for _ in range(4):
        eng.step()
    eng.lose_shard(1)
    for _ in range(3):
        eng.step()
    eng.regrow_shard()
    eng._fold_exec_stats()
    captures = eng.stats.n_graph_captures
    eng.step()
    eng._fold_exec_stats()
    assert eng.n_shards == 2 and eng.stats.n_graph_captures == captures
    eng.run()
    assert [r.out for r in reqs] == [r.out for r in clean_reqs]


def test_in_place_stacked_pool_update_is_seen_by_the_next_sharded_replay(
        cuda):
    """The sharded graph reads each shard's row of the stacked pool at its
    captured address: an in-place update of the stack is read by the next
    replay (no new capture), equal to an eager run over the updated
    pool."""
    from repro_torch.core.plan import ShardedBucketedPlanExecutor

    impls, (graphs, _), sp, policy = _sharded_case(cuda)
    ex = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                     device=cuda)
    eager = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                        device=cuda, capture=False)
    before = _shard_outputs(ex.run_sharded(graphs, policy, shard_params=sp),
                            graphs)
    for t in sp["slots"].values():
        t[1].mul_(-0.5).add_(0.25)
    got = _shard_outputs(ex.run_sharded(graphs, policy, shard_params=sp),
                         graphs)
    want = _shard_outputs(eager.run_sharded(graphs, policy, shard_params=sp),
                          graphs)
    assert ex.n_captures == 1 and ex.n_replays == 2
    for s in range(2):
        assert all(torch.equal(got[s][k], t) for k, t in want[s].items())
    assert all(torch.equal(got[0][k], t) for k, t in before[0].items())
    assert not all(torch.equal(got[1][k], t) for k, t in before[1].items())


def test_sharded_captures_are_reused_after_shrink_and_regrow(cuda):
    """The engine's stacked pool keeps its addresses across a shrink and a
    regrow, so the K = 2 graphs captured before the loss replay again
    after the regrow (no new capture), and the tokens equal a clean K = 2
    run's."""
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    wls = {"lm": make_workload("ChainLM", 64, 0, device=cuda)}

    def engine():
        eng = ServeEngine(dict(wls), max_slots=8, n_shards=2, device=cuda)
        reqs = [lm_request([i + 1, i + 2, i + 3], 10, arrival=0.0)
                for i in range(6)]
        eng.submit_many(reqs)
        return eng, reqs

    clean, clean_reqs = engine()
    clean.run()
    eng, reqs = engine()
    for _ in range(4):
        eng.step()
    eng._fold_exec_stats()
    captured_k2 = eng.stats.n_graph_captures
    assert captured_k2 >= 1 and eng.stats.n_sharded_dispatches == 4
    eng.lose_shard(1)
    for _ in range(3):
        eng.step()
    eng.regrow_shard()
    eng._fold_exec_stats()
    captures, dispatches = (eng.stats.n_graph_captures,
                            eng.stats.n_sharded_dispatches)
    eng.step()
    eng._fold_exec_stats()
    assert eng.n_shards == 2
    assert eng.stats.n_sharded_dispatches == dispatches + 1
    assert eng.stats.n_graph_captures == captures
    eng.run()
    assert [r.out for r in reqs] == [r.out for r in clean_reqs]


def test_background_sharded_capture_beside_the_loop(cuda, monkeypatch):
    """A worker captures sharded bucket B (both shards' bodies) while the
    main thread replays sharded bucket A three times, copies each result
    to the host and allocates 256 MB. The capture lands, both buckets
    equal their eager runs bit for bit, and the launch counters over the
    window move by the three replays of A and the worker's warm-up of B."""
    import threading
    from dataclasses import replace

    from repro_torch.core.plan import ShardedBucketedPlanExecutor
    from repro_torch.kernels import launches

    impls, (ga, gb), sp, policy = _sharded_case(cuda)
    eager = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                        device=cuda, capture=False)
    ex = ShardedBucketedPlanExecutor(impls, None, n_shards=2, ladder=(8,),
                                     device=cuda)
    want, one = {}, {}
    for name, gs in (("a", ga), ("b", gb)):
        eager.run_sharded(gs, policy, shard_params=sp)
        before = launches.snapshot()
        want[name] = _shard_outputs(
            eager.run_sharded(gs, policy, shard_params=sp), gs)
        one[name] = launches.delta(before, launches.snapshot())
    ex.run_sharded(ga, policy, shard_params=sp)     # A captured here
    packs_b = [ex.pack_for(g, policy) for g in gb]
    sspec_b = replace(packs_b[0].spec, n_shards=2)
    inside, release = threading.Event(), threading.Event()
    _slow_capture(monkeypatch, impls, inside, release)
    errors = []

    def worker():
        try:
            ex.build_sharded_executable(sspec_b, None, sp, packs=packs_b)
        except BaseException as exc:   # reported by the test
            errors.append(exc)

    torch.cuda.synchronize()
    before = launches.snapshot()
    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(30)
        got_a = []
        for _ in range(3):
            res = _shard_outputs(ex.run_sharded(ga, policy, shard_params=sp),
                                 ga)
            got_a.append([{k: v.cpu() for k, v in r.items()} for r in res])
            big = torch.empty(64 << 20, device=cuda)
            big.fill_(1.0)
            assert big[-1].item() == 1.0
            del big
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()
    torch.cuda.synchronize()
    window = launches.delta(before, launches.snapshot())
    assert not errors, errors
    assert ex.n_captures == 2
    got_b = _shard_outputs(ex.run_sharded(gb, policy, shard_params=sp), gb)
    for got in got_a:
        for s in range(2):
            assert all(torch.equal(got[s][k], t.cpu())
                       for k, t in want["a"][s].items())
    for s in range(2):
        assert all(torch.equal(got_b[s][k], t)
                   for k, t in want["b"][s].items())
    for name in ("gather_rows", "fused_gather_lstm_cell"):
        assert one["a"][name] > 0 and one["b"][name] > 0
        assert window[name] == 3 * one["a"][name] + one["b"][name], name


def test_sharded_engine_commits_into_the_pool_its_graph_reads(cuda):
    """Each sharded lm round writes the entries' state into the stacked
    pool in place, where the next round's replay reads it: a K = 2
    engine's tokens equal a K = 1 engine's, its steady rounds replay
    without capturing, and the pool keeps its addresses."""
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    wls = {"lm": make_workload("ChainLM", 64, 0, device=cuda)}

    def serve(k):
        eng = ServeEngine(dict(wls), max_slots=8, n_shards=k, device=cuda)
        reqs = [lm_request([i + 1, i + 2, i + 3], 8, arrival=float(i // 3))
                for i in range(6)]
        eng.submit_many(reqs)
        ptrs = {f: t.data_ptr() for f, t in eng._lm_pool().items()}
        stats = eng.run()
        assert {f: t.data_ptr() for f, t in eng._pool.items()} == ptrs
        return [r.out for r in reqs], stats

    one, _ = serve(1)
    two, stats = serve(2)
    assert two == one
    assert stats.n_sharded_dispatches == stats.tier_rounds["sharded"] > 4
    assert stats.n_graph_replays > stats.n_graph_captures


# -- the captured per-topology plan, LM wave and train step -------------------


def _plan_case(name, cuda):
    """(impls, two graphs of one topology with other aux, params, policy)
    from :func:`_bucket_case`: a ChainLM feed round's two graphs share one
    topology; a tagger's or a TreeLSTM's graph is paired with itself."""
    impls, graphs, params, policy = _bucket_case(name, cuda)
    assert graphs[0].topology_key() == graphs[1].topology_key()
    return impls, graphs, params, policy


@pytest.mark.parametrize("name", ["BiLSTM-Tagger", "TreeLSTM", "ChainLM"])
def test_captured_plan_replay_equals_eager_bit_for_bit(cuda, name):
    """A per-topology plan captured once replays what the eager plan
    computes, bit for bit, on every node output; each run is one counted
    launch and one replay, and each replay adds to the kernels' counters
    exactly what one eager run launches."""
    from repro_torch.core.executor import ExecStats
    from repro_torch.core.plan import PlanExecutor
    from repro_torch.kernels import launches

    impls, graphs, params, policy = _plan_case(name, cuda)
    ex = PlanExecutor(impls, params, device=cuda)
    eager = PlanExecutor(impls, params, device=cuda, capture=False)
    stats = ExecStats()
    for g in graphs + graphs:
        got = _outputs(ex.run(g, policy, stats), g)
        want = _outputs(eager.run(g, policy), g)
        for k, t in want.items():
            assert torch.equal(got[k], t), k
    assert (ex.n_captures, ex.n_replays) == (1, 4)
    assert eager.n_captures == eager.n_replays == 0
    assert (stats.n_launches, stats.n_compiles) == (4, 1)
    g = graphs[0]
    before = launches.snapshot()
    eager.run(g, policy)
    one = launches.delta(before, launches.snapshot())
    before = launches.snapshot()
    ex.run(g, policy)
    assert launches.delta(before, launches.snapshot()) == one
    assert ex.plan_for(g, policy)._exes.peek(
        ex.plan_for(g, policy).executable_key(params)).counts == one


def test_captured_plan_is_built_again_after_an_in_place_weight_update(cuda):
    """The key carries the weights' versions: a weight updated in place
    makes another entry, captured over the new values, which equals the
    eager plan's run on them."""
    from repro_torch.core.plan import PlanExecutor

    impls, graphs, params, policy = _plan_case("TreeLSTM", cuda)
    g = graphs[0]
    ex = PlanExecutor(impls, params, device=cuda)
    eager = PlanExecutor(impls, params, device=cuda, capture=False)
    first = _outputs(ex.run(g, policy), g)
    weight = next(t for impl in impls.values() for t in impl.params.values())
    weight.mul_(0.5)
    got = _outputs(ex.run(g, policy), g)
    want = _outputs(eager.run(g, policy), g)
    assert ex.n_captures == 2
    assert all(torch.equal(got[k], t) for k, t in want.items())
    assert not all(torch.equal(got[k], t) for k, t in first.items())


def test_failed_plan_capture_raises_and_leaves_the_card_usable(
        cuda, monkeypatch):
    """A plan body that syncs the host only while it is captured fails
    inside the capture: the run raises, nothing is cached, the stream is
    the one before, the generator draws again, and the eager plan still
    runs; the serve engine's per-topology tier books it as a failed build
    and serves the rounds on the interpreted floor."""
    from repro_torch.core.plan import PlanExecutor
    from repro_torch.models.workloads import make_workload
    from repro_torch.serve import ServeEngine, lm_request

    impls, graphs, params, policy = _plan_case("TreeLSTM", cuda)
    g = graphs[0]
    want = _outputs(PlanExecutor(impls, params, device=cuda,
                                 capture=False).run(g, policy), g)

    def syncing(apply):
        def inner(p, inputs, aux):
            if torch.cuda.is_current_stream_capturing():
                aux.sum().item()
            return apply(p, inputs, aux)
        return inner

    for impl in impls.values():
        monkeypatch.setattr(impl, "apply", syncing(impl.apply))
    ex = PlanExecutor(impls, params, device=cuda)
    stream = torch.cuda.current_stream(cuda)
    with pytest.raises(RuntimeError):
        ex.run(g, policy)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda) == stream
    torch.randn(4, device=cuda)          # the generator left capture mode
    p = ex.plan_for(g, policy)
    assert p._exes.peek(p.executable_key(params)) is None
    assert ex.n_captures == 0
    got = _outputs(PlanExecutor(impls, params, device=cuda,
                                capture=False).run(g, policy), g)
    assert all(torch.equal(got[k], t) for k, t in want.items())

    def serve(wl):
        eng = ServeEngine({"lm": wl}, max_slots=4, bucketed=False,
                          device=cuda)
        reqs = [lm_request([1, 2, 3], 4), lm_request([7, 5], 4)]
        eng.submit_many(reqs)
        return reqs, eng.run()

    clean, clean_stats = serve(make_workload("ChainLM", 64, 0, device=cuda))
    assert set(clean_stats.tier_rounds) == {"plan"}
    assert clean_stats.n_graph_captures >= 1
    assert clean_stats.n_graph_replays >= 1
    wl = make_workload("ChainLM", 64, 0, device=cuda)
    for impl in wl.impls.values():
        monkeypatch.setattr(impl, "apply", syncing(impl.apply))
    reqs, stats = serve(wl)
    assert all(r.status == "COMPLETED" for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in clean]
    assert stats.n_quarantine_events >= 1
    assert stats.tier_rounds.get("interpreted", 0) >= 1
    assert stats.n_graph_captures == 0
    torch.cuda.synchronize()


def test_a_second_thread_replays_a_captured_plan(cuda):
    """A plan captured on the main thread replays on a worker thread, on
    a stream of its own, while the main thread allocates and frees: the
    worker's results equal the eager plan's bit for bit."""
    import threading

    from repro_torch.core.plan import PlanExecutor

    impls, graphs, params, policy = _plan_case("BiLSTM-Tagger", cuda)
    g = graphs[0]
    ex = PlanExecutor(impls, params, device=cuda)
    want = _outputs(PlanExecutor(impls, params, device=cuda,
                                 capture=False).run(g, policy), g)
    ex.run(g, policy)
    got, errors = [], []

    def worker():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(3):
                    res = _outputs(ex.run(g, policy), g)
                    got.append({k: v.cpu() for k, v in res.items()})
        except BaseException as exc:   # reported by the test
            errors.append(exc)

    t = threading.Thread(target=worker)
    t.start()
    for _ in range(3):
        big = torch.empty(64 << 20, device=cuda)
        big.fill_(1.0)
        del big
    t.join(60)
    assert not t.is_alive() and not errors, errors
    assert ex.n_captures == 1 and ex.n_replays == 4
    for res in got:
        assert all(torch.equal(res[k], t.cpu()) for k, t in want.items())


def _lm_pair(name, cuda):
    """A reduced LM on the card and its params (Mamba2 at a chunk of 32)."""
    import dataclasses

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=32)
    model = TransformerLM(cfg, device=cuda)
    params = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    return model, tree_map(lambda t: t.to(cuda), params)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m",
                                  "granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_lm_wave_replays_give_the_eager_tokens(cuda, name):
    """Two waves of the same shape, the requests' lengths swapped between
    slots, through one engine whose prefill and decode steps are captured,
    beside an eager engine: equal tokens (the second wave zeroes the
    first's pool in place before it); the first wave captures
    each program once and replays the rest, the second only replays; and
    the kernels' counters move by the same launches in both engines (each
    warm-up is a real step)."""
    from repro_torch.kernels import launches
    from repro_torch.serve.lm_wave import ServeEngine, ServeStats

    model, params = _lm_pair(name, cuda)
    rng = np.random.default_rng(0)
    waves = [[rng.integers(0, model.cfg.vocab, n).tolist() for n in lengths]
             for lengths in ((32, 64, 32), (32, 32, 64))]
    engines = {mode: ServeEngine(model, params, cache_len=80, device=cuda,
                                 capture=mode == "captured")
               for mode in ("captured", "eager")}
    for w, prompts in enumerate(waves):
        outs, moved = {}, {}
        for mode, eng in engines.items():
            stats = ServeStats()
            before = launches.snapshot()
            outs[mode], _ = eng.generate(prompts, 5, stats=stats)
            torch.cuda.synchronize()
            moved[mode] = launches.delta(before, launches.snapshot())
            if mode == "eager":
                assert stats.n_captures == stats.n_replays == 0
            elif w == 0:
                assert stats.n_captures == 3       # two prefills, a decode
                assert stats.n_replays == 3        # decodes 2-4
            else:
                assert stats.n_captures == 0 and stats.n_replays == 6
        assert outs["captured"] == outs["eager"]
        assert moved["captured"] == moved["eager"]
        kernel = "ssd_scan" if model.cfg.ssm_state else "flash_attention"
        assert moved["captured"][kernel] > 0


def test_failed_decode_capture_raises_and_leaves_the_card_usable(
        cuda, monkeypatch):
    """A decode step that syncs the host while it is captured fails inside
    its capture: the wave raises (no eager fallback), the stream is the one
    before and the generator draws again."""
    from repro_torch.serve.lm_wave import ServeEngine

    model, params = _lm_pair("qwen2-0.5b", cuda)
    decode = model.decode_step

    def syncing(p, token, caches, pos):
        if torch.cuda.is_current_stream_capturing():
            pos.sum().item()
        return decode(p, token, caches, pos)

    monkeypatch.setattr(model, "decode_step", syncing)
    stream = torch.cuda.current_stream(cuda)
    eng = ServeEngine(model, params, cache_len=48, device=cuda)
    with pytest.raises(RuntimeError):
        eng.generate([[1, 2, 3], [4, 5, 6]], 3)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda) == stream
    torch.randn(4, device=cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m",
                                  "granite-moe-1b-a400m",
                                  "llama-3.2-vision-11b"])
def test_train_step_replays_equal_eager_steps_bit_for_bit(cuda, name):
    """Four static train steps captured (the first the warm-up, then
    three replays) beside four eager ones over the same buffers: equal
    losses and parameters bit for bit (the backward kernels' programmatic
    dependents keep their edges in the graph), and each replay adds to the
    counters what an eager step launches, the backward kernels (queued by
    autograd's thread) included."""
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.kernels import launches
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig

    model, params = _lm_pair(name, cuda)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    seq = 64
    runs = {}
    for mode in ("captured", "eager"):
        step = StaticTrainStep(model, opt, params,
                               capture=mode == "captured")
        corpus = SyntheticCorpus(PipelineConfig(
            vocab=model.cfg.vocab, seq_len=seq, batch_size=2, seed=1,
            n_image_tokens=model.cfg.n_image_tokens,
            d_model=model.cfg.d_model))
        losses, moved = [], []
        for _ in range(4):
            before = launches.snapshot()
            m = step(corpus.batch())
            losses.append(float(m["loss"]))
            moved.append(launches.delta(before, launches.snapshot()))
        runs[mode] = (losses, moved, step)
    (lc, mc, sc), (le, me, se) = runs["captured"], runs["eager"]
    assert len(sc._graphs) == 1 and not se._graphs
    assert lc == le
    assert mc == me
    kernel = ("ssd_scan_backward" if model.cfg.ssm_state
              else "flash_attention_backward")
    assert mc[-1][kernel] == model.cfg.n_layers
    n_moe = sum(s.ffn == "moe" for s in model.cfg.pattern) \
        * model.cfg.n_repeats
    assert mc[-1]["gather_rows"] == mc[-1]["gather_rows_backward"] \
        == 2 * n_moe
    for a, b in zip(sc.params + sc.mu + sc.nu, se.params + se.mu + se.nu):
        assert torch.equal(a, b)
    assert int(sc.step) == int(se.step) == 4


def test_failed_train_step_capture_raises_and_leaves_the_card_usable(
        cuda, monkeypatch):
    """A loss that syncs the host while it is captured fails inside the
    train step's capture: the step raises, the stream is the one before,
    the generator draws again, and an eager step still runs."""
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig

    model, params = _lm_pair("qwen2-0.5b", cuda)
    loss = model.loss

    def syncing(p, batch):
        if torch.cuda.is_current_stream_capturing():
            batch["tokens"].sum().item()
        return loss(p, batch)

    monkeypatch.setattr(model, "loss", syncing)
    batch = SyntheticCorpus(PipelineConfig(vocab=model.cfg.vocab, seq_len=32,
                                           batch_size=2, seed=0)).batch(0)
    stream = torch.cuda.current_stream(cuda)
    with pytest.raises(RuntimeError):
        StaticTrainStep(model, AdamWConfig(), params)(batch)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda) == stream
    torch.randn(4, device=cuda)
    m = StaticTrainStep(model, AdamWConfig(), params, capture=False)(batch)
    assert np.isfinite(float(m["loss"]))


def test_only_the_large_programs_empty_the_cache_before_a_capture(
        cuda, monkeypatch):
    """A capture cannot give cached memory back to the card, so the train
    step and the LM wave's steps empty the cache (and collect garbage)
    after their warm-up and before their capture; a per-topology plan does
    not, since emptying the cache synchronises the card and serve workers
    capture while the engine serves."""
    from repro_torch.core.plan import PlanExecutor
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.serve.lm_wave import ServeEngine, ServeStats
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig

    emptied = []
    empty = torch.cuda.empty_cache
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: (emptied.append(1), empty()))
    impls, graphs, params, policy = _plan_case("TreeLSTM", cuda)
    ex = PlanExecutor(impls, params, device=cuda)
    ex.run(graphs[0], policy)
    assert ex.n_captures == 1 and not emptied

    model, lm_params = _lm_pair("qwen2-0.5b", cuda)
    stats = ServeStats()
    ServeEngine(model, lm_params, cache_len=48, device=cuda).generate(
        [[1, 2, 3], [4, 5, 6]], 3, stats=stats)
    assert stats.n_captures == 2 and len(emptied) == 2

    batch = SyntheticCorpus(PipelineConfig(vocab=model.cfg.vocab, seq_len=32,
                                           batch_size=2, seed=0)).batch(0)
    StaticTrainStep(model, AdamWConfig(), lm_params)(batch)
    assert len(emptied) == 3


def test_a_graph_in_a_reference_cycle_is_not_freed_during_a_capture(cuda):
    """Destroying a CUDA graph while a stream captures invalidates the
    capture, and Python frees a graph held in a reference cycle whenever
    its cyclic collector runs. The collector is off while a capture runs:
    with a graph in a cycle and the collector set to run every few
    allocations, collections run around a new plan's capture but none
    while its stream captures; the capture lands and replays its eager
    run, and the graph in the cycle goes at the next collection."""
    import gc
    import weakref

    from repro_torch.core.plan import PlanExecutor

    impls, graphs, params, policy = _plan_case("TreeLSTM", cuda)
    g = graphs[0]
    ex = PlanExecutor(impls, params, device=cuda)
    ex.run(g, policy)
    p = ex.plan_for(g, policy)
    entry = p._exes.peek(p.executable_key(params))
    assert entry.graph is not None
    entry.cycle = entry                    # a cycle holding the graph
    gone = weakref.ref(entry)
    del entry, p, ex
    capturing = []

    def started(phase, info):
        if phase == "start":
            capturing.append(torch.cuda.is_current_stream_capturing())

    enabled, thresholds = gc.isenabled(), gc.get_threshold()
    gc.enable()
    gc.set_threshold(10)
    gc.callbacks.append(started)
    try:
        fresh = PlanExecutor(impls, params, device=cuda)
        got = _outputs(fresh.run(g, policy), g)
    finally:
        gc.callbacks.remove(started)
        gc.set_threshold(*thresholds)
        if not enabled:
            gc.disable()
    assert capturing and not any(capturing)
    assert fresh.n_captures == 1
    gc.collect()
    assert gone() is None
    want = _outputs(PlanExecutor(impls, params, device=cuda,
                                 capture=False).run(g, policy), g)
    assert all(torch.equal(got[k], t) for k, t in want.items())


# -- the MoE layer and cross-attention ----------------------------------------


def _moe_setup(cuda, name, N, seed=0):
    """An MoE layer at ``name``'s full width and its input of N tokens."""
    from repro_torch.arch import layers as L
    from repro_torch.configs import get_config

    cfg = get_config(name)
    g = torch.Generator(device=cuda).manual_seed(seed)
    p = L.init_moe(g, cfg, device=cuda)
    x = torch.randn((N, cfg.d_model), generator=g, device=cuda)
    return cfg, p, x


@pytest.mark.parametrize("name,N,G", [
    ("granite-moe-1b-a400m", 6, 1), ("granite-moe-1b-a400m", 384, 4),
    ("olmoe-1b-7b", 6, 1), ("olmoe-1b-7b", 384, 4)])
def test_moe_layer_kernel_gathers_equal_plain_gathers(cuda, name, N, G):
    """The MoE layer with the row-gather kernel against the same layer
    with the plain gathers: the same routing, the same bits (a gather
    copies), two runs bit-equal, and two gather launches a call (the
    dispatch and the combine)."""
    from repro_torch.arch import layers as L

    cfg, p, x = _moe_setup(cuda, name, N)
    before = gather_rows.launches
    y, aux = L.moe(p, x, cfg, G)
    y2, aux2 = L.moe(p, x, cfg, G)
    assert gather_rows.launches == before + 4
    y_plain, aux_plain = L.moe(p, x, cfg, G, gather=ref.gather_rows_ref)
    r, r_plain = L.moe_route(p, x, cfg, G), L.moe_route(p, x, cfg, G)
    torch.cuda.synchronize()
    for key in ("expert_idx", "order", "dest", "keep", "dispatch_idx",
                "combine_idx", "combine_w"):
        assert torch.equal(r[key], r_plain[key]), key
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert torch.equal(y, y_plain) and torch.equal(aux, aux_plain)
    assert torch.isfinite(y).all()


def test_moe_gradient_runs_the_gather_backward_on_its_sort_path(cuda):
    """Granite's layer at the train step's 1024 tokens in 8 groups: the
    dispatch gathers 10240 slots and the combine 8192 rows, both past the
    one-launch backward's 2048, so the backward takes its sort path; the
    gradients equal the plain gathers' within 1e-6 of their max, and two
    backward runs are bit-equal."""
    from repro_torch.arch import layers as L
    from repro_torch.kernels.gather_batch import (backward_geometry,
                                                  gather_rows_backward)

    cfg, p, x = _moe_setup(cuda, "granite-moe-1b-a400m", 1024, seed=1)
    r = L.moe_route(p, x, cfg, 8)
    slots = r["dispatch_idx"].numel()
    for n_src, idx in ((1024 + slots // cfg.n_experts, r["dispatch_idx"]),
                       (slots + 1024, r["combine_idx"])):
        assert backward_geometry(idx.numel(), n_src, 4096, 16)["path"] == \
            "sort"
    w = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(2), device=cuda)
    leaves = [x.requires_grad_(True)] + [t.requires_grad_(True)
                                         for t in p.values()]

    def grads(gather):
        y, aux = L.moe(p, x, cfg, 8, gather=gather)
        return torch.autograd.grad((y * w).sum() + aux, leaves)

    before = gather_rows_backward.launches
    got, again = grads(gather_rows), grads(gather_rows)
    assert gather_rows_backward.launches == before + 4
    want = grads(ref.gather_rows_ref)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert _grad_err(a, c) <= 1e-6


@pytest.mark.parametrize("part", ["dispatch", "combine"])
def test_gather_backward_sort_path_at_moe_shapes_equals_cpu_bits(cuda, part):
    """The row gather's backward at Granite's train shapes (4 KB rows; the
    dispatch's index vector reads each token up to K times and each zero
    row up to E) is the CPU plain version's bits: both sum each row's
    entries in ascending k."""
    from repro_torch.arch import layers as L
    from repro_torch.kernels.gather_batch import gather_rows_backward

    cfg, p, x = _moe_setup(cuda, "granite-moe-1b-a400m", 1024, seed=3)
    r = L.moe_route(p, x, cfg, 8)
    slots = r["dispatch_idx"].numel()
    n_src, idx = ((1024 + slots // cfg.n_experts, r["dispatch_idx"])
                  if part == "dispatch" else (slots + 1024, r["combine_idx"]))
    dout = torch.randn((idx.numel(), cfg.d_model), device=cuda)
    got = gather_rows_backward(dout, idx, n_src)
    assert torch.equal(got, gather_rows_backward(dout, idx, n_src))
    assert torch.equal(got.cpu(), ref.gather_rows_bwd_ref(
        dout.cpu(), idx.cpu(), n_src))


# The bf16 backward (each add rounded to bf16): the one-launch path, its
# threshold and one above, repeated and negative indices, odd rows in
# 2-byte units on both paths, the trash row, every index on one row.
_GATHER_BWD_BF16_CASES = {
    "K=256 one launch": ((2048, 1024), 256, "random"),
    "K=2048 at the threshold": ((2048, 1024), 2048, "random"),
    "K=2049 sorted": ((2048, 1024), 2049, "random"),
    "repeats and negatives": ((2048, 1024), 256, "repeats"),
    "odd row D=1023 one launch": ((513, 1023), 300, "repeats"),
    "odd row D=1023 sorted": ((513, 1023), 3000, "random"),
    "trash row": ((1001, 512), 256, "trash"),
    "every index on one row": ((2048, 512), 256, "one row"),
}


@pytest.mark.parametrize("case", sorted(_GATHER_BWD_BF16_CASES))
def test_gather_backward_bf16_kernel_is_the_plain_versions_bits(cuda, case):
    """The bf16 kernel sums each row's run from zero in ascending k,
    rounding after every add, as the plain version (and the reference's
    scatter-add) does: bit-equal to it on the card and on the CPU, two runs
    bit-equal, counted on the bf16 wrapper and not the fp32 one."""
    from repro_torch.kernels.gather_batch import (gather_rows_backward,
                                                  gather_rows_backward_bf16)

    shape, K, kind = _GATHER_BWD_BF16_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(K + 1)
    idx = _gather_bwd_indices(g, shape[0], K, kind)
    dout = torch.randn((K,) + shape[1:], generator=g, device=cuda).bfloat16()
    before = (gather_rows_backward.launches,
              gather_rows_backward_bf16.launches)
    got = gather_rows_backward(dout, idx, shape[0])
    again = gather_rows_backward_bf16(dout, idx, shape[0])
    torch.cuda.synchronize()
    assert (gather_rows_backward.launches,
            gather_rows_backward_bf16.launches) == (before[0],
                                                    before[1] + 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, shape[0]))
    assert torch.equal(got.cpu(), ref.gather_rows_bwd_ref(
        dout.cpu(), idx.cpu(), shape[0]))


def test_gather_backward_bf16_through_a_misaligned_dout(cuda):
    """A dout off 16 bytes is copied contiguous, or summed in 2-byte units
    where its rows are odd: the plain version's bits either way."""
    from repro_torch.kernels.gather_batch import gather_rows_backward

    g = torch.Generator(device=cuda).manual_seed(7)
    idx = _gather_bwd_indices(g, 300, 500, "repeats")
    base = torch.randn((500 * 37 + 1,), generator=g, device=cuda).bfloat16()
    dout = base[1:].view(500, 37)
    got = gather_rows_backward(dout, idx, 300)
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, 300))


def test_moe_bf16_gradients_through_the_kernels_are_the_plain_gathers(cuda):
    """Granite's layer in bf16 at the train step's 1024 tokens in 8 groups:
    both backwards on the bf16 kernel's sort path, counted on the bf16
    wrapper; every gradient bit-equal to the same layer's with the plain
    gathers (whose backward rounds where the kernel rounds), two runs
    bit-equal."""
    from repro_torch.arch import layers as L
    from repro_torch.kernels.gather_batch import (gather_rows_backward,
                                                  gather_rows_backward_bf16)

    cfg, p, x = _moe_setup(cuda, "granite-moe-1b-a400m", 1024, seed=4)
    p = {k: t.bfloat16().requires_grad_(True) for k, t in p.items()}
    x = x.bfloat16().requires_grad_(True)
    w = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(5), device=cuda).bfloat16()
    leaves = [x] + list(p.values())

    def grads(gather):
        y, aux = L.moe(p, x, cfg, 8, gather=gather)
        return torch.autograd.grad((y.float() * w.float()).sum() + aux,
                                   leaves)

    before = (gather_rows_backward.launches,
              gather_rows_backward_bf16.launches)
    got, again = grads(gather_rows), grads(gather_rows)
    assert (gather_rows_backward.launches,
            gather_rows_backward_bf16.launches) == (before[0],
                                                    before[1] + 4)
    want = grads(ref.gather_rows_ref)
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
        assert torch.equal(a, c)


def test_gather_rows_with_grad_refuses_float16(cuda):
    src = torch.randn((10, 4), device=cuda).half().requires_grad_(True)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_rows(src, idx)


def test_lm_wave_refuses_a_cross_attention_model_on_the_card(cuda):
    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.serve.lm_wave import ServeEngine

    model = TransformerLM(get_config("llama-3.2-vision-11b").reduced(),
                          device=cuda)
    with pytest.raises(ValueError, match="cross-attention"):
        ServeEngine(model, {}, device=cuda)


def test_vision_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    """The vision model, reduced: a prefill with image embeddings (its
    cross-attention through the flash kernel) and three decode steps
    (plain attention over the cross cache) on the card within 1e-4 of the
    CPU's logits."""
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import \
        flash_attention as flash_wrapper

    cfg = get_config("llama-3.2-vision-11b").reduced()
    params = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    img = torch.randn((2, cfg.n_image_tokens, cfg.d_model), generator=g)
    outs = {}
    for device in ("cpu", cuda):
        model = TransformerLM(cfg, device=device)
        p = tree_map(lambda t: t.to(device), params)
        before = flash_wrapper.launches
        with torch.no_grad():
            lg, caches = model.prefill(p, toks.to(device), img.to(device),
                                       cache_len=27)
            logits = [lg]
            for t in range(3):
                lg, caches = model.decode_step(p, toks[:, t].to(device),
                                               caches, 24 + t)
                logits.append(lg)
        outs[str(device)] = [x.cpu() for x in logits]
        if device == cuda:
            assert flash_wrapper.launches == before + cfg.n_layers
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_cuda_tensors_reach_the_kernels_and_meta_ones_do_not(cuda):
    """The plain versions are taken on the CPU and the meta device only:
    the same call on CUDA tensors launches the kernel (its counter rises
    by one), on meta tensors it does not."""
    from repro_torch.kernels.gather_batch import gather_rows_backward

    def calls(dev):
        def m(*shape, dtype=torch.float32):
            return torch.randn(shape, device=dev).to(dtype) \
                if dtype.is_floating_point else \
                torch.zeros(shape, dtype=dtype, device=dev)

        idx = m(7, dtype=torch.int32)
        q, kv = m(2, 24, 8, 16), m(2, 24, 2, 16)
        x, dt, A, BC = m(2, 32, 4, 16), m(2, 32, 4), m(4), m(2, 32, 1, 16)
        i3 = m(3, dtype=torch.int32)
        return [(gather_rows, lambda: gather_rows(m(50, 12), idx)),
                (gather_rows_backward,
                 lambda: gather_rows_backward(m(7, 12), idx, 50)),
                (flash_attention, lambda: flash_attention(q, kv, kv)),
                (ssd_scan, lambda: ssd_scan(x, dt.abs(), -A.abs(), BC, BC,
                                            16)),
                (fused_lstm_cell, lambda: fused_lstm_cell(
                    m(3, 40), m(40, 64), m(64), m(3, 16))),
                (fused_gather_lstm_cell, lambda: fused_gather_lstm_cell(
                    m(9, 24), m(5, 16), m(5, 16), i3, i3, i3, m(40, 64),
                    m(64)))]

    for dev, rise in ((cuda, 1), (torch.device("meta"), 0)):
        for wrapper, call in calls(dev):
            before = wrapper.launches
            call()
            torch.cuda.synchronize()
            assert wrapper.launches == before + rise, (wrapper, dev)

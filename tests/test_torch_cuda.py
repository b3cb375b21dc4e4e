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


@pytest.mark.parametrize("name", ["gather_rows", "fused_gather_lstm_cell",
                                  "fused_lstm_cell", "flash_attention",
                                  "ssd_scan"])
def test_cuda_routes_raise_under_grad_mode(cuda, name):
    """The kernels have no backward: with grad mode on and an input that
    requires grad, each CUDA route raises instead of returning a result
    with no autograd graph; under no_grad it runs."""
    fn, args = _grad_cases(cuda)[name]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(args)
    with torch.no_grad():
        fn(args)
    fn([a.detach() for a in args])
    torch.cuda.synchronize()


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

"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""

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

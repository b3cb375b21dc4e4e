"""The launch geometry of the gather and cell kernels, and the cell's
packed weight layout, on the CPU.

The wrappers compute each launch's geometry in Python
(``kernels/gather_batch.py:gather_geometry``,
``kernels/fused_cell.py:cell_geometry``) and the CUDA kernels walk exactly
what they are given. These tests replay the kernels' loops over that
geometry with numpy: the gather must copy every (row, unit) exactly once,
and the cell must reduce every (row, hidden unit, k chunk) exactly once,
with one leader CTA per (row, hidden unit) for the epilogue, at ragged
sizes and past the grid's cap, with the wrapper's cluster size and with
the others the phase tool times (``tools/kernel_phases.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_cell import (BN, KC, MAX_CLUSTER,  # noqa: E402
                                            cell_geometry, pack_weights,
                                            packed_weights)
from repro_torch.kernels.gather_batch import (  # noqa: E402
    THREADS, UNITS_PER_THREAD, gather_geometry)
from repro_torch.tools.kernel_phases import \
    cell_geometry_with_cluster  # noqa: E402


def gather_cover(k: int, row_bytes: int, geo: dict) -> np.ndarray:
    """How often the kernel's loops (csrc/gather_rows.cu) copy each byte of
    each row. Block (bx, by) walks row tiles bx, bx + grid_x, ... and unit
    tiles by, by + grid_y, ...; thread (x, y) takes row y of the tile and
    units x + j tc (j < v) of the unit tile."""
    gx, gy = geo["grid"]
    count = np.zeros((k, row_bytes), dtype=np.int32)
    tc, rows_per, v = geo["tc"], geo["r"], geo["v"]
    ub = geo["unit_bytes"]
    for bx in range(gx):
        for rt in range(bx, geo["row_tiles"], gx):
            rows = rt * rows_per + np.arange(rows_per)
            rows = rows[rows < k]
            for by in range(gy):
                for ut in range(by, geo["unit_tiles"], gy):
                    units = (ut * tc * v + np.arange(tc)[:, None]
                             + np.arange(v)[None, :] * tc).ravel()
                    units = units[units < row_bytes // ub]
                    cols = (units[:, None] * ub + np.arange(ub)).ravel()
                    count[np.ix_(rows, cols)] += 1
    return count


# (k, row bytes, unit bytes, grid cap)
_GATHER_CASES = [
    (1, 2048, 16, None), (2, 2048, 16, None), (16, 2048, 16, None),
    (255, 2048, 16, None), (256, 2048, 16, None), (257, 2048, 16, None),
    (2000, 2048, 16, None), (217, 68, 4, None), (100, 68, 4, None),
    (77, 384, 4, None), (40, 66, 2, None), (3, 4, 4, None), (1, 1, 1, None),
    (16, 2048, 4, None), (5, 8193, 1, None), (300, 1032, 8, None),
    (7, 1024, 16, None), (9, 4096, 16, None), (3, 20000, 16, None),
    (30, 1008, 16, None),
    # past the grid's cap: the row-tile and unit-tile loops
    (2000, 2048, 16, 7), (1000, 12, 4, 5), (9, 8193, 1, 2),
    (5, 1 << 18, 16, 3), (50, 1024, 16, 3), (40, 512, 16, 3),
]


@pytest.mark.parametrize("k,row_bytes,unit,cap", _GATHER_CASES)
def test_gather_geometry_copies_every_row_and_unit_once(k, row_bytes, unit,
                                                        cap):
    geo = (gather_geometry(k, row_bytes, unit) if cap is None
           else gather_geometry(k, row_bytes, unit, grid_cap=cap))
    assert 1 <= geo["tc"] * geo["r"] <= THREADS
    assert geo["v"] in (1, 2, 4, 8) and geo["v"] <= UNITS_PER_THREAD
    if cap is not None:
        assert max(geo["grid"]) <= cap
    geo = dict(geo, unit_bytes=unit)
    assert (gather_cover(k, row_bytes, geo) == 1).all()


def test_gather_geometry_sizes_the_grid_to_the_bytes():
    """A row takes up to 256 threads of one unit, then up to eight units a
    thread; a block reads about 4 KB: a large copy spreads over the SMs, a
    small one takes few blocks."""
    small = gather_geometry(16, 2048, 16)
    assert small["grid"][0] * small["grid"][1] <= 8
    assert (small["tc"], small["v"]) == (128, 1)
    assert gather_geometry(1, 2048, 16)["grid"] == (1, 1)
    large = gather_geometry(512, 2048, 16)
    assert large["grid"][0] * large["grid"][1] >= 132
    # 1 MB rows (MV-RNN's matrices): 8 units a thread, many unit tiles
    huge = gather_geometry(16, 1 << 20, 16)
    assert huge["v"] == UNITS_PER_THREAD and huge["unit_tiles"] == 32
    assert gather_geometry(16, 2048, 4)["v"] == 2
    assert gather_geometry(16, 1 << 20, 4)["v"] == UNITS_PER_THREAD


def cell_cover(B: int, K: int, H: int, geo: dict):
    """How often the cell kernels (csrc/lstm_cell_tile.cuh) reduce each
    (row, hidden unit, k chunk), and how many leader CTAs write each
    (row, hidden unit): CTA blockIdx.x has cluster rank x % cluster and
    hidden units (x / cluster) * BN.., rows blockIdx.y * 8 nt.., and k
    chunks rank * chunks_per_rank.. (fewer at the end)."""
    cl, cpr, rb = geo["cluster"], geo["chunks_per_rank"], geo["rows_per_cta"]
    gx, gy = geo["grid"]
    n_chunks = -(-K // KC)
    count = np.zeros((B, H, n_chunks), dtype=np.int64)
    leads = np.zeros((B, H), dtype=np.int64)
    for bx in range(gx):
        rank, tile = bx % cl, bx // cl
        units = tile * BN + np.arange(BN)
        units = units[units < H]
        chunks = rank * cpr + np.arange(cpr)
        chunks = chunks[chunks < n_chunks]
        for by in range(gy):
            rows = by * rb + np.arange(rb)
            rows = rows[rows < B]
            count[np.ix_(rows, units, chunks)] += 1
            if rank == 0:
                leads[np.ix_(rows, units)] += 1
    return count, leads


_CELL_CASES = (
    [(B, 1024, 512, None) for B in (1, 7, 8, 9, 15, 16, 17, 32, 33, 64, 65)]
    + [(B, E + H, H, None) for B in (5, 16, 33)
       for E, H in ((512, 512), (24, 40), (520, 500), (3, 5))]
    + [(16, 1024, 512, cl) for cl in (1, 2, 4)]
    + [(37, 333, 100, cl) for cl in (1, 2, 4)]
    + [(3, 1, 1, None), (130, 96, 17, 4), (200, 2048, 1024, None)])


@pytest.mark.parametrize("B,K,H,cluster", _CELL_CASES)
def test_cell_geometry_reduces_every_row_unit_and_k_chunk_once(B, K, H,
                                                               cluster):
    geo = cell_geometry_with_cluster(B, K, H, cluster)
    assert geo["cluster"] in (1, 2, 4) and geo["cluster"] <= MAX_CLUSTER
    assert geo["grid"][0] % geo["cluster"] == 0
    assert geo["rows_per_cta"] == 8 * geo["nt"] and geo["nt"] in (1, 2, 4, 8)
    count, leads = cell_cover(B, K, H, geo)
    assert (count == 1).all()
    assert (leads == 1).all()


def test_cell_geometry_fills_the_card_and_streams_w_once():
    """At the path's widths (E = H = 512): at least 128 CTAs at any B (256,
    clusters of 4, up to 16 rows), and one row group, so one pass over w,
    up to B = 64."""
    for B in (1, 8, 16, 17, 32, 64):
        geo = cell_geometry(B, 1024, 512)
        assert geo["grid"][0] * geo["grid"][1] >= 128
        assert geo["cluster"] == (4 if B <= 16 else 2)
    for B in (1, 16, 32, 33, 64):
        assert cell_geometry(B, 1024, 512)["row_groups"] == 1
    assert cell_geometry(65, 1024, 512)["row_groups"] == 2
    # a short K is not split into CTAs of fewer than two chunks
    assert cell_geometry(16, 64, 512)["cluster"] == 1


@pytest.mark.parametrize("K,H", [(1024, 512), (7, 13), (1, 1), (333, 100)])
def test_packed_weights_hold_each_lanes_fragment_in_order(K, H):
    """Packed tile ``t``, chunk ``c``, k step ``s``, m tile ``mt``, lane
    ``4 g + t4``, value ``j`` is ``w[k, gate * H + t * BN + u]`` at
    ``k = 32 c + 8 s + t4 + 4 (j // 2)`` and tile column
    ``gate * BN + u = 16 mt + g + 8 (j % 2)``; zero past H and K."""
    w = torch.as_tensor(np.random.default_rng(K).standard_normal((K, 4 * H)),
                        dtype=torch.float32)
    got = pack_weights(w).numpy()
    tiles, kp = -(-H // BN), -(-K // KC) * KC
    assert got.shape == (tiles, kp * 4 * BN)
    want = np.zeros((tiles, kp // KC, 4, 2, 32, 4), dtype=np.float32)
    wn = w.numpy()
    for t in range(tiles):
        for c in range(kp // KC):
            for s in range(4):
                for mt in range(2):
                    for lane in range(32):
                        g, t4 = lane // 4, lane % 4
                        for j in range(4):
                            k = 32 * c + 8 * s + t4 + 4 * (j // 2)
                            col = 16 * mt + g + 8 * (j % 2)
                            gate, u = col // BN, col % BN
                            if k < K and t * BN + u < H:
                                want[t, c, s, mt, lane, j] = \
                                    wn[k, gate * H + t * BN + u]
    np.testing.assert_array_equal(got, want.reshape(tiles, -1))


def test_packed_weights_are_built_once_per_weight_version():
    w = torch.randn(64, 4 * 24)
    first = packed_weights(w)
    assert packed_weights(w) is first                 # kept on the tensor
    w.mul_(2.0)                                       # in place: packs again
    again = packed_weights(w)
    assert again is not first
    assert torch.equal(again, pack_weights(w))
    view = torch.randn(2, 64, 4 * 24)
    w1 = view[1]
    packed_weights(w1)
    view.add_(1.0)                                    # the tensor it views
    assert torch.equal(packed_weights(w1), pack_weights(w1))
    before = packed_weights(w)
    w.data = torch.randn(64, 4 * 24)                  # new storage
    assert packed_weights(w) is not before
    assert torch.equal(packed_weights(w), pack_weights(w))

"""Dense fused LSTM cell.

The PQ-planned layout makes an LSTM cell's four gate weight matrices one
``(K, 4H)`` block, so the whole cell is one GEMM with the gate math as its
epilogue. On the card it is the hand-written kernel in
``csrc/fused_lstm_cell.cu`` (the tile of ``csrc/lstm_cell_tile.cuh``, which
the fused gather cell shares), launched with the geometry of
:func:`cell_geometry`; for tensors on the CPU the wrapper runs the plain
version in :mod:`repro_torch.kernels.ref`. No model path launches it,
in the reference as here: it is the public ``ops.fused_lstm_cell``.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import Published, capturing

from . import build, counting, guard, ref

BN = 8            # hidden units per cluster (csrc/lstm_cell_tile.cuh)
KC = 32           # k rows per chunk
MAX_ROWS = 64     # rows per CTA, at most
MAX_CLUSTER = 4   # CTAs per cluster, at most
SMS = 132         # streaming multiprocessors of an H100 SXM
GRID_Y_CAP = 65535


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` (K, 4H), gate columns ``[i|f|g|o]``, as the cell kernels read
    it: ``(ceil(H / BN), Kp * 4 * BN)`` with ``Kp = ceil(K / KC) * KC``.
    Tile ``t`` holds the 32 gate columns ``g * H + t * BN + u`` (column
    ``g * BN + u`` of the tile, zero past H) of every k row (zero past K),
    a chunk of KC k rows at a time, each chunk in the order the kernels'
    ``mma.sync`` steps read it: for k step ``s`` (8 rows), m tile ``mt``
    (16 columns) and lane ``l = 4 g + t``, the A fragment's four values
    ``(k, col) = (s8 + t, 16 mt + g), (s8 + t, 16 mt + g + 8),
    (s8 + t + 4, 16 mt + g), (s8 + t + 4, 16 mt + g + 8)``, one 16-byte
    load a lane. A chunk is then 4 KB of contiguous memory, one bulk
    copy."""
    K, H = w.shape[0], w.shape[1] // 4
    tiles, kp = -(-H // BN), -(-K // KC) * KC
    w4 = torch.nn.functional.pad(w.reshape(K, 4, H),
                                 (0, tiles * BN - H, 0, 0, 0, kp - K))
    # [t, k, col]: col = gate * BN + u
    cols = w4.reshape(kp, 4, tiles, BN).permute(2, 0, 1, 3)
    # k = ((c * 4 + s) * 2 + hb) * 4 + t4, col = (mt * 2 + jb) * 8 + g
    frag = cols.reshape(tiles, kp // KC, 4, 2, 4, 2, 2, 8)
    # -> [t, c, s, mt, g, t4, hb, jb]: lane 4 g + t4, value 2 hb + jb
    return (frag.permute(0, 1, 2, 5, 7, 4, 3, 6).contiguous()
            .reshape(tiles, kp * 4 * BN))


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_weights` of ``w``, built once per weight tensor and kept
    on it (``w._cell_packed``, keyed by ``w``'s version counter and data
    pointer): a new tensor, an in-place update of this one (or of a tensor
    it views), or new storage assigned to ``w.data`` packs again. A write
    into ``w.data`` in place (``w.data.copy_(...)``) bumps neither and is
    not seen: update the weights through ``w`` itself, or pass a new
    tensor. The executors pass the same blocked ``w`` every step
    (``core/executor.py:_lstm_fused_gather``), so a model packs each cell's
    weights once; a caller that passes a fresh view of its weights every
    call repacks them every call.

    The packing is queued on the current stream, and a caller on another
    stream (another thread's) waits for it before it reads it
    (:class:`~repro_torch.core.device.Published`). One built while the
    stream captures a CUDA graph belongs to that graph and is not kept."""
    key = (w._version, w.data_ptr())
    cached = getattr(w, "_cell_packed", None)
    if cached is None or cached[0] != key:
        if capturing(w):
            return pack_weights(w)
        cached = (key, Published(pack_weights(w)))
        w._cell_packed = cached
    return cached[1].get()[0]


def cell_geometry(B: int, K: int, H: int) -> dict:
    """The cell kernels' launch geometry for ``B`` rows, reduction depth
    ``K`` and ``H`` hidden units: clusters of ``cluster`` CTAs along grid x,
    one cluster per ``BN`` hidden units (``unit_tiles`` of them) and row
    group of ``8 * nt`` rows (``row_groups`` on grid y, one while B <= 64);
    CTA ``rank`` of a cluster reduces chunks ``[rank, rank + 1) *
    chunks_per_rank`` of the ``n_chunks`` chunks of ``KC`` k rows. The
    cluster grows (1, 2, 4) while the grid has fewer than two CTAs per SM
    and every CTA still gets two chunks or more; past 16 rows a CTA it
    stops at 2, which was faster at B = 32 on the card (PERF.md section
    6)."""
    nt = 1
    while 8 * nt < min(B, MAX_ROWS):
        nt *= 2
    row_groups = -(-B // (8 * nt))
    if row_groups > GRID_Y_CAP:
        raise ValueError(f"cell kernels: B = {B} rows is too many")
    unit_tiles = -(-H // BN)
    n_chunks = -(-K // KC)
    cluster = 1
    while (cluster < (MAX_CLUSTER if nt <= 2 else 2)
           and unit_tiles * row_groups * cluster < 2 * SMS
           and 2 * cluster * 2 <= n_chunks):
        cluster *= 2
    chunks_per_rank = max(1, -(-n_chunks // cluster))
    return {"nt": nt, "rows_per_cta": 8 * nt, "row_groups": row_groups,
            "unit_tiles": unit_tiles, "n_chunks": n_chunks,
            "cluster": cluster, "chunks_per_rank": chunks_per_rank,
            "grid": (unit_tiles * cluster, row_groups)}


def fused_lstm_cell(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, K) = concat[x, h]; w: (K, 4H) gate-blocked ``[i|f|g|o]``;
    b: (4H,); c: (B, H) -> (h', c'), each (B, H), equal to
    :func:`ref.fused_lstm_cell_ref`. On the card: float32, all four on one
    device and contiguous; any B, K and H (no tile multiples), and no
    alignment beyond the element's own. ``w`` is packed once and the
    packing kept on it (:func:`packed_weights`): a write into ``w.data`` in
    place is not seen."""
    if xh.device.type == "cpu":
        return ref.fused_lstm_cell_ref(xh, w, b, c)
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"fused_lstm_cell: unsupported device {dev}")
    guard.check_no_grad("fused_lstm_cell", xh, w, b, c)
    if xh.ndim != 2 or w.ndim != 2 or w.shape[1] % 4:
        raise ValueError(f"fused_lstm_cell: xh must be (B, K) and w (K, 4H), "
                         f"got {tuple(xh.shape)} and {tuple(w.shape)}")
    (B, K), H = xh.shape, w.shape[1] // 4
    for name, t, shape in (("xh", xh, (B, K)), ("w", w, (K, 4 * H)),
                           ("b", b, (4 * H,)), ("c", c, (B, H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(
                f"fused_lstm_cell: {name} must be {shape} float32 on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_lstm_cell: {name} must be contiguous")
    h_out = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_out = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return h_out, c_out
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = cell_geometry(B, K, H)
    build.check(lib.fused_lstm_cell_launch(
        xh.data_ptr(), packed_weights(w).data_ptr(), b.data_ptr(), c.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), B, K, H, geo["nt"],
        geo["cluster"], geo["chunks_per_rank"], *geo["grid"], stream),
        "fused_lstm_cell")
    counting.count(fused_lstm_cell)
    return h_out, c_out


fused_lstm_cell.launches = 0

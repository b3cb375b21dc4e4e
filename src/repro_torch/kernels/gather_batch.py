"""Row gather: the staging copy ED-Batch's memory planner optimizes away.

When an operand is not contiguous in its arena (an unplanned layout, a
batch the planner erased, or any operand of the bucketed executor, whose
index vectors are runtime data), its rows are copied into a contiguous
buffer before the batched cell runs. On the card that copy is the
hand-written kernel in ``csrc/gather_rows.cu``, launched with the geometry
of :func:`gather_geometry`; for a tensor on the CPU the wrapper runs the
plain version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from . import build, counting, guard, ref


THREADS = 256          # at most, per block (csrc/gather_rows.cu)
UNITS_PER_THREAD = 8   # at most
BLOCK_BYTES = 4096     # bytes a block reads, where the copy is large enough
GRID_CAP = 65535       # blocks on each grid axis; loops cover the rest


def gather_geometry(k: int, row_bytes: int, unit: int,
                    grid_cap: int = GRID_CAP) -> dict:
    """The gather kernel's launch geometry for ``k`` rows of ``row_bytes``
    bytes, copied in units of ``unit`` bytes (16 where the rows and both
    base pointers allow it, else one element).

    A block of ``(tc, r)`` threads copies ``r`` rows and, of each, a tile
    of ``tc * v`` units (thread ``x`` takes units ``x, x + tc, ...,
    x + (v - 1) tc``); ``row_tiles x unit_tiles`` such blocks. A row
    takes up to ``THREADS`` threads, one unit each, before a thread takes
    2, 4 or 8 (at the path's 2 KB rows one unit a thread was faster at
    small K than four, and level at large K: PERF.md section 6), and a
    block reads about ``BLOCK_BYTES``, so a large copy
    spreads over every SM and a small one takes as few blocks as its rows
    need. A grid of at most ``grid_cap`` blocks on each axis walks the
    tiles."""
    units_per_row = row_bytes // unit
    v = 1
    while v < UNITS_PER_THREAD and THREADS * v < units_per_row:
        v *= 2
    tc = min(THREADS, -(-units_per_row // v))
    unit_tiles = -(-units_per_row // (tc * v))
    blocks = max(1, -(-k * row_bytes // BLOCK_BYTES))
    r = max(1, min(THREADS // tc, k, -(-k * unit_tiles // blocks)))
    row_tiles = -(-k // r)
    return {"tc": tc, "r": r, "v": v,
            "row_tiles": row_tiles, "unit_tiles": unit_tiles,
            "grid": (min(row_tiles, grid_cap), min(unit_tiles, grid_cap))}


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` along axis 0: ``src`` is ``(N, *row)``, ``idx`` is a
    ``(K,)`` int32 tensor on the same device; returns ``(K, *row)``. Rows
    of more than one dim are gathered as flat rows. Indices mean what they
    mean to ``src[idx]``: a negative one counts from the end; one outside
    ``[-N, N)`` raises (on the card as a device-side assert, surfacing as
    a CUDA error at the next synchronisation, as ``src[idx]`` does there)."""
    if src.device.type == "cpu":
        return ref.gather_rows_ref(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
    guard.check_no_grad("gather_rows", src)
    if idx.device != src.device:
        raise ValueError(f"gather_rows: idx on {idx.device}, src on {src.device}")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise ValueError(f"gather_rows: idx must be 1-D int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if src.ndim < 1 or not src.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows: src and idx must be contiguous")
    elem = src.element_size()
    if elem not in (1, 2, 4, 8):
        raise ValueError(f"gather_rows: unsupported dtype {src.dtype}")
    out = torch.empty((idx.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(src.shape[1:]) * elem
    aligned = (row_bytes % 16 == 0 and src.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    unit = 16 if aligned else elem
    geo = gather_geometry(idx.shape[0], row_bytes, unit)
    lib = build.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = lib.gather_rows_launch(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
        idx.shape[0], row_bytes, unit, geo["tc"], geo["r"], geo["v"],
        geo["row_tiles"], geo["unit_tiles"], *geo["grid"], stream)
    build.check(status, "gather_rows")
    counting.count(gather_rows, (idx.shape[0], row_bytes))
    return out


gather_rows.launches = 0
gather_rows.shapes = Counter()   # (K, row bytes) -> launches

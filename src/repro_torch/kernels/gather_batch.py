"""Row gather: the staging copy ED-Batch's memory planner optimizes away,
and its backward.

When an operand is not contiguous in its arena (an unplanned layout, a
batch the planner erased, or any operand of the bucketed executor, whose
index vectors are runtime data), its rows are copied into a contiguous
buffer before the batched cell runs. On the card that copy is the
hand-written kernel in ``csrc/gather_rows.cu``, launched with the geometry
of :func:`gather_geometry`; for a tensor on the CPU the wrapper runs the
plain version in :mod:`repro_torch.kernels.ref`, and on the meta device it
takes the card's route, each launch a plain version standing in for its
kernel (:func:`ref.stand_in`).

When autograd records the call (grad mode on and a ``src`` that requires
grad), the wrapper runs :class:`GatherRowsFunction`, whose backward is the
kernel of ``csrc/gather_rows_bwd.cu`` (:func:`gather_rows_backward`): the
rows of the output gradient summed back into their source rows,
duplicates in ascending order (in bf16 rounded after every add, as the
reference's scatter-add of the gradient rounds; those launches are counted
on :func:`gather_rows_backward_bf16`). It saves the index vector and
``src``'s shape, never ``src``: the executors write their arenas in place
after later gathers have read them.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
from torch.autograd.function import once_differentiable

from . import build, costs, counting, ref


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


# csrc/gather_rows_bwd.cu, path 1 (one launch, no sort)
ONE_PASS_THREADS = 256
ONE_PASS_BLOCK_BYTES = 8192   # of dsrc a block writes, where rows allow
ONE_PASS_MAX_K = 2048       # (row, k) pairs a block holds in shared memory
ONE_PASS_MAX_ROWS = 2048    # rows a block owns
ONE_PASS_UNITS = 8          # most units a thread writes
BACKWARD_DTYPES = (torch.float32, torch.bfloat16)   # the backward's forms


def backward_geometry(k: int, n_src: int, row_bytes: int, unit: int) -> dict:
    """Which path of ``csrc/gather_rows_bwd.cu`` the backward takes for
    ``k`` output-gradient rows summed into ``n_src`` rows of ``row_bytes``
    bytes, in units of ``unit`` bytes: ``{"path": "one pass",
    "rows_per_block": R, "blocks": n}`` or ``{"path": "sort"}``.

    One pass: each block owns ``R`` rows of dsrc and reads all ``k``
    indices, so the blocks read ``blocks * k * 4`` bytes of indices where
    the kernel must move ``(k + n_src) * row_bytes``. ``R`` starts at about
    ``ONE_PASS_BLOCK_BYTES`` of rows a block (at the path's 2 KB rows four
    rows, two 16-byte units a thread, beat one, two, eight and sixteen
    rows cold at K = 1 to 2048: PERF.md section 6), at most
    ``ONE_PASS_UNITS`` units a thread (which only bf16's 2-byte units
    reach first), and doubles, up to ``ONE_PASS_UNITS`` units a thread,
    while the index reads exceed half of those bytes; the sort takes over
    where they still do, or where ``k`` is above the pairs a block can
    hold (``ONE_PASS_MAX_K``)."""
    if k > ONE_PASS_MAX_K:
        return {"path": "sort"}
    upr = row_bytes // unit
    rows = max(1, min(ONE_PASS_MAX_ROWS, ONE_PASS_BLOCK_BYTES // row_bytes,
                      ONE_PASS_THREADS * ONE_PASS_UNITS // max(upr, 1)))
    while True:
        blocks = -(-n_src // rows)
        if 2 * blocks * k * 4 <= (k + n_src) * row_bytes:
            return {"path": "one pass", "rows_per_block": rows,
                    "blocks": blocks}
        if (2 * rows * upr > ONE_PASS_THREADS * ONE_PASS_UNITS
                or 2 * rows > ONE_PASS_MAX_ROWS):
            return {"path": "sort"}
        rows *= 2


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` along axis 0: ``src`` is ``(N, *row)``, ``idx`` is a
    ``(K,)`` int32 tensor on the same device; returns ``(K, *row)``. Rows
    of more than one dim are gathered as flat rows. Indices mean what they
    mean to ``src[idx]``: a negative one counts from the end; one outside
    ``[-N, N)`` raises (on the card as a device-side assert, surfacing as
    a CUDA error at the next synchronisation, as ``src[idx]`` does there).
    On the card differentiable through :class:`GatherRowsFunction` when
    autograd records (``src`` float32 or bfloat16; on meta, where the
    plain versions stand in, any dtype)."""
    if src.device.type == "cpu":
        return ref.gather_rows_ref(src, idx)
    if torch.is_grad_enabled() and src.requires_grad:
        if src.dtype not in BACKWARD_DTYPES and src.device.type == "cuda":
            raise ValueError(f"gather_rows: the backward kernel takes "
                             f"float32 or bfloat16, got {src.dtype} that "
                             f"requires grad")
        return GatherRowsFunction.apply(src, idx)
    return _gather(src, idx)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch, recording nothing for autograd (on
    meta the plain version in its place)."""
    if src.device.type in ref.PLAIN_DEVICES:
        with ref.stand_in(lambda: costs.gather_rows(
                idx.shape[0], math.prod(src.shape[1:]) * src.element_size(),
                idx.element_size())):
            return ref.gather_rows_ref(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
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


def gather_rows_backward(dout: torch.Tensor, idx: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """The gradient of ``gather_rows(src, idx)`` at a ``src`` of ``n_rows``
    rows for the output gradient ``dout`` (K, *row): ``dsrc`` (n_rows,
    *row) in ``dout``'s dtype, each row the sum of the ``dout`` rows its
    indices chose (ascending in K; in bf16 from zero, rounded after every
    add), zero where none did. On the card the kernel of
    ``csrc/gather_rows_bwd.cu``: one launch where :func:`backward_geometry`
    allows it, else the keys sorted and every row of dsrc written with
    :func:`gather_geometry` over ``n_rows`` rows; counted as one launch
    either way, float32 on this function and bfloat16 on
    :func:`gather_rows_backward_bf16`, each with its ``(K, n_rows, row
    bytes)`` in its ``shapes``; float32 or bfloat16 only, ``dout`` copied
    contiguous where it is not. On the CPU the plain version
    (:func:`ref.gather_rows_bwd_ref`)."""
    if dout.device.type in ref.PLAIN_DEVICES:
        with ref.stand_in(lambda: costs.gather_rows_backward(
                idx.shape[0], n_rows,
                math.prod(dout.shape[1:]) * dout.element_size(),
                idx.element_size())):
            return ref.gather_rows_bwd_ref(dout, idx, n_rows)
    dev = dout.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rows backward: unsupported device {dev}")
    if dout.dtype not in BACKWARD_DTYPES:
        raise ValueError(f"gather_rows backward: dout must be float32 or "
                         f"bfloat16, got {dout.dtype}")
    if idx.device != dev or idx.dtype != torch.int32 or idx.ndim != 1 or \
            not idx.is_contiguous() or dout.ndim < 1 or \
            dout.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_rows backward: idx must be a contiguous "
                         f"1-D int32 tensor on {dev} of dout's "
                         f"{dout.shape[0]} rows, got {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")
    dout = dout.contiguous()
    dsrc = torch.empty((n_rows,) + tuple(dout.shape[1:]), dtype=dout.dtype,
                       device=dev)
    if dsrc.numel() == 0:
        return dsrc
    k = idx.shape[0]
    elem = dout.element_size()
    row_bytes = math.prod(dout.shape[1:]) * elem
    aligned = (row_bytes % 16 == 0 and dout.data_ptr() % 16 == 0
               and dsrc.data_ptr() % 16 == 0)
    unit = 16 if aligned else elem
    plan = backward_geometry(k, n_rows, row_bytes, unit)
    lib = build.library()
    bf16 = dout.dtype == torch.bfloat16
    launch = lib.gather_rows_bwd_bf16_launch if bf16 else \
        lib.gather_rows_bwd_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan["path"] == "one pass":
        status = launch(
            dout.data_ptr(), idx.data_ptr(), dsrc.data_ptr(), None, None,
            n_rows, k, row_bytes, unit, plan["rows_per_block"], 0, 0, 0, 0,
            0, 0, 0, stream)
    else:
        geo = gather_geometry(n_rows, row_bytes, unit)
        keys = torch.empty((2, max(k, 1)), dtype=torch.int64, device=dev)
        status = launch(
            dout.data_ptr(), idx.data_ptr(), dsrc.data_ptr(),
            keys[0].data_ptr(), keys[1].data_ptr(), n_rows, k, row_bytes,
            unit, 0, geo["tc"], geo["r"], geo["v"], geo["row_tiles"],
            geo["unit_tiles"], *geo["grid"], stream)
    counter = gather_rows_backward_bf16 if bf16 else gather_rows_backward
    build.check(status, counter.__name__)
    counting.count(counter)
    with counting.LOCK:
        counter.shapes[(k, n_rows, row_bytes)] += 1
    return dsrc


def gather_rows_backward_bf16(dout: torch.Tensor, idx: torch.Tensor,
                              n_rows: int) -> torch.Tensor:
    """:func:`gather_rows_backward` of a bfloat16 ``dout``; on the card its
    launches of the bf16 kernel are counted here."""
    if dout.dtype != torch.bfloat16:
        raise ValueError(f"gather_rows_backward_bf16: dout must be bfloat16, "
                         f"got {dout.dtype}")
    return gather_rows_backward(dout, idx, n_rows)


class GatherRowsFunction(torch.autograd.Function):
    """The card's differentiable gather: the forward kernel, saving the
    index vector and ``src``'s shape (never ``src``), and the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = tuple(src.shape)
        return gather_rows(src, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        idx, = ctx.saved_tensors
        return gather_rows_backward(dout, idx, ctx.src_shape[0]), None


gather_rows.launches = 0
gather_rows.shapes = Counter()   # (K, row bytes) -> launches
gather_rows_backward.launches = 0
gather_rows_backward.shapes = Counter()   # (K, n_rows, row bytes) -> launches
gather_rows_backward_bf16.launches = 0
gather_rows_backward_bf16.shapes = Counter()

"""Fused gather -> LSTM cell.

The bucketed plan executor makes every operand a runtime row gather, so an
unfused LSTM step would first copy its x, h and c rows into three gathered
buffers and only then run the gate GEMM. The kernel in
``csrc/fused_gather_lstm_cell.cu`` reads the rows straight out of the
source arenas into shared memory and applies the cell in one launch (one
cluster launch, with the geometry of :func:`.fused_cell.cell_geometry`).

Weight layout as in the reference: ``w`` is ``(E+H, 4H)`` with gate columns
blocked ``[i|f|g|o]``; ``b`` is ``(4H,)``. For tensors on the CPU the
wrapper runs the plain version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from . import build, counting, guard, ref
from .fused_cell import cell_geometry, packed_weights


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"fused_gather_lstm_cell: {name} must be {shape} {dtype} on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_gather_lstm_cell: {name} must be contiguous")


def fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b):
    """x_src: (Nx, E); h_src: (Nh, H); c_src: (Nc, H); ix/ih/ic: (B,) int32;
    w: (E+H, 4H); b: (4H,) -> (h', c'), each (B, H), equal to
    ``lstm(concat(x_src[ix], h_src[ih]), c_src[ic])``. Indices read as in
    that expression: negative ones count from the end, and one outside its
    source raises (a device-side assert on the card). On the card ``w`` is
    packed once and the packing kept on it
    (:func:`.fused_cell.packed_weights`): a write into ``w.data`` in place
    is not seen."""
    if x_src.device.type == "cpu":
        return ref.fused_gather_lstm_cell_ref(x_src, h_src, c_src, ix, ih, ic,
                                              w, b)
    dev = x_src.device
    if dev.type != "cuda":
        raise ValueError(f"fused_gather_lstm_cell: unsupported device {dev}")
    guard.check_no_grad("fused_gather_lstm_cell", x_src, h_src, c_src, w, b)
    if x_src.ndim != 2 or h_src.ndim != 2 or c_src.ndim != 2 or ix.ndim != 1:
        raise ValueError("fused_gather_lstm_cell: sources must be 2-D and "
                         "indices 1-D")
    (nx, E), (nh, H), nc, B = x_src.shape, h_src.shape, c_src.shape[0], ix.shape[0]
    f32 = torch.float32
    _check("x_src", x_src, (nx, E), f32, dev)
    _check("h_src", h_src, (nh, H), f32, dev)
    _check("c_src", c_src, (nc, H), f32, dev)
    for name, t in (("ix", ix), ("ih", ih), ("ic", ic)):
        _check(name, t, (B,), torch.int32, dev)
    _check("w", w, (E + H, 4 * H), f32, dev)
    _check("b", b, (4 * H,), f32, dev)
    h_out = torch.empty((B, H), dtype=f32, device=dev)
    c_out = torch.empty((B, H), dtype=f32, device=dev)
    if B == 0 or H == 0:
        return h_out, c_out
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = cell_geometry(B, E + H, H)
    build.check(lib.fused_gather_lstm_cell_launch(
        x_src.data_ptr(), h_src.data_ptr(), c_src.data_ptr(), ix.data_ptr(),
        ih.data_ptr(), ic.data_ptr(), packed_weights(w).data_ptr(),
        b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), B, E, H, nx, nh, nc, geo["nt"],
        geo["cluster"], geo["chunks_per_rank"], *geo["grid"], stream),
        "fused_gather_lstm_cell")
    counting.count(fused_gather_lstm_cell)
    return h_out, c_out


fused_gather_lstm_cell.launches = 0

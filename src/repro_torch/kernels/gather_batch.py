"""Row gather: the staging copy ED-Batch's memory planner optimizes away.

When an operand is not contiguous in its arena (an unplanned layout, a
batch the planner erased, or any operand of the bucketed executor, whose
index vectors are runtime data), its rows are copied into a contiguous
buffer before the batched cell runs. On the card that copy is the
hand-written kernel in ``csrc/gather_rows.cu``; for a tensor on the CPU the
wrapper runs the plain version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import math

import torch

from . import build, ref


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
    lib = build.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    build.check(lib.gather_rows_launch(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
        idx.shape[0], row_bytes, 16 if aligned else elem, stream),
        "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0

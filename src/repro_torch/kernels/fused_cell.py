"""Dense fused LSTM cell.

The PQ-planned layout makes an LSTM cell's four gate weight matrices one
``(K, 4H)`` block, so the whole cell is one GEMM with the gate math as its
epilogue. On the card it is the hand-written kernel in
``csrc/fused_lstm_cell.cu`` (the tile of ``csrc/lstm_cell_tile.cuh``, which
the fused gather cell shares); for tensors on the CPU the wrapper runs the
plain version in :mod:`repro_torch.kernels.ref`. No model path launches it,
in the reference as here: it is the public ``ops.fused_lstm_cell``.
"""

from __future__ import annotations

import torch

from . import build, ref


def fused_lstm_cell(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, K) = concat[x, h]; w: (K, 4H) gate-blocked ``[i|f|g|o]``;
    b: (4H,); c: (B, H) -> (h', c'), each (B, H), equal to
    :func:`ref.fused_lstm_cell_ref`. On the card: float32, all four on one
    device and contiguous; any B, K and H (no tile multiples), and no
    alignment beyond the element's own."""
    if xh.device.type == "cpu":
        return ref.fused_lstm_cell_ref(xh, w, b, c)
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"fused_lstm_cell: unsupported device {dev}")
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
    build.check(lib.fused_lstm_cell_launch(
        xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), B, K, H, stream),
        "fused_lstm_cell")
    fused_lstm_cell.launches += 1
    return h_out, c_out


fused_lstm_cell.launches = 0

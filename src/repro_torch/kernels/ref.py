"""Plain PyTorch versions of the port's hand-written kernels.

Each wrapper in this package calls its plain version for a tensor on the
CPU; on the card the kernel runs, and these are what it is held against.
"""

from __future__ import annotations

import torch


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx]


def fused_gather_lstm_cell_ref(x_src, h_src, c_src, ix, ih, ic, w, b):
    """Gather-then-cell composition: the fused kernel must equal this.
    ``w`` is ``(E+H, 4H)`` gate-blocked ``[i|f|g|o]``; ``b`` is ``(4H,)``."""
    xh = torch.cat([x_src[ix], h_src[ih]], dim=-1)
    H = w.shape[1] // 4
    y = (xh @ w + b).float()
    i = torch.sigmoid(y[:, 0 * H:1 * H])
    f = torch.sigmoid(y[:, 1 * H:2 * H])
    g = torch.tanh(y[:, 2 * H:3 * H])
    o = torch.sigmoid(y[:, 3 * H:4 * H])
    c_new = f * c_src[ic].float() + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(xh.dtype), c_new.to(xh.dtype)

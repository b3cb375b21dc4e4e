"""The public kernel entry points, the counterparts of the reference's
``kernels/ops.py``. Each name is the port's wrapper, in the port's argument
layouts:

- ``flash_attention(q, k, v, causal=True, window=0)``: q (B, Sq, H, D),
  k/v (B, Skv, KV, D) with ``H % KV == 0`` (the reference's takes
  (B·H, S, D) with K/V already per head);
- ``fused_lstm_cell(xh, w, b, c)``: xh (B, K), w (K, 4H) ``[i|f|g|o]``,
  b (4H,), c (B, H) -> (h', c');
- ``fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b)``: the
  same cell on the rows ``x_src[ix]``, ``h_src[ih]``, ``c_src[ic]``
  (int32 indices);
- ``gather_rows(src, idx)``: ``src[idx]`` along axis 0, int32 ``idx``;
- ``ssd_scan(x, dt, A, B, C, chunk, init_state=None)``: x (b, l, h, p),
  B/C (b, l, g, n) with groups read in place (the reference's takes them
  broadcast to heads); returns ``(y, final_state)``.

There is no jit and no ``interpret``: a CUDA tensor runs the kernel, a CPU
tensor its plain version.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .fused_cell import fused_lstm_cell as _fused_lstm_cell
from .fused_gather_cell import fused_gather_lstm_cell
from .gather_batch import gather_rows
from .ssd_scan import ssd_scan

__all__ = ["flash_attention", "fused_lstm_cell", "fused_gather_lstm_cell",
           "gather_rows", "ssd_scan"]


def fused_lstm_cell(xh, w, b, c, block_m: int = 128, block_n: int = 128,
                    block_k: int = 128):
    """The dense fused LSTM cell (:func:`.fused_cell.fused_lstm_cell`).
    ``block_m``/``block_n``/``block_k`` are the reference's tile sizes,
    accepted so its callers find this signature, and ignored: the kernel
    computes its own launch geometry (``fused_cell.cell_geometry``) and
    takes any shape."""
    return _fused_lstm_cell(xh, w, b, c)

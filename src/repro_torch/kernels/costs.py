"""The work each hand-written kernel does: ``(flops, bytes)`` of one launch.

``bytes`` is what the kernel must move: each input read once, each output
written once. ``flops`` is what the computed function needs, counted the
way ``chip_smoke.py`` counts it for a kernel's ``bound_ms``: attention over
the (row, column) pairs its mask lets through, the SSD scan at its cheapest
chunking, the gathers as pure data movement. The dry-run's step counter
(``launch/dryrun.py:StepCounter``) adds these in place of the ops of the
plain version that stands in for a kernel on the meta device, so a traced
step counts the port's kernels, not their plain versions (which write the
full score matrix, for one).

Bytes count each operand at its element size (``elem``: 4 for float32, 2
for bfloat16; the gathers take their row bytes). What a kernel keeps in
float32 whatever its operands' type counts 4 bytes an element: flash
attention's row log-sum-exp, and the SSD scan's A, its states (initial,
final, the chunks' starts) and their gradients.
"""

from __future__ import annotations

from functools import lru_cache

F32 = 4   # the float32 outputs and inputs of every form of a kernel


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (row, column) pairs of one (batch, head) that
    ``ref.attention_mask`` lets through: row ``i`` sees column ``j`` iff
    ``j <= i`` and, with a window, ``i - j < window``; all ``Sq * Skv``
    without ``causal``."""
    if not causal:
        return Sq * Skv

    def seen_up_to(r: int) -> int:   # rows 0..r-1, the window aside
        full = min(r, Skv)           # rows i < Skv see i + 1 columns
        return full * (full + 1) // 2 + (r - full) * Skv

    pairs = seen_up_to(Sq)
    if window:
        # row i loses its columns j <= i - window, that is min(i - window
        # + 1, Skv) of them where i >= window
        pairs -= seen_up_to(max(Sq - window, 0))
    return pairs


def flash_attention(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
                    causal: bool, window: int, with_lse: bool = False,
                    elem: int = 4) -> tuple[int, int]:
    """The forward: Q K^T and P V over the pairs (2D each), q, k, v read
    and the output written at ``elem`` bytes an element (and the rows'
    float32 log-sum-exp)."""
    pairs = B * H * attention_pairs(Sq, Skv, causal, window)
    nbytes = ((2 * B * Sq * H * D + 2 * B * Skv * KV * D) * elem
              + (B * H * Sq * F32 if with_lse else 0))
    return 4 * D * pairs, nbytes


def flash_attention_backward(B: int, Sq: int, Skv: int, H: int, KV: int,
                             D: int, causal: bool, window: int,
                             elem: int = 4) -> tuple[int, int]:
    """Five products over the pairs (S, dP, dq, dk, dv: 2D each); q, the
    output, its gradient and the float32 log-sum-exp read and dq written;
    k, v read and dk, dv written."""
    pairs = B * H * attention_pairs(Sq, Skv, causal, window)
    nbytes = ((4 * B * Sq * H * D + 4 * B * Skv * KV * D) * elem
              + B * H * Sq * F32)
    return 5 * 2 * D * pairs, nbytes


@lru_cache(maxsize=None)
def ssd_flops(b: int, l: int, h: int, p: int, n: int) -> int:
    """The fewest FLOPs that compute the scan, whose result does not depend
    on the chunk size: the least over every chunk size q (a ragged last
    chunk allowed) of the chunked algorithm's count, and the sequential
    recurrence's. Per (batch, head) and chunk of m steps the chunked count
    is the masked C.B^T scores and the diagonal block over the m(m+1)/2
    causal pairs (2n + 2p each), the carried state's contribution and the
    state update (2np each per step) and the state's decay (np); the
    recurrence's is, per step and (p, n) state entry, a decay multiply and
    a multiply-add for the update and a multiply-add for C . state."""
    def chunk(m: int) -> int:
        return m * (m + 1) * (n + p) + 4 * m * n * p + n * p

    def chunked(q: int) -> int:
        full, rest = divmod(l, q)
        return full * chunk(q) + (chunk(rest) if rest else 0)

    least = min(min(chunked(q) for q in range(1, l + 1)), 5 * l * p * n)
    return b * h * least


@lru_cache(maxsize=None)
def ssd_bwd_flops(b: int, l: int, h: int, p: int, n: int,
                  carried: bool) -> int:
    """The fewest FLOPs that compute the scan's gradients, which do not
    depend on the chunk size: the least over every chunk size q (a ragged
    last chunk allowed) of the chunked backward's count, and the
    sequential recurrence's. Per (batch, head) and chunk of m steps the
    chunked count is five products over the m(m+1)/2 causal pairs (C B^T,
    dy x^T, dx, dC, dB: 6n + 4p each), and, where a state is carried
    across the chunk's edges (more than one chunk, or a state carried in
    or out: ``carried``), the carried state's five per step (dS0, G B,
    x G, dy S0, S0 C: 2np each) and G's decay (np); the recurrence's is
    about ten per step and (p, n) state entry (the state's gradient
    carried back, dx, dB, dC and ddt, a multiply-add each)."""
    def chunk(m: int, state: bool) -> int:
        return m * (m + 1) * (3 * n + 2 * p) + (
            10 * m * n * p + n * p if state else 0)

    def chunked(q: int) -> int:
        full, rest = divmod(l, q)
        state = carried or full + (1 if rest else 0) > 1
        return full * chunk(q, state) + (chunk(rest, state) if rest else 0)

    least = min(min(chunked(q) for q in range(1, l + 1)), 10 * l * p * n)
    return b * h * least


def ssd_scan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
             with_init: bool, with_states: bool,
             elem: int = 4) -> tuple[int, int]:
    """The forward: x, dt, B, C read and y written at ``elem`` bytes an
    element; A (and the initial state) read and the final state (and the
    chunks' start states) written in float32."""
    state = b * h * p * n
    nbytes = ((2 * b * l * h * p + b * l * h + 2 * b * l * g * n) * elem
              + (h + state + (state if with_init else 0)
                 + ((l // chunk) * state if with_states else 0)) * F32)
    return ssd_flops(b, l, h, p, n), nbytes


def ssd_scan_backward(b: int, l: int, h: int, p: int, g: int, n: int,
                      chunk: int, with_init: bool, with_dfinal: bool,
                      with_states: bool, elem: int = 4) -> tuple[int, int]:
    """The backward: x, dt, B, C, dy read and dx, ddt, dB, dC written at
    ``elem`` bytes an element; A, dfinal, the initial and the chunks'
    start states read and dA, dinit written in float32."""
    state = b * h * p * n
    nbytes = ((3 * b * l * h * p + 2 * b * l * h + 4 * b * l * g * n) * elem
              + (2 * h + (2 * state if with_init else 0)
                 + (state if with_dfinal else 0)
                 + ((l // chunk) * state if with_states else 0)) * F32)
    carried = with_init or with_dfinal
    return ssd_bwd_flops(b, l, h, p, n, carried), nbytes


def gather_rows(k: int, row_bytes: int, idx_bytes: int) -> tuple[int, int]:
    """K rows read and written, the index vector read."""
    return 0, 2 * k * row_bytes + k * idx_bytes


def gather_rows_backward(k: int, n_rows: int, row_bytes: int,
                         idx_bytes: int) -> tuple[int, int]:
    """dout and idx read once, dsrc written once (the sums counted as data
    movement, as the forward's)."""
    return 0, k * row_bytes + k * idx_bytes + n_rows * row_bytes


def fused_lstm_cell(B: int, K: int, H: int,
                    elem: int = 4) -> tuple[int, int]:
    """The gate GEMM (2 B K 4H); xh, w, b, c read, h', c' written."""
    return 2 * B * K * 4 * H, (B * K + K * 4 * H + 4 * H + 3 * B * H) * elem


def fused_gather_lstm_cell(B: int, E: int, H: int,
                           elem: int = 4) -> tuple[int, int]:
    """The gate GEMM over the gathered rows; the B gathered x, h and c
    rows, w, b and the three int32 index vectors read, h', c' written."""
    K = E + H
    return (2 * B * K * 4 * H,
            (K * 4 * H + 4 * H + B * (E + 2 * H) + 2 * B * H) * elem
            + 3 * B * 4)

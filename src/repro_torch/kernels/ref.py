"""Plain PyTorch versions of the port's hand-written kernels.

Each wrapper in this package calls its plain version for a tensor on the
CPU; on the card the kernel runs, and these are what it is held against.
``ssd_scan_seq_ref`` is not a kernel's plain version: it is the sequential
recurrence the tests hold the chunked scan against.
"""

from __future__ import annotations

import torch


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx]


def fused_lstm_cell_ref(xh, w, b, c):
    """xh: (B, K) = concat[x, h]; w: (K, 4H) gate-blocked ``[i|f|g|o]``;
    b: (4H,); c: (B, H) -> (h', c'), each (B, H)."""
    H = w.shape[1] // 4
    y = (xh @ w + b).float()
    i = torch.sigmoid(y[:, 0 * H:1 * H])
    f = torch.sigmoid(y[:, 1 * H:2 * H])
    g = torch.tanh(y[:, 2 * H:3 * H])
    o = torch.sigmoid(y[:, 3 * H:4 * H])
    c_new = f * c.float() + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(xh.dtype), c_new.to(xh.dtype)


def fused_gather_lstm_cell_ref(x_src, h_src, c_src, ix, ih, ic, w, b):
    """Gather-then-cell composition: the fused kernel must equal this.
    ``w`` is ``(E+H, 4H)`` gate-blocked ``[i|f|g|o]``; ``b`` is ``(4H,)``."""
    xh = torch.cat([x_src[ix], h_src[ih]], dim=-1)
    return fused_lstm_cell_ref(xh, w, b, c_src[ic])


def attention_mask(Sq: int, Skv: int, window: int = 0, device=None):
    """``(Sq, Skv)`` bool: row ``i`` sees column ``j`` iff ``j <= i`` and,
    with a window, ``i - j < window``. Rows and columns both count from 0,
    as the reference's causal masks do."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Skv, device=device)[None, :]
    m = j <= i
    if window:
        m = m & (i - j < window)
    return m


def _attention_scores(q, k, causal: bool, window: int):
    """(B, KV, G, Sq, Skv) fp32 scores of :func:`flash_attention_ref`,
    scaled and masked."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (D ** -0.5)
    if causal:
        s = s.masked_fill(~attention_mask(Sq, Skv, window, q.device), -1e30)
    return s


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H a multiple of KV
    (query head h reads kv head h // (H // KV)) -> (B, Sq, H, D).
    Scores in fp32, scale ``D ** -0.5``, masked scores ``-1e30``: the
    function of the reference's ``_sdpa`` and its flash kernel."""
    B, Sq, H, D = q.shape
    w = torch.softmax(_attention_scores(q, k, causal, window),
                      dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, Sq, H, D)


def flash_attention_lse_ref(q, k, causal: bool = True, window: int = 0):
    """The rows' log-sum-exp of :func:`flash_attention_ref`'s scaled,
    masked scores: (B, H, Sq) float32, natural log."""
    B, Sq, H, _ = q.shape
    return torch.logsumexp(_attention_scores(q, k, causal, window),
                           dim=-1).reshape(B, H, Sq)


def flash_attention_backward_ref(q, k, v, dout, causal: bool = True,
                                 window: int = 0):
    """``(dq, dk, dv)``: autograd of :func:`flash_attention_ref` at
    ``q, k, v`` for the output gradient ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal, window)
        return torch.autograd.grad(out, leaves, dout)


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q): ``out[..., i, j] = sum_{k in (j, i]}``
    for ``i >= j``, ``-inf`` above the diagonal (so ``exp`` gives 0 there
    and never sees a positive exponent)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd_scan_ref(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD (Mamba-2), the algorithm of the reference's
    ``arch/ssm.py:ssd_scan``.

    x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n) with g
    groups shared by h // g heads each; ``l % chunk == 0``. Returns
    ``(y (b, l, h, p), final_state (b, h, p, n) float32)``."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_scan: length {l} is not a multiple of the "
                         f"chunk {chunk}")
    c, q = l // chunk, chunk
    rep = h // g
    xs = x.reshape(b, c, q, h, p)
    dts = dt.reshape(b, c, q, h)
    Bs = B.reshape(b, c, q, g, n).repeat_interleave(rep, dim=3)
    Cs = C.reshape(b, c, q, g, n).repeat_interleave(rep, dim=3)
    dA = dts * A
    dA_cum = torch.cumsum(dA, dim=2)
    wdt = x.dtype

    # 1) intra-chunk: masked decay "attention"
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2))).to(wdt)   # (b,c,h,q,q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cs, Bs) * L
    y_diag = torch.einsum("bchqs,bcsh,bcshp->bcqhp", scores, dts.to(wdt), xs)

    # 2) what each chunk adds to the state
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum).to(wdt)
    states = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchpn",
                          Bs, decay_to_end, dts.to(wdt), xs)

    # 3) the state carried across chunks, in order
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)

    # 4) the carried state's contribution
    state_decay = torch.exp(dA_cum).to(wdt)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                         Cs, prev_states.to(wdt), state_decay)
    return (y_diag + y_off).reshape(b, l, h, p), carry


def ssd_scan_seq_ref(x, dt, A, B, C):
    """The naive sequential recurrence, one step per position (the
    reference's ``kernels/ref.py:ssd_scan_ref``), as a second oracle.
    x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, h, n) with the
    heads already expanded. Returns ``(y, final_state (b, h, p, n))``."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A)                               # (b, h)
        state = state * dA[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", C[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state

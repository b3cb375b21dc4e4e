"""Plain PyTorch versions of the port's hand-written kernels.

Each wrapper in this package calls its plain version for a tensor on the
CPU or on the ``meta`` device (where the dry-run traces shapes, FLOPs and
bytes with nothing allocated: a meta tensor cannot be launched on); on the
card the kernel runs, and these are what it is held against. On meta a
wrapper takes the card's route (its autograd function where autograd
records) and the plain version stands in for each launch under
:func:`stand_in`, so the dry-run counts the kernels' work.
``ssd_scan_seq_ref`` is not a kernel's plain version: it is the sequential
recurrence the tests hold the chunked scan against. The two backward kernels'
plain versions (``gather_rows_bwd_ref``, ``ssd_scan_bwd_ref``) are written
out step by step, as the kernels compute them, and the tests hold them
against autograd of the forward's plain version.
"""

from __future__ import annotations

import contextlib

import torch

# The devices whose tensors take the plain versions. A CUDA tensor reaches
# only the kernels: nothing turns to a plain version when a build or a
# launch fails.
PLAIN_DEVICES = ("cpu", "meta")

# The dry-run's step counter (``launch/dryrun.py:StepCounter``) while it
# counts a traced step, else None.
RECKONER = None


@contextlib.contextmanager
def stand_in(cost):
    """Run a plain version in its kernel's place. Under the dry-run's step
    counter the kernel's own work, ``cost()`` = ``(flops, bytes)``
    (:mod:`.costs`), is counted and the plain version's ops are not, nor
    their memory but for what outlives the block; otherwise this does
    nothing."""
    counter = RECKONER
    if counter is None or counter.muted:
        yield
        return
    counter.add(*cost())
    counter.muted = True
    try:
        yield
    finally:
        counter.unmute()


def reckon(fn, args, labels, out_labels, shardable: str):
    """``fn(*args)``: a plain version standing in for a launch (under
    :func:`stand_in`), or plain code with a sharding rule of its own.
    Under the dry-run's step counter with operands placed on its
    production mesh (DTensors), the counter places the call by the rule
    that ``labels``, ``out_labels`` and ``shardable`` describe
    (``launch/spmd.py:on_shards``)."""
    counter = RECKONER
    if counter is not None and any(
            getattr(a, "placements", None) is not None for a in args):
        return counter.on_shards(fn, args, labels, out_labels, shardable)
    return fn(*args)


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx]


def gather_rows_bwd_ref(dout: torch.Tensor, idx: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """The gradient of ``src[idx]`` for a ``src`` of ``n_rows`` rows:
    ``dsrc`` (n_rows, *row) of ``dout``'s dtype, row ``r`` the sum of the
    ``dout[k]`` whose ``idx[k]`` means ``r`` (a negative index counts from
    the end, as in ``src[idx]``), zero where no index means it. On the CPU
    the sum runs in ascending ``k``. A bf16 ``dout`` is summed as the
    reference's scatter-add of its gradient sums it: from zero, in
    ascending ``k``, rounded to bf16 after every add (a loop over the
    runs' j-th entries, each step over every row at once). A meta ``idx``
    holds no values, so its bounds are not checked."""
    if idx.numel() and idx.device.type != "meta" and \
            not bool(((idx >= -n_rows) & (idx < n_rows)).all()):
        raise IndexError(f"gather_rows backward: an index is outside "
                         f"[-{n_rows}, {n_rows})")
    rows = torch.where(idx < 0, idx + n_rows, idx).long()
    shape = (n_rows,) + tuple(dout.shape[1:])
    if dout.dtype == torch.bfloat16 and dout.device.type != "meta":
        order = torch.argsort(rows, stable=True)
        sorted_rows = rows[order]
        # each entry's place in its row's run: ascending k
        j = torch.arange(rows.numel(), device=rows.device) - \
            torch.searchsorted(sorted_rows, sorted_rows)
        acc = torch.zeros(shape, dtype=torch.float32, device=dout.device)
        for step in range(int(j.max()) + 1 if j.numel() else 0):
            sel = order[j == step]
            r = rows[sel]
            acc[r] = (acc[r] + dout[sel].float()).bfloat16().float()
        return acc.bfloat16()
    dsrc = torch.zeros(shape, dtype=dout.dtype, device=dout.device)
    return dsrc.index_add_(0, rows, dout)


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


def ssd_chunk_states(x, dt, A, B, chunk: int, init_state=None):
    """The state each chunk of :func:`ssd_scan_ref` starts from: (b, c, h,
    p, n) float32 (float64 for float64 inputs) for c = l // chunk chunks,
    the first ``init_state`` (or zero). These are what the forward kernel writes for the backward."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c, q = l // chunk, chunk
    f = torch.promote_types(x.dtype, torch.float32)
    xs = x.reshape(b, c, q, h, p).to(f)
    dts = dt.reshape(b, c, q, h).to(f)
    Bs = B.reshape(b, c, q, g, n).to(f).repeat_interleave(h // g, dim=3)
    cum = torch.cumsum(dts * A.to(f), dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dts               # (b,c,q,h)
    adds = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bs, w, xs)
    carry = (torch.zeros((b, h, p, n), dtype=f, device=x.device)
             if init_state is None else init_state.to(f))
    out = []
    for ci in range(c):
        out.append(carry)
        carry = carry * torch.exp(cum[:, ci, -1])[:, :, None, None] + \
            adds[:, ci]
    return torch.stack(out, dim=1)


def ssd_scan_bwd_ref(x, dt, A, B, C, chunk: int, init_state, dy,
                     dfinal=None, states=None):
    """Gradients ``(dx, ddt, dA, dB, dC, dinit)`` of :func:`ssd_scan_ref`'s
    ``(y, final_state)`` for the output gradients ``dy`` and ``dfinal``
    (None: zero); ``dinit`` is None when ``init_state`` is. ``states``:
    the chunks' start states (:func:`ssd_chunk_states`, recomputed when
    None). The chunked backward, step by step, as the kernels of
    ``csrc/ssd_scan_bwd.cu`` compute it. Per (batch, chunk, head), with
    cum the within-chunk cumulative sum of dt A, S0 the chunk's start
    state, G the gradient reaching its end state, L_ts = exp(cum_t -
    cum_s) for s <= t (else 0), K = (C B^T) o L and dP = dy x^T:

    1. G over the chunks, last to first: G of the last chunk is
       ``dfinal``; the chunk before gets dS0 = exp(cum_Q) G +
       sum_t exp(cum_t) dy_t C_t^T, and the first chunk's dS0 is
       ``dinit``.
    2. Within a chunk, with w_s = exp(cum_Q - cum_s) dt_s and GB_s = G B_s:
       dx_s = sum_t K_ts dt_s dy_t + w_s GB_s;
       dC_t = sum_s dP_ts L_ts dt_s B_s + exp(cum_t) S0^T dy_t;
       dB_s = dt_s sum_t dP_ts L_ts C_t + w_s G^T x_s;
       ddt_s = sum_t K_ts dP_ts + exp(cum_Q - cum_s) x_s . GB_s, and
       through cum, with W = K o dt_s o dP and V_s = dt_s exp(cum_Q -
       cum_s) x_s . GB_s: dcum_t = sum_s W_ts - sum_s W_st + exp(cum_t)
       dy_t . (S0 C_t) - V_s, plus sum_s V_s + exp(cum_Q) <S0, G> at the
       chunk's last step; d(dt A)_u = sum_{t >= u} dcum_t; ddt_u +=
       A d(dt A)_u and dA gains sum_u dt_u d(dt A)_u.
    3. dB and dC of a group sum its heads' in ascending order, dA sums
       over batch and chunks.

    Computed in float32 (float64 for float64 inputs); each gradient is
    returned in its input's dtype."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_scan: length {l} is not a multiple of the "
                         f"chunk {chunk}")
    c, q = l // chunk, chunk
    rep = h // g
    if states is None:
        states = ssd_chunk_states(x, dt, A, B, chunk, init_state)
    f32 = torch.promote_types(x.dtype, torch.float32)
    xs = x.reshape(b, c, q, h, p).to(f32)
    dys = dy.reshape(b, c, q, h, p).to(f32)
    dts = dt.reshape(b, c, q, h).to(f32)
    Bs = B.reshape(b, c, q, g, n).to(f32).repeat_interleave(rep, dim=3)
    Cs = C.reshape(b, c, q, g, n).to(f32).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dts * A.to(f32), dim=2)                 # (b,c,q,h)
    cum_end = cum[:, :, -1, :]                                 # (b,c,h)
    e_t = torch.exp(cum)                                       # exp(cum_t)

    # 1. the gradient reaching each chunk's end state, last chunk first
    G = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
         if dfinal is None else dfinal.to(f32))
    Gs = [None] * c
    for ci in reversed(range(c)):
        Gs[ci] = G
        G = G * torch.exp(cum_end[:, ci])[:, :, None, None] + torch.einsum(
            "bqh,bqhp,bqhn->bhpn", e_t[:, ci], dys[:, ci], Cs[:, ci])
    dinit = None if init_state is None else G
    Gs = torch.stack(Gs, dim=1)                                # (b,c,h,p,n)

    # 2. within each chunk
    ct = cum.permute(0, 1, 3, 2)                               # (b,c,h,q)
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp((ct[..., :, None] - ct[..., None, :])
                  .masked_fill(~keep, float("-inf")))          # (b,c,h,t,s)
    dt_s = dts.permute(0, 1, 3, 2)[..., None, :]               # (b,c,h,1,s)
    K = torch.einsum("bcthn,bcshn->bchts", Cs, Bs) * L
    dP = torch.einsum("bcthp,bcshp->bchts", dys, xs)
    dPm = dP * L
    w = torch.exp(cum_end[:, :, None, :] - cum) * dts          # (b,c,q,h)
    GB = torch.einsum("bchpn,bcshn->bcshp", Gs, Bs)
    xGB = (xs * GB).sum(-1)                                    # (b,c,q,h)
    dx = torch.einsum("bchts,bcthp->bcshp", K * dt_s, dys) + w[..., None] * GB
    dC = (torch.einsum("bchts,bcshn->bcthn", dPm * dt_s, Bs)
          + e_t[..., None] * torch.einsum("bcthp,bchpn->bcthn", dys, states))
    dB = (torch.einsum("bchts,bcthn->bcshn", dPm, Cs) * dts[..., None]
          + w[..., None] * torch.einsum("bcshp,bchpn->bcshn", xs, Gs))
    ddt = (torch.einsum("bchts,bchts->bchs", K, dP).permute(0, 1, 3, 2)
           + torch.exp(cum_end[:, :, None, :] - cum) * xGB)
    W = K * dt_s * dP
    V = dts * torch.exp(cum_end[:, :, None, :] - cum) * xGB    # (b,c,q,h)
    S0C = torch.einsum("bchpn,bcthn->bcthp", states, Cs)
    dcum = (W.sum(-1).permute(0, 1, 3, 2) - W.sum(-2).permute(0, 1, 3, 2)
            + e_t * (dys * S0C).sum(-1) - V)
    dcum[:, :, -1, :] += V.sum(2) + torch.exp(cum_end) * (
        states * Gs).sum((-2, -1))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + A.to(f32) * ddA
    dA = (dts * ddA).sum((0, 1, 2))

    # 3. group sums
    dB = dB.reshape(b, l, g, rep, n).sum(3)
    dC = dC.reshape(b, l, g, rep, n).sum(3)
    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h).to(
        dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype),
            None if dinit is None else dinit.to(init_state.dtype))

"""CPU replays of the two bf16 backward kernels.

``csrc/flash_attention_bwd_bf16.cu`` and ``csrc/ssd_scan_bwd_bf16.cu`` run
only on the card, so their loops are replayed here in float64, with bf16
rounding at the kernels' own rounding points (float64 sums stand in for
their fp32 sums of exact bf16 products):

- attention: D = rowsum(dO o O) over the bf16 output; dk/dv by (batch, kv
  head, 64-key tile), each rank of the kv head's cluster walking its heads
  and the 64-row query tiles the kernel visits (from the diagonal when
  causal, up to the window's reach, plus the tiles of rows that see no
  key), P rounded to bf16 as the A operand of dV = P^T dO, dS = P (dP - D)
  from the unrounded P rounded as the operand of dK = dS^T Q, the ranks'
  partials summed in rank order; dq by (batch, head, 64-row query tile)
  over the key tiles the kernel visits (its key tile is 64 at D <= 64, 32
  at D = 128); each gradient rounded once;
- the scan: the state pass (the chunks' start states recomputed first to
  last, then G of each chunk last to first, in fp32), the
  chunk kernel's products with the decays rounded where the reference
  rounds them in the values (dx, dB, dC) and unrounded in the derivatives
  (dcum), G and S0 as two bf16 terms, the operands bf16(K dt), bf16(M),
  bf16(M dt), dcum's suffix sum, the group sums in ascending head order.

Each replay is held, on numpy-seeded inputs, to autograd of the port's
plain bf16 forward on the bf16 bar (the truth is autograd of the plain
fp32 forward on the same bf16-exact inputs; the replay within twice the
plain bf16 version's error and within 3e-2 of the largest |truth|), over
causal, windowed and non-causal attention, GQA, ragged tails, and one and
two scan chunks with and without an initial state, and to the JAX
package's gradient of its bf16 model functions (``repro.arch.layers._sdpa``
and ``repro.arch.ssm.ssd_scan``) within the 3e-2 of the largest magnitude
the reference's bf16 kernel test uses. Keep them in step with the two
``.cu`` files.
"""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as JL  # noqa: E402
from repro.arch import ssm as JS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.build import CSRC, SIGNATURES  # noqa: E402

BF16 = torch.bfloat16
F64 = torch.float64
KERNEL_TOL = 3e-2   # the reference's bf16 kernel test
BQ = BKV = 64       # query rows a tile; keys a dk/dv CTA
MAX_CLUSTER = 8


def r16(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 and back (to nearest even), in float64."""
    return t.to(BF16).to(F64)


def bf16_bar(got, plain, truth) -> None:
    truth = truth.float()
    err = float((got.float() - truth).abs().max())
    assert err <= 2 * float((plain.float() - truth).abs().max())
    assert err <= KERNEL_TOL * float(truth.abs().max())


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _near_reference(got, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= KERNEL_TOL * np.abs(want).max()


# -- attention --------------------------------------------------------------


def query_tiles(Sq, Skv, causal, window, j0):
    """The query tiles' first rows a dk/dv CTA at key j0 visits
    (``query_tiles`` of the kernel)."""
    nokey = Skv - 1 + window if causal and window else Sq
    qa, qhi = 0, Sq
    if causal:
        qa = j0 // BQ * BQ
        if window and j0 + BKV - 1 + window < Sq:
            qhi = j0 + BKV - 1 + window
    n1 = -(-(qhi - qa) // BQ) if qhi > qa else 0
    e1 = qa + n1 * BQ
    s2 = nokey - BQ + 1
    s2 = -(-s2 // BQ) * BQ if s2 > 0 else 0
    s2 = max(s2, e1)
    return [qa + i * BQ for i in range(n1)] + list(range(s2, Sq, BQ))


def key_tiles(Sq, Skv, causal, window, i0, BK):
    """The key tiles' first keys a dq CTA at row i0 visits."""
    lo, hi = 0, Skv
    if causal:
        last = min(i0 + BQ, Sq) - 1
        hi = min(last + 1, Skv)
        if window:
            first = i0 - window + 1
            lo = first // BK * BK if first > 0 else 0
    return list(range(lo, hi, BK)) if lo < hi else []


def p_ds(q, k, v, dout, lse, dvec, i0, j0, nq, nk, causal, window, Skv,
         nokey):
    """P and dS (float64) of query rows i0.. and keys j0.. of one head,
    with the kernel's masks: a masked pair 0, a row that sees no key
    P = 1 / Skv and dS = 0."""
    D = q.shape[-1]
    i = torch.arange(i0, i0 + nq)[:, None]
    j = torch.arange(j0, j0 + nk)[None, :]
    s = q[i0:i0 + nq] @ k[j0:j0 + nk].T
    p = torch.exp(s * D ** -0.5 - lse[i0:i0 + nq, None])
    dp = dout[i0:i0 + nq] @ v[j0:j0 + nk].T
    ds = p * (dp - dvec[i0:i0 + nq, None])
    if causal:
        masked = (j > i) | ((i - j >= window) if window else False)
        p = torch.where(masked, torch.zeros(()), p)
        ds = torch.where(masked, torch.zeros(()), ds)
        blind = (i >= nokey).expand_as(p)
        p = torch.where(blind, torch.full((), 1 / Skv, dtype=F64), p)
        ds = torch.where(blind, torch.zeros(()), ds)
    return p, ds


def replay_flash_bwd_bf16(q, k, v, out, dout, lse, causal, window):
    """csrc/flash_attention_bwd_bf16.cu's three kernels: (dq, dk, dv)
    bf16."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    BK = 64 if D <= 64 else 32
    hpr = -(-G // MAX_CLUSTER)
    cluster = -(-G // hpr)
    nokey = Skv - 1 + window if causal and window else Sq
    Q, K, V, O, dO = (t.to(F64) for t in (q, k, v, out, dout))
    L = lse.to(F64)
    dvec = (dO * O).sum(-1)                      # rowdot, (B, Sq, H)
    dq = torch.zeros(B, Sq, H, D, dtype=F64)
    dk = torch.zeros(B, Skv, KV, D, dtype=F64)
    dv = torch.zeros(B, Skv, KV, D, dtype=F64)
    scale = D ** -0.5
    for b in range(B):
        for kvh in range(KV):
            for j0 in range(0, Skv, BKV):
                nk = min(BKV, Skv - j0)
                tiles = query_tiles(Sq, Skv, causal, window, j0)
                parts = []
                for rank in range(cluster):
                    pk = torch.zeros(nk, D, dtype=F64)
                    pv = torch.zeros(nk, D, dtype=F64)
                    for h in range(kvh * G + rank * hpr,
                                   min(kvh * G + (rank + 1) * hpr,
                                       (kvh + 1) * G)):
                        for i0 in tiles:
                            nq = min(BQ, Sq - i0)
                            p, ds = p_ds(Q[b, :, h], K[b, :, kvh],
                                         V[b, :, kvh], dO[b, :, h],
                                         L[b, h], dvec[b, :, h], i0, j0, nq,
                                         nk, causal, window, Skv, nokey)
                            pv += r16(p).T @ dO[b, i0:i0 + nq, h]
                            pk += r16(ds).T @ Q[b, i0:i0 + nq, h]
                    parts.append((pk, pv))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:         # in rank order
                    sk, sv = sk + pk, sv + pv
                dk[b, j0:j0 + nk, kvh] = sk * scale
                dv[b, j0:j0 + nk, kvh] = sv
        for h in range(H):
            kvh = h // G
            for i0 in range(0, Sq, BQ):
                nq = min(BQ, Sq - i0)
                acc = torch.zeros(nq, D, dtype=F64)
                for j0 in key_tiles(Sq, Skv, causal, window, i0, BK):
                    nk = min(BK, Skv - j0)
                    _, ds = p_ds(Q[b, :, h], K[b, :, kvh], V[b, :, kvh],
                                 dO[b, :, h], L[b, h], dvec[b, :, h], i0, j0,
                                 nq, nk, causal, window, Skv, nokey)
                    if causal:   # a row that sees no key has dS = 0
                        ds = torch.where(
                            torch.arange(i0, i0 + nq)[:, None] >= nokey,
                            torch.zeros(()), ds)
                    acc += r16(ds) @ K[b, j0:j0 + nk, kvh]
                dq[b, i0:i0 + nq, h] = acc * scale
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _attn_inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).float().to(BF16)
            for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                      (B, Sq, H, D))]


def _attn_grads(fn, q, k, v, dout, causal, window):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fn(*leaves, causal, window).backward(dout)
    return [t.grad for t in leaves]


# (B, Sq, Skv, H, KV, D, causal, window): the trainer's heads (14 over 2,
# D = 64) at a ragged length, a window with rows that see no key, cross
# attention at D = 128 (the vision model's head dim, 32-key dq tiles),
# a cluster of 8 ranks of two heads (G = 16), small head dims
ATTN_CASES = {
    "causal S=100 G=7": (1, 100, 100, 14, 2, 64, True, 0),
    "window 16 S=150 G=7": (1, 150, 150, 14, 2, 64, True, 16),
    "window 4 Sq=17 Skv=9 D=16, rows with no key": (1, 17, 9, 14, 2, 16,
                                                   True, 4),
    "cross Sq=40 Skv=77 D=128 G=4": (2, 40, 77, 8, 2, 128, False, 0),
    "G=16 S=70 D=32": (1, 70, 70, 16, 1, 32, True, 0),
    "MHA S=37 G=1": (2, 37, 37, 4, 4, 64, True, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_backward_replay_on_the_bf16_bar(case):
    B, Sq, Skv, H, KV, D, causal, window = ATTN_CASES[case]
    q, k, v, dout = _attn_inputs(B, Sq, Skv, H, KV, D, 11)
    out = ref.flash_attention_ref(q, k, v, causal, window)
    lse = ref.flash_attention_lse_ref(q.float(), k.float(), causal, window)
    got = replay_flash_bwd_bf16(q, k, v, out, dout, lse, causal, window)
    plain = _attn_grads(ref.flash_attention_ref, q, k, v, dout, causal,
                        window)
    truth = ref.flash_attention_backward_ref(
        q.float(), k.float(), v.float(), dout.float(), causal, window)
    for a, p, t in zip(got, plain, truth):
        assert a.dtype == BF16
        bf16_bar(a, p, t)


def test_flash_backward_replay_near_the_references_bf16_gradient():
    """The JAX package's gradient of its bf16 ``_sdpa`` (the trainer's
    attention) at the trainer's heads, causal."""
    B, S, H, KV, D = 1, 80, 14, 2, 64
    q, k, v, dout = _attn_inputs(B, S, S, H, KV, D, 12)
    out = ref.flash_attention_ref(q, k, v, True, 0)
    lse = ref.flash_attention_lse_ref(q.float(), k.float(), True, 0)
    got = replay_flash_bwd_bf16(q, k, v, out, dout, lse, True, 0)
    mask = jnp.asarray(np.tril(np.ones((S, S), bool)))[None]

    def f(q_, k_, v_):
        return JL._sdpa(q_, k_, v_, mask, jnp.bfloat16).reshape(B, S, H, D)

    _, vjp = jax.vjp(f, _to_jax(q), _to_jax(k), _to_jax(v))
    for a, w in zip(got, vjp(_to_jax(dout))):
        _near_reference(a, w)


# -- the scan ---------------------------------------------------------------


def _two_terms(t: torch.Tensor) -> torch.Tensor:
    """A float32 value as the kernel feeds it to the tensor cores: hi +
    lo, hi = bf16(v), lo = bf16(v - hi)."""
    hi = r16(t)
    return hi + r16(t - hi)


def replay_ssd_bwd_bf16(x, dt, A, B, C, chunk, init_state, dy, dfinal):
    """csrc/ssd_scan_bwd_bf16.cu: ``(dx, ddt, dA, dB, dC, dinit)``, dx,
    ddt, dB, dC bf16, dA and dinit float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q, c, rep = chunk, l // chunk, h // g
    xs = x.to(F64).reshape(b, c, q, h, p)
    dys = dy.to(F64).reshape(b, c, q, h, p)
    dts = dt.to(F64).reshape(b, c, q, h)
    Bs = B.to(F64).reshape(b, c, q, g, n).repeat_interleave(rep, 3)
    Cs = C.to(F64).reshape(b, c, q, g, n).repeat_interleave(rep, 3)
    cum = torch.cumsum(dts * A.to(F64), 2)                      # (b,c,q,h)
    cend = cum[:, :, -1]
    ecu, wu = torch.exp(cum), torch.exp(cend[:, :, None] - cum)
    ecr, wr = r16(ecu), r16(wu)
    # 1. the state pass, last chunk first (unrounded exp(cum_t))
    G = (torch.zeros(b, h, p, n, dtype=F64) if dfinal is None
         else dfinal.to(F64))
    Gs = [None] * c
    for ci in reversed(range(c)):
        Gs[ci] = G
        G = G * torch.exp(cend[:, ci])[:, :, None, None] + torch.einsum(
            "bqh,bqhp,bqhn->bhpn", ecu[:, ci], dys[:, ci], Cs[:, ci])
    Gs = torch.stack(Gs, 1)                                     # (b,c,h,p,n)
    # the state pass's first walk: the chunks' start states (unrounded u_s)
    S0 = ref.ssd_chunk_states(x.to(F64), dt.to(F64), A.to(F64), B.to(F64),
                              chunk, None if init_state is None
                              else init_state.to(F64))
    G2, S2 = _two_terms(Gs), _two_terms(S0)
    # 2. the chunk kernel
    ct = cum.permute(0, 1, 3, 2)                                # (b,c,h,q)
    keep = torch.ones(q, q, dtype=torch.bool).tril()
    lu = torch.exp((ct[..., :, None] - ct[..., None, :])
                   .masked_fill(~keep, -math.inf))              # (b,c,h,t,s)
    L = r16(lu)
    dt_s = dts.permute(0, 1, 3, 2)[..., None, :]                # (b,c,h,1,s)
    CB = torch.einsum("bcthn,bcshn->bchts", Cs, Bs)
    dP = torch.einsum("bcthp,bcshp->bchts", dys, xs)
    K, M = CB * L, dP * L
    GB = torch.einsum("bchpn,bcshn->bcshp", G2, Bs)
    wdt = wr * dts
    dx = (torch.einsum("bchts,bcthp->bcshp", r16(K * dt_s), dys)
          + wdt[..., None] * GB)
    dB = (torch.einsum("bchts,bcthn->bcshn", r16(M), Cs) * dts[..., None]
          + wdt[..., None] * torch.einsum("bcshp,bchpn->bcshn", xs, G2))
    dyS = torch.einsum("bcthp,bchpn->bcthn", dys, S2)
    dC = (torch.einsum("bchts,bcshn->bcthn", r16(M * dt_s), Bs)
          + ecr[..., None] * dyS)
    W = CB * lu * dt_s * dP
    colw = W.sum(-2).permute(0, 1, 3, 2)                        # sum over t
    roww = W.sum(-1).permute(0, 1, 3, 2)                        # sum over s
    ddtd = (K * dP).sum(-2).permute(0, 1, 3, 2)
    t2 = wu * (xs * GB).sum(-1)
    t5 = ecu * (Cs * dyS).sum(-1)
    dcum = roww - colw + t5 - dts * t2
    dcum[:, :, -1] += (dts * t2).sum(2) + torch.exp(cend) * (
        S0 * Gs).sum((-2, -1))
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddtd + t2 + A.to(F64) * dda
    dA = (dts * dda).sum((0, 1, 2))
    # 3. the group sums
    dB = dB.reshape(b, l, g, rep, n).sum(3)
    dC = dC.reshape(b, l, g, rep, n).sum(3)
    return (dx.reshape(b, l, h, p).to(BF16), ddt.reshape(b, l, h).to(BF16),
            dA.float(), dB.to(BF16), dC.to(BF16),
            None if init_state is None else G.float())


def _ssd_inputs(b, l, h, p, g, n, seed, init, dfin):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p))).float().to(BF16)
    dt = torch.from_numpy(np.abs(rng.standard_normal((b, l, h))) * 0.5)
    dt = dt.float().to(BF16)
    A = torch.from_numpy(-np.abs(rng.standard_normal(h)) * 0.5).float()
    B = torch.from_numpy(rng.standard_normal((b, l, g, n))).float().to(BF16)
    C = torch.from_numpy(rng.standard_normal((b, l, g, n))).float().to(BF16)
    dy = torch.from_numpy(rng.standard_normal((b, l, h, p))).float().to(BF16)
    s0 = (torch.from_numpy(rng.standard_normal((b, h, p, n))).float()
          if init else None)
    dfinal = (torch.from_numpy(rng.standard_normal((b, h, p, n))).float()
              if dfin else None)
    return x, dt, A, B, C, dy, s0, dfinal


def _ssd_grads(fn, x, dt, A, B, C, chunk, s0, dy, dfinal, up=False):
    ins = [t.detach().clone().float() if up and t.dtype == BF16
           else t.detach().clone()
           for t in (x, dt, A, B, C) + (() if s0 is None else (s0,))]
    for t in ins:
        t.requires_grad_(True)
    y, final = fn(*ins[:5], chunk, ins[5] if s0 is not None else None)
    outs, gs = [y], [dy.float() if up else dy]
    if dfinal is not None:
        outs.append(final)
        gs.append(dfinal)
    return torch.autograd.grad(outs, ins, gs)


# (b, l, h, p, groups, n, chunk, init, dfinal): the trainer's widths (24
# heads of 64, n = 128) at one and two chunks, from an initial state with a
# final-state gradient, two groups, and ragged p, n and chunk
SSD_CASES = {
    "one chunk, trainer widths": (1, 128, 24, 64, 1, 128, 128, False,
                                  False),
    "two chunks, init state, final grad": (1, 256, 8, 64, 1, 128, 128, True,
                                           True),
    "two chunks, groups 2": (1, 256, 8, 64, 2, 128, 128, False, False),
    "ragged p=24 n=40 chunk 24 groups 2, init": (2, 48, 4, 24, 2, 40, 24,
                                                 True, False),
    "one chunk of 40, init state": (1, 40, 3, 16, 1, 32, 40, True, False),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_replay_on_the_bf16_bar(case):
    b, l, h, p, g, n, chunk, init, dfin = SSD_CASES[case]
    x, dt, A, B, C, dy, s0, dfinal = _ssd_inputs(b, l, h, p, g, n, 13, init,
                                                 dfin)
    got = replay_ssd_bwd_bf16(x, dt, A, B, C, chunk, s0, dy, dfinal)
    plain = _ssd_grads(ref.ssd_scan_ref, x, dt, A, B, C, chunk, s0, dy,
                       dfinal)
    truth = _ssd_grads(ref.ssd_scan_ref, x, dt, A, B, C, chunk, s0, dy,
                       dfinal, up=True)
    got = [t for t in got if t is not None]
    assert [t.dtype for t in got] == [BF16, BF16, torch.float32, BF16,
                                      BF16] + [torch.float32] * init
    for a, pl, t in zip(got, plain, truth):
        bf16_bar(a, pl, t)


def test_ssd_backward_replay_near_the_references_bf16_gradient():
    """The JAX package's gradient of its bf16 model scan
    (``repro.arch.ssm.ssd_scan``) over two chunks from an initial state:
    dx, dB and dC within 3e-2 of their largest magnitude (ddt and dA sum
    the decays' derivatives over every pair, where the reference's own
    bf16 rounding leaves more than that: they are held to the bar
    above)."""
    b, l, h, p, g, n, chunk = 1, 64, 4, 16, 1, 32, 32
    x, dt, A, B, C, dy, s0, _ = _ssd_inputs(b, l, h, p, g, n, 14, True,
                                            False)
    got = replay_ssd_bwd_bf16(x, dt, A, B, C, chunk, s0, dy, None)

    def f(x_, dt_, B_, C_):
        return JS.ssd_scan(x_, dt_, jnp.asarray(A.numpy()), B_, C_, chunk,
                           jnp.asarray(s0.numpy()))[0]

    _, vjp = jax.vjp(f, *(_to_jax(t) for t in (x, dt, B, C)))
    wx, _, wB, wC = vjp(_to_jax(dy))
    for a, w in ((got[0], wx), (got[3], wB), (got[4], wC)):
        _near_reference(a, w)


@pytest.mark.parametrize("name", ["flash_attention_bwd_bf16",
                                  "ssd_scan_bwd_bf16"])
def test_launch_declarations_take_the_signature_tables_arguments(name):
    """ctypes passes what ``build.SIGNATURES`` lists: each bf16 backward's C
    entry point declares as many parameters, pointers first as typed."""
    decl = re.search(rf"int {name}_launch\((.*?)\)\s*{{",
                     (CSRC / f"{name}.cu").read_text(), re.S)
    assert decl is not None
    params = [a.strip() for a in decl.group(1).split(",")]
    sig = SIGNATURES[f"{name}_launch"]
    assert len(params) == len(sig)
    assert ["*" in a for a in params] == \
        [t.__name__ == "c_void_p" for t in sig]

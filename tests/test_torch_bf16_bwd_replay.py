"""CPU replays of the two bf16 backward kernels.

``csrc/flash_attention_bwd_bf16.cu`` and ``csrc/ssd_scan_bwd_bf16.cu`` run
only on the card, so their loops are replayed here in float64, with bf16
rounding at the kernels' own rounding points (float64 sums stand in for
their fp32 sums of exact bf16 products):

- attention: D = rowsum(dO o O) over the bf16 output (the rows kernel's
  table); dk/dv by (batch, kv head, 64-key tile), the query tiles holding
  64 // G queries by the kv head's G query heads, rows (query, head)
  query-major as the TMA box lays them out, zero past Sq, visited from the
  diagonal when causal, up to the window's reach, plus the tiles of rows
  that see no key, split in order over the cluster's ranks (the card's
  CTA slots' worth, 1 to 8, at most the tiles) and the ranks' partials
  summed in rank order; P rounded to bf16 as the A operand of dV = P^T dO, dS = P (dP - D)
  from the unrounded P rounded as the operand of dK = dS^T Q; dq by (batch,
  kv head, query tile) over the 64-key tiles it sees, S and dP formed
  again; each gradient rounded once;
- the scan: the state pass (the chunks' start states recomputed first to
  last, then G of each chunk last to first, in fp32), then the chunk
  kernel by (batch, chunk, group), the group's heads in head blocks of
  ceil(rep / 8), each block's heads in order and the blocks (the
  cluster's ranks) summed in order: as t, C B^T and dy x^T once a head, K
  and M with the decays rounded where the reference rounds them in the
  values (dx, dB, dC) and unrounded in the derivatives (dcum), the tiles
  bf16(K dt) and bf16(M) and the operand bf16(M dt); as s, the tiles read
  back transposed by the causal 64 x 64 blocks of their s block; G and S0
  as two bf16 terms; dcum's suffix sum; dA summed over batch and chunks
  in order.

Each replay is held, on numpy-seeded inputs, to autograd of the port's
plain bf16 forward on the bf16 bar (the truth is autograd of the plain
fp32 forward on the same bf16-exact inputs; the replay within twice the
plain bf16 version's error and within 3e-2 of the largest |truth|), over
causal, windowed and non-causal attention, GQA from 1 to 64 query heads a
kv head, ragged tails, clusters of one to eight ranks, and one and two
scan chunks with and without an initial state, head blocks of one to
three heads, and to the JAX package's gradient of its bf16 model functions
(``repro.arch.layers._sdpa`` and ``repro.arch.ssm.ssd_scan``) within the
3e-2 of the largest magnitude the reference's bf16 kernel test uses. Keep
them in step with the two ``.cu`` files.
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
from repro_torch.arch import layers as TL  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.build import CSRC, SIGNATURES  # noqa: E402

BF16 = torch.bfloat16
F64 = torch.float64
KERNEL_TOL = 3e-2   # the reference's bf16 kernel test
BQ = BKV = 64       # query rows a tile; keys a dk/dv CTA
MAX_CLUSTER = 8   # the portable cluster size: dk/dv's ranks, the scan's


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


def query_tiles(Sq, Skv, causal, window, j0, qb):
    """The first queries of the query tiles (qb queries by the G heads of a
    kv head) a dk/dv CTA at key j0 visits (``query_tiles`` of the
    kernel)."""
    nokey = Skv - 1 + window if causal and window else Sq
    qa, qhi = 0, Sq
    if causal:
        qa = j0 // qb * qb
        if window and j0 + BKV - 1 + window < Sq:
            qhi = j0 + BKV - 1 + window
    n1 = -(-(qhi - qa) // qb) if qhi > qa else 0
    e1 = qa + n1 * qb
    s2 = nokey - qb + 1
    s2 = -(-s2 // qb) * qb if s2 > 0 else 0
    s2 = max(s2, e1)
    return [qa + i * qb for i in range(n1)] + list(range(s2, Sq, qb))


def key_tiles(Sq, Skv, causal, window, i0, qb):
    """The first keys of the 64-key tiles a dq CTA at query i0 visits."""
    lo, hi = 0, Skv
    if causal:
        last = min(i0 + qb, Sq) - 1
        hi = min(last + 1, Skv)
        if window:
            first = i0 - window + 1
            lo = first // BKV * BKV if first > 0 else 0
    return list(range(lo, hi, BKV)) if lo < hi else []


def cluster_ranks(B, Sq, Skv, KV, qb, D):
    """The ranks of a dk/dv cluster: the card's 132 SMs' worth of CTAs (two
    an SM at D <= 64), 1 to 8, at most the query tiles."""
    ctas = -(-Skv // BKV) * B * KV
    slots = 264 if D <= 64 else 132
    return min(max(1, min(MAX_CLUSTER, slots // ctas)), -(-Sq // qb))


def tile_rows(t, i0, kvh, G, qb, Sq):
    """Rows of the query tile from query i0 of kv head kvh, (query, head)
    pairs query-major (row r: query i0 + r // G, head kvh G + r % G), as
    the TMA box lays them out: t[:, i, h] gathered to (qb G, ...), zero
    past Sq; and each row's query and whether it is one."""
    i = i0 + torch.arange(qb * G) // G
    h = kvh * G + torch.arange(qb * G) % G
    ok = i < Sq
    rows = t[:, i.clamp(max=Sq - 1), h]
    rows = torch.where(ok.view((1, -1) + (1,) * (rows.ndim - 2)), rows,
                       torch.zeros((), dtype=rows.dtype))
    return rows, i, ok


def p_ds(s, dp, lse, dvec, i, ok, j, causal, window, Skv, nokey):
    """P and dS (float64) of the scores s and dP of tile rows (queries i,
    ``ok`` where in range) by keys j, with the kernels' masks: a row past Sq
    or a masked pair 0, a row that sees no key P = 1 / Skv and dS = 0."""
    p = torch.exp(s - lse[:, None])
    ds = p * (dp - dvec[:, None])
    zero = torch.zeros((), dtype=F64)
    i = i[:, None]
    if causal:
        masked = (j[None, :] > i) | ((i - j[None, :] >= window) if window
                                     else False)
        p = torch.where(masked, zero, p)
        ds = torch.where(masked, zero, ds)
        blind = (i >= nokey).expand_as(p)
        p = torch.where(blind, torch.full((), 1 / Skv, dtype=F64), p)
        ds = torch.where(blind, zero, ds)
    p = torch.where(ok[:, None], p, zero)
    ds = torch.where(ok[:, None], ds, zero)
    return p, ds


def replay_flash_bwd_bf16(q, k, v, out, dout, lse, causal, window):
    """csrc/flash_attention_bwd_bf16.cu's three kernels: (dq, dk, dv)
    bf16."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb = BQ // G
    ranks = cluster_ranks(B, Sq, Skv, KV, qb, D)
    nokey = Skv - 1 + window if causal and window else Sq
    Q, K, V, O, dO = (t.to(F64) for t in (q, k, v, out, dout))
    Lse = lse.to(F64).transpose(1, 2)            # (B, Sq, H)
    dvec = (dO * O).sum(-1)                      # the rows kernel, (B, Sq, H)
    dq = torch.zeros(B, Sq, H, D, dtype=F64)
    dk = torch.zeros(B, Skv, KV, D, dtype=F64)
    dv = torch.zeros(B, Skv, KV, D, dtype=F64)
    scale = D ** -0.5

    def tile(b, kvh, i0):
        (qt, dot), i, ok = tile_rows(torch.stack([Q[b], dO[b]]), i0, kvh, G,
                                     qb, Sq)
        (lt, dvt), _, _ = tile_rows(torch.stack([Lse[b], dvec[b]]), i0, kvh,
                                    G, qb, Sq)
        return qt, dot, lt, dvt, i, ok

    for b in range(B):
        for kvh in range(KV):
            for j0 in range(0, Skv, BKV):         # dk/dv: a cluster
                j = torch.arange(j0, min(j0 + BKV, Skv))
                kt, vt = K[b, j0:j0 + BKV, kvh], V[b, j0:j0 + BKV, kvh]
                tiles = query_tiles(Sq, Skv, causal, window, j0, qb)
                n = len(tiles)
                parts = []
                for rank in range(ranks):
                    pk = torch.zeros(len(j), D, dtype=F64)
                    pv = torch.zeros(len(j), D, dtype=F64)
                    for i0 in tiles[n * rank // ranks:
                                    n * (rank + 1) // ranks]:
                        qt, dot, lt, dvt, i, ok = tile(b, kvh, i0)
                        p, ds = p_ds(qt @ kt.T * scale, dot @ vt.T, lt, dvt,
                                     i, ok, j, causal, window, Skv, nokey)
                        pv += r16(p).T @ dot
                        pk += r16(ds).T @ qt
                    parts.append((pk, pv))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:         # in rank order
                    sk, sv = sk + pk, sv + pv
                dk[b, j0:j0 + BKV, kvh] = sk * scale
                dv[b, j0:j0 + BKV, kvh] = sv
            for i0 in range(0, Sq, qb):           # dq: a query tile
                qt, dot, lt, dvt, i, ok = tile(b, kvh, i0)
                acc = torch.zeros(qb * G, D, dtype=F64)
                for j0 in key_tiles(Sq, Skv, causal, window, i0, qb):
                    j = torch.arange(j0, min(j0 + BKV, Skv))
                    kt, vt = K[b, j0:j0 + BKV, kvh], V[b, j0:j0 + BKV, kvh]
                    _, ds = p_ds(qt @ kt.T * scale, dot @ vt.T, lt, dvt, i,
                                 ok, j, causal, window, Skv, nokey)
                    if causal:   # a row that sees no key has dS = 0
                        ds = torch.where(i[:, None] >= nokey,
                                         torch.zeros((), dtype=F64), ds)
                    acc += r16(ds) @ kt
                h = kvh * G + torch.arange(qb * G) % G
                dq[b, i[ok], h[ok]] = (acc * scale)[ok]
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
# attention at D = 128 (the vision model's head dim), G = 16 (4 queries a
# tile) and G = 64 (one), small head dims; every case but the MHA one
# splits its query tiles over a cluster of more than one rank, some ranks
# with none
ATTN_CASES = {
    "causal S=100 G=7": (1, 100, 100, 14, 2, 64, True, 0),
    "window 16 S=150 G=7": (1, 150, 150, 14, 2, 64, True, 16),
    "window 4 Sq=17 Skv=9 D=16, rows with no key": (1, 17, 9, 14, 2, 16,
                                                   True, 4),
    "cross Sq=40 Skv=77 D=128 G=4": (2, 40, 77, 8, 2, 128, False, 0),
    "G=16 S=70 D=32": (1, 70, 70, 16, 1, 32, True, 0),
    "MHA S=37 G=1": (2, 37, 37, 4, 4, 64, True, 0),
    "G=64 S=20 D=16, one query a tile": (1, 20, 20, 64, 1, 16, True, 0),
    "window 8 S=90 G=2, two kv heads": (2, 90, 90, 4, 2, 64, True, 8),
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


def head_blocks(h, g):
    """The chunk kernel's head blocks: ceil(rep / 8) of a group's rep heads
    a block, the group's blocks the ranks of one cluster."""
    rep = h // g
    hb = -(-rep // MAX_CLUSTER)
    return hb, -(-rep // hb)


def causal_blocks(q):
    """The chunk's 64 x 64 blocks (t block, s block) with t >= s, in the
    kernel's tile order."""
    nb = -(-q // 64)
    return [(tb, sb) for tb in range(nb) for sb in range(tb + 1)]


def replay_ssd_bwd_bf16(x, dt, A, B, C, chunk, init_state, dy, dfinal):
    """csrc/ssd_scan_bwd_bf16.cu: ``(dx, ddt, dA, dB, dC, dinit)``, dx,
    ddt, dB, dC bf16, dA and dinit float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q, c, rep = chunk, l // chunk, h // g
    hb, ranks = head_blocks(h, g)
    X, dY, Bf, Cf = (t.to(F64) for t in (x, dy, B, C))
    dts_all = dt.to(F64)
    # 1. the state pass: the chunks' start states first to last (unrounded
    # u_s), then G of each chunk last to first (unrounded exp(cum_t))
    S0 = ref.ssd_chunk_states(X, dts_all, A.to(F64), Bf, chunk,
                              None if init_state is None
                              else init_state.to(F64))   # (b, c, h, p, n)
    cum_all = torch.cumsum(dts_all.reshape(b, c, q, h) * A.to(F64), 2)
    Gc = (torch.zeros(b, h, p, n, dtype=F64) if dfinal is None
          else dfinal.to(F64))
    Gs = [None] * c
    for ci in reversed(range(c)):
        Gs[ci] = Gc
        sl = slice(ci * q, (ci + 1) * q)
        Cg = Cf[:, sl].repeat_interleave(rep, 2)              # (b, q, h, n)
        Gc = Gc * torch.exp(cum_all[:, ci, -1])[:, :, None, None] + \
            torch.einsum("bqh,bqhp,bqhn->bhpn", torch.exp(cum_all[:, ci]),
                         dY[:, sl], Cg)
    has_state = c > 1 or init_state is not None
    dx = torch.zeros(b, l, h, p, dtype=F64)
    ddt = torch.zeros(b, l, h, dtype=F64)
    dB = torch.zeros(b, l, g, n, dtype=F64)
    dC = torch.zeros(b, l, g, n, dtype=F64)
    dapart = torch.zeros(b, c, h, dtype=F64)
    keep = torch.ones(q, q, dtype=torch.bool).tril()
    blocks = causal_blocks(q)
    # 2. the chunk kernel: a block per (group, head block) and (batch,
    # chunk), its heads in order, the ranks' dB and dC summed in order
    for bi in range(b):
        for ci in range(c):
            sl = slice(ci * q, (ci + 1) * q)
            has_s = has_state and (ci > 0 or init_state is not None)
            has_g = (c > 1 or dfinal is not None or init_state is not None) \
                and not (dfinal is None and ci == c - 1)
            for gi in range(g):
                Cc, Bc = Cf[bi, sl, gi], Bf[bi, sl, gi]       # (q, n)
                CB = Cc @ Bc.T                                # (t, s)
                parts = []
                for rank in range(ranks):
                    dBg = torch.zeros(q, n, dtype=F64)
                    dCg = torch.zeros(q, n, dtype=F64)
                    for hh in range(gi * rep + rank * hb,
                                    gi * rep + min(rep, (rank + 1) * hb)):
                        xs, dys = X[bi, sl, hh], dY[bi, sl, hh]   # (q, p)
                        dts = dts_all[bi, sl, hh]
                        cum = cum_all[bi, ci, :, hh]
                        ecu, wu = torch.exp(cum), torch.exp(cum[-1] - cum)
                        ecr, wr = r16(ecu), r16(wu)
                        lu = torch.exp((cum[:, None] - cum[None, :])
                                       .masked_fill(~keep, -math.inf))
                        L = r16(lu)
                        # a. as t: K, M, the tiles, dC, W's sums
                        dP = dys @ xs.T
                        K, M = CB * L, dP * L
                        kt, mt = r16(K * dts[None, :]), r16(M)
                        dCg += r16(M * dts[None, :]) @ Bc
                        W = CB * lu * dts[None, :] * dP
                        roww, colw = W.sum(1), W.sum(0)
                        kdp = (K * dP).sum(0)
                        t5 = torch.zeros(q, dtype=F64)
                        if has_s:
                            dyS = dys @ _two_terms(S0[bi, ci, hh])
                            dCg += ecr[:, None] * dyS
                            t5 = ecu * (Cc * dyS).sum(-1)
                        # b. as s: the tiles read back transposed, by the
                        # causal blocks of their s block
                        dxh = torch.zeros(q, p, dtype=F64)
                        dbh = torch.zeros(q, n, dtype=F64)
                        for tb, sb in blocks:
                            ts, ss = (slice(64 * tb, 64 * tb + 64),
                                      slice(64 * sb, 64 * sb + 64))
                            dxh[ss] += kt[ts, ss].T @ dys[ts]
                            dbh[ss] += mt[ts, ss].T @ Cc[ts]
                        dbh = dbh * dts[:, None]
                        wsr = wr * dts
                        t2 = torch.zeros(q, dtype=F64)
                        if has_g:
                            G2 = _two_terms(Gs[ci][bi, hh])       # (p, n)
                            GB = Bc @ G2.T
                            dxh += wsr[:, None] * GB
                            dbh += wsr[:, None] * (xs @ G2)
                            t2 = wu * (xs * GB).sum(-1)
                        dBg += dbh
                        dx[bi, sl, hh] = dxh
                        # c. dcum, its suffix sum, ddt, dA's share
                        dcum = roww - colw + t5 - dts * t2
                        dcum[-1] += (dts * t2).sum()
                        if has_s and has_g:
                            dcum[-1] += torch.exp(cum[-1]) * (
                                S0[bi, ci, hh] * Gs[ci][bi, hh]).sum()
                        dda = torch.flip(torch.cumsum(torch.flip(dcum, [0]),
                                                      0), [0])
                        ddt[bi, sl, hh] = kdp + t2 + A[hh].double() * dda
                        dapart[bi, ci, hh] = (dts * dda).sum()
                    parts.append((dBg, dCg))
                sb_, sc_ = parts[0]
                for pb, pc in parts[1:]:                 # in rank order
                    sb_, sc_ = sb_ + pb, sc_ + pc
                dB[bi, sl, gi], dC[bi, sl, gi] = sb_, sc_
    dA = dapart.reshape(b * c, h).sum(0)   # the last block, in order
    return (dx.to(BF16), ddt.to(BF16), dA.float(), dB.to(BF16), dC.to(BF16),
            None if init_state is None else Gc.float())


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
# heads of 64, n = 128: 8 head blocks of 3) at one and two chunks, from an
# initial state with a final-state gradient, two groups, ragged p, n and
# chunk, a head block that does not divide the heads (11: 5 blocks of 2
# and one of 1) and two groups of 10 heads in blocks of 2
SSD_CASES = {
    "one chunk, trainer widths": (1, 128, 24, 64, 1, 128, 128, False,
                                  False),
    "two chunks, init state, final grad": (1, 256, 8, 64, 1, 128, 128, True,
                                           True),
    "two chunks, groups 2": (1, 256, 8, 64, 2, 128, 128, False, False),
    "ragged p=24 n=40 chunk 24 groups 2, init": (2, 48, 4, 24, 2, 40, 24,
                                                 True, False),
    "one chunk of 40, init state": (1, 40, 3, 16, 1, 32, 40, True, False),
    "11 heads: head blocks of 2 and 1": (1, 64, 11, 16, 1, 32, 64, False,
                                         False),
    "groups 2 of 10 heads, two chunks, init": (1, 128, 20, 16, 2, 32, 64,
                                               True, False),
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


@pytest.mark.parametrize("name", ARCHS)
def test_call_sites_hand_the_bf16_backwards_gradients_tma_can_read(name):
    """At every configuration's widths the gradient that reaches
    attention's output (``arch/layers.py:self_attention``) and the scan's y
    (``arch/ssm.py:ssm_block``) in a bf16 step is contiguous and starts on
    16 bytes, as the bf16 backward kernels' TMA maps take it (their
    wrappers raise otherwise, copying nothing). Run on the meta device
    through the call sites themselves, the kernels' wrappers wrapped to
    record each output's gradient."""
    from repro_torch.arch import ssm as TS

    cfg = get_config(name)
    Bt, L = 2, cfg.ssm_chunk if cfg.ssm_state else 16
    grads = []

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            first.register_hook(grads.append)
            return out
        return call

    meta = dict(device="meta", dtype=BF16)
    x = torch.empty((Bt, L, cfg.d_model), **meta, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "flash_attention", recording(TL.flash_attention))
        mp.setattr(TS, "ssd_scan", recording(TS.ssd_scan))
        if cfg.n_heads:
            p = {"wq": (cfg.d_model, cfg.n_heads * cfg.d_head),
                 "wk": (cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                 "wv": (cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                 "wo": (cfg.n_heads * cfg.d_head, cfg.d_model)}
            p = {k: torch.empty(v, **meta) for k, v in p.items()}
            out, _, _ = TL.self_attention(p, x, cfg,
                                          torch.arange(L, device="meta"))
            out.sum().backward()
        if cfg.ssm_state:
            p = TS.init_ssm(torch.Generator(), cfg, **meta)
            out, _ = TS.ssm_block(p, x, cfg)
            out.sum().backward()
    assert len(grads) == bool(cfg.n_heads) + bool(cfg.ssm_state)
    for g in grads:
        assert g.dtype == BF16 and g.is_contiguous()
        assert g.storage_offset() * 2 % 16 == 0


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

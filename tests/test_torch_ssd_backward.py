"""The SSD scan's backward on the CPU: the plain version against autograd
and against the JAX package, the autograd ``Function`` the card runs, and
a replay of the backward kernels in torch.

The CUDA kernels (``csrc/ssd_scan_bwd.cu``) cannot run here, so
``replay_backward`` walks them step by step over flat buffers laid out as
their shared memory is: the state pass over the chunks, last to first
(rows padded to 129 and 65 floats, each product an operand address ``r *
ar + k * ak`` against ``c * bc + k * bk``, the strides the kernel
passes); then per (batch, chunk, head) the chunk kernel's tiles (rows
padded to 132 and 68 floats, M = dP o L kept strip by strip with only the
columns on or past each strip's diagonal, an unwritten entry NaN so that
a read past what was written shows): the 16 x 8 tiles of M on or below the
diagonal; C B^T of each (batch, chunk, group) by strips of s, once for the
group's heads (kernel 2a); dx by strips split evenly over pairs of
warps, 8-wide tiles of t, K o dt and W = CB o M o dt formed from kernel
2a's tiles, W's row and column sums from the same terms, the first
half's partial added to the second's; the dC^T tiles (64 n x 8 t, over s <= t)
with their rows' C . dC; the dB tiles (16 s x 32 n, over t >= s); the
triangle's masks; dcum's suffix scan four steps a lane; then the group and
dA sums. It must give autograd's gradients of the plain scan, at the
shapes the card tests use (small here: h = 4, p = 8, n = 16). Keep it in
step with the kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.arch import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SsdScanFunction, ssd_scan, ssd_scan_backward, ssd_scan_forward)

MAXQ = MAXN = 128
MAXP = 64
LDS, LDY = MAXN + 1, MAXP + 1     # the state pass's rows
LDN, LDP = MAXN + 4, MAXP + 4     # the chunk kernel's B, C and dy rows
WARPS = 16

# (b, l, h, p, groups, n, chunk, initial state, final-state gradient)
CASES = {
    "one chunk": (2, 16, 4, 8, 1, 16, 16, False, False),
    "chunks of 8, groups 2": (2, 32, 4, 8, 2, 16, 8, False, False),
    "chunks of 16, init state, final grad": (2, 48, 4, 8, 1, 16, 16, True,
                                             True),
    "chunks of 8, groups 2, init state": (1, 24, 4, 8, 2, 16, 8, True,
                                          False),
    "one chunk, final grad": (1, 8, 4, 8, 2, 16, 8, False, True),
    "ragged p=5 n=12, chunks of 8": (2, 16, 4, 5, 1, 12, 8, True, True),
}


def make_inputs(b, l, h, p, g, n, init, dfin, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=dtype)
    x, B, C = t(b, l, h, p), t(b, l, g, n), t(b, l, g, n)
    dt = torch.as_tensor(rng.uniform(0.05, 0.5, (b, l, h)), dtype=dtype)
    A = -torch.as_tensor(rng.uniform(0.1, 1.0, (h,)), dtype=dtype)
    s0 = t(b, h, p, n) if init else None
    dy = t(b, l, h, p)
    dfinal = t(b, h, p, n) if dfin else None
    return x, dt, A, B, C, s0, dy, dfinal


def autograd_grads(x, dt, A, B, C, chunk, s0, dy, dfinal):
    leaves = [v.detach().clone().requires_grad_(True)
              for v in (x, dt, A, B, C) + ((s0,) if s0 is not None else ())]
    y, final = ref.ssd_scan_ref(*leaves[:5], chunk,
                                leaves[5] if s0 is not None else None)
    outs, grads = [y], [dy]
    if dfinal is not None:
        outs.append(final)
        grads.append(dfinal)
    got = torch.autograd.grad(outs, leaves, grads)
    return list(got) + ([None] if s0 is None else [])


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# -- the replay ------------------------------------------------------------


def stage(dst, ld, RR, CC, src, rows, cols, rscale=None):
    """csrc stage<CC>: rows < RR, columns < CC of ``dst`` (flat, rows of
    ``ld``) from ``src`` (indexed [r, k]), zero past rows x cols."""
    block = torch.zeros((RR, CC), dtype=dst.dtype)
    if rows and cols:
        v = src[:rows, :cols].to(dst.dtype)
        if rscale is not None:
            v = v * rscale[:rows, None]
        block[:rows, :cols] = v
    dst[:RR * ld].view(RR, ld)[:, :CC] = block


def mm(acc, A, ar, ak, Bm, bc, bk, kn):
    """csrc mm<RI, CJ>: acc (16 RI, 16 CJ), row ty + 16 i and column
    tx + 16 j, += sum_k A[r ar + k ak] Bm[c bc + k bk]."""
    r = torch.arange(acc.shape[0])[:, None]
    c = torch.arange(acc.shape[1])[:, None]
    k = torch.arange(kn)[None, :]
    acc += A[r * ar + k * ak] @ Bm[c * bc + k * bk].T


def chunk_cum(dts, a, q):
    """(cum, exp(cum)) as warp 0 forms them: cum_end past q, 0 for exp."""
    run = torch.cumsum(dts * a, 0)
    cum = torch.where(torch.arange(MAXQ) < q, run, run[q - 1])
    ecum = torch.where(torch.arange(MAXQ) < q, torch.exp(run),
                       torch.zeros_like(run))
    return cum, ecum


def replay_state_pass(dt, A, C, dy, dfinal, chunk, want_dinit):
    """Kernel 1: G of every chunk (b, c, h, p, n) and dinit (or None)."""
    b, l, h, p = dy.shape
    g, n = C.shape[2], C.shape[3]
    nc, q, f = l // chunk, chunk, dy.dtype
    gbuf = torch.zeros((b, nc, h, p, n), dtype=f)
    dinit = torch.zeros((b, h, p, n), dtype=f)
    for bb in range(b):
        for hh in range(h):
            grp = hh // (h // g)
            gs = torch.zeros(MAXP * LDS, dtype=f)
            stage(gs, LDS, MAXP, MAXN,
                  dfinal[bb, hh] if dfinal is not None else None,
                  p if dfinal is not None else 0, n)
            for ci in reversed(range(nc)):
                c0 = ci * q
                gbuf[bb, ci, hh] = gs.view(MAXP, LDS)[:p, :n]
                dts = torch.zeros(MAXQ, dtype=f)
                dts[:q] = dt[bb, c0:c0 + q, hh]
                cs = torch.zeros(MAXQ * LDS, dtype=f)
                stage(cs, LDS, MAXQ, MAXN, C[bb, c0:c0 + q, grp], q, n)
                cum, ecum = chunk_cum(dts, A[hh], q)
                ys = torch.zeros(MAXQ * LDY, dtype=f)
                stage(ys, LDY, MAXQ, MAXP, dy[bb, c0:c0 + q, hh], q, p, ecum)
                acc = torch.exp(cum[q - 1]) * gs.view(MAXP, LDS)[:, :MAXN]
                mm(acc, ys, 1, LDY, cs, 1, LDS, q)
                gs.view(MAXP, LDS)[:, :MAXN] = acc
            dinit[bb, hh] = gs.view(MAXP, LDS)[:p, :n]
    return gbuf, (dinit if want_dinit else None)


def band_ld(j):
    """Row length of M's strip j (columns t >= 16 j), 4 mod 8."""
    return MAXQ - 16 * j + 4


def band_off(j):
    return 16 * (j * (MAXQ + 4) - 8 * j * (j - 1))


class Bands:
    """M = dP o L, s-major, strip j (rows 16 j .. 16 j + 15) holding only
    columns t >= 16 j, as the kernel's shared memory does; an entry not
    yet written is NaN, and a read outside a strip's columns fails."""

    def __init__(self, f):
        self.buf = torch.full((band_off(MAXQ // 16),), float("nan"),
                              dtype=f)

    def _at(self, s, t):
        j = s // 16
        assert bool((t >= 16 * j).all()) and bool((t < MAXQ).all())
        return band_off(j) + (s - 16 * j) * band_ld(j) + (t - 16 * j)

    def write(self, s, t, v):
        self.buf[self._at(s, t)] = v

    def read(self, s, t):
        return self.buf[self._at(s, t)]


def replay_cb(B, C, chunk):
    """Kernel 2a: C B^T of each (batch, chunk, group) and 16-row strip j of
    s, for the 8-wide tiles of t from 2 j, as transposed tiles (16 s x 8
    t); NaN where no tile is formed. (b * nc * g, S16, 2 S16, 16, 8)."""
    b, l, g, n = B.shape
    nc, q, f = l // chunk, chunk, B.dtype
    S16 = -(-q // 16)
    cbuf = torch.full((b * nc * g, S16, 2 * S16, 16, 8), float("nan"),
                      dtype=f)
    for bcg in range(b * nc * g):
        bb, ci, gg = bcg // (nc * g), (bcg // g) % nc, bcg % g
        bq = torch.zeros((16 * S16, n), dtype=f)
        bq[:q] = B[bb, ci * q:(ci + 1) * q, gg]
        cq = torch.zeros((16 * S16, n), dtype=f)
        cq[:q] = C[bb, ci * q:(ci + 1) * q, gg]
        for j in range(S16):
            for tt in range(2 * j, 2 * S16):
                cbuf[bcg, j, tt] = bq[16 * j:16 * j + 16] @ \
                    cq[8 * tt:8 * tt + 8].T
    return cbuf


def replay_chunk(x, dt, A, B, C, dy, states, gbuf, cbuf, g_last_zero,
                 has_init, b_, ci, hh, chunk, out):
    """Kernel 2, one block: writes dx, ddt, its heads' dB and dC rows and
    its dA share into ``out``."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, q, f = l // chunk, chunk, x.dtype
    c0, grp = ci * q, hh // (h // g)
    S16, T8 = -(-q // 16), -(-q // 8)
    Q16, NK, PK = 16 * S16, -(-n // 8), -(-p // 8)
    has_g = gbuf is not None and not (g_last_zero and ci == nc - 1)
    has_s = states is not None and not (ci == 0 and not has_init)
    nan = float("nan")
    G = gbuf[b_, ci, hh] if has_g else None
    S0 = states[b_, ci, hh] if has_s else None
    # staged by cp.async: rows < Q16, zero past q, n and p
    bs = torch.full((MAXQ * LDN,), float("nan"), dtype=f)
    cs = torch.full((MAXQ * LDN,), float("nan"), dtype=f)
    ys = torch.full((MAXQ * LDP,), float("nan"), dtype=f)
    stage(bs, LDN, Q16, MAXN, B[b_, c0:c0 + q, grp], q, n)
    stage(cs, LDN, Q16, MAXN, C[b_, c0:c0 + q, grp], q, n)
    stage(ys, LDP, Q16, MAXP, dy[b_, c0:c0 + q, hh], q, p)
    bs2, cs2 = bs.view(MAXQ, LDN), cs.view(MAXQ, LDN)
    ys2 = ys.view(MAXQ, LDP)
    xq = torch.zeros((MAXQ, 8 * KP_ALL), dtype=f)
    xq[:q, :p] = x[b_, c0:c0 + q, hh]
    dts = torch.zeros(MAXQ, dtype=f)
    dts[:q] = dt[b_, c0:c0 + q, hh]
    cum, ecum = chunk_cum(dts, A[hh], q)
    cum_end = cum[MAXQ - 1]
    wq = torch.where(torch.arange(MAXQ) < q, torch.exp(cum_end - cum),
                     torch.zeros_like(cum))

    def decay(s, t):
        """e^(cum_t - cum_s) where s <= t < q, else 0 (and no exponent)."""
        keep = (s <= t) & (t < q)
        return keep, torch.where(keep, torch.exp(torch.where(
            keep, cum[t] - cum[s], torch.zeros((), dtype=f))),
            torch.zeros((), dtype=f))

    # a. M's 16 x 8 tiles on or below the diagonal, strip by strip, split
    # evenly over the warps (each warp's run up to four tiles at a time)
    M = Bands(f)
    tiles = 0
    flat = [(j, tt) for j in range(S16) for tt in range(2 * j, 2 * S16)]
    assert len(flat) == S16 * (S16 + 1)
    for w in range(WARPS):
        run = flat[len(flat) * w // WARPS:len(flat) * (w + 1) // WARPS]
        for j, tt in run:
            s0, t0 = 16 * j, 8 * tt
            s = torch.arange(s0, s0 + 16)[:, None]
            t = torch.arange(t0, t0 + 8)[None, :]
            assert t0 + 7 >= s0   # never wholly above the diagonal
            acc = xq[s0:s0 + 16, :8 * PK] @ ys2[t0:t0 + 8, :8 * PK].T
            keep, L = decay(s, t)
            M.write(s, t, torch.where(keep, acc * L, 0.0))
            tiles += 1
    out["m_tiles"] += tiles

    # b. dx by strips: a segment of strip j over t in [16 u0, 16 u1); W
    # formed once for its row and column sums
    ddtd = torch.zeros(MAXQ, dtype=f)
    colw = torch.zeros(MAXQ, dtype=f)
    roww = torch.full((MAXQ // 16, MAXQ), nan, dtype=f)
    t2 = torch.zeros(MAXQ, dtype=f)

    def segment(j, tb, te):
        """Strip j over the 8-wide tiles of t from tb to te."""
        s0 = 16 * j
        s = torch.arange(s0, s0 + 16)
        dxa = torch.zeros((16, 8 * KP_ALL), dtype=f)
        dd = torch.zeros(16, dtype=f)
        cw = torch.zeros(16, dtype=f)
        if tb == 2 * j and has_g:
            gb = bs2[s0:s0 + 16, :8 * NK] @ torch.nn.functional.pad(
                G, (0, 8 * NK - n, 0, 8 * KP_ALL - p)).T[:8 * NK]
            t2[s0:s0 + 16] = wq[s] * (xq[s0:s0 + 16] * gb).sum(1)
            dxa = gb * (wq[s] * dts[s])[:, None]
        for tt in range(tb, te):
            t = torch.arange(8 * tt, 8 * tt + 8)
            cbt = cbuf[(b_ * nc + ci) * g + grp, j, tt]   # kernel 2a's
            assert not torch.isnan(cbt).any()
            mv = M.read(s[:, None], t[None, :])
            kd = cbt * mv
            w = kd * dts[s][:, None]
            dd += kd.sum(1)
            cw += w.sum(1)
            roww[j, 8 * tt:8 * tt + 8] = w.sum(0)
            keep, L = decay(s[:, None], t[None, :])
            kv = torch.where(keep, cbt * L * dts[s][:, None], 0.0)
            dxa[:, :8 * PK] += kv @ ys2[8 * tt:8 * tt + 8, :8 * PK]
        return dxa, dd, cw

    def dx_out(j, dxa, dd, cw):
        s0 = 16 * j
        rows = min(16, q - s0)
        out["dx"][b_, c0 + s0:c0 + s0 + rows, hh] = dxa[:rows, :p]
        ddtd[s0:s0 + 16] = dd
        colw[s0:s0 + 16] = cw

    # strip j holds tiles [2 j, 2 S16); a pair (m, S16 - 1 - m) holds
    # 2 S16 + 2 of them, S16 + 1 a warp, as the middle strip alone does
    pairs, half = S16 // 2, S16 + 1
    assert S16 <= WARPS
    for w in range(S16):           # the dx warps, in any order
        m = w // 2
        if w >= 2 * pairs:
            assert 2 * S16 - 2 * pairs == half
            dx_out(pairs, *segment(pairs, 2 * pairs, 2 * S16))
        elif w % 2 == 1:
            jb = S16 - 1 - m
            assert (2 * S16 - 2 * jb) + (2 * S16 - 2 * m - half) == half
            dx_out(jb, *segment(jb, 2 * jb, 2 * S16))
            first = segment(m, 2 * m, 2 * m + half)   # the even warp's
            rest = segment(m, 2 * m + half, 2 * S16)
            dx_out(m, *(a_ + b_ for a_, b_ in zip(first, rest)))

    # b. the dC^T tiles (64 n x 8 t; s < 8 (i8 + 1)) and dB tiles
    # (16 s x 32 n; t >= 16 j), longest first
    items = []
    for length in range(2 * S16, 0, -1):
        if length <= T8:
            items += [("dC", nh, length - 1) for nh in range(2)
                      if 64 * nh < n]
        if length % 2 == 0:
            items += [("dB", nq, S16 - length // 2) for nq in range(4)
                      if 32 * nq < n]
    t5 = torch.zeros((2, MAXQ), dtype=f)
    for kind, sub, idx in items:
        if kind == "dC":
            t0, n0 = 8 * idx, 64 * sub
            s = torch.arange(0, 8 * (idx + 1))
            t = torch.arange(t0, t0 + 8)
            mdt = M.read(s[:, None], t[None, :]) * dts[s][:, None]
            acc = bs2[:8 * (idx + 1), n0:n0 + 64].T @ mdt   # (64 n, 8 t)
            if has_s:
                s0t = torch.zeros((8 * KP_ALL, 64), dtype=f)
                cols = max(0, min(64, n - n0))
                s0t[:p, :cols] = S0[:, n0:n0 + cols]
                sd = ecum[t][None, :] * (s0t[:8 * PK].T
                                         @ ys2[t0:t0 + 8, :8 * PK].T)
                acc = acc + sd
                live = torch.arange(n0, n0 + 64) < n
                t5[sub, t0:t0 + 8] = (cs2[t0:t0 + 8, n0:n0 + 64].T
                                      * sd)[live].sum(0)
            live = torch.arange(n0, n0 + 64) < n
            for tt in range(t0, min(t0 + 8, q)):
                out["dch"][b_, c0 + tt, hh, n0:n0 + 64][:max(0, n - n0)] = \
                    acc[live, tt - t0]
        else:
            s0, n0 = 16 * idx, 32 * sub
            s = torch.arange(s0, s0 + 16)
            t = torch.arange(s0, Q16)
            acc = M.read(s[:, None], t[None, :]) @ cs2[s0:Q16, n0:n0 + 32]
            acc = acc * dts[s][:, None]
            if has_g:
                gpad = torch.zeros((8 * KP_ALL, 32), dtype=f)
                cols = max(0, min(32, n - n0))
                gpad[:p, :cols] = G[:, n0:n0 + cols]
                acc = acc + (xq[s0:s0 + 16] * (wq[s] * dts[s])[:, None]) \
                    @ gpad
            rows, cols = min(16, q - s0), max(0, min(32, n - n0))
            if rows > 0 and cols > 0:
                out["dbh"][b_, c0 + s0:c0 + s0 + rows, hh,
                           n0:n0 + cols] = acc[:rows, :cols]

    # c. dcum, its suffix scan (four steps a lane, then across lanes),
    # ddt and the dA share
    sg = float((S0 * G).sum()) if has_g and has_s else 0.0
    vs = float((dts * t2).sum())
    d = torch.zeros(MAXQ, dtype=f)
    for t in range(q):   # the strips' row sums, in strip order
        d[t] = sum(roww[j, t] for j in range(t // 16 + 1))
    d[:q] += (-colw + (t5[0] + t5[1]) - dts * t2)[:q]
    d[q - 1] += vs + float(torch.exp(cum[q - 1])) * sg
    lanes = d.view(32, 4)
    suf = lanes.flip(1).cumsum(1).flip(1)
    incl = suf[:, 0].flip(0).cumsum(0).flip(0)
    after = torch.cat([incl[1:], torch.zeros(1, dtype=f)])
    dda = (suf + after[:, None]).reshape(MAXQ)
    out["ddt"][b_, c0:c0 + q, hh] = (ddtd + t2 + A[hh] * dda)[:q]
    out["dapart"][b_ * nc + ci, hh] = (dts * dda)[:q].sum()


KP_ALL = MAXP // 8


def replay_backward(x, dt, A, B, C, chunk, s0, dy, dfinal, counts=None):
    """All three kernels; returns (dx, ddt, dA, dB, dC, dinit)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, f = l // chunk, x.dtype
    states = (ref.ssd_chunk_states(x, dt, A, B, chunk, s0)
              if nc > 1 or s0 is not None else None)
    state_pass = nc > 1 or dfinal is not None or s0 is not None
    gbuf, dinit = (replay_state_pass(dt, A, C, dy, dfinal, chunk,
                                     s0 is not None)
                   if state_pass else (None, None))
    nan = float("nan")
    cbuf = replay_cb(B, C, chunk)
    out = {"dx": torch.full((b, l, h, p), nan, dtype=f),
           "ddt": torch.full((b, l, h), nan, dtype=f),
           "dbh": torch.full((b, l, h, n), nan, dtype=f),
           "dch": torch.full((b, l, h, n), nan, dtype=f),
           "dapart": torch.full((b * nc, h), nan, dtype=f),
           "m_tiles": 0}
    for hh in range(h):
        for bc in range(b * nc):
            replay_chunk(x, dt, A, B, C, dy, states, gbuf, cbuf,
                         dfinal is None, s0 is not None, bc // nc, bc % nc,
                         hh, chunk, out)
    if counts is not None:
        counts["m_tiles"] = out["m_tiles"]
    rep = h // g
    dB = torch.zeros((b, l, g, n), dtype=f)
    dC = torch.zeros((b, l, g, n), dtype=f)
    for u in range(rep):   # heads of a group, in order
        dB += out["dbh"].view(b, l, g, rep, n)[:, :, :, u]
        dC += out["dch"].view(b, l, g, rep, n)[:, :, :, u]
    dA = torch.zeros(h, dtype=f)
    for u in range(b * nc):   # batch and chunks, in order
        dA += out["dapart"][u]
    return out["dx"], out["ddt"], dA, dB, dC, dinit


# -- tests -----------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_within_1e5(case):
    b, l, h, p, g, n, chunk, init, dfin = CASES[case]
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(b, l, h, p, g, n, init,
                                                 dfin)
    got = ref.ssd_scan_bwd_ref(x, dt, A, B, C, chunk, s0, dy, dfinal)
    want = autograd_grads(x, dt, A, B, C, chunk, s0, dy, dfinal)
    for name, gg, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                           want):
        if w is None:
            assert gg is None, name
            continue
        assert gg.shape == w.shape, name
        assert rel(gg, w) <= 1e-5, (name, rel(gg, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp_within_1e4(case):
    """The JAX package's plain scan (``repro.arch.ssm.ssd_scan``), which its
    trainer differentiates, through ``jax.vjp`` on the same inputs."""
    b, l, h, p, g, n, chunk, init, dfin = CASES[case]
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(b, l, h, p, g, n, init,
                                                 dfin)
    args = [jnp.asarray(v.numpy()) for v in (x, dt, A, B, C)]
    if init:
        args.append(jnp.asarray(s0.numpy()))

    def f(*a):
        return jax_ssm.ssd_scan(*a[:5], chunk, a[5] if init else None)

    (y, final), vjp = jax.vjp(f, *args)
    dfin_j = (jnp.asarray(dfinal.numpy()) if dfin
              else jnp.zeros_like(final))
    want = vjp((jnp.asarray(dy.numpy()), dfin_j))
    got = ref.ssd_scan_bwd_ref(x, dt, A, B, C, chunk, s0, dy, dfinal)
    for name, gg, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                           want):
        w = torch.as_tensor(np.asarray(w))
        assert rel(gg, w) <= 1e-4, (name, rel(gg, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_kernels_give_autograds_gradients(case):
    b, l, h, p, g, n, chunk, init, dfin = CASES[case]
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(b, l, h, p, g, n, init,
                                                 dfin, seed=3,
                                                 dtype=torch.float64)
    got = replay_backward(x, dt, A, B, C, chunk, s0, dy, dfinal)
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, chunk, s0, dy, dfinal)
    for name, gg, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                           want):
        if w is None:
            assert gg is None, name
            continue
        assert rel(gg, w) <= 1e-10, (name, rel(gg, w))


def test_replay_exponents_stay_at_or_below_zero_below_the_diagonal():
    """The kernels form exp(cum_t - cum_s) only where s <= t: with A < 0
    and dt > 0 every such exponent is <= 0, and the masked products never
    see an overflowed term, even where the unmasked exponent would be
    huge."""
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(1, 16, 4, 8, 1, 16, False,
                                                 False, dtype=torch.float64)
    dt = dt * 400.0          # cum spans thousands: exp above it overflows
    got = replay_backward(x, dt, A, B, C, 16, None, dy, None)
    want = autograd_grads(x, dt, A, B, C, 16, None, dy, None)
    for gg, w in zip(got[:5], want[:5]):
        assert torch.isfinite(gg).all()
        assert rel(gg, w) <= 1e-10


def test_function_returns_none_for_a_none_init_and_takes_no_final_grad():
    """SsdScanFunction's bookkeeping on the CPU routes: the final state
    unused (its gradient None, taken as zero), an init_state of None gets
    None, and with one chunk and no initial state no start states are
    saved."""
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(2, 16, 4, 8, 1, 16, False,
                                                 False)
    leaves = [v.clone().requires_grad_(True) for v in (x, dt, A, B, C)]
    y, final = SsdScanFunction.apply(*leaves, 16, None)
    assert final.requires_grad
    saved = y.grad_fn.saved_tensors
    assert saved[5] is None and saved[6] is None   # init_state, states
    grads = torch.autograd.grad(y, leaves, dy)
    want = autograd_grads(x, dt, A, B, C, 16, None, dy, None)
    for gg, w in zip(grads, want):
        assert rel(gg, w) <= 1e-5


def test_function_with_init_state_saves_the_chunk_states():
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(1, 32, 4, 8, 2, 16, True,
                                                 True)
    leaves = [v.clone().requires_grad_(True) for v in (x, dt, A, B, C, s0)]
    y, final = SsdScanFunction.apply(*leaves[:5], 8, leaves[5])
    states = y.grad_fn.saved_tensors[6]
    assert states.shape == (1, 4, 4, 8, 16)
    assert torch.allclose(states, ref.ssd_chunk_states(x, dt, A, B, 8, s0))
    assert torch.equal(states[:, 0], s0)
    grads = torch.autograd.grad((y, final), leaves, (dy, dfinal))
    want = autograd_grads(x, dt, A, B, C, 8, s0, dy, dfinal)
    for gg, w in zip(grads, want):
        assert rel(gg, w) <= 1e-5


def test_forward_with_states_leaves_the_outputs_equal():
    x, dt, A, B, C, s0, *_ = make_inputs(2, 32, 4, 8, 1, 16, True, False)
    y, final, none = ssd_scan_forward(x, dt, A, B, C, 8, s0)
    y2, final2, states = ssd_scan_forward(x, dt, A, B, C, 8, s0,
                                          with_states=True)
    assert none is None and torch.equal(y, y2) and torch.equal(final, final2)
    assert states.shape == (2, 4, 4, 8, 16)


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU ``ssd_scan`` is the plain scan (autograd differentiates
    it) and ``ssd_scan_backward`` the plain backward; neither counts a
    launch."""
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(1, 16, 4, 8, 1, 16, True,
                                                 True)
    before = (ssd_scan.launches, ssd_scan_backward.launches)
    got = ssd_scan_backward(x, dt, A, B, C, 8, s0, dy, dfinal)
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, 8, s0, dy, dfinal)
    for gg, w in zip(got, want):
        assert torch.equal(gg, w)
    xr = x.clone().requires_grad_(True)
    y, _ = ssd_scan(xr, dt, A, B, C, 8, s0)
    assert y.grad_fn is not None and "SsdScan" not in type(y.grad_fn).__name__
    assert (ssd_scan.launches, ssd_scan_backward.launches) == before


def test_mamba2_reduced_gradients_match_autograd_of_the_plain_model():
    """A reduced Mamba2 loss on the CPU: its gradients through the model's
    scan (plain, autograd) equal those with the scan's backward taken from
    the plain backward through SsdScanFunction."""
    from repro_torch.arch import ssm
    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import leaves, unflatten

    cfg = get_config("mamba2-130m").reduced()
    model = TransformerLM(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    L = 2 * cfg.ssm_chunk if cfg.ssm_chunk <= 32 else cfg.ssm_chunk
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, L))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (2, L)))}

    def grads():
        flat = [t.detach().clone().requires_grad_(True)
                for t in leaves(params)]
        loss = model.loss(unflatten(params, flat), batch)
        return loss, torch.autograd.grad(loss, flat)

    loss, want = grads()
    plain = ssm.ssd_scan
    ssm.ssd_scan = lambda *a: SsdScanFunction.apply(*a)
    try:
        loss2, got = grads()
    finally:
        ssm.ssd_scan = plain
    assert abs(float(loss2) - float(loss)) <= 1e-6 * abs(float(loss))
    top = max(float(w.abs().max()) for w in want)
    for gg, w in zip(got, want):
        assert float((gg - w).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("chunk", [128, 24])
def test_replay_forms_only_the_causal_triangles_tiles(chunk):
    """dP's 16 x 8 tiles (and 2a's C B^T tiles) cover the causal triangle
    of each chunk and nothing wholly above it: S16 (S16 + 1) a chunk and
    head, against 2 S16^2 for whole tiles; the gradients still autograd's."""
    b, l, h, p, g, n = 1, 2 * chunk, 2, 8, 1, 16
    x, dt, A, B, C, s0, dy, dfinal = make_inputs(b, l, h, p, g, n, False,
                                                 False, seed=6,
                                                 dtype=torch.float64)
    counts = {}
    got = replay_backward(x, dt, A, B, C, chunk, None, dy, None, counts)
    s16 = -(-chunk // 16)
    assert counts["m_tiles"] == b * (l // chunk) * h * s16 * (s16 + 1)
    cb = replay_cb(B, C, chunk)
    formed = (~torch.isnan(cb)).all(-1).all(-1)
    assert int(formed.sum()) == b * (l // chunk) * g * s16 * (s16 + 1)
    want = autograd_grads(x, dt, A, B, C, chunk, None, dy, None)
    for gg, w in zip(got[:5], want[:5]):
        assert rel(gg, w) <= 1e-10

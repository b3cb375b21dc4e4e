"""The SSD scan's backward on the CPU: the plain version against autograd
and against the JAX package, the autograd ``Function`` the card runs, and
a replay of the backward kernels in torch.

The CUDA kernels (``csrc/ssd_scan_bwd.cu``) cannot run here, so
``replay_backward`` walks them step by step over flat buffers laid out as
their shared memory is (rows padded to 129 and 65 floats), with the same
staging, the same product calls (each an operand address ``r * ar + k *
ak`` against ``c * bc + k * bk``, the strides the kernel passes), the same
masks and the same order of sums: the state pass over the chunks, last to
first; the chunk kernel's three roles per (batch, chunk, head); the group
and dA sums. It must give autograd's gradients of the plain scan, at the
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
LDN, LDP = MAXN + 1, MAXP + 1

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


def tril(q):
    t = torch.arange(MAXQ)[:, None]
    s = torch.arange(MAXQ)[None, :]
    return (s <= t) & (t < q)


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
            gs = torch.zeros(MAXP * LDN, dtype=f)
            stage(gs, LDN, MAXP, MAXN,
                  dfinal[bb, hh] if dfinal is not None else None,
                  p if dfinal is not None else 0, n)
            for ci in reversed(range(nc)):
                c0 = ci * q
                gbuf[bb, ci, hh] = gs.view(MAXP, LDN)[:p, :n]
                dts = torch.zeros(MAXQ, dtype=f)
                dts[:q] = dt[bb, c0:c0 + q, hh]
                cs = torch.zeros(MAXQ * LDN, dtype=f)
                stage(cs, LDN, MAXQ, MAXN, C[bb, c0:c0 + q, grp], q, n)
                cum, ecum = chunk_cum(dts, A[hh], q)
                ys = torch.zeros(MAXQ * LDP, dtype=f)
                stage(ys, LDP, MAXQ, MAXP, dy[bb, c0:c0 + q, hh], q, p, ecum)
                acc = torch.exp(cum[q - 1]) * gs.view(MAXP, LDN)[:, :MAXN]
                mm(acc, ys, 1, LDP, cs, 1, LDN, q)
                gs.view(MAXP, LDN)[:, :MAXN] = acc
            dinit[bb, hh] = gs.view(MAXP, LDN)[:p, :n]
    return gbuf, (dinit if want_dinit else None)


def replay_chunk(role, x, dt, A, B, C, dy, states, gbuf, g_last_zero,
                 has_init, b_, ci, hh, chunk, out):
    """Kernel 2, one block: writes its role's outputs into ``out``."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, q, f = l // chunk, chunk, x.dtype
    c0, grp = ci * q, hh // (h // g)
    has_g = gbuf is not None and not (g_last_zero and ci == nc - 1)
    has_s = states is not None and not (ci == 0 and not has_init)
    r0 = torch.zeros(MAXQ * LDN, dtype=f)
    r1 = torch.zeros(MAXQ * LDN, dtype=f)
    xs = torch.zeros(MAXQ * LDP, dtype=f)
    ys = torch.zeros(MAXQ * LDP, dtype=f)
    dts = torch.zeros(MAXQ, dtype=f)
    dts[:q] = dt[b_, c0:c0 + q, hh]
    stage(xs, LDP, MAXQ, MAXP, x[b_, c0:c0 + q, hh], q, p)
    stage(ys, LDP, MAXQ, MAXP, dy[b_, c0:c0 + q, hh], q, p)
    stage(r1, LDN, MAXQ, MAXN, (C if role == 2 else B)[b_, c0:c0 + q, grp],
          q, n)
    if role == 0:
        stage(r0, LDN, MAXQ, MAXN, C[b_, c0:c0 + q, grp], q, n)
    cum, ecum = chunk_cum(dts, A[hh], q)
    cum_end = cum[q - 1]
    wq = torch.where(torch.arange(MAXQ) < q, torch.exp(cum_end - cum),
                     torch.zeros_like(cum))
    dp = torch.zeros((MAXQ, MAXQ), dtype=f)
    mm(dp, ys, LDP, 1, xs, LDP, 1, p)
    mask = tril(q)
    decay = torch.exp(torch.where(mask, cum[:, None] - cum[None, :],
                                  torch.zeros_like(dp)))
    if role == 0:
        kt = torch.zeros((MAXQ, MAXQ), dtype=f)
        mm(kt, r0, LDN, 1, r1, LDN, 1, n)
        kt = torch.where(mask, kt * decay, torch.zeros_like(kt))
        kd = kt * dp
        w = kd * dts[None, :]
        roww, colw, ddtd = w.sum(1), w.sum(0), kd.sum(0)
        t2 = torch.zeros(MAXQ, dtype=f)
        t5 = torch.zeros(MAXQ, dtype=f)
        r0.view(MAXQ, LDN)[:, :MAXQ] = kt * dts[None, :]
        dxa = torch.zeros((MAXQ, MAXP), dtype=f)
        mm(dxa, r0, 1, LDN, ys, 1, LDP, q)
        sg = 0.0
        if has_g:
            stage(r0, LDN, MAXP, MAXN, gbuf[b_, ci, hh], p, n)
            gb = torch.zeros((MAXQ, MAXP), dtype=f)
            mm(gb, r1, LDN, 1, r0, LDN, 1, n)
            dxa += (wq * dts)[:, None] * gb
            xg = (xs.view(MAXQ, LDP)[:, :MAXP] * gb).sum(1)
            t2 = wq * xg
        if has_s:
            stage(r1, LDN, MAXP, MAXN, states[b_, ci, hh], p, n)
            if has_g:
                sg = float((r1.view(MAXQ, LDN)[:MAXP, :MAXN]
                            * r0.view(MAXQ, LDN)[:MAXP, :MAXN]).sum())
            stage(r0, LDN, MAXQ, MAXN, C[b_, c0:c0 + q, grp], q, n)
            sc = torch.zeros((MAXQ, MAXP), dtype=f)
            mm(sc, r0, LDN, 1, r1, LDN, 1, n)
            t5 = ecum * (ys.view(MAXQ, LDP)[:, :MAXP] * sc).sum(1)
        # thread 0, in order
        vsum = sum(float(dts[s] * t2[s]) for s in range(q))
        run, da = 0.0, 0.0
        dda = torch.zeros(MAXQ, dtype=f)
        for t in reversed(range(q)):
            d = float(roww[t] - colw[t] + t5[t] - dts[t] * t2[t])
            if t == q - 1:
                d += vsum + float(torch.exp(cum_end)) * sg
            run += d
            dda[t] = run
            da += float(dts[t]) * run
        out["dapart"][b_ * nc + ci, hh] = da
        out["ddt"][b_, c0:c0 + q, hh] = (ddtd + t2 + A[hh] * dda)[:q]
        out["dx"][b_, c0:c0 + q, hh] = dxa[:q, :p]
        return
    v = torch.where(mask, dp * decay, torch.zeros_like(dp))
    if role == 1:
        v = v * dts[None, :]
    r0.view(MAXQ, LDN)[:, :MAXQ] = v
    acc = torch.zeros((MAXQ, MAXN), dtype=f)
    if role == 1:
        mm(acc, r0, LDN, 1, r1, 1, LDN, q)
        if has_s:
            stage(r0, LDN, MAXP, MAXN, states[b_, ci, hh], p, n)
            ys.view(MAXQ, LDP)[:, :MAXP] *= ecum[:, None]
            mm(acc, ys, LDP, 1, r0, 1, LDN, p)
        out["dch"][b_, c0:c0 + q, hh] = acc[:q, :n]
    else:
        mm(acc, r0, 1, LDN, r1, 1, LDN, q)
        acc *= dts[:, None]
        if has_g:
            stage(r0, LDN, MAXP, MAXN, gbuf[b_, ci, hh], p, n)
            xs.view(MAXQ, LDP)[:, :MAXP] *= (wq * dts)[:, None]
            mm(acc, xs, LDP, 1, r0, 1, LDN, p)
        out["dbh"][b_, c0:c0 + q, hh] = acc[:q, :n]


def replay_backward(x, dt, A, B, C, chunk, s0, dy, dfinal):
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
    out = {"dx": torch.zeros((b, l, h, p), dtype=f),
           "ddt": torch.zeros((b, l, h), dtype=f),
           "dbh": torch.zeros((b, l, h, n), dtype=f),
           "dch": torch.zeros((b, l, h, n), dtype=f),
           "dapart": torch.zeros((b * nc, h), dtype=f)}
    for role in range(3):
        for hh in range(h):
            for bc in range(b * nc):
                replay_chunk(role, x, dt, A, B, C, dy, states, gbuf,
                             dfinal is None, s0 is not None, bc // nc,
                             bc % nc, hh, chunk, out)
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

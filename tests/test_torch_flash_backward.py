"""Flash attention's backward on the CPU: the plain versions, the autograd
``Function`` the card runs, and a replay of the backward kernels' tile
loops.

The CUDA kernels (``csrc/flash_attention_bwd.cu``) cannot run here, so
``replay_backward`` walks their loops in torch: the dk/dv blocks over
(batch, kv head, 32 keys) with their G query heads and the 64-row query
tiles they visit (skips included), the dq blocks over (batch, head, 64
query rows) with the key tiles they visit, each pair tile formed as the
kernel forms it (P from the saved log-sum-exp, the forward's masks, rows
that see no key averaging every key). It must give autograd's gradients
of the plain attention at the edge cases the card tests use."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFunction, flash_attention, flash_attention_backward,
    flash_attention_forward)

BQ, BKV = 64, 32   # the kernels' query and key tiles


def _inputs(B, Sq, Skv, H, KV, D, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                          (B, Sq, H, D))]


def _pair_tile(q, k, v, dout, lse, dvec, b, h, kvh, i0, j0, causal, window):
    """P and dS of the (BQ, BKV) pair tile, zero outside the arrays."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[3]
    i = torch.arange(i0, i0 + BQ)[:, None]
    j = torch.arange(j0, j0 + BKV)[None, :]
    qi, di = i[:, 0].clamp(max=Sq - 1), j[0].clamp(max=Skv - 1)
    s = (q[b, qi, h] @ k[b, di, kvh].T) * D ** -0.5
    dp = dout[b, qi, h] @ v[b, di, kvh].T
    valid = (i < Sq) & (j < Skv)
    seen = torch.ones_like(valid)
    nokey = torch.zeros_like(valid)
    if causal:
        seen = (j <= i) & ((i - j < window) if window else True)
        if window:
            nokey = (i >= Skv - 1 + window).expand_as(valid)
    p = torch.exp(s - lse[b, h, qi][:, None])
    p = torch.where(valid & nokey, torch.full_like(p, 1.0 / Skv),
                    torch.where(valid & seen & ~nokey, p, torch.zeros_like(p)))
    ds = torch.where(valid & seen & ~nokey, p * (dp - dvec[b, h, qi][:, None]),
                     torch.zeros_like(p))
    return p, ds


def replay_backward(q, k, v, dout, causal, window):
    """The kernels' loops, step by step; returns (dq, dk, dv) and the number
    of pair tiles the dk/dv and dq blocks formed."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = ref.flash_attention_ref(q, k, v, causal, window)
    lse = ref.flash_attention_lse_ref(q, k, causal, window)
    dvec = (dout * out).sum(-1).permute(0, 2, 1)           # (B, H, Sq)
    pad_q = lambda t, i0: torch.nn.functional.pad(          # noqa: E731
        t[i0:i0 + BQ], (0, 0, 0, max(0, i0 + BQ - t.shape[0])))
    pad_k = lambda t, j0: torch.nn.functional.pad(          # noqa: E731
        t[j0:j0 + BKV], (0, 0, 0, max(0, j0 + BKV - t.shape[0])))
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    tiles = [0, 0]
    for b in range(B):
        for kvh in range(KV):
            for j0 in range(0, Skv, BKV):
                qlo, qhi, nokey = 0, Sq, Sq
                if causal:
                    qlo = j0
                    if window:
                        qhi = min(j0 + BKV - 1 + window, Sq)
                        nokey = Skv - 1 + window
                acc_k = torch.zeros((BKV, D), dtype=q.dtype)
                acc_v = torch.zeros((BKV, D), dtype=q.dtype)
                for hh in range(G):
                    h = kvh * G + hh
                    for i0 in range(qlo // BQ * BQ, Sq, BQ):
                        if i0 >= qhi and i0 + BQ <= nokey:
                            continue
                        tiles[0] += 1
                        p, ds = _pair_tile(q, k, v, dout, lse, dvec, b, h,
                                           kvh, i0, j0, causal, window)
                        acc_v += p.T @ pad_q(dout[b, :, h], i0)
                        acc_k += ds.T @ pad_q(q[b, :, h], i0)
                n = min(BKV, Skv - j0)
                dk[b, j0:j0 + n, kvh] = acc_k[:n] * D ** -0.5
                dv[b, j0:j0 + n, kvh] = acc_v[:n]
        for h in range(H):
            kvh = h // G
            for i0 in range(0, Sq, BQ):
                lo, hi = 0, Skv
                if causal:
                    hi = min(min(i0 + BQ, Sq), Skv)
                    if window:
                        lo = max(i0 - window + 1, 0) // BKV * BKV
                acc = torch.zeros((BQ, D), dtype=q.dtype)
                for j0 in range(lo, hi, BKV):
                    tiles[1] += 1
                    _, ds = _pair_tile(q, k, v, dout, lse, dvec, b, h, kvh,
                                       i0, j0, causal, window)
                    acc += ds @ pad_k(k[b, :, kvh], j0)
                n = min(BQ, Sq - i0)
                dq[b, i0:i0 + n, h] = acc[:n] * D ** -0.5
    return (dq, dk, dv), tiles


# (B, Sq, Skv, H, KV, D, causal, window): the trainer's shape, lengths
# around the tiles (1, 37, 200), both head maps, a window, rows that see no
# key, and cross attention.
_CASES = {
    "trainer S=128 G=7": (1, 128, 128, 14, 2, 64, True, 0),
    "S=1 G=7": (2, 1, 1, 7, 1, 16, True, 0),
    "S=37 G=1 D=128": (1, 37, 37, 2, 2, 128, True, 0),
    "S=200 G=7 window 16": (1, 200, 200, 7, 1, 32, True, 16),
    "S=200 G=1 window 100": (1, 200, 200, 1, 1, 16, True, 100),
    "Sq=100 Skv=77 window 8": (1, 100, 77, 2, 2, 16, True, 8),
    "Sq=17 Skv=9 window 4, rows with no key": (1, 17, 9, 14, 2, 16, True, 4),
    "Sq=1 Skv=77 causal": (1, 1, 77, 2, 1, 16, True, 0),
    "cross Sq=40 Skv=77": (1, 40, 77, 6, 3, 32, False, 0),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_replayed_backward_tiles_give_autograds_gradients(case):
    B, Sq, Skv, H, KV, D, causal, window = _CASES[case]
    q, k, v, dout = _inputs(B, Sq, Skv, H, KV, D, seed=Sq + Skv)
    got, tiles = replay_backward(q, k, v, dout, causal, window)
    want = ref.flash_attention_backward_ref(q, k, v, dout, causal, window)
    # the plain version takes its softmax in float32 (``.float()``)
    for name, g, w in zip("qkv", got, want):
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1.0))
        assert err <= 1e-6, f"d{name} ({case}): {err}"
    assert tiles[0] > 0 and tiles[1] >= 0


def test_replay_skips_the_query_tiles_a_window_does_not_reach():
    """Causal with a window: a key tile's dk/dv block visits only the query
    tiles that reach it, so the pair tiles grow with S, not S^2."""
    q, k, v, dout = _inputs(1, 512, 512, 1, 1, 16)
    _, (kv_tiles, q_tiles) = replay_backward(q, k, v, dout, True, 16)
    # a key tile's rows reach at most two query tiles; a query tile's rows
    # see at most three key tiles (15 keys back, 64 forward)
    assert kv_tiles <= 2 * (512 // BKV)
    assert q_tiles <= 3 * (512 // BQ)
    _, (full_kv, full_q) = replay_backward(q, k, v, dout, True, 0)
    assert full_kv > 3 * kv_tiles and full_q > 2 * q_tiles


def test_lse_ref_is_the_softmax_normaliser():
    q, k, v, _ = _inputs(2, 33, 33, 4, 2, 16, dtype=torch.float32)
    lse = ref.flash_attention_lse_ref(q, k, True, 8)
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, dim=2))
    s = s * 16 ** -0.5
    s = s.masked_fill(~ref.attention_mask(33, 33, 8)[None, None], -1e30)
    assert lse.shape == (2, 4, 33)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    # a row that sees no key: every score -1e30, and so its lse
    q, k, v, _ = _inputs(1, 17, 9, 2, 1, 16)
    lse = ref.flash_attention_lse_ref(q, k, True, 4)
    assert (lse[0, :, 12:] == -1e30).all() and (lse[0, :, :12] > -1e3).all()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_function_on_the_cpu_gives_autograds_gradients(case):
    """The card's autograd ``Function``, run on CPU tensors (its forward and
    backward take the plain versions there), against autograd of the plain
    attention: the Function's plumbing, saved tensors and argument order."""
    B, Sq, Skv, H, KV, D, causal, window = _CASES[case]
    q, k, v, dout = _inputs(B, Sq, Skv, H, KV, D, seed=1,
                            dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFunction.apply(*leaves, causal, window)
    out.backward(dout)
    want = ref.flash_attention_backward_ref(q, k, v, dout, causal, window)
    torch.testing.assert_close(out.detach(),
                               ref.flash_attention_ref(q, k, v, causal,
                                                       window))
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, dout = _inputs(1, 20, 20, 4, 2, 16, dtype=torch.float32)
    out, lse = flash_attention_forward(q, k, v, True, 0, with_lse=True)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    assert torch.equal(lse, ref.flash_attention_lse_ref(q, k))
    assert flash_attention_forward(q, k, v)[1] is None
    grads = flash_attention_backward(q, k, v, out, dout, lse)
    for g, w in zip(grads, ref.flash_attention_backward_ref(q, k, v, dout)):
        assert torch.equal(g, w)
    # autograd differentiates the CPU route of the wrapper itself
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).backward(dout)
    for leaf, w in zip(leaves, ref.flash_attention_backward_ref(q, k, v,
                                                                 dout)):
        torch.testing.assert_close(leaf.grad, w)
    with pytest.raises(ValueError, match="window"):
        flash_attention_backward(q, k, v, out, dout, lse, False, 4)

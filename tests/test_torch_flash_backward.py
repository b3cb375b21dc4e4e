"""Flash attention's backward on the CPU: the plain versions, the autograd
``Function`` the card runs, and a replay of the backward kernels' tile
loops.

The CUDA kernels (``csrc/flash_attention_bwd.cu``) cannot run here, so
``replay_backward`` walks their loops in torch: the dk/dv CTAs over
(batch, query head, 64 keys), grouped in a cluster per kv head whose C
ranks take ceil(G / 8) heads each, with the 64-row query tiles each
visits (skips included) and the transposed pair tile (S^T = K Q^T,
dP^T = V dO^T, P^T from the saved log-sum-exp, the forward's masks, rows
that see no key averaging every key), the ranks' partial dK and dV summed
in rank order; the dq CTAs over (batch, head, 64 query rows) with the key
tiles they visit (64 keys, 32 at D = 128). It must give autograd's
gradients of the plain attention at the edge cases the card tests use."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFunction, flash_attention, flash_attention_backward,
    flash_attention_forward)

BQ, BKV = 64, 64    # the kernels' query tile and dk/dv key tile
MAX_CLUSTER = 8     # the portable cluster size


def dq_key_tile(D: int) -> int:
    """The dq kernel's key tile."""
    return 64 if D <= 64 else 32


def cluster_ranks(G: int) -> list:
    """The dk/dv cluster of a kv head: ceil(G / 8) heads a rank, as many
    ranks as that needs; each rank's heads (offsets in the kv head's
    group), in order."""
    per = -(-G // MAX_CLUSTER)
    return [list(range(r * per, min(G, (r + 1) * per)))
            for r in range(-(-G // per))]


def query_tiles(Sq, Skv, j0, causal, window) -> list:
    """The query tiles a dk/dv CTA at key j0 visits for each head: from
    the diagonal (causal) as far as the window reaches, then the tiles
    holding a row that sees no key."""
    qa, qhi = 0, Sq
    nokey = Skv - 1 + window if causal and window else Sq
    if causal:
        qa = j0 // BQ * BQ
        if window:
            qhi = min(j0 + BKV - 1 + window, Sq)
    e1 = qa + (-(-(qhi - qa) // BQ) * BQ if qhi > qa else 0)
    s2 = nokey - BQ + 1
    s2 = max(-(-s2 // BQ) * BQ if s2 > 0 else 0, e1)
    return list(range(qa, e1, BQ)) + list(range(s2, Sq, BQ))


def _inputs(B, Sq, Skv, H, KV, D, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                          (B, Sq, H, D))]


def _rows(t, r0, n):
    """Rows r0 .. r0 + n of t, zero past its end (the kernels' cp.async
    zero fill)."""
    return torch.nn.functional.pad(t[r0:r0 + n],
                                   (0, 0, 0, max(0, r0 + n - t.shape[0])))


def _masks(i, j, Sq, Skv, causal, window):
    """(seen, nokey) of the pairs (i, j), broadcast: a pair the softmax
    sees, and a row that sees no key (it averages every key)."""
    valid = (i < Sq) & (j < Skv)
    seen = valid.clone()
    nokey = torch.zeros_like(valid)
    if causal:
        seen = valid & (j <= i) & ((i - j < window) if window else True)
        if window:
            nokey = valid & (i >= Skv - 1 + window)
    return seen & ~nokey, nokey


def _pair_tile_t(q, k, v, dout, lse, dvec, b, h, kvh, i0, j0, causal,
                 window):
    """P^T and dS^T of the dk/dv CTA's (BKV keys, BQ queries) tile as the
    kernel forms them: S^T = K Q^T and dP^T = V dO^T, then P^T from the
    queries' lse and dS^T = P^T (dP^T - D[query])."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[3]
    kt, vt = _rows(k[b, :, kvh], j0, BKV), _rows(v[b, :, kvh], j0, BKV)
    qt, ot = _rows(q[b, :, h], i0, BQ), _rows(dout[b, :, h], i0, BQ)
    st = (kt @ qt.T) * D ** -0.5
    dpt = vt @ ot.T
    j = torch.arange(j0, j0 + BKV)[:, None]
    i = torch.arange(i0, i0 + BQ)[None, :]
    qi = i[0].clamp(max=Sq - 1)
    seen, nokey = _masks(i, j, Sq, Skv, causal, window)
    pt = torch.exp(st - lse[b, h, qi][None, :])
    pt = torch.where(nokey, torch.full_like(pt, 1.0 / Skv),
                     torch.where(seen, pt, torch.zeros_like(pt)))
    dst = torch.where(seen, pt * (dpt - dvec[b, h, qi][None, :]),
                      torch.zeros_like(pt))
    return pt, dst, qt, ot


def _dq_tile(q, k, v, dout, lse, dvec, b, h, kvh, i0, j0, bk, causal,
             window):
    """dS of the dq CTA's (BQ queries, bk keys) tile and its K rows."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[3]
    kt, vt = _rows(k[b, :, kvh], j0, bk), _rows(v[b, :, kvh], j0, bk)
    s = (_rows(q[b, :, h], i0, BQ) @ kt.T) * D ** -0.5
    dp = _rows(dout[b, :, h], i0, BQ) @ vt.T
    i = torch.arange(i0, i0 + BQ)[:, None]
    j = torch.arange(j0, j0 + bk)[None, :]
    qi = i[:, 0].clamp(max=Sq - 1)
    seen, _ = _masks(i, j, Sq, Skv, causal, window)
    p = torch.exp(s - lse[b, h, qi][:, None])
    ds = torch.where(seen, p * (dp - dvec[b, h, qi][:, None]),
                     torch.zeros_like(p))
    return ds, kt


def _scores64(q, k, causal, window):
    """:func:`ref.flash_attention_ref`'s scaled, masked scores, (B, KV, G,
    Sq, Skv), left in the inputs' dtype: the plain version takes them in
    float32 (``.float()``)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) * (D ** -0.5)
    if causal:
        s = s.masked_fill(~ref.attention_mask(Sq, Skv, window, q.device),
                          -1e30)
    return s


def attention64(q, k, v, causal, window):
    """The plain attention with its softmax in the inputs' dtype."""
    B, Sq, H, D = q.shape
    w = torch.softmax(_scores64(q, k, causal, window), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, Sq, H, D)


def backward64(q, k, v, dout, causal, window):
    """Autograd's (dq, dk, dv) of :func:`attention64`: the replay's
    yardstick, with no float32 arithmetic in it."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = attention64(*leaves, causal, window)
        return torch.autograd.grad(out, leaves, dout)


def replay_backward(q, k, v, dout, causal, window):
    """The kernels' loops, step by step, in the inputs' dtype (the output
    and its log-sum-exp too); returns (dq, dk, dv) and the number of pair
    tiles the dk/dv and dq CTAs formed."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = attention64(q, k, v, causal, window)
    lse = torch.logsumexp(_scores64(q, k, causal, window),
                          dim=-1).reshape(B, H, Sq)
    dvec = (dout * out).sum(-1).permute(0, 2, 1)           # (B, H, Sq)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    tiles = [0, 0]
    ranks = cluster_ranks(G)
    for j0 in range(0, Skv, BKV):
        visited = query_tiles(Sq, Skv, j0, causal, window)
        for b in range(B):
            for kvh in range(KV):
                parts = []            # each rank's partial dK, dV
                for heads in ranks:
                    acc_k = torch.zeros((BKV, D), dtype=q.dtype)
                    acc_v = torch.zeros((BKV, D), dtype=q.dtype)
                    for hh in heads:
                        h = kvh * G + hh
                        for i0 in visited:
                            tiles[0] += 1
                            pt, dst, qt, ot = _pair_tile_t(
                                q, k, v, dout, lse, dvec, b, h, kvh, i0, j0,
                                causal, window)
                            acc_v += pt @ ot
                            acc_k += dst @ qt
                    parts.append((acc_k, acc_v))
                sum_k, sum_v = parts[0]
                for acc_k, acc_v in parts[1:]:   # ranks 0, 1, ..., C - 1
                    sum_k, sum_v = sum_k + acc_k, sum_v + acc_v
                n = min(BKV, Skv - j0)
                dk[b, j0:j0 + n, kvh] = sum_k[:n] * D ** -0.5
                dv[b, j0:j0 + n, kvh] = sum_v[:n]
    bk = dq_key_tile(D)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for i0 in range(0, Sq, BQ):
                lo, hi = 0, Skv
                if causal:
                    hi = min(min(i0 + BQ, Sq), Skv)
                    if window:
                        lo = max(i0 - window + 1, 0) // bk * bk
                acc = torch.zeros((BQ, D), dtype=q.dtype)
                for j0 in range(lo, hi, bk):
                    tiles[1] += 1
                    ds, kt = _dq_tile(q, k, v, dout, lse, dvec, b, h, kvh,
                                      i0, j0, bk, causal, window)
                    acc += ds @ kt
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
    # clusters of 3 and 4 ranks (phi4-mini's head map at D = 128), and
    # beyond one cluster: 16 heads as 8 ranks of 2, 9 as 4 of 2 and 1 of 1
    "G=3 D=128": (2, 128, 128, 24, 8, 128, True, 0),
    "G=4 D=128": (1, 128, 128, 32, 8, 128, True, 0),
    "G=16 S=128": (1, 128, 128, 16, 1, 64, True, 0),
    "G=9 window 16": (1, 70, 70, 9, 1, 16, True, 16),
    # rows that see no key in query tiles past the window's reach
    "Sq=300 Skv=77 window 8": (1, 300, 77, 2, 1, 16, True, 8),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_replayed_backward_tiles_give_autograds_gradients(case):
    B, Sq, Skv, H, KV, D, causal, window = _CASES[case]
    q, k, v, dout = _inputs(B, Sq, Skv, H, KV, D, seed=Sq + Skv)
    got, tiles = replay_backward(q, k, v, dout, causal, window)
    # both sides in float64: the float32 softmax of the plain version put
    # its own rounding (2e-7 of the 1e-6 bar here) into the comparison
    want = backward64(q, k, v, dout, causal, window)
    for name, g, w in zip("qkv", got, want):
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1.0))
        assert err <= 1e-6, f"d{name} ({case}): {err}"
    assert tiles[0] > 0 and tiles[1] >= 0


def test_replay_skips_the_query_tiles_a_window_does_not_reach():
    """Causal with a window: a key tile's dk/dv CTA visits only the query
    tiles that reach it, so the pair tiles grow with S, not S^2."""
    q, k, v, dout = _inputs(1, 512, 512, 1, 1, 16)
    _, (kv_tiles, q_tiles) = replay_backward(q, k, v, dout, True, 16)
    # a 64-key tile's rows reach at most two query tiles (64 keys and 15
    # back); a query tile's rows see at most two key tiles (15 keys back,
    # 64 forward)
    assert kv_tiles <= 2 * (512 // BKV)
    assert q_tiles <= 2 * (512 // BQ)
    _, (full_kv, full_q) = replay_backward(q, k, v, dout, True, 0)
    assert full_kv > 2 * kv_tiles and full_q > 2 * q_tiles


@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8, 9, 12, 16, 17, 64])
def test_cluster_ranks_take_every_head_once_in_order(G):
    """A dk/dv cluster has at most 8 ranks (the portable size), each with
    at least one head, the heads in order: ceil(G / 8) a rank."""
    ranks = cluster_ranks(G)
    assert 1 <= len(ranks) <= MAX_CLUSTER
    assert [h for heads in ranks for h in heads] == list(range(G))
    assert all(heads for heads in ranks)
    assert max(map(len, ranks)) == -(-G // MAX_CLUSTER)


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

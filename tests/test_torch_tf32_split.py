"""The numerics of the tensor-core kernels, rehearsed on the CPU.

``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu`` and the LSTM-cell tile
(``csrc/lstm_cell_tile.cuh``) run their matrix
products as 3xTF32 ``mma.sync`` steps (``csrc/mma_tf32x3.cuh``): each fp32
operand is split as ``big = tf32(a)``, ``small = a - big`` and a product
is accumulated in fp32 as ``small*big' + big*small' + big*big'``. Here
TF32 rounding (round to nearest, ties away from zero, to a 10-bit
mantissa, as PTX ``cvt.rna.tf32.f32`` rounds and as the header does with
two integer operations) is emulated through the int32 view, and so is the
tensor core's reading of an unrounded operand (``small``): only its top
19 bits, the rest dropped. The two kernels' algorithms, with every
product made that way, are
held to the 1e-4 bar (of the largest |output|) that the card checks hold
the kernels to against the fp32 plain versions of ``kernels/ref.py``, at
the shapes of the LM path; the cell's, with its split of K over a cluster
and the fixed order in which the partial sums meet, at the tagger's. A single-TF32 product is computed too; it is
reported beside the split and only held to be worse than it.

The fragment layout of an ``m16n8k8`` step and the header's paired k
order (an accumulator fed back as the A operand with no shuffle) are
checked lane by lane, and so are the banks each fragment loader reads at
the kernels' row strides.

The backward of the attention (``csrc/flash_attention_bwd.cu``) is
rehearsed the same way: its seven products (S^T, dP^T, P^T dO, dS^T Q for
dk/dv; S, dP, dS K for dq) split, the accumulators fed back in the paired
k order, the cluster's per-rank partials summed in rank order, held to
1e-4 of the largest |gradient| of the fp64 plain backward.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

BAR = 1e-4
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away
    from zero: add half of the 13 dropped bits' unit to the magnitude
    bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 given as a TF32 operand: the
    top 19 bits, the 13 low mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: 3xTF32, the small terms first."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32_read(a - ab), tf32_read(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# -- the rounding itself ----------------------------------------------------


def test_tf32_rounding_keeps_ten_mantissa_bits_and_ties_away():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(10000) * 10.0 ** rng.integers(
        -6, 6, 10000), dtype=torch.float32)
    r = tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    one = torch.tensor([1.0, -1.0])
    tie = one * (1 + 2.0 ** -11)                   # half way: away from 0
    assert torch.equal(tf32(tie), one * (1 + 2.0 ** -10))
    below = one * (1 + 2.0 ** -11 - 2.0 ** -23)    # just below: down
    assert torch.equal(tf32(below), one)


def test_split_recovers_the_operand_to_fp32_resolution():
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(10000),
                        dtype=torch.float32)
    big = tf32(x)
    small = x - big
    assert ((small.abs() <= x.abs() * 2.0 ** -11)).all()
    assert ((big + tf32_read(small) - x).abs() <= x.abs() * 2.0 ** -21).all()


# -- the paired k order and the fragment layout -----------------------------


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3      # g, t


def _a_matrix(frag):
    """The 16 x 8 A operand that per-lane registers ``frag`` (32, 4) stand
    for in an m16n8k8 step: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
    a3 (g+8, t+4)."""
    g, t = _lanes()
    A = np.zeros((16, 8))
    A[g, t], A[g + 8, t] = frag[:, 0], frag[:, 1]
    A[g, t + 4], A[g + 8, t + 4] = frag[:, 2], frag[:, 3]
    return A


def _b_matrix(frag):
    """The 8 x 8 B operand (K x N) of registers ``frag`` (32, 2):
    b0 (k = t, n = g), b1 (k = t+4, n = g)."""
    g, t = _lanes()
    B = np.zeros((8, 8))
    B[t, g], B[t + 4, g] = frag[:, 0], frag[:, 1]
    return B


PAIRED = [0, 2, 4, 6, 1, 3, 5, 7]   # logical k -> physical column


def test_accumulator_fed_back_as_a_operand_in_paired_order():
    """An m16n8k8 accumulator c (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
    c3 (g+8, 2t+1)) passed on as a = (c0, c2, c1, c3), with B read as
    b0 = V[2t][g], b1 = V[2t+1][g], multiplies the accumulator by V: the
    P V step of the attention kernel and the diagonal block of the scan."""
    rng = np.random.default_rng(2)
    P, V = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    g, t = _lanes()
    c = np.stack([P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t],
                  P[g + 8, 2 * t + 1]], axis=1)
    a = c[:, [0, 2, 1, 3]]
    b = np.stack([V[2 * t, g], V[2 * t + 1, g]], axis=1)
    A, B = _a_matrix(a), _b_matrix(b)
    # the logical operands are the physical ones with k permuted alike
    np.testing.assert_array_equal(A, P[:, PAIRED])
    np.testing.assert_array_equal(B, V[PAIRED])
    np.testing.assert_allclose(A @ B, P @ V, rtol=1e-12, atol=1e-12)


def test_transposed_operand_in_paired_order():
    """``load_at_paired`` (a0 = X[2t][g], a1 = X[2t][g+8], a2 =
    X[2t+1][g], a3 = X[2t+1][g+8]) with ``load_b_paired`` on W gives
    X^T W: the scan's state update."""
    rng = np.random.default_rng(3)
    X, W = rng.standard_normal((8, 16)), rng.standard_normal((8, 8))
    g, t = _lanes()
    a = np.stack([X[2 * t, g], X[2 * t, g + 8], X[2 * t + 1, g],
                  X[2 * t + 1, g + 8]], axis=1)
    b = np.stack([W[2 * t, g], W[2 * t + 1, g]], axis=1)
    got = _a_matrix(a) @ _b_matrix(b)
    np.testing.assert_allclose(got, X.T @ W, rtol=1e-12, atol=1e-12)


def test_transposed_b_operand_in_natural_order():
    """``load_b_nk`` (b0 = K[g][t], b1 = K[g][t+4]) reads K^T: the score
    products Q K^T and C B^T and the carried state C S^T."""
    rng = np.random.default_rng(4)
    Q, K = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    g, t = _lanes()
    a = np.stack([Q[g, t], Q[g + 8, t], Q[g, t + 4], Q[g + 8, t + 4]],
                 axis=1)
    b = np.stack([K[g, t], K[g, t + 4]], axis=1)
    got = _a_matrix(a) @ _b_matrix(b)
    np.testing.assert_allclose(got, Q @ K.T, rtol=1e-12, atol=1e-12)


def test_natural_a_operand_from_a_row_major_tile():
    """``load_a`` (a0 = K[g][t], a1 = K[g+8][t], a2 = K[g][t+4],
    a3 = K[g+8][t+4]) with ``load_b_nk`` on Q gives K Q^T: the backward's
    transposed scores S^T and dP^T, K and V rows as the A operand."""
    rng = np.random.default_rng(9)
    K, Q = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    g, t = _lanes()
    a = np.stack([K[g, t], K[g + 8, t], K[g, t + 4], K[g + 8, t + 4]],
                 axis=1)
    b = np.stack([Q[g, t], Q[g, t + 4]], axis=1)
    np.testing.assert_array_equal(_a_matrix(a), K)
    np.testing.assert_allclose(_a_matrix(a) @ _b_matrix(b), K @ Q.T,
                               rtol=1e-12, atol=1e-12)


# lane -> word offsets each loader reads (one array per load instruction)
def _loader_offsets(ld: int) -> dict:
    g, t = _lanes()
    return {"load_a": [g * ld + t, (g + 8) * ld + t, g * ld + t + 4,
                       (g + 8) * ld + t + 4],
            "load_b_nk": [g * ld + t, g * ld + t + 4],
            "load_b_paired": [2 * t * ld + g, (2 * t + 1) * ld + g]}


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_fragment_loads_hit_32_banks_at_the_padded_stride(D):
    """Rows padded to D + 4 floats (attention forward and backward): every
    load instruction of every fragment loader reads 32 distinct banks."""
    for name, reads in _loader_offsets(D + 4).items():
        for words in reads:
            assert len(set(words % 32)) == 32, (name, D)


# -- the kernels' algorithms with split products ----------------------------


def attention_split(q, k, v, causal, window, mm):
    """The attention kernel's arithmetic: S = Q K^T and O = P V through
    ``mm``, the softmax in fp32 with exp2 and log2(e) folded into the
    scale (masked in-range scores -1e30, as the kernel's)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.permute(0, 2, 1, 3)                               # (B, H, Sq, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    s = mm(qh, kh.transpose(-1, -2)) * (LOG2E / D ** 0.5)
    if causal:
        s = s.masked_fill(~ref.attention_mask(Sq, Skv, window), -1e30)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = mm(p, vh) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def ssd_split(x, dt, A, B, C, chunk, mm, init_state=None):
    """The scan kernel's arithmetic: per chunk the scores C B^T, the
    diagonal block (scores o decay o dt) x, the carried state C S^T
    scaled by exp(cum_t) and the update S exp(cum_end) + x^T (B o dt o
    exp(cum_end - cum_s)), every product through ``mm``."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xh = x.permute(0, 2, 1, 3)                               # (b, h, l, p)
    dth = dt.permute(0, 2, 1)                                # (b, h, l)
    Bh = B.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)  # (b, h, l, n)
    Ch = C.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    S = (torch.zeros((b, h, p, n)) if init_state is None
         else init_state.clone())
    tril = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xh[:, :, sl], dth[:, :, sl], Bh[:, :, sl], Ch[:, :, sl]
        cum = torch.cumsum(dtc * A[None, :, None], dim=-1)   # (b, h, q)
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, 0)
        decay = torch.exp2(diff * LOG2E).masked_fill(~tril, 0)
        scores = mm(Cc, Bc.transpose(-1, -2)) * decay * dtc[..., None, :]
        y = mm(scores, xc) + torch.exp2(cum * LOG2E)[..., None] * mm(
            Cc, S.transpose(-1, -2))
        ys.append(y)
        wdt = torch.exp2((cum[..., -1:] - cum) * LOG2E) * dtc
        S = S * torch.exp2(cum[..., -1] * LOG2E)[..., None, None] + mm(
            xc.transpose(-1, -2), Bc * wdt[..., None])
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


def _attn_inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


def _ssd_inputs(b, l, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, l, h, p)),
              np.abs(rng.standard_normal((b, l, h))) * 0.5,
              -np.abs(rng.standard_normal(h)) * 0.5,
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, l, g, n))]
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


# (B, Sq, Skv, H, KV, D, causal, window): the two Qwen2-0.5B wave shapes
# (S = 32, B = 2 and S = 96, B = 4), a window and a cross-attention.
ATTN_CASES = {
    "wave S=32 B=2": (2, 32, 32, 14, 2, 64, True, 0),
    "wave S=96 B=4": (4, 96, 96, 14, 2, 64, True, 0),
    "window 16 S=100": (1, 100, 100, 4, 2, 32, True, 16),
    "cross Sq=40 Skv=77": (2, 40, 77, 6, 3, 128, False, 0),
}

# (b, l, h, p, g, n, chunk): the two Mamba2-130m wave shapes and a ragged
# one with two groups.
SSD_CASES = {
    "wave l=128 b=3": (3, 128, 24, 64, 1, 128, 128),
    "wave l=256 b=3": (3, 256, 24, 64, 1, 128, 128),
    "ragged p=24 n=40 chunk 24, groups 2": (2, 72, 4, 24, 2, 40, 24),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_with_split_products_meets_the_bar(case):
    B, Sq, Skv, H, KV, D, causal, window = ATTN_CASES[case]
    q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, seed=Sq + D)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    err3 = rel_err(attention_split(q, k, v, causal, window, mm3), want)
    err1 = rel_err(attention_split(q, k, v, causal, window, mm1), want)
    print(f"attention {case}: 3xTF32 {err3:.3e}, TF32 {err1:.3e}")
    assert err3 <= BAR
    assert err3 < err1


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_with_split_products_meets_the_bar(case):
    b, l, h, p, g, n, chunk = SSD_CASES[case]
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, seed=l + n)
    s0 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (b, h, p, n)), dtype=torch.float32)
    for init in (None, s0):
        y_want, s_want = ref.ssd_scan_ref(x, dt, A, B, C, chunk, init)
        y3, s3 = ssd_split(x, dt, A, B, C, chunk, mm3, init)
        y1, s1 = ssd_split(x, dt, A, B, C, chunk, mm1, init)
        err3 = max(rel_err(y3, y_want), rel_err(s3, s_want))
        err1 = max(rel_err(y1, y_want), rel_err(s1, s_want))
        print(f"ssd_scan {case}, init {init is not None}: 3xTF32 "
              f"{err3:.3e}, TF32 {err1:.3e}")
        assert err3 <= BAR
        assert err3 < err1


def cell_split(xh, w, b, c, split, cluster=4, kc=32):
    """The cell kernels' arithmetic at B rows: y^T = w^T xh^T in k steps
    of 8, each step's products (``split``: the three 3xTF32 terms in the
    kernel's order, or one TF32 product) added in fp32 into the
    accumulator of its CTA (``cluster`` CTAs, a K slice of chunks of
    ``kc`` each), its warp (k step 0-3 of a chunk) and its chunk's parity;
    then a CTA's two accumulators and four warps' partials, then the CTAs
    in rank order, in the kernel's fixed order; then the bias and the gate
    math."""
    K, H4 = w.shape
    H, B = H4 // 4, xh.shape[0]
    n_chunks = -(-K // kc)
    per_rank = -(-n_chunks // cluster)
    acc = torch.zeros((cluster, 4, 2, H4, B))
    for chunk in range(n_chunks):
        rank, local = divmod(chunk, per_rank)
        for ks in range(4):
            k0 = chunk * kc + ks * 8
            if k0 >= K:
                continue
            a, bm = w[k0:k0 + 8].t(), xh[:, k0:k0 + 8].t()
            for term in split(a, bm):
                acc[rank, ks, local % 2] += term
    part = acc[:, :, 0] + acc[:, :, 1]
    cta = ((part[:, 0] + part[:, 1]) + part[:, 2]) + part[:, 3]
    y = cta[0]
    for r in range(1, cluster):
        y = y + cta[r]
    y = y.t() + b
    i, f = torch.sigmoid(y[:, :H]), torch.sigmoid(y[:, H:2 * H])
    g, o = torch.tanh(y[:, 2 * H:3 * H]), torch.sigmoid(y[:, 3 * H:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def terms3(a, b):
    """A step's 3xTF32 terms in the order ``mma3_row`` issues them."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32_read(a - ab), tf32_read(b - bb)
    return as_ @ bb, ab @ bs, ab @ bb


def terms1(a, b):
    return (tf32(a) @ tf32(b),)


def _cell_inputs(B, K, H, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32)
            for scale, shape in ((1.0, (B, K)), (0.05, (K, 4 * H)),
                                 (0.1, (4 * H,)), (1.0, (B, H)))]


# (B, K, H, cluster): the tagger's cell at width 512 (B = 16, K = 1024,
# 4H = 2048; clusters of 4), one row, and clusters of 2 at B = 32.
CELL_CASES = {
    "tagger B=16": (16, 1024, 512, 4),
    "B=1": (1, 1024, 512, 4),
    "B=32 clusters of 2": (32, 1024, 512, 2),
}


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_cell_with_split_products_and_split_k_meets_the_bar(case):
    B, K, H, cluster = CELL_CASES[case]
    xh, w, b, c = _cell_inputs(B, K, H, seed=B + K)
    h_want, c_want = ref.fused_lstm_cell_ref(xh, w, b, c)
    h3, c3 = cell_split(xh, w, b, c, terms3, cluster)
    h1, c1 = cell_split(xh, w, b, c, terms1, cluster)
    err3 = max(rel_err(h3, h_want), rel_err(c3, c_want))
    err1 = max(rel_err(h1, h_want), rel_err(c1, c_want))
    print(f"cell {case}: 3xTF32 {err3:.3e}, TF32 {err1:.3e}")
    assert err3 <= BAR
    assert err1 > BAR       # a single TF32 product misses the bar


def test_split_algorithms_in_fp32_are_the_plain_versions():
    """With exact fp32 products the two algorithms above are the plain
    versions, so what the bar measures is the split's rounding alone."""
    def mm(a, b):
        return a @ b

    q, k, v = _attn_inputs(2, 33, 33, 14, 2, 64, seed=6)
    want = ref.flash_attention_ref(q, k, v, True, 0)
    assert rel_err(attention_split(q, k, v, True, 0, mm), want) <= 1e-6
    x, dt, A, B, C = _ssd_inputs(2, 64, 4, 16, 2, 16, seed=7)
    y, s = ssd_split(x, dt, A, B, C, 16, mm)
    y_want, s_want = ref.ssd_scan_ref(x, dt, A, B, C, 16)
    assert rel_err(y, y_want) <= 1e-5 and rel_err(s, s_want) <= 1e-5
    xh, w, b, c = _cell_inputs(5, 333, 24, seed=8)   # ragged K and chunks
    h, c2 = cell_split(xh, w, b, c, lambda a, bm: (a @ bm,), 4)
    h_want, c_want = ref.fused_lstm_cell_ref(xh, w, b, c)
    assert rel_err(h, h_want) <= 1e-5 and rel_err(c2, c_want) <= 1e-5


# -- the backward of the attention -------------------------------------------


def _paired(n: int) -> torch.Tensor:
    """The paired k order over n (padded to a multiple of 8): in each block
    of 8, logical k = t reads physical 2t and k = t + 4 reads 2t + 1."""
    m = -(-n // 8) * 8
    return torch.tensor([b + p for b in range(0, m, 8) for p in PAIRED])


def _fed_back(acc, rows, mm):
    """``acc @ rows`` with the accumulator fed back as the A operand: the k
    axis (acc's last, rows' first but one) taken in the paired order."""
    n = acc.shape[-1]
    pad = -(-n // 8) * 8 - n
    acc = torch.nn.functional.pad(acc, (0, pad))
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    perm = _paired(n)
    return mm(acc[..., perm], rows[..., perm, :])


def attention_backward_split(q, k, v, dout, causal, window, mm):
    """The backward kernels' arithmetic, every product through ``mm``:
    dk/dv from the transposed tiles S^T = K Q^T, dP^T = V dO^T, with
    P^T = exp2(S^T scale log2(e) - lse2[query]) and dS^T = P^T (dP^T -
    D[query]) fed back for dV = P^T dO and dK = dS^T Q, the per-head sums
    added per cluster rank (ceil(G / 8) heads a rank, in order) and the
    ranks in order; dq from S = Q K^T, dP = dO V^T and dQ = dS K."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qh, oh = (t.permute(0, 2, 1, 3) for t in (q, dout))   # (B, H, Sq, D)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    out = ref.flash_attention_ref(q, k, v, causal, window)
    lse2 = ref.flash_attention_lse_ref(q, k, causal, window) * LOG2E
    dvec = (dout * out).sum(-1).permute(0, 2, 1)          # (B, H, Sq)
    seen = torch.ones(Sq, Skv, dtype=torch.bool)
    nokey = torch.zeros(Sq, 1, dtype=torch.bool)
    if causal:
        seen = ref.attention_mask(Sq, Skv, window)
        if window:
            nokey = (torch.arange(Sq) >= Skv - 1 + window)[:, None]
    seen = seen & ~nokey

    st = mm(kh, qh.transpose(-1, -2)) * (scale * LOG2E)   # (B, H, Skv, Sq)
    dpt = mm(vh, oh.transpose(-1, -2))
    pt = torch.exp2(st - lse2[:, :, None, :])
    pt = torch.where(nokey.T, torch.full_like(pt, 1.0 / Skv),
                     torch.where(seen.T, pt, torch.zeros_like(pt)))
    dst = torch.where(seen.T, pt * (dpt - dvec[:, :, None, :]),
                      torch.zeros_like(pt))
    dv_h, dk_h = _fed_back(pt, oh, mm), _fed_back(dst, qh, mm)
    per = -(-G // 8)

    def cluster_sum(x):   # (B, H, Skv, D) -> (B, Skv, KV, D)
        x = x.reshape(B, KV, G, Skv, D)
        total = None
        for r0 in range(0, G, per):                   # the ranks, in order
            part = x[:, :, r0]
            for hh in range(r0 + 1, min(G, r0 + per)):   # its heads, in order
                part = part + x[:, :, hh]
            total = part if total is None else total + part
        return total.permute(0, 2, 1, 3)

    dk, dv = cluster_sum(dk_h) * scale, cluster_sum(dv_h)

    s = mm(qh, kh.transpose(-1, -2)) * (scale * LOG2E)    # (B, H, Sq, Skv)
    dp = mm(oh, vh.transpose(-1, -2))
    p = torch.exp2(s - lse2[..., None])
    ds = torch.where(seen, p * (dp - dvec[..., None]), torch.zeros_like(p))
    dq = (_fed_back(ds, kh, mm) * scale).permute(0, 2, 1, 3)
    return dq, dk, dv


# (B, Sq, Skv, H, KV, D, causal, window): the trainer's shape, and a window
# with rows that see no key.
ATTN_BWD_CASES = {
    "trainer B=8 S=128 G=7": (8, 128, 128, 14, 2, 64, True, 0),
    "window 8 Sq=100 Skv=77 G=2": (2, 100, 77, 4, 2, 32, True, 8),
}


def _bwd_inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                          (B, Sq, H, D))]


def _grad_err(got, want) -> float:
    """Worst of (dq, dk, dv): max abs error over the largest |gradient|."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(ATTN_BWD_CASES))
def test_attention_backward_with_split_products_meets_the_bar(case):
    B, Sq, Skv, H, KV, D, causal, window = ATTN_BWD_CASES[case]
    q, k, v, dout = _bwd_inputs(B, Sq, Skv, H, KV, D, seed=Sq + H)
    want = ref.flash_attention_backward_ref(
        *(t.double() for t in (q, k, v, dout)), causal, window)
    err3 = _grad_err(attention_backward_split(q, k, v, dout, causal, window,
                                              mm3), want)
    err1 = _grad_err(attention_backward_split(q, k, v, dout, causal, window,
                                              mm1), want)
    print(f"attention backward {case}: 3xTF32 {err3:.3e}, TF32 {err1:.3e}")
    assert err3 <= BAR
    assert err3 < err1


def test_backward_split_algorithm_in_fp64_is_the_plain_backward():
    """With exact products the backward's algorithm (transposed tiles, fed
    back in the paired order, per-rank sums; G = 16 takes two heads a rank)
    is autograd's backward, so the bar measures the split alone."""
    for B, Sq, Skv, H, KV, D, causal, window in (
            (1, 40, 40, 16, 1, 16, True, 0), (1, 37, 29, 6, 2, 16, True, 4),
            (1, 20, 33, 6, 3, 16, False, 0)):
        q, k, v, dout = (t.double() for t in _bwd_inputs(
            B, Sq, Skv, H, KV, D, seed=Sq))
        got = attention_backward_split(q, k, v, dout, causal, window,
                                       lambda a, b: a @ b)
        want = ref.flash_attention_backward_ref(q, k, v, dout, causal, window)
        assert _grad_err(got, want) <= 1e-6

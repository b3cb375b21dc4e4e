"""CPU replays of the Hopper designs of the two bf16 forward kernels.

``csrc/ssd_scan_bf16.cu`` and ``csrc/flash_attention_bf16.cu`` run only on
the card, so their decompositions are replayed here in torch, block by
block and tile by tile, with the same bf16 rounding points, masks and
ragged edges (fp32 products of bf16-exact operands stand in for the
tensor cores' steps):

- the scan: one block per (head block, batch); the chunks go through a
  ring of two stages zeroed once, each load writing only the chunk's rows
  (so the rows past a short chunk stay zero, which the kernel's whole-tile
  products rely on); C B^T formed once per block and chunk for all heads
  of the block; the update as x^T scaled by dt_s bf16(w_s) and rounded,
  against B; the diagonal block's weights (C B^T) o bf16(L) o dt rounded
  once on top of bf16(e_t) C S'^T; S' the bf16 state;
- attention: the query heads of a KV head folded into a block's 64 rows
  as (query, head in group) pairs in the order TMA's box writes them,
  each row's causal limit and window from its own query; the kernel's
  first and last K/V tile, its mask test per tile; the online softmax in
  base 2; P rounded to bf16 before P V.

Each replay is held, on numpy-seeded bf16 inputs, to the port's plain bf16
version on the bf16 bar (the truth is the fp32 plain version on the same
bf16-exact inputs; the replay within twice the plain bf16 version's error
and within 3e-2 of the largest |truth|) and to the JAX package's function
in bf16 within the 3e-2 of the largest magnitude the reference's tests use
(the scan's final state within 1e-2, as ``tests/test_torch_bf16.py``
holds it): the reference model's scan (``repro.arch.ssm.ssd_scan``), and
its Pallas attention kernel in interpret mode (``flash_attention_kernel``)
or, for a window, its model's ``_sdpa`` with the window's mask. A CPU
test also checks that the model's call sites hand the kernels views that
TMA can read at every configuration's widths.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as JL  # noqa: E402
from repro.arch import ssm as JS  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_kernel  # noqa: E402
from repro_torch.arch import layers as TL  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    MAX_GROUP_BF16  # noqa: E402
from repro_torch.kernels.ssd_scan import MAX_HEAD_DIM_BF16  # noqa: E402

BF16 = torch.bfloat16
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASKED = -1e30
KERNEL_TOL = 3e-2   # the reference's bf16 kernel test
NS = 2              # stages of both kernels' rings


def r16(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 and back (to nearest even)."""
    return t.to(BF16).float()


def bf16_bar(got, plain, truth) -> None:
    truth = truth.float()
    err = float((got.float() - truth).abs().max())
    assert err <= 2 * float((plain.float() - truth).abs().max())
    assert err <= KERNEL_TOL * float(truth.abs().max())


# -- the scan ---------------------------------------------------------------


def replay_ssd_bf16(x, dt, A, B, C, chunk: int, init_state=None,
                    heads_per_block: int = 1):
    """csrc/ssd_scan_bf16.cu block by block: ``(y bf16, final fp32,
    states fp32)``. The kernel runs blocks of one head; a larger
    ``heads_per_block`` (dividing the heads of a group) forms C B^T once
    for more heads."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q, nc, rep = chunk, l // chunk, h // g
    QT = 64 if q <= 64 else 128           # the chunk's row tile
    NW = 64 * (1 if n <= 64 else 2)       # n's column blocks
    assert p <= 64 and rep % heads_per_block == 0
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    y = torch.empty((b, l, h, p), dtype=BF16)
    final = torch.empty((b, h, p, n))
    states = torch.empty((b, nc, h, p, n))
    for bi in range(b):
        for h0 in range(0, h, heads_per_block):
            heads = range(h0, h0 + heads_per_block)
            grp = h0 // rep
            # the ring, zeroed once; a load writes the chunk's q rows only
            ring = [{"c": torch.zeros(QT, NW), "b": torch.zeros(QT, NW),
                     "x": {hh: torch.zeros(QT, 64) for hh in heads}}
                    for _ in range(NS)]
            free = [True] * NS
            S, Sp = {}, {}
            for hh in heads:
                S[hh] = torch.zeros(64, NW)    # rows p, columns n
                if init_state is not None:
                    S[hh][:p, :n] = init_state[bi, hh].float()
                Sp[hh] = r16(S[hh])
            for c in range(nc):
                slot = ring[c % NS]
                assert free[c % NS]
                free[c % NS] = False
                rows = slice(c * q, (c + 1) * q)
                slot["c"][:q, :n] = Cf[bi, rows, grp]
                slot["b"][:q, :n] = Bf[bi, rows, grp]
                for hh in heads:
                    slot["x"][hh][:q, :p] = xf[bi, rows, hh]
                for tile in (slot["c"], slot["b"], *slot["x"].values()):
                    assert not tile[q:].any()   # zero past the chunk
                sc = slot["c"] @ slot["b"].T    # once for the block's heads
                for hh in heads:
                    # the producer: dt, cum (log2 e units), wdt
                    d = torch.zeros(QT)
                    d[:q] = dtf[bi, rows, hh]
                    cum = torch.cumsum(d * A[hh], 0)
                    cum_end = cum[q - 1]
                    cl = cum * LOG2E
                    wdt = torch.where(torch.arange(QT) < q,
                                      r16(torch.exp2((cum_end - cum) * LOG2E))
                                      * d, torch.zeros(()))
                    states[bi, c, hh] = S[hh][:p, :n]
                    # 1. the update's A operand, (wdt o x)^T rounded
                    ua = r16(wdt[:, None] * slot["x"][hh])
                    # 2. C S'^T with C B^T
                    ya = slot["c"] @ Sp[hh].T
                    # 3. the update against B
                    S[hh] = S[hh] * torch.exp2(cum_end * LOG2E) + \
                        ua.T @ slot["b"]
                    # 4. the diagonal block on top of e_t C S'^T
                    ya = ya * r16(torch.exp2(cl))[:, None]
                    L = r16(torch.exp2(cl[:, None] - cl[None, :]))
                    w = (sc * d[None, :] * L).tril()
                    ya = ya + r16(w) @ slot["x"][hh]
                    # 5. y, and S' of the next chunk
                    y[bi, rows, hh] = ya[:q, :p].to(BF16)
                    Sp[hh] = r16(S[hh])
                free[c % NS] = True   # every consumer is done with the stage
            for hh in heads:
                final[bi, hh] = S[hh][:p, :n]
    return y, final, states


def _ssd_inputs(b, l, h, p, g, n, seed=0, with_state=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p))).to(BF16)
    dt = torch.from_numpy(np.abs(rng.standard_normal((b, l, h))) * 0.3)
    dt = dt.to(BF16)
    A = torch.from_numpy(-np.abs(rng.standard_normal(h)) * 0.5).float()
    B = torch.from_numpy(rng.standard_normal((b, l, g, n))).to(BF16)
    C = torch.from_numpy(rng.standard_normal((b, l, g, n))).to(BF16)
    s0 = (torch.from_numpy(rng.standard_normal((b, h, p, n))).float()
          if with_state else None)
    return x, dt, A, B, C, s0


# (b, l, h, p, groups, n, chunk, from a state): the Mamba2-130m wave's
# prefills at full width, the reduced model's, and chip_smoke.py phase 2's
# edge cases (groups, short and ragged chunks, p and n under a block)
SSD_CASES = {
    "path l=256 b=3": (3, 256, 24, 64, 1, 128, 128, False),
    "path l=128 b=3, init state": (3, 128, 24, 64, 1, 128, 128, True),
    "reduced model": (2, 32, 16, 16, 1, 16, 16, False),
    "groups 2, chunk 16": (2, 64, 8, 16, 2, 16, 16, False),
    "ragged p=24 n=40 chunk 32": (1, 96, 4, 24, 1, 40, 32, False),
    "chunk 8 n=16 p=24 groups 2": (2, 24, 4, 24, 2, 16, 8, False),
    "chunk 24 n=40 p=64": (2, 72, 4, 64, 1, 40, 24, False),
    "chunk 24 n=128 p=24 groups 2": (1, 48, 4, 24, 2, 128, 24, False),
    "chunk 40 n=8 p=8": (1, 120, 3, 8, 1, 8, 40, False),
    "init state, ragged p=24 n=40 chunk 24": (2, 48, 4, 24, 2, 40, 24, True),
    "chunk 96 n=64 p=64, init state": (1, 192, 2, 64, 1, 64, 96, True),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_replay_on_the_bf16_bar(case):
    b, l, h, p, g, n, chunk, from_state = SSD_CASES[case]
    x, dt, A, B, C, s0 = _ssd_inputs(b, l, h, p, g, n, 3, from_state)
    y, final, states = replay_ssd_bf16(x, dt, A, B, C, chunk, s0)
    up = [t.float() for t in (x, dt, B, C)]
    y_t, final_t = ref.ssd_scan_ref(up[0], up[1], A, up[2], up[3], chunk, s0)
    y_p, final_p = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
    assert y.dtype == BF16
    bf16_bar(y, y_p, y_t)
    bf16_bar(final, final_p, final_t)
    states_t = ref.ssd_chunk_states(up[0], up[1], A, up[2], chunk, s0)
    assert float((states - states_t).abs().max()) <= \
        KERNEL_TOL * float(states_t.abs().max())


@pytest.mark.parametrize("case", ["path l=256 b=3", "reduced model",
                                  "groups 2, chunk 16",
                                  "init state, ragged p=24 n=40 chunk 24",
                                  "chunk 40 n=8 p=8"])
def test_ssd_replay_against_the_references_scan(case):
    """The reference model's scan in bf16 (plain jnp in the model's
    dtype) on the same inputs: y within 3e-2 and the fp32 final state
    within 1e-2 of their largest magnitudes."""
    b, l, h, p, g, n, chunk, from_state = SSD_CASES[case]
    x, dt, A, B, C, s0 = _ssd_inputs(b, l, h, p, g, n, 4, from_state)
    s16 = None if s0 is None else s0.to(BF16)
    y, final, _ = replay_ssd_bf16(x, dt, A, B, C, chunk, s16)

    def j16(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    jy, jf = JS.ssd_scan(j16(x), j16(dt), jnp.asarray(A.numpy()), j16(B),
                         j16(C), chunk, None if s16 is None else j16(s16))
    jy = np.asarray(jy, dtype=np.float32)
    jf = np.asarray(jf, dtype=np.float32)
    assert np.abs(y.float().numpy() - jy).max() <= \
        KERNEL_TOL * np.abs(jy).max()
    assert np.abs(final.numpy() - jf).max() <= 1e-2 * np.abs(jf).max()


def test_ssd_replay_head_blocks_share_the_scores():
    """C B^T does not depend on the head: forming it once for every head
    of a group gives the blocks of one head their outputs bit for bit."""
    x, dt, A, B, C, s0 = _ssd_inputs(2, 64, 8, 16, 2, 40, 5, True)
    one = replay_ssd_bf16(x, dt, A, B, C, 32, s0, heads_per_block=1)
    group = replay_ssd_bf16(x, dt, A, B, C, 32, s0, heads_per_block=4)
    for a, b in zip(one, group):
        assert torch.equal(a, b)


# -- attention ---------------------------------------------------------------


def fold_rows(G: int, i_first: int):
    """The rows of a block (64, of which G * (64 // G) in use): each row's
    query and head in group, r = (i - i_first) G + hg."""
    r = torch.arange(64)
    return i_first + r // G, r % G, r < G * (64 // G)


def replay_flash_bf16(q, k, v, causal: bool = True, window: int = 0):
    """csrc/flash_attention_bf16.cu block by block: ``(out bf16, lse)``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, BK = H // KV, 64
    QB = 64 // G
    scale_log2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((B, Sq, H, D), dtype=BF16)
    lse = torch.empty((B, H, Sq))
    cols = torch.arange(BK)
    for b in range(B):
        for kvh in range(KV):
            for mt in range(-(-Sq // QB)):
                i_first = mt * QB
                i_last = min(i_first + QB, Sq) - 1
                # TMA's box: 64 values of D by the G heads by QB queries,
                # innermost first, zeros past Sq, as the tile's first rows
                box = torch.zeros(QB, G, D)
                nq = min(QB, Sq - i_first)
                box[:nq] = qf[b, i_first:i_first + nq, kvh * G:(kvh + 1) * G]
                Qt = torch.zeros(64, D)
                Qt[:QB * G] = box.reshape(QB * G, D)
                qi, hg, used = fold_rows(G, i_first)   # each row's query
                live = used & (qi < Sq)
                lo, hi = 0, Skv
                if causal:
                    hi = min(i_last + 1, Skv)
                    if window > 0 and i_last < Skv - 1 + window:
                        first = i_first - window + 1
                        lo = first // BK * BK if first > 0 else 0
                ntiles = -(-(hi - lo) // BK) if lo < hi else 0
                m = torch.full((64,), MASKED)
                s_sum = torch.zeros(64)
                acc = torch.zeros(64, D)
                for it in range(ntiles):
                    j0 = lo + it * BK
                    keys = slice(j0, min(j0 + BK, Skv))
                    nk = keys.stop - keys.start
                    Kt, Vt = torch.zeros(BK, D), torch.zeros(BK, D)
                    Kt[:nk], Vt[:nk] = kf[b, keys, kvh], vf[b, keys, kvh]
                    s = (Qt @ Kt.T) * scale_log2
                    need_mask = j0 + BK > Skv or (causal and (
                        j0 + BK - 1 > i_first or
                        (window > 0 and i_last - j0 >= window)))
                    if need_mask:
                        d = (qi - j0)[:, None]
                        masked = torch.zeros(64, BK, dtype=torch.bool)
                        if causal:
                            masked = cols[None, :] > d
                            if window > 0:
                                masked |= cols[None, :] < d - window + 1
                        s = torch.where(masked, torch.tensor(MASKED), s)
                        s = torch.where(cols[None, :] >= nk,
                                        torch.tensor(-math.inf), s)
                    mx = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp2(m - mx)
                    m = mx
                    pm = torch.exp2(s - mx[:, None])
                    s_sum = s_sum * alpha + pm.sum(1)
                    acc = acc * alpha[:, None] + r16(pm) @ Vt
                o = acc / torch.clamp(s_sum, min=1e-30)[:, None]
                heads = kvh * G + hg[live]
                out[b, qi[live], heads] = o[live].to(BF16)
                row_lse = torch.where(
                    m <= MASKED, torch.tensor(MASKED),
                    (m + torch.log2(s_sum)) * LN2)
                lse[b, heads, qi[live]] = row_lse[live]
    return out, lse


def _attn_inputs(B, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)).to(BF16)
            for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


# (B, Sq, Skv, H, KV, D, causal, window): the Qwen2-0.5B wave's prefills
# at full width, the reduced model's, the vision model's cross shape and
# chip_smoke.py phase 2's and the card tests' edge cases
ATTN_CASES = {
    "path S=96 B=4": (4, 96, 96, 14, 2, 64, True, 0),
    "path S=32 B=2": (2, 32, 32, 14, 2, 64, True, 0),
    "reduced model": (2, 24, 24, 4, 2, 32, True, 0),
    "vision cross": (2, 64, 1024, 32, 8, 128, False, 0),
    "ragged S=37": (3, 37, 37, 14, 2, 64, True, 0),
    "window 5 S=71": (1, 71, 71, 4, 2, 32, True, 5),
    "window 40 S=150 G=7": (1, 150, 150, 7, 1, 64, True, 40),
    "cross Sq=9 Skv=133 D=128": (2, 9, 133, 8, 2, 128, False, 0),
    "Sq=3 Skv=5 D=16 G=3": (2, 3, 5, 3, 1, 16, True, 0),
    "G=1 D=128 S=200": (1, 200, 200, 2, 2, 128, True, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_replay_on_the_bf16_bar(case):
    B, Sq, Skv, H, KV, D, causal, window = ATTN_CASES[case]
    q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, 7)
    out, lse = replay_flash_bf16(q, k, v, causal, window)
    up = [t.float() for t in (q, k, v)]
    truth = ref.flash_attention_ref(*up, causal, window)
    bf16_bar(out, ref.flash_attention_ref(q, k, v, causal, window), truth)
    lse_t = ref.flash_attention_lse_ref(up[0], up[1], causal, window)
    assert float((lse - lse_t).abs().max()) <= \
        1e-4 * float(lse_t.abs().max())


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_replay_against_the_reference(case):
    """The reference's Pallas kernel in interpret mode (one head per
    batch row, K/V of the head's KV head), as ``tests/test_torch_bf16.py``
    runs it; a window through its model's ``_sdpa`` with the window's
    causal mask (the kernel has no window): within 3e-2."""
    B, Sq, Skv, H, KV, D, causal, window = ATTN_CASES[case]
    q, k, v = _attn_inputs(B, Sq, Skv, H, KV, D, 8)
    out, _ = replay_flash_bf16(q, k, v, causal, window)

    def j16(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    if window:
        want = JL._sdpa(j16(q), j16(k), j16(v), JL.causal_mask(Sq, window),
                        jnp.bfloat16).reshape(B, Sq, H, D)
    else:
        G = H // KV
        heads = lambda t: t.permute(0, 2, 1, 3).reshape(-1, *t.shape[1::2])
        kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
        # one block over each sequence: every length here divides itself
        want = flash_attention_kernel(
            j16(heads(q)), j16(heads(kx)), j16(heads(vx)), causal=causal,
            block_q=Sq, block_k=Skv, interpret=True)
        want = jnp.transpose(want.reshape(B, H, Sq, D), (0, 2, 1, 3))
    want = np.asarray(want, dtype=np.float32)
    assert np.abs(out.float().numpy() - want).max() <= \
        KERNEL_TOL * np.abs(want).max()


@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 14, 64])
def test_flash_row_fold_takes_each_query_and_head_once(G):
    """Over a sequence's row tiles the folded rows in use meet every
    (query, head in group) pair exactly once, at most 64 rows a block."""
    Sq = 3 * (64 // G) + 1
    seen = []
    for mt in range(-(-Sq // (64 // G))):
        qi, hg, used = fold_rows(G, mt * (64 // G))
        live = used & (qi < Sq)
        seen += list(zip(qi[live].tolist(), hg[live].tolist()))
    assert sorted(seen) == [(i, h) for i in range(Sq) for h in range(G)]


# -- the call sites ------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_call_sites_hand_the_bf16_kernels_views_tma_can_read(name):
    """At every configuration's widths the SSD scan's x, B and C (slices of
    the packed projection, ``arch/ssm.py:ssm_block``) and attention's q, k
    and v (``arch/layers.py:self_attention``, ``cross_attention``) start on
    16 bytes with strides in multiples of 16 bytes, and fit the bf16
    kernels' limits (head dim, query heads per KV head). Built on the meta
    device from the call sites' own splits."""
    cfg = get_config(name)
    Bt, L = 2, 16
    if cfg.ssm_state:
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
        xbc = torch.empty((Bt, L, di + 2 * g * n), dtype=BF16,
                          device="meta")
        xin, Bv, Cv = torch.split(xbc, [di, g * n, g * n], dim=-1)
        views = (xin.reshape(Bt, L, nh, hd), Bv.reshape(Bt, L, g, n),
                 Cv.reshape(Bt, L, g, n))
        for t in views:
            assert t.storage_offset() * 2 % 16 == 0
            assert not any(s % 8 for s in t.stride()[:3])
        assert hd <= MAX_HEAD_DIM_BF16
    p = {"wq": torch.empty((cfg.d_model, cfg.n_heads * cfg.d_head),
                           dtype=BF16, device="meta"),
         "wk": torch.empty((cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                           dtype=BF16, device="meta"),
         "wv": torch.empty((cfg.d_model, cfg.n_kv_heads * cfg.d_head),
                           dtype=BF16, device="meta")}
    x = torch.empty((Bt, L, cfg.d_model), dtype=BF16, device="meta")
    q, k, v = TL._project_qkv(p, x, x, cfg)
    positions = torch.arange(L, device="meta")
    q = TL.apply_rope(q, positions, cfg.rope_theta)
    k = TL.apply_rope(k, positions, cfg.rope_theta)
    for t in (q, k, v):
        assert t.stride(3) == 1 and t.storage_offset() * 2 % 16 == 0
        assert not any(s % 8 for s in t.stride()[:3])
    assert cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP_BF16

"""The port's kernel modules against the JAX package: the plain versions
that the wrappers run for CPU tensors match the JAX oracles and the Pallas
kernels in interpret mode. The CUDA kernels themselves are tested on the
card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as jlayers  # noqa: E402
from repro.arch import ssm as jssm  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_gather_cell import \
    fused_gather_lstm_cell_kernel  # noqa: E402
from repro.kernels.gather_batch import gather_rows_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_gather_cell import \
    fused_gather_lstm_cell  # noqa: E402
from repro_torch.kernels.gather_batch import gather_rows  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402


@pytest.mark.parametrize("n,row,k", [
    (8, (16,), 5),
    (32, (32,), 16),
    (20, (4, 8), 9),            # 3-D rows gather flattened
    (12, (17,), 30),            # ragged width, K > N
])
def test_gather_plain_bit_equal_to_jax(n, row, k):
    rng = np.random.default_rng(k)
    src = rng.standard_normal((n,) + row).astype(np.float32)
    idx = rng.integers(0, n, k).astype(np.int32)
    idx[: k // 3] = idx[0]      # duplicate indices
    got = gather_rows(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.gather_rows_ref(jnp.asarray(src), jnp.asarray(idx))))
    D = int(np.prod(row))
    pallas = gather_rows_kernel(jnp.asarray(src.reshape(n, D)),
                                jnp.asarray(idx), block_d=D, interpret=True)
    np.testing.assert_array_equal(got.reshape(k, D), np.asarray(pallas))


def _fused_inputs(rng, B, E, H, nx, nh):
    x_src = rng.standard_normal((nx, E)).astype(np.float32)
    h_src = rng.standard_normal((nh, H)).astype(np.float32)
    c_src = rng.standard_normal((nh, H)).astype(np.float32)
    ix = rng.integers(0, nx, B).astype(np.int32)
    ih = rng.integers(0, nh, B).astype(np.int32)
    ic = rng.integers(0, nh, B).astype(np.int32)
    w = (0.1 * rng.standard_normal((E + H, 4 * H))).astype(np.float32)
    b = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
    return [x_src, h_src, c_src, ix, ih, ic, w, b]


def _assert_fused_matches(args):
    h2, c2 = fused_gather_lstm_cell(*[torch.from_numpy(a) for a in args])
    jargs = [jnp.asarray(a) for a in args]
    for want in (jref.fused_gather_lstm_cell_ref(*jargs),
                 fused_gather_lstm_cell_kernel(*jargs, interpret=True)):
        np.testing.assert_allclose(h2.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c2.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,E,H", [(4, 8, 16), (7, 16, 16), (16, 32, 8)])
def test_fused_plain_matches_jax(B, E, H):
    rng = np.random.default_rng(B)
    _assert_fused_matches(_fused_inputs(rng, B, E, H, 3 * B, 2 * B))


def test_fused_plain_duplicate_and_pad_lanes():
    """Duplicate indices (broadcast-as-gather and replicated pad lanes), as
    the bucketed executor produces them."""
    rng = np.random.default_rng(0)
    args = _fused_inputs(rng, 6, 8, 8, 4, 4)
    args[3] = np.asarray([0, 0, 0, 3, 3, 3], np.int32)
    args[4] = np.asarray([1, 1, 2, 2, 3, 3], np.int32)
    args[5] = np.asarray([0, 1, 2, 3, 3, 3], np.int32)
    args[7] = np.zeros_like(args[7])
    _assert_fused_matches(args)


def _launch_counts():
    return (gather_rows.launches, fused_gather_lstm_cell.launches,
            flash_attention.launches, ssd_scan.launches)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = _launch_counts()
    src = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    assert torch.equal(gather_rows(src, idx), ref.gather_rows_ref(src, idx))
    args = [torch.from_numpy(a) for a in
            _fused_inputs(np.random.default_rng(1), 3, 4, 4, 5, 5)]
    fused_gather_lstm_cell(*args)
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    assert torch.equal(flash_attention(q, k, k),
                       ref.flash_attention_ref(q, k, k))
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(2), 1, 16, 2, 4, 1, 4)
    y, final = ssd_scan(x, dt, A, B, C, 8)
    y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, 8)
    assert torch.equal(y, y_ref) and torch.equal(final, final_ref)
    assert _launch_counts() == before


def test_other_devices_raise_instead_of_falling_back(monkeypatch):
    # The plain versions run on the CPU and the meta device alone
    # (``ref.PLAIN_DEVICES``; the dry-run traces on meta). A device outside
    # them and outside CUDA must raise: taken out of the plain devices
    # here, meta stands for such a device, the only other one this build
    # of torch can make.
    monkeypatch.setattr(ref, "PLAIN_DEVICES", ("cpu",))
    src = torch.empty((4, 3), device="meta")
    idx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(src, idx)
    h = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gather_lstm_cell(h, h, h, idx, idx, idx,
                               torch.empty((8, 16), device="meta"),
                               torch.empty((16,), device="meta"))
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    x = torch.empty((1, 8, 2, 4), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    BC = torch.empty((1, 8, 1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(x, dt, torch.empty((2,), device="meta"), BC, BC, 8)


# -- flash attention ---------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("bh,sq,skv,d,bq,bk", [
    (1, 32, 32, 16, 16, 16),
    (4, 64, 64, 32, 32, 32),
    (2, 128, 128, 64, 64, 32),
    (3, 48, 48, 8, 16, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(bh, sq, skv, d, bq, bk, causal):
    """The shapes of the reference's own kernel tests; one head per batch
    row maps its (BH, S, D) layout onto the port's (B, S, H, D)."""
    rng = np.random.default_rng(sq + d)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    got = flash_attention(_t(q)[:, :, None], _t(k)[:, :, None],
                          _t(v)[:, :, None], causal=causal)[:, :, 0].numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                 block_k=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 16, 6, 2, 8, 0),       # GQA, G = 3
    (1, 13, 4, 1, 16, 0),      # ragged S, one KV head
    (2, 21, 4, 2, 8, 5),       # sliding window
    (1, 9, 2, 2, 16, 1),       # window of one: attends to itself only
])
def test_flash_attention_plain_matches_jax_sdpa(B, S, H, KV, D, window):
    rng = np.random.default_rng(S * H)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), window=window).numpy()
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jlayers.causal_mask(S, window), jnp.float32)
    np.testing.assert_allclose(got.reshape(B, S, H * D), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_plain_cross_attention_matches_jax_sdpa():
    """Non-causal with Sq != Skv, as cross-attention calls it."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    got = flash_attention(_t(q), _t(kv), _t(kv) * 2, causal=False).numpy()
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(kv),
                         jnp.asarray(kv) * 2, None, jnp.float32)
    np.testing.assert_allclose(got.reshape(2, 5, 32), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# -- SSD scan ----------------------------------------------------------------


def _ssd_inputs(rng, b, l, h, p, g, n):
    arrays = [rng.standard_normal((b, l, h, p)),
              np.abs(rng.standard_normal((b, l, h))) * 0.5,
              -np.abs(rng.standard_normal(h)) * 0.5,
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, l, g, n))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("b,l,h,p,n,chunk,g", [
    (1, 16, 2, 8, 8, 8, 1),
    (2, 32, 4, 8, 16, 8, 2),
    (2, 64, 8, 16, 16, 16, 4),
])
def test_ssd_plain_matches_pallas_and_arch_scan(b, l, h, p, n, chunk, g):
    """The shapes of the reference's own scan tests, with groups: y against
    the Pallas kernel in interpret mode (which takes heads expanded), y and
    the final state against ``repro.arch.ssm.ssd_scan`` and against the
    sequential recurrence."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(l + h), b, l, h, p,
                                 g, n)
    y, final = ssd_scan(x, dt, A, B, C, chunk)
    jx, jdt, jA, jB, jC = (jnp.asarray(t.numpy()) for t in (x, dt, A, B, C))
    Bh, Ch = (jnp.repeat(t, h // g, axis=2) for t in (jB, jC))
    pallas = ops.ssd_scan(jx, jdt, jA, Bh, Ch, chunk=chunk, block_h=2,
                          interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), rtol=5e-4,
                               atol=5e-4)
    y_arch, final_arch = jssm.ssd_scan(jx, jdt, jA, jB, jC, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_arch), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_arch),
                               rtol=5e-4, atol=5e-4)
    y_seq, final_seq = ref.ssd_scan_seq_ref(
        x, dt, A, B.repeat_interleave(h // g, dim=2),
        C.repeat_interleave(h // g, dim=2))
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(final.numpy(), final_seq.numpy(), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(
        y_seq.numpy(), np.asarray(jref.ssd_scan_ref(jx, jdt, jA, Bh, Ch)),
        rtol=5e-4, atol=5e-4)


def test_ssd_plain_carries_an_initial_state():
    """With ``init_state`` the scan continues a state: two halves equal
    one whole (the card's kernel takes it too: ``test_torch_cuda.py``)."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(9), 2, 32, 4, 8, 2, 8)
    y, final = ssd_scan(x, dt, A, B, C, 8)
    y1, s1 = ssd_scan(x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16], 8)
    y2, s2 = ssd_scan(x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:], 8,
                      init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), final.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ssd_plain_never_exponentiates_above_the_diagonal():
    """Large steps make cum_i - cum_j very positive for i < j; the plain
    chunked scan stays finite, as the kernel does by construction."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(4), 1, 16, 2, 4, 1, 4)
    y, final = ssd_scan(x, dt * 400.0, A, B, C, 16)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()

"""The port's kernel modules against the JAX package: the plain versions
that the wrappers run for CPU tensors match the JAX oracles and the Pallas
kernels in interpret mode. The CUDA kernels themselves are tested on the
card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_gather_cell import \
    fused_gather_lstm_cell_kernel  # noqa: E402
from repro.kernels.gather_batch import gather_rows_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_gather_cell import \
    fused_gather_lstm_cell  # noqa: E402
from repro_torch.kernels.gather_batch import gather_rows  # noqa: E402


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


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = (gather_rows.launches, fused_gather_lstm_cell.launches)
    src = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    assert torch.equal(gather_rows(src, idx), ref.gather_rows_ref(src, idx))
    args = [torch.from_numpy(a) for a in
            _fused_inputs(np.random.default_rng(1), 3, 4, 4, 5, 5)]
    fused_gather_lstm_cell(*args)
    assert (gather_rows.launches, fused_gather_lstm_cell.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    src = torch.empty((4, 3), device="meta")
    idx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(src, idx)
    h = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gather_lstm_cell(h, h, h, idx, idx, idx,
                               torch.empty((8, 16), device="meta"),
                               torch.empty((16,), device="meta"))

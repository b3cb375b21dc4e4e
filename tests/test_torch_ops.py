"""Port parity for ``core/ops.py`` and ``core/subgraph.py``: every op of the
registry and every cell program against the JAX package on the same numpy
inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.subgraph import CompiledCell as JCompiledCell  # noqa: E402
from repro.models import cells as jcells  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.subgraph import CompiledCell  # noqa: E402
from repro_torch.models import cells as tcells  # noqa: E402

B, K = 3, 2
# op -> operand shapes: (B, k, *elem) instance operands, (k, *elem) params.
OP_CASES = {
    "affine": [(B, K, 4), (K, 4, 5), (K, 5)],
    "matmul": [(B, K, 4), (K, 4, 5)],
    "matvec": [(B, K, 4, 4), (B, K, 4)],
    "add": [(B, K, 4), (K, 4)],
    "sub": [(B, K, 4), (B, K, 4)],
    "mul": [(K, 4), (B, K, 4)],
    "tanh": [(B, K, 4)],
    "sigmoid": [(B, K, 4)],
    "relu": [(B, K, 4)],
    "concat2": [(B, K, 4), (B, K, 3)],
    "addmul": [(B, K, 4)] * 4,
    "lerp": [(B, K, 4)] * 3,
    "matmat": [(K, 4, 4), (B, K, 4, 5)],
}


def test_registry_matches():
    assert set(tops.OPS) == set(jops.OPS) == set(OP_CASES)
    for name, op in tops.OPS.items():
        assert op.arity == jops.OPS[name].arity


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_jax(name):
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in OP_CASES[name]]
    want = np.asarray(jops.OPS[name].fn(*[jnp.asarray(x) for x in xs]))
    got = tops.OPS[name].fn(*[torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


CELL_BUILDERS = sorted(tcells.CELLS) + ["LatticeCharLSTM", "LatticeCharGRU"]


def _program(module, name, e=6, h=4):
    if name == "LatticeCharLSTM":
        return module.lattice_char_lstm(e, h)
    if name == "LatticeCharGRU":
        return module.lattice_char_gru(e, h)
    return module.CELLS[name](e, h)


@pytest.mark.parametrize("layout", ["planned", "declaration"])
@pytest.mark.parametrize("name", CELL_BUILDERS)
def test_cell_plan_identical(name, layout):
    jc = JCompiledCell(_program(jcells, name), layout)
    tc = CompiledCell(_program(tcells, name), layout)
    assert tc.var_order == jc.var_order
    assert tc.offsets == jc.offsets
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(jc.stats)
    assert ([dataclasses.asdict(b) for b in tc.batch_plans]
            == [dataclasses.asdict(b) for b in jc.batch_plans])
    assert tc.zero_copy_fraction() == jc.zero_copy_fraction()


@pytest.mark.parametrize("name", CELL_BUILDERS)
def test_cell_apply_matches_jax(name):
    jc = JCompiledCell(_program(jcells, name), "planned")
    tc = CompiledCell(_program(tcells, name), "planned")
    jbuf = jc.init_params(np.random.default_rng(1))
    tbuf = tc.init_params(np.random.default_rng(1), device="cpu")
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    rng = np.random.default_rng(2)
    inputs = {n: rng.standard_normal((5,) + tc.prog.vars[n].shape)
              .astype(np.float32) for n in tc.prog.inputs}
    jin = {n: jnp.asarray(x) for n, x in inputs.items()}
    tin = {n: torch.from_numpy(x) for n, x in inputs.items()}
    for want, got in ((jc.apply(jbuf, jin), tc.apply(tbuf, tin)),
                      (jc.reference_apply(jbuf, jin),
                       tc.reference_apply(tbuf, tin))):
        assert want.keys() == got.keys()
        for f in want:
            np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                       rtol=1e-5, atol=1e-5, err_msg=f)

"""The port's launch analysis helpers against the reference's, on the same
configurations: the production meshes, the ``Partitioner``'s partition
specs (every configuration, both meshes, plain / fsdp / no_tp), the
models' ``param_specs`` / ``cache_specs`` shapes against
``jax.eval_shape``, the parameter and model-FLOP counts, the roofline
terms with the H100 constants, and the Markdown report.

The reference's ``Partitioner`` reads only a mesh's ``shape`` and
``axis_names``, so a stub mesh serves it at production size without 256
devices."""

import os
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.arch.model import TransformerLM as RefLM  # noqa: E402
from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro_torch.arch.model import TransformerLM, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, mesh, report, roofline  # noqa: E402
from repro_torch.launch.sharding import (P, Partitioner,  # noqa: E402
                                         Sharding)
from repro_torch.train.optimizer import leaves  # noqa: E402


def _reference_dryrun():
    """``repro.launch.dryrun`` without the 512 host devices its import asks
    for (``XLA_FLAGS`` restored)."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref_dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


REF_DRYRUN = _reference_dryrun()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"plain": {}, "fsdp": {"fsdp": True}, "no_tp": {"no_tp": True}}


def _stub_mesh(name):
    sizes, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)),
                                 axis_names=axes)


def _plain(tree):
    """A spec tree as nested dicts / tuples / lists with each spec as
    ``("spec", tuple(spec))``, for either package."""
    if isinstance(tree, (P, jax.sharding.PartitionSpec)):
        return ("spec", tuple(tree))
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_plain(v) for v in tree)
    raise TypeError(type(tree))


_REF_TREES: dict = {}


def _ref_params(arch):
    if arch not in _REF_TREES:
        _REF_TREES[arch] = RefLM(ref_config(arch)).param_specs()
    return _REF_TREES[arch]


def _partitioners(arch, mesh_name, variant, cfg_ref=None, cfg=None):
    kw = dict(VARIANTS[variant])
    no_tp = kw.pop("no_tp", False)
    ref = ref_sharding.Partitioner(_stub_mesh(mesh_name),
                                   cfg_ref or ref_config(arch), **kw)
    port = Partitioner(mesh.device_mesh(*MESHES[mesh_name]),
                       cfg or get_config(arch), **kw)
    ref.no_tp = port.no_tp = no_tp
    return ref, port


def test_production_meshes():
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert single.devices.shape == (16, 16)
    assert single.axis_names == ("data", "model")
    assert list(single.shape.items()) == [("data", 16), ("model", 16)]
    assert multi.devices.shape == (2, 16, 16)
    assert multi.axis_names == ("pod", "data", "model")
    assert sorted(multi.devices.flatten().tolist()) == list(range(512))
    for name in MESHES:
        port, stub = mesh.device_mesh(*MESHES[name]), _stub_mesh(name)
        for fn in ("batch_axes", "model_axis_size", "data_parallel_size"):
            assert getattr(mesh, fn)(port) == getattr(ref_mesh, fn)(stub)


def test_partition_spec_canonical_form():
    J = jax.sharding.PartitionSpec
    for parts in [(), ("model", None), (("data",), None),
                  (("pod", "data"), None), ((),), (None, None, ("data",
                                                              "model"))]:
        assert tuple(P(*parts)) == tuple(J(*parts))
    assert P("model", None) == ("model", None)


def test_shard_shape():
    m = mesh.make_production_mesh(multi_pod=True)
    assert Sharding(m, P(("pod", "data"), None, "model")).shard_shape(
        (64, 3, 32)) == (2, 3, 2)
    assert Sharding(m, P()).shard_shape((5, 7)) == (5, 7)
    assert Sharding(m, P(None, ("data", "model"))).shard_shape(
        (1, 1000)) == (1, 4)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioner_specs_equal_the_reference(arch, mesh_name, variant):
    ref, port = _partitioners(arch, mesh_name, variant)
    rtree = _ref_params(arch)
    ptree = TransformerLM(get_config(arch), device="cpu").param_specs()
    assert _plain(port.param_specs(ptree)) == _plain(ref.param_specs(rtree))
    assert _plain(port.opt_specs(ptree)) == _plain(ref.opt_specs(rtree))
    for rblock, pblock in zip(rtree["blocks"], ptree["blocks"]):
        rone = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype), rblock)
        pone = tree_map(lambda t: t[0], pblock)
        assert _plain(port.block_specs(pone)) == \
            _plain(ref.block_specs(rone))
    for shape, info in dryrun.SHAPES.items():
        B = info["batch"]
        assert tuple(port.token_spec(B)) == tuple(ref.token_spec(B))
        assert tuple(P(port.batch_spec(B))) == \
            tuple(jax.sharding.PartitionSpec(ref.batch_spec(B)))
        cfg_ref, _ = REF_DRYRUN.resolve_config(arch, shape)
        cfg, _ = dryrun.resolve_config(arch, shape)
        ref_c, port_c = _partitioners(arch, mesh_name, variant, cfg_ref, cfg)
        rcache = RefLM(cfg_ref).cache_specs(B, info["seq"])
        pcache = TransformerLM(cfg, device="cpu").cache_specs(B, info["seq"])
        assert _plain(port_c.cache_specs(pcache, B)) == \
            _plain(ref_c.cache_specs(rcache, B))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_shapes_equal_eval_shape(arch):
    ref = RefLM(ref_config(arch))
    model = TransformerLM(get_config(arch), device="cpu")
    got = leaves(model.param_specs())
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in got)
    assert [tuple(t.shape) for t in got] == \
        [tuple(s.shape) for s in jax.tree.leaves(_ref_params(arch))]
    for B, S in ((2, 64), (3, 40)):
        got = leaves(model.cache_specs(B, S))
        want = jax.tree.leaves(ref.cache_specs(B, S))
        assert all(t.device.type == "meta" for t in got)
        assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]


@pytest.mark.parametrize("shape", list(dryrun.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch, shape):
    cfg_ref, _ = REF_DRYRUN.resolve_config(arch, shape)
    cfg, _ = dryrun.resolve_config(arch, shape)
    rtree = RefLM(cfg_ref).param_specs()
    ptree = TransformerLM(cfg, device="cpu").param_specs()
    assert roofline.count_params(ptree) == ref_roofline.count_params(rtree)
    assert roofline.count_active_params(ptree, cfg) == \
        ref_roofline.count_active_params(rtree, cfg_ref)
    info = dryrun.SHAPES[shape]
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    assert roofline.model_flops(cfg, ptree, shape, tokens) == \
        ref_roofline.model_flops(cfg_ref, rtree, shape, tokens)


def test_roofline_terms_use_the_h100_peaks():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)
    assert (roofline.PEAK_TF32, roofline.LINK_BW) == (495e12, 450e9)
    assert roofline.PEAK_3XTF32 == pytest.approx(165e12)
    rl = roofline.Roofline(arch="a", shape="s", mesh="16x16", chips=256,
                           hlo_flops=6.7e12, hlo_bytes=6.7e9,
                           model_flops=6.7e12 * 128, bytes_per_device=8.0)
    assert rl.t_compute == pytest.approx(0.1)       # 6.7e12 / 67e12
    assert rl.t_memory == pytest.approx(0.002)      # 6.7e9 / 3.35e12
    assert rl.t_collective is None
    assert rl.dominant == "compute"
    assert rl.useful_ratio == pytest.approx(0.5)
    row = rl.row()
    assert row["t_collective_s"] is None
    assert list(row) == list(ref_roofline.Roofline(
        arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=1.0,
        hlo_bytes=1.0, coll_bytes=1.0).row())
    rl.coll_bytes = 90e9                            # 90e9 / 450e9 = 0.2 s
    assert rl.t_collective == pytest.approx(0.2)
    assert rl.dominant == "collective"
    rl.hlo_bytes = 3.35e12                          # 1 s
    assert rl.dominant == "memory"


ROWS = [
    {"arch": "qwen2-7b", "shape": "train_4k", "mesh": "16x16", "ok": True,
     "t_compute_s": 0.0123456, "t_memory_s": 0.5, "t_collective_s": 0.001,
     "dominant": "memory", "useful_ratio": 0.456, "temp_bytes": 3 * 2**30},
    {"arch": "mamba2-130m", "shape": "long_500k", "mesh": "2x16x16",
     "ok": True, "t_compute_s": 1e-6, "t_memory_s": 2e-5,
     "t_collective_s": 0.0, "dominant": "memory", "useful_ratio": 1.26,
     "temp_bytes": None},
    {"arch": "jamba-v0.1-52b", "shape": "prefill_32k", "mesh": "16x16",
     "ok": False, "error": "x" * 100},
]


@pytest.mark.parametrize("with_roofline", [True, False])
def test_report_renders_as_the_reference(with_roofline):
    assert report.render(ROWS, with_roofline) == \
        ref_report.render(ROWS, with_roofline)


def test_report_prints_a_dash_for_a_term_not_counted():
    row = dict(ROWS[0], t_collective_s=None, temp_bytes=None)
    line = report.render([row]).splitlines()[-1]
    assert line == ("| qwen2-7b | train_4k | 12.35 | 500.00 | - | memory | "
                    "0.46 | - |")

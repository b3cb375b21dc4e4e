"""The dry-run's collective term (``repro_torch.launch.dryrun``,
``launch/spmd.py``): a step placed on a mesh as DTensors over torch's fake
process group, the bytes of every collective it issues counted per device
under the reference's kinds.

On a 2 x 4 ("data", "model") mesh and a reduced Qwen2 whose heads divide
the model axis, a prefill issues exactly the Megatron all-reduces (the
vocab-parallel embedding's and two a layer, each one device's (B/2, S, D)
bf16 block), a training step adds at least one all-reduce of every
parameter's gradient over "data" but the embedding's, which it forms from
the tokens and the residual's gradient gathered over "data", ``fsdp`` adds at least one all-gather of
every weight sharded over "data", and a reduced MoE layer gathers its
experts' outputs over "model" for the combine; a training step's loss
gathers no logits. ``constrain`` is the
identity on a plain tensor and places a DTensor as the reference's spec
of each kind says, with and without ``seq_parallel``. Every row leaves no
process group behind. ``chip_smoke.py``'s ``DRYRUN_COLL_REFERENCE`` and
``DRYRUN_MEM_REFERENCE`` (the reference's own ``--all`` rows) are held to
the JAX package's live ``dryrun_one`` for two decode rows, in a subprocess
with its 512 host devices."""

import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.arch import layers  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, spmd  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.launch.sharding import P, Partitioner, Sharding  # noqa: E402
from repro_torch.train.optimizer import leaves, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = device_mesh((2, 4), ("data", "model"))
B, S = 4, 32


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _dense():
    """Reduced Qwen2 (two layers, d_model 64) with four kv heads, so that
    query and kv heads both divide the 4-way model axis."""
    return replace(get_config("qwen2-0.5b").reduced(d_model=64),
                   n_kv_heads=4)


def _count(monkeypatch, cfg, kind, *, fsdp=False, seq_parallel=False):
    monkeypatch.setitem(dryrun.SHAPES, "tiny",
                        dict(kind=kind, seq=S, batch=B))
    part = Partitioner(MESH, cfg, seq_parallel=seq_parallel, fsdp=fsdp)
    model = TransformerLM(cfg, torch.bfloat16, device="meta")
    model.partitioner = part
    fn, args, shardings = dryrun.build_step(cfg.name, "tiny", model, part)
    counter = dryrun.count_placed(fn, args, shardings, MESH)
    assert not dist.is_initialized()
    return counter, args, shardings, part


def _shard_bytes(tree, shardings) -> list[int]:
    return [math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
            for t, sh in zip(leaves(tree), leaves(shardings), strict=True)]


def test_prefill_issues_exactly_the_megatron_all_reduces(monkeypatch):
    cfg = _dense()
    counter, _, _, _ = _count(monkeypatch, cfg, "prefill")
    block = (B // 2) * S * cfg.d_model * 2      # one device's bf16 residual
    # the embedding's partial rows, then per layer the attention's and the
    # MLP's row-parallel products reduced into the residual
    want = (1 + 2 * cfg.n_layers) * block
    assert counter.collectives == {"all-gather": 0, "all-reduce": want,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 0}
    assert counter.resharded == {}


def _frozen(which):
    """``dryrun._value_and_grad`` with the leaves for which
    ``which(leaf, params)`` holds out of the differentiation (their
    gradients zeros of their placements)."""

    def value_and_grad(model, params, batch):
        flat = [p.detach().requires_grad_(not which(p, params))
                for p in leaves(params)]
        with torch.enable_grad():
            loss = model.loss(unflatten(params, flat), batch)
            grads = iter(torch.autograd.grad(
                loss, [p for p in flat if p.requires_grad]))
        grads = [next(grads) if p.requires_grad else torch.zeros_like(p)
                 for p in flat]
        grads = [spmd.place(g, p.placements) for g, p in zip(grads, flat)]
        return loss.detach(), unflatten(params, grads)

    return value_and_grad


def test_a_training_step_reduces_every_gradient_over_data(monkeypatch):
    """Every gradient but the embedding's is all-reduced over "data" once,
    at its shard's bytes: the step all-reduces exactly their sum more than
    the same step with every leaf but the embedding frozen. The norms'
    scales count too: they enter a region split over "data" as replicas
    and leave it as partial sums. The embedding's gradient is formed whole
    on each device from the tokens and the residual's gradient gathered
    over "data": the step all-gathers exactly those two, one device's
    int32 (B, S) and bf16 (B, S, D / 4), more than the same step with the
    embedding frozen, and all-reduces no byte more."""
    cfg = _dense()
    prefill, _, _, _ = _count(monkeypatch, cfg, "prefill")
    train, args, shardings, _ = _count(monkeypatch, cfg, "train")
    grads = sum(n for n, t in zip(_shard_bytes(args[0], shardings[0]),
                                  leaves(args[0]))
                if t is not args[0]["embed"])
    # the forward's reductions at least once more, and each gradient's
    assert train.collectives["all-reduce"] >= \
        prefill.collectives["all-reduce"] + grads
    # ZeRO-1: the moments' shards over "data" gather the new parameters
    assert train.collectives["all-gather"] > 0
    monkeypatch.setattr(dryrun, "_value_and_grad", _frozen(
        lambda p, params: p is not params["embed"]))
    weights, _, _, _ = _count(monkeypatch, cfg, "train")
    assert train.collectives["all-reduce"] == \
        weights.collectives["all-reduce"] + grads
    assert train.collectives["all-gather"] == \
        weights.collectives["all-gather"]
    monkeypatch.setattr(dryrun, "_value_and_grad", _frozen(
        lambda p, params: p is params["embed"]))
    embed, _, _, _ = _count(monkeypatch, cfg, "train")
    tokens, residual = B * S * 4, B * S * (cfg.d_model // 4) * 2
    assert train.collectives["all-gather"] == \
        embed.collectives["all-gather"] + tokens + residual
    assert train.collectives["all-reduce"] == \
        embed.collectives["all-reduce"]


def test_a_region_takes_its_gradients_as_the_reference_transposes():
    """An RMSNorm (a region that moves nothing) feeding a Megatron MLP (a
    column-parallel product, then a row-parallel one) on the 2 x 4 mesh.
    The gradient of the norm's output arrives as a partial sum over
    "model" and is all-reduced once, one device's bf16 (B/2, S, D), before
    the region's backward reads it (Megatron's backward all-reduce). The
    scale, a replica inside a region split over "data", leaves it as a
    partial sum, all-reduced over "data" with the two weights' gradients,
    each at its shard, when they take their parameters' placements.
    Nothing else moves."""
    D, F = 64, 128

    def step(params, x):
        flat = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            scale, up, down = flat
            loss = (layers.rmsnorm(x, scale) @ up @ down).float().sum()
            grads = torch.autograd.grad(loss, flat)
        return [spmd.place(g, p.placements) for g, p in zip(grads, flat)]

    meta = dict(dtype=torch.bfloat16, device="meta")
    args = ((torch.empty(D, **meta), torch.empty(D, F, **meta),
             torch.empty(F, D, **meta)), torch.empty(B, S, D, **meta))
    shardings = ((Sharding(MESH, P()), Sharding(MESH, P(None, "model")),
                  Sharding(MESH, P("model", None))),
                 Sharding(MESH, P("data", None, None)))
    counter = dryrun.count_placed(step, args, shardings, MESH)
    block = (B // 2) * S * D * 2
    weight = D * (F // 4) * 2
    assert counter.collectives == {
        "all-gather": 0, "all-reduce": block + D * 2 + 2 * weight,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert counter.resharded == {}


def test_fsdp_gathers_the_weights_over_data(monkeypatch):
    cfg = _dense()
    plain, _, _, _ = _count(monkeypatch, cfg, "prefill")
    fsdp, args, shardings, part = _count(monkeypatch, cfg, "prefill",
                                         fsdp=True)
    # every layer weight the plain placement holds whole over "data" and
    # fsdp splits there: its model shard gathered at least once
    plain_specs = Partitioner(MESH, cfg).param_shardings(args[0])["blocks"]
    gathered = sum(
        math.prod(plain.shard_shape(tuple(t.shape))) * t.element_size()
        for t, plain, sh in zip(
            leaves(args[0]["blocks"]), leaves(plain_specs),
            leaves(part.param_shardings(args[0])["blocks"]))
        if "data" in tuple(sh.spec) and t.ndim >= 3)
    assert gathered > 0
    assert fsdp.collectives["all-gather"] >= \
        plain.collectives["all-gather"] + gathered


def test_a_moe_layer_gathers_its_experts_outputs_for_the_combine(
        monkeypatch):
    cfg = get_config("granite-moe-1b-a400m").reduced(d_model=64,
                                                      n_experts=4)
    counter, _, _, _ = _count(monkeypatch, cfg, "prefill")
    G = B                                   # a group a sequence
    C = math.ceil(cfg.capacity_factor * S * cfg.experts_per_token
                  / cfg.n_experts)
    # each device's groups' slots of every expert, gathered over "model"
    combine = cfg.n_experts * (G // 2) * C * cfg.d_model * 2
    n_moe = sum(spec.ffn == "moe" for spec in cfg.pattern) * cfg.n_repeats
    assert counter.collectives["all-gather"] >= n_moe * combine
    assert counter.collectives["all-to-all"] == 0


def test_the_loss_gathers_no_logits(monkeypatch):
    """The gold logit of a training step's loss is a masked lookup on each
    vocab shard and a partial sum, as the reference's one-hot product is
    (its ``take_along_axis`` would gather the logits): a gather of the
    logits by label instead all-gathers one device's float32 logits over
    the model axis."""
    cfg = _dense()
    counter, _, _, _ = _count(monkeypatch, cfg, "train")
    monkeypatch.setattr(layers, "gold_logit", lambda logits, labels:
                        logits.gather(-1, labels.long()[..., None]))
    gathered, _, _, _ = _count(monkeypatch, cfg, "train")
    logits = (B // 2) * S * cfg.vocab * 4
    assert gathered.collectives["all-gather"] == \
        counter.collectives["all-gather"] + logits
    assert counter.resharded == {}


def _placed(dmesh, shape, spec):
    return spmd.distribute(torch.empty(shape, dtype=torch.bfloat16,
                                       device="meta"),
                           Sharding(MESH, spec), dmesh)


CASES = [  # kind, shape, the reference's spec on the 2 x 4 mesh
    ("residual", (4, 8, 16), P("data", None, None)),
    ("logits", (4, 8, 12), P("data", None, "model")),
    ("logits", (4, 8, 6), P("data", None, None)),
    ("one_hot", (4, 8, 12), P("data", None, "model")),
    ("nll", (4, 8), P("data", None)),
    ("moe_buf", (2, 8, 3, 16), P("data", "model", None, None)),
    ("moe_buf", (1, 3, 3, 16), P(None, None, None, None)),
    ("moe_tokens", (2, 6, 16), P("data", None, None)),
    ("residual", (3, 8, 16), P(None, None, None)),
]


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("kind,shape,spec", CASES)
def test_constrain_places_a_dtensor_as_the_reference_spec(kind, shape, spec,
                                                          seq_parallel):
    part = Partitioner(MESH, _dense(), seq_parallel=seq_parallel)
    if seq_parallel and kind == "residual" and shape[1] % 4 == 0:
        spec = P(spec[0], "model", None)
    assert tuple(part.activation_spec(shape, kind)) == tuple(spec)
    plain = torch.zeros(shape)
    assert part.constrain(plain, kind) is plain
    with spmd.fake_mesh(MESH) as dmesh:
        x = _placed(dmesh, shape, P(*([None] * len(shape))))
        y = part.constrain(x, kind)
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == tuple(
            spmd.placements(spec, len(shape), ("data", "model")))
        assert tuple(y.shape) == shape
    assert not dist.is_initialized()


def test_a_spec_on_two_axes_shards_one_dim_on_both():
    assert spmd.placements(P(None, ("data", "model")), 2,
                           ("data", "model")) == [Shard(1), Shard(1)]
    assert spmd.placements(P(("pod", "data"), None), 2,
                           ("pod", "data", "model")) == \
        [Shard(0), Shard(0), Replicate()]
    with spmd.fake_mesh(MESH) as dmesh:
        x = _placed(dmesh, (1, 64, 2), P(None, ("data", "model"), None))
        assert tuple(x._local_tensor.shape) == (1, 8, 2)
    assert not dist.is_initialized()


def test_a_row_leaves_no_process_group_behind(monkeypatch):
    assert not dist.is_initialized()
    row = dryrun.dryrun_one("qwen2-0.5b", "long_500k", verbose=False)
    assert row["ok"] and row["coll_bytes"] > 0
    assert not dist.is_initialized()

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "count_step", boom)
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.dryrun_one("qwen2-0.5b", "long_500k", verbose=False)
    assert not dist.is_initialized()


def test_a_row_counts_the_same_unplaced(monkeypatch):
    """The placed trace counts the FLOPs and bytes the plain one does."""
    cfg = _dense()
    counter, args, _, part = _count(monkeypatch, cfg, "train")
    model = TransformerLM(cfg, torch.bfloat16, device="meta")
    fn, args, _ = dryrun.build_step(cfg.name, "tiny", model, part)
    assert dryrun.trace_counts(fn, *args) == (counter.flops, counter.bytes)


LIVE_ROWS = [("qwen2-0.5b", "decode_32k"), ("granite-moe-1b-a400m",
                                             "decode_32k")]


def test_the_reference_table_is_the_reference_dryrun():
    """``DRYRUN_COLL_REFERENCE`` and ``DRYRUN_MEM_REFERENCE`` against the
    JAX package's ``dryrun_one``, run live in a subprocess (its import asks
    for 512 host devices) by ``tests/reference_memory.py``."""
    smoke = _smoke()
    table = smoke.DRYRUN_COLL_REFERENCE
    assert len(table) == len(smoke.DRYRUN_MEM_REFERENCE) == 40
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "from reference_memory import reference_rows\n"
            f"rows = reference_rows({LIVE_ROWS!r})\n"
            "print(json.dumps([[r['coll_breakdown'], [r['temp_bytes'], "
            "r['output_bytes'], r['peak_bytes'], r['f32_copies']]] "
            "for r in rows]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    live = json.loads(out.stdout.strip().splitlines()[-1])
    for (arch, shape), (coll, mem) in zip(LIVE_ROWS, live):
        assert {k: v for k, v in coll.items() if v} == table[(arch, shape)]
        assert tuple(mem) == smoke.DRYRUN_MEM_REFERENCE[(arch, shape)]


def test_the_reference_table_names_the_reference_kinds():
    table = _smoke().DRYRUN_COLL_REFERENCE
    kinds = {k for row in table.values() for k in row}
    assert kinds <= set(spmd.REFERENCE_KINDS)
    assert all(sum(row.values()) > 0 for row in table.values())
    assert np.isclose(min(sum(r.values()) for r in table.values()), 481280)

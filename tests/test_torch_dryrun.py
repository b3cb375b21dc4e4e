"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

``--dynamic`` builds each workload's plan on the CPU here; its host
statistics (steps, arenas, layout, every read and write count, fallback
steps, the PQ counts) must equal the reference's on the same seed. Batch
sizes are 2 for the chains and MV-RNN (16 gather reads), 1 for the other
trees and the lattices, whose joint PQ planning at 2 takes 10-80 s a
package (TreeLSTM-2Type still gathers 8 operands at 1).

The arch sweep traces every (configuration x shape) step on the meta
device: each row must be ``ok``, its ``model_flops`` the reference's
formula on the reference's parameter shapes, and its ``arg_bytes`` one
device's shard bytes of the reference's arguments in the reference's own
dtypes (the bf16 model's parameters, caches and image embeddings, fp32
moments, int32 tokens), from the reference's ``Partitioner`` specs; its
compute term divides by the bf16 tensor-core peak, and with gradient
accumulation AdamW takes bf16 gradients, as the reference's. Each row's
collective term (the step placed on the mesh as DTensors) is filled under
the reference's kinds and stands within ``chip_smoke.py``'s bar of the
reference's own row, or near its held ratio; ``--seq-parallel`` and
``--layer-remat`` are taken. Each row's memory term is filled: its
``output_bytes`` the reference's leaf for leaf (XLA adds 8 bytes a leaf
for its output tuple) but where XLA splits its output caches as it
chooses, its ``temp_bytes`` within ``chip_smoke.py``'s memory bar of the
reference's own row, below the same training step's without remat. A
tiny dense model's counted forward FLOPs must equal the hand count of its
matmuls, attention counted as the flash kernel computes it (over the
causal pairs), and a tiny step's reckoned memory the hand count of what
it makes, on CPU tensors as on meta."""

import importlib.util
import json
import math
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.arch.model import TransformerLM as RefLM  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.workloads import WORKLOADS  # noqa: E402


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


REF = _reference_dryrun()

# workload -> minibatch size of its case
DYNAMIC_BATCH = {"BiLSTM-Tagger": 2, "LSTM-NMT": 2, "MV-RNN": 2,
                 "TreeGRU": 1, "TreeLSTM": 1, "TreeLSTM-2Type": 1,
                 "LatticeLSTM": 1, "LatticeGRU": 1}
TIMES = ("wall_s", "lower_time_s", "compile_time_s", "n_compiles")


@pytest.mark.parametrize("name", list(DYNAMIC_BATCH))
def test_dynamic_rows_equal_the_reference(name):
    bs = DYNAMIC_BATCH[name]
    got, = dryrun.dryrun_dynamic([name], batch_size=bs, verbose=False,
                                 device="cpu")
    want, = REF.dryrun_dynamic([name], batch_size=bs, verbose=False)
    assert got["ok"], got
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smokes_reference_rows_are_the_dynamic_rows():
    """``chip_smoke.py`` phase 12 holds the card's eight rows to the JAX
    package's ``--dynamic`` rows at its defaults (``DRYRUN_REFERENCE``).
    The first two workloads' plans take seconds: their rows here, one rng
    across both as there, must be those."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert list(smoke.DRYRUN_REFERENCE) == list(WORKLOADS)
    rows = dryrun.dryrun_dynamic(list(WORKLOADS)[:2], verbose=False,
                                 device="cpu")
    for row in rows:
        assert tuple(row[k] for k in smoke.DRYRUN_FIELDS) == \
            smoke.DRYRUN_REFERENCE[row["workload"]]
    assert set(smoke.DRYRUN_FIELDS) == set(rows[0]) - set(TIMES) - {
        "workload", "ok"}


def test_a_skipped_workloads_graph_is_still_drawn():
    """``chip_smoke.py`` phase 12 skips the plans earlier phases build;
    the rows after a skipped workload must stay the full sweep's."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    first, second = list(WORKLOADS)[:2]
    assert first in smoke.DRYRUN_PLANNED_EARLIER
    row, = dryrun.dryrun_dynamic([first, second], verbose=False,
                                 device="cpu", skip=(first,))
    assert row["workload"] == second
    assert tuple(row[k] for k in smoke.DRYRUN_FIELDS) == \
        smoke.DRYRUN_REFERENCE[second]


def test_dynamic_reports_a_failed_workload_as_a_row():
    rows = dryrun.dryrun_dynamic(["no-such-workload"], verbose=False,
                                 device="cpu")
    assert rows == [{"workload": "no-such-workload", "ok": False,
                     "error": "no-such-workload"}]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``--all`` through the command, once: 40 rows on the 16x16 mesh."""
    out = tmp_path_factory.mktemp("dryrun") / "rows.json"
    rc = dryrun.main(["--all", "--out", str(out)])
    with open(out) as f:
        rows = json.load(f)
    return rc, {(r["arch"], r["shape"].split("(")[0]): r for r in rows}


def test_all_exits_zero_with_every_row_ok(sweep):
    rc, rows = sweep
    assert rc == 0
    assert sorted(rows) == sorted((a, s) for a in ARCHS for s in dryrun.SHAPES)
    assert all(r["ok"] and r["mesh"] == "16x16" for r in rows.values())


def _stub_mesh():
    return types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))


def _shard_elements(shape, spec, sizes) -> int:
    n = 1
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        axes = () if part is None else (part,) if isinstance(part, str) \
            else part
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


def _reference_arg_bytes(arch, shape) -> int:
    """One device's bytes of the reference's step arguments, each leaf at
    its own element size: the model built in bf16 as the reference's
    dry-run builds it (parameters, caches, image embeddings), the AdamW
    moments fp32 (``init_opt_state``), tokens and positions int32."""
    cfg, _ = REF.resolve_config(arch, shape)
    mesh = _stub_mesh()
    part = ref_sharding.Partitioner(mesh, cfg)
    model = RefLM(cfg, dtype=jnp.bfloat16)
    info = REF.SHAPES[shape]
    B, S = info["batch"], info["seq"]
    params = model.param_specs()
    pairs = [(params, part.param_specs(params))]
    P = jax.sharding.PartitionSpec
    if info["kind"] == "train":
        moments = jax.eval_shape(REF.init_opt_state, params)
        pairs.append((moments["mu"], part.opt_specs(params)["mu"]))
        pairs.append((moments["nu"], part.opt_specs(params)["nu"]))
        pairs.append((moments["step"], P()))
    if info["kind"] in ("train", "prefill"):
        for _ in range(2 if info["kind"] == "train" else 1):
            pairs.append((jax.ShapeDtypeStruct((B, S), "int32"),
                          part.token_spec(B)))
        if cfg.n_image_tokens:
            pairs.append((jax.ShapeDtypeStruct(
                (B, cfg.n_image_tokens, cfg.d_model), model.dtype),
                P(part.batch_spec(B) or None, None, None)))
    else:
        caches = model.cache_specs(B, S)
        pairs.append((caches, part.cache_specs(caches, B)))
        pairs.append((jax.ShapeDtypeStruct((B,), "int32"),
                      P(part.batch_spec(B) or None)))
        pairs.append((jax.ShapeDtypeStruct((), "int32"), P()))
    total = 0
    for tree, specs in pairs:
        shapes = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        assert len(shapes) == len(spec_leaves)
        total += sum(np.dtype(s.dtype).itemsize
                     * _shard_elements(s.shape, tuple(p), mesh.shape)
                     for s, p in zip(shapes, spec_leaves))
    return total


# Rows whose output caches XLA splits as it chooses (the reference's
# prefill and decode steps set no output shardings), by cache leaf name:
# each of the port's leaves so named comes out split over "data" on the
# batch alone (where it divides), replicated over "model", where XLA
# splits it the given number of times more (read from the reference's
# rows: the differences below are exact)
OUTPUT_CACHES_REPLACED = {
    **{(a, "prefill_32k"): {"k": 16, "v": 16}
       for a in ("llama-3.2-vision-11b", "qwen2-7b", "phi4-mini-3.8b",
                 "qwen2-0.5b", "granite-moe-1b-a400m")},
    ("musicgen-medium", "prefill_32k"): {"k": 8, "v": 8},
    ("jamba-v0.1-52b", "prefill_32k"): {"k": 16, "v": 16, "state": 16,
                                        "conv": 16},
    ("mamba2-130m", "prefill_32k"): {"state": 8, "conv": 16},
    ("mamba2-130m", "decode_32k"): {"state": 8},
    ("mamba2-130m", "long_500k"): {"state": 8},
    ("jamba-v0.1-52b", "decode_32k"): {"state": 16},
    ("jamba-v0.1-52b", "long_500k"): {"state": 16}}


def _bytes_xla_splits_further(arch, shape) -> int:
    """One device's bytes of the step's output cache leaves that
    :data:`OUTPUT_CACHES_REPLACED` names, as the port places them, less
    the same leaves split as many times more as it says."""
    factors = OUTPUT_CACHES_REPLACED[(arch, shape)]
    cfg, _ = dryrun.resolve_config(arch, shape)
    info = dryrun.SHAPES[shape]
    data = _stub_mesh().shape["data"]
    data = data if info["batch"] % data == 0 else 1
    caches = TransformerLM(cfg, torch.bfloat16, device="meta").cache_specs(
        info["batch"], info["seq"])
    total = 0

    def walk(tree, name=None):
        nonlocal total
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, key)
        elif isinstance(tree, (list, tuple)):
            for sub in tree:
                walk(sub, name)
        elif name in factors:
            held = tree.numel() * tree.element_size() // data
            total += held - held // factors[name]

    walk(caches)
    return total


def _output_leaves(arch, shape) -> int:
    """The leaves of the step's outputs: a training step's parameters, both
    moments, the step counter and the loss; otherwise the logits and the
    caches."""
    cfg, _ = dryrun.resolve_config(arch, shape)
    model = TransformerLM(cfg, device="meta")
    info = dryrun.SHAPES[shape]
    if info["kind"] == "train":
        return 3 * len(dryrun.leaves(model.param_specs())) + 2
    return 1 + len(dryrun.leaves(model.cache_specs(info["batch"],
                                                   info["seq"])))


@pytest.mark.parametrize("shape", list(dryrun.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_row_counts_equal_the_reference(sweep, arch, shape):
    row = sweep[1][(arch, shape)]
    assert row["ok"], row
    cfg, note = REF.resolve_config(arch, shape)
    assert row["shape"] == shape + note
    info = REF.SHAPES[shape]
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    assert row["model_flops"] == ref_roofline.model_flops(
        cfg, RefLM(cfg).param_specs(), shape, tokens)
    assert row["arg_bytes"] == _reference_arg_bytes(arch, shape)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    # the memory term: one device's bytes
    assert row["temp_bytes"] > 0
    assert row["bytes_per_device"] == row["temp_bytes"] + row["arg_bytes"]
    assert row["peak_bytes"] >= row["arg_bytes"] + row["temp_bytes"]
    want = _smoke().DRYRUN_MEM_REFERENCE[(arch, shape)][1]
    xla_tuple = 8 * _output_leaves(arch, shape)
    further = _bytes_xla_splits_further(arch, shape) \
        if (arch, shape) in OUTPUT_CACHES_REPLACED else 0
    assert row["output_bytes"] + xla_tuple == want + further
    # the collective term: per device, under the reference's kinds
    assert row["coll_bytes"] > 0
    assert row["coll_bytes"] == sum(row["coll_breakdown"].values())
    assert set(row["coll_breakdown"]) <= set(ref_roofline._COLLECTIVES)
    assert all(v > 0 for v in row["coll_breakdown"].values())
    assert row["t_collective_s"] == row["coll_bytes"] / 450e9
    terms = {"compute": row["t_compute_s"], "memory": row["t_memory_s"],
             "collective": row["t_collective_s"]}
    assert row["dominant"] == max(terms, key=terms.get)


def test_sweep_rows_collective_bytes_stand_by_the_references(sweep):
    """Each single-pod row's collective bytes within ``chip_smoke.py``'s
    bar of the reference's own ``--all`` row (``DRYRUN_COLL_REFERENCE``),
    or, for the few rows PERF.md explains, within the slack of the ratio
    recorded for it; no more than eight rows held so."""
    smoke = _smoke()
    assert len(smoke.DRYRUN_COLL_HELD) <= 8
    assert smoke.DRYRUN_COLL_BAR == 8.0
    rows = sweep[1]
    assert set(smoke.DRYRUN_COLL_REFERENCE) == set(rows)
    missed = {key: rows[key]["coll_bytes"]
              / sum(smoke.DRYRUN_COLL_REFERENCE[key].values())
              for key in rows
              if not smoke.collective_ratio_ok(*key, rows[key]["coll_bytes"])}
    assert missed == {}
    for key, ratio in smoke.DRYRUN_COLL_HELD.items():
        assert not 1 / 8 <= ratio <= 8, key      # held only off the bar


def test_sweep_rows_memory_stand_by_the_references(sweep):
    """Each single-pod row's temp bytes within ``chip_smoke.py``'s memory
    bar, either way, of the reference's own ``--all`` row less XLA:CPU's
    float32 copies of the step's bf16 arguments (``DRYRUN_MEM_REFERENCE``),
    or, for the few rows PERF.md explains, within the slack of the ratio
    recorded for it; no more than eight rows held so."""
    smoke = _smoke()
    assert len(smoke.DRYRUN_MEM_HELD) <= 8
    assert smoke.DRYRUN_MEM_BAR == 8.0
    rows = sweep[1]
    assert set(smoke.DRYRUN_MEM_REFERENCE) == set(rows)
    missed = {key: smoke.memory_ratio(*key, rows[key]["temp_bytes"])
              for key in rows
              if not smoke.memory_ratio_ok(*key, rows[key]["temp_bytes"])}
    assert missed == {}
    for key, ratio in smoke.DRYRUN_MEM_HELD.items():
        assert not 1 / 8 <= ratio <= 8, key      # held only off the bar


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "granite-moe-1b-a400m"])
def test_a_training_row_holds_less_than_its_step_without_remat(sweep, arch):
    """The sweep's training row (each repeat checkpointed) holds fewer temp
    bytes than the same placed step of a model without remat, and counts
    more FLOPs: the backward's recomputed forward."""
    cfg, _ = dryrun.resolve_config(arch, "train_4k")
    mesh = dryrun.make_production_mesh()
    part = dryrun.Partitioner(mesh, cfg)
    model = TransformerLM(cfg, torch.bfloat16, device="meta")
    model.partitioner = part
    fn, args, shardings = dryrun.build_step(arch, "train_4k", model, part)
    plain = dryrun.count_placed(fn, args, shardings, mesh)
    row = sweep[1][(arch, "train_4k")]
    assert row["temp_bytes"] < plain.temp_high_water
    assert row["hlo_flops"] * 256 > plain.flops


def test_dryrun_one_variants_run_on_both_meshes():
    plain = dryrun.dryrun_one("qwen2-0.5b", "decode_32k", verbose=False)
    multi = dryrun.dryrun_one("qwen2-0.5b", "decode_32k", multi_pod=True,
                              verbose=False, fsdp=True, no_tp=True)
    assert multi["ok"] and multi["mesh"] == "2x16x16"
    assert multi["shape"] == "decode_32k+fsdp+notp"
    assert multi["model_flops"] == plain["model_flops"]
    accum = dryrun.dryrun_one("qwen2-0.5b", "train_4k", verbose=False,
                              grad_accum=2)
    single = dryrun.dryrun_one("qwen2-0.5b", "train_4k", verbose=False)
    assert accum["shape"] == "train_4k+ga2"
    assert accum["arg_bytes"] == single["arg_bytes"]
    assert accum["hlo_flops"] == pytest.approx(single["hlo_flops"])


def test_grad_accum_hands_adamw_bf16_gradients(monkeypatch):
    """With ``--grad-accum 2`` the microbatches' gradients are summed in
    fp32 and cast to bf16 after dividing, as the reference's
    ``(g / accum).astype(jnp.bfloat16)``: AdamW takes bf16 gradients
    beside the bf16 parameters and the fp32 moments."""
    seen = {}
    real = dryrun.adamw_update

    def spy(cfg, params, grads, state):
        seen["params"] = {t.dtype for t in dryrun.leaves(params)}
        seen["grads"] = {t.dtype for t in dryrun.leaves(grads)}
        seen["moments"] = {t.dtype for t in dryrun.leaves(state["mu"])}
        return real(cfg, params, grads, state)

    monkeypatch.setattr(dryrun, "adamw_update", spy)
    row = dryrun.dryrun_one("mamba2-130m", "train_4k", verbose=False,
                            grad_accum=2)
    assert row["ok"] and row["shape"] == "train_4k+ga2"
    assert seen == {"params": {torch.bfloat16}, "grads": {torch.bfloat16},
                    "moments": {torch.float32}}


def test_a_bf16_rows_compute_term_uses_the_bf16_peak():
    from repro_torch.launch import roofline

    row = dryrun.dryrun_one("qwen2-0.5b", "prefill_32k", verbose=False)
    assert roofline.PEAK_BF16 == 989e12
    assert row["t_compute_s"] == pytest.approx(
        row["hlo_flops"] / roofline.PEAK_BF16, rel=1e-12)
    fp32 = roofline.Roofline(arch="a", shape="s", mesh="1", chips=1,
                             hlo_flops=row["hlo_flops"], hlo_bytes=1.0)
    assert fp32.t_compute == row["hlo_flops"] / roofline.PEAK_FLOPS


def test_tiny_dense_forward_flops_are_its_matmuls():
    cfg = get_config("qwen2-0.5b").reduced(d_model=32)
    B, S = 2, 24
    model = TransformerLM(cfg, device="meta")
    params = model.param_specs()
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    flops, nbytes = dryrun.trace_counts(model.forward, params, tokens)
    D, H, KV, dh, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.vocab)
    per_layer = (2 * B * S * D * H * dh          # q
                 + 2 * 2 * B * S * D * KV * dh   # k, v
                 + 2 * 2 * B * H * S * (S + 1) // 2 * dh   # flash attention:
                 # scores and P V over the causal pairs only
                 + 2 * B * S * H * dh * D        # o
                 + 3 * 2 * B * S * D * F)        # SwiGLU
    assert flops == cfg.n_layers * per_layer + 2 * B * S * D * V
    assert nbytes > 4 * B * S * V                # at least the logits


def test_cli_refuses_variants_it_does_not_reckon(sweep, tmp_path):
    """No variant is refused now: ``--layer-remat`` is taken, as the
    reference's, checkpointing each layer of a training step too. The
    row's note ends in ``+lremat``, and it holds no more temp bytes than
    the plain row (the vision model's repeat of five layers: fewer)."""
    out = tmp_path / "lremat.json"
    assert dryrun.main(["--arch", "llama-3.2-vision-11b", "--shape",
                        "train_4k", "--layer-remat", "--out", str(out)]) == 0
    row, = json.loads(out.read_text())
    plain = sweep[1][("llama-3.2-vision-11b", "train_4k")]
    assert row["ok"] and row["shape"] == "train_4k+lremat"
    assert _smoke().memory_ratio_ok("llama-3.2-vision-11b", "train_4k",
                                    row["temp_bytes"], layer_remat=True)
    assert row["temp_bytes"] < plain["temp_bytes"]
    assert row["arg_bytes"] == plain["arg_bytes"]
    assert row["hlo_flops"] > plain["hlo_flops"]


def test_tiny_step_memory_is_its_hand_count():
    """A tiny step's reckoned memory, by hand: the projection ``h`` lives
    beside the attention's output and lse, which a stand-in makes (its
    (B, H, S, S) scores count nothing); ``h`` dies with its last view, and
    the sum and the lse are the outputs. On CPU tensors as on meta."""
    from repro_torch.kernels.flash_attention import flash_attention_forward

    B, S, H, D = 2, 16, 4, 8

    def step(x, w):
        h = x @ w                                     # (B*S, 3*H*D)
        q, k, v = h.view(B, S, 3, H, D).unbind(2)     # views of h
        o, lse = flash_attention_forward(q, k, v, with_lse=True)
        del h, q, k, v
        return o.sum(), lse

    f32 = 4
    h, o, lse = B * S * 3 * H * D * f32, B * S * H * D * f32, B * H * S * f32
    for dev in ("cpu", "meta"):
        args = (torch.zeros((B * S, 16), device=dev),
                torch.zeros((16, 3 * H * D), device=dev))
        counter = dryrun.count_step(step, *args)
        assert counter.high_water == h + o + lse, dev
        assert counter.temp_high_water == h + o, dev
        assert counter.output_bytes == f32 + lse, dev
        # the plain attention, not a stand-in: its scores and weights count
        plain = dryrun.count_step(
            lambda q: dryrun.ref.flash_attention_ref(q, q, q),
            torch.zeros((B, S, H, D), device=dev))
        assert plain.high_water >= 2 * B * H * S * S * f32


def test_cli_takes_seq_parallel(tmp_path):
    """``--seq-parallel`` places the residuals on "model" along the
    sequence, as the reference's: the row's note says ``+sp`` and its
    collectives differ from the plain row's."""
    out = tmp_path / "sp.json"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                        "--seq-parallel", "--out", str(out)]) == 0
    row, = json.loads(out.read_text())
    plain = dryrun.dryrun_one("qwen2-0.5b", "prefill_32k", verbose=False)
    assert row["ok"] and row["shape"] == "prefill_32k+sp"
    assert row["coll_bytes"] > 0
    assert row["coll_breakdown"] != plain["coll_breakdown"]
    assert (row["hlo_flops"], row["arg_bytes"]) == \
        (plain["hlo_flops"], plain["arg_bytes"])

"""The model's activation checkpointing (``TransformerLM(..., remat=True)``
and ``layer_remat``) against the port without it and against the JAX
package's ``remat``, on the CPU at reduced size: one configuration of each
family (dense, SSM, MoE, hybrid, cross-attention), two pattern repeats
each, the reference's parameters installed by the converter.

- The loss and every gradient with ``remat``, and with ``remat`` and
  ``layer_remat``, equal the port's without, bit for bit (the recomputed
  forward runs the same ops in the same order), and lie within 1e-4 of the
  reference's ``jax.value_and_grad`` of its remat model.
- Traced on the meta device (``dryrun.trace_counts``), a remat step's
  FLOPs less the plain step's are the blocks' forward FLOPs (the
  forward's less the head's matmul), less, under the checkpoint's early
  stop, each repeat's last projection, which no gradient needs.
- A remat step draws no random numbers and reads no generator state.
- The MoE routes each token to the same experts in the recomputed forward.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.arch import layers  # noqa: E402
from repro_torch.arch.convert import install_params  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

FAMILIES = ["qwen2-0.5b", "mamba2-130m", "granite-moe-1b-a400m",
            "jamba-v0.1-52b", "llama-3.2-vision-11b"]
VARIANTS = {"remat": (True, False), "remat+layer": (True, True)}
SEQ = 32      # two chunks of the reduced Mamba2's 16
TOL = 1e-4


def _cfgs(name):
    """The reduced configuration at two pattern repeats, both packages'."""
    jcfg = jax_config(name).reduced()
    over = dict(n_layers=2 * len(jcfg.pattern))
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(get_config(name).reduced(), **over))


def _model(cfg, remat: bool, layer_remat: bool, device="cpu"):
    m = TransformerLM(cfg, device=device, remat=remat)
    m.layer_remat = layer_remat
    return m


def _loss_and_grads(model, params, batch):
    """The loss and its gradients, with deterministic algorithms: the
    CPU's ``index_put_`` with accumulation (the backward of the MoE's
    plain row gathers) otherwise sums across threads in no fixed order,
    so that two plain runs differ in their last bits."""
    flat = [p.detach().requires_grad_(True) for p in opt.leaves(params)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        loss = model.loss(opt.unflatten(params, flat), batch)
        return loss.detach(), list(torch.autograd.grad(loss, flat))
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """Each family's reference model and parameters, the port's parameters
    installed from them, a batch, and the port's plain loss and
    gradients."""
    jcfg, cfg = _cfgs(request.param)
    assert cfg.n_repeats == 2
    jparams = JaxLM(jcfg).init_params(jax.random.PRNGKey(0))
    params = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    install_params(params, jax.tree.map(np.asarray, jparams))
    batch = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=SEQ, batch_size=2, seed=0,
        n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model)).batch(0)
    plain = _loss_and_grads(_model(cfg, False, False), params,
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params, batch=batch, plain=plain)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_is_bit_equal_to_plain_and_near_the_reference(family, variant):
    remat, layer_remat = VARIANTS[variant]
    cfg, batch = family["cfg"], family["batch"]
    loss, grads = _loss_and_grads(
        _model(cfg, remat, layer_remat), family["params"],
        {k: torch.as_tensor(v) for k, v in batch.items()})
    want_loss, want_grads = family["plain"]
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(grads, want_grads,
                                                 strict=True))

    jm = JaxLM(family["jcfg"], remat=remat)
    jm.layer_remat = layer_remat
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        family["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g.numpy() - jg).max()) / scale <= TOL


def _tail_flops(cfg, tokens: int) -> int:
    """The FLOPs of one repeat's forward that its backward needs nothing
    from: the last layer's output projection (a dense FFN's down
    projection; an SSM layer without an FFN, its out projection), whose
    operands autograd has saved before it runs. The MoE's combine feeds a
    product that saves its output, so an MoE repeat has no such tail."""
    spec = cfg.pattern[-1]
    if spec.ffn == "dense":
        return 2 * tokens * cfg.d_ff * cfg.d_model
    if spec.ffn == "none" and spec.mixer == "ssm":
        return 2 * tokens * cfg.d_inner * cfg.d_model
    return 0


@pytest.mark.parametrize("early_stop", [True, False],
                         ids=["early stop", "whole recompute"])
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_step_flops_add_the_blocks_forward(name, early_stop):
    """On meta, the FLOPs of a remat loss and backward less the plain
    one's are the blocks' forward FLOPs (the forward's less the head's
    matmul), exactly, where the recomputation runs whole; with
    ``torch.utils.checkpoint``'s early stop (its default, which the model
    keeps, as XLA drops a recomputed op no gradient needs) they lack each
    repeat's tail (:func:`_tail_flops`)."""
    _, cfg = _cfgs(name)
    B = 2
    params = TransformerLM(cfg, device="meta").param_specs()
    batch = {"tokens": torch.empty((B, SEQ), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty((B, SEQ), dtype=torch.int32,
                                   device="meta")}
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.d_model), device="meta")

    def step_flops(remat: bool) -> int:
        model = _model(cfg, remat, False, device="meta")
        with set_checkpoint_early_stop(early_stop):
            return dryrun.trace_counts(
                lambda: _loss_and_grads(model, params, batch))[0]

    forward = dryrun.trace_counts(
        _model(cfg, False, False, device="meta").forward, params,
        batch["tokens"], batch.get("image_embeds"))[0]
    blocks = forward - 2 * B * SEQ * cfg.d_model * cfg.vocab   # the head
    skipped = cfg.n_repeats * _tail_flops(cfg, B * SEQ) if early_stop else 0
    assert step_flops(True) - step_flops(False) == blocks - skipped > 0


def test_a_remat_step_draws_no_random_numbers(monkeypatch):
    """No op of a remat step (forward, recomputation, backward) is a
    seeded random op, the CPU generator's state is unchanged, and no
    generator state is read or written: a captured step on the card meets
    no generator."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    model = _model(cfg, True, True)
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=SEQ, batch_size=2, seed=0)).batch(0).items()}

    def refuse(*args):
        raise AssertionError("a generator's state was read or set")

    for name in ("get_rng_state", "set_rng_state"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.random, name, refuse)
    seeded = []

    class Seeded(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if torch.Tag.nondeterministic_seeded in func.tags:
                seeded.append(str(func))
            return func(*args, **(kwargs or {}))

    state = torch.default_generator.get_state()
    with Seeded():
        _loss_and_grads(model, params, batch)
    assert seeded == []
    assert torch.equal(torch.default_generator.get_state(), state)


def test_moe_routes_alike_in_the_recomputed_forward(monkeypatch):
    """Each MoE call's expert choices and gather indices in the backward's
    recomputation equal the forward's call of the same layer."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    model = _model(cfg, True, False)
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=SEQ, batch_size=2, seed=0)).batch(0).items()}
    calls = []
    real = layers.moe_route

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        calls.append({k: r[k].clone() for k in ("expert_idx", "dispatch_idx",
                                                 "combine_idx")})
        return r

    monkeypatch.setattr(layers, "moe_route", spy)
    _loss_and_grads(model, params, batch)
    n = cfg.n_layers          # every reduced Granite layer has an MoE
    assert len(calls) == 2 * n  # the forward's, then the recomputation's
    # the backward recomputes the repeats last to first
    per_repeat = n // cfg.n_repeats
    forward = calls[:n]
    order = [i for r in reversed(range(cfg.n_repeats))
             for i in range(r * per_repeat, (r + 1) * per_repeat)]
    for got, i in zip(calls[n:], order, strict=True):
        for key, want in forward[i].items():
            assert torch.equal(got[key], want), (i, key)

"""The port's static-buffer train step (``repro_torch.train.loop.
StaticTrainStep``) and its multi-tensor in-place AdamW
(``repro_torch.train.optimizer.adamw_update_``) against the JAX package's
jitted step and ``adamw_update`` on the CPU, at ``cfg.reduced()`` with the
reference's parameters installed by the converter and batches from the
same ``SyntheticCorpus``:

- ``adamw_update_`` fed the same gradients within 1e-6 of the largest
  |value| per leaf (parameters, both moments), the gradient norm and lr
  within 1e-6 relative, with clipping active and inactive;
- five static-buffer steps' losses within 1e-4 relative of the
  reference's ``train``, run eagerly here as on the CPU the trainer runs
  it, for both LM families;
- the step counter and the lr after N steps equal to the reference's: the
  first step (the warm-up of a capture on the card) counts once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.arch.convert import install_params  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.loop import StaticTrainStep, train  # noqa: E402

LM_ARCHS = ["qwen2-0.5b", "mamba2-130m"]
SEQ = 32     # a multiple of the reduced Mamba2's chunk of 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name):
    jcfg = jax_config(name).reduced()
    cfg = get_config(name).reduced()
    jm = JaxLM(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    install_params(params, _np_tree(jparams))
    return jm, jparams, m, params


def _assert_close(got: dict, want: dict, rel: float, what: str):
    """Two {checkpoint path: array} maps, each leaf within ``rel`` of its
    largest |value|."""
    assert sorted(got) == sorted(want)
    for path in want:
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        err = float(np.abs(got[path] - want[path]).max()) / scale
        assert err <= rel, f"{what} {path}: {err:.3e}"


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["clip inactive", "clip active"])
def test_in_place_adamw_matches_the_reference(grad_scale):
    """Seven in-place updates with the same gradients (across warmup into
    the cosine) against the reference's functional ones."""
    _, jparams, _, params = _models("qwen2-0.5b")
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                          grad_clip=1.0)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                            grad_clip=1.0)
    state, jstate = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    flat = [t.clone() for t in opt.leaves(params)]
    mu = [t.clone() for t in opt.leaves(state["mu"])]
    nu = [t.clone() for t in opt.leaves(state["nu"])]
    step = state["step"].clone()
    rng = np.random.default_rng(1)
    clipped = []
    for _ in range(7):
        g = [(grad_scale * rng.standard_normal(a.shape)).astype(np.float32)
             for a in jax.tree.leaves(_np_tree(jparams))]
        m = opt.adamw_update_(cfg, flat, [torch.from_numpy(a.copy())
                                          for a in g], mu, nu, step)
        jparams, jstate, jm = jopt.adamw_update(
            jcfg, jparams, jax.tree.unflatten(jax.tree.structure(jparams), g),
            jstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        clipped.append(float(m["grad_norm"]) > cfg.grad_clip)
        for what, mine, ref in (("params", flat, jparams),
                                ("mu", mu, jstate["mu"]),
                                ("nu", nu, jstate["nu"])):
            _assert_close(ckpt._flatten(opt.unflatten(params, mine)),
                          jckpt._flatten(ref), 1e-6, what)
        assert int(step) == int(jstate["step"])
    assert all(clipped) if grad_scale > 1 else not any(clipped)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_five_static_steps_match_the_reference(name):
    jm, jparams, m, params = _models(name)
    pc = dict(vocab=m.cfg.vocab, seq_len=SEQ, batch_size=2, seed=3)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    step = StaticTrainStep(m, opt.AdamWConfig(**kw), params)
    corpus = SyntheticCorpus(PipelineConfig(**pc))
    losses = [float(step(corpus.batch())["loss"]) for _ in range(5)]
    jstate = jloop.train(jm, jparams, iter(JCorpus(JPipelineConfig(**pc))),
                         5, jopt.AdamWConfig(**kw), log_every=1,
                         log_fn=lambda s: None)
    np.testing.assert_allclose(losses, jstate.history, rtol=1e-4)
    assert not step.capture            # the CPU runs the body eagerly


@pytest.mark.parametrize("n", [1, 3, 6])
def test_step_counter_and_lr_count_the_first_step_once(n):
    """After ``n`` static steps the counter is ``n`` and the last step's lr
    the reference's at its step ``n``; ``state()`` hands back the updated
    buffers and the caller's params are left alone."""
    jm, jparams, m, params = _models("qwen2-0.5b")
    before = ckpt._flatten(params)
    kw = dict(lr=1e-3, warmup_steps=4, total_steps=8)
    step = StaticTrainStep(m, opt.AdamWConfig(**kw), params)
    corpus = SyntheticCorpus(PipelineConfig(vocab=m.cfg.vocab, seq_len=SEQ,
                                            batch_size=2, seed=0))
    for _ in range(n):
        metrics = step(corpus.batch())
    new, state = step.state()
    assert int(state["step"]) == n
    np.testing.assert_allclose(float(metrics["lr"]),
                               float(jopt.lr_at(jopt.AdamWConfig(**kw), n)),
                               rtol=1e-6)
    after = ckpt._flatten(params)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert any(not np.array_equal(before[k], v)
               for k, v in ckpt._flatten(new).items())


def test_train_on_the_cpu_runs_the_static_step_eagerly():
    """``train`` runs :class:`StaticTrainStep`, which captures only on the
    card: on the CPU, with capture on or off, the same eager steps give
    the same losses and parameters, and the static step's own."""
    _, _, m, params = _models("mamba2-130m")
    pc = PipelineConfig(vocab=m.cfg.vocab, seq_len=SEQ, batch_size=2, seed=1)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=3)
    runs = [train(m, params, iter(SyntheticCorpus(pc)), 3,
                  opt.AdamWConfig(**kw), log_every=1, log_fn=lambda s: None,
                  capture=capture) for capture in (True, False)]
    step = StaticTrainStep(m, opt.AdamWConfig(**kw), params)
    corpus = SyntheticCorpus(pc)
    losses = [float(step(corpus.batch())["loss"]) for _ in range(3)]
    assert runs[0].history == runs[1].history == losses
    a, b = (ckpt._flatten(r.params) for r in runs)
    c = ckpt._flatten(step.state()[0])
    assert all(np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])
               for k in a)
    assert runs[0].step == 3 and int(runs[0].opt["step"]) == 3

"""The port's LM trainer (``repro_torch.train``, ``launch/train.py``,
``TransformerLM.loss``) against the JAX package's on the CPU, at
``cfg.reduced()`` with the reference's parameters installed by the
converter and batches from the same ``SyntheticCorpus``:

- ``loss`` and its gradients against ``jax.value_and_grad(model.loss)``,
  within 1e-4 of the largest |gradient| per leaf, with and without a
  ``loss_mask``;
- ``adamw_update`` fed the same gradients within 1e-6 (``lr_at`` across
  warmup and cosine; clipping active and inactive);
- five steps of ``train`` with losses within 1e-4 relative;
- npz checkpoints written by each package load into the other bit-equal;
- ``launch.train.main`` on the CPU, whose checkpoint the reference loads.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.arch.convert import install_params  # noqa: E402
from repro_torch.arch.model import TransformerLM, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.loop import make_train_step, train  # noqa: E402

LM_ARCHS = ["qwen2-0.5b", "mamba2-130m", "granite-moe-1b-a400m",
            "llama-3.2-vision-11b"]
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


def _batch(cfg, B=2, seed=0, mask=False):
    b = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=SEQ, batch_size=B, seed=seed,
        n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model)).batch(0)
    if mask:
        rng = np.random.default_rng(seed)
        b["loss_mask"] = (rng.random((B, SEQ)) < 0.6).astype(np.float32)
    return b


def _by_path(tree) -> dict:
    """A tree's leaves as numpy arrays by checkpoint path."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return ckpt._flatten(tree)
    return jckpt._flatten(tree)


def _assert_tree_close(got, want, rel: float, what: str):
    got, want = _by_path(got), _by_path(want)
    assert sorted(got) == sorted(want)
    for path in want:
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        err = float(np.abs(got[path] - want[path]).max()) / scale
        assert err <= rel, f"{what} {path}: {err:.3e}"


@pytest.mark.parametrize("mask", [False, True], ids=["no mask", "loss_mask"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_loss_and_gradients_match(name, mask):
    jm, jparams, m, params = _models(name)
    batch = _batch(m.cfg, mask=mask)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = [p.requires_grad_(True) for p in opt.leaves(params)]
    loss = m.loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = opt.unflatten(params, list(torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_tree_close(grads, jgrads, 1e-4, "gradient")


def test_loss_of_a_fully_masked_batch_is_zero():
    _, _, m, params = _models("qwen2-0.5b")
    batch = {k: torch.as_tensor(v) for k, v in _batch(m.cfg).items()}
    batch["loss_mask"] = torch.zeros(batch["tokens"].shape)
    assert float(m.loss(params, batch)) == 0.0


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 30, 59, 60, 61, 100])
def test_lr_schedule_matches(step):
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    np.testing.assert_allclose(float(opt.lr_at(cfg, step)),
                               float(jopt.lr_at(jcfg, step)), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["clip inactive", "clip active"])
def test_adamw_update_matches(grad_scale):
    """Seven updates with the same gradients (across warmup into the
    cosine), parameters and both moments within 1e-6 of the reference."""
    _, jparams, _, params = _models("qwen2-0.5b")
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                          grad_clip=1.0)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                            grad_clip=1.0)
    state, jstate = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    rng = np.random.default_rng(1)
    clipped = []
    for _ in range(7):
        g = jax.tree.map(lambda a: (grad_scale * rng.standard_normal(
            a.shape)).astype(np.float32), _np_tree(jparams))
        tg = tree_map(lambda a: torch.from_numpy(np.array(a)), g)
        params, state, m = opt.adamw_update(cfg, params, tg, state)
        jparams, jstate, jm = jopt.adamw_update(jcfg, jparams, g, jstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        clipped.append(float(m["grad_norm"]) > cfg.grad_clip)
        _assert_tree_close(params, jparams, 1e-6, "params")
        _assert_tree_close(state["mu"], jstate["mu"], 1e-6, "mu")
        _assert_tree_close(state["nu"], jstate["nu"], 1e-6, "nu")
        assert int(state["step"]) == int(jstate["step"])
    assert all(clipped) if grad_scale > 1 else not any(clipped)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_five_training_steps_match(name):
    jm, jparams, m, params = _models(name)
    pc = dict(vocab=m.cfg.vocab, seq_len=SEQ, batch_size=2, seed=3,
              n_image_tokens=m.cfg.n_image_tokens, d_model=m.cfg.d_model)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    lines = []
    state = train(m, params, iter(SyntheticCorpus(PipelineConfig(**pc))), 5,
                  opt.AdamWConfig(**kw), log_every=1, log_fn=lines.append)
    jstate = jloop.train(jm, jparams, iter(JCorpus(JPipelineConfig(**pc))), 5,
                         jopt.AdamWConfig(**kw), log_every=1,
                         log_fn=lambda s: None)
    assert state.step == jstate.step == 5
    assert len(state.history) == len(jstate.history) == 5 == len(lines)
    np.testing.assert_allclose(state.history, jstate.history, rtol=1e-4)
    assert lines[0].startswith("step     1 loss ")


def test_train_step_leaves_its_inputs_alone():
    _, _, m, params = _models("qwen2-0.5b")
    before = ckpt._flatten(params)
    step = make_train_step(m, opt.AdamWConfig())
    batch = {k: torch.as_tensor(v) for k, v in _batch(m.cfg).items()}
    new, state, metrics = step(params, opt.init_opt_state(params), batch)
    after = ckpt._flatten(params)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert not any(p.requires_grad for p in opt.leaves(params))
    assert not any(p.requires_grad for p in opt.leaves(new))
    assert int(state["step"]) == 1 and np.isfinite(float(metrics["loss"]))


def _trained_state(name):
    """Params and optimizer state after two updates, both packages'."""
    _, jparams, _, params = _models(name)
    cfg = opt.AdamWConfig(warmup_steps=1, total_steps=4)
    jcfg = jopt.AdamWConfig(warmup_steps=1, total_steps=4)
    state, jstate = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    rng = np.random.default_rng(2)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), _np_tree(jparams))
        params, state, _ = opt.adamw_update(
            cfg, params, tree_map(lambda a: torch.from_numpy(np.array(a)), g),
            state)
        jparams, jstate, _ = jopt.adamw_update(jcfg, jparams, g, jstate)
    return params, state, jparams, jstate


def _bit_equal(got, want):
    got, want = _by_path(got), _by_path(want)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert np.array_equal(got[path], want[path]), path


@pytest.mark.parametrize("name", LM_ARCHS)
def test_port_checkpoint_loads_in_the_reference(tmp_path, name):
    params, state, jparams, jstate = _trained_state(name)
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, params, state, 2, {"arch": name})
    p2, o2, step, meta = jckpt.load_checkpoint(path, jparams, jstate)
    assert step == 2 and meta == {"arch": name}
    _bit_equal(params, p2)
    _bit_equal(state, o2)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_reference_checkpoint_loads_in_the_port(tmp_path, name):
    params, state, jparams, jstate = _trained_state(name)
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, jparams, jstate, 2, {"arch": name})
    p2, o2, step, meta = ckpt.load_checkpoint(path, params, state)
    assert step == 2 and meta == {"arch": name}
    _bit_equal(p2, jparams)
    _bit_equal(o2, jstate)
    assert all(t.dtype == torch.float32 for t in opt.leaves(p2))
    assert o2["step"].dtype == torch.int32
    # the parameters alone, as the legacy serve path restores them
    p3, o3, _, _ = ckpt.load_checkpoint(path, params)
    assert o3 is None
    _bit_equal(p3, jparams)


def test_launcher_trains_on_the_cpu_and_the_reference_loads_it(tmp_path):
    path = str(tmp_path / "w.npz")
    lines = []
    state = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                           "3", "--batch", "2", "--seq", "16", "--device",
                           "cpu", "--log-every", "1", "--checkpoint", path],
                          log_fn=lines.append)
    assert state.step == 3 and len(state.history) == 3
    assert all(np.isfinite(state.history))
    assert lines[-1] == f"saved {path}"
    jm = JaxLM(jax_config("qwen2-0.5b").reduced())
    jparams = jm.init_params(jax.random.PRNGKey(0))
    p, o, step, meta = jckpt.load_checkpoint(
        path, jparams, jopt.init_opt_state(jparams))
    assert step == 3 and meta == {"arch": "qwen2-0.5b-reduced"}
    _bit_equal(state.params, p)
    _bit_equal(state.opt, o)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "llama-3.2-vision-11b"])
def test_launcher_trains_moe_and_cross_attention_models(tmp_path, name):
    """``--arch`` an MoE model and the vision model (its batches carry
    ``image_embeds``) train through the launcher on the CPU, and the
    reference loads the checkpoint."""
    path = str(tmp_path / "w.npz")
    state = launcher.main(["--arch", name, "--reduced", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--log-every", "1", "--checkpoint", path],
                          log_fn=lambda line: None)
    assert state.step == 3 and len(state.history) == 3
    assert all(np.isfinite(state.history))
    jm = JaxLM(jax_config(name).reduced())
    jparams = jm.init_params(jax.random.PRNGKey(0))
    p, o, step, _ = jckpt.load_checkpoint(
        path, jparams, jopt.init_opt_state(jparams))
    assert step == 3
    _bit_equal(state.params, p)


def test_launcher_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])


def test_launcher_flags_are_the_references():
    """Every flag of the reference's launcher, with its default."""
    import argparse

    from repro.launch import train as jlauncher

    seen = {}

    def capture(self, argv=None):
        seen["parser"] = self
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jlauncher.main([])
    ref_defaults = {a.dest: a.default for a in seen["parser"]._actions}
    ours = {a.dest: a.default for a in launcher.build_parser()._actions}
    for dest, default in ref_defaults.items():
        assert ours[dest] == default, dest
    assert set(ours) - set(ref_defaults) == {"device", "log_every"}


def test_unbound_forward_equals_per_repeat_selects():
    """``forward`` unbinds each stacked leaf once; its logits equal the
    per-repeat select it replaced, and under autograd the gradients of a
    depth-3 stack are those of the select."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              n_layers=3, pattern=get_config(
                                  "qwen2-0.5b").reduced().pattern[:1])
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    from repro_torch.arch import layers as L

    toks = torch.as_tensor(_batch(cfg)["tokens"])
    wq = params["blocks"][0]["attn"]["wq"].requires_grad_(True)
    logits, _ = m.forward(params, toks)
    x = params["embed"][toks]
    pos = m._positions(*toks.shape)
    for r in range(cfg.n_repeats):
        x, _ = m._apply_layer(x, tree_map(lambda a: a[r],
                                          params["blocks"][0]),
                              cfg.pattern[0], pos, None)
    want = L.rmsnorm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]
    assert torch.equal(logits, want)
    g = torch.randn(logits.shape, generator=torch.Generator().manual_seed(2))
    got, = torch.autograd.grad(logits, wq, g)
    expect, = torch.autograd.grad(want, wq, g)
    assert got.shape == (3,) + tuple(wq.shape[1:])
    torch.testing.assert_close(got, expect)

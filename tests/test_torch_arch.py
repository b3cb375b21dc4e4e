"""The port's LM architecture (``repro_torch.arch``) against the JAX
package's ``repro.arch`` on the same numpy-seeded inputs and parameters:
each layer within 1e-5, the whole model (forward, prefill, decode) of all
ten configurations within 1e-4 with the reference's parameters installed
by the converter (the MoE and cross-attention layers included; the MoE
layer alone in ``tests/test_torch_moe.py``), the layer order of a
two-repeat pattern, and the reference's own model properties (decode
matches forward, prefill then decode, sliding window) mirrored on the
port."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as JL  # noqa: E402
from repro.arch import ssm as JS  # noqa: E402
from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.arch import layers as L  # noqa: E402
from repro_torch.arch import ssm as S  # noqa: E402
from repro_torch.arch.convert import (install_params,  # noqa: E402
                                     params_to_numpy)
from repro_torch.arch.model import TransformerLM, tree_map  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = ARCHS     # all ten, reduced


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


# -- layers ------------------------------------------------------------------


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, (2, 5, 32)), _rand(rng, (32,))
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 300, (2, 7))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _attn_cfg(window=0, bias=True):
    cfg = jax_config("qwen2-0.5b").reduced(d_model=64)
    return dataclasses.replace(cfg, sliding_window=window, qkv_bias=bias)


def _attn_params(cfg, seed, cross=False):
    p = _np_tree(JL.init_attention(jax.random.PRNGKey(seed), cfg,
                                   cross=cross))
    rng = np.random.default_rng(seed)
    # nonzero biases, so the bias paths are exercised
    return {k: (v + _rand(rng, v.shape, 0.1) if k.startswith("b") else v)
            for k, v in p.items()}


@pytest.mark.parametrize("window", [0, 3])
def test_self_attention_matches(window):
    cfg = _attn_cfg(window)
    p = _attn_params(cfg, 2)
    rng = np.random.default_rng(2)
    B, S_ = 2, 11
    x = _rand(rng, (B, S_, cfg.d_model))
    pos = np.broadcast_to(np.arange(S_)[None], (B, S_))
    got = L.attention(_torch_tree(p), torch.from_numpy(x), cfg,
                      torch.from_numpy(pos.copy()))
    want = JL.attention(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                        JL.causal_mask(S_, window))
    _close(got, want)


@pytest.mark.parametrize("window", [0, 4])
def test_causal_mask_matches(window):
    np.testing.assert_array_equal(L.causal_mask(9, window).numpy(),
                                  np.asarray(JL.causal_mask(9, window)))


def test_cross_attention_matches():
    cfg = _attn_cfg(bias=False)
    p = _attn_params(cfg, 3, cross=True)
    rng = np.random.default_rng(3)
    x, enc = _rand(rng, (2, 6, cfg.d_model)), _rand(rng, (2, 9, cfg.d_model))
    got = L.attention(_torch_tree(p), torch.from_numpy(x), cfg, None,
                      kv=torch.from_numpy(enc))
    want = JL.attention(p, jnp.asarray(x), cfg, None, None,
                        kv=jnp.asarray(enc))
    _close(got, want)


@pytest.mark.parametrize("window,pos", [(0, [5, 9]), (4, [2, 10])])
def test_attention_with_cache_matches(window, pos):
    cfg = _attn_cfg(window)
    p = _attn_params(cfg, 4)
    rng = np.random.default_rng(4)
    B, T = 2, (window or 12)
    x = _rand(rng, (B, 1, cfg.d_model))
    cache = {k: _rand(rng, (B, T, cfg.n_kv_heads, cfg.d_head))
             for k in ("k", "v")}
    tcache = _torch_tree(cache)
    got, new = L.attention_with_cache(_torch_tree(p), torch.from_numpy(x),
                                      cfg, tcache, torch.tensor(pos))
    want, jnew = JL.attention_with_cache(
        p, jnp.asarray(x), cfg, jax.tree.map(jnp.asarray, cache),
        jnp.asarray(pos))
    _close(got, want)
    assert new is tcache                     # updated in place
    for k in ("k", "v"):
        _close(new[k], jnew[k])


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches(mlp_type):
    cfg = dataclasses.replace(_attn_cfg(), mlp_type=mlp_type)
    p = _np_tree(JL.init_mlp(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(5)
    p = {k: v + _rand(rng, v.shape, 0.1) for k, v in p.items()}
    x = _rand(rng, (2, 3, cfg.d_model))
    _close(L.mlp(_torch_tree(p), torch.from_numpy(x), cfg),
           JL.mlp(p, jnp.asarray(x), cfg))


def _ssm_setup(seed):
    cfg = jax_config("mamba2-130m").reduced()
    p = _np_tree(JS.init_ssm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    # non-trivial A, D, dt bias and norm, so each term is exercised
    for k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        p[k] = p[k] + _rand(rng, p[k].shape, 0.3)
    return cfg, p, rng


def test_ssm_block_matches():
    cfg, p, rng = _ssm_setup(6)
    x = _rand(rng, (2, 2 * cfg.ssm_chunk, cfg.d_model))
    out, cache = S.ssm_block(_torch_tree(p), torch.from_numpy(x), cfg,
                             return_cache=True)
    jout, jcache = JS.ssm_block(p, jnp.asarray(x), cfg, return_cache=True)
    _close(out, jout)
    for k in ("state", "conv"):
        _close(cache[k], jcache[k])
    out2, final = S.ssm_block(_torch_tree(p), torch.from_numpy(x), cfg)
    _close(out2, jout)
    _close(final, jcache["state"])


def test_ssm_decode_matches():
    cfg, p, rng = _ssm_setup(7)
    B = 3
    x = _rand(rng, (B, 1, cfg.d_model))
    jc = JS.init_ssm_cache(cfg, B)
    cache = {k: _rand(rng, v.shape, 0.5) for k, v in jc.items()}
    out, new = S.ssm_decode(_torch_tree(p), torch.from_numpy(x), cfg,
                            _torch_tree(cache))
    jout, jnew = JS.ssm_decode(p, jnp.asarray(x), cfg,
                               jax.tree.map(jnp.asarray, cache))
    _close(out, jout)
    for k in ("state", "conv"):
        _close(new[k], jnew[k])


# -- the model ---------------------------------------------------------------


def _models(name, **over):
    jcfg = dataclasses.replace(jax_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jm = JaxLM(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    install_params(params, _np_tree(jparams))
    return jm, jparams, m, params


def _tokens(cfg, B, S_, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S_))


def _image(cfg, B, seed=0):
    """(B, n_image_tokens, D) image embeddings for a model with
    cross-attention layers, else None."""
    if not cfg.n_image_tokens:
        return None
    return _rand(np.random.default_rng(seed + 100),
                 (B, cfg.n_image_tokens, cfg.d_model))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_model_forward_matches(name):
    jm, jparams, m, params = _models(name)
    toks, img = _tokens(m.cfg, 2, 32), _image(m.cfg, 2)
    logits, aux = m.forward(params, torch.from_numpy(toks), _t(img))
    jlogits, jaux = jm.forward(jparams, jnp.asarray(toks), _j(img))
    assert tuple(logits.shape) == (2, 32, m.cfg.vocab)
    assert (float(aux) == 0.0) == (not m.cfg.n_experts)
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_model_prefill_and_decode_match(name):
    jm, jparams, m, params = _models(name)
    B, S_, cache_len = 2, 16, 24
    toks, img = _tokens(m.cfg, B, S_ + 3, seed=1), _image(m.cfg, B, 1)
    lg, caches = m.prefill(params, torch.from_numpy(toks[:, :S_]), _t(img),
                           cache_len=cache_len)
    jlg, jcaches = jm.prefill(jparams, jnp.asarray(toks[:, :S_]), _j(img),
                              cache_len=cache_len)
    _close(lg, jlg, MODEL_TOL)
    for c, jc in zip(caches, jcaches):
        assert set(c) == set(jc)
        for k in c:
            _close(c[k], jc[k], MODEL_TOL)
    for t in range(S_, S_ + 3):
        pos = np.full(B, t)
        lg, caches = m.decode_step(params, torch.from_numpy(toks[:, t]),
                                   caches, torch.from_numpy(pos))
        jlg, jcaches = jm.decode_step(jparams, jnp.asarray(toks[:, t]),
                                      jcaches, jnp.asarray(pos))
        _close(lg, jlg, MODEL_TOL)


def _ample(name):
    """The reduced config with ``capacity_factor=8.0``, so that no MoE
    layer drops a token and a decode step (one group of B rows) computes
    what the sequence (B groups) does, as the reference's own test sets
    it."""
    return dataclasses.replace(get_config(name).reduced(),
                               capacity_factor=8.0)


def _fill_cross_caches(m, params, caches, img):
    """The cross layers' caches of ``init_cache``, zeros, filled with the
    projected image K/V (the reference's test does the same)."""
    cfg = m.cfg
    for spec, blk, cache in zip(cfg.pattern, params["blocks"], caches):
        if spec.mixer == "cross_attn":
            for key, w in (("k", "wk"), ("v", "wv")):
                proj = img[None] @ blk["attn"][w][:, None]   # (R, B, T, KV*Dh)
                cache[key].copy_(proj.view(cache[key].shape))
    return caches


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_forward(name):
    """Mirror of the reference's property test, on the port alone."""
    m = TransformerLM(_ample(name), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    B, S_ = 2, 16
    toks = torch.from_numpy(_tokens(m.cfg, B, S_, seed=2))
    img = _t(_image(m.cfg, B, 2))
    full, _ = m.forward(params, toks, img)
    caches = m.init_cache(B, S_)
    if img is not None:
        caches = _fill_cross_caches(m, params, caches, img)
    outs = []
    for t in range(S_):
        lg, caches = m.decode_step(params, toks[:, t], caches, t)
        outs.append(lg)
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < 5e-3, err


@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_then_decode_continues(name):
    m = TransformerLM(_ample(name), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(2))
    B, S_, extra = 2, 16, 16      # forward's length: a multiple of the chunk
    toks = torch.from_numpy(_tokens(m.cfg, B, S_ + extra, seed=3))
    img = _t(_image(m.cfg, B, 3))
    full, _ = m.forward(params, toks, img)
    lg, caches = m.prefill(params, toks[:, :S_], img, cache_len=S_ + extra)
    _close(lg, full[:, S_ - 1], dict(rtol=2e-3, atol=2e-3))
    for t in range(S_, S_ + extra):
        lg, caches = m.decode_step(params, toks[:, t], caches, t)
        _close(lg, full[:, t], dict(rtol=2e-3, atol=2e-3))


def test_sliding_window_attention_masks_far_context():
    """With window W, logits for position t must not depend on tokens
    earlier than t - W + 1."""
    cfg = get_config("qwen2-0.5b").reduced().with_sliding_window(4)
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(3))
    t1 = torch.from_numpy(_tokens(cfg, 1, 16, seed=4))
    t2 = t1.clone()
    t2[:, 0:4] = (t1[:, 0:4] + 7) % cfg.vocab
    l1, _ = m.forward(params, t1)
    l2, _ = m.forward(params, t2)
    _close(l1[:, -1], l2[:, -1], dict(rtol=1e-4, atol=1e-4))
    t3 = t1.clone()
    t3[:, -2] = (t1[:, -2] + 7) % cfg.vocab
    l3, _ = m.forward(params, t3)
    assert float((l3[:, -1] - l1[:, -1]).abs().max()) > 1e-4


def test_sliding_window_model_matches_jax():
    jm, jparams, m, params = _models("qwen2-0.5b", sliding_window=5)
    toks = _tokens(m.cfg, 2, 20, seed=5)
    logits, _ = m.forward(params, torch.from_numpy(toks))
    _close(logits, jm.forward(jparams, jnp.asarray(toks))[0], MODEL_TOL)


# -- converter and scope -----------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS)
def test_converter_round_trip(name):
    jm, jparams, m, params = _models(name)
    back = params_to_numpy(params)
    flat, tdef = jax.tree.flatten(_np_tree(jparams))
    flat_back, tdef_back = jax.tree.flatten(back)
    assert tdef == tdef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    fresh = m.init_params(torch.Generator().manual_seed(9))
    install_params(fresh, back)
    for a, b in zip(jax.tree.leaves(params_to_numpy(fresh)), flat):
        np.testing.assert_array_equal(a, b)


def test_converter_rejects_unknown_keys_and_shapes():
    m = TransformerLM(get_config("qwen2-0.5b").reduced(), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="wx"):
        install_params(params, {"blocks": ({"attn": {"wx": np.zeros(1)}},
                                           {})})
    with pytest.raises(ValueError, match="shape"):
        install_params(params, {"final_norm": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="sequence"):
        install_params(params, {"blocks": ({}, {}, {})})


def test_configs_are_the_references():
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))


def test_unknown_layer_specs_raise():
    from repro_torch.arch.config import LayerSpec

    cfg = get_config("qwen2-0.5b").reduced()
    for spec, what in ((LayerSpec("conv", "dense"), "mixer 'conv'"),
                       (LayerSpec("attn", "glu"), "ffn 'glu'")):
        with pytest.raises(ValueError, match=what):
            TransformerLM(dataclasses.replace(cfg, pattern=(spec,) * 2),
                          device="cpu")


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "llama-3.2-vision-11b"])
def test_two_repeat_layer_order_matches(name):
    """Two repeats of a pattern of three (Jamba: SSM, SSM with MoE,
    attention) or two (the vision model: cross-attention, attention)
    layers: ``forward`` runs them repeat-major and ``prefill`` and
    ``decode_step`` pattern-major, as the reference's entry points of the
    same names do, so each is held to its own counterpart, never one to
    the other."""
    base = jax_config(name).reduced()
    over = dict(n_layers=2 * len(base.pattern))
    jm, jparams, m, params = _models(name, **over)
    assert m.cfg.n_repeats == 2
    B, S_ = 2, 16
    toks, img = _tokens(m.cfg, B, S_ + 2, seed=6), _image(m.cfg, B, 6)
    logits, aux = m.forward(params, torch.from_numpy(toks[:, :S_]), _t(img))
    jlogits, jaux = jm.forward(jparams, jnp.asarray(toks[:, :S_]), _j(img))
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)
    lg, caches = m.prefill(params, torch.from_numpy(toks[:, :S_]), _t(img),
                           cache_len=S_ + 2)
    jlg, jcaches = jm.prefill(jparams, jnp.asarray(toks[:, :S_]), _j(img),
                              cache_len=S_ + 2)
    _close(lg, jlg, MODEL_TOL)
    for t in range(S_, S_ + 2):
        pos = np.full(B, t)
        lg, caches = m.decode_step(params, torch.from_numpy(toks[:, t]),
                                   caches, torch.from_numpy(pos))
        jlg, jcaches = jm.decode_step(jparams, jnp.asarray(toks[:, t]),
                                      jcaches, jnp.asarray(pos))
        _close(lg, jlg, MODEL_TOL)
        for c, jc in zip(caches, jcaches):
            for k in c:
                _close(c[k], jc[k], MODEL_TOL)

"""The port's LM architecture (``repro_torch.arch``) against the JAX
package's ``repro.arch`` on the same numpy-seeded inputs and parameters:
each layer within 1e-5, the whole model (forward, prefill, decode) within
1e-4 with the reference's parameters installed by the converter, and the
reference's own model properties (decode matches forward, prefill then
decode, sliding window) mirrored on the port."""

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
LM_ARCHS = ["qwen2-0.5b", "mamba2-130m"]


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


@pytest.mark.parametrize("name", LM_ARCHS)
def test_model_forward_matches(name):
    jm, jparams, m, params = _models(name)
    toks = _tokens(m.cfg, 2, 32)
    logits, aux = m.forward(params, torch.from_numpy(toks))
    jlogits, _ = jm.forward(jparams, jnp.asarray(toks))
    assert tuple(logits.shape) == (2, 32, m.cfg.vocab)
    assert float(aux) == 0.0
    _close(logits, jlogits, MODEL_TOL)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_model_prefill_and_decode_match(name):
    jm, jparams, m, params = _models(name)
    B, S_, cache_len = 2, 16, 24
    toks = _tokens(m.cfg, B, S_ + 3, seed=1)
    lg, caches = m.prefill(params, torch.from_numpy(toks[:, :S_]),
                           cache_len=cache_len)
    jlg, jcaches = jm.prefill(jparams, jnp.asarray(toks[:, :S_]),
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


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_forward(name):
    """Mirror of the reference's property test, on the port alone."""
    m = TransformerLM(get_config(name).reduced(), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    B, S_ = 2, 16
    toks = torch.from_numpy(_tokens(m.cfg, B, S_, seed=2))
    full, _ = m.forward(params, toks)
    caches = m.init_cache(B, S_)
    outs = []
    for t in range(S_):
        lg, caches = m.decode_step(params, toks[:, t], caches, t)
        outs.append(lg)
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < 5e-3, err


@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_then_decode_continues(name):
    m = TransformerLM(get_config(name).reduced(), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(2))
    B, S_, extra = 2, 16, 16      # forward's length: a multiple of the chunk
    toks = torch.from_numpy(_tokens(m.cfg, B, S_ + extra, seed=3))
    full, _ = m.forward(params, toks)
    lg, caches = m.prefill(params, toks[:, :S_], cache_len=S_ + extra)
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


@pytest.mark.parametrize("name,missing", [
    ("olmoe-1b-7b", "moe"), ("jamba-v0.1-52b", "moe"),
    ("llama-3.2-vision-11b", "cross_attn")])
def test_unported_layer_specs_raise(name, missing):
    with pytest.raises(NotImplementedError, match=missing):
        TransformerLM(get_config(name).reduced(), device="cpu")

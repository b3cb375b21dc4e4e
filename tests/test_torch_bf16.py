"""bfloat16 in the port against the JAX package in bfloat16, on the CPU.

The reference builds a model in bf16 with ``TransformerLM(cfg,
dtype=jnp.bfloat16)``; the port with ``TransformerLM(cfg,
torch.bfloat16)``. Held here, with inputs from a numpy seed:

- every leaf of ``param_specs()`` and ``cache_specs()`` of all ten
  configurations has the reference's shape and dtype;
- the reference's bf16 parameters cross over bit for bit, and back;
- on reduced Qwen2-0.5B, Mamba2-130m (two layers, narrow widths, two
  SSD chunks), Granite-MoE-1B-A400M and Llama-3.2-Vision-11B (its
  cross-attention layer fed bf16 image embeddings in both packages), the
  port's bf16 ``forward``, ``prefill`` and ``decode_step`` logits are
  within ``2 e`` of the reference's bf16 logits, where ``e`` is the
  largest gap between the reference's own bf16 and fp32 logits on the
  same bf16-exact parameters (the resolution of bf16 for that model and
  input: two packages that round at other places can differ by about as
  much again);
- the greedy tokens of the two wave engines are equal, except where the
  reference's own top-2 margin is within ``2 e`` (the vision model, which
  the port's wave engine refuses, through ``prefill`` and
  ``decode_step``);
- the kernels' plain versions in bf16 against the reference's: flash
  attention against its Pallas kernel in interpret mode within the
  reference test's 3e-2 (``tests/test_kernels.py``), the SSD scan against
  the reference model's plain ``ssd_scan`` over two chunks;
- argmax over tied bf16 logits takes the first index in both packages;
- a dtype other than float32 and bfloat16 is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch import ssm as JS  # noqa: E402
from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import lm_wave as jwave  # noqa: E402
from repro_torch.arch.convert import (install_params,  # noqa: E402
                                     params_to_numpy)
from repro_torch.arch.model import TransformerLM, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serve import lm_wave  # noqa: E402

BF16 = torch.bfloat16
E_FACTOR = 2          # the bar: 2 e (module docstring)
MODELS = ("qwen2-0.5b", "mamba2-130m", "granite-moe-1b-a400m",
          "llama-3.2-vision-11b")


def _flat(tree, path=""):
    """{path: leaf} of a tree of dicts (sorted keys) and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}.{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def _shape_dtype(leaf):
    return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")


@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_specs_match_the_reference_in_bf16(name):
    cfg, jcfg = get_config(name), jax_config(name)
    model = TransformerLM(cfg, BF16, device="meta")
    jmodel = JaxLM(jcfg, dtype=jnp.bfloat16)
    for got, want in ((model.param_specs(), jmodel.param_specs()),
                      (model.cache_specs(2, 64), jmodel.cache_specs(2, 64))):
        got, want = _flat(got), _flat(want)
        assert list(got) == list(want)
        assert {k: _shape_dtype(v) for k, v in got.items()} == \
            {k: _shape_dtype(v) for k, v in want.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """A reduced model in both packages: the reference's bf16 parameters,
    the same upcast to fp32, and the port's bf16 model with them
    installed."""
    name = request.param
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    j16, j32 = JaxLM(jcfg, dtype=jnp.bfloat16), JaxLM(jcfg)
    p16 = j16.init_params(jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    model = TransformerLM(cfg, BF16, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    install_params(params, jax.tree.map(np.asarray, p16))
    # bf16-exact image embeddings for a model with cross-attention layers
    img = None if not cfg.n_image_tokens else np.asarray(jnp.asarray(
        np.random.default_rng(9).standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)), jnp.bfloat16).astype(
                jnp.float32))
    return {"name": name, "cfg": cfg, "j16": j16, "j32": j32, "p16": p16,
            "p32": p32, "model": model, "params": params, "img": img}


def _images(pair, rows=slice(None)):
    """The pair's image embeddings for the port and for the reference in
    bf16 and fp32 (all None for a model without cross-attention)."""
    img = pair["img"]
    if img is None:
        return None, None, None
    img = img[rows]
    return (torch.from_numpy(np.array(img)).to(BF16),
            jnp.asarray(img, jnp.bfloat16), jnp.asarray(img))


def test_reference_bf16_weights_cross_over_bit_exact(pair):
    want = _flat(jax.tree.map(np.asarray, pair["p16"]))
    got = _flat(pair["params"])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.dtype == BF16, k
        np.testing.assert_array_equal(_bits(t), want[k].view(np.int16),
                                      err_msg=k)
    # and back: params_to_numpy's uint16 bits install bit for bit
    fresh = pair["model"].init_params(torch.Generator().manual_seed(5))
    install_params(fresh, params_to_numpy(pair["params"]))
    for k, t in _flat(fresh).items():
        np.testing.assert_array_equal(_bits(t), _bits(got[k]), err_msg=k)


def test_install_refuses_a_leaf_of_another_dtype(pair):
    with pytest.raises(ValueError, match="float32 leaf where the model has "
                                         "torch.bfloat16"):
        install_params(pair["model"].init_params(
            torch.Generator().manual_seed(0)),
            jax.tree.map(np.asarray, pair["p32"]))
    fp32 = TransformerLM(pair["cfg"], device="cpu")
    with pytest.raises(ValueError, match="bfloat16 leaf where the model has "
                                         "torch.float32"):
        install_params(fp32.init_params(torch.Generator().manual_seed(0)),
                       jax.tree.map(np.asarray, pair["p16"]))


def _np32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def runs(pair):
    """Each entry point's logits in both packages: (port bf16, reference
    bf16, reference fp32), on B = 2 prompts of 32 tokens (two SSD chunks
    of 16) and one decode step after them."""
    rng = np.random.default_rng(0)
    cfg = pair["cfg"]
    B, S = 2, 32
    toks = rng.integers(0, cfg.vocab, (B, S))
    tok = rng.integers(0, cfg.vocab, (B,))
    j16, j32, p16, p32 = pair["j16"], pair["j32"], pair["p16"], pair["p32"]
    m, params = pair["model"], pair["params"]
    ti, ji16, ji32 = _images(pair)
    out = {}
    with torch.no_grad():
        out["forward"] = (
            m.forward(params, torch.from_numpy(toks), ti)[0],
            j16.forward(p16, jnp.asarray(toks), ji16)[0],
            j32.forward(p32, jnp.asarray(toks), ji32)[0])
        lt, ct = m.prefill(params, torch.from_numpy(toks), ti, cache_len=40)
        l16, c16 = j16.prefill(p16, jnp.asarray(toks), ji16, cache_len=40)
        l32, c32 = j32.prefill(p32, jnp.asarray(toks), ji32, cache_len=40)
        out["prefill"] = (lt, l16, l32)
        out["decode_step"] = (
            m.decode_step(params, torch.from_numpy(tok), ct, S)[0],
            j16.decode_step(p16, jnp.asarray(tok), c16, S)[0],
            j32.decode_step(p32, jnp.asarray(tok), c32, S)[0])
    return out


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step"])
def test_bf16_logits_within_twice_the_references_own_bf16_gap(runs, entry):
    port, ref16, ref32 = runs[entry]
    assert port.dtype == BF16
    port, ref16, ref32 = _np32(port.float()), _np32(ref16), _np32(ref32)
    assert np.isfinite(port).all()
    e = np.abs(ref16 - ref32).max()
    assert 0 < e < 0.1 * np.abs(ref32).max()   # bf16 resolves the model
    assert np.abs(port - ref16).max() <= E_FACTOR * e


def test_greedy_tokens_match_the_reference_but_at_near_ties(pair, runs):
    """Both wave engines, bf16, six prompts of two lengths and eight new
    tokens; a stream may differ only where the reference's own top-2
    margin at the first differing token is within 2 e (e of the forward
    entry point). The vision model, which the port's engine refuses (its
    prefill needs image embeddings), decodes two prompts greedily through
    both packages' ``prefill`` and ``decode_step`` instead."""
    port, ref16, ref32 = runs["forward"]
    e = float(np.abs(_np32(ref16) - _np32(ref32)).max())
    cfg = pair["cfg"]
    rng = np.random.default_rng(1)
    if cfg.n_image_tokens:
        with pytest.raises(ValueError, match="cross-attention"):
            lm_wave.ServeEngine(pair["model"], pair["params"], cache_len=48,
                                device="cpu")
        prompts = rng.integers(0, cfg.vocab, (2, 16)).tolist()
        outs, jouts = _greedy_with_images(pair, prompts, 8)
    else:
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.choice((16, 32), 6)]
        outs, _ = lm_wave.ServeEngine(pair["model"], pair["params"],
                                      cache_len=48, device="cpu").generate(
                                          prompts, max_new=8)
        jouts, _ = jwave.ServeEngine(pair["j16"], pair["p16"],
                                     cache_len=48).generate(prompts,
                                                            max_new=8)
    for r, (prompt, a, b) in enumerate(zip(prompts, outs, jouts)):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = _reference_logits_after(pair, prompt, b[:t], r)
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] <= E_FACTOR * e, (t, a, b)


def _greedy_with_images(pair, prompts, n):
    """Greedy streams of ``n`` tokens after each prompt (one length, one
    image each) through the port's and the reference's bf16 entry
    points."""
    m, params, j16, p16 = pair["model"], pair["params"], pair["j16"], \
        pair["p16"]
    ti, ji, _ = _images(pair)
    toks = np.asarray(prompts)
    S = toks.shape[1]
    with torch.no_grad():
        lt, ct = m.prefill(params, torch.from_numpy(toks), ti,
                           cache_len=S + n)
        outs = []
        for i in range(n):
            tok = lt.argmax(-1)
            outs.append(tok.tolist())
            lt, ct = m.decode_step(params, tok, ct, S + i)
    lj, cj = j16.prefill(p16, jnp.asarray(toks), ji, cache_len=S + n)
    jouts = []
    for i in range(n):
        tok = jnp.argmax(lj, -1)
        jouts.append(np.asarray(tok).tolist())
        lj, cj = j16.decode_step(p16, tok, cj, S + i)
    return [list(r) for r in zip(*outs)], [list(r) for r in zip(*jouts)]


def _reference_logits_after(pair, prompt, prefix, row=0) -> np.ndarray:
    """The reference's bf16 logits for the token after ``prompt +
    prefix``: its prefill of the prompt (with image ``row`` where the
    model has cross-attention), then a decode step a token."""
    j16, p16 = pair["j16"], pair["p16"]
    ji = _images(pair, slice(row, row + 1))[1]
    logits, caches = j16.prefill(p16, jnp.asarray([prompt]), ji,
                                 cache_len=len(prompt) + len(prefix) + 1)
    for i, tok in enumerate(prefix):
        logits, caches = j16.decode_step(p16, jnp.asarray([tok]), caches,
                                         len(prompt) + i)
    return _np32(logits[0])


def test_flash_attention_plain_bf16_against_the_reference_kernel():
    """The reference's Pallas kernel in bf16, as ``tests/test_kernels.py``
    runs it (interpret mode, (2, 32, 16), blocks of 16), against the
    port's plain version on the same bf16 inputs: within 3e-2."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((2, 32, 16)) for _ in range(3)]
    for causal in (True, False):
        want = jops.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal=causal,
            block_q=16, block_k=16)
        q, k, v = (torch.from_numpy(a.astype(np.float32)).to(BF16)[:, :, None]
                   for a in arrays)          # (B, S, 1 head, D)
        got = ref.flash_attention_ref(q, k, v, causal)
        assert got.dtype == BF16
        np.testing.assert_allclose(_np32(got.float()[:, :, 0]), _np32(want),
                                   rtol=3e-2, atol=3e-2)


def test_ssd_scan_plain_bf16_against_the_references_scan():
    """The reference model's scan (plain jnp in the model's dtype) and the
    port's plain version on the same bf16 inputs over two chunks: y within
    3e-2 of its largest magnitude, the fp32 final state within 1e-2 of
    its largest magnitude (each of the two rounds its einsums' outputs to
    bf16 in its own contraction order)."""
    rng = np.random.default_rng(2)
    b, l, h, p, g, n, chunk = 2, 32, 4, 16, 1, 16, 16
    x = rng.standard_normal((b, l, h, p))
    dt = np.abs(rng.standard_normal((b, l, h))) * 0.5
    A = -np.abs(rng.standard_normal(h)) * 0.5
    Bm = rng.standard_normal((b, l, g, n))
    C = rng.standard_normal((b, l, g, n))
    s0 = rng.standard_normal((b, h, p, n))
    for init in (None, s0):
        jy, jf = JS.ssd_scan(
            *(jnp.asarray(a, jnp.bfloat16) for a in (x, dt)),
            jnp.asarray(A, jnp.float32),
            *(jnp.asarray(a, jnp.bfloat16) for a in (Bm, C)), chunk,
            None if init is None else jnp.asarray(init, jnp.bfloat16))
        ty = [torch.from_numpy(a.astype(np.float32)).to(BF16)
              for a in (x, dt, Bm, C)]
        y, fin = ref.ssd_scan_ref(
            ty[0], ty[1], torch.from_numpy(A.astype(np.float32)), ty[2],
            ty[3], chunk,
            None if init is None else
            torch.from_numpy(init.astype(np.float32)).to(BF16))
        assert (y.dtype, fin.dtype) == (BF16, torch.float32)
        jy, jf = _np32(jy), _np32(jf)
        assert np.abs(_np32(y.float()) - jy).max() <= 3e-2 * np.abs(jy).max()
        assert np.abs(fin.numpy() - jf).max() <= 1e-2 * np.abs(jf).max()


def test_argmax_of_tied_bf16_logits_takes_the_first_index():
    rows = np.array([[1.0, 3.0, 3.0, 2.0], [0.5, 0.5, 0.5, 0.5],
                     [-1.0, -2.0, 4.0, 4.0]], np.float32)
    # values that round to the same bf16: 1 + 2^-10 and 1 tie in bf16
    near = np.array([[1.0, 1.0 + 2.0 ** -10, 0.0]], np.float32)
    for arr in (rows, near):
        t = torch.from_numpy(arr).to(BF16)
        j = jnp.asarray(arr, jnp.bfloat16)
        got = torch.argmax(t, -1).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.argmax(j, -1)))
    assert torch.argmax(torch.from_numpy(near).to(BF16), -1).item() == 0


def test_the_bf16_path_loads_neither_jax_nor_ml_dtypes():
    """The port reads bf16 leaves by their bits: importing its model, the
    converter, the kernels and the wave engine loads neither package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; import repro_torch.arch.convert, "
            "repro_torch.arch.model, repro_torch.kernels.launches, "
            "repro_torch.serve.lm_wave, repro_torch.launch.dryrun; "
            "print(sorted(m for m in ('jax', 'ml_dtypes', 'repro') "
            "if m in sys.modules))")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_only_float32_and_bfloat16_models_are_built():
    cfg = get_config("qwen2-0.5b").reduced()
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            TransformerLM(cfg, dtype, device="cpu")
    assert TransformerLM(cfg, device="cpu").dtype == torch.float32


def test_wave_engine_serves_in_its_models_dtype(pair):
    """The decode pool is in the model's dtype; parameters of another
    dtype are refused, and so, in bf16 too, is a model with
    cross-attention layers."""
    if pair["cfg"].n_image_tokens:
        with pytest.raises(ValueError, match="cross-attention"):
            lm_wave.ServeEngine(pair["model"], pair["params"], device="cpu")
        return
    eng = lm_wave.ServeEngine(pair["model"], pair["params"], cache_len=48,
                              device="cpu")
    eng.generate([list(range(1, 17))], max_new=2)   # one SSD chunk
    pool = eng._decode(1).pool
    assert {t.dtype for c in pool for t in c.values()} == {BF16}
    fp32 = tree_map(lambda t: t.float(), pair["params"])
    with pytest.raises(ValueError, match="parameters of"):
        lm_wave.ServeEngine(pair["model"], fp32, device="cpu")

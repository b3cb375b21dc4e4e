"""Image embeddings of another dtype than the model's are refused, as the
reference refuses them.

The reference's bf16 Llama-3.2-Vision-11B raises ``TypeError`` in its
``forward``, ``prefill`` and ``loss`` when handed fp32 image embeddings
(it does not promote them). The port's raises ``ValueError`` naming both
dtypes, and takes the same embeddings once they are cast to bf16. Reduced
configurations, the reference's bf16 parameters in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.arch.convert import install_params  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

VISION = "llama-3.2-vision-11b"
ENTRIES = ("forward", "prefill", "loss")


@pytest.fixture(scope="module")
def vision():
    cfg, jcfg = get_config(VISION).reduced(), jax_config(VISION).reduced()
    jmodel = JaxLM(jcfg, dtype=jnp.bfloat16)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = TransformerLM(cfg, torch.bfloat16, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    install_params(params, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)
    return {"cfg": cfg, "jmodel": jmodel, "jparams": jparams,
            "model": model, "params": params, "tokens": tokens, "img": img}


def _call(entry, model, params, tokens, img):
    if entry == "forward":
        return model.forward(params, tokens, img)
    if entry == "prefill":
        return model.prefill(params, tokens, img, cache_len=16)
    return model.loss(params, {"tokens": tokens, "labels": tokens,
                               "image_embeds": img})


@pytest.mark.parametrize("entry", ENTRIES)
def test_bf16_vision_model_refuses_fp32_image_embeddings_as_the_reference(
        vision, entry):
    v = vision
    with pytest.raises(TypeError):
        _call(entry, v["jmodel"], v["jparams"], jnp.asarray(v["tokens"]),
              jnp.asarray(v["img"]))
    tokens = torch.from_numpy(v["tokens"]).long()
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        with torch.no_grad():
            _call(entry, v["model"], v["params"], tokens,
                  torch.from_numpy(v["img"]))


@pytest.mark.parametrize("entry", ENTRIES)
def test_bf16_vision_model_takes_image_embeddings_cast_to_bf16(vision,
                                                               entry):
    v = vision
    tokens = torch.from_numpy(v["tokens"]).long()
    img = torch.from_numpy(v["img"]).to(torch.bfloat16)
    with torch.no_grad():
        out = _call(entry, v["model"], v["params"], tokens, img)
    first = out if entry == "loss" else out[0]
    assert torch.isfinite(first.float()).all()


def test_fp32_vision_model_refuses_bf16_image_embeddings():
    cfg = get_config(VISION).reduced()
    model = TransformerLM(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    img = torch.zeros((1, cfg.n_image_tokens, cfg.d_model),
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16.*float32"):
        model.forward(params, torch.zeros((1, 4), dtype=torch.long), img)

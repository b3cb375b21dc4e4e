"""bf16 MoE in the port against the JAX package, on the CPU.

The reference's MoE layer sums in bf16 where it scatter-adds: its combine,
``zeros(bf16).at[tok].add(contrib)``, and the gradient of its dispatch
gather, ``jnp.take_along_axis``, both add a row's updates one at a time in
update order and round to bf16 after each add. The port sums those rows in
the same order (a token's experts ascending, which is the reference's
stable sort by expert) with the same rounding. Held here, with inputs from
a numpy seed:

- the port's plain gather backward in bf16 (``kernels/ref.py:
  gather_rows_bwd_ref``) is bit-equal to ``jax.grad`` of a bf16 ``jnp.take``
  on indices with repeats and negatives;
- the port's bf16 combine is bit-equal to the reference's scatter-add of
  the same contributions, in the reference's own order;
- reduced Granite-MoE-1B-A400M and OLMoE-1B-7B ``moe`` layers in bf16 (16
  experts, so that a token chooses 8 of them): the routing equals the
  reference's but where the bf16 tie rule allows a flip (the logit gap
  within two bf16 ulps of the larger logit), and ``y``, ``aux`` and every
  gradient are within ``2 e`` of the reference's bf16, ``e`` the
  reference's own gap between its bf16 and fp32 layers on the same
  bf16-exact inputs;
- the bf16 tie rule of ``chip_smoke.py`` (``bf16_ulp``, ``routing_tie``)
  on hand-made logits;
- ``gather_rows`` refuses a float16 ``src`` that requires grad on the card
  (a fake CUDA tensor here), and its backward a float16 ``dout``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as JL  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.arch import layers as L  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gather_batch import (gather_rows,  # noqa: E402
                                              gather_rows_backward)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BF16 = torch.bfloat16
E_FACTOR = 2


def _bits(t) -> np.ndarray:
    """A bf16 tensor's or array's 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


# (n_src, row, K, repeats, negatives): a third of the indices on one row, a
# ragged row, more indices than rows, a single index
GATHERS = {
    "repeats": (40, (16,), 300, True, False),
    "repeats and negatives": (33, (7,), 500, True, True),
    "flat (d, d) rows": (20, (3, 5), 90, True, True),
    "no repeats": (64, (8,), 40, False, False),
    "one index": (5, (9,), 1, False, True),
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_bf16_plain_gather_backward_is_the_references_gradient_bits(case):
    n, row, K, repeats, negatives = GATHERS[case]
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, n, K) if repeats else rng.permutation(n)[:K]
    if repeats:
        idx[: K // 3] = idx[0]
    if negatives:
        idx = np.where(rng.random(K) < 0.4, idx - n, idx)
    dout = rng.standard_normal((K,) + row).astype(np.float32)
    d16 = jnp.asarray(dout, jnp.bfloat16)
    _, vjp = jax.vjp(lambda s: jnp.take(s, jnp.asarray(idx), axis=0),
                     jnp.zeros((n,) + row, jnp.bfloat16))
    want = vjp(d16)[0]
    got = ref.gather_rows_bwd_ref(torch.from_numpy(dout).to(BF16),
                                  torch.as_tensor(idx, dtype=torch.int32), n)
    assert got.dtype == BF16 and tuple(got.shape) == (n,) + row
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the fp32 plain version stays the index_add_ it was
    got32 = ref.gather_rows_bwd_ref(torch.from_numpy(dout),
                                    torch.as_tensor(idx, dtype=torch.int32),
                                    n)
    want32 = torch.zeros((n,) + row).index_add_(
        0, torch.as_tensor(np.where(idx < 0, idx + n, idx)),
        torch.from_numpy(dout))
    assert torch.equal(got32, want32)


def _moe_cfgs(name, d=64, experts=16):
    """The reduced configuration at 16 experts (a token's 8 chosen among
    them, where the plain reduction keeps 4 and so chooses all)."""
    return (jax_config(name).reduced(d_model=d, n_experts=experts),
            get_config(name).reduced(d_model=d, n_experts=experts))


def _moe_inputs(name, N, seed=0):
    jcfg, cfg = _moe_cfgs(name)
    p16 = JL.init_moe(jax.random.PRNGKey(seed), jcfg, dtype=jnp.bfloat16)
    x = np.random.default_rng(seed).standard_normal((N, cfg.d_model))
    x16 = jnp.asarray(x, jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(BF16)
          for k, v in p16.items()}
    tx = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(BF16)
    return jcfg, cfg, p16, x16, tp, tx


@pytest.mark.parametrize("name,N,G", [("granite-moe-1b-a400m", 48, 2),
                                      ("olmoe-1b-7b", 40, 1)])
def test_bf16_combine_is_the_references_scatter_add_bits(name, N, G):
    """The port's bf16 ``y`` against the reference's ``zeros(bf16).at[tok]
    .add(contrib)`` over the port's own contributions (its combine
    gather's rows times its gates), laid out in the reference's order (the
    stable sort by expert within each group), drops included."""
    jcfg, cfg, p16, x16, tp, tx = _moe_inputs(name, N)
    cfg = dataclasses.replace(cfg, capacity_factor=0.75)
    rows_seen = []

    def gather(src, idx):
        out = ref.gather_rows_ref(src, idx)
        rows_seen.append(out)
        return out

    y, _ = L.moe(tp, tx, cfg, G, gather=gather)
    r = L.moe_route(tp, tx, cfg, G)
    assert not bool(r["keep"].all())             # some assignments dropped
    K, D = cfg.experts_per_token, cfg.d_model
    contrib = rows_seen[1].view(N, K, D) * r["combine_w"][..., None].to(BF16)
    # back to top-k order, then to the reference's sorted order per group
    ascending = r["expert_idx"].argsort(-1)
    topk = torch.empty_like(contrib)
    topk.scatter_(1, ascending[..., None].expand(N, K, D), contrib)
    Gr, Sg = r["groups"], N // r["groups"]
    order = r["order"]                                  # (G, Sg * K)
    in_order = torch.stack([topk.view(Gr, Sg * K, D)[g][order[g]]
                            for g in range(Gr)])
    tok = (order // K).numpy()
    c16 = jnp.asarray(in_order.float().numpy(), jnp.bfloat16)
    want = jax.vmap(lambda t, c: jnp.zeros((Sg, D), jnp.bfloat16).at[t].add(
        c))(jnp.asarray(tok), c16).reshape(N, D)
    assert y.dtype == BF16
    np.testing.assert_array_equal(_bits(y), _bits(want))
    # and one fp32 sum rounded once is not what the reference does here
    once = contrib.float().sum(1).to(BF16)
    assert not torch.equal(once, y)


def _tie_ok(logits, K, port_idx, ref_idx):
    """Tokens whose chosen experts differ must sit at a bf16 tie: the
    reference's K-th and (K+1)-th logits within BF16_ROUTING_ULPS ulps of
    the larger. Returns (all do, how many differ)."""
    differ = (np.sort(port_idx, -1) != np.sort(ref_idx, -1)).any(-1)
    top = -np.sort(-logits, -1)
    a, b = torch.from_numpy(top[:, K - 1]), torch.from_numpy(top[:, K])
    ulps = (a - b) / chip_smoke.bf16_ulp(torch, torch.maximum(a.abs(),
                                                              b.abs()))
    return bool((ulps[torch.from_numpy(differ)]
                 <= chip_smoke.BF16_ROUTING_ULPS).all()), int(differ.sum())


@pytest.fixture(scope="module", params=[("granite-moe-1b-a400m", 64, 2),
                                        ("olmoe-1b-7b", 48, 1)],
                ids=["granite-moe-1b-a400m", "olmoe-1b-7b"])
def moe_runs(request):
    """The layer and its gradients in both packages: the port in bf16,
    the reference in bf16 and in fp32 on the same bf16-exact values."""
    name, N, G = request.param
    jcfg, cfg, p16, x16, tp, tx = _moe_inputs(name, N, seed=3)
    w = np.random.default_rng(4).standard_normal((N, cfg.d_model))
    w16 = jnp.asarray(w, jnp.bfloat16)

    def jloss(p, x):
        y, aux = JL.moe(p, x, jcfg, n_groups=G)
        return (y.astype(jnp.float32) * w16.astype(jnp.float32)).sum() + aux

    out = {"cfg": cfg}
    for tag, cast in (("ref16", lambda a: a),
                      ("ref32", lambda a: a.astype(jnp.float32))):
        p, x = jax.tree.map(cast, p16), cast(x16)
        y, aux = JL.moe(p, x, jcfg, n_groups=G)
        grads = jax.grad(jloss, argnums=(0, 1))(p, x)
        out[tag] = (np.asarray(y.astype(jnp.float32)), float(aux),
                    [np.asarray(grads[1].astype(jnp.float32))]
                    + [np.asarray(grads[0][k].astype(jnp.float32))
                       for k in sorted(tp)])
    leaves = [tx.clone().requires_grad_(True)] + \
        [tp[k].clone().requires_grad_(True) for k in sorted(tp)]
    p = dict(zip(sorted(tp), leaves[1:]))
    y, aux = L.moe(p, leaves[0], cfg, G)
    loss = (y.float() * torch.from_numpy(
        np.array(w16.astype(jnp.float32)))).sum() + aux
    grads = torch.autograd.grad(loss, leaves)
    out["port"] = (y.detach().float().numpy(), float(aux.detach()),
                   [g.float().numpy() for g in grads],
                   [g.dtype for g in grads])
    logits = np.asarray((x16 @ p16["router"]).astype(jnp.float32))
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                               cfg.experts_per_token)
    out["routing"] = _tie_ok(logits, cfg.experts_per_token,
                             L.moe_route(tp, tx, cfg, G)["expert_idx"]
                             .numpy(), np.asarray(ref_idx))
    return out


def test_bf16_moe_routing_equals_the_references_but_at_bf16_ties(moe_runs):
    ok, differing = moe_runs["routing"]
    assert ok, differing


def test_bf16_moe_output_within_twice_the_references_own_bf16_gap(moe_runs):
    (y, aux, _, _), (y16, aux16, _), (y32, aux32, _) = (
        moe_runs["port"], moe_runs["ref16"], moe_runs["ref32"])
    assert np.isfinite(y).all()
    e = np.abs(y16 - y32).max()
    assert 0 < e < 0.1 * np.abs(y32).max()
    assert np.abs(y - y16).max() <= E_FACTOR * e
    # aux: fp32 from the probabilities of the bf16 router logits in both
    assert abs(aux - aux16) <= max(E_FACTOR * abs(aux16 - aux32), 1e-6)


def test_bf16_moe_gradients_within_twice_the_references_own_bf16_gap(
        moe_runs):
    _, _, grads, dtypes = moe_runs["port"]
    g16, g32 = moe_runs["ref16"][2], moe_runs["ref32"][2]
    assert set(dtypes) == {BF16}
    e = max(np.abs(a - b).max() / np.abs(a).max() for a, b in zip(g16, g32))
    for i, (g, a) in enumerate(zip(grads, g16)):
        assert np.isfinite(g).all()
        assert np.abs(g - a).max() <= E_FACTOR * e * np.abs(a).max(), i


def test_bf16_tie_rule_on_hand_made_logits():
    """One bf16 ulp at |l| in [2^k, 2^(k+1)) is 2^(k-7); a flip is a tie
    within two of them at the larger of the two logits, and fp32 keeps its
    probability bar."""
    ulp = chip_smoke.bf16_ulp(torch, torch.tensor([1.0, 1.5, 2.0, -3.0,
                                                   0.25, 100.0]))
    assert ulp.tolist() == [2 ** -7, 2 ** -7, 2 ** -6, 2 ** -6, 2 ** -9,
                            2 ** -1]

    def routing(ulps, bf16=True, gap=None):
        return {"first_differing_call": 0, "bf16": bf16,
                "ulps_at_flip": ulps, "gap_at_flip": gap}

    assert chip_smoke.routing_tie(routing(2.0))
    assert chip_smoke.routing_tie(routing(0.0))
    assert not chip_smoke.routing_tie(routing(2.5))
    assert chip_smoke.routing_tie(routing(None, False, 1e-5))
    assert not chip_smoke.routing_tie(routing(None, False, 2e-5))
    assert not chip_smoke.routing_tie(
        {"first_differing_call": None, "bf16": True})
    assert not chip_smoke.routing_tie(None)


def test_routing_recorder_measures_bf16_logit_gaps_in_ulps():
    """Hand-made router logits (x the identity): token 0's 2nd and 3rd
    logits 4.0 and 4.0 - 2 ulps(4) = 3.9375, token 1's 1.0 and 0.5;
    the recorder gives 2 and 64 ulps, and a bf16 run's divergence reports
    the gap in ulps at the first differing call."""
    from repro_torch.arch.config import ArchConfig, LayerSpec

    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=4,
                     n_heads=1, n_kv_heads=1, d_ff=0, vocab=8, n_experts=4,
                     experts_per_token=2, d_ff_expert=4,
                     pattern=(LayerSpec("attn", "moe"),))
    x = torch.tensor([[5.0, 4.0, 3.9375, 0.0],
                      [2.0, 1.0, 0.5, 0.25]]).to(BF16)
    p = {"router": torch.eye(4, dtype=BF16)}
    with chip_smoke.RoutingRecorder() as rec:
        L.moe_route(p, x, cfg)
    _, _, ulps = rec.calls[0]
    assert ulps.tolist() == [2.0, 64.0]
    assert rec.bf16 and rec.min_ulps() == 2.0 and rec.within_bar() == 1
    changed = rec.calls[0][0].clone()
    changed[1] = torch.tensor([0, 2])
    other = chip_smoke.RoutingRecorder()
    other.calls = [(changed, rec.calls[0][1], ulps)]
    div = chip_smoke.routing_divergence(other, rec)
    assert div["bf16"] and div["first_differing_call"] == 0
    assert div["ulps_at_flip"] == 64.0
    assert not chip_smoke.routing_tie(div)


def test_gather_rows_refuses_float16_with_grad_on_the_card():
    """On a (fake) CUDA tensor the wrapper's dtype checks run as on the
    card: a float16 src that requires grad, and a float16 dout, raise; the
    bf16 ones pass the checks (and would launch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        idx = torch.zeros(3, dtype=torch.int32, device="cuda")
        src = torch.empty((10, 4), dtype=torch.float16,
                          device="cuda").requires_grad_(True)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            gather_rows(src, idx)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            gather_rows_backward(torch.empty((3, 4), dtype=torch.float16,
                                             device="cuda"), idx, 10)

"""The port's MoE layer (``repro_torch.arch.layers.moe``) against the JAX
package's ``repro.arch.layers.moe`` on the same numpy-seeded inputs and
parameters, over several ``(E, K, capacity_factor, n_groups)``, drops
included:

- the routing (``expert_idx``, the sorted order, ``dest``, ``keep`` and
  the capacity) equal to the reference's, recomputed here by its own
  lines;
- the expert-major staging layout the dispatch gather fills, and the
  combine gather's slots;
- ``y`` and ``aux`` within 1e-5, the gradient within 1e-4 of ``jax.grad``;
- the reference's own MoE properties (sorted dispatch equals a dense
  per-token loop at ample capacity, bounded drops, a uniform router's aux
  near 1) mirrored on the port.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arch import layers as JL  # noqa: E402
from repro.arch.config import ArchConfig as JArchConfig  # noqa: E402
from repro.arch.config import LayerSpec as JLayerSpec  # noqa: E402
from repro_torch.arch import layers as L  # noqa: E402
from repro_torch.arch.config import ArchConfig, LayerSpec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (E, K, capacity_factor, n_groups, N): drops at capacity 1.0 and below,
# groups that do and do not divide N, K = E (every expert for every token)
CASES = [
    (4, 2, 1.0, 1, 24),
    (4, 2, 1.0, 3, 24),
    (4, 2, 0.5, 4, 32),
    (8, 3, 1.25, 4, 32),
    (8, 2, 1.25, 5, 24),      # 5 does not divide 24: one group
    (4, 4, 1.0, 2, 16),
    (4, 1, 8.0, 2, 16),
    (16, 4, 1.25, 1, 6),      # a decode step's shape: one group of B rows
]


def _cfgs(E, K, cf, d=32, f=64):
    kw = dict(name="t", family="moe", n_layers=2, d_model=d, n_heads=4,
              n_kv_heads=4, d_ff=0, vocab=64, n_experts=E,
              experts_per_token=K, d_ff_expert=f, capacity_factor=cf)
    return (JArchConfig(pattern=(JLayerSpec("attn", "moe"),), **kw),
            ArchConfig(pattern=(LayerSpec("attn", "moe"),), **kw))


def _setup(E, K, cf, N, seed=0):
    jcfg, cfg = _cfgs(E, K, cf)
    p = jax.tree.map(np.asarray, JL.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        (N, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jcfg, cfg, p, tp, x


def _jax_routing(p, x, cfg, n_groups):
    """The reference's routing, by the lines of ``repro.arch.layers.moe``
    that compute it."""
    N = x.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    G = n_groups if n_groups > 0 and N % n_groups == 0 else 1
    Sg = N // G
    C = int(np.ceil(cfg.capacity_factor * Sg * K / E))
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    fe = expert_idx.reshape(G, Sg * K)
    order = jnp.argsort(fe, axis=-1)
    se = jnp.take_along_axis(fe, order, axis=-1)
    first = jax.vmap(lambda s: jnp.searchsorted(s, s, side="left"))(se)
    pos_in_e = jnp.arange(Sg * K)[None] - first
    keep = pos_in_e < C
    dest = jnp.where(keep, se * C + pos_in_e, E * C)
    return {"groups": G, "capacity": C,
            **{k: np.asarray(v) for k, v in (
                ("expert_idx", expert_idx), ("order", order),
                ("dest", dest), ("keep", keep))}}


@pytest.mark.parametrize("E,K,cf,G,N", CASES)
def test_routing_equals_the_reference(E, K, cf, G, N):
    jcfg, cfg, p, tp, x = _setup(E, K, cf, N)
    r = L.moe_route(tp, torch.from_numpy(x), cfg, G)
    want = _jax_routing(p, jnp.asarray(x), jcfg, G)
    assert (r["groups"], r["capacity"]) == (want["groups"],
                                            want["capacity"])
    assert r["capacity"] == math.ceil(cf * (N // r["groups"]) * K / E)
    for key in ("expert_idx", "order", "dest", "keep"):
        np.testing.assert_array_equal(r[key].numpy(), want[key], err_msg=key)
    if cf <= 1.0 and K < E:
        assert not want["keep"].all()      # the case drops assignments


@pytest.mark.parametrize("E,K,cf,G,N", CASES)
def test_gather_indices_lay_the_slots_out_expert_major(E, K, cf, G, N):
    """Slot ``e * G * C + g * C + c`` of the staging buffer holds the token
    the reference's ``dest = e * C + c`` of group g sends there (where none
    does, appended zero row ``N + g * C + c``), and each token's combine
    entries are its kept slots in ascending expert order (where dropped,
    its own zero row ``E * G * C + n``), weighted by gate times keep; no
    source row is read more than E (dispatch) or K (combine) times."""
    jcfg, cfg, p, tp, x = _setup(E, K, cf, N)
    r = L.moe_route(tp, torch.from_numpy(x), cfg, G)
    want = _jax_routing(p, jnp.asarray(x), jcfg, G)
    G, C = r["groups"], r["capacity"]
    Sg = N // G
    staging = np.broadcast_to(N + np.arange(G * C).reshape(G, C),
                              (E, G, C)).copy()
    slot_of = np.broadcast_to(E * G * C + np.arange(N)[:, None],
                              (N, E)).copy()
    for g in range(G):
        for j in range(Sg * K):
            if want["keep"][g, j]:
                e, c = divmod(int(want["dest"][g, j]), C)
                t = g * Sg + int(want["order"][g, j]) // K
                staging[e, g, c] = t
                slot_of[t, e] = e * G * C + g * C + c
    np.testing.assert_array_equal(r["dispatch_idx"].numpy(),
                                  staging.reshape(-1))
    assert r["dispatch_idx"].dtype == r["combine_idx"].dtype == torch.int32
    experts = np.sort(want["expert_idx"], axis=-1)
    np.testing.assert_array_equal(
        r["combine_idx"].numpy().reshape(N, K),
        np.take_along_axis(slot_of, experts, axis=1))
    kept = r["combine_idx"].numpy().reshape(N, K) < E * G * C
    gates = r["gate_vals"].detach().gather(
        1, r["expert_idx"].argsort(dim=-1)).numpy()
    np.testing.assert_array_equal(r["combine_w"].detach().numpy(),
                                  np.where(kept, gates, 0.0))
    assert np.bincount(r["dispatch_idx"].numpy()).max() <= E
    assert np.bincount(r["combine_idx"].numpy()).max() <= K


@pytest.mark.parametrize("E,K,cf,G,N", CASES)
def test_moe_matches_the_reference(E, K, cf, G, N):
    jcfg, cfg, p, tp, x = _setup(E, K, cf, N, seed=1)
    y, aux = L.moe(tp, torch.from_numpy(x), cfg, n_groups=G)
    jy, jaux = JL.moe(p, jnp.asarray(x), jcfg, n_groups=G)
    assert tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    y2, aux2 = L.moe(tp, torch.from_numpy(x), cfg, n_groups=G)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    # the plain gathers (the card's check) compute the same bits here
    y3, _ = L.moe(tp, torch.from_numpy(x), cfg, n_groups=G,
                  gather=ref.gather_rows_ref)
    assert torch.equal(y, y3)


@pytest.mark.parametrize("E,K,cf,G,N", CASES[:6])
def test_moe_gradient_matches_jax_grad(E, K, cf, G, N):
    """The gradient of ``sum(y * w) + aux`` with respect to ``x`` and every
    parameter, within 1e-4 of its largest |value|."""
    jcfg, cfg, p, tp, x = _setup(E, K, cf, N, seed=2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JL.moe(p, x, jcfg, n_groups=G)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = L.moe(leaves, xt, cfg, n_groups=G)
    loss = (y * torch.from_numpy(w)).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + list(leaves.values()))
    wants = [jgx] + [jgp[k] for k in leaves]
    for name, got, want in zip(["x"] + list(leaves), grads, wants):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= 1e-4, f"{name}: {err:.3e}"


def test_init_moe_has_the_reference_shapes_and_scales():
    jcfg, cfg = _cfgs(8, 2, 1.25, d=64, f=96)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    jp = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in p:
        np.testing.assert_allclose(float(p[k].std()),
                                   float(np.asarray(jp[k]).std()), rtol=0.1)


# -- the reference's MoE properties, mirrored --------------------------------


def _dense_ref(p, x, cfg):
    """Dense per-token expert loop (no capacity, no sorting)."""
    probs = torch.softmax((x @ p["router"]).float(), -1)
    gate, idx = torch.topk(probs, cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        w = torch.where(idx == e, gate, 0.0).sum(-1)
        y = y + (h @ p["w_down"][e]) * w[:, None]
    return y


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("E,K", [(2, 1), (4, 1), (4, 2)])
def test_sorted_dispatch_matches_dense(seed, E, K):
    """With ample capacity, sorted contiguous dispatch == dense reference
    (the reference's ``test_moe_sorted_dispatch_matches_dense``)."""
    _, cfg = _cfgs(E, K, float(E))
    p = L.init_moe(torch.Generator().manual_seed(seed), cfg)
    x = torch.randn((24, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 1))
    y, aux = L.moe(p, x, cfg)
    torch.testing.assert_close(y, _dense_ref(p, x, cfg), rtol=2e-4,
                               atol=2e-4)
    assert torch.isfinite(aux)


def test_capacity_drops_are_bounded():
    """At capacity factor 1.0 no expert keeps more than C assignments a
    group, and the output stays finite."""
    _, cfg = _cfgs(4, 2, 1.0)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    r = L.moe_route(p, x, cfg, 4)
    kept = r["dest"][r["keep"]]
    per_group = [torch.bincount(d[k] // r["capacity"], minlength=4)
                 for d, k in zip(r["dest"], r["keep"])]
    assert int(torch.stack(per_group).max()) <= r["capacity"]
    assert int(kept.max()) < 4 * r["capacity"]
    assert torch.isfinite(L.moe(p, x, cfg, 4)[0]).all()


def test_uniform_router_aux_is_one():
    """Perfectly uniform routing gives aux loss ~= 1 (switch
    normalization)."""
    _, cfg = _cfgs(4, 1, 8.0)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn((256, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    _, aux = L.moe(p, x, cfg)
    assert abs(float(aux) - 1.0) < 0.3


def test_top_k_ties_take_the_lower_expert_first():
    """Equal router probabilities: the lower expert index wins, in
    ``jax.lax.top_k``'s order, so routing on ties is the reference's."""
    jcfg, cfg = _cfgs(8, 3, 1.25)
    p = {k: v.clone() for k, v in L.init_moe(
        torch.Generator().manual_seed(0), cfg).items()}
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 5] = 1.0
    x = torch.ones((4, cfg.d_model))
    r = L.moe_route(p, x, cfg, 1)
    want = _jax_routing({"router": jnp.asarray(p["router"].numpy())},
                        jnp.asarray(x.numpy()), jcfg, 1)
    np.testing.assert_array_equal(r["expert_idx"].numpy(),
                                  want["expert_idx"])
    assert r["expert_idx"][0].tolist() == [5, 0, 1]

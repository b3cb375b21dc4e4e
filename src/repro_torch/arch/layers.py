"""Transformer building blocks: RMSNorm, RoPE, GQA attention (causal,
sliding-window or cross), the SwiGLU and GeLU MLPs, and MoE with ED-Batch's
sorted contiguous dispatch.

Parameters are dicts of tensors of the model's dtype (float32 or
bfloat16, as the reference's ``dtype``) made by the matching ``init_*``
functions from an explicit ``torch.Generator``, with the reference's
scales. Every
attention over a sequence (self or cross) runs the flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`); single-token decode against a
cache stays plain PyTorch, as the reference computes it outside any kernel.

The MoE dispatch is the paper's memory-layout insight applied to expert
parallelism: assignments sorted by expert id give each expert a contiguous
slice of the staging buffer, which one row gather
(:mod:`repro_torch.kernels.gather_batch`) fills in the order the expert
GEMMs read, and a second gather brings the experts' rows back to their
tokens (:func:`moe`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.gather_batch import gather_rows
from ..kernels import ref
from ..kernels.ref import attention_mask
from .config import ArchConfig


def _normal(gen: torch.Generator | None, shape, scale: float, device,
            dtype=torch.float32):
    """``N(0, 1) * scale`` drawn in fp32 on the generator's device, then
    cast to ``dtype`` and moved. On the ``meta`` device nothing is drawn
    (``gen`` may be None): an empty meta tensor of the shape and dtype
    stands in, so a tree of a model's full size is built without
    allocating or drawing."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(device=device,
                                                       dtype=dtype)


# -----------------------------------------------------------------------------
# Norm + RoPE
# -----------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-5):
    """Over the last dim; on the dry-run's production mesh placed as a
    row-wise op, split on any dim but the last (``kernels/ref.py:reckon``)."""
    rows = "abc"[:x.ndim - 1]
    return ref.reckon(_rmsnorm, (x, scale, eps), (rows + "d", "d", None),
                      rows + "d", rows)


def _rmsnorm(x, scale, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def gold_logit(logits, labels):
    """``logits`` (B, S, V) at ``labels`` (B, S): (B, S, 1). On the dry-run's
    production mesh a region that moves nothing (``kernels/ref.py:reckon``):
    each vocab shard's masked gather, a partial sum over the vocab's split,
    whose backward scatters into the shard alone."""
    return ref.reckon(torch.gather, (logits, -1, labels.long()[..., None]),
                      ("bsv", None, "bsu"), "bsu", "bsv")


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The two
    halves of the head dim rotate together (not interleaved pairs). On the
    dry-run's production mesh x (B, S, H, Dh) is placed as a position- and
    head-wise op (``kernels/ref.py:reckon``)."""
    if x.ndim == 4 and positions.ndim == 2:
        return ref.reckon(_apply_rope, (x, positions, theta),
                          ("bshd", "bs", None), "bshd", "bsh")
    return _apply_rope(x, positions, theta)


def _apply_rope(x, positions, theta: float):
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -----------------------------------------------------------------------------
# Attention
# -----------------------------------------------------------------------------


def init_attention(gen, cfg: ArchConfig, cross: bool = False, device=None,
                   dtype=torch.float32):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    p = {"wq": _normal(gen, (d, h * dh), s, device, dtype),
         "wk": _normal(gen, (d, kv * dh), s, device, dtype),
         "wv": _normal(gen, (d, kv * dh), s, device, dtype),
         "wo": _normal(gen, (h * dh, d), s, device, dtype)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h * dh,), device=device, dtype=dtype)
        p["bk"] = torch.zeros((kv * dh,), device=device, dtype=dtype)
        p["bv"] = torch.zeros((kv * dh,), device=device, dtype=dtype)
    return p


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _sdpa(q, k, v, mask, dtype):
    """q: (B,S,H,Dh); k/v: (B,T,KV,Dh); mask: (B or 1, S, T) bool or None.
    Plain PyTorch: the decode path's attention against the cache. On the
    dry-run's production mesh it is placed as attention splits, by batch,
    heads and keys (a split over the keys leaves partial sums;
    ``kernels/ref.py:reckon``)."""
    return ref.reckon(_sdpa_plain, (q, k, v, mask, dtype),
                      ("bshd", "bthd", "bthd",
                       None if mask is None else "bst", None), "bsh", "bht")


def _sdpa_plain(q, k, v, mask, dtype):
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * (Dh ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H * Dh)


def causal_mask(S: int, window: int = 0, device=None):
    return attention_mask(S, S, window, device)[None]  # (1, S, T)


def _project_qkv(p, x, src, cfg: ArchConfig):
    """Q from ``x``, K and V from ``src``, biased and split into heads."""
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (_split_heads(q, cfg.n_heads, cfg.d_head),
            _split_heads(k, cfg.n_kv_heads, cfg.d_head),
            _split_heads(v, cfg.n_kv_heads, cfg.d_head))


def self_attention(p, x, cfg: ArchConfig, positions):
    """Causal self-attention (with ``cfg.sliding_window``) through the
    flash-attention kernel; the reference's causal mask argument is the
    kernel's own mask here. Returns ``(out, k, v)`` with K roped: the rows
    a prefill writes into the decode cache."""
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return out.flatten(2).to(x.dtype) @ p["wo"], k, v


def cross_attention(p, x, cfg: ArchConfig, kv):
    """Non-causal cross-attention of ``x`` onto ``kv`` (the image
    embeddings; no RoPE on the encoder side, which carries no order)
    through the flash-attention kernel. Returns ``(out, k, v)``: K and V
    are the rows a prefill writes into the cross cache."""
    q, k, v = _project_qkv(p, x, kv, cfg)
    out = flash_attention(q, k, v, causal=False)
    return out.flatten(2).to(x.dtype) @ p["wo"], k, v


def attention(p, x, cfg: ArchConfig, positions, kv=None):
    """Causal self-attention when ``kv`` is None, else non-causal
    cross-attention onto ``kv``. Both go through the flash-attention
    kernel."""
    if kv is None:
        return self_attention(p, x, cfg, positions)[0]
    return cross_attention(p, x, cfg, kv)[0]


def attention_with_cache(p, x, cfg: ArchConfig, cache, pos):
    """Single-token decode. cache: dict(k=(B,T,KV,Dh), v=...) with T the
    cache capacity (a ring when cfg.sliding_window > 0); ``pos`` is the
    absolute position, a scalar or a per-request (B,) tensor. Writes the
    new K/V row into ``cache`` in place (the reference returns updated
    copies) and returns ``(out, cache)``."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, x, cfg)    # (B,1,H,Dh), (B,1,KV,Dh)
    posv = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    q = apply_rope(q, posv[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, posv[:, None], cfg.rope_theta)  # rope at write
    T = cache["k"].shape[1]
    slot = posv % T                                  # ring slot (full: T>=S)
    barange = torch.arange(B, device=x.device)
    cache["k"][barange, slot] = k_new[:, 0]
    cache["v"][barange, slot] = v_new[:, 0]
    idx = torch.arange(T, device=x.device)
    # A slot is valid once written: idx <= pos while the cache is not full;
    # every slot once a ring has wrapped (pos + 1 >= T).
    valid = (idx[None] <= posv[:, None]) | (posv[:, None] + 1 >= T)
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, :], x.dtype)
    return out @ p["wo"], cache


# -----------------------------------------------------------------------------
# MLPs
# -----------------------------------------------------------------------------


def init_mlp(gen, cfg: ArchConfig, device=None, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    s = d ** -0.5
    if cfg.mlp_type == "swiglu":
        return {"w_gate": _normal(gen, (d, f), s, device, dtype),
                "w_up": _normal(gen, (d, f), s, device, dtype),
                "w_down": _normal(gen, (f, d), f ** -0.5, device, dtype)}
    return {"w_in": _normal(gen, (d, f), s, device, dtype),
            "b_in": torch.zeros((f,), device=device, dtype=dtype),
            "w_out": _normal(gen, (f, d), f ** -0.5, device, dtype),
            "b_out": torch.zeros((d,), device=device, dtype=dtype)}


def mlp(p, x, cfg: ArchConfig):
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh") @ p["w_out"] \
        + p["b_out"]


# -----------------------------------------------------------------------------
# MoE with sorted contiguous dispatch
# -----------------------------------------------------------------------------


def init_moe(gen, cfg: ArchConfig, device=None, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    s = d ** -0.5
    return {"router": _normal(gen, (d, e), s, device, dtype),
            "w_gate": _normal(gen, (e, d, f), s, device, dtype),
            "w_up": _normal(gen, (e, d, f), s, device, dtype),
            "w_down": _normal(gen, (e, f, d), f ** -0.5, device, dtype)}


def moe_route(p, x, cfg: ArchConfig, n_groups: int = 1) -> dict:
    """The reference's routing of ``x`` (N, D), computed on ``x``'s device
    with no host synchronisation: every shape follows from ``(N, G, E, K,
    C)``. Returns a dict of

    - ``groups`` G (``n_groups`` where it divides N, else 1) and
      ``capacity`` C = ceil(capacity_factor * (N / G) * K / E);
    - ``probs`` (N, E), the router's softmax; ``gate_vals`` (N, K), the
      top K renormalised, and ``expert_idx`` (N, K), in
      ``jax.lax.top_k``'s order (descending, the lower expert first on a
      tie);
    - per group, over its ``(N / G) * K`` assignments (token-major):
      ``order``, the stable sort by expert; ``dest``, the group-local slot
      ``expert * C + rank`` of each sorted assignment, or ``E * C`` (the
      overflow slot) where ``keep`` is False because the expert is full;
    - the gathers' int32 index vectors: ``dispatch_idx`` (E * G * C,) the
      row of ``cat([x, zeros(G * C, D)])`` each slot of the expert-major
      staging buffer takes (slot ``e * G * C + g * C + c``; where no
      assignment filled it, zero row ``N + g * C + c``), and
      ``combine_idx`` (N * K,) the slot of each token's K assignments in
      ascending expert order in ``cat([out, zeros(N, D)])`` (where
      dropped, token n's zero row ``E * G * C + n``), with ``combine_w``
      (N, K) their gates times ``keep`` in the same order. The zero rows
      are spread so that no row of either gather's source is read more
      than E (dispatch) or K (combine) times: the gather's backward sums
      each source row's entries in order, one row's run on one thread, so
      one zero row for every empty slot (thousands of them once a trained
      router favours a few experts) would be a serial sum of that length.
    """
    N = x.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    G = n_groups if n_groups > 0 and N % n_groups == 0 else 1
    Sg = N // G
    C = math.ceil(cfg.capacity_factor * Sg * K / E)
    dev = x.device
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)       # (N, E)
    # a stable descending sort puts the lower index first on a tie, as
    # jax.lax.top_k does (torch.topk promises no order among ties)
    expert_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                            stable=True).indices[:, :K]
    gate_vals = probs.gather(1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    fe = expert_idx.reshape(G, Sg * K)
    order = torch.argsort(fe, dim=-1, stable=True)             # by expert
    se = fe.gather(1, order)
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(Sg * K, device=dev)[None] - first
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, E * C)

    # expert-major slots over all groups: one expert's G * C rows are
    # contiguous, so a single bmm over E runs every group's expert GEMMs
    g = torch.arange(G, device=dev)[:, None]
    slot = torch.where(keep, se * (G * C) + g * C + pos_in_e, E * G * C)
    rows = g * Sg + order // K                                 # token in x
    # every slot starts at its own (g, c) zero row
    dispatch = (N + torch.arange(G * C, device=dev)).repeat(E)
    dispatch = torch.cat([dispatch, dispatch.new_zeros(1)])
    # an integer scatter: kept slots are distinct, and the dropped
    # assignments all land on the extra last entry, which is cut off
    dispatch.scatter_(0, slot.flatten(), rows.flatten())
    # each assignment's slot and keep back in token-major order; a dropped
    # one reads its token's zero row past the experts' output
    slot_of = torch.empty_like(slot).scatter_(1, order, slot).view(N, K)
    keep_of = torch.empty_like(keep).scatter_(1, order, keep).view(N, K)
    tokens = torch.arange(N, device=dev)[:, None]
    slot_of = torch.where(keep_of, slot_of, E * G * C + tokens)
    ascending = expert_idx.argsort(dim=-1)     # a token's experts differ
    return {"groups": G, "capacity": C, "probs": probs,
            "gate_vals": gate_vals, "expert_idx": expert_idx,
            "order": order, "dest": dest, "keep": keep,
            "dispatch_idx": dispatch[:E * G * C].int(),
            "combine_idx": slot_of.gather(1, ascending).flatten().int(),
            "combine_w": (gate_vals * keep_of).gather(1, ascending)}


def moe(p, x, cfg: ArchConfig, n_groups: int = 1, gather=gather_rows,
        constrain=None):
    """Top-k MoE with grouped sorted dispatch (the reference's ``moe``):
    x (N, D) flattened tokens -> (y (N, D), aux). Tokens beyond an
    expert's capacity are dropped (switch-style).

    Where the reference gathers, scatters into a per-group staging buffer
    and scatter-adds the weighted rows back, this runs two row gathers
    (``gather``, the kernel's wrapper; on the card differentiable through
    its backward kernel) and no scatter of floats: the first fills the
    expert-major staging buffer (:func:`moe_route`), each expert's GEMMs
    read one contiguous ``(G * C, D)`` slice (one ``bmm`` over E), and the
    second gathers each token's K output rows in ascending expert order,
    which are scaled by their gates and summed (in bf16 one add at a time,
    rounded after each, as the reference's scatter-add rounds). Empty
    slots and dropped assignments read zero rows appended to the gathers'
    sources. The sum's order is fixed, so two runs, and a captured replay
    against eager, give the same bits (``index_add_`` sums with atomics on
    the card).

    ``constrain`` (the model's ``Partitioner``, as the reference hands its
    ``constrain`` down) places the layer on a mesh, the reference's
    constraints on the tensors holding the same data. The reference's
    ``gathered`` (G, Sg*K, D) tokens, ``contrib`` and ``y`` are groups on
    "data" (``moe_tokens``); here the dispatch reads x's rows and the
    combine writes y's, both group-major, so x and y take that placement.
    Its ``hidden`` and ``out`` (G, E, C, D) are groups on "data" and
    experts on "model" (``moe_buf``); here they are the expert-major
    (E, G*C, D) buffers, placed with E on "model" and G*C on "data". The
    reference routes, gathers and scatters within each group (a ``vmap``
    over the groups); the port's routing and its two gathers run over all
    groups' rows at once, so each is a region that moves nothing
    (``Partitioner.local``): every device routes its own groups and fills
    their slots, and the combine reads its groups' rows of every expert,
    the expert outputs first gathered over "model"."""
    N, D = x.shape
    E = cfg.n_experts

    def route(router, x):
        return moe_route({"router": router}, x, cfg, n_groups)

    if constrain is not None:
        G = n_groups if n_groups > 0 and N % n_groups == 0 else 1
        g, e = constrain.activation_spec((G, E, 1, 1), "moe_buf")[:2]
        tokens, buf = (g, None), (e, g, None)
        route = constrain.local(route, ((None, None), tokens), dict.fromkeys(
            ("probs", "gate_vals", "expert_idx", "order", "dest", "keep",
             "combine_w"), tokens) | {"dispatch_idx": (None,),
                                     "combine_idx": (g,)})
    r = route(p["router"], x)
    slots = r["dispatch_idx"].shape[0]

    def dispatch(x, idx):
        return gather(torch.cat([x, x.new_zeros((slots // E, D))]),
                      idx).view(E, -1, D)

    def combine(out, idx, w):
        rows = gather(torch.cat([out.view(-1, D), out.new_zeros((N, D))]),
                      idx)
        contrib = rows.view(N, -1, D) * w[..., None].to(x.dtype)
        if x.dtype == torch.float32:
            return contrib.sum(1)
        # the reference's scatter-add: from zero, a token's rows in
        # ascending expert order, rounded to x's dtype after every add
        y = x.new_zeros((N, D))
        for k in range(contrib.shape[1]):
            y = y + contrib[:, k]
        return y

    if constrain is not None:
        dispatch = constrain.local(dispatch, (tokens, None), (None, g, None))
        combine = constrain.local(combine, ((None, g, None), (g,), tokens),
                                  tokens)
    hidden = dispatch(x, r["dispatch_idx"])
    if constrain is not None:
        hidden = constrain.place(hidden, buf)
    h = F.silu(torch.bmm(hidden, p["w_gate"])) * torch.bmm(hidden, p["w_up"])
    out = torch.bmm(h, p["w_down"])
    if constrain is not None:
        out = constrain.place(out, buf)
    y = combine(out, r["combine_idx"], r["combine_w"])
    # switch-style load-balance aux loss, differentiable through probs
    me = r["probs"].mean(0)
    ce = F.one_hot(r["expert_idx"][:, 0], E).float().mean(0)
    return y, E * (me * ce).sum()

"""Transformer building blocks: RMSNorm, RoPE, GQA attention (causal,
sliding-window or cross), and the SwiGLU and GeLU MLPs.

Parameters are dicts of fp32 tensors made by the matching ``init_*``
functions from an explicit ``torch.Generator``, with the reference's
scales (the kernels are fp32). Every
self-attention over a sequence runs the flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`); single-token decode against a
cache stays plain PyTorch, as the reference computes it outside any kernel.
The MoE layer is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.ref import attention_mask
from .config import ArchConfig


def _normal(gen: torch.Generator, shape, scale: float, device):
    """fp32 ``N(0, 1) * scale`` drawn on the generator's device, then
    moved."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(device)


# -----------------------------------------------------------------------------
# Norm + RoPE
# -----------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The two
    halves of the head dim rotate together (not interleaved pairs)."""
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


def init_attention(gen, cfg: ArchConfig, cross: bool = False, device=None):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    p = {"wq": _normal(gen, (d, h * dh), s, device),
         "wk": _normal(gen, (d, kv * dh), s, device),
         "wv": _normal(gen, (d, kv * dh), s, device),
         "wo": _normal(gen, (h * dh, d), s, device)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h * dh,), device=device)
        p["bk"] = torch.zeros((kv * dh,), device=device)
        p["bv"] = torch.zeros((kv * dh,), device=device)
    return p


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _sdpa(q, k, v, mask, dtype):
    """q: (B,S,H,Dh); k/v: (B,T,KV,Dh); mask: (B or 1, S, T) bool or None.
    Plain PyTorch: the decode path's attention against the cache."""
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


def attention(p, x, cfg: ArchConfig, positions, kv=None):
    """Causal self-attention when ``kv`` is None, else non-causal
    cross-attention onto ``kv`` (no RoPE on the encoder side). Both go
    through the flash-attention kernel."""
    if kv is None:
        return self_attention(p, x, cfg, positions)[0]
    q, k, v = _project_qkv(p, x, kv, cfg)
    out = flash_attention(q, k, v, causal=False)
    return out.flatten(2).to(x.dtype) @ p["wo"]


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


def init_mlp(gen, cfg: ArchConfig, device=None):
    d, f = cfg.d_model, cfg.d_ff
    s = d ** -0.5
    if cfg.mlp_type == "swiglu":
        return {"w_gate": _normal(gen, (d, f), s, device),
                "w_up": _normal(gen, (d, f), s, device),
                "w_down": _normal(gen, (f, d), f ** -0.5, device)}
    return {"w_in": _normal(gen, (d, f), s, device),
            "b_in": torch.zeros((f,), device=device),
            "w_out": _normal(gen, (f, d), f ** -0.5, device),
            "b_out": torch.zeros((d,), device=device)}


def mlp(p, x, cfg: ArchConfig):
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh") @ p["w_out"] \
        + p["b_out"]

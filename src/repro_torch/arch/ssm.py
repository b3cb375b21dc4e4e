"""State-space duality (SSD / Mamba-2, arXiv:2405.21060) blocks.

The chunked SSD algorithm over a sequence runs in the scan kernel
(:mod:`repro_torch.kernels.ssd_scan`), which also returns the final state
for the decode cache. Decode is O(1): one plain state update per token, as
the reference computes it outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Chunked SSD over a sequence: x (b, l, h, p), dt (b, l, h), A (h,), B and
# C (b, l, g, n) -> (y (b, l, h, p), final state (b, h, p, n)).
from ..kernels import ref
from ..kernels.ssd_scan import ssd_scan
from .config import ArchConfig
from .layers import _normal, rmsnorm


def init_ssm(gen, cfg: ArchConfig, device=None, dtype=torch.float32):
    d, di = cfg.d_model, cfg.d_inner
    nh, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    s = d ** -0.5
    # in_proj packs [z (di), x (di), B (g*n), C (g*n), dt (nh)]
    proj_out = 2 * di + 2 * g * n + nh
    conv_ch = di + 2 * g * n

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    return {
        "in_proj": _normal(gen, (d, proj_out), s, device, dtype),
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_ch), 0.2, device, dtype),
        "conv_b": const((conv_ch,), 0.0),
        "A_log": const((nh,), 0.0),           # A = -exp(A_log) in (-inf, 0)
        "D": const((nh,), 1.0),
        "dt_bias": const((nh,), 0.0),
        "norm_scale": const((di,), 1.0),
        "out_proj": _normal(gen, (di, d), di ** -0.5, device, dtype),
    }


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token update. x: (b,h,p); dt: (b,h); B/C: (b,g,n);
    state: (b,h,p,n) -> (y (b,h,p), new_state)."""
    b, g, n = B.shape
    rep = A.shape[0] // g
    # each group's row repeated for its heads, as ``repeat_interleave``
    # would, by an expand and a reshape, which read nothing back to the
    # host: a captured decode step holds them
    Bh = B[:, :, None].expand(b, g, rep, n).reshape(b, g * rep, n)  # (b,h,n)
    Ch = C[:, :, None].expand(b, g, rep, n).reshape(b, g * rep, n)
    dA = torch.exp(dt * A)                                     # (b,h)
    new = state * dA[:, :, None, None] + \
        torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x)
    # the state is fp32 from here (dA is); jnp.einsum promotes a bf16 C
    f = torch.promote_types(Ch.dtype, new.dtype)
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(f), new.to(f))
    return y, new


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B, L, Ch); w: (K, Ch). The same K
    shifted multiply-adds as the reference, in the input's dtype (a cuDNN
    convolution would run an fp32 one in TF32 on the card by default). On
    the dry-run's production mesh placed as a batch- and channel-wise op
    (``kernels/ref.py:reckon``)."""
    return ref.reckon(_causal_conv_plain, (u, w, b), ("blc", "kc", "c"),
                      "blc", "bc")


def _causal_conv_plain(u, w, b):
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for k in range(K):
        out = out + pad[:, k:k + u.shape[1], :] * w[k]
    return out + b


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return torch.split(zxbcdt, [di, di + 2 * g * n, cfg.ssm_heads], dim=-1)


def ssm_block(p, x, cfg: ArchConfig, state=None, return_cache: bool = False):
    """Full Mamba-2 mixer over a sequence. x: (B, L, D).

    Returns (out, final_state) or, with ``return_cache``, (out, decode cache
    dict matching :func:`init_ssm_cache`)."""
    B_, L, D = x.shape
    di, nh, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xbc_raw, dt = _split_proj(x @ p["in_proj"], cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, Bv, Cv = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                          # (B,L,nh)
    A = -torch.exp(p["A_log"].float())
    y, final = ssd_scan(
        xin.reshape(B_, L, nh, hd), dt, A,
        Bv.reshape(B_, L, g, n), Cv.reshape(B_, L, g, n),
        cfg.ssm_chunk, state)
    y = y + xin.reshape(B_, L, nh, hd) * p["D"][:, None]
    y = y.reshape(B_, L, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_cache:
        K = cfg.ssm_conv
        return out, {"state": final.to(x.dtype),
                     "conv": xbc_raw[:, L - (K - 1):, :]}
    return out, final


def ssm_decode(p, x, cfg: ArchConfig, cache):
    """One-token decode. x: (B, 1, D); cache: {'state': (B,h,p,n),
    'conv': (B, K-1, conv_channels)}. Returns (out, new cache)."""
    B_, _, D = x.shape
    di, nh, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt = _split_proj(x[:, 0] @ p["in_proj"], cfg)
    conv_in = torch.cat([cache["conv"], xbc[:, None]], dim=1)   # (B,K,Ch)
    xbc = F.silu((conv_in * p["conv_w"]).sum(dim=1) + p["conv_b"])
    new_conv = conv_in[:, 1:]
    xin, Bv, Cv = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, new_state = ssd_decode_step(
        xin.reshape(B_, nh, hd), dt, A,
        Bv.reshape(B_, g, n), Cv.reshape(B_, g, n), cache["state"])
    y = y + xin.reshape(B_, nh, hd) * p["D"][:, None]
    y = y.reshape(B_, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], \
        {"state": new_state.to(cache["state"].dtype), "conv": new_conv}


def init_ssm_cache(cfg: ArchConfig, batch: int, device=None,
                   dtype=torch.float32):
    di, nh, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    return {
        "state": torch.zeros((batch, nh, hd, n), device=device, dtype=dtype),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * g * n),
                            device=device, dtype=dtype),
    }

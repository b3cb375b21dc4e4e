"""Jamba-v0.1-52B [arXiv:2403.19887].

Hybrid: attention : Mamba = 1 : 7 (one attn layer at position 4 of each
8-layer block), MoE (16 experts, top-2) on every other layer. Mamba layers
use the SSD parameterization (DESIGN.md deviation #6).
"""

from repro_torch.arch.config import ArchConfig, LayerSpec

_pattern = tuple(
    LayerSpec("attn" if i == 4 else "ssm",
              "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    d_ff_expert=14336,
    n_experts=16,
    experts_per_token=2,
    vocab=65536,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    pattern=_pattern,
)

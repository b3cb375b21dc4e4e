"""Phi-4-mini-3.8B [arXiv:2412.08905]. RoPE + SwiGLU + GQA (24h/8kv)."""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    pattern=(LayerSpec("attn", "dense"),),
)

"""Qwen2-7B [arXiv:2407.10671]. GQA (28h/4kv), QKV bias, SwiGLU."""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    pattern=(LayerSpec("attn", "dense"),),
)

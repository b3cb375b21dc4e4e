"""Qwen2-0.5B [arXiv:2407.10671]. GQA (14h/2kv), QKV bias."""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    pattern=(LayerSpec("attn", "dense"),),
)

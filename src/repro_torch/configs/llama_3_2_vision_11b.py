"""Llama-3.2-11B-Vision backbone [hf:meta-llama/Llama-3.2-11B-Vision].

40 layers: a gated cross-attention (image) layer every 5th layer (8 total).
The ViT vision encoder + projector are stubs: ``image_embeds`` arrive as
precomputed (B, n_image_tokens, d_model) patch embeddings.
"""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    n_image_tokens=1024,
    rope_theta=5e5,
    pattern=(
        LayerSpec("cross_attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
    ),
)

"""MusicGen-medium decoder backbone [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens. The EnCodec codec and the
text-conditioning frontend are stubs per the assignment carve-out; the
backbone consumes audio token ids directly. GeLU MLP (pre-SwiGLU era),
full attention — long_500k runs via the sliding-window variant (DESIGN.md).
"""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_type="gelu",
    rope_theta=1e4,
    pattern=(LayerSpec("attn", "dense"),),
)

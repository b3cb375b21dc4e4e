"""Mamba2-130m [arXiv:2405.21060]. Attention-free SSD; no MLP (d_ff=0)."""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,          # unused by SSM layers; kept for config uniformity
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    pattern=(LayerSpec("ssm", "none"),),
)

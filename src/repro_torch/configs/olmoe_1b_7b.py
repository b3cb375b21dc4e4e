"""OLMoE-1B-7B [arXiv:2409.02060]. MoE: 64 experts, top-8, FFN width 1024."""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    d_ff_expert=1024,
    n_experts=64,
    experts_per_token=8,
    vocab=50304,
    pattern=(LayerSpec("attn", "moe"),),
)

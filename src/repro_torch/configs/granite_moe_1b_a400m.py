"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

MoE: 32 experts, top-8, expert FFN width 512.
"""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,
    d_ff_expert=512,
    n_experts=32,
    experts_per_token=8,
    vocab=49155,
    pattern=(LayerSpec("attn", "moe"),),
)

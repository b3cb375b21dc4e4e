"""Moonlight-16B-A3B (moonshot) [hf:moonshotai/Moonlight-16B-A3B].

MoE: 64 routed experts, top-6, expert FFN width 1408. 3B active params.
(The released model also has shared experts and a dense first layer; we
implement the assigned spec exactly — noted in DESIGN.md.)
"""

from repro_torch.arch.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    d_ff_expert=1408,
    n_experts=64,
    experts_per_token=6,
    vocab=163840,
    pattern=(LayerSpec("attn", "moe"),),
)

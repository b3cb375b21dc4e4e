"""Architecture configuration covering all six assigned families."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class LayerSpec:
    """One layer within the repeating block pattern."""

    mixer: str = "attn"          # "attn" | "ssm" | "cross_attn"
    ffn: str = "dense"           # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"     # "swiglu" | "gelu"
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (SSD / Mamba-2 parameterization)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    # attention variants
    sliding_window: int = 0      # 0 -> full attention
    # VLM
    n_image_tokens: int = 0
    # repeating block pattern; empty -> derived from family defaults
    pattern: tuple[LayerSpec, ...] = ()
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if not self.pattern:
            object.__setattr__(self, "pattern", (LayerSpec("attn", "dense"),))
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return replace(self, sliding_window=window)

    def reduced(self, d_model: int = 0, n_experts: int = 0) -> "ArchConfig":
        """Smoke-test variant: 1 pattern repeat, small widths, <=4 experts."""
        d = d_model or min(self.d_model, 128)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        e = (n_experts or min(self.n_experts, 4)) if self.n_experts else 0
        per_tok = min(self.experts_per_token, max(e, 1)) if e else 0
        # Keep one layer per distinct spec so the family's structure survives
        # (e.g. jamba keeps one attn + one ssm, moe + dense), capped at 4.
        distinct: list[LayerSpec] = []
        for s in self.pattern:
            if s not in distinct:
                distinct.append(s)
        pat2 = tuple(distinct[:4])
        if len(pat2) == 1:
            pat2 = pat2 * 2
        n_layers = len(pat2)
        return replace(
            self, name=self.name + "-reduced", n_layers=n_layers, d_model=d,
            n_heads=heads, n_kv_heads=max(1, kv), d_head=max(d // heads, 8),
            d_ff=min(self.d_ff, 4 * d) or 0,
            d_ff_expert=min(self.d_ff_expert, 2 * d) if self.d_ff_expert else 0,
            vocab=min(self.vocab, 512), n_experts=e, experts_per_token=per_tok,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16),
            ssm_chunk=16,
            n_image_tokens=min(self.n_image_tokens, 16) if self.n_image_tokens else 0,
            pattern=pat2)

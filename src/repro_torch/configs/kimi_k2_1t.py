"""Kimi-K2 1T-A32B [arXiv:2501 Kimi K2 tech report] — 384-expert top-8
MoE, d_ff_expert 2048. ~1.03T total / ~32B active params. Trains with
Adafactor-class state (1T of Adam fp32 m/v cannot fit a v5e pod;
EXPERIMENTS.md reports per-chip bytes for both meshes)."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab=163840,
        n_experts=384, top_k=8, d_ff_expert=2048, moe_impl="ep",
        optimizer="adafactor",
    )

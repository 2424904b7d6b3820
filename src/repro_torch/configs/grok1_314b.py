"""Grok-1 314B [hf:xai-org/grok-1] — 8-expert top-2 MoE. 8 experts % 16
!= 0 → EP falls back to TP-sharded experts (moe_impl='tp');
DESIGN.md §6 sharding auto-solver."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab=131072,
        n_experts=8, top_k=2, d_ff_expert=32768, moe_impl="tp",
        optimizer="adafactor",
    )

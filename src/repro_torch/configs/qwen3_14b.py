"""Qwen3-14B [hf:Qwen/Qwen3-14B] — qk_norm, GQA. 40 heads % 16 != 0 →
the sharding rules fall back to context parallelism for attention."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    )

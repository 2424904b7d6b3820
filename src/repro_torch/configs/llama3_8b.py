"""Llama-3-8B [arXiv:2407.21783] — GQA, 128k vocab."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256, rope_theta=5e5,
    )

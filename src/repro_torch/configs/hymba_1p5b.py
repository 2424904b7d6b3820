"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + mamba
heads in every block, SWA for the attention half. 25 heads % 16 != 0 →
CP fallback for the attention half."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001,
        ssm_state=16, ssm_headdim=50, ssm_expand=2, ssm_chunk=256,
        tie_embeddings=True,
        swa_window=1024,
    )

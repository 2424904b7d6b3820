"""InternVL2-Llama3-76B [arXiv:2404.16821] — InternViT frontend (STUB:
precomputed patch embeddings) + Llama3-70B-class backbone."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256, frontend="vlm", rope_theta=5e5,
    )

"""Granite-20B-Code [arXiv:2405.04324; hf:ibm-granite] — MQA (kv=1),
GPT-BigCode-style non-gated MLP."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152, mlp_gated=False, rope_theta=1e4,
    )

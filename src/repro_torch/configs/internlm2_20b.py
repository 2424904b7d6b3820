"""InternLM2-20B [arXiv:2403.17297; hf:internlm/internlm2-20b]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92544, rope_theta=1e6,
    )

"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens;
frontend (EnCodec codebook embeddings) is a STUB providing precomputed
frame embeddings. MHA (kv=24), non-gated MLP. 24 heads % 16 != 0 → CP."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="dense",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, mlp_gated=False, frontend="audio",
        rope_theta=1e4,
    )

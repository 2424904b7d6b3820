"""Shared layers: norms, RoPE, MLPs, embeddings, losses (plain PyTorch),
with the reference's fp32 casts (``src/repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# vocabulary columns of one fp32 unembedding product: bounds the fp32 copy
# of the (d_model, vocab) matrix (7168 × 16384 × 4 B = 470 MB at Kimi-K2's
# width) instead of casting all of it (4.7 GB) at once
UNEMBED_CHUNK = 16384


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs             # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:  # SwiGLU
        g = x @ p["w_gate"]
        h = x @ p["w_in"]
        a = F.silu(g.float()).to(x.dtype) * h
    else:      # GPT-style 2-matrix GELU
        h = x @ p["w_in"]
        a = gelu(h.float()).to(x.dtype)
    return a @ p["w_out"]


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits over the true (unpadded) vocab, fp32. Computed in chunks of
    :data:`UNEMBED_CHUNK` vocabulary columns: each logit is the same fp32
    dot product, without an fp32 copy of the whole matrix."""
    xf = x.float()
    return torch.cat([xf @ w[:, c:min(c + UNEMBED_CHUNK, vocab)].float()
                      for c in range(0, vocab, UNEMBED_CHUNK)], dim=-1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 1e-4):
    """Mean CE over all positions + z-loss; logits fp32 (..., V)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = (lse - ll).mean()
    zl = z_loss * (lse ** 2).mean()
    return ce + zl, {"ce": ce, "z_loss": zl}

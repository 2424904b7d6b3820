"""Shared layers: norms, RoPE, MLPs, embeddings, losses (plain PyTorch),
with the reference's fp32 casts (``src/repro/models/layers.py``).

Under a split of the vocabulary over ``model`` (the embedding and
unembedding hold the rank's block of rows or columns) the lookup is
masked to the block (:func:`embed_tokens` with ``v0``), the logits are
the block's (:func:`vocab_logits`, padding masked to −inf) and the loss
is :func:`cross_entropy_split`. :func:`mlp` is the same code on the
rank's FFN columns: ``w_in``/``w_gate`` column-parallel, ``w_out``
row-parallel, so its output is then a partial sum over the model
peers."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C

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


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 v0: int | None = None) -> torch.Tensor:
    """The table's rows of ``tokens``; with ``v0`` the table is the block
    of vocabulary rows [v0, v0 + rows), and a token outside it gives a
    zero row (the model peers' lookups then sum to the whole one)."""
    if v0 is None:
        return table[tokens]
    t = tokens.long() - v0
    mine = (t >= 0) & (t < table.shape[0])
    rows = table[t.clamp(0, table.shape[0] - 1)]
    return rows * mine[..., None].to(rows.dtype)


def unembed(w: torch.Tensor, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits over the true (unpadded) vocab, fp32. Computed in chunks of
    :data:`UNEMBED_CHUNK` vocabulary columns: each logit is the same fp32
    dot product, without an fp32 copy of the whole matrix."""
    xf = x.float()
    return torch.cat([xf @ w[:, c:min(c + UNEMBED_CHUNK, vocab)].float()
                      for c in range(0, vocab, UNEMBED_CHUNK)], dim=-1)


def vocab_logits(w: torch.Tensor, x: torch.Tensor, vocab: int,
                 v0: int) -> torch.Tensor:
    """fp32 logits of the vocabulary block ``w`` (D, n), the columns
    [v0, v0 + n) of the padded unembedding, in chunks as
    :func:`unembed`; the padding columns (at or past ``vocab``) are
    −inf, so every rank's block has one width."""
    xf = x.float()
    n = w.shape[1]
    out = torch.cat([xf @ w[:, c:c + UNEMBED_CHUNK].float()
                     for c in range(0, n, UNEMBED_CHUNK)], dim=-1)
    if v0 + n > vocab:
        pad = torch.arange(v0, v0 + n, device=out.device) >= vocab
        out = out.masked_fill(pad, float("-inf"))
    return out


def cross_entropy_split(logits: torch.Tensor, targets: torch.Tensor,
                        v0: int, group, z_loss: float = 1e-4):
    """:func:`cross_entropy` of logits split over ``group`` by vocabulary
    block (this rank's (..., n) columns start at ``v0``): the
    log-sum-exp from the all-reduced max and sum of exponentials, the
    target's logit picked where it lies in the block and all-reduced,
    the z-loss from the same log-sum-exp."""
    n = logits.shape[-1]
    m = C.all_reduce_max_(logits.detach().amax(dim=-1), group)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    t = targets.long() - v0
    mine = (t >= 0) & (t < n)
    picked = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros_like(picked))
    se, ll = C.all_reduce(torch.stack([se, picked]), group).unbind(0)
    lse = torch.log(se) + m
    ce = (lse - ll).mean()
    zl = z_loss * (lse ** 2).mean()
    return ce + zl, {"ce": ce, "z_loss": zl}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 1e-4):
    """Mean CE over all positions + z-loss; logits fp32 (..., V)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = (lse - ll).mean()
    zl = z_loss * (lse ** 2).mean()
    return ce + zl, {"ce": ce, "z_loss": zl}

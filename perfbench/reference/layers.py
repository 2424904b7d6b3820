"""Plain float32 layers shared by the references: norms, RoPE, products.

Imports nothing of the program. Every product goes through :func:`mm`,
which computes in float32 with TF32 off, or, for the benchmark's control,
with both operands rounded to float8 (e4m3) first: the weight with one
scale for the whole matrix, the activations with one scale a row. With
``bf16`` both operands are rounded to bfloat16 (a witness of what the
configuration's own precision does to a number, not a control).
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def no_tf32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn and back to float32, scaled so its
    largest magnitude (over ``dim``, or all of it) maps to 448."""
    t = t.float()
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32",
       contract: int = 1) -> torch.Tensor:
    """``x``'s last ``contract`` dims against ``w``'s first ``contract``
    dims, in float32: (..., K) x (K, ...) → (..., ...)."""
    k = 1
    for s in w.shape[:contract]:
        k *= s
    lead, tail = x.shape[:x.dim() - contract], w.shape[contract:]
    xf = x.reshape(-1, k).float()
    wf = w.reshape(k, -1).float()
    if precision == "fp8":
        xf, wf = fp8(xf, -1), fp8(wf)
    elif precision == "bf16":
        xf, wf = xf.bfloat16().float(), wf.bfloat16().float()
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return (xf @ wf).reshape(lead + tail)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on the whole head, halves rotated as pairs:
    x (..., S, heads, hd), positions (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = positions.float()[:, None] * freqs                  # (S, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def logits(x: torch.Tensor, w: torch.Tensor, vocab: int, precision: str,
           chunk: int = 16384) -> torch.Tensor:
    """(..., vocab) float32 logits of hidden states ``x`` against the
    (d, padded vocab) unembedding ``w``, in blocks of vocabulary
    columns."""
    return torch.cat([mm(x, w[:, c:min(c + chunk, vocab)], precision)
                      for c in range(0, vocab, chunk)], dim=-1)

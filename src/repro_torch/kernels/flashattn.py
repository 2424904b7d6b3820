"""c6_flashattn — fused blockwise attention as one "instruction", on the H100.

Flash attention is a carried-state streaming primitive: the running max
m and normaliser l play the role of c3_prefixsum's carried batch total,
K/V blocks stream past while the accumulator stays on chip. One fused
kernel replaces the einsum → mask → softmax → einsum sequence.

The kernel is CUDA C++ (``csrc/flashattn.cu``, built by ``_cuda.py``):
**K8** (:data:`K8`, replaces ``flash_attention_pallas``). It takes q, k, v
as (B, H, S, D) with any (batch, head, seq) strides and a unit head-dim
stride, so the model's (B, S, H, D) activations are read through a
transposed view without a copy, and writes its output into a (B, S, H, D)
buffer returned as the (B, H, S, D) view. In bfloat16 (the LM's path) it
runs on the tensor cores: one block per (batch·head, 128-row q tile), q
and 128-row k/v tiles loaded by TMA, ``wgmma`` for q·kᵀ and for p·v with p
split into three bf16 terms (p1 + p2 + p3, error ≤ 2⁻²⁴·p), each 16 keys'
products summed apart and added to the output's accumulator in fp32 (the
tensor cores round their sums toward zero). TMA needs
16-byte-aligned bases and strides: an operand that has neither is copied
once with ``.contiguous()`` inside K8 (counted in ``K8.aligned_copies``).
In float32 it computes the products as fp32 FMAs (the tensor cores would
round fp32 to TF32), one block per :data:`BLOCK`-row q tile, looping over
k/v tiles of :data:`BLOCK` rows. Both skip k/v tiles wholly above the
causal diagonal.

The causal mask is aligned bottom-right (query i sees key j iff
j <= i + sk - sq), as ``ref.flash_attention`` aligns it; the TPU kernel
takes causal attention only at sq == sk. A causal call with sq > sk
would leave rows with no visible key and raises.

:func:`flash_attention_plain` is its plain PyTorch version: the same
blocked online softmax (fp32 logits, -1e30 mask, running m, l and acc in
fp32, ``acc / max(l, 1e-30)`` cast to q's dtype), vectorised across
batch·head and q tiles, looping over the k/v tiles. ``interpret`` mode
runs it on any device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.fused_kernel import check_cuda

from . import _cuda

NEG_INF = -1e30
BLOCK = 64                    # q rows of a K8 block, k/v rows of its tiles
#                               (float32; the plain version's blocks)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_SIGNATURES = {
    # (dtype, d, q, k, v, o, batch, heads, sq, sk, 12 strides, scale,
    #  causal, stream)
    "k8_flash_attention": (_cuda.I32, _cuda.I32, _cuda.P, _cuda.P, _cuda.P,
                           _cuda.P, _cuda.I64, _cuda.I32, _cuda.I32,
                           _cuda.I32, *(_cuda.I64,) * 12, ctypes.c_float,
                           _cuda.I32, _cuda.P),
}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.ndim < 2 or k.shape != v.shape or k.shape[:-2] != q.shape[:-2] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (..., sq, d) and "
                         f"(..., sk, d) with the same leading dims")
    sq, sk = q.shape[-2], k.shape[-2]
    if sk == 0:
        raise ValueError("attention over no keys")
    if causal and sq > sk:
        raise ValueError(f"causal attention with sq={sq} > sk={sk} leaves "
                         f"rows with no visible key")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None,
                          block_q: int = BLOCK,
                          block_k: int = BLOCK) -> torch.Tensor:
    """K8's plain PyTorch version. q (..., sq, d), k and v (..., sk, d);
    blocks of ``block_q`` q rows and ``block_k`` k/v rows (ragged ends are
    padded: padded keys get -inf, so their p is exactly 0)."""
    _check(q, k, v, causal)
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)

    def rows_to(t, n):          # (BH, n, d) fp32, zero rows past the end
        return torch.nn.functional.pad(t.float().reshape(-1, t.shape[-2], d),
                                       (0, 0, 0, n - t.shape[-2]))

    qf = rows_to(q, nq * bq).reshape(-1, nq, bq, d)
    kf, vf = rows_to(k, nk * bk), rows_to(v, nk * bk)
    dev = q.device
    qpos = torch.arange(nq * bq, device=dev).reshape(nq, bq, 1)
    m = torch.full(qf.shape[:-1] + (1,), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j in range(nk):
        kpos = torch.arange(j * bk, (j + 1) * bk, device=dev)
        s = torch.einsum("bnqd,bkd->bnqk", qf,
                         kf[:, j * bk:(j + 1) * bk]) * scale
        if causal:
            s = torch.where(qpos + (sk - sq) >= kpos, s, NEG_INF)
        s = torch.where(kpos < sk, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bnqk,bkd->bnqd", p,
                                         vf[:, j * bk:(j + 1) * bk])
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(-1, nq * bq, d)[:, :sq].reshape(*lead, sq, d)


def _strides(t: torch.Tensor) -> list[int]:
    """t's (batch, head, seq) strides, a size-1 dimension's replaced by
    the packed stride there (never read, but a TMA map must hold it)."""
    b, h, s, d = t.shape
    sb, sh, ss = t.stride()[:3]
    ss = ss if s > 1 else d
    sh = sh if h > 1 else s * ss
    sb = sb if b > 1 else h * sh
    return [sb, sh, ss]


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` as it is: a 16-byte-aligned base and
    (batch, head, seq) strides of whole 16-byte units, none of them 0."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s * size % 16 == 0 for s in _strides(t)))


class FlashAttentionKernel:
    """The K8 wrapper. ``launches`` counts kernel launches, and only those;
    ``aligned_copies`` counts the operands it copied for TMA."""

    def __init__(self):
        self.launches = 0
        self.aligned_copies = 0

    def _tma_operand(self, t: torch.Tensor) -> torch.Tensor:
        if tma_aligned(t):
            return t
        self.aligned_copies += 1      # a fresh, packed, aligned buffer
        return t.clone(memory_format=torch.contiguous_format)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
        _check(q, k, v, causal)
        code = _DTYPE_CODES.get(q.dtype)
        if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"K8 takes float32 or bfloat16 q, k, v of one "
                             f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
        if q.ndim != 4:
            raise ValueError(f"K8 takes (B, H, S, D) operands, got "
                             f"{tuple(q.shape)}")
        b, h, sq, d = q.shape
        sk = k.shape[2]
        if d not in HEAD_DIMS:
            raise ValueError(f"K8 takes head dims {HEAD_DIMS}, got {d}")
        check_cuda([q, k, v], "K8")
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        if q.dtype == torch.bfloat16:
            q, k, v = (self._tma_operand(t) for t in (q, k, v))
        # (B, S, H, D) storage: the caller's transpose back is free
        o = torch.empty((b, sq, h, d), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        if b == 0 or sq == 0:
            return o
        if scale is None:
            scale = d ** -0.5
        lib = _cuda.load("flashattn", _SIGNATURES)
        strides = [s for t in (q, k, v, o) for s in _strides(t)]
        with torch.cuda.device(q.device):
            err = lib.k8_flash_attention(
                code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), b, h, sq, sk, *strides, float(scale),
                int(causal), torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K8 flash_attention")
        self.launches += 1
        return o


#: The process-wide kernel wrapper; ``K8.launches`` is the launch count.
K8 = FlashAttentionKernel()

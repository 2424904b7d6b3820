"""c5_topk — router top-k as a key/payload sorting network, on the H100.

This is where the paper's `c2_sort` lands inside a modern LM: MoE expert
routing needs, per token, the k largest of E router logits *with their
indices*. Here that is ONE instruction: a descending bitonic network whose
compare-and-swap units move a (key, lane index) pair, so equal keys come
out in ascending index order (``lax.top_k``'s order) and the first k
lanes are the top-k values and their original positions.

The kernel is CUDA C++ (``csrc/topk.cu``, built by ``_cuda.py``):
**K7** (:data:`K7`, replaces ``topk_pallas``) sorts every row of a
power-of-two width n ≤ :data:`MAX_WIDTH` inside one block's tile and
writes only the first k keys and indices. Rows need no padding to 8:
the reference's ``_pad_rows`` is a TPU tiling rule.

:func:`topk_plain` is its plain PyTorch version: the same network
(``sortnet.bitonic_sort_network`` with the lane index as payload), then
a slice. ``interpret`` mode runs it on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.fused_kernel import check_cuda

from . import _cuda
from .sortnet import _check_pow2, bitonic_sort_network

MAX_WIDTH = 4096              # keys of one row: one block's tile
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}
_SIGNATURES = {
    # (dtype, x, vals, idx, rows, n, k, stream)
    "k7_topk": (_cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
                _cuda.I32, _cuda.P),
}


def _check(x: torch.Tensor, k: int) -> None:
    """The reference's operand checks (``topk_pallas``)."""
    n = x.shape[1]
    _check_pow2(n, f"n={n} (pad to a power of two with the dtype minimum)")
    if k > n:
        raise ValueError(f"k={k} > n={n}")


def topk_plain(x: torch.Tensor, k: int):
    """K7's plain PyTorch version: the descending key/payload network over
    each row, then the first k lanes. x: (rows, n)."""
    lane = torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device).expand(x.shape)
    keys, payload = bitonic_sort_network(x, payload=lane, descending=True)
    return keys[:, :k], payload[:, :k]


class TopKKernel:
    """The K7 wrapper. ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, k: int):
        try:
            code = _DTYPE_CODES[x.dtype]
        except KeyError:
            raise ValueError(f"K7 sorts float32, int32 or bfloat16 keys, "
                             f"got {x.dtype}") from None
        check_cuda([x], "K7")
        rows, n = x.shape
        x = x.contiguous()
        vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
        idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
        if rows == 0:
            return vals, idx
        lib = _cuda.load("topk", _SIGNATURES)
        with torch.cuda.device(x.device):
            err = lib.k7_topk(code, x.data_ptr(), vals.data_ptr(),
                              idx.data_ptr(), rows, n, k,
                              torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K7 topk")
        self.launches += 1
        return vals, idx


#: The process-wide kernel wrapper; ``K7.launches`` is the launch count.
K7 = TopKKernel()


def topk_kernel(x: torch.Tensor, k: int, interpret: bool = False):
    """c5_topk over a 2D operand (rows, n), n a power of two: K7 on CUDA
    tensors, or the plain network (``interpret=True``, any device).
    Returns (values (rows, k), int32 indices (rows, k)), descending."""
    _check(x, k)
    if interpret:
        return topk_plain(x, k)
    if x.shape[1] > MAX_WIDTH:
        raise ValueError(f"K7 sorts rows of at most {MAX_WIDTH} keys, got "
                         f"n={x.shape[1]}")
    return K7(x, k)

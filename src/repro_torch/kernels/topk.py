"""c5_topk — router top-k on the H100.

This is where the paper's `c2_sort` lands inside a modern LM: MoE expert
routing needs, per token, the k largest of E router logits *with their
indices*. The JAX kernel (``topk_pallas``) spells it as ONE instruction:
a descending bitonic network whose compare-and-swap units move a (key,
lane index) pair, so equal keys come out in ascending index order and
the first k lanes are the top-k values and their original positions.

The kernel is CUDA C++ (``csrc/topk.cu``, built by ``_cuda.py``),
**K7** (:data:`K7`, replaces ``topk_pallas``). It computes the top k in
``lax.top_k``'s order (``ref.topk``: the sortable integer key of each
value descending, equal keys in ascending index), which is a strict
total order, so its result is unique. Two routes, chosen by k:

* k ≤ :data:`MAX_PARTIAL_K`: a partial top-k, one warp (or a part of
  one, for narrow rows) a row, each lane keeping its best k in
  registers and shuffle rounds merging the lanes' lists; rows of any
  width;
* larger k: the full network of the JAX kernel on one block's tile,
  rows of at most :data:`MAX_WIDTH` keys.

A row is read in place: (rows, n) stands for rows of ``npow`` (a power
of two ≥ n) whose lanes n … npow-1 hold the dtype's minimum, as the
reference pads the router's 384 experts to 512, and no padded copy is
made. Rows need no padding to 8: the reference's ``_pad_rows`` is a TPU
tiling rule.

:func:`topk_plain` is its plain PyTorch version: the JAX kernel's own
network (``sortnet.bitonic_sort_network`` with the lane index as
payload, comparing values as floats), then a slice; ``interpret`` mode
pads and runs it on any device, as the JAX package's ``interpret`` mode
runs its network. It agrees with K7 and the oracle wherever a row has no
NaN and not both signed zeros.
"""
from __future__ import annotations

import torch

from repro_torch.core.fused_kernel import check_cuda

from . import _cuda
from .sortnet import _check_pow2, bitonic_sort_network

MAX_PARTIAL_K = 32            # k of the partial walk (rows of any width)
MAX_WIDTH = 4096              # keys of one row in the full network (k > 32)
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}
# (dtype, x, vals, idx, rows, ld, n, npow, k, stream)
_ARGS = (_cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I64,
         _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P)
_SIGNATURES = {"k7_topk_partial": _ARGS, "k7_topk_network": _ARGS}


def _check(n: int, npow: int, k: int) -> None:
    """The reference's operand checks (``topk_pallas``), on the padded
    width npow."""
    _check_pow2(npow, f"n={npow} (pad to a power of two with the dtype "
                      f"minimum)")
    if n > npow:
        raise ValueError(f"a row of {n} keys does not fit npow={npow}")
    if k > npow:
        raise ValueError(f"k={k} > n={npow}")


def pad_to(x: torch.Tensor, npow: int) -> torch.Tensor:
    """x (rows, n) padded to npow columns with the dtype's minimum (never
    -inf), as the reference's ``ops._topk_kernel`` pads."""
    n = x.shape[1]
    if npow == n:
        return x
    fill = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).min)
    return torch.cat([x, x.new_full((x.shape[0], npow - n), fill)], dim=1)


def topk_plain(x: torch.Tensor, k: int):
    """The JAX kernel's network as plain PyTorch: the descending
    key/payload network over each row, then the first k lanes.
    x: (rows, n), n a power of two."""
    lane = torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device).expand(x.shape)
    keys, payload = bitonic_sort_network(x, payload=lane, descending=True)
    return keys[:, :k], payload[:, :k]


class TopKKernel:
    """The K7 wrapper. ``launches`` counts kernel launches (either
    route), and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, k: int, npow: int | None = None):
        code = _DTYPE_CODES.get(x.dtype)
        if code is None:
            raise ValueError(f"K7 sorts float32, int32 or bfloat16 keys, "
                             f"got {x.dtype}")
        check_cuda([x], "K7")
        rows, n = x.shape
        npow = n if npow is None else npow
        if x.stride(1) != 1:               # rows may be strided, keys not
            x = x.contiguous()
        vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
        idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
        if rows == 0:
            return vals, idx
        lib = _cuda.load("topk", _SIGNATURES)
        launch = (lib.k7_topk_partial if k <= MAX_PARTIAL_K
                  else lib.k7_topk_network)
        with torch.cuda.device(x.device):
            err = launch(code, x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                         rows, x.stride(0), n, npow, k,
                         torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K7 topk")
        self.launches += 1
        return vals, idx


#: The process-wide kernel wrapper; ``K7.launches`` is the launch count.
K7 = TopKKernel()


def topk_kernel(x: torch.Tensor, k: int, npow: int | None = None,
                interpret: bool = False):
    """c5_topk over a 2D operand (rows, n) standing for rows of ``npow``
    (a power of two, default n) padded with the dtype's minimum: K7 on
    CUDA tensors, reading the rows in place, or the plain network on the
    padded rows (``interpret=True``, any device). Returns (values (rows,
    k), int32 indices (rows, k)), descending."""
    n = x.shape[1]
    npow = n if npow is None else npow
    _check(n, npow, k)
    if interpret:
        return topk_plain(pad_to(x, npow), k)
    if k > MAX_PARTIAL_K and npow > MAX_WIDTH:
        raise ValueError(
            f"K7 takes rows of at most {MAX_WIDTH} keys for k > "
            f"{MAX_PARTIAL_K} (its full network; rows of any width for "
            f"k ≤ {MAX_PARTIAL_K}), got n={npow}, k={k}")
    return K7(x, k, npow)

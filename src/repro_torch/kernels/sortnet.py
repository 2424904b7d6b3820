"""Sorting-network instructions (paper §2.2 Alg. 1 + §4.3.1) for the H100.

The paper's `c2_sort` is a bitonic sorting network over one 256-bit vector
register (8 × 32-bit lanes, 6 CAS layers, 3 cycles); `c1_merge` is the
last log2(N) layers of an odd-even/bitonic merger that merges two sorted
registers, writing the lower half to vrd1 and the upper half to vrd2 —
an I'-type instruction using 2 vector sources *and* 2 vector
destinations.

The network is written here as plain torch functions: each CAS layer is
a vectorised compare-and-select between a lane and its XOR-partner lane
(static reshapes, no gathers). That is the plain version the CPU tests
run and the chip smoke test holds the kernels against.

The kernels are CUDA C++ (``csrc/sortnet.cu``, built by ``_cuda.py``):

* **K5** (:data:`K5`, replaces ``sort_chunks_pallas``) sorts every
  power-of-two ``width`` chunk of each row;
* **K6** (:data:`K6`, replaces ``merge_sorted_pallas``) merges each
  chunk of ``a`` with the reversed chunk of ``b``.

Both run a grid over all tiles of the operand (a sort has no carry) and
take chunks of up to :data:`MAX_CHUNK` keys: a sorted chunk of up to
4096, or two merged halves of up to 2048. Rows need no padding: a
chunk never spans two rows, and the kernels stop at the last key. Both
are built once per network size (L = 1 … 12: log2(width) for K5,
log2(2w) for K6): their layers run on keys a thread holds, with
shuffles (K5) or shared-memory transposes between groups of index bits.
K5 moves each warp's keys as 16-byte vectors on consecutive addresses;
K6 stores 16-byte vectors. A wider chunk would need a merge across
blocks, a kernel of its own: ``sortnet_mergesort`` sends none (its
``max_kernel_width`` is 4096, as in the reference).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fused_kernel import check_cuda

from . import _cuda

MAX_CHUNK = 4096              # keys of one network in K5/K6 (a block's tile)
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}
_SIGNATURES = {
    # (dtype, x, out, n, width, descending, stream)
    "k5_sort_chunks": (_cuda.I32, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
                       _cuda.I32, _cuda.P),
    # (dtype, a, b, lo, hi, rows, cols, lda, ldb, w, descending, stream)
    "k6_merge_sorted": (_cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                        _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I64,
                        _cuda.I32, _cuda.I32, _cuda.P),
}


def _check_pow2(w: int, what: str) -> None:
    if w < 2 or (w & (w - 1)):
        raise ValueError(f"{what} must be a power of two ≥ 2, got {w}")


# ---------------------------------------------------------------------------
# The network itself (static index math: every layer is shuffle + select).
# ---------------------------------------------------------------------------

def _swap_blocks(x: torch.Tensor, j: int) -> torch.Tensor:
    """Value at lane XOR j, as a static reshape + reverse."""
    *lead, w = x.shape
    return x.reshape(*lead, w // (2 * j), 2, j).flip(-2).reshape(*lead, w)


def _cas_layer(keys: torch.Tensor, payload: Optional[torch.Tensor],
               j: int, k: int, descending: bool):
    """One compare-and-swap layer: partner = lane XOR j, direction from k."""
    lane = torch.arange(keys.shape[-1], device=keys.device)
    lower = (lane & j) == 0                 # partner = lane^j → lower iff bit j unset
    asc = (lane & k) == 0                   # ascending sub-block?
    keep_lo = (asc != lower) if descending else (asc == lower)

    kp = _swap_blocks(keys, j)
    lt = keys < kp
    eq = keys == kp
    if payload is None:
        self_is_lo = lt | (eq & lower)      # lane tiebreak (keys only)
        take_self = keep_lo == self_is_lo
        return torch.where(take_self, keys, kp), None
    # With payload, ties need a lane-independent total order so equal keys
    # emerge in ascending-payload order (= top-k tie semantics for the
    # descending sort used by c5_topk).
    pp = _swap_blocks(payload, j)
    tie = (payload > pp) if descending else (payload < pp)
    self_is_lo = lt | (eq & tie)
    take_self = keep_lo == self_is_lo
    return (torch.where(take_self, keys, kp),
            torch.where(take_self, payload, pp))


def bitonic_sort_network(keys: torch.Tensor,
                         payload: Optional[torch.Tensor] = None,
                         descending: bool = False):
    """Full bitonic sort along the last axis (width = static power of 2)."""
    w = keys.shape[-1]
    _check_pow2(w, "sort width")
    k = 2
    while k <= w:
        j = k // 2
        while j >= 1:
            keys, payload = _cas_layer(keys, payload, j, k, descending)
            j //= 2
        k *= 2
    return (keys, payload) if payload is not None else keys


def bitonic_merge_network(keys: torch.Tensor,
                          payload: Optional[torch.Tensor] = None,
                          descending: bool = False):
    """Merge stages only (`c1_merge`): input already bitonic along last axis."""
    w = keys.shape[-1]
    _check_pow2(w, "merge width")
    j = w // 2
    while j >= 1:
        # k = 2w → every sub-block ascending (or descending).
        keys, payload = _cas_layer(keys, payload, j, 2 * w, descending)
        j //= 2
    return (keys, payload) if payload is not None else keys


def n_cas_layers(width: int) -> int:
    """Θ(log²N) layers — the paper's pipeline-depth (c2: width 8 → 6)."""
    lg = int(np.log2(width))
    return lg * (lg + 1) // 2


# ---------------------------------------------------------------------------
# c2_sort — sort every contiguous `width`-chunk of each row.
# ---------------------------------------------------------------------------

def sort_chunks_plain(x: torch.Tensor, width: int,
                      descending: bool = False) -> torch.Tensor:
    """K5's plain PyTorch version: the network over every chunk."""
    r, c = x.shape
    s = bitonic_sort_network(x.reshape(r, c // width, width),
                             descending=descending)
    return s.reshape(r, c)


def _dtype_code(what: str, dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(f"{what} sorts float32, int32 or bfloat16 keys, "
                         f"got {dtype}") from None


def _library():
    return _cuda.load("sortnet", _SIGNATURES)


class SortChunksKernel:
    """The K5 wrapper. ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, width: int,
                 descending: bool) -> torch.Tensor:
        code = _dtype_code("K5", x.dtype)
        check_cuda([x], "K5")
        x = x.contiguous()
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.k5_sort_chunks(
                code, x.data_ptr(), out.data_ptr(), x.numel(), width,
                int(descending), torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K5 sort_chunks")
        self.launches += 1
        return out


class MergeSortedKernel:
    """The K6 wrapper. ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor, width: int,
                 descending: bool):
        code = _dtype_code("K6", a.dtype)
        check_cuda([a, b], "K6")
        # rows may be strided (the mergesort app passes the halves of
        # each pair as views); the last axis must be contiguous
        a, b = (t if t.stride(1) == 1 else t.contiguous() for t in (a, b))
        rows, cols = a.shape
        lo = torch.empty((rows, cols), dtype=a.dtype, device=a.device)
        hi = torch.empty_like(lo)
        if a.numel() == 0:
            return lo, hi
        if rows * cols // width >= 1 << 32:
            raise ValueError(f"K6 merges fewer than 2**32 chunks, got "
                             f"{rows * cols // width}")
        lib = _library()
        with torch.cuda.device(a.device):
            err = lib.k6_merge_sorted(
                code, a.data_ptr(), b.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), rows, cols, a.stride(0), b.stride(0), width,
                int(descending), torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K6 merge_sorted")
        self.launches += 1
        return lo, hi


#: The process-wide kernel wrappers; ``K5.launches`` / ``K6.launches``.
K5 = SortChunksKernel()
K6 = MergeSortedKernel()


def sort_chunks_kernel(x: torch.Tensor, width: int = 8,
                       descending: bool = False,
                       interpret: bool = False) -> torch.Tensor:
    """c2_sort over a 2D operand: K5 on CUDA tensors, or the plain network
    (``interpret=True``, any device).

    Keeps the reference's operand checks (``sort_chunks_pallas``); its
    row/column block nesting is a TPU tiling rule, and K5 tiles the
    operand itself, so only the chunk must nest in the row."""
    rows, cols = x.shape
    _check_pow2(width, "width")
    if cols % width:
        raise ValueError(f"cols={cols} width={width} must nest evenly")
    if interpret:
        return sort_chunks_plain(x, width, descending)
    if width > MAX_CHUNK:
        raise ValueError(f"K5 sorts chunks of at most {MAX_CHUNK} keys, "
                         f"got width={width}")
    return K5(x, width, descending)


# ---------------------------------------------------------------------------
# c1_merge — merge two sorted width-chunks: lower→vrd1, upper→vrd2.
# ---------------------------------------------------------------------------

def merge_sorted_plain(a: torch.Tensor, b: torch.Tensor, width: int,
                       descending: bool = False):
    """K6's plain PyTorch version: per chunk, b reversed, then the merge
    network; the lower half to lo and the upper half to hi."""
    r, c = a.shape
    ar = a.reshape(r, c // width, width)
    br = b.reshape(r, c // width, width).flip(-1)   # reversed → bitonic
    s = bitonic_merge_network(torch.cat([ar, br], dim=-1),
                              descending=descending)
    return (s[..., :width].reshape(r, c), s[..., width:].reshape(r, c))


def merge_sorted_kernel(a: torch.Tensor, b: torch.Tensor,
                        width: Optional[int] = None,
                        descending: bool = False,
                        interpret: bool = False):
    """c1_merge over 2D operands: per row, merge sorted chunks of a with
    those of b. K6 on CUDA tensors, or the plain network
    (``interpret=True``, any device). Checks as ``merge_sorted_pallas``
    (without its TPU block nesting)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError("operands must match")
    rows, cols = a.shape
    width = width or cols
    _check_pow2(width, "width")
    if cols % width:
        raise ValueError("cols/block/width must nest evenly")
    if interpret:
        return merge_sorted_plain(a, b, width, descending)
    if 2 * width > MAX_CHUNK:
        raise ValueError(f"K6 merges chunks of at most {MAX_CHUNK // 2} "
                         f"keys ({MAX_CHUNK} merged), got width={width}")
    return K6(a, b, width, descending)


# ---------------------------------------------------------------------------
# Batcher odd-even mergesort — the paper's other topology (§2.2 cites both;
# c1_merge is "the last log2(N) layers of odd-even mergesort"). Same
# Θ(log²N) depth as bitonic; all-ascending comparators, partner = lane ± k,
# expressed as static shifts + iota masks (no gathers).
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Value at lane+k (k>0) or lane+k (k<0 → lane-|k|), edge-filled."""
    *lead, w = x.shape
    if k > 0:
        pad = torch.full((*lead, k), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x[..., k:], pad], dim=-1)
    pad = torch.full((*lead, -k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :k]], dim=-1)


def _oddeven_cas(keys: torch.Tensor, p: int, k: int) -> torch.Tensor:
    """One odd-even merge layer: compare (x, x+k) for lanes x with
    x ≡ k mod p (mod 2k) and floor(x/2p) == floor((x+k)/2p)."""
    w = keys.shape[-1]
    lane = torch.arange(w, device=keys.device)
    x = lane - (k % p)
    is_lo = ((x >= 0) & (torch.remainder(x, 2 * k) < k)
             & (lane + k < w)
             & ((lane // (2 * p)) == ((lane + k) // (2 * p))))
    up = _shift(keys, k, 0)          # partner above (for lo lanes)
    down = _shift(keys, -k, 0)       # partner below (for hi lanes)
    is_hi_src = _shift(is_lo.to(torch.int32), -k, 0) == 1
    new = torch.where(is_lo, torch.minimum(keys, up), keys)
    new = torch.where(is_hi_src, torch.maximum(new, down), new)
    return new


def oddeven_sort_network(keys: torch.Tensor) -> torch.Tensor:
    """Full Batcher odd-even mergesort along the last axis (ascending)."""
    w = keys.shape[-1]
    _check_pow2(w, "sort width")
    p = 1
    while p < w:
        k = p
        while k >= 1:
            keys = _oddeven_cas(keys, p, k)
            k //= 2
        p *= 2
    return keys

"""Carried prefix-scan instructions (paper §4.3.2, Fig. 7) for the H100.

`c3_prefixsum` pipelines a Hillis–Steele network over each incoming vector
register *plus one extra stage that adds the running total of all previous
batches* — that carried total is what lets one short instruction scan an
arbitrarily long stream without blocking. `c4_chunkscan` generalises the
carry from (+) to the affine map y = a·y_prev + b: Mamba2-SSD's
inter-chunk state recurrence.

**K3** (:data:`K3`, replaces ``prefix_sum_pallas``) is CUDA C++
(``csrc/prefix_scan.cu``, built by ``_cuda.py``): a single-pass chained
scan with decoupled look-back. A row is cut into tiles of 4096 columns,
scanned in parallel by blocks that take their tile from a global counter;
each tile publishes its aggregate, looks back over its predecessors' state
until it meets an inclusive prefix, and publishes its own. So a one-row
operand spreads over every SM. An operand with rows enough to fill the
card (at least twice the SMs, as the MoE router's 384) takes the same
kernel's walk instead: one block a row, the next tile's loads in flight
while the current one is scanned. Both sum in an order of their own:
:func:`k3_bound_constants` gives the constants of its first-order error
bound.

**K4** (:data:`K4`, replaces ``chunk_scan_pallas``) is Triton, one
program per block of ``br`` rows that walks its row's column blocks of
``bc`` in order with the carry in registers, set to 0 before the loop
(the TPU kernel's carry in VMEM scratch across a sequential grid axis,
reset at step 0, becomes that loop): per block ``tl.associative_scan`` of
(a, b) under the affine combine, then ``y = A·carry + B``; the carry is
y's last column. The output and the carry are ``promote(a, b)``.

What bounds them on the H100: device-memory bytes (each input read once,
the output written once; a scan does one or two operations per element).
Ragged rows and columns are masked (a load past the edge reads the
combine's identity), so nothing is padded: the reference pads rows to 8,
a TPU sublane rule that would cost 8× the bytes of a one-row operand.

:func:`prefix_sum_plain` and :func:`chunk_scan_plain` are the plain
PyTorch versions of the same blocked walk (Hillis–Steele inside each
``bc`` block, the carry across blocks, reset per row), which
``interpret`` mode runs on any device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.fused_kernel import check_cuda, load_module

from . import _cuda
from .ref import chunk_scan as _affine_scan
from .ref import shifted

TILE_ELEMS = 4096            # elements of a K4 program's (br, bc) block,
#                              columns of a K3 tile


def block_shape(rows: int, cols: int) -> tuple[int, int]:
    """The (br, bc) block K3/K4 use for a (rows, cols) operand: the whole
    row up to 4096 columns, and as many rows as fill 4096 elements."""
    bc = min(1 << max(cols - 1, 0).bit_length(), TILE_ELEMS)
    br = min(1 << max(rows - 1, 0).bit_length(), TILE_ELEMS // bc)
    return br, bc


# ---------------------------------------------------------------------------
# in-block networks (the reference's, on torch tensors) and the plain walk
# ---------------------------------------------------------------------------

def _hs_shift_add(x: torch.Tensor) -> torch.Tensor:
    """Hillis–Steele inclusive scan: log2(cols) shifted adds (static)."""
    c = x.shape[-1]
    d = 1
    while d < c:
        x = x + shifted(x, d, -1, 0)
        d *= 2
    return x


def _affine_hs(a: torch.Tensor, b: torch.Tensor):
    """HS scan under affine composition: (A,B)_i ∘ (A,B)_{i-d}."""
    c = a.shape[-1]
    d = 1
    while d < c:
        b = b + a * shifted(b, d, -1, 0)
        a = a * shifted(a, d, -1, 1)
        d *= 2
    return a, b


def _blocks(x: torch.Tensor, bc: int, fill) -> torch.Tensor:
    """(rows, cols) → (rows, ncb, bc), the ragged last block filled."""
    rows, cols = x.shape
    pad = (-cols) % bc
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=fill)
    return x.reshape(rows, -1, bc)


def prefix_sum_plain(x: torch.Tensor, bc: int) -> torch.Tensor:
    """K3's blocked walk in torch eager: Hillis–Steele inside each block of
    ``bc`` columns, plus the carry of the blocks before it in the row."""
    rows, cols = x.shape
    hs = _hs_shift_add(_blocks(x, bc, 0))
    totals = hs[:, :, -1]
    carry = shifted(torch.cumsum(totals, dim=1, dtype=x.dtype), 1, 1, 0)
    return (hs + carry[:, :, None]).reshape(rows, -1)[:, :cols]


def chunk_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     bc: int) -> torch.Tensor:
    """K4's blocked walk in torch eager: the affine Hillis–Steele inside
    each block, then y = A·carry + B with the carry = the previous
    block's last y (y before the row's first block = 0)."""
    rows, cols = a.shape
    dt = torch.promote_types(a.dtype, b.dtype)
    acum, bcum = _affine_hs(_blocks(a.to(dt), bc, 1), _blocks(b.to(dt), bc, 0))
    # the carry into each block: the affine scan of the blocks' totals
    last = _affine_scan(acum[:, :, -1], bcum[:, :, -1])
    carry = shifted(last, 1, 1, 0)
    return (acum * carry[:, :, None] + bcum).reshape(rows, -1)[:, :cols]


# ---------------------------------------------------------------------------
# K4 in Triton, K3 in CUDA C++
# ---------------------------------------------------------------------------

TRITON_SOURCE = '''
import triton
import triton.language as tl


@triton.jit
def _affine(pa, pb, qa, qb):
    return pa * qa, qb + qa * pb


@triton.jit
def k4_chunk_scan(A, B, O, rows, cols, stride_a, stride_b,
                  BR: tl.constexpr, BC: tl.constexpr):
    r = tl.program_id(0).to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)
    arow = A + r[:, None] * stride_a
    brow = B + r[:, None] * stride_b
    orow = O + r[:, None] * cols
    last = (tl.arange(0, BC) == BC - 1)[None, :]
    carry = tl.zeros((BR,), O.dtype.element_ty)
    for c0 in range(0, cols, BC):
        c = c0 + tl.arange(0, BC)
        m = (r < rows)[:, None] & (c < cols)[None, :]
        a = tl.load(arow + c[None, :], mask=m, other=1).to(O.dtype.element_ty)
        b = tl.load(brow + c[None, :], mask=m, other=0).to(O.dtype.element_ty)
        acum, bcum = tl.associative_scan((a, b), 1, _affine)
        y = (acum * carry[:, None] + bcum).to(O.dtype.element_ty)
        tl.store(orow + c[None, :], y, mask=m)
        carry = tl.sum(tl.where(last, y, 0), axis=1).to(O.dtype.element_ty)
'''


def _triton_kernels():
    """The module of K4, written into the build directory and imported
    there at first use (Triton reads a kernel's source through
    ``inspect``)."""
    return load_module(TRITON_SOURCE, prefix="scan")[0]


def _rows_operand(x: torch.Tensor) -> torch.Tensor:
    """Rows may be strided; the scanned axis must be contiguous."""
    return x if x.stride(1) == 1 else x.contiguous()


K3_D_TILE = 25               # adds on an element's way to a tile prefix
_K3_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                   torch.float16: 3}
_K3_SIGNATURES = {
    # (dtype, x, out, rows, cols, stride, scratch, stream)
    "k3_prefix_sum": (_cuda.I32, _cuda.P, _cuda.P, _cuda.I64, _cuda.I64,
                      _cuda.I64, _cuda.P, _cuda.P),
    # (rows, cols, words out)
    "k3_scratch_words": (_cuda.I64, _cuda.I64, ctypes.POINTER(_cuda.I64)),
}


def k3_bound_constants(dtype: torch.dtype, cols: int) -> tuple[int, int]:
    """(k_abs, k_ends) of K3's first-order error bound
    ``eps·(k_abs·Σ_{j≤i}|x_j| + k_ends·Σ_{e<i}|y_e| + |y_i|)`` (e over the
    ends of the row's earlier 4096-column tiles; eps of the output type):
    25 adds at most inside a tile, plus the exclusive prefix rounded once
    from the double look-back (near y at the previous tile's end; one more
    unit of Σ|x| absorbs the look-back's double roundings). In float64 the
    look-back rounds at the working precision: 5 butterfly levels, one add
    for each window of 32 tiles beyond the second (at most ⌈tiles / 32⌉
    windows), and each published value loses up to 3 units of its last
    place to the status bits (3 more on Σ|x| for an aggregate, on y_e for
    an inclusive prefix). The carried walk's constants are
    (⌈log2 bc⌉, 1)."""
    if dtype == torch.float64:
        windows = -(-(-(-cols // TILE_ELEMS)) // 32)
        return K3_D_TILE + 5 + 3 + max(0, windows - 2), 4
    return K3_D_TILE + 1, 1


def walk_bound_constants(cols: int) -> tuple[int, int]:
    """(k_abs, k_ends) of the carried walk (:func:`prefix_sum_plain`): a
    Hillis–Steele tree of depth ⌈log2 bc⌉ in each block, one carry add
    per block."""
    return math.ceil(math.log2(block_shape(1, cols)[1])), 1


class PrefixSumKernel:
    """The K3 wrapper. ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        code = _K3_DTYPE_CODES.get(x.dtype)
        if code is None:
            raise ValueError(f"K3 scans floating-point rows of float32, "
                             f"float64, float16 or bfloat16, got {x.dtype}")
        check_cuda([x], "K3")
        x = _rows_operand(x)
        rows, cols = x.shape
        out = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
        if x.numel() == 0:
            return out
        lib = _cuda.load("prefix_scan", _K3_SIGNATURES)
        with torch.cuda.device(x.device):
            # the look-back's tile counter and state words, zero-filled; the
            # walk takes none (the launcher chooses, from the shape)
            words = _cuda.I64()
            _cuda.check(lib, lib.k3_scratch_words(rows, cols,
                                                  ctypes.byref(words)),
                        "K3 scratch")
            scratch = (torch.zeros(words.value, dtype=torch.int64,
                                   device=x.device) if words.value else None)
            err = lib.k3_prefix_sum(
                code, x.data_ptr(), out.data_ptr(), rows, cols, x.stride(0),
                None if scratch is None else scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K3 prefix_sum")
        self.launches += 1
        return out


class ChunkScanKernel:
    """The K4 wrapper. ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(a.dtype, b.dtype)
        if not dt.is_floating_point:
            raise ValueError(f"K4 scans floating-point rows, got {dt}")
        check_cuda([a, b], "K4")
        a, b = _rows_operand(a), _rows_operand(b)
        rows, cols = a.shape
        out = torch.empty((rows, cols), dtype=dt, device=a.device)
        if a.numel() == 0:
            return out
        br, bc = block_shape(rows, cols)
        with torch.cuda.device(a.device):
            _triton_kernels().k4_chunk_scan[(-(-rows // br),)](
                a, b, out, rows, cols, a.stride(0), b.stride(0), BR=br,
                BC=bc, num_warps=8 if br * bc >= 2048 else 4)
        self.launches += 1
        return out


#: The process-wide kernel wrappers; ``K3.launches`` / ``K4.launches``.
K3 = PrefixSumKernel()
K4 = ChunkScanKernel()


def prefix_sum_kernel(x: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of a 2D operand: K3 on
    CUDA tensors, or its blocked walk in torch (``interpret=True``)."""
    if interpret:
        return prefix_sum_plain(x, block_shape(*x.shape)[1])
    return K3(x)


def chunk_scan_kernel(a: torch.Tensor, b: torch.Tensor,
                      interpret: bool = False) -> torch.Tensor:
    """Affine carried scan along the last axis; a, b same 2D shape. K4 on
    CUDA tensors, or its blocked walk in torch (``interpret=True``)."""
    if a.shape != b.shape:
        raise ValueError("a and b must match")
    if interpret:
        return chunk_scan_plain(a, b, block_shape(*a.shape)[1])
    return K4(a, b)

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

**K4** (:data:`K4`, replaces ``chunk_scan_pallas``) is Gluon (Triton
with explicit register layouts), one program per block of ``br`` rows
that walks its row's column blocks of ``bc`` in order with the carry in
registers, set to 0 before the loop (the TPU kernel's carry in VMEM
scratch across a sequential grid axis, reset at step 0, becomes that
loop): per block ``associative_scan`` of (a, b) under the affine
combine, then ``y = A·carry + B``; the carry is y's last column. The
output and the carry are ``promote(a, b)``. Its state-scan entry
(``k4_state_scan``, :meth:`ChunkScanKernel.state_scan`; c4_statescan,
Mamba2's inter-chunk recurrence) walks the same rows in the same blocks
without moving them: a program takes ``br`` contiguous payload elements
of one (batch, head) group of the (B, C, H, P, N) states, its columns
the C chunks at stride H·P·N, and each column's decay ``a[b, c, h]``
loaded once at the decay's own rank. The reference instead broadcasts
the decay to the states' rank and moves the chunk axis last, two copies
the size of the states. The entry loads and stores along the contiguous
payload rows and converts each tile, through shared memory, to the
layout both entries scan in (:func:`scan_layout`). A scan's combine
order follows its layout, so one stated layout and one block body
(``_scan_block``) make the entry K4's result bit for bit.

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


def chunk_scan_plain(a: torch.Tensor, b: torch.Tensor, bc: int,
                     reverse: bool = False) -> torch.Tensor:
    """K4's blocked walk in torch eager: the affine Hillis–Steele inside
    each block, then y = A·carry + B with the carry = the previous
    block's last y (y before the row's first block = 0). ``reverse``
    walks each row from its last column, as K4's ``REVERSE`` does: the
    same walk on the columns in reverse order."""
    if reverse:
        return chunk_scan_plain(a.flip(1), b.flip(1), bc).flip(1)
    rows, cols = a.shape
    dt = torch.promote_types(a.dtype, b.dtype)
    acum, bcum = _affine_hs(_blocks(a.to(dt), bc, 1), _blocks(b.to(dt), bc, 0))
    # the carry into each block: the affine scan of the blocks' totals
    last = _affine_scan(acum[:, :, -1], bcum[:, :, -1])
    carry = shifted(last, 1, 1, 0)
    return (acum * carry[:, :, None] + bcum).reshape(rows, -1)[:, :cols]


def state_scan_map(a: torch.Tensor, states: torch.Tensor, axis: int):
    """How K4's state-scan entry walks ``states`` in place: (the decay at
    the states' leading dims, contiguous; the walk's sizes).

    The states are (outer, cols, inner) around the scanned ``axis``
    (counted on the states). A group g = (o, ai) is ``rows`` contiguous
    payload elements that share one decay per column; its column c lies
    at ``(o·cols + c)·inner + ai·rows``, and its decay at
    ``(o // a_div)·a_outer + ai + c·a_col`` of the flat decay. Where the
    axis is one of the decay's (SSD: a (B, C, H), states (B, C, H, P,
    N), axis 1) there are ``a_in`` decays per (o, c), each shared by
    ``rows`` = inner / a_in elements; past the decay's dims the decay is
    constant along the axis (a_col = 0) and shared by a_div outer
    indices."""
    nd = states.ndim
    if not (-nd <= axis < nd) or a.ndim > nd:
        raise IndexError(f"axis {axis} and decay rank {a.ndim} for states "
                         f"of rank {nd}")
    ax = axis % nd
    shape = tuple(states.shape)
    a = a.expand(shape[:a.ndim]).contiguous()
    outer, cols = math.prod(shape[:ax]), shape[ax]
    inner = math.prod(shape[ax + 1:])
    if ax < a.ndim:
        a_in = math.prod(shape[ax + 1:a.ndim])
        walk = dict(a_in=a_in, rows=inner // max(a_in, 1), a_div=1,
                    a_outer=cols * a_in, a_col=a_in)
    else:
        walk = dict(a_in=1, rows=inner, a_div=math.prod(shape[a.ndim:ax]),
                    a_outer=1, a_col=0)
    return a, dict(outer=outer, cols=cols, inner=inner, **walk)


def state_scan_plain(a: torch.Tensor, states: torch.Tensor,
                     axis: int, reverse: bool = False) -> torch.Tensor:
    """K4's state-scan entry in torch eager: the rows of
    :func:`state_scan_map`'s groups, with their decays gathered by the
    kernel's own index, through :func:`chunk_scan_plain` at the block
    K4 uses, and back into the states' layout. ``reverse`` walks the
    chunks from the last one (states and decays), as ``REVERSE`` does."""
    dt = torch.promote_types(a.dtype, states.dtype)
    a, w = state_scan_map(a, states, axis)
    if reverse:
        ax = axis % states.ndim
        a = a.flip(ax) if ax < a.ndim else a
        return state_scan_plain(a, states.flip(ax), axis).flip(ax)
    outer, cols, a_in, rows = w["outer"], w["cols"], w["a_in"], w["rows"]
    if states.numel() == 0:
        return torch.empty(states.shape, dtype=dt, device=states.device)
    dev = states.device
    o = torch.arange(outer, device=dev)[:, None, None]
    c = torch.arange(cols, device=dev)[None, :, None]
    ai = torch.arange(a_in, device=dev)[None, None, :]
    idx = (o // w["a_div"]) * w["a_outer"] + ai + c * w["a_col"]
    ag = a.reshape(-1)[idx]                          # (outer, cols, a_in)
    ra = ag.permute(0, 2, 1)[:, :, None, :].expand(outer, a_in, rows, cols)
    rb = states.reshape(outer, cols, a_in, rows).permute(0, 2, 3, 1)
    bc = block_shape(states.numel() // cols, cols)[1]
    out = chunk_scan_plain(ra.reshape(-1, cols), rb.reshape(-1, cols), bc)
    return out.reshape(outer, a_in, rows, cols).permute(0, 3, 1, 2).reshape(
        states.shape)


# ---------------------------------------------------------------------------
# K4 in Gluon, K3 in CUDA C++
# ---------------------------------------------------------------------------

GLUON_SOURCE = '''
from triton.experimental import gluon
from triton.experimental.gluon import language as gl


@gluon.jit
def _affine(pa, pb, qa, qb):
    return pa * qa, qb + qa * pb


@gluon.jit
def _scan_block(a, b, carry, last):
    # one (BR, BC) block in SCAN: the affine scan along the columns, the
    # carry in; returns (y, y's last column: the next block's carry)
    acum, bcum = gl.associative_scan((a, b), 1, _affine)
    y = (acum * gl.expand_dims(carry, 1) + bcum).to(carry.dtype)
    return y, gl.sum(gl.where(last, y, 0), axis=1).to(carry.dtype)


@gluon.jit
def k4_chunk_scan(A, B, O, rows, cols, stride_a, stride_b,
                  BR: gl.constexpr, BC: gl.constexpr, SCAN: gl.constexpr,
                  REVERSE: gl.constexpr):
    # REVERSE walks each row from its last column: step c of the walk
    # loads and stores column cols-1-c, in the same layout and order
    r = (gl.program_id(0).to(gl.int64) * BR
         + gl.arange(0, BR, layout=gl.SliceLayout(1, SCAN)).to(gl.int64))
    cs = gl.arange(0, BC, layout=gl.SliceLayout(0, SCAN))
    arow = A + gl.expand_dims(r, 1) * stride_a
    brow = B + gl.expand_dims(r, 1) * stride_b
    orow = O + gl.expand_dims(r, 1) * cols
    last = gl.expand_dims(cs == BC - 1, 0)
    carry = gl.zeros([BR], O.dtype.element_ty, layout=gl.SliceLayout(1, SCAN))
    for c0 in range(0, cols, BC):
        c = gl.expand_dims(c0 + cs, 0)
        m = gl.expand_dims(r < rows, 1) & (c < cols)
        if REVERSE:
            c = cols - 1 - c
        a = gl.load(arow + c, mask=m, other=1).to(O.dtype.element_ty)
        b = gl.load(brow + c, mask=m, other=0).to(O.dtype.element_ty)
        y, carry = _scan_block(a, b, carry, last)
        gl.store(orow + c, y, mask=m)


@gluon.jit
def k4_state_scan(A, S, O, n_rb, rows, cols, inner, a_in, a_div, a_outer,
                  a_col, BR: gl.constexpr, BC: gl.constexpr,
                  SCAN: gl.constexpr, MOVE: gl.constexpr,
                  REVERSE: gl.constexpr):
    # group g = (outer index o, decay index ai): `rows` contiguous payload
    # elements, its columns the chunks at stride `inner`. Loads and stores
    # go along the rows (MOVE); the scan runs in SCAN, k4_chunk_scan's
    # layout, so each row is combined in k4_chunk_scan's order. REVERSE
    # maps the chunk index as k4_chunk_scan's does, decays included.
    pid = gl.program_id(0)
    g = pid // n_rb
    o = g // a_in
    ai = g % a_in
    sbase = o.to(gl.int64) * cols * inner + ai.to(gl.int64) * rows
    abase = (o // a_div).to(gl.int64) * a_outer + ai
    r = (pid % n_rb) * BR + gl.arange(0, BR, layout=gl.SliceLayout(1, MOVE))
    cmove = gl.arange(0, BC, layout=gl.SliceLayout(0, MOVE))
    cscan = gl.arange(0, BC, layout=gl.SliceLayout(0, SCAN))
    last = gl.expand_dims(cscan == BC - 1, 0)
    carry = gl.zeros([BR], O.dtype.element_ty, layout=gl.SliceLayout(1, SCAN))
    for c0 in range(0, cols, BC):
        c = c0 + cmove
        m = gl.expand_dims(r < rows, 1) & gl.expand_dims(c < cols, 0)
        if REVERSE:
            c = cols - 1 - c
        off = (sbase + gl.expand_dims(c.to(gl.int64), 0) * inner
               + gl.expand_dims(r, 1))
        b = gl.load(S + off, mask=m, other=0).to(O.dtype.element_ty)
        b = gl.convert_layout(b, SCAN)
        ca = c0 + cscan
        ma = ca < cols
        if REVERSE:
            ca = cols - 1 - ca
        ac = gl.load(A + abase + ca.to(gl.int64) * a_col, mask=ma,
                     other=1).to(O.dtype.element_ty)
        a, b = gl.broadcast(gl.expand_dims(ac, 0), b)
        y, carry = _scan_block(a, b, carry, last)
        gl.store(O + off, gl.convert_layout(y, MOVE), mask=m)
'''


def _gluon_kernels():
    """The module of K4 (Gluon: Triton with explicit register layouts),
    written into the build directory and imported there at first use
    (Triton reads a kernel's source through ``inspect``)."""
    return load_module(GLUON_SOURCE, prefix="scan")[0]


def _num_warps(br: int, bc: int) -> int:
    return 8 if br * bc >= 2048 else 4


def scan_layout(br: int, bc: int, num_warps: int) -> tuple:
    """(size_per_thread, threads_per_warp, warps_per_cta, order): the
    register layout of K4's scan over a (br, bc) block, in both of its
    entries. Four columns a thread (16 bytes of float32), then lanes and
    warps along the columns, the rest along the rows: the layout that
    coalesces a row-major block's loads. A scan's combine order follows
    its layout, so one layout for both entries is what makes the
    state-scan entry K4's result bit for bit."""
    spt = min(4, bc)
    tc = min(32, bc // spt)
    wc = min(num_warps, max(1, bc // (spt * tc)))
    return (1, spt), (32 // tc, tc), (num_warps // wc, wc), (1, 0)


def _layout(shape: tuple):
    """A :func:`scan_layout` or :func:`move_layout` tuple as Gluon's
    ``BlockedLayout`` (Triton imported at launch, never at import)."""
    from triton.experimental.gluon import language as gl
    return gl.BlockedLayout(*map(list, shape))


def move_layout(br: int, bc: int, num_warps: int) -> tuple:
    """The state-scan entry's layout for loads and stores: payload rows
    fastest (they are contiguous in the states), up to four a thread,
    then lanes and warps along the rows, the rest along the columns."""
    spt = min(4, max(1, br // 32))
    tpw = min(32, max(1, br // spt))
    wpc = max(1, min(num_warps, br // (spt * tpw)))
    return ((spt, 1), (tpw, 32 // tpw), (wpc, num_warps // wpc), (0, 1))


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
    """The K4 wrapper. ``launches`` counts the forward walk's kernel
    launches and ``reverse_launches`` the reverse walk's (the backward
    of a scan), and only those."""

    def __init__(self):
        self.launches = 0
        self.reverse_launches = 0

    def _count(self, reverse: bool) -> None:
        if reverse:
            self.reverse_launches += 1
        else:
            self.launches += 1

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
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
        nw = _num_warps(br, bc)
        with torch.cuda.device(a.device):
            _gluon_kernels().k4_chunk_scan[(-(-rows // br),)](
                a, b, out, rows, cols, a.stride(0), b.stride(0), BR=br,
                BC=bc, SCAN=_layout(scan_layout(br, bc, nw)),
                REVERSE=reverse, num_warps=nw)
        self._count(reverse)
        return out

    def state_scan(self, a: torch.Tensor, states: torch.Tensor,
                   axis: int, reverse: bool = False) -> torch.Tensor:
        """The scan along ``axis`` of ``states`` with the decay ``a`` at
        its own rank (the states' leading dims), in one launch of
        ``k4_state_scan`` on the states where they lie; the output in
        their layout (see :func:`state_scan_map`). ``reverse`` walks the
        chunks from the last one."""
        dt = torch.promote_types(a.dtype, states.dtype)
        if not dt.is_floating_point:
            raise ValueError(f"K4 scans floating-point rows, got {dt}")
        check_cuda([a, states], "K4")
        a, w = state_scan_map(a, states, axis)
        states = states.contiguous()
        out = torch.empty(states.shape, dtype=dt, device=states.device)
        if states.numel() == 0:
            return out
        cols, rows = w["cols"], w["rows"]
        br, bc = block_shape(states.numel() // cols, cols)
        nw = _num_warps(br, bc)
        n_rb = -(-rows // br)
        with torch.cuda.device(states.device):
            _gluon_kernels().k4_state_scan[(w["outer"] * w["a_in"] * n_rb,)](
                a, states, out, n_rb, rows, cols, w["inner"], w["a_in"],
                w["a_div"], w["a_outer"], w["a_col"], BR=br, BC=bc,
                SCAN=_layout(scan_layout(br, bc, nw)),
                MOVE=_layout(move_layout(br, bc, nw)),
                REVERSE=reverse, num_warps=nw)
        self._count(reverse)
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
                      interpret: bool = False,
                      reverse: bool = False) -> torch.Tensor:
    """Affine carried scan along the last axis; a, b same 2D shape. K4 on
    CUDA tensors, or its blocked walk in torch (``interpret=True``);
    ``reverse`` scans each row from its last column."""
    if a.shape != b.shape:
        raise ValueError("a and b must match")
    if interpret:
        return chunk_scan_plain(a, b, block_shape(*a.shape)[1], reverse)
    return K4(a, b, reverse)


def chunk_scan_state_kernel(a: torch.Tensor, states: torch.Tensor,
                            axis: int = 1, interpret: bool = False,
                            reverse: bool = False) -> torch.Tensor:
    """The affine scan of ``states`` along ``axis`` (counted on the
    states) with the decay ``a`` at the states' leading dims: K4's
    state-scan entry on CUDA tensors, reading the states in place, or
    its walk in torch (``interpret=True``); ``reverse`` scans from the
    last chunk."""
    if interpret:
        return state_scan_plain(a, states, axis, reverse)
    return K4.state_scan(a, states, axis, reverse)


# ---------------------------------------------------------------------------
# the adjoint: K4's reverse walk
# ---------------------------------------------------------------------------

def next_decay(a: torch.Tensor, ax: int) -> torch.Tensor:
    """``a[c+1]`` at column c along ``ax`` (0 at the last column): the
    decay of the adjoint scan, built at ``a``'s own rank."""
    n = a.shape[ax]
    return torch.cat([a.narrow(ax, 1, n - 1),
                      a.new_zeros(a.shape[:ax] + (1,) + a.shape[ax + 1:])],
                     dim=ax)


def _prev_product(lam: torch.Tensor, y: torch.Tensor, ax: int,
                  keep: int) -> torch.Tensor:
    """``Σ λ[c]·y[c−1]`` (y[−1] = 0) over the dims from ``keep`` on, at
    every c along ``ax``: the gradient of the decays."""
    n = lam.shape[ax]
    prod = lam.narrow(ax, 1, n - 1) * y.narrow(ax, 0, n - 1)
    prod = prod.sum(dim=tuple(range(keep, lam.ndim))) if keep < lam.ndim \
        else prod
    zero = prod.new_zeros(prod.shape[:ax] + (1,) + prod.shape[ax + 1:]) \
        if ax < prod.ndim else None
    return prod if zero is None else torch.cat([zero, prod], dim=ax)


def chunk_scan_grad(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    interpret: bool = False):
    """(da, db) of ``y = chunk_scan(a, b)`` (2D, along the columns) for
    the output's gradient ``g``: the adjoint λ[c] = g[c] + a[c+1]·λ[c+1]
    is the affine scan run from the last column, one reverse walk of K4
    (or its plain walk); db = λ, da[c] = λ[c]·y[c−1]."""
    lam = chunk_scan_kernel(next_decay(a, 1), g, interpret, reverse=True)
    return _prev_product(lam, y, 1, 2), lam


def state_scan_grad(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    axis: int, interpret: bool = False):
    """(da, dstates) of ``y = chunk_scan_state(a, states, axis)`` (the
    axis counted on the states, ``a`` at the states' leading dims, as
    :func:`state_scan_map` expands it) for the output's gradient ``g``:
    one reverse walk of K4's state-scan entry on ``g`` where it lies,
    with the shifted decay at ``a``'s rank; da[c] = Σ λ[c]·y[c−1] over
    the states' payload dims (a torch reduction)."""
    nd = y.ndim
    ax = axis % nd
    a = a.expand(y.shape[:a.ndim])
    shifted_a = next_decay(a, ax) if ax < a.ndim else a
    lam = chunk_scan_state_kernel(shifted_a, g, axis, interpret,
                                  reverse=True)
    return _prev_product(lam, y, ax, a.ndim), lam

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

**K4** (:data:`K4`, replaces ``chunk_scan_pallas``) has two entries.
Its state-scan entry (``k4_state_kernel`` in ``csrc/prefix_scan.cu``,
beside K3; :meth:`ChunkScanKernel.state_scan`; c4_statescan, Mamba2's
inter-chunk recurrence) is CUDA C++: the recurrence y[c] = a[c]·y[c−1]
+ b[c] folded in order along the chunks, one thread per payload element
or 16- or 8-byte vector of them, the carry in registers (the TPU
kernel's carry in VMEM scratch across a sequential grid axis, reset at
step 0, becomes that walk). Each step is one product and one add, each
rounded in ``promote(a, b)`` — the reference oracle's recurrence, in
the order torch evaluates ``a * y + b`` — so :func:`state_scan_plain` is
the kernel's result bit for bit. It reads the (B, C, H, P, N) states
where they lie: a group of ``rows`` contiguous payload elements shares
one decay ``a[b, c, h]`` a chunk, a warp-uniform load; a thread keeps a
ring of chunks' loads in flight, issued before the chunk ahead of them
is folded (:func:`state_walk` chooses the vector width). Its reverse
walk with the forward's output (:meth:`ChunkScanKernel.state_scan_grad`,
the backward) also reduces λ[c]·y[c−1] over each warp's payload into one
partial per (warp, chunk), and a second launch sums the partials in a
fixed order: da without the product at the states' size, the same bits
on every run (:func:`state_da_plain` is that reduction in torch).
:func:`k4_bound_steps` gives the fold's error bound.

Its contiguous-rows entry (c4_chunkscan, ``ChunkScanFn``) folds rows of
up to :data:`K4_FOLD_COLS` columns, every chunk count of the model
paths, in CUDA C++ too (``k4_rows_kernel``: a lane a row, a warp's rows
moved through shared memory in coalesced 16-byte chunks), so there the
two entries are one fold, bit for bit. Longer rows keep the former
design, Gluon (Triton with explicit register layouts): one program per
block of ``br`` rows walks its rows' column blocks of ``bc`` in order
with the carry in registers, per block ``associative_scan`` of (a, b)
under the affine combine, then ``y = A·carry + B``. A fold of segments
a thread (``experiments/k4_rows_fold.cu``) was slower there (PERF.md).
:func:`k4_rows_bound_steps` gives each route's error bound.

What bounds them on the H100: device-memory bytes (each input read once,
the output written once; a scan does one or two operations per element).
Ragged rows and columns are masked (a load past the edge reads the
combine's identity), so nothing is padded: the reference pads rows to
8, a TPU sublane rule that would cost 8× the bytes of a one-row
operand.

:func:`prefix_sum_plain` is the plain PyTorch version of K3's blocked
walk (Hillis–Steele inside each ``bc`` block, the carry across blocks,
reset per row), :func:`chunk_scan_plain` of K4's rows entry (the fold,
or the Gluon kernel's blocked walk past :data:`K4_FOLD_COLS` columns)
and :func:`state_scan_plain` of its state-scan entry; ``interpret`` mode
runs them on any device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.fused_kernel import check_cuda, load_module

from . import _cuda
from .ref import chunk_scan as _affine_scan
from .ref import shifted

TILE_ELEMS = 4096            # elements of a K4 rows block (br, bc),
#                              columns of a K3 tile


def block_shape(rows: int, cols: int) -> tuple[int, int]:
    """The (br, bc) block K3 and K4's rows entry use for a (rows, cols)
    operand: the whole row up to 4096 columns, and as many rows as fill
    4096 elements."""
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


#: Rows of at most this many columns K4's rows entry folds as the state
#: entry folds its chunks (``FOLD_COLS`` in ``csrc/prefix_scan.cu``);
#: longer rows take the Gluon kernel.
K4_FOLD_COLS = 64


def chunk_scan_plain(a: torch.Tensor, b: torch.Tensor, bc: int | None = None,
                     reverse: bool = False) -> torch.Tensor:
    """K4's rows entry in torch eager. Up to :data:`K4_FOLD_COLS`
    columns the fold y[:, c] = a[:, c]·y[:, c−1] + b[:, c] (y before the
    row's first column = 0), one product and one add a step, each
    rounded in ``promote(a, b)``: ``k4_rows_kernel``'s result bit for
    bit. Longer rows: the Gluon kernel's blocked walk, the affine
    Hillis–Steele inside each block of ``bc`` columns (default
    :func:`block_shape`'s), then y = A·carry + B with the carry = the
    previous block's last y. ``reverse`` walks each row from its last
    column, as K4's does: the same walk on the columns in reverse
    order."""
    if reverse:
        return chunk_scan_plain(a.flip(1), b.flip(1), bc).flip(1)
    rows, cols = a.shape
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if cols <= K4_FOLD_COLS:
        out = torch.empty(a.shape, dtype=dt, device=a.device)
        y = torch.zeros(rows, dtype=dt, device=a.device)
        for c in range(cols):
            y = a[:, c] * y + b[:, c]
            out[:, c] = y
        return out
    bc = bc or block_shape(rows, cols)[1]
    acum, bcum = _affine_hs(_blocks(a, bc, 1), _blocks(b, bc, 0))
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
    """K4's state-scan entry in torch eager: the fold y[c] = a[c]·y[c−1]
    + b[c] (y[−1] = 0), one product and one add a step, each rounded in
    ``promote(a, states)``, on every payload element of
    :func:`state_scan_map`'s groups, each chunk's decay gathered by the
    kernel's own index, in the states' layout. ``reverse`` walks the
    chunks from the last one (states and decays), as ``reverse`` does."""
    dt = torch.promote_types(a.dtype, states.dtype)
    a, w = state_scan_map(a.to(dt), states, axis)
    outer, cols, a_in, rows = w["outer"], w["cols"], w["a_in"], w["rows"]
    out = torch.empty(states.shape, dtype=dt, device=states.device)
    if states.numel() == 0:
        return out
    ag = _group_decays(a, w)                         # (outer, cols, a_in)
    st = states.to(dt).reshape(outer, cols, a_in, rows)
    ov = out.view(outer, cols, a_in, rows)
    y = torch.zeros((outer, a_in, rows), dtype=dt, device=states.device)
    for j in range(cols):
        c = cols - 1 - j if reverse else j
        y = ag[:, c, :, None] * y + st[:, c]
        ov[:, c] = y
    return out


def _group_decays(a: torch.Tensor, w: dict) -> torch.Tensor:
    """The decay of group (o, ai) at chunk c, (outer, cols, a_in), by the
    kernel's index ``(o // a_div)·a_outer + ai + c·a_col``."""
    dev = a.device
    o = torch.arange(w["outer"], device=dev)[:, None, None]
    c = torch.arange(w["cols"], device=dev)[None, :, None]
    ai = torch.arange(w["a_in"], device=dev)[None, None, :]
    return a.reshape(-1)[(o // w["a_div"]) * w["a_outer"] + ai
                         + c * w["a_col"]]


K4_RING_BYTES = 128          # of each operand in a thread's ring (RING_BYTES)


def state_walk(rows: int, cols: int, itemsize: int,
               da: bool = False) -> dict:
    """How ``k4_state_kernel`` walks groups of ``rows`` payload elements
    over ``cols`` chunks (``da``: the reverse walk that also loads y and
    reduces da): ``vec`` contiguous elements a thread (16 or 8 bytes, or
    one element), ``ring`` chunks whose loads a thread keeps in flight
    (fixed by ``vec``, the dtype and ``da``: the kernel's ``ring_depth``),
    ``sp`` a group's vector slots rounded up to whole warps.

    The widest vector that divides a group's rows is taken, even where
    the group's last warp is then partly idle: at Hymba's P·N = 800, 200
    16-byte slots (7 warps, 24 lanes idle) ran in 0.0083 ms against
    0.0114 for 25 whole warps of one element (NVIDIA H100 80GB HBM3,
    ``experiments/k1_k4_redesign.py --k4-walks``). The ring holds
    :data:`K4_RING_BYTES` of each operand it loads (y too, with ``da``),
    4 to 32 chunks, so where that covers the chunks every load is issued
    before the walk."""
    vec = next(v for v in sorted({max(1, 16 // itemsize),
                                  max(1, 8 // itemsize), 1}, reverse=True)
               if rows % v == 0)
    ring = min(32, max(4, K4_RING_BYTES // (vec * itemsize
                                            * (2 if da else 1))))
    return dict(vec=vec, ring=ring, sp=-(-(rows // vec) // 32) * 32)


def state_da_plain(lam: torch.Tensor, y: torch.Tensor, a: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """da[e] = Σ λ[c]·y[c−1] (y[−1] = 0) over the payload (and, where the
    decay is shared along the chunks, the chunks and groups) of decay
    element e, as the fused reverse walk sums it: each thread's ``vec``
    products in order, the warp's lanes by an xor butterfly, then the
    warps (and chunks and groups) in order, in float32 (float64 for
    float64), rounded once to λ's dtype. ``a`` is the decay at its own
    rank; returns da at ``state_scan_map``'s expanded decay shape."""
    dt = lam.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    a, w = state_scan_map(a, lam, axis)
    outer, cols, a_in, rows = w["outer"], w["cols"], w["a_in"], w["rows"]
    walk = state_walk(rows, cols, lam.element_size(), da=True)
    vec, sp = walk["vec"], walk["sp"]
    lv = lam.reshape(outer, cols, a_in, rows).to(acc)
    yv = y.reshape(outer, cols, a_in, rows).to(acc)
    prod = torch.zeros((outer, cols, a_in, sp * vec), dtype=acc,
                       device=lam.device)
    prod[:, 1:, :, :rows] = lv[:, 1:] * yv[:, :-1]
    prod = prod.view(outer, cols, a_in, sp // 32, 32, vec)
    t = torch.zeros(prod.shape[:-1], dtype=acc, device=lam.device)
    for e in range(vec):
        t = t + prod[..., e]
    lane = torch.arange(32, device=lam.device)
    for d in (16, 8, 4, 2, 1):
        t = t + t[..., lane ^ d]
    part = t[..., 0]                             # (outer, cols, a_in, warps)
    da = torch.zeros(a.numel(), dtype=acc, device=lam.device)
    if w["a_col"]:                               # e = (o, c, ai)
        for k in range(part.shape[-1]):
            da = da + part[..., k].reshape(-1)
    else:                                        # e = o // a_div
        q = part.reshape(a.numel(), -1)
        for i in range(q.shape[1]):
            da = da + q[:, i]
    return da.to(dt).view(a.shape)


def k4_rows_bound_steps(c: int, rows: int, cols: int) -> int:
    """k(c) of the rows entry's bound ``k(c)·eps·Σ_{j≤c}|b_j|`` at column
    c of a (rows, cols) operand, for |a| ≤ 1: the fold's
    (:func:`k4_bound_steps`) up to :data:`K4_FOLD_COLS` columns; past
    them the Gluon walk's, ⌈log2 bc⌉ levels of its tree in a block, one
    more for each block's carry, and two for the rest."""
    if cols <= K4_FOLD_COLS:
        return k4_bound_steps(c)
    bc = block_shape(rows, cols)[1]
    return math.ceil(math.log2(bc)) + -(-(c + 1) // bc) + 2


def k4_bound_steps(c: int) -> int:
    """k(c) of K4's first-order error bound ``k(c)·eps·Σ_{j≤c}|b_j|`` at
    step c of its walk (counted from 0 in walk order) against the exact
    recurrence, for |a| ≤ 1: b_j passes c − j products and c − j + 1
    adds, each rounded once (half an eps), so (c + ½)·eps; one unit more
    covers the second-order terms."""
    return c + 2


# ---------------------------------------------------------------------------
# K4's rows entry past K4_FOLD_COLS columns, in Gluon
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
'''


def _gluon_kernels():
    """The module of K4 (Gluon: Triton with explicit register layouts),
    written into the build directory and imported there at first use
    (Triton reads a kernel's source through ``inspect``)."""
    return load_module(GLUON_SOURCE, prefix="scan")[0]


def gluon_chunk_scan(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                     reverse: bool = False) -> torch.Tensor:
    """One launch of the Gluon ``k4_chunk_scan`` on (rows, cols) operands
    of one floating dtype (rows strided, columns contiguous) into ``out``
    (contiguous, the same dtype): K4's rows entry past
    :data:`K4_FOLD_COLS` columns; not counted here."""
    rows, cols = a.shape
    br, bc = block_shape(rows, cols)
    nw = _num_warps(br, bc)
    with torch.cuda.device(a.device):
        _gluon_kernels().k4_chunk_scan[(-(-rows // br),)](
            a, b, out, rows, cols, a.stride(0), b.stride(0), BR=br, BC=bc,
            SCAN=_layout(scan_layout(br, bc, nw)), REVERSE=reverse,
            num_warps=nw)
    return out


def _num_warps(br: int, bc: int) -> int:
    return 8 if br * bc >= 2048 else 4


def scan_layout(br: int, bc: int, num_warps: int) -> tuple:
    """(size_per_thread, threads_per_warp, warps_per_cta, order): the
    register layout of K4's rows entry over a (br, bc) block. Four columns a thread (16 bytes of float32), then lanes and
    warps along the columns, the rest along the rows: the layout that
    coalesces a row-major block's loads."""
    spt = min(4, bc)
    tc = min(32, bc // spt)
    wc = min(num_warps, max(1, bc // (spt * tc)))
    return (1, spt), (32 // tc, tc), (num_warps // wc, wc), (1, 0)


def _layout(shape: tuple):
    """A :func:`scan_layout` tuple as Gluon's
    ``BlockedLayout`` (Triton imported at launch, never at import)."""
    from triton.experimental.gluon import language as gl
    return gl.BlockedLayout(*map(list, shape))


# ---------------------------------------------------------------------------
# K3 and K4's state-scan entry in CUDA C++
# ---------------------------------------------------------------------------

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
        self._lib = None

    def lib(self):
        """The built and loaded ``csrc/prefix_scan.cu`` (once a wrapper)."""
        if self._lib is None:
            self._lib = _cuda.load("prefix_scan", _K3_SIGNATURES)
        return self._lib

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
        lib = self.lib()
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


_K4_SIGNATURES = {
    # (dtype, a, b, out, rows, cols, stride_a, stride_b, vec, reverse,
    #  stream)
    "k4_chunk_scan": (_cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.I64,
                      _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I32, _cuda.I32,
                      _cuda.P),
    # (dtype, a, s, out, y, partials, groups, rows, cols, inner, a_in,
    #  a_div, a_outer, a_col, vec, sp, reverse, da, stream)
    "k4_state_scan": (_cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                      _cuda.P, _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I64,
                      _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I32,
                      _cuda.I64, _cuda.I32, _cuda.I32, _cuda.P),
    # (dtype, partials, da, n_e, cols, a_in, a_div, wpg, per_chunk, stream)
    "k4_da_sum": (_cuda.I32, _cuda.P, _cuda.P, _cuda.I64, _cuda.I64,
                  _cuda.I64, _cuda.I64, _cuda.I64, _cuda.I32, _cuda.P),
}


def _k4_dtype(*dtypes) -> tuple[torch.dtype, int]:
    """The promoted dtype K4 folds in, and its code in the CUDA source."""
    dt = dtypes[0]
    for d in dtypes[1:]:
        dt = torch.promote_types(dt, d)
    code = _K3_DTYPE_CODES.get(dt)
    if code is None:
        raise ValueError(f"K4 scans floating-point rows of float32, "
                         f"float64, float16 or bfloat16, got {dt}")
    return dt, code


def _aligned(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``x`` where its address is a multiple of ``nbytes`` (the vector
    the state walk moves), else a copy (a fresh allocation is)."""
    return x if x.data_ptr() % nbytes == 0 else x.clone()


class ChunkScanKernel:
    """The K4 wrapper. ``launches`` counts the forward walk's kernel
    launches, ``reverse_launches`` the reverse walk's (the backward of a
    scan) and ``da_launches`` the second pass that sums the reverse
    walk's da partials, and only those."""

    def __init__(self):
        self.launches = 0
        self.reverse_launches = 0
        self.da_launches = 0
        self._lib = None

    def lib(self):
        """The built and loaded ``csrc/prefix_scan.cu`` (once a wrapper)."""
        if self._lib is None:
            self._lib = _cuda.load("prefix_scan", _K4_SIGNATURES)
        return self._lib

    def _count(self, reverse: bool) -> None:
        if reverse:
            self.reverse_launches += 1
        else:
            self.launches += 1

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
        """The rows entry on (rows, cols) operands, ``reverse`` from each
        row's last column: one launch of ``k4_rows_kernel`` up to
        :data:`K4_FOLD_COLS` columns, of the Gluon kernel past them."""
        dt, code = _k4_dtype(a.dtype, b.dtype)
        check_cuda([a, b], "K4")
        a, b = _rows_operand(a.to(dt)), _rows_operand(b.to(dt))
        rows, cols = a.shape
        out = torch.empty((rows, cols), dtype=dt, device=a.device)
        if a.numel() == 0:
            return out
        if cols > K4_FOLD_COLS:
            gluon_chunk_scan(a, b, out, reverse)
            self._count(reverse)
            return out
        # 16-byte chunks where the rows and both operands allow
        vec = 16 // out.element_size()
        if (cols % vec or a.stride(0) % vec or b.stride(0) % vec
                or a.data_ptr() % 16 or b.data_ptr() % 16):
            vec = 1
        lib = self.lib()
        with torch.cuda.device(a.device):
            err = lib.k4_chunk_scan(
                code, a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, cols,
                a.stride(0), b.stride(0), vec, int(reverse),
                torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "K4 chunk_scan")
        self._count(reverse)
        return out

    def state_scan(self, a: torch.Tensor, states: torch.Tensor,
                   axis: int, reverse: bool = False) -> torch.Tensor:
        """The scan along ``axis`` of ``states`` with the decay ``a`` at
        its own rank (the states' leading dims), in one launch of
        ``k4_state_kernel`` on the states where they lie; the output in
        their layout (see :func:`state_scan_map`). ``reverse`` walks the
        chunks from the last one."""
        return self._state(a, states, axis, reverse, None)[0]

    def state_scan_grad(self, a: torch.Tensor, g: torch.Tensor,
                        y: torch.Tensor, axis: int):
        """(λ, da) of the backward: λ the reverse walk of ``g`` under the
        decay ``a`` (already shifted, :func:`next_decay`), and da[e] =
        Σ λ[c]·y[c−1] over decay element e's payload, reduced inside the
        same walk from the forward's output ``y`` and summed by a second
        launch (``k4_da_sum``, counted in ``da_launches``); da has
        :func:`state_scan_map`'s expanded decay shape."""
        return self._state(a, g, axis, True, y)

    def _state(self, a, states, axis, reverse, y):
        dt, code = _k4_dtype(a.dtype, states.dtype)
        check_cuda([a, states] + ([] if y is None else [y]), "K4")
        a, w = state_scan_map(a.to(dt), states, axis)
        out = torch.empty(states.shape, dtype=dt, device=states.device)
        if states.numel() == 0:
            return out, (None if y is None else
                         torch.zeros(a.shape, dtype=dt, device=a.device))
        cols, rows = w["cols"], w["rows"]
        walk = state_walk(rows, cols, out.element_size(), da=y is not None)
        nbytes = walk["vec"] * out.element_size()
        states = _aligned(states.to(dt).contiguous(), nbytes)
        groups = w["outer"] * w["a_in"]
        partials = None
        if y is not None:
            if y.shape != states.shape:
                raise ValueError(f"K4: y {tuple(y.shape)} is not shaped as "
                                 f"the states {tuple(states.shape)}")
            y = _aligned(y.to(dt).contiguous(), nbytes)
            acc = torch.float64 if dt == torch.float64 else torch.float32
            partials = torch.empty(groups * cols * walk["sp"] // 32,
                                   dtype=acc, device=states.device)
        lib = self.lib()
        with torch.cuda.device(states.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.k4_state_scan(
                code, a.data_ptr(), states.data_ptr(), out.data_ptr(),
                None if y is None else y.data_ptr(),
                None if partials is None else partials.data_ptr(), groups,
                rows, cols, w["inner"], w["a_in"], w["a_div"], w["a_outer"],
                w["a_col"], walk["vec"], walk["sp"], int(reverse),
                int(y is not None), stream)
            _cuda.check(lib, err, "K4 state_scan")
            self._count(reverse)
            if y is None:
                return out, None
            # k4_da_sum writes every element of da
            da = torch.empty(a.shape, dtype=dt, device=states.device)
            err = lib.k4_da_sum(code, partials.data_ptr(), da.data_ptr(),
                                da.numel(), cols, w["a_in"], w["a_div"],
                                walk["sp"] // 32, int(bool(w["a_col"])),
                                stream)
        _cuda.check(lib, err, "K4 da_sum")
        self.da_launches += 1
        return out, da


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
        return chunk_scan_plain(a, b, reverse=reverse)
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
    with the shifted decay at ``a``'s rank, which also reduces da[c] =
    Σ λ[c]·y[c−1] over the states' payload dims, and the second launch
    that sums its partials (:meth:`ChunkScanKernel.state_scan_grad`); or
    the plain walk and :func:`state_da_plain`, the same reduction in
    torch (``interpret``)."""
    ax = axis % y.ndim
    a = a.expand(y.shape[:a.ndim])
    shifted_a = next_decay(a, ax) if ax < a.ndim else a
    if interpret:
        lam = chunk_scan_state_kernel(shifted_a, g, axis, True, reverse=True)
        return state_da_plain(lam, y, a, axis), lam
    lam, da = K4.state_scan_grad(shifted_a, g, y, axis)
    return da, lam

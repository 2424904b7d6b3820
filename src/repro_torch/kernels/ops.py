"""Public ops: the ported custom SIMD instructions, registered in the ISA.

This is the "binutils patch": each op below registers one Instruction
with its I'/S'-type operand signature, its torch-eager oracle (ref.py)
and its GPU kernel, then exposes a user-facing wrapper that handles
shape normalisation and dispatch-mode plumbing.

Dispatch (repro_torch.core.isa.use):
    'ref'       — base core, no SIMD unit (paper's software baselines)
    'kernel'    — the instruction's GPU kernel on CUDA tensors (K1 for the
                  c0 family, K3–K6 for c1–c4, K7 for c5, K8 for c6)
    'interpret' — the kernel's plain PyTorch version, any device
    'auto'      — kernel for CUDA tensors, ref for CPU tensors

Ported: c0–c6 and the mergesort application. The kernels take ragged
rows as they come: the reference's padding of rows to 8 (``_pad_rows``) is a
TPU sublane rule and is not carried over (the results are the same,
since the reference slices the padding away).
"""
from __future__ import annotations

import torch

from repro_torch.core import isa
from repro_torch.core.isa import Instruction, OperandSpec
from repro_torch.core.stream import StreamConfig
from repro_torch.core.stream import as_rows as _as_rows

from . import flashattn as _fa
from . import prefix_scan as _ps
from . import ref
from . import sortnet as _sn
from . import stream_copy as _sc
from . import topk as _tk


# ---------------------------------------------------------------------------
# c2_sort
# ---------------------------------------------------------------------------

def _sort_kernel(x, width: int = 8, descending: bool = False, *,
                 interpret: bool = False):
    x2d, lead = _as_rows(x, x.shape[-1])
    out = _sn.sort_chunks_kernel(x2d, width=width, descending=descending,
                                 interpret=interpret)
    return out.reshape(*lead, x.shape[-1])


isa.register(Instruction(
    name="c2_sort",
    spec=OperandSpec(itype="I'", vector_in=1, vector_out=1),
    ref=ref.sort_chunks,
    kernel=_sort_kernel,
    pipeline_depth=_sn.n_cas_layers(8) // 2,    # paper: 6 layers / 3 cycles
    stream=StreamConfig(),
    doc="bitonic sort of each `width`-chunk of a vector register",
))


def sort_chunks(x, width: int = 8, descending: bool = False, mode=None):
    return isa.call("c2_sort", x, width=width, descending=descending, mode=mode)


# ---------------------------------------------------------------------------
# c1_merge  (2 vector in, 2 vector out — the full I'-type operand budget)
# ---------------------------------------------------------------------------

def _merge_kernel(a, b, width=None, *, interpret: bool = False):
    w = width or a.shape[-1]
    a2, lead = _as_rows(a, a.shape[-1])
    b2, _ = _as_rows(b, b.shape[-1])
    lo, hi = _sn.merge_sorted_kernel(a2, b2, width=w, interpret=interpret)
    return (lo.reshape(*lead, a.shape[-1]), hi.reshape(*lead, a.shape[-1]))


isa.register(Instruction(
    name="c1_merge",
    spec=OperandSpec(itype="I'", vector_in=2, vector_out=2),
    ref=ref.merge_sorted,
    kernel=_merge_kernel,
    pipeline_depth=4,
    doc="merge two sorted registers; lower→vrd1, upper→vrd2",
))


def merge_sorted(a, b, width=None, mode=None):
    return isa.call("c1_merge", a, b, width=width, mode=mode)


# ---------------------------------------------------------------------------
# c3_prefixsum
# ---------------------------------------------------------------------------

def _prefix_kernel(x, *, interpret: bool = False):
    x2d, lead = _as_rows(x, x.shape[-1])
    out = _ps.prefix_sum_kernel(x2d, interpret=interpret)
    return out.reshape(*lead, x.shape[-1])


isa.register(Instruction(
    name="c3_prefixsum",
    spec=OperandSpec(itype="I'", vector_in=1, vector_out=1),
    ref=ref.prefix_sum,
    kernel=_prefix_kernel,
    pipeline_depth=2,
    doc="Hillis–Steele scan with carried batch total (arbitrary length)",
))


def prefix_sum(x, mode=None):
    return isa.call("c3_prefixsum", x, mode=mode)


def exclusive_prefix_sum(x, mode=None):
    inc = prefix_sum(x, mode=mode)
    return inc - x


# ---------------------------------------------------------------------------
# c4_chunkscan (affine carry — SSD inter-chunk recurrence)
# ---------------------------------------------------------------------------

def _chunkscan_kernel(a, b, *, interpret: bool = False):
    a2, lead = _as_rows(a, a.shape[-1])
    b2, _ = _as_rows(b, b.shape[-1])
    out = _ps.chunk_scan_kernel(a2, b2, interpret=interpret)
    return out.reshape(*lead, a.shape[-1])


isa.register(Instruction(
    name="c4_chunkscan",
    spec=OperandSpec(itype="I'", vector_in=2, vector_out=1),
    ref=ref.chunk_scan,
    kernel=_chunkscan_kernel,
    pipeline_depth=2,
    doc="carried affine scan y=a·y'+b (Mamba2 SSD state recurrence)",
))


def chunk_scan(a, b, mode=None):
    return isa.call("c4_chunkscan", a, b, mode=mode)


def _chunkscan_state_kernel(a, b, axis: int = 1, *, interpret: bool = False):
    # kernel path: broadcast decay to state rank, scan along last axis.
    # (The ref path keeps the broadcast symbolic.) The broadcast and the
    # two moves copy the decay and the states once each, as the reference
    # does.
    extra = b.ndim - a.ndim
    ab = a.reshape(a.shape + (1,) * extra).expand(b.shape)
    ab = torch.movedim(ab, axis, -1)
    bb = torch.movedim(b, axis, -1)
    out = _chunkscan_kernel(ab.reshape(-1, ab.shape[-1]),
                            bb.reshape(-1, bb.shape[-1]),
                            interpret=interpret)
    return torch.movedim(out.reshape(bb.shape), -1, axis)


isa.register(Instruction(
    name="c4_statescan",
    spec=OperandSpec(itype="I'", vector_in=2, vector_out=1),
    ref=ref.chunk_scan_state,
    kernel=_chunkscan_state_kernel,
    pipeline_depth=2,
    doc="c4_chunkscan with shared per-head decay (SSD chunk states)",
))


def chunk_scan_state(a, b, axis: int = 1, mode=None):
    return isa.call("c4_statescan", a, b, axis=axis, mode=mode)


# ---------------------------------------------------------------------------
# c5_topk
# ---------------------------------------------------------------------------

def _topk_kernel(x, k: int, *, interpret: bool = False):
    # rows of n stand for rows of the next power of two padded with the
    # dtype's minimum (never -inf), as the reference pads them: K7 reads
    # them in place, the plain network gets the padded copy
    x2d, lead = _as_rows(x, x.shape[-1])
    npow = 1 << (x2d.shape[1] - 1).bit_length()
    vals, idx = _tk.topk_kernel(x2d, k, npow=npow, interpret=interpret)
    return (vals.reshape(*lead, k), idx.reshape(*lead, k))


isa.register(Instruction(
    name="c5_topk",
    spec=OperandSpec(itype="I'", scalar_in=1, vector_in=1, vector_out=2),
    ref=ref.topk,
    kernel=_topk_kernel,
    pipeline_depth=8,
    doc="descending key/payload sort → top-k values + indices (MoE router)",
))


def topk(x, k: int, mode=None):
    return isa.call("c5_topk", x, k, mode=mode)


# ---------------------------------------------------------------------------
# c6_flashattn
# ---------------------------------------------------------------------------

def _flashattn_kernel(q, k, v, causal=True, scale=None, *,
                      interpret: bool = False):
    """q, k, v: (b, h, s, d). K8 tiles by its own 64 rows; the plain
    version walks the reference's blocks."""
    if not interpret:
        return _fa.K8(q, k, v, causal=causal, scale=scale)
    s = q.shape[2]
    block = 128 if s % 128 == 0 else (64 if s % 64 == 0 else s)
    return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block, block_k=block)


isa.register(Instruction(
    name="c6_flashattn",
    spec=OperandSpec(itype="I'", vector_in=2, vector_out=1),  # (q, kv) fused pair
    ref=ref.flash_attention,
    kernel=_flashattn_kernel,
    pipeline_depth=2,
    doc="fused blockwise attention with carried (m, l) state",
))


def flash_attention(q, k, v, causal=True, scale=None, mode=None):
    # The ISA operand budget counts register *names*; K and V stream from the
    # same base address pair (S'-style), so they count as one vector source —
    # hence manual dispatch here rather than isa.call's 2-operand check.
    # 'auto' follows the tensors, as isa.resolve_auto does.
    mode = isa.resolve_auto(mode or isa.registry.mode, (q, k, v))
    if mode == "ref":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return _flashattn_kernel(q, k, v, causal=causal, scale=scale,
                             interpret=(mode == "interpret"))


# ---------------------------------------------------------------------------
# c0 streaming family (S'-type)
# ---------------------------------------------------------------------------

# S'-type: the paper's two scalar sources are the base address + loop index;
# in K1 addressing is the tile offset a program computes, so the dispatch
# signature carries only the vector operand.
# Every template-backed op registers its KernelTemplate so Registry.fuse
# can chain its Stage into a single-launch fused program.
isa.register(Instruction(
    name="c0_copy", spec=OperandSpec(itype="S'", scalar_in=0, vector_in=1,
                                     vector_out=1),
    ref=ref.stream_copy, kernel=_sc.stream_copy_kernel, pipeline_depth=1,
    template=_sc.COPY,
    doc="c0_lv + c0_sv: streaming vector move (memcpy building block); "
        "S'-type rs1/rs2 (base+index) become K1's tile offsets"))

isa.register(Instruction(
    name="c0_scale", spec=OperandSpec(itype="I'", scalar_in=1, vector_in=1,
                                      vector_out=1),
    ref=ref.stream_scale, kernel=_sc.stream_scale_kernel, pipeline_depth=1,
    template=_sc.SCALE, doc="STREAM Scale"))

isa.register(Instruction(
    name="c0_add", spec=OperandSpec(itype="I'", vector_in=2, vector_out=1),
    ref=ref.stream_add, kernel=_sc.stream_add_kernel, pipeline_depth=1,
    template=_sc.ADD, doc="STREAM Add"))

isa.register(Instruction(
    name="c0_triad", spec=OperandSpec(itype="I'", scalar_in=1, vector_in=2,
                                      vector_out=1),
    ref=ref.stream_triad, kernel=_sc.stream_triad_kernel, pipeline_depth=1,
    template=_sc.TRIAD, doc="STREAM Triad"))


def stream_copy(x, mode=None):
    return isa.call("c0_copy", x, mode=mode)

def stream_scale(x, s, mode=None):
    return isa.call("c0_scale", x, s, mode=mode)

def stream_add(a, b, mode=None):
    return isa.call("c0_add", a, b, mode=mode)

def stream_triad(a, b, s, mode=None):
    return isa.call("c0_triad", a, b, s, mode=mode)


# ---------------------------------------------------------------------------
# c0 DAG pipelines — branching/shared-input dataflow graphs over the
# streaming family, the shapes the repro_torch.graph partitioner explores.
# Linear chains stay on Registry.fuse.
# ---------------------------------------------------------------------------

C0_PIPELINES = ("axpby_residual", "saxpby", "diamond")


def c0_pipeline_graph(kind: str = "axpby_residual"):
    """Build a named DAG-shaped c0 pipeline as a :class:`repro_torch.graph.
    ir.Graph` (branching, shared inputs and fan-out — not just chains).

    axpby_residual: out1 = copy(add(scale(x, s), b)), out2 = triad(x, b, t)
                    — a fusable 3-chain next to a branch sharing both
                    inputs.
    saxpby:         out = add(scale(x, a), scale(y, b)) — two chains
                    joining at an add; only one can absorb the join.
    diamond:        a = scale(x, s); out = add(copy(a), a) — fan-out on a,
                    so a must materialise and cannot be elided.
    """
    from repro_torch.graph.ir import Graph   # deferred: graph imports the ISA
    g = Graph(name=f"c0_{kind}")
    if kind == "axpby_residual":
        x, b = g.input("x"), g.input("b")
        s, t = g.scalar("s"), g.scalar("t")
        u = g.apply("c0_scale", x, s)
        v = g.apply("c0_add", u, b)
        g.output(g.apply("c0_copy", v))
        g.output(g.apply("c0_triad", x, b, t))
    elif kind == "saxpby":
        x, y = g.input("x"), g.input("y")
        a, b = g.scalar("a"), g.scalar("b")
        u = g.apply("c0_scale", x, a)
        v = g.apply("c0_scale", y, b)
        g.output(g.apply("c0_add", u, v))
    elif kind == "diamond":
        x, s = g.input("x"), g.scalar("s")
        a = g.apply("c0_scale", x, s)
        c = g.apply("c0_copy", a)
        g.output(g.apply("c0_add", c, a))
    else:
        raise ValueError(f"unknown c0 pipeline {kind!r}; "
                         f"have {C0_PIPELINES}")
    g.validate()
    return g


# ---------------------------------------------------------------------------
# The mergesort application (paper §4.3.1): sort-in-chunks + pairwise merges.
# ---------------------------------------------------------------------------

def sortnet_mergesort(x: torch.Tensor, base_width: int = 8,
                      max_kernel_width: int = 4096, mode=None) -> torch.Tensor:
    """Sort the last axis using c2_sort for chunks then c1_merge levels.

    Above ``max_kernel_width`` (the working-set bound, the same limit the
    paper hits when a merge no longer fits one register pair) the remaining
    merge levels run on the base core (torch.sort over pairs), exactly as
    the reference does.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    if n <= base_width:
        return sort_chunks(x, width=n, mode=mode)
    x = sort_chunks(x, width=base_width, mode=mode)
    w = base_width
    lead = x.shape[:-1]
    while w < n:
        pairs = x.reshape(*lead, n // (2 * w), 2, w)
        a = pairs[..., 0, :]
        b = pairs[..., 1, :]
        if 2 * w <= max_kernel_width:
            lo, hi = merge_sorted(a.reshape(-1, w), b.reshape(-1, w),
                                  width=w, mode=mode)
            merged = torch.cat(
                [lo.reshape(*lead, n // (2 * w), w),
                 hi.reshape(*lead, n // (2 * w), w)], dim=-1)
        else:  # the base core sorts the huge merge levels
            merged = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
        x = merged.reshape(*lead, n)
        w *= 2
    return x

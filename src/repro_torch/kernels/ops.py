"""Public ops: the ported custom SIMD instructions, registered in the ISA.

This is the "binutils patch": each op below registers one Instruction
with its I'/S'-type operand signature, its torch-eager oracle (ref.py)
and its GPU kernel, then exposes a user-facing wrapper.

Dispatch (repro_torch.core.isa.use):
    'ref'       — base core, no SIMD unit (paper's software baselines)
    'kernel'    — the fused Triton kernel K1 on CUDA tensors
    'interpret' — K1's plain PyTorch emulator, same grid walk
    'auto'      — kernel for CUDA tensors, ref for CPU tensors

Only the c0 streaming family is ported so far; c1–c6 arrive with their
kernels.
"""
from __future__ import annotations

from repro_torch.core import isa
from repro_torch.core.isa import Instruction, OperandSpec

from . import ref
from . import stream_copy as _sc

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

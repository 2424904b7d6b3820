# The paper's primary contribution, ported to PyTorch on the H100:
#   isa          — I'/S'/P' instruction types, registry, ref/kernel dispatch,
#                  instruction fusion (Registry.fuse)
#   template     — instruction templates (paper Alg. 1) + Stage
#   program      — fused instruction programs: N stages, one K1 launch
#   fused_kernel — K1, the generated Triton kernel, and its emulator
#   stream       — VLEN / tile geometry (paper cache hierarchy, §3.1)
#   burst_model  — B_eff(block) law behind Fig. 3
#   artifact     — persistent plan cache shared with the JAX package
from . import isa
from .burst_model import H100_HBM, PAPER_AXI, BurstModel
from .fused_kernel import K1
from .isa import FusedProgram, Instruction, OperandSpec, Registry
from .program import Program
from .stream import (LANES, SMEM_BYTES, SUBLANES, StreamConfig, as_rows,
                     flatten_to_blocks, pad_rows, round_up)
from .template import KernelTemplate, Stage

__all__ = [
    "isa", "Instruction", "OperandSpec", "Registry", "KernelTemplate",
    "Stage", "Program", "FusedProgram", "K1",
    "StreamConfig", "BurstModel", "PAPER_AXI", "H100_HBM",
    "LANES", "SUBLANES", "SMEM_BYTES", "round_up",
    "as_rows", "pad_rows", "flatten_to_blocks",
]

"""Instruction templates — paper §2.2 ("Algorithm 1") for the H100.

The paper gives a Verilog placeholder module: the framework provides the
operand plumbing (register names delayed by ``c1_cycles``, valid bits,
back-to-back pipelining) and the user writes only the datapath between
``in_vdata*`` and ``out_vdata*``.

:class:`KernelTemplate` is the same contract here. The user supplies a
*block body* in functional form, once per route, with one contract::

    body(scalars, ins, carry, step) -> (outs, carry)

* ``body`` is torch-eager code on block tensors. The fused kernel's plain
  PyTorch emulator (``interpret`` mode) calls it with every row block of
  one column step at once: vector blocks are ``(n_row_blocks,
  block_rows, block_cols)``, each scalar a ``(n_row_blocks, 1, 1)``
  tensor and the carry ``(n_row_blocks, block_rows, carry_cols)``, so a
  body written with broadcasting and ``dim=-1`` reductions serves both.
* ``triton_body`` is the source text of one Triton device function with
  the flat parameter list ``(s0, …, x0, …, carry, step)`` returning
  ``(out0, …, carry)``; the vector blocks are ``(block_rows,
  block_cols)`` tiles and the carry a ``(block_rows, carry_cols)`` tile.
  The fused-kernel generator (:mod:`repro_torch.core.fused_kernel`) adds
  ``@triton.jit``, renames it per stage and calls it from K1. ``tl``
  (``triton.language``) is in scope.

The carry is per row block, set to ``carry_init`` before the first
column step and carried across column steps (the paper's "stateful
instruction" discussion in §6: the softcore's internal-state registers).

A template exposes its bodies and block geometry as a composable
:class:`Stage`, and launching a template is running the single-stage
:class:`repro_torch.core.program.Program`. Multi-stage programs chain
several registered instructions into ONE launch, threading
intermediates through registers instead of device memory.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import torch

from .stream import LANES


@dataclasses.dataclass(frozen=True)
class Stage:
    """One composable pipeline stage: block bodies plus their geometry.

    This is the unit of fusion: a :class:`KernelTemplate` yields exactly
    one Stage (via :meth:`KernelTemplate.stage`), and a
    :class:`repro_torch.core.program.Program` chains several Stages into
    a single kernel whose body runs the stage bodies back to back.

    body signature (the template contract, see the module docstring):
        body(scalars, ins, carry, step) -> (outs, carry)
    """

    name: str
    body: Callable[..., Any]
    n_scalar_in: int = 0
    n_vec_in: int = 1
    n_vec_out: int = 1
    block_rows: int = 8
    block_cols: int = LANES
    carry_cols: int = 0
    carry_dtype: Any = torch.float32
    carry_init: float = 0.0
    cost_flops_per_elem: float = 1.0
    # Non-None only on single-stage programs (shape-changing outputs can't
    # feed a chained stage's input block): fn(*vectors) -> one object with
    # ``.shape`` and ``.dtype`` per output (a ``device="meta"`` tensor
    # serves); each keeps the input's rows and scales its columns.
    out_shapes: Optional[Callable[..., Sequence[Any]]] = None
    # Source text of the stage's Triton device function (None: the stage
    # runs only in ``interpret`` mode).
    triton_body: Optional[str] = None

    def pipeline_depth(self) -> int:
        """Column steps before the first output block lands (c*_cycles)."""
        return 1 if self.carry_cols == 0 else 2

    @property
    def shape_preserving(self) -> bool:
        """True iff every output block has the input block's geometry —
        the precondition for this stage to sit anywhere in a fused chain."""
        return self.out_shapes is None


def emit_stage(stage: Stage, scalars, ins, carry, step):
    """Run one stage's torch body on blocks and hold it to the contract.

    Shared by every eager walk of a program (the K1 emulator), so the
    carried-state semantics are identical everywhere: the returned
    carry keeps the stage's ``carry_dtype``.
    """
    outs, new_carry = stage.body(scalars, ins, carry, step)
    outs = tuple(outs)
    if len(outs) != stage.n_vec_out:
        raise ValueError(f"{stage.name}: body returned {len(outs)} outputs, "
                         f"declared {stage.n_vec_out}")
    if carry is not None:
        new_carry = new_carry.to(stage.carry_dtype)
    return outs, new_carry


@dataclasses.dataclass
class KernelTemplate:
    """Generate a fused-kernel launch for a streaming / carried SIMD
    instruction.

    ``body`` / ``triton_body`` follow the contract in the module
    docstring. Vector operands are 2D ``(rows, cols)``; row blocks run
    in parallel and each walks its column blocks in order (so a carry
    along cols is legal).
    """

    name: str
    body: Callable[..., Any]
    n_scalar_in: int = 0
    n_vec_in: int = 1
    n_vec_out: int = 1
    block_rows: int = 8
    block_cols: int = LANES
    # carry: per-row-block state, shape (block_rows, carry_cols)
    carry_cols: int = 0
    carry_dtype: Any = torch.float32
    carry_init: float = 0.0
    out_shapes: Optional[Callable[..., Sequence[Any]]] = None
    cost_flops_per_elem: float = 1.0   # for roofline bookkeeping
    triton_body: Optional[str] = None

    def pipeline_depth(self) -> int:
        """Column steps before the first output block lands (c*_cycles)."""
        return self.stage().pipeline_depth()

    # ------------------------------------------------------------------
    def stage(self) -> Stage:
        """This template's bodies + geometry as a composable fusion stage."""
        return Stage(
            name=self.name, body=self.body,
            n_scalar_in=self.n_scalar_in, n_vec_in=self.n_vec_in,
            n_vec_out=self.n_vec_out,
            block_rows=self.block_rows, block_cols=self.block_cols,
            carry_cols=self.carry_cols, carry_dtype=self.carry_dtype,
            carry_init=self.carry_init,
            cost_flops_per_elem=self.cost_flops_per_elem,
            out_shapes=self.out_shapes, triton_body=self.triton_body)

    def program(self):
        """The single-stage Program this template launches, kept while
        the template's fields stay the same so repeat launches are warm."""
        from .program import Program    # deferred: program imports template
        st = self.stage()
        prog = self.__dict__.get("_program")
        if prog is None or prog.stages[0] != st:
            prog = Program((st,), name=self.name)
            self.__dict__["_program"] = prog
        return prog

    # ------------------------------------------------------------------
    def __call__(self, *operands, interpret: bool = False):
        # A template launch IS the single-stage program: one stage, the
        # template's own block geometry, one launch.
        return self.program().call_blocks(*operands, interpret=interpret)

    # ------------------------------------------------------------------
    def reference(self, ref_fn: Callable) -> Callable:
        """Tag a torch oracle with the same calling convention."""
        @functools.wraps(ref_fn)
        def wrapped(*operands, interpret: bool = False):  # interpret ignored
            del interpret
            return ref_fn(*operands)
        return wrapped

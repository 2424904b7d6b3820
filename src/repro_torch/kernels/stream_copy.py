"""Streaming instructions: c0_lv / c0_sv + the four STREAM kernels (§4.1, Fig. 4).

These are the S'-type instructions of the paper — the two scalar sources
are the base address and loop index (here: the tile offsets K1 computes
from its program id), and the payload is one VLEN-wide vector. memcpy()
composed of c0_lv/c0_sv is the paper's design-space-exploration
workload (Fig. 3).

All four are built from :class:`repro_torch.core.template.KernelTemplate`,
i.e. they are literally "a few user lines inside the provided template",
the paper's usability claim (§2.2): one torch body and one Triton body
each. Each template exposes its bodies as a composable
:class:`~repro_torch.core.template.Stage`, so the c0 family chains into
fused programs (``isa.fuse("c0_scale", "c0_add")``) that run as ONE
launch of the fused kernel K1 (``core/fused_kernel.py``); a solo c0
instruction is the one-stage K1 at the template's declared block.
"""
from __future__ import annotations

import torch

from repro_torch.core.stream import LANES, StreamConfig
from repro_torch.core.template import KernelTemplate


def _copy_body(scalars, ins, carry, step):
    return (ins[0],), carry


def _scale_body(scalars, ins, carry, step):
    return (ins[0] * scalars[0],), carry


def _add_body(scalars, ins, carry, step):
    return (ins[0] + ins[1],), carry


def _triad_body(scalars, ins, carry, step):
    return (ins[0] + scalars[0] * ins[1],), carry


_COPY_TRITON = """
def copy(x0, carry, step):
    return x0, carry
"""

_SCALE_TRITON = """
def scale(s0, x0, carry, step):
    return x0 * s0, carry
"""

_ADD_TRITON = """
def add(x0, x1, carry, step):
    return x0 + x1, carry
"""

_TRIAD_TRITON = """
def triad(s0, x0, x1, carry, step):
    return x0 + s0 * x1, carry
"""


def _template(name, body, triton_body, *, n_scalar_in=0, n_vec_in=1,
              flops=1.0) -> KernelTemplate:
    block_cols = min(StreamConfig().block_elems(torch.float32) // 8,
                     8 * LANES)
    return KernelTemplate(
        name=name, body=body, n_scalar_in=n_scalar_in, n_vec_in=n_vec_in,
        n_vec_out=1, block_rows=8, block_cols=max(LANES, block_cols),
        cost_flops_per_elem=flops, triton_body=triton_body)


COPY = _template("c0_copy", _copy_body, _COPY_TRITON, flops=0.0)
SCALE = _template("c0_scale", _scale_body, _SCALE_TRITON, n_scalar_in=1,
                  flops=1.0)
ADD = _template("c0_add", _add_body, _ADD_TRITON, n_vec_in=2, flops=1.0)
TRIAD = _template("c0_triad", _triad_body, _TRIAD_TRITON, n_scalar_in=1,
                  n_vec_in=2, flops=2.0)


def _launch(tpl: KernelTemplate, scalars, vectors, interpret: bool):
    """One launch at the template's declared block on the operands as
    they lie, the tail masked (``Program.call_flat``), in the caller's
    shape."""
    return tpl.program().call_flat(*scalars, *vectors,
                                   block_rows=tpl.block_rows,
                                   block_cols=tpl.block_cols,
                                   interpret=interpret)


def _scalar_as(s, dtype: torch.dtype) -> float:
    """The scalar rounded to the vectors' dtype, as the reference's
    wrappers pass it (``jnp.asarray(s, x.dtype)``)."""
    return torch.tensor(float(s), dtype=dtype).item()


def stream_copy_kernel(x, *, interpret: bool = False):
    return _launch(COPY, (), (x,), interpret)


def stream_scale_kernel(x, s, *, interpret: bool = False):
    return _launch(SCALE, (_scalar_as(s, x.dtype),), (x,), interpret)


def stream_add_kernel(a, b, *, interpret: bool = False):
    return _launch(ADD, (), (a, b), interpret)


def stream_triad_kernel(a, b, s, *, interpret: bool = False):
    return _launch(TRIAD, (_scalar_as(s, a.dtype),), (a, b), interpret)

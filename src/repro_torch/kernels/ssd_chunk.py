"""The SSD mixer's chunk output in prefill, one kernel on the H100.

Mamba2's chunked SSD (``models/ssm.py``) gives each row i of a chunk c
the output

    y[i] = Σ_{j ≤ i} g[i,j] · exp(cum_i − cum_j) · dt_j · x[j]   (intra)
         + exp(cum_i) · C[i] · run[c−1]ᵀ                          (inter)
         + D · x[i]                                               (skip)

per head, with g = C·Bᵀ, cum the chunk's cumulative log-decay and run
the states after each chunk (c4_statescan's output; no inter term for
the first chunk). The eager chain builds the (B, C, Q, Q, H) weights in
device memory and multiplies in float32; the **SSD chunk-output
kernel** (:data:`SSD_CHUNK`, ``csrc/ssd_chunk.cu``, built by
``_cuda.py``) computes the whole of y in one pass, the weights in
registers, the states read where K4 left them, y written once in the
activations' dtype. It replaces no TPU kernel: the JAX package leaves
this term to XLA; the port adds the kernel because the eager chain took
half of the card's time in Mamba2-1.3B's prefill (PERF.md).

Precision: the same work as the eager chain's float32 products. x and C
hold bf16 values, exact as bf16 tensor-core operands; the weights and
the states go in as :data:`PIECES` bf16 terms (:func:`split`), whose
products are summed in float32. ``pieces=1`` is the single-term
control, which the tests show to miss the layer tolerance.

:func:`chunk_output_plain` is its plain PyTorch version (the same
formula and the same terms, chunk by chunk); ``interpret`` mode runs it
on any device. :func:`shape_error` is the kernel's shape rule, and
:func:`route` the mixer's choice between the kernel, its plain version
and the eager chain.
"""
from __future__ import annotations

import torch

from repro_torch.core.fused_kernel import check_cuda

from . import _cuda

PIECES = 3                   # bf16 terms of each float32 operand
QMAX, PMAX, NMAX = 256, 64, 128
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 2}
# (out dtype, pieces, x, c, g, cum, dt, run, d, y, batch, nc, q, heads,
#  p, n, stream)
_SIGNATURES = {"ssd_chunk_output": (
    _cuda.I32, _cuda.I32, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
    _cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32, _cuda.I32, _cuda.I32,
    _cuda.I32, _cuda.I32, _cuda.P)}


def shape_error(q: int, p: int, n: int, x_dtype: torch.dtype,
                c_dtype: torch.dtype) -> str | None:
    """Why the kernel does not take chunks of ``q`` rows, head dim ``p``
    and state ``n`` with x and C in these dtypes; None when it does."""
    if q % 32 or not 32 <= q <= QMAX:
        return f"chunk {q} is not a multiple of 32 up to {QMAX}"
    if p % 2 or not 2 <= p <= PMAX:
        return f"head dim {p} is not even, up to {PMAX}"
    if n % 16 or not 16 <= n <= NMAX:
        return f"state {n} is not a multiple of 16 up to {NMAX}"
    if x_dtype != torch.bfloat16 or c_dtype != torch.bfloat16:
        return f"x and C are {x_dtype} and {c_dtype}, not bfloat16"
    return None


def route(mode: str, on_cuda: bool, grad: bool, ssd_bf16: bool,
          takes: bool) -> str:
    """How the mixer computes its chunk output: ``"kernel"``, ``"plain"``
    (its plain version), ``"eager"`` (the chain in ``models/ssm.py``) or
    ``"declined"`` (the eager chain, for a call the kernel would have
    served but for its shape or dtype). The kernel serves passes without grad
    (training keeps the chain autograd differentiates) and without
    ``ssd_bf16`` (that knob's bf16 rounding points are the chain's), on
    CUDA under ``kernel`` or ``auto``; ``interpret`` runs its plain
    version on any device, ``ref`` the chain."""
    if grad or ssd_bf16 or mode == "ref":
        return "eager"
    if mode == "interpret":
        return "plain"
    if not on_cuda:
        return "eager"
    return "kernel" if takes else "declined"


def split(v: torch.Tensor, pieces: int = PIECES) -> list[torch.Tensor]:
    """``v`` (float32) as ``pieces`` bf16 terms t1 = bf16(v), t2 =
    bf16(v − t1), … (the kernel's split, differences exact in float32):
    each leaves at most 2⁻⁸ of what it splits; three hold ``v`` exactly
    while every term stays in bf16's normal range."""
    terms, rest = [], v.float()
    for _ in range(pieces):
        t = rest.to(torch.bfloat16)
        terms.append(t)
        rest = rest - t.float()
    return terms


def _product(eq: str, a: torch.Tensor, b: torch.Tensor,
             pieces: int) -> torch.Tensor:
    """einsum(eq, a, b) in float32 with ``b`` as ``pieces`` bf16 terms,
    their products summed in float32."""
    a = a.float()
    out = None
    for t in split(b, pieces):
        part = torch.einsum(eq, a, t.float())
        out = part if out is None else out + part
    return out


def chunk_output_plain(x, c, g, cum, dt, run, d, q: int,
                       out_dtype: torch.dtype,
                       pieces: int = PIECES) -> torch.Tensor:
    """The kernel's formula in plain PyTorch, chunk by chunk: x (B, S, H,
    P), c (B, S, N), g (B, NC, Q, Q), cum (B, NC, Q, H), dt (B, S, H), run
    (B, NC, H, P, N), d (H,) → y (B, S, H, P) in ``out_dtype``; the
    weights and the states as ``pieces`` bf16 terms."""
    b, s, h, p = x.shape
    nc = s // q
    xc = x.reshape(b, nc, q, h, p)
    cc = c.reshape(b, nc, q, -1)
    dtc = dt.reshape(b, nc, q, h)
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    skip = d.float()[:, None]
    ys = []
    for k in range(nc):
        seg = (cum[:, k, :, None, :] - cum[:, k, None, :, :]).masked_fill(
            upper, 0.0)                                      # (B,Q,Q,H) i-j
        w = (seg.exp().masked_fill(upper, 0.0) * g[:, k, :, :, None]
             ) * dtc[:, k, None, :, :]
        y = _product("bjhp,bijh->bihp", xc[:, k], w, pieces)
        if k:
            inter = _product("bin,bhpn->bihp", cc[:, k], run[:, k - 1],
                             pieces)
            y = inter * cum[:, k].exp()[..., None] + y
        ys.append(y + xc[:, k].float() * skip)
    return torch.stack(ys, 1).reshape(b, s, h, p).to(out_dtype)


#: the alignment (bytes) of each operand's widest access in the kernel
_ALIGN = {"x": 16, "c": 4, "g": 8, "cum": 8, "dt": 8, "run": 16, "d": 4}


class ChunkOutputKernel:
    """The SSD chunk-output kernel's wrapper. ``launches`` counts its
    launches, and only those; ``declined`` counts the mixer's calls
    without grad on CUDA that went to the eager chain for their shape or
    dtype (:func:`shape_error`; set by ``models/ssm.py``)."""

    def __init__(self):
        self.launches = 0
        self.declined = 0

    def __call__(self, x, c, g, cum, dt, run, d, q: int,
                 out_dtype: torch.dtype,
                 pieces: int = PIECES) -> torch.Tensor:
        b, s, h, p = x.shape
        n, nc = c.shape[-1], s // q
        why = shape_error(q, p, n, x.dtype, c.dtype)
        if why is not None:
            raise ValueError(f"the SSD chunk kernel does not take this "
                             f"call: {why}")
        if out_dtype not in _OUT_CODES or pieces not in (1, 3):
            raise ValueError(f"the SSD chunk kernel writes float32 or "
                             f"bfloat16 with 1 or 3 terms, got {out_dtype}, "
                             f"{pieces}")
        want = {"c": (b, s, n), "g": (b, nc, q, q), "cum": (b, nc, q, h),
                "dt": (b, s, h), "run": (b, nc, h, p, n), "d": (h,)}
        got = {"c": c, "g": g, "cum": cum, "dt": dt, "run": run, "d": d}
        for name, t in got.items():
            if tuple(t.shape) != want[name] or (
                    name != "c" and t.dtype != torch.float32):
                raise ValueError(f"the SSD chunk kernel takes {name} "
                                 f"{want[name]} float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if s % q:
            raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
        check_cuda([x, c, g, cum, dt, run, d], "the SSD chunk kernel")
        for name, t in dict(got, x=x).items():
            if not t.is_contiguous() or t.data_ptr() % _ALIGN[name]:
                raise ValueError(f"the SSD chunk kernel reads {name} "
                                 f"contiguous and {_ALIGN[name]}-byte "
                                 f"aligned")
        y = torch.empty((b, s, h, p), dtype=out_dtype, device=x.device)
        if y.numel() == 0:
            return y
        lib = _cuda.load("ssd_chunk", _SIGNATURES)
        with torch.cuda.device(x.device):
            err = lib.ssd_chunk_output(
                _OUT_CODES[out_dtype], pieces, x.data_ptr(), c.data_ptr(),
                g.data_ptr(), cum.data_ptr(), dt.data_ptr(), run.data_ptr(),
                d.data_ptr(), y.data_ptr(), b, nc, q, h, p, n,
                torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, "SSD chunk output")
        self.launches += 1
        return y


#: The process-wide kernel wrapper; ``SSD_CHUNK.launches`` is the launch
#: count, ``SSD_CHUNK.declined`` the mixer's declined calls.
SSD_CHUNK = ChunkOutputKernel()


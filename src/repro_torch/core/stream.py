"""Streaming geometry — the H100 analogue of the paper's cache hierarchy knobs.

The paper (§3.1) tunes three widths:
  * VLEN            — vector register width (256-bit sweet spot, Fig. 3 right)
  * DL1 block size  — set equal to VLEN so full-vector stores skip the
                      fetch-on-write-miss read (§3.1.1)
  * LLC block size  — very wide (8192–16384 bit) so one block maps to one
                      long DRAM burst (§3.1.2), stored as sub-blocks that
                      stream out before the burst completes (§3.1.3)

On the H100 the same three degrees of freedom are:
  * VLEN            → the column granularity of a tile: ``LANES`` = 128
                      elements, so a warp's loads coalesce into whole
                      128-byte lines (and 4-element vector loads per thread)
  * DL1 block       → the ``(block_rows, block_cols)`` tile one thread
                      block of the fused kernel owns per column step; rows
                      come in multiples of ``SUBLANES`` = 8
  * LLC block/burst → the bytes a thread block streams per step; the
                      budget that bounds the resident tiles is the shared
                      memory one thread block can use (``SMEM_BYTES``),
                      in place of the paper's BRAM capacity.

``StreamConfig`` carries those choices and the budget check.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# H100 SXM geometry (NVIDIA's H100 data sheet / Hopper tuning guide).
LANES = 128                 # column granularity: coalesced 128-element rows
SUBLANES = 8                # row granularity of a tile
SMEM_BYTES = 232_448        # shared memory one thread block can use (227 KB)

DTYPE_BITS = {
    "float32": 32, "bfloat16": 16, "float16": 16,
    "int32": 32, "int8": 8, "uint8": 8, "int16": 16,
}


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.bfloat16`` →
    ``"bfloat16"``); names pass through. Cache keys and stage
    identities use these names, so they serialise exactly as the JAX
    package's (which names dtypes through numpy)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    raise TypeError(f"expected a torch.dtype or a dtype name, got {dtype!r}")


def _bits(dtype) -> int:
    name = dtype_name(dtype)
    try:
        return DTYPE_BITS[name]
    except KeyError as e:
        raise ValueError(f"unsupported dtype for streaming geometry: {name}") from e


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Block geometry for a streaming instruction (paper Table 1 analogue).

    vlen_bits:   per-step vector width a kernel body sees (paper: VLEN).
    block_bits:  bits one thread block streams per step ("LLC block").
    n_buffers:   pipeline depth of the tile loads (paper §3.1.4 "double
                 the interconnect rate" → overlap instead). Capacity-wise
                 a partial buffer still occupies a whole one (``ceil``).
    """

    vlen_bits: int = 256 * 128       # 256-bit paper VLEN × 128 lanes
    block_bits: int = 16384 * 128    # paper's 16384-bit LLC block × lanes
    n_buffers: float = 2

    def __post_init__(self):
        if self.vlen_bits % (LANES * 8) != 0:
            raise ValueError(
                f"vlen_bits={self.vlen_bits} must be a multiple of "
                f"{LANES * 8} (byte-aligned across {LANES} lanes)")
        if self.block_bits % self.vlen_bits != 0:
            raise ValueError("block_bits must be a multiple of vlen_bits "
                             "(LLC block holds whole sub-blocks, §3.1.3)")

    # -- derived geometry ---------------------------------------------------
    def vlen_elems(self, dtype) -> int:
        return self.vlen_bits // _bits(dtype)

    def block_elems(self, dtype) -> int:
        return self.block_bits // _bits(dtype)

    def sub_blocks(self) -> int:
        """Paper §3.1.3: sub-blocks per LLC block."""
        return self.block_bits // self.vlen_bits

    def block_shape_2d(self, dtype) -> tuple[int, int]:
        """A (rows, LANES) tile covering one streamed block."""
        elems = self.block_elems(dtype)
        rows = max(1, elems // LANES)
        return (rows, LANES)

    # -- budget check (BRAM capacity analogue) ------------------------------
    def smem_footprint_bytes(self, n_operands: int) -> int:
        """Bytes of on-chip memory pinned by the operand tiles.

        ``block_bits`` fixes the tile's size in bits, so the footprint is
        dtype-independent; a fractional overlap depth still pins whole
        buffers.
        """
        return n_operands * math.ceil(self.n_buffers) * self.block_bits // 8

    def check_smem_budget(self, n_operands: int,
                          budget: int = SMEM_BYTES) -> None:
        fp = self.smem_footprint_bytes(n_operands)
        if fp > budget:
            raise ValueError(
                f"instruction operand blocks need {fp} B of shared memory "
                f"({n_operands} operands × {self.n_buffers} buffers × "
                f"{self.block_bits // 8} B) > budget {budget} B — shrink "
                f"block_bits (the paper hit the same wall with BRAM, §3.1.3)")

    # -- hierarchy-derived defaults (paper §3.1 knob mapping) ---------------
    @classmethod
    def from_hierarchy(cls, hier, n_buffers: int = 2) -> "StreamConfig":
        """Derive the default geometry from a :class:`repro_torch.memhier.
        hierarchy.Hierarchy`: VLEN from the first level's block (DL1
        block = VLEN, §3.1.1) and the streamed block from the LLC block
        (one block = one burst, §3.1.2), both rounded up to the column
        and sub-block granularity so the result satisfies
        ``__post_init__``.
        """
        vlen_bits = round_up(hier.levels[0].block_bytes * 8, LANES * 8)
        block_bits = round_up(hier.llc.block_bytes * 8, vlen_bits)
        return cls(vlen_bits=vlen_bits, block_bits=block_bits,
                   n_buffers=n_buffers)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pad_vocab(vocab: int, mult: int = 256) -> int:
    """Pad embedding-table rows so the vocab dim shards over any axis ≤ mult.

    (50280 → 50432, 32001 → 32256; logits over padding are masked.)
    """
    return round_up(vocab, mult)


# -- shared operand shape normalisation --------------------------------------
# One entry path for every streaming op and fused program: kernels see 2D
# (rows, cols) tiles whose geometry satisfies the block constraints; callers
# keep arbitrary shapes.

def as_rows(x: torch.Tensor, cols: int):
    """Collapse all leading axes; last axis stays the vector axis.

    Returns (x2d, lead_shape) so callers can restore the original shape.
    """
    lead = tuple(x.shape[:-1])
    return x.reshape(math.prod(lead), cols), lead


def pad_rows(x2d: torch.Tensor, mult: int = SUBLANES):
    """Zero-pad rows up to the row granularity; returns (padded, n_rows)."""
    r = x2d.shape[0]
    pad = (-r) % mult
    if pad:
        x2d = torch.nn.functional.pad(x2d, (0, 0, 0, pad))
    return x2d, r


def flatten_to_blocks(x: torch.Tensor, block_cols: int,
                      block_rows: int = SUBLANES):
    """Flatten to (rows, block_cols), padded to whole (block_rows, block_cols)
    tiles; returns (x2d, n_valid_elems). The streaming-op entry path: a fused
    program and every c0 instruction normalise operands through here. A
    contiguous operand that already fills whole tiles is returned as a
    view (no copy)."""
    n = x.numel()
    rows = round_up(-(-n // block_cols), block_rows)
    flat = x.reshape(-1)
    pad = rows * block_cols - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(rows, block_cols), n

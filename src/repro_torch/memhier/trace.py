"""Access-trace generation for the hierarchy simulator.

A trace is a sequence of :class:`Access` records — the per-grid-step
memory behaviour of a streaming instruction or fused program:

  * each vector operand is one sequential *stream* in its own address
    region (streams never alias);
  * per grid step, each input stream reads one block and each output
    stream writes one block (write-only: outputs are produced whole, so
    the §3.1.1 full-block-write skip applies — no fetch-on-write-miss);
  * chained intermediates of a fused :class:`~repro_torch.core.program.Program`
    are ELIDED: they live in registers inside the single K1 launch and
    never reach the memory system. This is the fusion layer's whole
    point, and the simulator sees it as missing traffic.

Generators are cheap to re-create, so geometry searches regenerate the
trace per candidate instead of materialising it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

from repro_torch.core.stream import StreamConfig, _bits, round_up

# Streams are placed in disjoint 1-TiB-aligned regions so they can never
# share a cache block.
STREAM_SPACING = 1 << 40


@dataclasses.dataclass(frozen=True)
class Access:
    """One memory access: `kind` is "r" or "w"; `stream` labels the operand."""

    addr: int
    nbytes: int
    kind: str
    stream: str


def stream_trace(n_bytes: int, block_bytes: int,
                 read_streams: Sequence[str],
                 write_streams: Sequence[str] = (),
                 region_base: int = 0) -> Iterator[Access]:
    """Interleaved streaming trace: per step, one block per stream.

    Reads and writes of a step are adjacent (the grid pipeline issues
    them together); the final partial block is truncated to ``n_bytes``.
    ``region_base`` offsets the address regions so independent launches
    (e.g. the stages of an unfused chain) never alias.
    """
    if n_bytes <= 0 or block_bytes <= 0:
        return
    streams = [(s, region_base + i, "r")
               for i, s in enumerate(read_streams)]
    streams += [(s, region_base + len(read_streams) + i, "w")
                for i, s in enumerate(write_streams)]
    n_steps = -(-n_bytes // block_bytes)
    for step in range(n_steps):
        off = step * block_bytes
        size = min(block_bytes, n_bytes - off)
        for name, region, kind in streams:
            yield Access(region * STREAM_SPACING + off, size, kind, name)


def trace_config(cfg: StreamConfig, n_elems: int, dtype,
                 n_in: int = 1, n_out: int = 1) -> Iterator[Access]:
    """Trace of one streaming instruction at a StreamConfig's geometry."""
    block_bytes = cfg.block_bits // 8
    total = round_up(n_elems * _bits(dtype) // 8, block_bytes)
    return stream_trace(total, block_bytes,
                        [f"in{i}" for i in range(n_in)],
                        [f"out{i}" for i in range(n_out)])


def trace_stage(stage, n_elems: int, dtype,
                region_base: int = 0) -> Iterator[Access]:
    """Trace of one unfused :class:`~repro_torch.core.template.Stage` launch:
    every vector input is read from and every output spilled to memory."""
    bits = _bits(dtype)
    block_bytes = stage.block_rows * stage.block_cols * bits // 8
    total = round_up(n_elems * bits // 8, block_bytes)
    return stream_trace(total, block_bytes,
                        [f"{stage.name}.in{i}" for i in range(stage.n_vec_in)],
                        [f"{stage.name}.out{i}"
                         for i in range(stage.n_vec_out)],
                        region_base=region_base)


def trace_program(program, n_elems: int, dtype,
                  block_rows: Optional[int] = None,
                  block_cols: Optional[int] = None) -> Iterator[Access]:
    """Trace of a fused Program: external inputs + final outputs only.

    Chained intermediates are elided — they stay in registers inside the
    one K1 launch. Geometry defaults to the stages' declared blocks
    (as in ``Program.call_blocks``); the negotiation passes candidates
    explicitly. ``program`` is duck-typed (n_ext_vec_in / n_vec_out /
    stages) so this module never imports :mod:`repro_torch.core.program`.
    """
    stages = program.stages
    if block_rows is None:
        block_rows = max(st.block_rows for st in stages)
    if block_cols is None:
        block_cols = max(st.block_cols for st in stages)
    bits = _bits(dtype)
    block_bytes = block_rows * block_cols * bits // 8
    total = round_up(n_elems * bits // 8, block_bytes)
    return stream_trace(total, block_bytes,
                        [f"in{i}" for i in range(program.n_ext_vec_in)],
                        [f"out{i}" for i in range(program.n_vec_out)])


def trace_program_unfused(program, n_elems: int, dtype) -> Iterator[Access]:
    """The same chain as N separate launches: every stage's inputs re-read
    from and outputs spilled to memory — the fusion counterfactual.

    Stages get disjoint address regions: each launch re-streams its
    operands from DRAM (a launch's on-chip staging is not a coherent
    cache surviving between launches).
    """
    base = 0
    for st in program.stages:
        yield from trace_stage(st, n_elems, dtype, region_base=base)
        base += st.n_vec_in + st.n_vec_out


def demand_bytes(trace: Iterable[Access]) -> int:
    """Total bytes an (exhaustible) trace demands — consumes the trace."""
    return sum(a.nbytes for a in trace)

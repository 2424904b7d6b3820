"""repro_torch.memhier — trace-driven cache-hierarchy simulator (paper §3.1).

The port of :mod:`repro.memhier`, pure Python over
:mod:`repro_torch.core.stream` and :mod:`repro_torch.core.burst_model`:
:mod:`~repro_torch.memhier.hierarchy` describes the levels (DL1 full-block
write skip, sub-blocked very-wide LLC, per-set replacement policy, DRAM
burst model underneath; the ``PAPER_ULTRA96`` and ``H100`` presets),
:mod:`~repro_torch.memhier.trace` derives access traces from streaming
configs / stages / fused programs, :mod:`~repro_torch.memhier.predict`
simulates a trace to predicted time, per-level breakdowns and a
best-geometry search, and :mod:`~repro_torch.memhier.fastsim` is the
phase-structured fast engine the scoring hot paths use (bit-identical
to :func:`~repro_torch.memhier.predict.simulate` on periodic traces).
For the same hierarchy values and trace, every statistic equals the JAX
package's.
"""
from .fastsim import simulate_fast
from .hierarchy import (H100, CacheLevel, ChannelModel, Hierarchy,
                        LastLevelCache, PAPER_ULTRA96, PRESETS)
from .predict import (DramStats, FluidItem, LevelStats, Prediction,
                      best_geometry, contended_makespan, fluid_finish_times,
                      fluid_makespan, predict_program, simulate,
                      stream_bandwidth, sweep_llc_blocks)
from .trace import (Access, demand_bytes, stream_trace, trace_config,
                    trace_program, trace_program_unfused, trace_stage)

__all__ = [
    "Access", "CacheLevel", "ChannelModel", "DramStats", "FluidItem",
    "H100", "Hierarchy", "LastLevelCache",
    "LevelStats", "PAPER_ULTRA96", "PRESETS", "Prediction",
    "best_geometry", "contended_makespan", "demand_bytes",
    "fluid_finish_times", "fluid_makespan",
    "predict_program", "simulate",
    "simulate_fast", "stream_bandwidth", "stream_trace", "sweep_llc_blocks",
    "trace_config", "trace_program", "trace_program_unfused", "trace_stage",
]

"""Analytical burst-efficiency model (paper Fig. 3 law, re-parameterised).

The paper's LLC-block sweep (Fig. 3 left) shows memcpy() throughput rising
with block size and plateauing around 8192-bit blocks: each block is one
AXI burst, and a burst pays a fixed handshake latency before streaming.
The standard model is

    T(block) = t_overhead + block_bytes / B_peak
    B_eff    = block_bytes / T(block)
             = B_peak * block_bytes / (block_bytes + t_overhead * B_peak)

i.e. efficiency = block / (block + "critical block size") where the
critical block size N_1/2 = t_overhead * B_peak is the block size at which
half of peak is reached (classic n_1/2 from vector-machine literature).

On the H100 the fused kernel (K1) moves one ``(block_rows, block_cols)``
tile per column step of a thread block, so the same law prices a
candidate tile width during geometry negotiation
(:meth:`repro_torch.core.program.Program.negotiate_geometry`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BurstModel:
    peak_bw: float           # bytes/s at infinite block size
    overhead_s: float        # fixed per-burst latency (handshake / descriptor)

    @property
    def n_half_bytes(self) -> float:
        """Block size achieving 50% of peak."""
        return self.peak_bw * self.overhead_s

    def fingerprint(self) -> tuple:
        """Hashable value identifying this model's predictions.

        The dispatch-cache key component in
        :meth:`repro_torch.core.program.Program.negotiate_geometry`: two
        models with equal fingerprints score geometries identically, and
        any parameter edit (a ``dataclasses.replace``) changes the
        fingerprint, so cached geometries invalidate correctly. Equal to
        the JAX package's fingerprint for equal fields, so both packages
        share plan-cache entries.
        """
        return ("burst", self.peak_bw, self.overhead_s)

    def effective_bw(self, block_bytes: float) -> float:
        return self.peak_bw * block_bytes / (block_bytes + self.n_half_bytes)

    def time_for(self, total_bytes: float, block_bytes: float) -> float:
        n_bursts = max(1.0, total_bytes / block_bytes)
        return n_bursts * (self.overhead_s + block_bytes / self.peak_bw)

    def plateau_block_bytes(self, frac: float = 0.9) -> float:
        """Smallest block reaching `frac` of peak (paper: ~8192 bit ≈ 1 KiB)."""
        return frac / (1.0 - frac) * self.n_half_bytes


# Paper's platform (Ultra96, AXI @ 150–300 MHz): measured memcpy plateau of
# ~1.37 GB/s at 16384-bit blocks, ~50% of plateau around 1024-bit blocks
# → N_1/2 ≈ 128 B. (Fig. 3 left.)
PAPER_AXI = BurstModel(peak_bw=1.45e9, overhead_s=128 / 1.45e9)

# H100 SXM, 700 W: 3.35 TB/s HBM3 peak (NVIDIA's H100 SXM data sheet).
# overhead_s is ASSUMED, not measured: about one device-memory round trip
# plus the scheduling of one thread block's tile, ~1 µs. It only ranks
# candidate tile widths; a fit from chip timings replaces it later.
H100_HBM = BurstModel(peak_bw=3.35e12, overhead_s=1e-6)

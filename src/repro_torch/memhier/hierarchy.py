"""Cache-hierarchy description — paper §3.1 as data.

The paper's memory contribution is a hierarchy optimised for *bandwidth*
rather than latency:

  * §3.1.1 — the DL1 block equals VLEN, so a full-vector store covers a
    whole block and the fetch-on-write-miss read is skipped entirely
    (``full_block_write_skips_fetch``);
  * §3.1.2 — the last-level cache uses very wide blocks (8192–16384 bit)
    so that one block maps onto one long DRAM burst, amortising the
    fixed AXI handshake over many beats;
  * §3.1.3 — the wide LLC block is *sub-blocked*: validity is tracked at
    sub-block (VLEN) granularity, so sub-blocks stream out to DL1 before
    the burst completes and partial writes need no read-fill.

:class:`CacheLevel` captures one level's geometry and write policy,
:class:`LastLevelCache` adds the sub-block granularity, and
:class:`Hierarchy` stacks levels over the DRAM/HBM
:class:`~repro_torch.core.burst_model.BurstModel` (the §3.1.2 burst law —
one LLC-block fill or writeback is one burst).

Two presets anchor the two platforms the port models:

  * :data:`PAPER_ULTRA96` — the paper's Ultra96 softcore: 256-bit VLEN /
    DL1 blocks, a 16384-bit sub-blocked LLC, AXI DRAM (Fig. 3 left).
  * :data:`H100` — one H100 SXM: a thread block's shared memory as the
    staging level, the 50 MB L2 as the sub-blocked last level whose
    block is the tile one thread block streams per column step of K1,
    HBM3 as DRAM.

The classes are the JAX package's, field for field, so a hierarchy
built with the same values in either package has the same fingerprint
and the same simulated statistics. The trace-driven engine that runs a
hierarchy lives in :mod:`repro_torch.memhier.predict`; access traces
come from :mod:`repro_torch.memhier.trace`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.burst_model import H100_HBM, PAPER_AXI, BurstModel
from repro_torch.core.stream import SMEM_BYTES


@dataclasses.dataclass(frozen=True)
class CacheLevel:
    """One cache level: block geometry, capacity, write policy, port speed.

    write_allocate:
        on a write miss, fetch the block from below before writing
        (classic fetch-on-write-miss). Ignored when the write covers
        whole (sub-)blocks and ``full_block_write_skips_fetch`` is set.
    full_block_write_skips_fetch:
        paper §3.1.1 — a write covering a whole block (whole sub-blocks
        for a sub-blocked level) allocates without reading below.
    bandwidth:
        bytes/s the level's ports sustain (demand + fill + writeback
        traffic all cross them); the per-level busy-time term.
    hit_latency_s:
        per-access latency; streaming pipelines mostly hide it, so the
        presets keep it small but it participates in busy time.
    n_ways:
        set associativity: blocks per set, with set-indexed replacement
        inside each set — so reuse-heavy traces pay conflict misses when
        hot lines collide on a set. ``None`` (the default) keeps the
        level fully associative, the pre-associativity behaviour. ``1``
        is direct-mapped. When ``n_ways`` does not divide ``n_blocks``,
        the remainder blocks are unreachable (the modeled capacity is
        ``n_sets * n_ways``, as in real hardware where sets × ways
        defines the cache) — prefer geometries where it divides.
    policy:
        replacement policy inside each set: ``"lru"`` (the default,
        recency order refreshed on every hit), ``"fifo"`` (insertion
        order only — hits do not refresh, the cheap-BRAM option a
        softcore LLC would actually ship), or ``"plru"`` (bit-pseudo-LRU:
        one MRU bit per line, victim is the first line whose bit is
        clear; when setting a bit would set them all, the others reset).
        The engine in :mod:`repro_torch.memhier.predict` honours the policy on
        hits and on victim selection.
    """

    POLICIES = ("lru", "fifo", "plru")

    name: str
    block_bytes: int
    capacity_bytes: int
    bandwidth: float
    hit_latency_s: float = 0.0
    write_allocate: bool = True
    full_block_write_skips_fetch: bool = True
    n_ways: Optional[int] = None
    policy: str = "lru"

    def __post_init__(self):
        if self.block_bytes <= 0:
            raise ValueError(f"{self.name}: block_bytes must be positive")
        if self.capacity_bytes < self.block_bytes:
            raise ValueError(
                f"{self.name}: capacity {self.capacity_bytes} B holds no "
                f"{self.block_bytes}-byte block")
        if self.bandwidth <= 0:
            raise ValueError(f"{self.name}: bandwidth must be positive")
        if self.n_ways is not None and self.n_ways <= 0:
            raise ValueError(f"{self.name}: n_ways must be positive "
                             f"(None = fully associative)")
        if self.policy not in self.POLICIES:
            raise ValueError(f"{self.name}: unknown replacement policy "
                             f"{self.policy!r}; have {self.POLICIES}")

    @property
    def n_blocks(self) -> int:
        return self.capacity_bytes // self.block_bytes

    @property
    def n_sets(self) -> int:
        """Sets the block index hashes over (1 = fully associative)."""
        if self.n_ways is None:
            return 1
        return max(1, self.n_blocks // self.n_ways)

    @property
    def ways(self) -> int:
        """Blocks per set the replacement policy manages (capacity-clamped
        so geometry edits like :meth:`Hierarchy.with_llc_block` cannot
        oversubscribe a shrunken level)."""
        if self.n_ways is None:
            return self.n_blocks
        return min(self.n_ways, self.n_blocks)

    @property
    def sub_bytes(self) -> int:
        """Write-skip granularity; a plain level needs the whole block."""
        return self.block_bytes


@dataclasses.dataclass(frozen=True)
class LastLevelCache(CacheLevel):
    """A very wide, sub-blocked level (paper §3.1.2–3.1.3).

    One block fill/writeback is one DRAM burst; validity at sub-block
    granularity means writes covering whole sub-blocks skip the fill
    even when they don't cover the whole (very wide) block.
    """

    sub_block_bytes: int = 0      # 0 → block_bytes (no sub-blocking)

    def __post_init__(self):
        super().__post_init__()
        sub = self.sub_block_bytes or self.block_bytes
        if self.block_bytes % sub:
            raise ValueError(
                f"{self.name}: block {self.block_bytes} B must hold whole "
                f"{sub}-byte sub-blocks (§3.1.3)")

    @property
    def sub_bytes(self) -> int:
        return self.sub_block_bytes or self.block_bytes


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """N independent DRAM channels behind the last-level cache
    (DESIGN.md §18).

    Multi-stack semantics: the hierarchy's ``dram`` :class:`BurstModel`
    describes ONE channel, so aggregate bandwidth scales with
    ``n_channels`` — like adding HBM stacks, not like slicing one
    interface. ``peak_bw`` overrides the per-channel peak (``None``
    inherits ``dram.peak_bw``); per-burst ``overhead_s`` always comes
    from ``dram``.

    ``mapping`` places each burst on a channel by its address:

      * ``"interleave"`` — round-robin at ``interleave_bytes``
        granularity, ``(addr // interleave_bytes) % n_channels``: one
        stream spreads over all channels (one-item aggregate bandwidth).
      * ``"pinned"`` — by 1-TiB stream region (the spacing
        :mod:`repro_torch.memhier.trace` places operand streams at), region
        ``% n_channels`` unless ``pins`` maps it explicitly: streams /
        parts own whole channels, so distinct items never collide —
        the lane→channel story the scheduler builds on.
    """

    MAPPINGS = ("interleave", "pinned")
    REGION_BYTES = 1 << 40       # == trace.STREAM_SPACING

    n_channels: int = 1
    mapping: str = "interleave"
    interleave_bytes: int = 4096
    peak_bw: Optional[float] = None
    pins: Optional[tuple[tuple[int, int], ...]] = None  # (region, channel)

    def __post_init__(self):
        if self.n_channels <= 0:
            raise ValueError("n_channels must be positive")
        if self.mapping not in self.MAPPINGS:
            raise ValueError(f"unknown channel mapping {self.mapping!r}; "
                             f"have {self.MAPPINGS}")
        if self.interleave_bytes <= 0:
            raise ValueError("interleave_bytes must be positive")
        for region, ch in self.pins or ():
            if not (0 <= ch < self.n_channels):
                raise ValueError(f"pin {region} -> {ch} outside "
                                 f"{self.n_channels} channels")

    def channel_of(self, addr: int) -> int:
        """The channel serving a burst at ``addr``."""
        if self.n_channels == 1:
            return 0
        if self.mapping == "interleave":
            return (addr // self.interleave_bytes) % self.n_channels
        region = addr // self.REGION_BYTES
        for r, ch in self.pins or ():
            if r == region:
                return ch
        return region % self.n_channels

    def fingerprint(self) -> tuple:
        return ("channels", self.n_channels, self.mapping,
                self.interleave_bytes, self.peak_bw, self.pins)


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """A stack of cache levels (closest to the core first) over DRAM.

    ``dram`` is the existing :class:`BurstModel`: every last-level block
    fill or dirty writeback costs one burst, ``overhead_s + bytes/peak``.

    ``channels`` (optional, DESIGN.md §18) splits DRAM into N
    independent per-channel interfaces; ``None`` and
    ``ChannelModel(n_channels=1)`` are modeled identically (the
    pre-channel single-interface behaviour, bit for bit).
    """

    name: str
    levels: tuple[CacheLevel, ...]
    dram: BurstModel
    channels: Optional[ChannelModel] = None

    def __post_init__(self):
        for above, below in zip(self.levels, self.levels[1:]):
            if below.block_bytes % above.block_bytes:
                raise ValueError(
                    f"{self.name}: {below.name} block ({below.block_bytes} B)"
                    f" must hold whole {above.name} blocks "
                    f"({above.block_bytes} B)")

    @property
    def n_channels(self) -> int:
        return self.channels.n_channels if self.channels else 1

    def with_channels(self, n_channels: int, mapping: str = "interleave",
                      interleave_bytes: int = 4096,
                      peak_bw: Optional[float] = None,
                      pins=None) -> "Hierarchy":
        """This hierarchy with an N-channel DRAM (multi-stack semantics:
        per-channel peak defaults to the full ``dram`` peak, so aggregate
        bandwidth is ``n_channels ×`` the single-channel preset)."""
        ch = ChannelModel(n_channels=n_channels, mapping=mapping,
                          interleave_bytes=interleave_bytes,
                          peak_bw=peak_bw,
                          pins=tuple(pins) if pins else None)
        return dataclasses.replace(self, channels=ch)

    def fingerprint(self) -> tuple:
        """Hashable value identifying this hierarchy's modeled behaviour.

        The dispatch-cache key component in
        :meth:`repro_torch.core.program.Program.negotiate_geometry` (DESIGN.md
        §12): any level edit — a mutated LLC block via
        :meth:`with_llc_block`, a policy change, a different preset —
        yields a different fingerprint, so cached geometries invalidate;
        structurally identical hierarchies share cache entries even
        across distinct objects.
        """
        base = ("hier",
                tuple((type(lv).__name__,) + dataclasses.astuple(lv)
                      for lv in self.levels),
                self.dram.fingerprint())
        # a 1-channel ChannelModel is modeled identically to channels=None
        # (the N=1 identity gate), so both share the legacy fingerprint —
        # and with it every persisted geometry/plan artifact (§14).
        if self.channels is None or self.channels.n_channels == 1:
            return base
        return base + (self.channels.fingerprint(),)

    @property
    def dl1(self) -> CacheLevel:
        return self.levels[0]

    @property
    def llc(self) -> CacheLevel:
        """The level whose block size is the DRAM burst length (§3.1.2)."""
        return self.levels[-1]

    def with_llc_block(self, block_bytes: int) -> "Hierarchy":
        """This hierarchy with the LLC block (= burst length) replaced.

        The geometry-search knob: sweeping it reproduces Fig. 3, and the
        Program block negotiation evaluates candidates through it.
        Capacity is bumped to hold at least 4 blocks; the sub-block
        granularity is kept when it still divides, else collapsed.
        """
        if not self.levels:
            return self
        llc = self.llc
        sub = llc.sub_bytes if block_bytes % llc.sub_bytes == 0 else block_bytes
        repl = dict(
            block_bytes=block_bytes,
            capacity_bytes=max(llc.capacity_bytes, 4 * block_bytes),
        )
        if isinstance(llc, LastLevelCache):
            repl["sub_block_bytes"] = sub
        new_llc = dataclasses.replace(llc, **repl)
        # keep upper levels no wider than the new LLC block
        uppers = tuple(
            lv if block_bytes % lv.block_bytes == 0 else dataclasses.replace(
                lv, block_bytes=block_bytes,
                capacity_bytes=max(lv.capacity_bytes, 4 * block_bytes))
            for lv in self.levels[:-1])
        return dataclasses.replace(self, levels=uppers + (new_llc,))


# -- presets ------------------------------------------------------------------

# The paper's Ultra96 softcore (Fig. 3 left): 256-bit VLEN, DL1 blocks equal
# to VLEN (§3.1.1), a 16384-bit sub-blocked LLC (§3.1.2-3) in PL BRAM, AXI
# DRAM with N_1/2 ≈ 128 B. Port rates: one VLEN per ~150 MHz cycle at DL1
# (4.8 GB/s); the LLC runs the doubled interconnect rate of §3.1.4.
PAPER_ULTRA96 = Hierarchy(
    name="paper_ultra96",
    levels=(
        CacheLevel("dl1", block_bytes=32, capacity_bytes=32 * 1024,
                   bandwidth=4.8e9),
        LastLevelCache("llc", block_bytes=2048, capacity_bytes=512 * 1024,
                       bandwidth=9.6e9, sub_block_bytes=32),
    ),
    dram=PAPER_AXI,
    # the Ultra96 PS exposes a single DDR4 channel to the PL AXI ports
    channels=ChannelModel(n_channels=1),
)

# H100 SXM5 80 GB (NVIDIA's H100 data sheet, the Hopper tuning guide and
# the CUDA programming guide's compute-capability 9.0 table). The whole
# launch is one trace, so port rates are the 132 SMs' aggregate.
H100_SMS = 132                  # SMs of the H100 SXM5 (data sheet)
H100_BOOST_HZ = 1.98e9          # max SM clock of the H100 SXM5 (data sheet)
H100 = Hierarchy(
    name="h100",
    levels=(
        # A thread block's shared memory, the staging level K1's tiles
        # pass through (the paper's DL1).
        CacheLevel(
            "smem",
            # ASSUMED: the port's VLEN (StreamConfig().vlen_bits, 4 KiB),
            # K1's smallest tile of 8 × 128 fp32 (SUBLANES × LANES)
            block_bytes=4096,
            # 227 KB a thread block may use (SMEM_BYTES; tuning guide)
            capacity_bytes=SMEM_BYTES,
            # 32 banks × 4 B a clock per SM (CUDA guide, CC 9.0), all
            # SMs at the boost clock: 33.45 TB/s
            bandwidth=H100_SMS * 128 * H100_BOOST_HZ),
        # The L2 (the paper's very wide sub-blocked LLC).
        LastLevelCache(
            "l2",
            # ASSUMED: K1's declared c0 tile, 8 × 1024 fp32 — the bytes
            # one thread block streams per column step (the "burst"
            # of §3.1.2); negotiation replaces it per candidate tile
            block_bytes=8 * 1024 * 4,
            # 50 MB (data sheet; the device reports 52,428,800 bytes)
            capacity_bytes=50 * 1024 * 1024,
            # ASSUMED: NVIDIA publishes no L2 rate; about 1.6× HBM3
            bandwidth=5.5e12,
            # 128-byte L2 lines (tuning guide): writes of whole lines
            # need no fill
            sub_block_bytes=128),
    ),
    # HBM3, 3.35 TB/s (data sheet); overhead_s assumed (burst_model.py)
    dram=H100_HBM,
    # H100_HBM's 3.35 TB/s is the five HBM3 stacks' aggregate: one
    # interface, as the JAX package's base preset folds its stacks
    channels=ChannelModel(n_channels=1),
)

PRESETS = {h.name: h for h in (PAPER_ULTRA96, H100)}

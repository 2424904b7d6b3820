"""Trace-driven hierarchy simulation → predicted time and traffic.

The engine walks an access trace through the :class:`Hierarchy`: each
level is a fully-associative LRU cache of its blocks; misses fill from
the level below; dirty evictions write back below; every last-level fill
or writeback is one DRAM burst priced by the
:class:`~repro_torch.core.burst_model.BurstModel` (``overhead_s + bytes/peak``
— the Fig. 3 law the one-term ``BurstModel`` applied to the whole
machine, now applied only where it belongs, at the burst interface).

Predicted time is the *bottleneck* busy time across levels and DRAM:
the paper's streaming pipeline (sub-blocked LLC serving DL1 mid-burst,
§3.1.3; doubled interconnect rate, §3.1.4) and K1's pipelined tile
loads both overlap levels, so the slowest stage sets throughput. For a pure
stream with no reuse every byte misses through to DRAM and the predicted
effective bandwidth collapses to the Fig. 3 burst law at the LLC block
size — the validation gate of the JAX package's
``benchmarks/bench_blocksweep.py``, held by ``tests/test_torch_memhier.py``
on the same presets.

Approximations (documented, deliberate):
  * replacement is per set (``CacheLevel.n_ways`` sets the
    associativity; the ``n_ways=None`` default is fully associative —
    no conflict misses; a non-dividing ``n_ways`` models only
    ``n_sets * n_ways`` blocks of the declared capacity) and follows
    ``CacheLevel.policy``: ``"lru"`` refreshes recency on every hit,
    ``"fifo"`` evicts in pure insertion order, ``"plru"`` is bit-
    pseudo-LRU (an MRU bit per line; victim = first clear bit);
  * a write covering whole sub-blocks allocates without tracking partial
    validity (§3.1.3 valid bits are assumed to work);
  * ``hit_latency_s`` charges busy time but not dependent-access latency
    (streams are independent);
  * ``n_buffers`` (the :class:`~repro_torch.core.stream.StreamConfig`
    double-buffering depth) sets the overlap model: with ≥ 2 buffers the
    levels pipeline and the slowest stage sets throughput
    (``max(busy)``, the §3.1.3/§3.1.4 overlap); a single buffer
    serialises fill with compute, so the stages' busy times add.

Scoring hot paths (geometry negotiation, the partitioner's beam search,
``best_geometry``) route every simulation through the phase-structured
fast engine in :mod:`repro_torch.memhier.fastsim` — exact-by-construction on
the periodic streaming traces of :mod:`repro_torch.memhier.trace`, falling
back to the reference :func:`simulate` loop on irregular traces
(DESIGN.md §12).
"""
from __future__ import annotations

import copy
import dataclasses
from collections import OrderedDict
from typing import Iterable, Optional, Sequence

from repro_torch.core.stream import _bits, round_up

from .hierarchy import CacheLevel, Hierarchy
from .trace import Access, stream_trace, trace_program

# Geometry searches and roofline terms simulate at most this many bytes
# per stream and scale linearly — streaming traces are cold-miss
# dominated, so per-byte cost converges fast.
MAX_SIM_BYTES = 1 << 24


@dataclasses.dataclass
class LevelStats:
    """Per-level traffic breakdown of one simulation."""

    name: str
    hits: int = 0
    misses: int = 0
    write_skips: int = 0          # §3.1.1 fills avoided on full writes
    read_bytes: int = 0           # demand reads arriving at this level
    write_bytes: int = 0          # demand writes arriving at this level
    fill_bytes: int = 0           # fetched from the level below
    writeback_bytes: int = 0      # dirty evictions pushed below
    busy_s: float = 0.0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def port_bytes(self) -> int:
        return (self.read_bytes + self.write_bytes
                + self.fill_bytes + self.writeback_bytes)


@dataclasses.dataclass
class DramStats:
    """DRAM burst interface totals (one burst per LLC fill/writeback)."""

    bursts: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    busy_s: float = 0.0

    @property
    def bytes(self) -> int:
        return self.read_bytes + self.write_bytes


@dataclasses.dataclass
class Prediction:
    """Simulation result: time, bandwidth, and the per-level breakdown.

    ``dram_channels`` (DESIGN.md §18) is the per-channel split of the
    DRAM counters when the hierarchy carries a multi-channel
    :class:`~repro_torch.memhier.hierarchy.ChannelModel`; empty on the
    single-channel path, where ``dram`` alone is authoritative (bit for
    bit the pre-channel behaviour)."""

    time_s: float
    demand_bytes: int
    levels: tuple[LevelStats, ...]
    dram: DramStats
    bottleneck: str
    scale: float = 1.0            # >1 when a capped trace was extrapolated
    n_buffers: float = 2          # overlap depth the timing term assumed
    dram_channels: tuple[DramStats, ...] = ()

    @property
    def effective_bw(self) -> float:
        return self.demand_bytes / self.time_s if self.time_s > 0 else 0.0

    @property
    def dram_busy_s(self) -> float:
        """Full-workload DRAM busy seconds. ``time_s``/``demand_bytes``
        are already extrapolated by ``scale`` for capped simulations; the
        per-level/DRAM stats describe the simulated window only, so the
        contention math scales the DRAM term here."""
        return self.scale * self.dram.busy_s

    @property
    def dram_bytes(self) -> int:
        """Full-workload DRAM traffic bytes (window stats × ``scale``)."""
        return int(round(self.scale * self.dram.bytes))

    @property
    def dram_busy_by_channel(self) -> tuple[float, ...]:
        """Full-workload DRAM busy seconds per channel (length 1 on the
        single-channel path, where it equals ``(dram_busy_s,)``)."""
        if not self.dram_channels:
            return (self.dram_busy_s,)
        return tuple(self.scale * c.busy_s for c in self.dram_channels)

    @property
    def dram_bytes_by_channel(self) -> tuple[int, ...]:
        """Full-workload DRAM traffic bytes per channel."""
        if not self.dram_channels:
            return (self.dram_bytes,)
        return tuple(int(round(self.scale * c.bytes))
                     for c in self.dram_channels)

    def level(self, name: str) -> LevelStats:
        for st in self.levels:
            if st.name == name:
                return st
        raise KeyError(name)


class _DramSim:
    def __init__(self, model, channels=None):
        self.model = model
        self.stats = DramStats()
        # per-channel integer counters only on genuinely multi-channel
        # hierarchies: the N=1 path must not even allocate differently,
        # so the single-channel behaviour stays bit-identical (§18).
        self.channels = (channels if channels is not None
                         and channels.n_channels > 1 else None)
        self.ch = ([DramStats() for _ in range(channels.n_channels)]
                   if self.channels else None)

    def read(self, addr: int, nbytes: int) -> None:
        self.stats.bursts += 1
        self.stats.read_bytes += nbytes
        if self.ch is not None:
            c = self.ch[self.channels.channel_of(addr)]
            c.bursts += 1
            c.read_bytes += nbytes

    def write(self, addr: int, nbytes: int) -> None:
        self.stats.bursts += 1
        self.stats.write_bytes += nbytes
        if self.ch is not None:
            c = self.ch[self.channels.channel_of(addr)]
            c.bursts += 1
            c.write_bytes += nbytes

    def finish(self) -> None:
        # busy time derived from the integer burst/byte counters at the
        # end (not accumulated per burst) so the fast engine's counter
        # extrapolation reproduces it bit-exactly (DESIGN.md §12).
        self.stats.busy_s = (self.stats.bursts * self.model.overhead_s
                             + self.stats.bytes / self.model.peak_bw)
        if self.ch is not None:
            peak = self.channels.peak_bw or self.model.peak_bw
            for c in self.ch:
                # the same expression as the aggregate, per channel
                c.busy_s = (c.bursts * self.model.overhead_s
                            + c.bytes / peak)


class _LevelSim:
    # Line state is a mutable [dirty, mru] pair: `dirty` drives
    # writebacks; `mru` is only meaningful under the "plru" policy.

    def __init__(self, level: CacheLevel, below):
        self.level = level
        self.below = below
        self.policy = level.policy
        # one replacement domain per set (n_sets == 1 → fully associative).
        self.sets: list[OrderedDict[int, list]] = [
            OrderedDict() for _ in range(level.n_sets)]
        self.ways = level.ways
        self.stats = LevelStats(name=level.name)

    def _set(self, la: int) -> OrderedDict:
        """Set-indexed placement: the block index hashes over the sets."""
        return self.sets[(la // self.level.block_bytes) % len(self.sets)]

    def _chunks(self, addr: int, nbytes: int):
        """Split an access into (chunk_addr, chunk_bytes, line_addr)."""
        B = self.level.block_bytes
        end = addr + nbytes
        a = addr
        while a < end:
            la = (a // B) * B
            csize = min(la + B, end) - a
            yield a, csize, la
            a += csize

    def _mark_mru(self, lines: OrderedDict, la: int) -> None:
        """Bit-PLRU: set the line's MRU bit; if that saturates the set,
        clear every other bit (the accessed line stays protected)."""
        lines[la][1] = True
        if all(st[1] for st in lines.values()):
            for other, st in lines.items():
                if other != la:
                    st[1] = False

    def _touch_hit(self, lines: OrderedDict, la: int, dirty: bool) -> None:
        if dirty:
            lines[la][0] = True
        if self.policy == "lru":
            lines.move_to_end(la)
        elif self.policy == "plru":
            self._mark_mru(lines, la)
        # fifo: hits never refresh the insertion order.

    def _victim(self, lines: OrderedDict) -> int:
        if self.policy == "plru":
            for la, st in lines.items():
                if not st[1]:
                    return la
        return next(iter(lines))      # lru: least-recent; fifo: oldest

    def _insert(self, la: int, dirty: bool) -> None:
        lines = self._set(la)
        lines[la] = [dirty, False]
        if self.policy == "plru":
            self._mark_mru(lines, la)
        if len(lines) > self.ways:
            victim = self._victim(lines)
            was_dirty = lines.pop(victim)[0]
            if was_dirty:
                self.stats.writeback_bytes += self.level.block_bytes
                self.below.write(victim, self.level.block_bytes)

    def read(self, addr: int, nbytes: int) -> None:
        self.stats.read_bytes += nbytes
        B = self.level.block_bytes
        for _, _, la in self._chunks(addr, nbytes):
            lines = self._set(la)
            if la in lines:
                self.stats.hits += 1
                self._touch_hit(lines, la, dirty=False)
            else:
                self.stats.misses += 1
                self.below.read(la, B)
                self.stats.fill_bytes += B
                self._insert(la, False)

    def write(self, addr: int, nbytes: int) -> None:
        self.stats.write_bytes += nbytes
        B = self.level.block_bytes
        sub = self.level.sub_bytes
        for a, csize, la in self._chunks(addr, nbytes):
            lines = self._set(la)
            if la in lines:
                self.stats.hits += 1
                self._touch_hit(lines, la, dirty=True)
                continue
            self.stats.misses += 1
            covers_subs = (a % sub == 0) and (csize % sub == 0)
            if covers_subs and self.level.full_block_write_skips_fetch:
                # §3.1.1 / §3.1.3: whole (sub-)blocks written → no fill.
                self.stats.write_skips += 1
                self._insert(la, True)
            elif self.level.write_allocate:
                self.below.read(la, B)            # fetch-on-write-miss
                self.stats.fill_bytes += B
                self._insert(la, True)
            else:
                self.below.write(a, csize)        # write-through, no allocate

    def finish(self) -> None:
        self.stats.busy_s = (
            self.stats.accesses * self.level.hit_latency_s
            + self.stats.port_bytes / self.level.bandwidth)


# -- engine plumbing shared with the fast engine (repro_torch.memhier.fastsim) ------

def _build_sims(hier: Hierarchy):
    """Wire up the level sims over DRAM; returns (sims, dram, top)."""
    dram = _DramSim(hier.dram, getattr(hier, "channels", None))
    below = dram
    sims: list[_LevelSim] = []
    for level in reversed(hier.levels):
        below = _LevelSim(level, below)
        sims.append(below)
    sims.reverse()                                # core-side first
    top = sims[0] if sims else dram
    return sims, dram, top


def _run_accesses(top, accesses: Iterable[Access]) -> int:
    """Feed accesses to the top of the hierarchy; returns demand bytes."""
    demand = 0
    for acc in accesses:
        demand += acc.nbytes
        if acc.kind == "r":
            top.read(acc.addr, acc.nbytes)
        elif acc.kind == "w":
            top.write(acc.addr, acc.nbytes)
        else:
            raise ValueError(f"unknown access kind {acc.kind!r}")
    return demand


def _flush(sims: Sequence[_LevelSim]) -> None:
    """Drain dirty lines to DRAM and close per-level busy accounting, so
    a write stream's traffic is not hidden by the finite trace."""
    for sim in sims:
        for lines in sim.sets:
            for la, st in lines.items():
                if st[0]:
                    sim.stats.writeback_bytes += sim.level.block_bytes
                    sim.below.write(la, sim.level.block_bytes)
            lines.clear()
        sim.finish()


def _prediction(sims, dram, demand: int, n_buffers: int) -> Prediction:
    """Assemble the Prediction from finished sims (shared result path)."""
    dram.finish()
    busy = {st.stats.name: st.stats.busy_s for st in sims}
    # per-channel hierarchies (§18): channels drain in parallel, so the
    # DRAM pipeline stage is busy for as long as its *busiest channel*
    # (the single-channel branch keeps the exact legacy float).
    busy["dram"] = (max(c.busy_s for c in dram.ch) if dram.ch is not None
                    else dram.stats.busy_s)
    bottleneck = max(busy, key=busy.get) if busy else "dram"
    if not busy:
        time_s = 0.0
    elif n_buffers >= 2:
        # §3.1.3/§3.1.4 + pipelined tile loads: double-buffered
        # streams overlap all levels, the slowest stage sets throughput.
        time_s = max(busy.values())
    elif n_buffers > 1:
        # fractional overlap depth: between the serial (k=1) and fully
        # pipelined (k=2) extremes a stream spends part of each step in
        # fill/drain transients where stages cannot hide behind each
        # other. Linear interpolation in the depth keeps both extremes
        # bit-exact (k→1 is the serial sum, k→2 the pipelined max) and
        # is monotone non-increasing in k since sum >= max.
        k = float(n_buffers)
        time_s = (2.0 - k) * sum(busy.values()) + (k - 1.0) * max(busy.values())
    else:
        # single-buffered: each fill serialises with compute, stages add.
        time_s = sum(busy.values())
    return Prediction(
        time_s=time_s,
        demand_bytes=demand,
        levels=tuple(st.stats for st in sims),
        dram=dram.stats,
        bottleneck=bottleneck,
        n_buffers=n_buffers,
        dram_channels=tuple(dram.ch) if dram.ch is not None else (),
    )


def simulate(hier: Hierarchy, trace: Iterable[Access],
             n_buffers: float = 2) -> Prediction:
    """Run a trace through the hierarchy; returns the full breakdown.

    This is the reference engine: every access walks every level.
    ``n_buffers`` is the tile loads' double-buffering depth (see module
    docstring); the default 2 keeps the historical fully-overlapped
    timing term, fractional depths in (1, 2) interpolate the fill/drain
    transients between serial and fully pipelined.
    :func:`repro_torch.memhier.fastsim.simulate_fast` is the drop-in
    phase-structured engine the scoring hot paths use.
    """
    if n_buffers < 1:
        raise ValueError(f"n_buffers must be >= 1, got {n_buffers}")
    sims, dram, top = _build_sims(hier)
    demand = _run_accesses(top, trace)
    _flush(sims)
    return _prediction(sims, dram, demand, n_buffers)


# -- convenience predictors ---------------------------------------------------

def _engine(engine):
    """Resolve the simulation engine: default = the phase-structured fast
    engine (exact on periodic traces, reference fallback otherwise)."""
    if engine is not None:
        return engine
    from .fastsim import simulate_fast       # deferred: fastsim imports us
    return simulate_fast


def stream_bandwidth(hier: Hierarchy, n_bytes: int,
                     block_bytes: Optional[int] = None,
                     n_read: int = 1, n_write: int = 0,
                     max_sim_bytes: int = MAX_SIM_BYTES,
                     n_buffers: int = 2, engine=None) -> Prediction:
    """Predict a pure streaming workload (the Fig. 3 memcpy shape).

    ``block_bytes`` is the per-step access size (defaults to the LLC
    block — one access per burst). Large workloads are simulated capped
    and extrapolated linearly (cold-miss streams have constant per-byte
    cost); the returned stats describe the simulated window, ``time_s``
    and ``demand_bytes`` the full workload. ``engine`` defaults to the
    fast phase-structured engine; pass :func:`simulate` to force the
    reference loop.
    """
    run = _engine(engine)
    block = block_bytes or hier.llc.block_bytes
    if n_bytes <= 0:
        return run(hier, (), n_buffers=n_buffers)
    sim_bytes = min(n_bytes, max(round_up(max_sim_bytes, block), 4 * block))
    sim_bytes = round_up(sim_bytes, block) if sim_bytes < n_bytes else sim_bytes
    trace = stream_trace(sim_bytes, block,
                         [f"in{i}" for i in range(n_read)],
                         [f"out{i}" for i in range(n_write)])
    pred = run(hier, trace, n_buffers=n_buffers)
    scale = n_bytes / sim_bytes
    if scale > 1.0:
        pred.time_s *= scale
        pred.demand_bytes = int(pred.demand_bytes * scale)
        pred.scale = scale
    return pred


def predict_program(hier: Hierarchy, program, n_elems: int, dtype,
                    block_rows: Optional[int] = None,
                    block_cols: Optional[int] = None,
                    max_sim_bytes: int = MAX_SIM_BYTES,
                    n_buffers: Optional[float] = None,
                    engine=None) -> Prediction:
    """Predicted execution profile of one fused Program launch.

    The LLC block is pinned to the tile (one grid step = one burst
    per stream, §3.1.2) and the trace elides chained intermediates.
    When no geometry is given, the tile is derived from the
    hierarchy's own LLC block — so sweeping hierarchy parameters (e.g.
    ``experiments/hillclimb.py memhier``) moves the prediction; the
    Program negotiation passes explicit candidates instead. Large
    ``n_elems`` are capped and extrapolated. ``n_buffers`` defaults to
    the program's own double-buffering depth; ``engine`` to the fast
    phase-structured engine.
    """
    from repro_torch.core.stream import LANES
    run = _engine(engine)
    stages = program.stages
    bits = _bits(dtype)
    if block_rows is None:
        block_rows = max(st.block_rows for st in stages)
    if block_cols is None:
        target_elems = max(1, hier.llc.block_bytes * 8 // bits)
        block_cols = max(LANES,
                         target_elems // (block_rows * LANES) * LANES)
    if n_buffers is None:
        n_buffers = getattr(program, "n_buffers", 2)
    block_elems = block_rows * block_cols
    elem_bytes = max(1, bits // 8)
    cap_elems = max(4 * block_elems, max_sim_bytes // elem_bytes)
    n_sim = min(n_elems, cap_elems)
    h = hier.with_llc_block(block_elems * bits // 8)
    pred = run(h, trace_program(program, n_sim, dtype,
                                block_rows=block_rows,
                                block_cols=block_cols),
               n_buffers=n_buffers)
    padded = round_up(max(n_elems, 1), block_elems)
    padded_sim = round_up(max(n_sim, 1), block_elems)
    scale = padded / padded_sim
    if scale > 1.0:
        pred.time_s *= scale
        pred.demand_bytes = int(pred.demand_bytes * scale)
        pred.scale = scale
    return pred


def contended_makespan(predictions: Sequence[Prediction]) -> float:
    """Bandwidth-sharing contention query: predicted makespan of
    concurrently issued workloads that share ONE DRAM/HBM interface.

    Each prediction's non-DRAM work (cache-port traffic, compute overlap)
    proceeds on its own lane, but every DRAM burst crosses the single
    burst interface, so the DRAM busy times *serialise* while everything
    else overlaps:

        makespan = max( max_i time_i,  Σ_i dram_busy_i )

    Properties (the JAX package's ``bench_sched`` contention gates):
      * never below the slowest individual workload (overlap cannot make
        one stream faster);
      * never above the serial sum (``dram_busy_i ≤ time_i`` under the
        pipelined timing term, and a serial schedule trivially achieves
        the sum) — so "overlap is free" is replaced by a makespan that
        inflates exactly when the summed HBM demand saturates the
        interface.

    This closes the ROADMAP item that :meth:`repro_torch.graph.plan.Plan.
    predicted_time`'s critical-path makespan priced overlapping parts as
    if HBM ports were infinite; :mod:`repro_torch.sched.cost` applies it to
    every concurrently scheduled lane set.
    """
    preds = list(predictions)
    if not preds:
        return 0.0
    solo = max(p.time_s for p in preds)
    shared_dram = sum(p.dram_busy_s for p in preds)
    return max(solo, shared_dram)


# -- per-channel fluid bandwidth sharing (DESIGN.md §18) ----------------------

@dataclasses.dataclass(frozen=True)
class FluidItem:
    """One concurrently running workload in the fluid contention model.

    ``time_s`` is the item's solo pipelined time (its non-DRAM critical
    path — cache ports, compute — which runs on the item's own lane);
    ``demands`` its DRAM busy seconds per channel. Build one per
    scheduled batch from an estimate/prediction, placing the DRAM demand
    on the channel(s) the item's lane is pinned to."""

    time_s: float
    demands: tuple[float, ...]

    @classmethod
    def pinned(cls, time_s: float, dram_busy_s: float, channel: int,
               n_channels: int) -> "FluidItem":
        """An item whose whole DRAM demand lands on one channel — the
        scheduler's lane→channel pinning (§18)."""
        d = [0.0] * n_channels
        d[channel] = dram_busy_s
        return cls(time_s=time_s, demands=tuple(d))

    @classmethod
    def from_prediction(cls, pred: Prediction,
                        n_channels: Optional[int] = None) -> "FluidItem":
        """An item carrying the prediction's own per-channel split."""
        d = pred.dram_busy_by_channel
        if n_channels is not None and len(d) < n_channels:
            d = d + (0.0,) * (n_channels - len(d))
        return cls(time_s=pred.time_s, demands=d)


def fluid_makespan(items: Sequence[FluidItem]) -> float:
    """Makespan of concurrent items under per-channel fluid sharing.

    Each channel is work-conserving and processor-shared: while k items
    still have demand on a channel they drain at rate 1/k each, and when
    one finishes its share is released and the survivors speed up.
    Because a work-conserving channel is never idle while demand
    remains, its last demand completes exactly at the channel's summed
    demand — so the round's makespan has the closed form

        max( max_i time_i,  max_c Σ_i demands[i][c] )

    which at one channel is *bit-identical* to
    :func:`contended_makespan` (same max/sum over the same floats — the
    N=1 identity gate), and shares its bounds: never below the slowest
    item, never above the serial sum. What fluid sharing changes is the
    *per-item* finish times (:func:`fluid_finish_times`), not the
    round's end.
    """
    its = list(items)
    if not its:
        return 0.0
    solo = max(it.time_s for it in its)
    n_ch = max(len(it.demands) for it in its)
    busiest = max(
        (sum(it.demands[c] for it in its if c < len(it.demands))
         for c in range(n_ch)), default=0.0)
    return max(solo, busiest)


def fluid_finish_times(items: Sequence[FluidItem]) -> list[float]:
    """Per-item finish times under per-channel fluid sharing (§18).

    Piecewise-constant-rate event loop: between events every channel
    serves its k active items at rate 1/k; the next event is the first
    demand to drain, at which point that item's share is released and
    the survivors' rates step up. An item finishes when both its solo
    pipeline (``time_s``) and its last channel demand are done; finishes
    are clamped to :func:`fluid_makespan` so the round's end matches the
    closed form exactly.

    Versus the rigid :func:`contended_makespan` — where every item in
    the round is charged the whole makespan — this *strictly tightens*
    short-item finishes in mixed rounds (a small request coalesced next
    to a giant one completes early, and its bandwidth share is released
    to the giant), which is what the scheduler's virtual timeline and
    deadline accounting consume (the JAX package's ``bench_channels`` gates the
    tightening and the [max, serial-sum] envelope).
    """
    its = list(items)
    if not its:
        return []
    n_ch = max(len(it.demands) for it in its)
    rem = [[it.demands[c] if c < len(it.demands) else 0.0
            for c in range(n_ch)] for it in its]
    pending = [sum(1 for d in r if d > 0.0) for r in rem]
    dram_done = [0.0] * len(its)
    t = 0.0
    while True:
        counts = [0] * n_ch
        for r in rem:
            for c in range(n_ch):
                if r[c] > 0.0:
                    counts[c] += 1
        # next event: the first demand to drain at current rates — a
        # demand d on a channel shared k ways drains in d * k seconds.
        dt = min((r[c] * counts[c] for r in rem for c in range(n_ch)
                  if r[c] > 0.0), default=None)
        if dt is None:
            break
        t += dt
        for i, r in enumerate(rem):
            for c in range(n_ch):
                if r[c] <= 0.0:
                    continue
                # min achievers hit exactly zero (no fp residue), so
                # every event retires at least one demand and the loop
                # terminates in ≤ items × channels steps.
                if r[c] * counts[c] <= dt:
                    r[c] = 0.0
                    pending[i] -= 1
                    if pending[i] == 0:
                        dram_done[i] = t
                else:
                    r[c] -= dt / counts[c]
    end = fluid_makespan(its)
    return [min(max(it.time_s, dram_done[i]), end)
            for i, it in enumerate(its)]


def best_geometry(hier: Hierarchy, program, n_elems: int, dtype):
    """Search the block-candidate space for the modeled-time optimum.

    Reuses the Program's own candidate set and shared-memory budget filter (so
    hierarchy- and burst-law-negotiated geometries are comparable), but
    scores every candidate with the full hierarchy simulation. Returns
    ``(block_rows, block_cols, Prediction)``.
    """
    prog = copy.copy(program)
    prog.model = hier
    br, bc, _ = prog.negotiate_geometry(n_elems, dtype)
    return br, bc, predict_program(hier, program, n_elems, dtype,
                                   block_rows=br, block_cols=bc)


def sweep_llc_blocks(hier: Hierarchy, n_bytes: int,
                     blocks: Sequence[int]) -> list[tuple[int, Prediction]]:
    """Fig. 3 reproduction: predicted stream bandwidth per LLC block size."""
    return [(b, stream_bandwidth(hier.with_llc_block(b), n_bytes))
            for b in blocks]

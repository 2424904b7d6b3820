"""Phase-structured fast engine: exact extrapolation of periodic traces.

The traces :mod:`repro_torch.memhier.trace` generates are *regular*: a
streaming launch repeats the same per-grid-step phase — one access per
stream, every stream advancing by one block — thousands of times. The
reference engine (:func:`repro_torch.memhier.predict.simulate`) pays a pure-
Python cache walk for every one of those steps; this module pays it only
until the hierarchy reaches steady state, then jumps.

The algorithm (DESIGN.md §12):

  1. **Detect the phase.** Scan the access list for a periodic run:
     a period of ``P`` accesses whose (stream, kind, nbytes) signature
     repeats with a uniform address stride ``S`` per period. Runs are
     detected per *phase*, so multi-phase traces (e.g.
     :func:`~repro_torch.memhier.trace.trace_program_unfused`, one phase per
     unfused stage) fast-path each phase in turn.
  2. **Super-period.** Group ``k`` periods so the per-super-period
     stride ``k·S`` is a multiple of every level's block size — then a
     super-period's effect on the hierarchy is *translation-equivariant*
     (set indices rotate consistently, sub-block alignment is
     preserved).
  3. **Steady state.** Simulate super-periods with the reference engine
     until the cache state (line addresses, dirty bits, replacement
     order, PLRU bits) is exactly the previous state translated by
     ``k·S``. From that point, by equivariance, every remaining
     super-period adds the *identical* stats delta.
  4. **Jump.** Add ``remaining × delta`` to the integer counters,
     translate the cache state by ``remaining × k·S``, and resume the
     reference engine for the trace tail (truncated final block) and the
     dirty-line flush.

Because the jump reproduces the exact reference state and the exact
integer counters (busy times are derived from the counters at the end,
in :func:`~repro_torch.memhier.predict._prediction`), the result is
**bit-identical** to the reference engine on every periodic trace —
``tests/test_hotpath.py`` (the JAX package) and ``tests/test_torch_memhier.py`` gate this
on every trace generator. Irregular traces simply never reach step 3 and
fall through to the reference loop, access by access.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Iterable, Sequence

from .hierarchy import Hierarchy
from .predict import (Access, Prediction, _build_sims, _flush, _prediction,
                      _run_accesses)

# How far ahead to look for the first access's stream recurring (bounds
# the period length the detector can find; stream_trace periods are one
# access per stream, so this comfortably covers every generated trace).
MAX_PERIOD = 64

# Minimum full super-periods for the fast path to engage: one to warm,
# two to compare, at least one left to extrapolate over.
MIN_SUPER_PERIODS = 3

_LEVEL_FIELDS = ("hits", "misses", "write_skips", "read_bytes",
                 "write_bytes", "fill_bytes", "writeback_bytes")
_DRAM_FIELDS = ("bursts", "read_bytes", "write_bytes")


@dataclasses.dataclass(frozen=True)
class _Run:
    """One detected periodic run: ``[start, end)`` repeats every
    ``period`` accesses, position ``j`` advancing by ``strides[j]``
    bytes per period. ``stride`` is position 0's stride (the uniform
    stride when all positions agree)."""

    period: int
    stride: int
    end: int
    strides: tuple[int, ...] = ()

    @property
    def uniform(self) -> bool:
        return len(set(self.strides)) <= 1


def _find_periodic_run(accesses: Sequence[Access], start: int):
    """Longest periodic run beginning at ``start``, or None.

    The candidate period is the distance to the first recurrence of the
    starting access's (stream, kind, nbytes) signature; the run extends
    while every access matches its predecessor one period back with a
    *per-position* address stride — so non-commensurate streams (e.g.
    64 B and 96 B strides in one phase) form one multi-stride run
    instead of breaking the period (DESIGN.md §12).
    """
    n = len(accesses)
    a0 = accesses[start]
    period = None
    for j in range(start + 1, min(start + 1 + MAX_PERIOD, n)):
        b = accesses[j]
        if (b.stream == a0.stream and b.kind == a0.kind
                and b.nbytes == a0.nbytes):
            period = j - start
            break
    if period is None or start + 2 * period > n:
        return None
    strides = tuple(accesses[start + period + j].addr
                    - accesses[start + j].addr for j in range(period))
    j = start
    while j + period < n:
        a, b = accesses[j], accesses[j + period]
        if (b.stream != a.stream or b.kind != a.kind
                or b.nbytes != a.nbytes
                or b.addr - a.addr != strides[(j - start) % period]):
            break
        j += 1
    end = j + period                     # [start, end) is period-periodic
    if end - start < 2 * period:
        return None
    return _Run(period=period, stride=strides[0], end=end, strides=strides)


def _channel_lcm_term(hier: Hierarchy, stride: int) -> int:
    """Extra super-period factor keeping the DRAM channel map invariant
    under the shift: interleaved channels (§18) repeat every
    ``interleave_bytes × n_channels`` bytes, so ``k·stride`` must be a
    multiple of that for per-channel counter deltas to repeat. Pinned
    (region-granular) mapping is translation-invariant at stream scale —
    no constraint."""
    ch = getattr(hier, "channels", None)
    if ch is None or ch.n_channels == 1 or ch.mapping != "interleave":
        return 1
    m = ch.interleave_bytes * ch.n_channels
    return m // math.gcd(stride, m)


def _super_period(hier: Hierarchy, strides) -> int:
    """Periods per super-period for a run with the given per-position
    strides.

    Uniform runs keep the historical constraint — the smallest k with
    k·stride a multiple of every level's block size (set indices may
    *rotate*, :func:`_shift_state` handles that consistently). Multi-
    stride runs need the stronger *set-preserving* constraint per
    distinct stride — k·s a multiple of every level's ``block_bytes ×
    n_sets`` — because lines of different strides shift by different
    amounts and only a rotation-free shift keeps every line in its own
    set. Both cases fold in :func:`_channel_lcm_term`.
    """
    distinct = {s for s in strides if s}
    uniform = len(set(strides)) <= 1
    k = 1
    for s in distinct:
        for lv in hier.levels:
            span = lv.block_bytes if uniform else lv.block_bytes * lv.n_sets
            k = math.lcm(k, span // math.gcd(s, span))
        k = math.lcm(k, _channel_lcm_term(hier, s))
    return k


def _snapshot(sims, dram):
    """Deep, comparable copy of (cache state, integer stat counters)."""
    state = [
        [[(la, st[0], st[1]) for la, st in lines.items()]
         for lines in sim.sets]
        for sim in sims
    ]
    stats = (
        [tuple(getattr(sim.stats, f) for f in _LEVEL_FIELDS)
         for sim in sims],
        tuple(getattr(dram.stats, f) for f in _DRAM_FIELDS),
        tuple(tuple(getattr(c, f) for f in _DRAM_FIELDS)
              for c in dram.ch) if dram.ch is not None else (),
    )
    return state, stats


def _is_shifted(prev_state, cur_state, sims, stride: int) -> bool:
    """True iff cur_state is exactly prev_state translated by ``stride``
    (line addresses shifted, sets rotated, order and bits preserved)."""
    for sim, prev_lv, cur_lv in zip(sims, prev_state, cur_state):
        B = sim.level.block_bytes
        n_sets = len(sim.sets)
        rot = (stride // B) % n_sets
        for si in range(n_sets):
            pset = prev_lv[si]
            cset = cur_lv[(si + rot) % n_sets]
            if len(pset) != len(cset):
                return False
            for (la, d, m), (cla, cd, cm) in zip(pset, cset):
                if cla != la + stride or cd != d or cm != m:
                    return False
    return True


def _apply_stats_delta(sims, dram, prev_stats, cur_stats, times: int) -> None:
    """Add ``times`` × (cur - prev) to every integer stat counter
    (per-level, aggregate DRAM, and per-channel DRAM when present)."""
    for sim, p, c in zip(sims, prev_stats[0], cur_stats[0]):
        for f, pv, cv in zip(_LEVEL_FIELDS, p, c):
            setattr(sim.stats, f, getattr(sim.stats, f) + times * (cv - pv))
    for f, pv, cv in zip(_DRAM_FIELDS, prev_stats[1], cur_stats[1]):
        setattr(dram.stats, f, getattr(dram.stats, f) + times * (cv - pv))
    if dram.ch is not None:
        for ch, p, c in zip(dram.ch, prev_stats[2], cur_stats[2]):
            for f, pv, cv in zip(_DRAM_FIELDS, p, c):
                setattr(ch, f, getattr(ch, f) + times * (cv - pv))


def _shift_state(sims, delta: int) -> None:
    """Translate every resident line by ``delta`` bytes in place.

    ``delta`` is a multiple of each level's block size, so all lines of
    one set land in one rotated set — per-set replacement order (and the
    PLRU/dirty bits travelling in the line state) is preserved, which is
    exactly the state the reference engine would have reached.
    """
    if delta == 0:
        return
    for sim in sims:
        n_sets = len(sim.sets)
        B = sim.level.block_bytes
        new_sets: list[OrderedDict] = [OrderedDict() for _ in range(n_sets)]
        for lines in sim.sets:
            for la, st in lines.items():
                nla = la + delta
                new_sets[(nla // B) % n_sets][nla] = st
        sim.sets = new_sets


def _stride_groups(accesses, start: int, end: int, run: _Run, max_b: int):
    """Disjoint per-stride address intervals for a multi-stride run.

    Returns ``[(lo, hi, stride), ...]`` such that every access at a
    position with stride ``s`` falls inside exactly that stride's
    interval, and intervals of *different* strides are separated by at
    least ``max_b`` bytes — so any cache line (≤ ``max_b`` bytes wide)
    intersects at most one interval and its per-super-period shift is
    unambiguous. ``None`` when the streams' footprints interleave (the
    reference loop handles those).
    """
    bounds: dict[int, tuple[int, int]] = {}
    for j in range(start, end):
        s = run.strides[(j - start) % run.period]
        a = accesses[j]
        lo, hi = bounds.get(s, (a.addr, a.addr + a.nbytes))
        bounds[s] = (min(lo, a.addr), max(hi, a.addr + a.nbytes))
    groups = sorted((lo, hi, s) for s, (lo, hi) in bounds.items())
    for (_, h1, _), (l2, _, _) in zip(groups, groups[1:]):
        if l2 < h1 + max_b:
            return None
    return groups


def _group_delta(groups, la: int, block_bytes: int) -> int:
    """Per-period shift of the line at ``la``: its stride group's
    stride, or 0 for resident lines outside every group (untouched
    pre-run leftovers, which steady state requires to sit still)."""
    for lo, hi, s in groups:
        if la < hi and la + block_bytes > lo:
            return s
    return 0


def _is_shifted_multi(prev_state, cur_state, sims, groups, k: int) -> bool:
    """Multi-stride steady-state check: cur_state is prev_state with
    every line translated by ``k ×`` its *own* stride group's stride
    (set-preserving by the :func:`_super_period` constraint, so sets
    compare index-to-index with order and bits intact)."""
    for sim, prev_lv, cur_lv in zip(sims, prev_state, cur_state):
        B = sim.level.block_bytes
        for pset, cset in zip(prev_lv, cur_lv):
            if len(pset) != len(cset):
                return False
            for (la, d, m), (cla, cd, cm) in zip(pset, cset):
                if (cla != la + k * _group_delta(groups, la, B)
                        or cd != d or cm != m):
                    return False
    return True


def _shift_state_multi(sims, groups, periods: int) -> None:
    """Translate every resident line by ``periods ×`` its stride group's
    stride. Each delta is a multiple of ``block_bytes × n_sets`` at
    every level, so lines stay in their sets and per-set order (with the
    dirty/PLRU bits in the line state) is preserved."""
    for sim in sims:
        B = sim.level.block_bytes
        n_sets = len(sim.sets)
        new_sets: list[OrderedDict] = [OrderedDict() for _ in range(n_sets)]
        for lines in sim.sets:
            for la, st in lines.items():
                nla = la + periods * _group_delta(groups, la, B)
                new_sets[(nla // B) % n_sets][nla] = st
        sim.sets = new_sets


def _extrapolate_run(sims, dram, top, accesses, start: int, run: _Run,
                     k: int) -> tuple[int, int]:
    """Consume the full super-periods of one periodic run.

    Simulates super-periods with the reference engine until steady state
    (state = shift of previous state — uniform translation for
    single-stride runs, per-stride-group translation for multi-stride
    limit cycles), then jumps over the rest. Returns (demand bytes
    accounted, index after the consumed super-periods).
    """
    sp = k * run.period                  # accesses per super-period
    stride = k * run.stride              # bytes per super-period (uniform)
    n_super = (run.end - start) // sp
    if n_super < MIN_SUPER_PERIODS:
        demand = _run_accesses(top, accesses[start:run.end])
        return demand, run.end
    groups = None
    if not run.uniform:
        max_b = max((sim.level.block_bytes for sim in sims), default=1)
        groups = _stride_groups(accesses, start, run.end, run, max_b)
        if groups is None:
            # interleaved stride footprints: no sound line attribution —
            # the reference loop is the answer for this run.
            demand = _run_accesses(top, accesses[start:run.end])
            return demand, run.end
    demand_sp = sum(a.nbytes for a in accesses[start:start + sp])

    demand = 0
    done = 0
    prev_snap = None
    next_check = 2
    take_prev_at = next_check - 1
    while done < n_super:
        lo = start + done * sp
        demand += _run_accesses(top, accesses[lo:lo + sp])
        done += 1
        if done == n_super:
            break
        if done == take_prev_at:
            prev_snap = _snapshot(sims, dram)
        elif done == next_check:
            snap = _snapshot(sims, dram)
            steady = prev_snap is not None and (
                _is_shifted(prev_snap[0], snap[0], sims, stride)
                if run.uniform else
                _is_shifted_multi(prev_snap[0], snap[0], sims, groups, k))
            if steady:
                remaining = n_super - done
                _apply_stats_delta(sims, dram, prev_snap[1], snap[1],
                                   remaining)
                if run.uniform:
                    _shift_state(sims, remaining * stride)
                else:
                    _shift_state_multi(sims, groups, remaining * k)
                demand += remaining * demand_sp
                done = n_super
                break
            # not steady yet: back off the check cadence ~1.5× so the
            # state comparison never dominates a long warm-up.
            next_check += max(1, next_check // 2)
            take_prev_at = next_check - 1
            prev_snap = snap if take_prev_at == done else None
    return demand, start + n_super * sp


def simulate_fast(hier: Hierarchy, trace: Iterable[Access],
                  n_buffers: float = 2) -> Prediction:
    """Drop-in replacement for :func:`repro_torch.memhier.predict.simulate`
    (including fractional ``n_buffers`` overlap depths — the timing
    term is shared, so the engines cannot disagree on it).

    Bit-identical results on periodic (streaming) traces in a small
    fraction of the Python iterations; irregular traces fall back to the
    reference engine access by access. This is the default scorer behind
    :func:`~repro_torch.memhier.predict.predict_program`,
    :func:`~repro_torch.memhier.predict.stream_bandwidth` and therefore the
    Program geometry negotiation, the graph partitioner's beam search,
    ``best_geometry``, ``launch/dryrun.py`` roofline terms and the
    memhier hillclimb.
    """
    if n_buffers < 1:
        raise ValueError(f"n_buffers must be >= 1, got {n_buffers}")
    accesses = trace if isinstance(trace, (list, tuple)) else list(trace)
    sims, dram, top = _build_sims(hier)
    demand = 0
    i = 0
    n = len(accesses)
    while i < n:
        run = _find_periodic_run(accesses, i)
        if run is None:
            # no period detectable here: reference-simulate one detection
            # window and retry (keeps fully-irregular traces linear).
            hi = min(i + MAX_PERIOD + 1, n)
            demand += _run_accesses(top, accesses[i:hi])
            i = hi
            continue
        k = _super_period(hier, run.strides)
        d, i = _extrapolate_run(sims, dram, top, accesses, i, run, k)
        demand += d
    _flush(sims)
    return _prediction(sims, dram, demand, n_buffers)

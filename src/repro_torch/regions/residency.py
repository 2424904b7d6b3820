"""The region file: bounded configured-region slots per scheduler lane.

Models the paper's endgame resource — reconfigurable regions of the CPU
holding custom SIMD pipelines, shared between tenants, costing real
time to (re)configure (PAPERS.md, "FPGA-extended General Purpose
Computer Architecture").  In this reproduction the "configuration" a
region holds is a program's warm dispatch state (negotiated geometry +
built K1 launch), and the (re)load cost is the measured cold-vs-warm
dispatch delta (:mod:`repro_torch.regions.cost`).

Charging model — **compulsory loads are free**:

A lane is charged for loading region K only when the load *displaces*
state: either the lane is full and a resident must be evicted, or K was
previously evicted from this lane and must be re-configured.  A
first-ever touch on a lane with free slots costs nothing — that is
exactly today's behavior, where every warm cache starts cold once per
process regardless of scheduling.  Consequence (the bit-identity gate
of ``bench_regions``): with unbounded slots no eviction ever happens,
every charge is zero, and the scheduler's placements and virtual
timeline are bit-identical to the pre-regions runtime.

:meth:`RegionFile.charge` is a pure peek (placement ranking);
:meth:`RegionFile.place` commits the load and returns the events for
the replay trace.  Metrics (lane-labelled hit/load/eviction counters,
swap-seconds, hit-ratio gauges) flow into the process
:class:`~repro_torch.obs.metrics.MetricsRegistry`.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.regions.cost import ReconfigCostModel
from repro_torch.regions.policy import make_policy


class SlotState:
    """Residency bookkeeping for one region on one lane."""

    __slots__ = ("loaded_at", "last_used", "uses")

    def __init__(self, now: float):
        self.loaded_at = now
        self.last_used = now
        self.uses = 0


class RegionEvent(NamedTuple):
    """One region-file transition, in commit order: ``hit`` (already
    resident), ``evict`` (victim displaced), or ``load`` (key
    configured; ``cost_s`` > 0 iff the load was charged)."""

    op: str
    lane: int
    key: object
    cost_s: float


class ReuseHistory:
    """EWMA per-(region, tenant) inter-arrival gaps → next-use
    prediction, feeding the predicted-reuse policy.

    ``note`` is called by the scheduler once per admitted item, in
    arrival-time order.  ``predict_next(key)`` returns the earliest
    predicted next arrival of *any* tenant of that region, computed in
    arrival-time space: a tenant's next use is ``last_arrival +
    ewma_gap``, floored at :attr:`frontier` (the latest arrival seen) —
    an already-due prediction cannot be earlier than "now" in arrival
    time.  A region whose tenants were each seen only once has no gap
    signal and predicts ``inf`` ("never").
    """

    def __init__(self, alpha: float = 0.5):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.frontier = 0.0
        # (key, tenant) -> [last_arrival, ewma_gap or None, n_arrivals]
        self._hist: Dict[tuple, list] = {}

    def note(self, key, tenant, now: float) -> None:
        self.frontier = max(self.frontier, now)
        h = self._hist.get((key, tenant))
        if h is None:
            self._hist[(key, tenant)] = [now, None, 1]
            return
        gap = max(now - h[0], 0.0)
        h[1] = gap if h[1] is None else (1 - self.alpha) * h[1] + self.alpha * gap
        h[0] = now
        h[2] += 1

    def predict_next(self, key) -> float:
        best = math.inf
        for (k, _tenant), (last, gap, _n) in self._hist.items():
            if k == key and gap is not None:
                best = min(best, max(last + gap, self.frontier))
        return best


class RegionFile:
    """Per-lane bounded region slots with pluggable eviction.

    ``slots=None`` (or 0) means unbounded — residency is tracked for
    metrics but nothing is ever evicted or charged.
    """

    def __init__(self, n_lanes: int, slots: Optional[int] = None,
                 policy="lru",
                 cost: Optional[ReconfigCostModel] = None,
                 history: Optional[ReuseHistory] = None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if slots is not None and slots < 0:
            raise ValueError(f"slots must be >= 0, got {slots}")
        self.n_lanes = n_lanes
        self.slots = None if not slots else int(slots)
        # a policy name from the registry, or a ready policy instance —
        # replay hands in OracleResidency objects that cannot be built
        # from a name alone (they carry the trace's future schedule).
        if isinstance(policy, str):
            self.policy = make_policy(policy)
        else:
            self.policy = policy
        self.policy_name = getattr(self.policy, "name",
                                   type(self.policy).__name__)
        self.cost = cost if cost is not None else ReconfigCostModel()
        self.history = history if history is not None else ReuseHistory()
        self._resident: List[Dict[object, SlotState]] = [
            {} for _ in range(n_lanes)]
        self._evicted: List[set] = [set() for _ in range(n_lanes)]
        self.hits = [0] * n_lanes
        self.loads = [0] * n_lanes
        self.evictions = [0] * n_lanes
        self.swap_seconds = 0.0
        reg = _metrics.REGISTRY
        self._m_hits = [reg.counter(
            "repro_regions_hits_total",
            help="region-file residency hits",
            labels={"lane": str(i)}) for i in range(n_lanes)]
        self._m_loads = [reg.counter(
            "repro_regions_loads_total",
            help="region configurations (loads)",
            labels={"lane": str(i)}) for i in range(n_lanes)]
        self._m_evict = [reg.counter(
            "repro_regions_evictions_total",
            help="region evictions",
            labels={"lane": str(i)}) for i in range(n_lanes)]
        self._m_swap_s = reg.counter(
            "repro_regions_swap_seconds_total",
            help="seconds charged to region reconfiguration")
        self._m_ratio = [reg.gauge(
            "repro_regions_hit_ratio",
            help="residency hits / touches per lane",
            labels={"lane": str(i)}) for i in range(n_lanes)]

    # -- queries -------------------------------------------------------------
    @property
    def slots_cfg(self) -> int:
        """The configured bound as recorded in traces (0 = unbounded)."""
        return 0 if self.slots is None else self.slots

    @property
    def bounded(self) -> bool:
        return self.slots is not None

    def resident(self, lane: int, key) -> bool:
        return key in self._resident[lane]

    def resident_keys(self, lane: int):
        return list(self._resident[lane])

    def charge(self, lane: int, key) -> float:
        """Seconds loading ``key`` onto ``lane`` would cost *right now*
        — a pure peek used to rank candidate lanes.  Zero when resident,
        unbounded, or a compulsory (free-slot, never-evicted) load."""
        if key in self._resident[lane]:
            return 0.0
        if self.slots is None:
            return 0.0
        if (len(self._resident[lane]) < self.slots
                and key not in self._evicted[lane]):
            return 0.0
        return self.cost.cost(key)

    # -- mutation ------------------------------------------------------------
    def note_arrival(self, key, tenant, now: float) -> None:
        """Feed the reuse predictor one admission (scheduler calls this
        in arrival order as items are popped from the request queue)."""
        self.history.note(key, tenant, now)

    def place(self, lane: int, key, now: float):
        """Commit ``key`` running on ``lane`` at ``now``; returns
        ``(cost_s, [RegionEvent, ...])`` in commit order."""
        note = getattr(self.policy, "note_touch", None)
        if note is not None:
            # future-aware policies (OracleResidency) track their
            # position in the touch sequence; the cursor must advance
            # past THIS touch before choose_victim consults next uses
            note(key)
        lane_res = self._resident[lane]
        st = lane_res.get(key)
        if st is not None:
            st.last_used = now
            st.uses += 1
            self.hits[lane] += 1
            self._m_hits[lane].inc()
            self._touch_ratio(lane)
            return 0.0, [RegionEvent("hit", lane, key, 0.0)]

        events: List[RegionEvent] = []
        charged = False
        if self.slots is not None:
            if key in self._evicted[lane]:
                charged = True
            while len(lane_res) >= self.slots:
                victim = self.policy.choose_victim(
                    lane_res, self.cost, self.history, now)
                del lane_res[victim]
                self._evicted[lane].add(victim)
                self.evictions[lane] += 1
                self._m_evict[lane].inc()
                events.append(RegionEvent("evict", lane, victim, 0.0))
                charged = True
        cost_s = self.cost.cost(key) if charged else 0.0
        lane_res[key] = SlotState(now)
        lane_res[key].uses = 1
        self.loads[lane] += 1
        self._m_loads[lane].inc()
        if cost_s:
            self.swap_seconds += cost_s
            self._m_swap_s.inc(cost_s)
        events.append(RegionEvent("load", lane, key, cost_s))
        self._touch_ratio(lane)
        return cost_s, events

    def _touch_ratio(self, lane: int) -> None:
        touches = self.hits[lane] + self.loads[lane]
        if touches:
            self._m_ratio[lane].set(self.hits[lane] / touches)

    # -- reporting -----------------------------------------------------------
    def hit_ratio(self, lane: int) -> float:
        touches = self.hits[lane] + self.loads[lane]
        return self.hits[lane] / touches if touches else 0.0

    def report(self) -> dict:
        return {
            "slots": self.slots_cfg,
            "policy": self.policy_name,
            "swap_seconds": self.swap_seconds,
            "lanes": [
                {
                    "lane": i,
                    "resident": len(self._resident[i]),
                    "hits": self.hits[i],
                    "loads": self.loads[i],
                    "evictions": self.evictions[i],
                    "hit_ratio": self.hit_ratio(i),
                }
                for i in range(self.n_lanes)
            ],
        }

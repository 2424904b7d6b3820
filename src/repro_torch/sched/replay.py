"""Deterministic trace recording + offline replay of scheduling runs.

A :class:`TraceRecorder` attached to a :class:`~repro_torch.sched.scheduler.
Scheduler` logs one JSON object per line (JSONL, sorted keys — so a
trace is byte-stable and diffs cleanly):

  * ``config`` — policy name, lane count, clock (+ ``region_slots`` /
    ``region_policy`` when region residency is enabled;
    + ``n_channels`` / ``lane_channels`` on a multi-channel scheduler —
    single-channel traces stay byte-identical to pre-channel ones);
  * ``submit`` — per item: seq, arrival, deadline, tenant, weight,
    coalesce key (stringified), and the cost model's estimate at
    admission (predicted / modeled / DRAM busy seconds, DRAM bytes;
    + stringified region key and pinned reconfig cost under regions);
  * ``region`` — per residency transition: op (hit / evict / load),
    lane, stringified region key, charged swap seconds, round;
  * ``place``  — per item: lane, round, start/finish, predicted vs
    observed seconds, coalescing flag (+ the lane's HBM ``channel`` on
    a multi-channel scheduler).

:func:`replay` re-runs the *scheduler* (not the kernels) on a recorded
trace: the submit events reconstruct the arrival sequence, a
:class:`ReplayCost` pins every item's estimate to the recorded values,
and the virtual clock executes the same policy — so the produced
placements must be identical to the recorded ones (the JAX package's
``bench_sched`` determinism gate). That makes scheduling policies benchmarkable offline
from production traces, the same way :mod:`repro_torch.memhier` makes memory
geometries benchmarkable from access traces (DESIGN.md §13).

Relationship to :mod:`repro_torch.obs.trace` (DESIGN.md §15): the span
tracer shares this module's byte-stability contract (virtual clock ⇒
identical JSONL bytes) but answers a different question — spans are
the *causal* view of one request (admission → … → placement, with
durations), this recorder is the *schedulable* view a policy can be
re-run against. Replayed items are reconstructed without root spans;
activate a tracer during the replay to trace the replayed run itself.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

from repro_torch.obs import trace as _trace
from repro_torch.regions import PinnedReconfigCost

from .cost import CostModel, Estimate
from .queue import RequestQueue, WorkItem
from .scheduler import Placement, Report, Scheduler


class TraceRecorder:
    """Append-only event log with byte-stable JSONL serialisation."""

    def __init__(self):
        self.events: list[dict] = []

    def record(self, kind: str, **data) -> None:
        self.events.append({"event": kind, **data})

    # -- serialisation --------------------------------------------------------
    def dumps(self) -> str:
        return "".join(json.dumps(e, sort_keys=True) + "\n"
                       for e in self.events)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def loads(cls, text: str) -> "TraceRecorder":
        rec = cls()
        for line in text.splitlines():
            line = line.strip()
            if line:
                rec.events.append(json.loads(line))
        return rec

    @classmethod
    def load(cls, path: str) -> "TraceRecorder":
        with open(path) as f:
            return cls.loads(f.read())

    # -- views ----------------------------------------------------------------
    def of_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e.get("event") == kind]

    def placements(self) -> list[Placement]:
        return [Placement(seq=e["seq"], lane=e["lane"], round=e["round"],
                          start=e["start"], finish=e["finish"],
                          predicted_s=e["predicted_s"],
                          observed_s=e["observed_s"],
                          coalesced=e["coalesced"],
                          batch_seq=e["batch_seq"],
                          channel=e.get("channel", 0))
                for e in self.of_kind("place")]


class ReplayCost(CostModel):
    """Cost model pinned to a trace's recorded estimates (keyed by seq)."""

    def __init__(self, estimates: dict[int, Estimate]):
        super().__init__()
        self._by_seq = dict(estimates)

    def estimate_item(self, item: WorkItem) -> Estimate:
        return self._by_seq[item.seq]


class _ReplayTarget:
    """Stand-in work target; never executed under the virtual clock. The
    recorded coalesce-key string restores batch grouping."""

    def __init__(self, seq: int):
        self.seq = seq

    def __call__(self, *a, **k):      # pragma: no cover - virtual only
        raise RuntimeError("replay targets are never executed")


def replay(trace: TraceRecorder, policy: Optional[str] = None,
           n_lanes: Optional[int] = None,
           recorder: Optional[TraceRecorder] = None,
           region_slots: Optional[int] = None,
           region_policy=None,
           n_channels: Optional[int] = None) -> Report:
    """Re-run the scheduler over a recorded arrival sequence.

    With no overrides, policy, lane count, channel map, and
    region-residency config come from the trace's ``config`` event and
    the run must reproduce the recorded placements exactly (including
    each item's HBM channel on multi-channel traces); pass a different
    ``policy`` / ``n_lanes`` / ``region_slots`` / ``region_policy`` /
    ``n_channels`` to ask "what would X have done on this workload"
    offline.

    Traces recorded with regions enabled carry each item's region key
    (stringified) and its pinned reconfiguration cost in the submit
    events; the replayed scheduler rebuilds the region file from those,
    so residency decisions — and the swap charges they imply — replay
    without the original targets or any artifact cache.

    ``region_policy`` also accepts a policy *instance* — that is how
    :class:`repro_torch.regions.policy.OracleResidency` (Belady with the
    trace's perfect future knowledge) scores the online policies'
    regret.  With a tracer active, replay re-opens
    each request's root span so blame attribution
    (:mod:`repro_torch.obs.critical`) works on replayed runs too.
    """
    cfgs = trace.of_kind("config")
    cfg = cfgs[0] if cfgs else {"policy": "edf", "n_lanes": 2}
    submits = sorted(trace.of_kind("submit"), key=lambda e: e["seq"])
    if not submits:
        raise ValueError("trace has no submit events to replay")
    if region_slots is None:
        region_slots = cfg.get("region_slots")
    if region_policy is None:
        region_policy = cfg.get("region_policy", "lru")

    queue = RequestQueue()
    estimates: dict[int, Estimate] = {}
    pinned_costs: dict[tuple, float] = {}
    tr = _trace.ACTIVE
    for e in submits:
        rk = (("trace", e["region_key"])
              if e.get("region_key") is not None else None)
        item = WorkItem(seq=e["seq"], target=_ReplayTarget(e["seq"]),
                        operands=(), deadline=e.get("deadline"),
                        arrival=e["arrival"], tenant=e.get("tenant",
                                                           "default"),
                        weight=e.get("weight", 1.0),
                        key=None if e.get("key") is None
                        else ("replay", e["key"]),
                        region_key=rk)
        if tr is not None:
            # re-open each request's root span so the replayed
            # scheduler re-stamps the same blame inputs it recorded
            # live — obs/critical.py's JSONL export is then
            # byte-identical across record/replay (DESIGN.md §19).
            item.span = tr.start_span(
                "request", parent=None, seq=item.seq,
                tenant=item.tenant, arrival=float(item.arrival),
                deadline=item.deadline)
        queue.pending.append(item)
        estimates[item.seq] = Estimate(
            seconds=e["predicted_s"], modeled_s=e["modeled_s"],
            dram_busy_s=e["dram_busy_s"], dram_bytes=e["dram_bytes"],
            source="replay")
        if rk is not None:
            pinned_costs[rk] = e.get("region_cost_s", 0.0)
    # keep the queue's seq counter ahead of the replayed items
    for _ in range(max(e["seq"] for e in submits) + 1):
        next(queue._seq)

    region_cost = (PinnedReconfigCost(pinned_costs)
                   if region_slots is not None else None)
    lanes = n_lanes or cfg["n_lanes"]
    if n_channels is None:
        n_channels = cfg.get("n_channels")
    lane_channels = cfg.get("lane_channels")
    if lane_channels is not None and len(lane_channels) != lanes:
        # lane count overridden: the recorded table no longer applies,
        # fall back to the round-robin map over n_channels.
        lane_channels = None
    sched = Scheduler(queue, cost=ReplayCost(estimates),
                      policy=policy or cfg["policy"],
                      n_lanes=lanes,
                      clock="virtual", recorder=recorder,
                      region_slots=region_slots,
                      region_policy=region_policy,
                      region_cost=region_cost,
                      n_channels=n_channels,
                      lane_channels=lane_channels)
    return sched.drain()


def placements_match(a: Sequence[Placement],
                     b: Sequence[Placement]) -> bool:
    """True iff two placement sequences are identical (the determinism
    gate's comparison: same items, same lanes, same HBM channels, same
    rounds, same predicted times and virtual start/finish instants)."""
    sa = [(p.seq, p.lane, p.channel, p.round, p.start, p.finish,
           p.predicted_s) for p in a]
    sb = [(p.seq, p.lane, p.channel, p.round, p.start, p.finish,
           p.predicted_s) for p in b]
    return sa == sb

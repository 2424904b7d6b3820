"""Per-request critical-path blame attribution (DESIGN.md §19).

PRs 7–9 built the raw signals — spans (§15), region swap charges (§16),
per-channel DRAM busy time (§18) — but a trace alone doesn't answer the
operator's question: *where did this request's time actually go?*  This
module turns one finished ``request`` span tree into a typed answer.

Each served request's root span is finished by the scheduler with the
**blame inputs** it alone knows (``start``, ``solo_s``, ``batch_s``,
``swap_s``, ``channel``, ``clock`` — see
:meth:`repro_torch.sched.scheduler.Scheduler._run_round`), and
:func:`attribute` decomposes the request's total latency
``finish - arrival`` into buckets that telescope exactly::

    queue_wait          start - arrival        (admission → lane grant)
    region_swap         swap_s                 (§16 reconfiguration charge)
    coalesce            batch_s - solo_s       (riding a shared batch)
    channel_contention  finish - start - batch_s - swap_s
                                               (§18 fluid-share slowdown)
    negotiate           geometry sweeps        (wall clock only)
    pallas_build        cold jit builds        (wall clock only)
    compute             solo_s - negotiate - pallas_build

so ``sum(buckets) == finish - arrival`` to float addition error — the
conservation gate (``bench_slo`` asserts the residual ≤ 1e-9 on the
virtual clock).  On the virtual clock negotiate/pallas_build stay zero:
the tracer's :class:`~repro_torch.obs.trace.VirtualClock` timestamps are
synthetic span-count ticks, not scheduler time, so child-span durations
only carry meaning under the wall clock.

The **critical path** is the chain root → deepest-finishing child at
every level — the spans an operator should look at first.  It is
reported by name; durations always come from the blame inputs above,
never from virtual-clock span timestamps.

:func:`blame_report` aggregates per tenant with buckets ranked by total
seconds; :func:`export_jsonl` is byte-stable across identical runs *and*
across record/replay (``sched/replay.py`` re-opens root spans and the
scheduler re-stamps identical blame inputs from the recorded
estimates/charges — the ``bench_slo`` byte-equality gate).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Tuple

from repro_torch.obs.trace import Span, Tracer

#: bucket names in report/export order (also the JSONL key order after
#: json sort — keep them lexically unsurprising, not load-bearing).
BUCKETS = ("queue_wait", "region_swap", "coalesce", "channel_contention",
           "negotiate", "pallas_build", "compute")

#: wall-clock child spans carved out of the solo compute share
_CARVED = ("negotiate", "pallas_build")


@dataclasses.dataclass
class Blame:
    """One request's latency decomposition."""

    seq: int
    tenant: str
    arrival: float
    start: float
    finish: float
    lane: int
    channel: int
    clock: str
    buckets: Dict[str, float]
    critical_path: Tuple[str, ...]

    @property
    def total_s(self) -> float:
        return self.finish - self.arrival

    @property
    def residual_s(self) -> float:
        """Conservation error: total minus the bucket sum (≈ float
        addition noise; the ``bench_slo`` gate bounds it at 1e-9)."""
        return self.total_s - math.fsum(self.buckets[b] for b in BUCKETS)

    def top(self) -> str:
        """The bucket this request spent the most time in."""
        return max(BUCKETS, key=lambda b: self.buckets[b])

    def to_dict(self) -> dict:
        return {
            "seq": self.seq, "tenant": self.tenant,
            "arrival": self.arrival, "start": self.start,
            "finish": self.finish, "lane": self.lane,
            "channel": self.channel, "clock": self.clock,
            "total_s": self.total_s,
            "buckets": dict(self.buckets),
        }


# ---------------------------------------------------------------------
# span-tree reconstruction

def request_trees(tracer: Tracer) -> List[Tuple[Span, Dict[int, List[Span]]]]:
    """Finished ``request`` roots with a child index for the whole
    tracer: ``[(root, children_by_parent_id), ...]`` in span-id order.

    Only roots the scheduler finished with blame inputs participate
    (``start`` in attrs) — shed or still-queued requests are skipped.
    """
    children: Dict[int, List[Span]] = {}
    for s in tracer.spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.span_id)
    return [(s, children) for s in sorted(tracer.spans,
                                          key=lambda s: s.span_id)
            if s.parent_id is None and s.name == "request"
            and s.end is not None and "start" in s.attrs]


def critical_path(root: Span,
                  children: Dict[int, List[Span]]) -> Tuple[str, ...]:
    """Span names along the root → leaf chain, descending into the
    latest-*ending* child at each level (ties break on span id, so the
    path is deterministic under the virtual clock)."""
    path, cur = [root.name], root
    while True:
        kids = children.get(cur.span_id)
        if not kids:
            return tuple(path)
        cur = max(kids, key=lambda s: (s.end if s.end is not None
                                       else s.start, s.span_id))
        path.append(cur.name)


def _subtree_seconds(span: Span, children: Dict[int, List[Span]],
                     names: Tuple[str, ...]) -> Dict[str, float]:
    """Sum of (end - start) per matching span name under ``span``."""
    out = {n: 0.0 for n in names}
    todo = [span]
    while todo:
        s = todo.pop()
        if s.name in names and s.end is not None:
            out[s.name] += max(s.end - s.start, 0.0)
        todo.extend(children.get(s.span_id, ()))
    return out


# ---------------------------------------------------------------------
# attribution

def attribute(tracer: Tracer) -> List[Blame]:
    """Blame decomposition for every finished request in ``tracer``,
    seq order.  See the module docstring for the bucket algebra."""
    blames: List[Blame] = []
    for root, children in request_trees(tracer):
        a = root.attrs
        arrival = float(a.get("arrival", root.start))
        start = float(a["start"])
        finish = float(a.get("finish", root.end))
        solo = float(a.get("solo_s", 0.0))
        batch = float(a.get("batch_s", solo))
        swap = float(a.get("swap_s", 0.0))
        clock = str(a.get("clock", "wall"))
        neg = build = 0.0
        if clock == "wall":
            carved = _subtree_seconds(root, children, _CARVED)
            neg, build = carved["negotiate"], carved["pallas_build"]
            if neg + build > solo:
                # a cold negotiate can dwarf a tiny solo share on a
                # coalesced batch; scale down so compute stays ≥ 0 and
                # the telescoping sum survives intact (build takes the
                # rest of solo: the scaled pair can round past solo,
                # which left compute at -1e-20)
                scale = solo / (neg + build) if (neg + build) > 0 else 0.0
                neg = min(neg * scale, solo)
                build = solo - neg
        blames.append(Blame(
            seq=int(a.get("seq", root.span_id)),
            tenant=str(a.get("tenant", "default")),
            arrival=arrival, start=start, finish=finish,
            lane=int(a.get("lane", 0)), channel=int(a.get("channel", 0)),
            clock=clock,
            buckets={
                "queue_wait": start - arrival,
                "region_swap": swap,
                "coalesce": batch - solo,
                "channel_contention": (finish - start) - batch - swap,
                "negotiate": neg,
                "pallas_build": build,
                "compute": solo - neg - build,
            },
            critical_path=critical_path(root, children),
        ))
    blames.sort(key=lambda b: b.seq)
    return blames


def max_residual(blames: List[Blame]) -> float:
    """Largest absolute conservation error — the acceptance gate."""
    return max((abs(b.residual_s) for b in blames), default=0.0)


# ---------------------------------------------------------------------
# aggregation + export

def blame_report(blames: List[Blame]) -> Dict[str, List[Tuple[str, float]]]:
    """Per-tenant bucket totals, ranked worst-first:
    ``{tenant: [(bucket, seconds), ...]}``.  Ties break on bucket name
    so the ranking is deterministic."""
    per: Dict[str, Dict[str, float]] = {}
    for b in blames:
        acc = per.setdefault(b.tenant, {k: 0.0 for k in BUCKETS})
        for k in BUCKETS:
            acc[k] += b.buckets[k]
    return {tenant: sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))
            for tenant, acc in sorted(per.items())}


def format_report(blames: List[Blame], top: int = 3) -> str:
    """Human-readable ranking for ``serve.py`` report lines."""
    lines = []
    for tenant, ranked in blame_report(blames).items():
        parts = ", ".join(f"{k}={v * 1e3:.3f}ms"
                          for k, v in ranked[:top] if v > 0.0)
        lines.append(f"blame[{tenant}]: {parts or 'all-zero'}")
    return "\n".join(lines)


def export_jsonl(blames: List[Blame]) -> str:
    """One sorted-key JSON object per request, seq order.  Contains
    only scheduler-time quantities (never tracer-clock timestamps or
    span ids), so record and replay of the same workload produce
    byte-identical output — the ``bench_slo`` stability gate."""
    return "".join(
        json.dumps(b.to_dict(), sort_keys=True, separators=(",", ":"))
        + "\n"
        for b in blames)

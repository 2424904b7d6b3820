"""Pluggable residency (eviction) policies for the region file.

A policy answers one question: *which resident region should leave a
full lane to admit a new one?*  It sees the lane's slot states (per-key
:class:`~repro_torch.regions.residency.SlotState`), the reconfiguration cost
model, and the shared per-tenant arrival history, and returns the
victim key.  Policies are pure choosers — the :class:`RegionFile` owns
all mutation, event emission, and metrics.

Two policies ship (DESIGN.md §16 policy table):

``lru``
    Evict the least-recently-used resident.  The classic baseline; blind
    to both reload cost and arrival patterns, so a periodic hot tenant
    interleaved with a scan of one-shot programs thrashes.

``reuse``
    Predicted-reuse (cost-aware Belady approximation).  Each resident's
    *keep value* is ``load_cost / time_until_predicted_next_use``: cheap
    regions and far-future (or never-predicted) reuses are cheap to
    evict; expensive regions about to be re-requested are kept.  The
    next-use prediction comes from the EWMA per-(region, tenant)
    inter-arrival history the scheduler feeds on every admission —
    the same signal family as the cost model's EWMA corrections.
    Regions with *no* arrival history (seen once, never again) predict
    "never" and are evicted first, making the policy scan-resistant.

A third, replay-only policy scores the other two (DESIGN.md §19):

``oracle`` (:class:`OracleResidency`)
    Belady's MIN with *actual* future knowledge: constructed from a
    recorded trace's touch sequence, it evicts the resident whose next
    use lies farthest in the future (never-again first).  It cannot run
    online — it reads the future — so it is instantiated explicitly and
    handed to :func:`repro_torch.sched.replay.replay` as a policy instance;
    ``bench_regions`` reports each online policy's **regret**
    (makespan over the oracle's) from it.

Determinism: every comparison tie-breaks on ``(last_used, loaded_at,
repr(key))``, so victim choice — and therefore the whole event trace —
is reproducible for a given workload.
"""
from __future__ import annotations

import bisect
import math


class LruResidency:
    """Evict the least-recently-used resident region."""

    name = "lru"

    def choose_victim(self, slots, cost, history, now):
        return min(
            slots,
            key=lambda k: (slots[k].last_used, slots[k].loaded_at, repr(k)),
        )


class PredictedReuseResidency:
    """Evict the region with the least cost-weighted predicted reuse.

    keep_value(k) = load_cost(k) / max(predicted_next_use(k) − frontier,
    eps), where *frontier* is the latest arrival the history has seen —
    predictions live in arrival-time space, not the (possibly far
    ahead) virtual service clock.  predicted "never" ⇒ keep_value 0.
    """

    name = "reuse"

    EPS = 1e-9

    def choose_victim(self, slots, cost, history, now):
        frontier = history.frontier if history is not None else now

        def keep_value(k):
            nxt = (history.predict_next(k) if history is not None
                   else float("inf"))
            if nxt == float("inf"):
                return 0.0
            return cost.cost(k) / max(nxt - frontier, self.EPS)

        return min(
            slots,
            key=lambda k: (keep_value(k), slots[k].last_used,
                           slots[k].loaded_at, repr(k)),
        )


class OracleResidency:
    """Belady's MIN over a known future touch sequence (replay-only).

    ``schedule`` is the full ordered list of region keys the workload
    will touch — for a recorded trace, the submit events' region keys
    in ``(arrival, seq)`` order.  The policy tracks its position in
    that sequence via the :meth:`note_touch` hook the
    :class:`~repro_torch.regions.residency.RegionFile` calls on every
    placement, and evicts the resident whose next touch is farthest
    ahead (never touched again ⇒ evicted first) — the provable
    minimum-misses choice for uniform reload costs, and the regret
    baseline online policies are scored against.
    """

    name = "oracle"

    def __init__(self, schedule):
        self._index: dict = {}
        for i, k in enumerate(schedule):
            self._index.setdefault(k, []).append(i)
        self._pos = 0  # touches consumed so far

    def note_touch(self, key) -> None:
        """Advance past ``key``'s next occurrence at/after the cursor
        (unknown keys just advance one step, keeping later lookups
        sane if a live workload diverges from the schedule)."""
        idxs = self._index.get(key)
        if idxs:
            j = bisect.bisect_left(idxs, self._pos)
            if j < len(idxs):
                self._pos = idxs[j] + 1
                return
        self._pos += 1

    def _next_use(self, key) -> float:
        idxs = self._index.get(key)
        if not idxs:
            return math.inf
        j = bisect.bisect_left(idxs, self._pos)
        return idxs[j] if j < len(idxs) else math.inf

    def choose_victim(self, slots, cost, history, now):
        return min(
            slots,
            key=lambda k: (-self._next_use(k), slots[k].last_used,
                           slots[k].loaded_at, repr(k)),
        )


RESIDENCY_POLICIES = {
    "lru": LruResidency,
    "reuse": PredictedReuseResidency,
}


def make_policy(name: str):
    try:
        return RESIDENCY_POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown residency policy {name!r}; "
            f"choose from {sorted(RESIDENCY_POLICIES)}") from None

"""Tail-based trace sampling (DESIGN.md §19).

The §15 tracer's head sampling decides keep/drop when a request's root
span *opens* — cheap, but blind: at ``sample_rate=0.01`` the one-in-a-
hundred keep almost never lands on the trace an operator actually wants,
the p99.9 straggler.  Tail sampling inverts the decision point: run the
tracer at ``sample_rate=1.0`` so every tree is *provisionally* recorded,
then decide at root **finish** — when the request's latency and error
status are known — and evict the boring majority from a bounded ring.

Keep rules, checked in order (first match wins, counted per reason):

  ``error``  any span in the tree carries an ``error`` attr;
  ``slo``    latency breached the tenant's SLO target (a float for all
             tenants, or a ``{tenant: seconds}`` dict);
  ``p99``    latency ≥ the rolling p99 of the last ``p99_window``
             finished requests (armed once ``p99_min`` have finished —
             the threshold is computed *before* the current latency
             joins the window, so the decision is causal);
  ``head``   the deterministic credit accumulator at ``sample_rate`` —
             the same no-RNG rule as :meth:`Tracer._sample_root`, so a
             baseline cross-section of *fast* traffic survives too.

Everything else sits in the provisional ring (an insertion-ordered map
of root id → its spans) until ring overflow evicts the oldest tree —
its spans are removed from ``tracer.spans`` so memory stays bounded by
``ring × tree-size`` plus the kept trees.  Latency prefers the
scheduler-stamped ``finish - arrival`` blame inputs over span
timestamps, so the sampler is deterministic under the virtual clock
(``tests/test_obs.py`` asserts byte-equal exports across identical
runs; ``bench_slo`` gates 100% retention of SLO breaches at
``sample_rate=0.01`` where head sampling alone keeps < 10%).
"""
from __future__ import annotations

import json
import math
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Union

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import Span, Tracer

KEEP_REASONS = ("error", "slo", "p99", "head")


def _kept_counter(reason: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_obs_tail_kept_total",
        help="request trees kept by the tail sampler, by reason",
        labels={"reason": reason})


_EVICTED = _metrics.REGISTRY.counter(
    "repro_obs_tail_evicted_total",
    help="provisional request trees evicted from the tail ring")


class TailSampler:
    """Attach to a ``sample_rate=1.0`` tracer; decide at root finish.

    Registers itself on ``tracer.root_listeners`` — the §15 tracer
    fires each listener exactly once, when a sampled root span is first
    finished.  Only roots named ``request`` participate; other root
    spans (none today) pass through untouched.
    """

    def __init__(self, tracer: Tracer, ring: int = 256,
                 sample_rate: float = 0.0,
                 slo_s: Union[None, float, Dict[str, float]] = None,
                 p99_window: int = 256, p99_min: int = 20,
                 quantile: float = 0.99):
        if tracer.sample_rate < 1.0:
            raise ValueError(
                f"tail sampling needs every tree provisionally recorded; "
                f"tracer.sample_rate={tracer.sample_rate} would head-drop "
                f"trees before the tail decision — use sample_rate=1.0")
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0, 1], got "
                             f"{sample_rate}")
        if not (0.0 < quantile < 1.0):
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.tracer = tracer
        self.ring = int(ring)
        self.sample_rate = float(sample_rate)
        self.slo_s = slo_s
        self.p99_min = max(2, int(p99_min))
        self.quantile = float(quantile)
        #: kept root span-id → keep reason, insertion (finish) order
        self.kept: "OrderedDict[int, str]" = OrderedDict()
        #: provisional root span-id → the tree's spans
        self._ring: "OrderedDict[int, List[Span]]" = OrderedDict()
        self._window: deque = deque(maxlen=int(p99_window))
        self.seen = 0
        self.evicted = 0
        # same first-root-kept credit rule as Tracer._sample_root
        self._credit = 1.0 - self.sample_rate
        tracer.root_listeners.append(self._on_root_finish)

    # -- keep rules --------------------------------------------------
    def _slo_for(self, tenant: str) -> Optional[float]:
        if isinstance(self.slo_s, dict):
            return self.slo_s.get(tenant)
        return self.slo_s

    def _latency(self, root: Span) -> float:
        a = root.attrs
        if "finish" in a and "arrival" in a:
            return float(a["finish"]) - float(a["arrival"])
        end = root.end if root.end is not None else root.start
        return end - root.start

    def _head_keep(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        self._credit += self.sample_rate
        if self._credit >= 1.0 - 1e-12:
            self._credit -= 1.0
            return True
        return False

    def _tree_spans(self, root: Span) -> List[Span]:
        by_parent: Dict[int, List[Span]] = {}
        for s in self.tracer.spans:
            if s.parent_id is not None:
                by_parent.setdefault(s.parent_id, []).append(s)
        out, todo = [], [root]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(by_parent.get(s.span_id, ()))
        out.sort(key=lambda s: s.span_id)
        return out

    def _reason(self, root: Span, spans: List[Span],
                latency: float) -> Optional[str]:
        if any("error" in s.attrs for s in spans):
            return "error"
        slo = self._slo_for(str(root.attrs.get("tenant", "default")))
        if slo is not None and latency > slo:
            return "slo"
        if len(self._window) >= self.p99_min:
            if latency >= _quantile(sorted(self._window), self.quantile):
                return "p99"
        if self._head_keep():
            return "head"
        return None

    # -- the finish hook ---------------------------------------------
    def _on_root_finish(self, root: Span) -> None:
        if root.name != "request":
            return
        self.seen += 1
        spans = self._tree_spans(root)
        latency = self._latency(root)
        reason = self._reason(root, spans, latency)
        # window updated AFTER the decision: the p99 threshold a request
        # is judged against never includes its own latency
        self._window.append(latency)
        if reason is not None:
            self.kept[root.span_id] = reason
            _kept_counter(reason).inc()
            return
        self._ring[root.span_id] = spans
        while len(self._ring) > self.ring:
            _, old = self._ring.popitem(last=False)
            self._evict(old)

    def _evict(self, spans: List[Span]) -> None:
        drop = {id(s) for s in spans}
        self.tracer.spans[:] = [s for s in self.tracer.spans
                                if id(s) not in drop]
        self.evicted += 1
        _EVICTED.inc()

    # -- queries / export --------------------------------------------
    def kept_roots(self) -> List[Span]:
        by_id = {s.span_id: s for s in self.tracer.spans}
        return [by_id[i] for i in self.kept if i in by_id]

    def stats(self) -> dict:
        by_reason = {r: 0 for r in KEEP_REASONS}
        for r in self.kept.values():
            by_reason[r] += 1
        return {"seen": self.seen, "kept": len(self.kept),
                "provisional": len(self._ring), "evicted": self.evicted,
                "by_reason": by_reason}

    def export_jsonl(self) -> str:
        """Kept trees only, span-id order with the keep reason stamped
        on each root — same sorted-key JSONL shape as
        :meth:`Tracer.export_jsonl`, byte-stable under the virtual
        clock."""
        out = []
        for root in self.kept_roots():
            reason = self.kept[root.span_id]
            for s in self._tree_spans(root):
                d = s.to_dict()
                if s.span_id == root.span_id:
                    d["keep_reason"] = reason
                out.append(d)
        out.sort(key=lambda d: d["span_id"])
        return "".join(json.dumps(d, sort_keys=True,
                                  separators=(",", ":")) + "\n"
                       for d in out)


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of an ascending list (no interpolation —
    a threshold, not an estimator)."""
    if not sorted_vals:
        return math.inf
    i = min(len(sorted_vals) - 1,
            max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]

"""Per-tenant SLOs: multi-window burn rate + admission feedback
(DESIGN.md §19).

An :class:`Slo` is a latency target plus an objective — "99% of decode
requests finish within 4ms".  The **error budget** is ``1 - objective``;
the **burn rate** over a window is the fraction of requests that missed
the target, divided by the budget::

    burn = bad_fraction / (1 - objective)

so burn 1.0 consumes the budget exactly as fast as allowed and burn 10
exhausts a month's budget in three days.  Alerting on a single window
either pages too slowly (long window) or flaps on blips (short window);
the standard fix is **multi-window**: a tenant is *burning* only when
BOTH its fast and slow windows exceed the threshold — the fast window
proves the problem is happening *now*, the slow window proves it is
sustained.  Windows are measured on whatever clock feeds
:meth:`SloMonitor.record` — the scheduler's deterministic virtual clock
in benchmarks, wall seconds in serve.py — so burn rates are replayable.

The action tier is :class:`SloShedder`, the admission hook
``sched/queue.py`` consults on every submit (off by default; wired by
``serve.py --slo-shed``): a burning tenant's NEW arrivals are shed
(rejected before they queue) or deprioritised (weight scaled down for
the WFQ policy).  Shedding records each rejection as a bad event —
a shed request is a served-zero, and without that the burn signal would
decay the moment shedding starts and the gate would flap open.  Burn
rates are exported as ``repro_slo_burn_rate{tenant,window}`` gauges;
sheds count in ``repro_sched_shed_total{tenant}`` (queue side).

``bench_slo`` gates the loop end to end: on a two-tenant overload mix,
shedding identifies the burning tenant (only its arrivals are shed) and
the protected tenant's p99 wait improves vs the shed-off run.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _metrics

WINDOWS = ("fast", "slow")


def _burn_gauge(tenant: str, window: str) -> _metrics.Gauge:
    return _metrics.REGISTRY.gauge(
        "repro_slo_burn_rate",
        help="error-budget burn rate per tenant and window",
        labels={"tenant": tenant, "window": window})


def _events_total(tenant: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_slo_events_total",
        help="latency events recorded against a tenant SLO",
        labels={"tenant": tenant})


def _breaches_total(tenant: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_slo_breaches_total",
        help="events over the tenant's SLO target (sheds included)",
        labels={"tenant": tenant})


class Slo:
    """One tenant's latency SLO with fast/slow burn-rate windows."""

    def __init__(self, tenant: str, target_s: float,
                 objective: float = 0.99, fast_s: float = 60.0,
                 slow_s: float = 600.0, max_events: int = 4096):
        if target_s <= 0.0:
            raise ValueError(f"target_s must be > 0, got {target_s}")
        if not (0.0 < objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{objective}")
        if not (0.0 < fast_s < slow_s):
            raise ValueError(f"need 0 < fast_s < slow_s, got "
                             f"{fast_s} / {slow_s}")
        self.tenant = tenant
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.max_events = int(max_events)
        #: (t, bad) events; appended in call order, NOT sorted — the
        #: admission hook records sheds at arrival time while the
        #: scheduler records completions at finish time, and those
        #: interleave non-monotonically.  Window queries scan.
        self._events: Deque[Tuple[float, bool]] = deque()
        self._latest = -float("inf")

    # -- recording ---------------------------------------------------
    def record(self, latency_s: float, now: float) -> bool:
        """Record one completion; returns True when it breached."""
        bad = latency_s > self.target_s
        self._note(now, bad)
        return bad

    def record_bad(self, now: float) -> None:
        """Record a shed (denied-service) event — always a breach."""
        self._note(now, True)

    def _note(self, now: float, bad: bool) -> None:
        now = float(now)
        self._events.append((now, bad))
        if now > self._latest:
            self._latest = now
        _events_total(self.tenant).inc()
        if bad:
            _breaches_total(self.tenant).inc()
        if len(self._events) > self.max_events:
            # events older than the slow window can never be counted
            # again (the effective now only grows), so sweep them; cap
            # regardless so a pathological burst stays bounded
            lo = self._latest - self.slow_s
            self._events = deque(
                [e for e in self._events if e[0] > lo],
                )
            while len(self._events) > self.max_events:
                self._events.popleft()

    # -- burn rates --------------------------------------------------
    def _window_s(self, window: str) -> float:
        if window == "fast":
            return self.fast_s
        if window == "slow":
            return self.slow_s
        raise ValueError(f"window must be one of {WINDOWS}, got "
                         f"{window!r}")

    def burn_rate(self, now: Optional[float] = None,
                  window: str = "fast") -> float:
        """bad-fraction / error-budget over the trailing window ending
        at ``max(now, latest recorded time)``; 0.0 with no events."""
        eff = self._latest if now is None else max(float(now),
                                                  self._latest)
        lo = eff - self._window_s(window)
        n = bad = 0
        for t, b in self._events:
            if t > lo:
                n += 1
                bad += b
        if n == 0:
            return 0.0
        return (bad / n) / self.budget

    def burning(self, now: Optional[float] = None,
                threshold: float = 2.0) -> bool:
        """Multi-window rule: burning iff BOTH windows exceed the
        threshold (fast = happening now, slow = sustained)."""
        return (self.burn_rate(now, "fast") > threshold
                and self.burn_rate(now, "slow") > threshold)


class SloMonitor:
    """The tenant → :class:`Slo` registry the scheduler feeds and the
    shedder consults.  ``record`` on an unregistered tenant is a no-op
    (tenants without an SLO are never shed)."""

    def __init__(self, threshold: float = 2.0):
        if threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self._slos: Dict[str, Slo] = {}

    def add(self, tenant: str, target_s: float, **kw) -> Slo:
        if tenant in self._slos:
            raise ValueError(f"tenant {tenant!r} already has an SLO")
        slo = Slo(tenant, target_s, **kw)
        self._slos[tenant] = slo
        self._export(slo, None)
        return slo

    def get(self, tenant: str) -> Optional[Slo]:
        return self._slos.get(tenant)

    def tenants(self) -> List[str]:
        return sorted(self._slos)

    def record(self, tenant: str, latency_s: float, now: float) -> None:
        slo = self._slos.get(tenant)
        if slo is None:
            return
        slo.record(latency_s, now)
        self._export(slo, now)

    def record_shed(self, tenant: str, now: float) -> None:
        slo = self._slos.get(tenant)
        if slo is None:
            return
        slo.record_bad(now)
        self._export(slo, now)

    def _export(self, slo: Slo, now: Optional[float]) -> None:
        for w in WINDOWS:
            _burn_gauge(slo.tenant, w).set(slo.burn_rate(now, w))

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[str, Tuple[float, float]]:
        return {t: (s.burn_rate(now, "fast"), s.burn_rate(now, "slow"))
                for t, s in sorted(self._slos.items())}

    def burning(self, now: Optional[float] = None,
                threshold: Optional[float] = None) -> List[str]:
        thr = self.threshold if threshold is None else threshold
        return [t for t, s in sorted(self._slos.items())
                if s.burning(now, thr)]

    def report(self, now: Optional[float] = None) -> str:
        lines = []
        for t, (fast, slow) in self.burn_rates(now).items():
            state = "BURNING" if t in self.burning(now) else "ok"
            lines.append(f"slo[{t}]: burn fast={fast:.2f} "
                         f"slow={slow:.2f} ({state})")
        return "\n".join(lines)


class SloShedder:
    """Admission hook for :class:`repro_torch.sched.queue.RequestQueue`.

    ``admit(tenant, now)`` returns ``"accept"``, ``"shed"`` (do not
    enqueue), or ``"deprioritise"`` (enqueue with
    ``weight * weight_factor``).  Only tenants whose SLO is burning on
    BOTH windows are acted on; in shed mode every rejection is recorded
    back into the monitor as a bad event so the burn signal holds while
    the tenant's arrivals are being dropped (see module docstring).
    """

    MODES = ("shed", "deprioritise")

    def __init__(self, monitor: SloMonitor,
                 threshold: Optional[float] = None, mode: str = "shed",
                 weight_factor: float = 0.25):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got "
                             f"{mode!r}")
        if not (0.0 < weight_factor <= 1.0):
            raise ValueError(f"weight_factor must be in (0, 1], got "
                             f"{weight_factor}")
        self.monitor = monitor
        self.threshold = threshold
        self.mode = mode
        self.weight_factor = float(weight_factor)

    def admit(self, tenant: str, now: float) -> str:
        slo = self.monitor.get(tenant)
        thr = (self.monitor.threshold if self.threshold is None
               else self.threshold)
        if slo is None or not slo.burning(now, thr):
            return "accept"
        if self.mode == "shed":
            self.monitor.record_shed(tenant, now)
        return self.mode

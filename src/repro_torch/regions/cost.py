"""Reconfiguration cost model: measured, persisted, per-region.

A *region key* names the hardware configuration a target needs loaded —
the structural identity of its fused program chain (the "bitstream"),
NOT the operand size/dtype: two requests running the same chain share
one configured region regardless of their data (DESIGN.md §16).

The :class:`ReconfigCostModel` answers "what does (re)loading region K
cost?" in seconds. Costs are **measured, not assumed**: the observable
proxy this repo already has for a region (re)configuration is the
cold-vs-warm dispatch delta — rebuilding the negotiated geometry and
dispatch state a warm process holds for free. That is exactly what
``bench_hotpath``'s cold-rebuild gate and the PlanCache disk-hit
timings (DESIGN.md §14) measure; :meth:`ReconfigCostModel.measure`
packages the same experiment per program: clear the warm caches, time a
cold ``negotiate_geometry`` (candidate sweep, or a disk hit when a plan
cache is active), time the warm repeat, and seed the key with the
delta.

Seeds persist as ``kind="reconfig"`` artifacts (:mod:`repro_torch.core.
artifact`) keyed on the region key alone — a measured wall time is
machine- (not model-) scoped, so a fresh worker process on the same
machine starts *calibrated* instead of falling back to the flat
default. Later observations fold in with EWMA weight ``alpha`` and
re-publish, mirroring the cost model's ``kind="ewma"`` corrections.
"""
from __future__ import annotations

import math
import time

from repro_torch.core import artifact as _artifact
from repro_torch.core.isa import FusedProgram
from repro_torch.core.program import Program, clear_dispatch_caches
from repro_torch.graph.plan import Plan


def region_key_of(target) -> tuple:
    """The configured-region identity of a work target.

    Structural only — ``Program._identity`` for fused programs (any two
    structurally equal chains share one region), the graph name + chain
    split for plans, the qualname for opaque callables. ``repr`` of the
    result is stable within and across processes, which is what the
    replay trace and the ``kind="reconfig"`` artifacts key on.
    """
    if isinstance(target, FusedProgram):
        return ("prog",) + target.program._identity
    if isinstance(target, Program):
        return ("prog",) + target._identity
    if isinstance(target, Plan):
        return ("plan", target.graph.name, tuple(target.chains()))
    return ("fn", getattr(target, "__qualname__", type(target).__name__))


def _reconfig_payload(raw):
    """Validating decoder for persisted ``kind="reconfig"`` artifacts;
    None (= invalidated) for anything malformed."""
    if not isinstance(raw, dict):
        return None
    cost = raw.get("cost_s")
    count = raw.get("count")
    if (not isinstance(cost, (int, float)) or isinstance(cost, bool)
            or not math.isfinite(cost) or cost <= 0):
        return None
    if not isinstance(count, int) or isinstance(count, bool) or count < 1:
        return None
    return (float(cost), count)


class ReconfigCostModel:
    """Per-region load cost: measured seed, EWMA refinement, disk warm
    start (see module docstring)."""

    KIND = "reconfig"

    def __init__(self, default_s: float = 5e-4, alpha: float = 0.25):
        if default_s < 0:
            raise ValueError(f"default_s must be >= 0, got {default_s}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.default_s = float(default_s)
        self.alpha = alpha
        self._cost: dict = {}          # key -> seconds
        self._count: dict = {}         # samples folded in per key
        self._checked: set = set()     # one disk probe per key per process

    # -- reads ----------------------------------------------------------------
    def cost(self, key) -> float:
        """Load cost of region ``key`` in seconds; the flat default when
        nothing was ever measured (here or by a previous process)."""
        self._warm(key)
        return self._cost.get(key, self.default_s)

    def known(self, key) -> bool:
        """True iff ``key`` has a measured (non-default) cost."""
        self._warm(key)
        return key in self._cost

    # -- writes ---------------------------------------------------------------
    def seed(self, key, seconds: float) -> None:
        """Install a measured cost outright (first calibration)."""
        if not (seconds > 0 and math.isfinite(seconds)):
            raise ValueError(f"seed cost must be finite and > 0, "
                             f"got {seconds}")
        self._checked.add(key)
        self._cost[key] = float(seconds)
        self._count[key] = max(self._count.get(key, 0), 1)
        self._persist(key)

    def observe(self, key, seconds: float) -> None:
        """Fold one observed (re)configuration time into the key's cost:
        the first observation seeds, later ones blend with ``alpha``."""
        if not (seconds > 0 and math.isfinite(seconds)):
            raise ValueError(f"observed cost must be finite and > 0, "
                             f"got {seconds}")
        self._warm(key)
        prev = self._cost.get(key)
        self._cost[key] = (seconds if prev is None else
                           (1 - self.alpha) * prev + self.alpha * seconds)
        self._count[key] = self._count.get(key, 0) + 1
        self._persist(key)

    # -- measurement ----------------------------------------------------------
    def measure(self, target, n_elems: int, dtype) -> float:
        """Measure ``target``'s cold-vs-warm dispatch delta and seed it.

        The experiment of the JAX package's ``bench_hotpath`` §14
        cold-start gate, per program: drop every warm dispatch cache
        (global — run this in a calibration phase, not on a serving hot
        path), time the cold ``negotiate_geometry`` (a full candidate
        sweep, or a PlanCache disk hit when a cache dir is active — both
        are real "load this region" times), time the warm repeat, seed
        ``cost = cold − warm`` and return it. As in the JAX package, the
        kernel build is not part of it: on the card a region's first
        launch also builds K1 (Triton), which the first ``observe`` of a
        wall-clock run sees.
        """
        prog = target.program if isinstance(target, FusedProgram) else target
        if not isinstance(prog, Program):
            raise TypeError("measure needs a Program/FusedProgram target "
                            f"(got {type(target).__name__}); plans and "
                            "callables keep the default cost")
        clear_dispatch_caches()
        t0 = time.perf_counter()
        prog.negotiate_geometry(n_elems, dtype)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog.negotiate_geometry(n_elems, dtype)
        warm = time.perf_counter() - t0
        delta = max(cold - warm, 1e-9)
        self.seed(region_key_of(target), delta)
        return delta

    # -- persistence (kind="reconfig", DESIGN.md §16) --------------------------
    def _warm(self, key) -> None:
        if key in self._checked:
            return
        self._checked.add(key)
        if key in self._cost:
            return
        cache = _artifact.plan_cache()
        if cache is None:
            return
        loaded = cache.load(self.KIND, key, decode=_reconfig_payload)
        if loaded is None:
            return
        cost, count = loaded
        self._cost[key] = cost
        self._count[key] = max(self._count.get(key, 0), count)

    def _persist(self, key) -> None:
        cache = _artifact.plan_cache()
        if cache is None:
            return
        cache.store(self.KIND, key, {
            "cost_s": self._cost.get(key),
            "count": self._count.get(key, 0),
        })


class PinnedReconfigCost(ReconfigCostModel):
    """Cost model pinned to a recorded trace's per-region costs
    (:func:`repro_torch.sched.replay.replay` — keys are the recorded
    ``("trace", region_key_repr)`` tuples). Never touches disk, so a
    replay is deterministic regardless of any active plan cache."""

    def __init__(self, costs: dict, default_s: float = 0.0):
        super().__init__(default_s=default_s)
        for k, v in costs.items():
            self._cost[k] = float(v)
            self._count[k] = 1
        self._checked.update(costs)

    def _warm(self, key) -> None:
        return

    def _persist(self, key) -> None:
        return

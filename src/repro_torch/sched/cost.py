"""Online cost model: model-seeded, EWMA-corrected, contention-aware.

Three layers (DESIGN.md §13):

  * **Seed** — a request's first estimate comes from the repo's memory
    model: :func:`repro_torch.memhier.predict.predict_program` at the
    program's negotiated geometry (full Prediction: solo seconds + DRAM
    busy time + DRAM bytes), :meth:`repro_torch.graph.plan.Plan.predicted_time`
    plus per-part DRAM terms from :meth:`Plan.units` for plans, the
    burst-law ``Program.negotiated_time`` when only a BurstModel is
    bound, and a flat default for opaque callables.
  * **EWMA correction** — observed wall seconds (fed by the scheduler,
    or by the observed-time hooks of :mod:`repro_torch.core.program` via
    :meth:`CostModel.attach`) maintain an exponentially weighted
    observed/modeled ratio per ``(program fingerprint, size bucket,
    dtype)``; predictions are the seed times the learned ratio, so the
    model tracks the machine it actually runs on without re-fitting the
    simulator.
  * **Contention** — :meth:`CostModel.contended_makespan` prices a set
    of *concurrently scheduled* work: per
    :func:`repro_torch.memhier.predict.contended_makespan`, non-DRAM work
    overlaps freely but the summed (correction-scaled) DRAM busy times
    serialise on the shared interface — closing the ROADMAP item that
    plan overlap treated HBM ports as free.

Two extensions (DESIGN.md §15):

  * **Drift tracking** — every ``observe()`` also feeds the model's
    :class:`repro_torch.obs.drift.DriftTracker`, accumulating raw
    observed/modeled residuals per EWMA cell so
    :meth:`CostModel.drift_report` can rank where memhier is most
    wrong — separately from the correction that papers over it.
  * **EWMA persistence** — when a plan cache is active
    (:mod:`repro_torch.core.artifact`), corrections are published as
    ``kind="ewma"`` artifacts keyed on the EWMA key (value-based, so
    stable across processes) and consulted once per key on the first
    in-memory miss: a restarted fleet warm-starts its *predictions*,
    not just its geometries.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core import artifact as _artifact
from repro_torch.core.burst_model import BurstModel
from repro_torch.core.program import (Program, _model_fingerprint,
                                      _n_bucket, pop_observed_time_hook,
                                      push_observed_time_hook)
from repro_torch.core.stream import dtype_name
from repro_torch.graph.plan import Plan
from repro_torch.obs.drift import DriftTracker

from .queue import WorkItem, program_of


def _target_name(target) -> str:
    prog = program_of(target)
    if prog is not None:
        return prog.name
    if isinstance(target, Plan):
        return target.graph.name
    return getattr(target, "__qualname__", type(target).__name__)


def _ewma_payload(raw):
    """Validating decoder for persisted ``kind="ewma"`` artifacts;
    None (= invalidated) for anything malformed."""
    if not isinstance(raw, dict):
        return None

    def ok(v):
        return v is None or (isinstance(v, (int, float))
                             and not isinstance(v, bool)
                             and v > 0 and math.isfinite(v))

    ratio, abs_s, count = raw.get("ratio"), raw.get("abs"), raw.get("count")
    if not ok(ratio) or not ok(abs_s):
        return None
    if not isinstance(count, int) or isinstance(count, bool) or count < 0:
        return None
    if ratio is None and abs_s is None:
        return None
    return (ratio, abs_s, count)


@dataclasses.dataclass(frozen=True)
class Estimate:
    """One work item's cost estimate.

    ``seconds`` is the EWMA-corrected prediction the scheduler plans
    with; ``modeled_s`` the raw model seed; ``dram_busy_s``/``dram_bytes``
    the shared-interface demand feeding the contention term (already
    scaled by the same correction as ``seconds``).
    """

    seconds: float
    modeled_s: float
    dram_busy_s: float
    dram_bytes: int
    source: str                      # memhier | plan | burst | default

    @property
    def correction(self) -> float:
        return self.seconds / self.modeled_s if self.modeled_s > 0 else 1.0


class CostModel:
    """Predict-then-correct cost model over the repo's memory models."""

    def __init__(self, hierarchy=None, alpha: float = 0.25,
                 default_s: float = 1e-3,
                 drift_threshold: Optional[float] = None):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.hierarchy = hierarchy
        self.alpha = alpha
        self.default_s = default_s
        self._ratio: dict = {}        # EWMA of observed/modeled per key
        self._abs: dict = {}          # EWMA of observed seconds (callables)
        self._count: dict = {}        # observations folded in per key
        self._seed_cache: dict = {}
        # keys whose persisted correction was already consulted (hit or
        # miss) — one disk probe per key per process, never on the
        # warm path.
        self._ewma_checked: set = set()
        #: raw modeled-vs-observed residuals (repro_torch.obs.drift); with
        #: ``drift_threshold``, chronic mismatch past it bumps the
        #: repro_drift_exceeded_total counter and is listed by
        #: ``self.drift.exceeding()``
        self.drift = DriftTracker(threshold=drift_threshold)

    # -- keys -----------------------------------------------------------------
    def ewma_key(self, target, n_elems: Optional[int], dtype,
                 cost_key: Optional[tuple] = None) -> tuple:
        """(program fingerprint, size bucket, dtype) — the correction's
        granularity. Explicit ``cost_key`` wins (opaque callables).
        The dtype is its numpy name, so keys — and the ``kind="ewma"``
        artifacts stored under them — are byte-equal to the JAX
        package's."""
        if cost_key is not None:
            return ("user",) + tuple(cost_key)
        prog = program_of(target)
        bucket = _n_bucket(n_elems) if n_elems else 0
        dt = dtype_name(dtype) if dtype is not None else "none"
        if prog is not None:
            return ("prog", prog._identity, bucket, dt)
        if isinstance(target, Plan):
            return ("plan", target.graph.name,
                    tuple(target.chains()), bucket, dt)
        return ("fn", getattr(target, "__qualname__",
                              type(target).__name__))

    # -- seeding --------------------------------------------------------------
    def _resolve_hier(self, prog: Optional[Program], plan: Optional[Plan]):
        if self.hierarchy is not None:
            return self.hierarchy
        if prog is not None and not isinstance(prog.model, BurstModel):
            return prog.model
        if plan is not None:
            return plan.hierarchy
        return None

    def _seed_program(self, prog: Program, n: int, dtype):
        hier = self._resolve_hier(prog, None)
        if hier is None:
            t = prog.negotiated_time(n, dtype)
            return (t, t, prog.hbm_bytes_fused(n, dtype), "burst")
        from repro_torch.memhier.predict import predict_program
        if prog.model is hier:
            negotiator = prog
        else:                          # rescore under this model's geometry
            negotiator = copy.copy(prog)
            negotiator.model = hier
            negotiator._model_fp = None
        br, bc, _ = negotiator.negotiate_geometry(n, dtype)
        pred = predict_program(hier, prog, n, dtype, block_rows=br,
                               block_cols=bc, n_buffers=prog.n_buffers)
        return (pred.time_s, pred.dram_busy_s, pred.dram_bytes, "memhier")

    def _seed_plan(self, plan: Plan, n: Optional[int], dtype):
        hier = self._resolve_hier(None, plan)
        if hier is None:
            return (self.default_s, 0.0, plan.modeled_hbm_bytes(n, dtype),
                    "default")
        t = plan.predicted_time(hier, n_elems=n, dtype=dtype)
        units = plan.units(hier, n_elems=n, dtype=dtype)
        busy = sum(u.dram_busy_s for u in units)
        return (t, busy, plan.modeled_hbm_bytes(n, dtype), "plan")

    def _model_key(self, prog: Optional[Program], plan: Optional[Plan]):
        """Model-side component of the seed-cache key: the resolved
        hierarchy's fingerprint plus the program knobs that change its
        prediction — so rebinding ``prog.model``/``self.hierarchy`` or
        two structurally equal Programs with different ``n_buffers``
        never share a stale seed."""
        hier = self._resolve_hier(prog, plan)
        hfp = _model_fingerprint(hier) if hier is not None else None
        if prog is not None:
            return (hfp, prog._current_model_fp(), prog.n_buffers,
                    prog.smem_budget)
        return (hfp,)

    def seed(self, target, n_elems: Optional[int] = None, dtype=None):
        """(modeled seconds, DRAM busy s, DRAM bytes, source) — memoised."""
        prog = program_of(target)
        plan = target if isinstance(target, Plan) else None
        key = (self.ewma_key(target, n_elems, dtype) + (int(n_elems or 0),)
               + self._model_key(prog, plan))
        hit = self._seed_cache.get(key)
        if hit is not None:
            return hit
        if prog is not None:
            if n_elems is None or dtype is None:
                raise ValueError("program estimates need n_elems and dtype")
            res = self._seed_program(prog, n_elems, dtype)
        elif plan is not None:
            res = self._seed_plan(plan, n_elems, dtype)
        else:
            res = (self.default_s, 0.0, 0, "default")
        self._seed_cache[key] = res
        return res

    # -- prediction -----------------------------------------------------------
    def estimate(self, target, operands=(), *, n_elems: Optional[int] = None,
                 dtype=None, cost_key: Optional[tuple] = None) -> Estimate:
        prog = program_of(target)
        if prog is not None and (n_elems is None or dtype is None):
            vecs = prog.check_vector_operands(operands)
            n_elems = vecs[0].numel()
            dtype = vecs[0].dtype
        if isinstance(target, Plan):
            n_elems = n_elems if n_elems is not None else target.n_elems
            dtype = dtype if dtype is not None else target.dtype
        modeled, busy, nbytes, source = self.seed(target, n_elems, dtype)
        key = self.ewma_key(target, n_elems, dtype, cost_key)
        self._warm_ewma(key)
        if source == "default" and key in self._abs:
            # opaque targets: prediction IS the observed EWMA.
            obs = self._abs[key]
            return Estimate(seconds=obs, modeled_s=modeled,
                            dram_busy_s=busy, dram_bytes=nbytes,
                            source="ewma")
        ratio = self._ratio.get(key, 1.0)
        return Estimate(seconds=modeled * ratio, modeled_s=modeled,
                        dram_busy_s=busy * ratio, dram_bytes=nbytes,
                        source=source)

    def estimate_item(self, item: WorkItem) -> Estimate:
        """Estimate for an admitted work item (overridden by replay)."""
        return self.estimate(item.target, item.operands,
                             cost_key=item.cost_key)

    # -- correction -----------------------------------------------------------
    def observe(self, target, *, n_elems: Optional[int] = None, dtype=None,
                seconds: float, n_items: int = 1,
                cost_key: Optional[tuple] = None) -> None:
        """Fold one observed wall time into the EWMA correction.

        ``seconds`` is the whole dispatch (a coalesced batch reports the
        batch total with ``n_items`` > 1; the per-item share seeds the
        ratio so batched and solo observations share one key).

        The first observation of a key seeds the correction outright and
        the second REPLACES it (a key's first call typically pays
        one-off kernel generation and build — cold-start time must not poison
        the steady-state estimate); from the third on, samples blend in
        with weight ``alpha``.
        """
        if seconds < 0:
            raise ValueError(f"observed seconds must be >= 0, got {seconds}")
        per_item = seconds / max(1, n_items)
        key = self.ewma_key(target, n_elems, dtype, cost_key)
        self._warm_ewma(key)   # continue a persisted EWMA, don't restart
        n_seen = self._count.get(key, 0)
        self._count[key] = n_seen + 1
        modeled, _, _, source = self.seed(target, n_elems, dtype)
        if source == "default":
            prev = self._abs.get(key)
            self._abs[key] = (per_item if n_seen <= 1 or prev is None else
                              (1 - self.alpha) * prev + self.alpha * per_item)
            self._persist_ewma(key)
            return
        sample = per_item / modeled if modeled > 0 else 1.0
        prev = self._ratio.get(key)
        self._ratio[key] = (sample if n_seen <= 1 or prev is None else
                            (1 - self.alpha) * prev + self.alpha * sample)
        self._persist_ewma(key)
        # raw residual alongside the correction (DESIGN.md §15): the
        # EWMA *adapts to* model error, the drift tracker *reports* it.
        bucket = _n_bucket(n_elems) if n_elems else 0
        dt_name = dtype_name(dtype) if dtype is not None else "none"
        self.drift.record(
            key, modeled, per_item, name=_target_name(target),
            bucket=bucket, dtype=dt_name,
            ewma_ratio=self._ratio.get(key))
        # the action half of the obs→cost loop (DESIGN.md §15/§18):
        # chronic drift past the threshold flags the (fingerprint,
        # bucket, dtype) cell for geometry re-negotiation — the next
        # dispatch of that shape re-runs the candidate sweep instead of
        # trusting memos tuned for a machine the model mispredicts.
        prog = program_of(target)
        if (prog is not None and self.drift.threshold is not None
                and self.drift.cell_exceeds(key)):
            from repro_torch.core.program import request_renegotiation
            request_renegotiation(prog._identity, bucket, dt_name)

    def drift_report(self, top: Optional[int] = None,
                     min_samples: int = 1) -> list:
        """Cells ranked by |mean(observed/modeled) − 1|, worst first —
        see :meth:`repro_torch.obs.drift.DriftTracker.report`."""
        return self.drift.report(top=top, min_samples=min_samples)

    # -- persistence (kind="ewma", DESIGN.md §15) ------------------------------
    def _warm_ewma(self, key) -> None:
        """One-shot disk consult for a key with no in-memory correction
        (no-op without an active plan cache)."""
        if key in self._ewma_checked:
            return
        self._ewma_checked.add(key)
        if key in self._ratio or key in self._abs:
            return
        cache = _artifact.plan_cache()
        if cache is None:
            return
        loaded = cache.load("ewma", key, decode=_ewma_payload)
        if loaded is None:
            return
        ratio, abs_s, count = loaded
        if ratio is not None:
            self._ratio[key] = ratio
        if abs_s is not None:
            self._abs[key] = abs_s
        if count:
            self._count[key] = max(self._count.get(key, 0), count)

    def _persist_ewma(self, key) -> None:
        cache = _artifact.plan_cache()
        if cache is None:
            return
        cache.store("ewma", key, {
            "ratio": self._ratio.get(key),
            "abs": self._abs.get(key),
            "count": self._count.get(key, 0),
        })

    @contextlib.contextmanager
    def attach(self):
        """Feed the EWMA from :mod:`repro_torch.core.program`'s observed-time
        hooks: every ``Program.__call__``/``call_batch`` anywhere in the
        process reports its measured wall seconds while attached."""
        def hook(program, n_elems, dtype_name, seconds, n_items):
            self.observe(program, n_elems=n_elems, dtype=dtype_name,
                         seconds=seconds, n_items=n_items)
        push_observed_time_hook(hook)
        try:
            yield self
        finally:
            pop_observed_time_hook(hook)

    # -- contention -----------------------------------------------------------
    def contended_makespan(self, estimates: Sequence[Estimate],
                           channels: Optional[Sequence[int]] = None) -> float:
        """Predicted makespan of concurrently scheduled estimates:
        correction-scaled form of
        :func:`repro_torch.memhier.predict.contended_makespan` — overlapping
        work is free except the DRAM busy times, which serialise.

        ``channels`` (DESIGN.md §18) gives each estimate's DRAM channel:
        busy times then serialise only *within* a channel and the
        busiest channel sets the DRAM term —
        :func:`repro_torch.memhier.predict.fluid_makespan` with each item
        pinned to its lane's channel. ``None`` (or all-equal channels)
        is the single-interface formula, bit for bit.
        """
        ests = list(estimates)
        if not ests:
            return 0.0
        solo = max(e.seconds for e in ests)
        if channels is None:
            shared = sum(e.dram_busy_s for e in ests)
            return max(solo, shared)
        per_ch: dict[int, float] = {}
        for e, c in zip(ests, channels):
            per_ch[c] = per_ch.get(c, 0.0) + e.dram_busy_s
        return max(solo, max(per_ch.values()))

    def fluid_finishes(self, estimates: Sequence[Estimate],
                       channels: Optional[Sequence[int]] = None,
                       n_channels: int = 1) -> list[float]:
        """Per-item finish offsets of one concurrent round under the
        per-channel fluid sharing model (DESIGN.md §18): each estimate's
        DRAM demand is pinned to its lane's channel and drains under
        processor sharing, so short items finish early and release their
        bandwidth share — :func:`repro_torch.memhier.predict.
        fluid_finish_times` over the correction-scaled estimates. The
        max finish equals :meth:`contended_makespan` of the same round.
        """
        from repro_torch.memhier.predict import FluidItem, fluid_finish_times
        ests = list(estimates)
        if not ests:
            return []
        chans = list(channels) if channels is not None else [0] * len(ests)
        n_ch = max(n_channels, max(chans) + 1)
        items = [FluidItem.pinned(e.seconds, e.dram_busy_s, c, n_ch)
                 for e, c in zip(ests, chans)]
        fins = fluid_finish_times(items)
        # clamp the round's end to the (bit-stable) rigid closed form so
        # the virtual clock advances exactly as the makespan promises.
        end = self.contended_makespan(ests, channels)
        return [min(f, end) for f in fins]

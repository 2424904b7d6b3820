"""Modeled-vs-observed drift tracking (DESIGN.md §15).

The memhier simulator predicts a time for every dispatch; the runtime
then measures one.  Ramírez et al.'s methodology (PAPERS.md) holds that
a simulator is only trustworthy when systematically confronted with
measurement — this module makes that confrontation a first-class,
monitorable signal instead of something buried inside the cost model's
EWMA state.

A :class:`DriftTracker` accumulates ``(modeled_s, observed_s)`` pairs
into cells keyed exactly like the cost model's EWMA —
``(fingerprint, pow2 bucket, dtype)`` — and
:meth:`DriftTracker.report` ranks cells by ``|mean(observed/modeled)
− 1|`` ("drift"): the top of the report is where memhier is most
wrong.  Each ``CostModel`` owns a tracker and feeds it from
``observe()`` alongside the EWMA update, so the report can show the
raw residual next to the correction the model is currently applying.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, List, Optional, Tuple


def _cell_fingerprint(key: Any) -> str:
    """Stable short id for a cell key (keys are nested tuples that are
    ``repr``-stable within and across processes)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:12]


@dataclasses.dataclass
class DriftCell:
    """Residual accumulator for one (fingerprint, bucket, dtype)."""

    key: Any
    name: str = ""
    bucket: Optional[int] = None
    dtype: Optional[str] = None
    n: int = 0
    sum_ratio: float = 0.0
    sum_sq: float = 0.0
    min_ratio: float = math.inf
    max_ratio: float = -math.inf
    ewma_ratio: Optional[float] = None

    @property
    def mean_ratio(self) -> float:
        return self.sum_ratio / self.n if self.n else float("nan")

    @property
    def drift(self) -> float:
        """|mean(observed/modeled) − 1| — the ranking key."""
        return abs(self.mean_ratio - 1.0) if self.n else 0.0

    def record(self, ratio: float, ewma_ratio: Optional[float]):
        self.n += 1
        self.sum_ratio += ratio
        self.sum_sq += ratio * ratio
        self.min_ratio = min(self.min_ratio, ratio)
        self.max_ratio = max(self.max_ratio, ratio)
        if ewma_ratio is not None:
            self.ewma_ratio = ewma_ratio

    def to_row(self) -> dict:
        std = 0.0
        if self.n > 1:
            var = max(self.sum_sq / self.n - self.mean_ratio ** 2, 0.0)
            std = math.sqrt(var)
        return {
            "fingerprint": _cell_fingerprint(self.key),
            "name": self.name,
            "bucket": self.bucket,
            "dtype": self.dtype,
            "samples": self.n,
            "mean_ratio": self.mean_ratio,
            "drift": self.drift,
            "std_ratio": std,
            "min_ratio": self.min_ratio,
            "max_ratio": self.max_ratio,
            "ewma_ratio": self.ewma_ratio,
        }


class DriftTracker:
    """Accumulates observed/modeled residual ratios per cell.

    ``max_cells`` bounds memory for long-lived fleets: once full, new
    keys are counted in :attr:`overflow` instead of allocating.

    ``threshold`` makes chronic mismatch *queryable* instead of only
    ranked: each recorded sample whose cell (≥ 2 samples, so one
    outlier can't trip it) is drifting past the threshold bumps the
    process-global ``repro_drift_exceeded_total`` counter, and
    :meth:`exceeding` lists the offending cells — the hook for alerting
    and for re-negotiation triggers (ROADMAP: drift → re-calibration).
    """

    def __init__(self, max_cells: int = 4096,
                 threshold: Optional[float] = None):
        if threshold is not None and threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.max_cells = max_cells
        self.threshold = threshold
        self._cells: Dict[Any, DriftCell] = {}
        self.overflow = 0
        from repro_torch.obs import metrics as _metrics
        self._m_exceeded = _metrics.REGISTRY.counter(
            "repro_drift_exceeded_total",
            help="samples recorded into cells whose |obs/model - 1| "
                 "exceeds the tracker's threshold")

    def record(self, key: Any, modeled_s: float, observed_s: float, *,
               name: str = "", bucket: Optional[int] = None,
               dtype: Optional[str] = None,
               ewma_ratio: Optional[float] = None) -> Optional[float]:
        """Record one completion.  Returns the residual ratio, or
        ``None`` if the pair was unusable (non-positive times)."""
        if modeled_s <= 0 or observed_s <= 0:
            return None
        cell = self._cells.get(key)
        if cell is None:
            if len(self._cells) >= self.max_cells:
                self.overflow += 1
                return None
            cell = DriftCell(key=key, name=name, bucket=bucket, dtype=dtype)
            self._cells[key] = cell
        ratio = observed_s / modeled_s
        cell.record(ratio, ewma_ratio)
        if (self.threshold is not None and cell.n >= 2
                and cell.drift > self.threshold):
            self._m_exceeded.inc()
        return ratio

    def cell_exceeds(self, key: Any,
                     threshold: Optional[float] = None) -> bool:
        """True iff ``key``'s cell is currently past the threshold (≥ 2
        samples, same rule as the counter) — the O(1) per-observation
        probe behind the re-negotiation trigger (DESIGN.md §15 action
        half), where :meth:`exceeding` is the O(cells) report."""
        thr = threshold if threshold is not None else self.threshold
        if thr is None:
            return False
        cell = self._cells.get(key)
        return cell is not None and cell.n >= 2 and cell.drift > thr

    def exceeding(self, threshold: Optional[float] = None,
                  min_samples: int = 2) -> List[dict]:
        """Cells whose drift exceeds ``threshold`` (defaults to the
        tracker's own), worst-first — empty list means the model is
        within tolerance everywhere it has been measured."""
        thr = threshold if threshold is not None else self.threshold
        if thr is None:
            raise ValueError("no threshold: pass one or construct the "
                             "tracker with DriftTracker(threshold=...)")
        return [r for r in self.report(min_samples=min_samples)
                if r["drift"] > thr]

    def __len__(self):
        return len(self._cells)

    def reset(self):
        self._cells.clear()
        self.overflow = 0

    def report(self, top: Optional[int] = None,
               min_samples: int = 1) -> List[dict]:
        """Cells ranked worst-first by :attr:`DriftCell.drift`, ties
        broken by sample count then fingerprint (deterministic)."""
        rows = [c.to_row() for c in self._cells.values()
                if c.n >= min_samples]
        rows.sort(key=lambda r: (-r["drift"], -r["samples"],
                                 r["fingerprint"]))
        return rows[:top] if top else rows

    def format_report(self, top: Optional[int] = 20,
                      min_samples: int = 1) -> str:
        """Human-readable table of :meth:`report`."""
        rows = self.report(top=top, min_samples=min_samples)
        if not rows:
            return "drift: no samples\n"
        hdr = (f"{'fingerprint':<14}{'name':<24}{'bucket':>8}"
               f"{'dtype':>10}{'n':>6}{'obs/model':>11}{'drift':>8}"
               f"{'ewma':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in rows:
            ew = ("-" if r["ewma_ratio"] is None
                  else f"{r['ewma_ratio']:.3f}")
            lines.append(
                f"{r['fingerprint']:<14}{r['name'][:23]:<24}"
                f"{str(r['bucket']):>8}{str(r['dtype']):>10}"
                f"{r['samples']:>6}{r['mean_ratio']:>11.3f}"
                f"{r['drift']:>8.3f}{ew:>8}")
        if self.overflow:
            lines.append(f"(+{self.overflow} samples dropped: cell "
                         f"table full at {self.max_cells})")
        return "\n".join(lines) + "\n"


def watch_programs(tracker: DriftTracker, hierarchy=None):
    """Context manager feeding a tracker from *bare* ``Program`` calls
    (no scheduler in the loop) via the observed-time hook: modeled time
    comes from the program's own negotiated prediction.

    ``with watch_programs(t): prog(...)`` — per-item observed seconds
    are compared against ``predicted_time(n, dtype) / n_items``.
    """
    import contextlib

    from repro_torch.core import program as prog_mod

    @contextlib.contextmanager
    def _ctx():
        memo: Dict[Tuple, float] = {}

        def hook(program, n_elems, dtype_name, seconds, n_items):
            k = (id(program), n_elems, dtype_name)
            modeled = memo.get(k)
            if modeled is None:
                try:
                    modeled = program.negotiated_time(n_elems, dtype_name)
                except Exception:
                    modeled = 0.0
                memo[k] = modeled
            tracker.record(
                ("prog", program._identity, prog_mod._n_bucket(n_elems),
                 dtype_name),
                modeled, seconds / max(n_items, 1),
                name=program.name, bucket=prog_mod._n_bucket(n_elems),
                dtype=dtype_name)

        prog_mod.push_observed_time_hook(hook)
        try:
            yield tracker
        finally:
            prog_mod.pop_observed_time_hook(hook)

    return _ctx()

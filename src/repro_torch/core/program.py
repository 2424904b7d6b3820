"""Fused instruction programs: N registered instructions, ONE kernel launch.

The paper's wide-operand I'/S' encodings exist to do more work per
instruction issue; the GPU analogue of "one issue" is one kernel launch.
Chaining unfused ops round-trips every intermediate through device
memory — exactly the traffic the paper's reconfigurable region avoids by
keeping values in the datapath. A :class:`Program` is the software form
of a *larger* reconfigurable region: it takes the
:class:`~repro_torch.core.template.Stage` of each instruction, negotiates
one common block geometry (picked with the
:mod:`~repro_torch.core.burst_model` burst-efficiency law, bounded by the
shared-memory budget check in :class:`~repro_torch.core.stream.
StreamConfig`), and launches K1 (:mod:`repro_torch.core.fused_kernel`),
whose body runs the stage bodies back to back, threading intermediates
through registers instead of HBM.

Chaining rule (the "register bypass network"):
  * stage *i*'s vector outputs feed the FIRST ``n_vec_out`` vector inputs
    of stage *i+1*;
  * every remaining vector input, and every scalar input, comes from the
    program's external operand list.

External operand order (user-facing): for each stage in chain order, its
scalar operands then its non-chained vector operands. E.g.
``fuse("c0_scale", "c0_add")`` is called as ``fused(s, x, b)`` and computes
``add(scale(s, x), b)``.

Hot-path caching: geometry negotiation is memoised per ``(program
identity, n_elems, dtype, model fingerprint, budget, buffers)`` in a
shared module-level cache, ``__call__`` resolves a warm dispatch through
a per-instance ``(n_elems bucket, dtype, model fingerprint)`` table
without re-entering negotiation, and the launch closure (K1 or its
emulator) is cached per operand signature, so a warm call regenerates
nothing. :data:`DISPATCH_STATS` counts hits/misses/builds. Warm buckets
are cost-aware: a warm hit at a size whose modeled time has drifted
> 10% from the bucket's negotiated geometry re-negotiates
(``DISPATCH_STATS.rebucketed``).

Persistent artifacts: when a plan cache is active
(:mod:`repro_torch.core.artifact`), a geometry miss first consults the
content-addressed on-disk cache — keyed identically to the memo, and
identically to the JAX package's, so either package serves the other —
and every completed negotiation (including "no-fit" verdicts) is
published back.

Observability: ``dispatch`` spans wrap every ``__call__``/``call_batch``,
``negotiate`` a memo-miss sweep (outcome ``disk_hit`` vs ``sweep``) and
``pallas_build`` a cold build of the launch (the reference's span name,
kept so trace readers work on either package), through
:mod:`repro_torch.obs.trace`.

Serving entry points: :meth:`Program.call_batch` coalesces N
same-structure requests into ONE launch, and observed-time hooks
(:func:`push_observed_time_hook`) report measured wall seconds per call.

A :class:`Program` scores candidate geometries with the one-term
:class:`~repro_torch.core.burst_model.BurstModel` law, or, given a
:class:`~repro_torch.memhier.hierarchy.Hierarchy`, by simulating each
candidate's trace (:func:`repro_torch.memhier.predict.predict_program`,
intermediates elided, through the fast engine).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
import weakref
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from . import artifact as _artifact
from . import fused_kernel as _fk
from .burst_model import H100_HBM, BurstModel
from .stream import (LANES, SMEM_BYTES, StreamConfig, _bits, dtype_name,
                     round_up)
from .template import Stage

# Candidate fused block widths (lanes-aligned powers of two). The burst
# model picks among these: wide enough to amortise per-block overhead
# (paper §3.1.2: very wide LLC blocks), small enough for the on-chip
# budget (paper §3.1.3: BRAM capacity).
_BLOCK_COL_CANDIDATES = tuple(LANES * (1 << k) for k in range(7))


# ---------------------------------------------------------------------------
# dispatch caching
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DispatchStats:
    """Frozen snapshot of the warm-dispatch counters.

    The live counters are registry-backed (``repro_torch.obs.metrics``,
    one ``repro_dispatch_<field>_total`` counter per field);
    :data:`DISPATCH_STATS` is a thin attribute view over them whose
    :meth:`_DispatchStatsView.snapshot` returns an instance of this
    dataclass. The fields are the JAX package's.
    """

    geometry_hits: int = 0       # negotiations answered from the cache
    geometry_misses: int = 0     # negotiations that ran the candidate loop
    call_builds: int = 0         # launch closures built (K1 or emulator)
    kernel_traces: int = 0       # kernel bodies instantiated: K1 modules
                                 # generated, or emulator walks bound
    rebucketed: int = 0          # warm buckets re-negotiated on cost drift
    batch_calls: int = 0         # coalesced call_batch launches
    batch_items: int = 0         # work items those coalesced launches served
    batch_mixed: int = 0         # coalesced launches with per-item scalars
    # persistent-artifact cache (core.artifact):
    disk_hit: int = 0            # artifacts loaded + verified from disk
    disk_miss: int = 0           # disk consults that found no entry
    disk_invalidated: int = 0    # stale/wrong-key/version-drift entries dropped
    disk_corrupt: int = 0        # unreadable/truncated entries dropped
    disk_store: int = 0          # artifacts atomically published to disk
    disk_evict: int = 0          # artifacts removed by the LRU size sweep
    drift_renegotiated: int = 0  # geometry sweeps re-run on chronic drift


_STAT_FIELDS = tuple(f.name for f in dataclasses.fields(DispatchStats))


class _DispatchStatsView:
    """Attribute view over the registry-backed dispatch counters:
    ``DISPATCH_STATS.geometry_hits += 1`` writes through to the
    ``repro_dispatch_geometry_hits_total`` counter."""

    __slots__ = ("_counters",)

    def __init__(self):
        counters = {}
        for f in _STAT_FIELDS:
            counters[f] = _metrics.REGISTRY.counter(
                f"repro_dispatch_{f}_total",
                help=f"dispatch counter {f} (core/program.py)")
        object.__setattr__(self, "_counters", counters)

    def __getattr__(self, name):
        try:
            return self._counters[name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        try:
            self._counters[name].set(value)
        except KeyError:
            raise AttributeError(name) from None

    def snapshot(self) -> DispatchStats:
        return DispatchStats(**{f: c.value
                                for f, c in self._counters.items()})

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()

    def __eq__(self, other):
        if isinstance(other, (DispatchStats, _DispatchStatsView)):
            return all(getattr(self, f) == getattr(other, f)
                       for f in _STAT_FIELDS)
        return NotImplemented

    def __repr__(self):
        return repr(self.snapshot()).replace("DispatchStats",
                                             "DispatchStatsView", 1)


DISPATCH_STATS = _DispatchStatsView()


class StatsWindow:
    """Scoped delta reader over :data:`DISPATCH_STATS` (the counters are
    process-global, so assertions compare against a baseline)."""

    def __init__(self, view: _DispatchStatsView):
        self._view = view
        self.start = view.snapshot()

    def delta(self, field: str) -> int:
        return getattr(self._view, field) - getattr(self.start, field)

    def deltas(self) -> DispatchStats:
        now = self._view.snapshot()
        return DispatchStats(**{f: getattr(now, f) - getattr(self.start, f)
                                for f in _STAT_FIELDS})


class _StatsWindowCtx:
    __slots__ = ("_window",)

    def __enter__(self) -> StatsWindow:
        self._window = StatsWindow(DISPATCH_STATS)
        return self._window

    def __exit__(self, *a):
        return False


def dispatch_stats_window() -> _StatsWindowCtx:
    """``with dispatch_stats_window() as w: ...; w.delta("disk_hit")``."""
    return _StatsWindowCtx()


# Observed-time hooks: callables
#   hook(program, n_elems, dtype_name, seconds, n_items)
# invoked after a __call__ / call_batch whose outputs were waited for, so
# ``seconds`` is wall time including execution on the device.
_OBSERVED_HOOKS: list = []


def push_observed_time_hook(hook) -> None:
    _OBSERVED_HOOKS.append(hook)


def pop_observed_time_hook(hook) -> None:
    _OBSERVED_HOOKS.remove(hook)


# Cost-aware warm bucketing: re-negotiate a warm bucket when the cached
# geometry's modeled time at the actual n_elems drifts more than this
# fraction from the best geometry for that size.
REBUCKET_DRIFT = 0.10
# Per-bucket bound on remembered already-checked sizes.
_CHECKED_MAX = 64


class _WarmEntry:
    """One warm-dispatch bucket: geometry + the drift anchor."""

    __slots__ = ("block_rows", "block_cols", "anchor_n", "anchor_t",
                 "checked")

    def __init__(self, block_rows: int, block_cols: int,
                 anchor_n: int, anchor_t: float):
        self.block_rows = block_rows
        self.block_cols = block_cols
        self.anchor_n = anchor_n
        self.anchor_t = anchor_t
        self.checked: dict = {}

    def mark_checked(self, n: int) -> None:
        if len(self.checked) >= _CHECKED_MAX:
            self.checked.pop(next(iter(self.checked)))
        self.checked[n] = True


# (program identity, n_elems, dtype, model fp, budget, n_buffers)
#   -> (block_rows, block_cols, StreamConfig, seconds) | ("no-fit", message)
# Bounded FIFO.
_GEOMETRY_CACHE: dict = {}
_GEOMETRY_CACHE_MAX = 4096
# Per-Program launch-closure cache bound.
_EXE_CACHE_MAX = 64
# Per-Program warm-dispatch table bound.
_DISPATCH_CACHE_MAX = 256


def reset_dispatch_stats() -> None:
    DISPATCH_STATS.reset()


def clear_dispatch_caches() -> None:
    """Drop every warm dispatch cache: the shared geometry cache, the
    registry's memoised FusedPrograms, and the per-instance tables of the
    Programs those kept alive."""
    _GEOMETRY_CACHE.clear()
    from . import isa as _isa          # deferred: isa imports us lazily
    for fused in _isa.registry._fuse_cache.values():
        fused.program._dispatch_cache.clear()
        fused.program._exe_cache.clear()
    _isa.registry._fuse_cache.clear()


def _n_bucket(n: int) -> int:
    """Warm-dispatch size bucket: next power of two."""
    n = int(n)
    return 1 << max(0, n - 1).bit_length()


# Identity tokens for models without a fingerprint(): weak-keyed so a
# token lives exactly as long as its model.
_MODEL_TOKENS = weakref.WeakKeyDictionary()
_MODEL_PIN: dict = {}
_MODEL_COUNTER = itertools.count().__next__


def _model_fingerprint(model) -> tuple:
    """Hashable identity of the memory model's predictions: the model's
    value ``fingerprint()``, else a per-object token."""
    fp = getattr(model, "fingerprint", None)
    if fp is not None:
        return fp()
    try:
        tok = _MODEL_TOKENS.get(model)
        if tok is None:
            tok = _MODEL_COUNTER()
            _MODEL_TOKENS[model] = tok
    except TypeError:                   # unhashable/unweakrefable model
        key = id(model)
        pinned = _MODEL_PIN.get(key)
        if pinned is None or pinned[0] is not model:
            pinned = (model, _MODEL_COUNTER())
            _MODEL_PIN[key] = pinned    # strong ref: id can't recycle
        tok = pinned[1]
    return ("token", tok)


def _cache_geometry(key, value) -> None:
    if len(_GEOMETRY_CACHE) >= _GEOMETRY_CACHE_MAX:
        _GEOMETRY_CACHE.pop(next(iter(_GEOMETRY_CACHE)))
    _GEOMETRY_CACHE[key] = value


# -- drift-triggered re-negotiation -----------------------------------------
# Pending (program identity, n_elems bucket, dtype name) cells whose
# chronic modeled-vs-observed drift asked for a fresh geometry sweep;
# consumed by the next _resolve_geometry on that cell.
_RENEGOTIATE: set = set()


def request_renegotiation(identity, bucket: int, dtype_name: str) -> None:
    """Ask the next dispatch of ``(identity, bucket, dtype)`` to re-run
    its geometry sweep from scratch — memo and disk consult skipped,
    warm bucket and cached sweeps purged. Idempotent until consumed;
    consumption is counted in ``DISPATCH_STATS.drift_renegotiated``."""
    _RENEGOTIATE.add((identity, int(bucket), str(dtype_name)))


def _purge_geometry(identity, bucket: int, dtype_name: str) -> None:
    stale = [k for k in _GEOMETRY_CACHE
             if k[0] == identity and _n_bucket(k[1]) == bucket
             and k[2] == dtype_name]
    for k in stale:
        _GEOMETRY_CACHE.pop(k, None)


def _scalar_table(rows: Sequence[Sequence[Any]],
                  device: torch.device) -> torch.Tensor:
    """The ``(k_items, m)`` float32 scalar table K1 reads, on ``device``.

    Scalar operands are host values (numbers, or one-element arrays or
    tensors). For a CUDA device the table is built in pinned host memory
    (PyTorch's caching host allocator) and copied asynchronously: a
    pageable source can make the copy wait for the device, which would
    put a host sync on every call."""
    k, m = len(rows), len(rows[0])
    if m == 0:
        return torch.empty((k, 0), dtype=torch.float32, device=device)
    table = torch.tensor([[float(s) for s in row] for row in rows],
                         dtype=torch.float32,
                         pin_memory=device.type == "cuda")
    if device.type != "cpu":
        table = table.to(device, non_blocking=True)
    return table


# -- persistent geometry artifacts ------------------------------------------
# Payload of one "geom" disk entry: the memo value serialised flat, in
# the JAX package's format.

def _geometry_payload(value) -> dict:
    if value[0] == "no-fit":
        return {"no_fit": str(value[1])}
    br, bc, cfg, t = value
    return {"block_rows": int(br), "block_cols": int(bc),
            "vlen_bits": int(cfg.vlen_bits),
            "block_bits": int(cfg.block_bits),
            "n_buffers": cfg.n_buffers, "time_s": float(t)}


def _geometry_from_payload(payload):
    """Decode + validate one disk payload back to the memo value; None
    marks the entry stale."""
    if not isinstance(payload, dict):
        return None
    if "no_fit" in payload:
        return ("no-fit", str(payload["no_fit"]))
    try:
        br, bc = int(payload["block_rows"]), int(payload["block_cols"])
        cfg = StreamConfig(vlen_bits=int(payload["vlen_bits"]),
                           block_bits=int(payload["block_bits"]),
                           n_buffers=payload["n_buffers"])
        t = float(payload["time_s"])
    except (KeyError, TypeError, ValueError):
        return None
    if br < 1 or bc < 1 or bc % LANES:
        return None
    return (br, bc, cfg, t)


def _stage_identity(st: Stage) -> tuple:
    # The JAX package's identity tuple, field for field: plan-cache keys
    # of the two packages are byte-equal for the same chain.
    return (st.name, st.n_scalar_in, st.n_vec_in, st.n_vec_out,
            st.block_rows, st.block_cols, st.carry_cols,
            dtype_name(st.carry_dtype), st.carry_init,
            st.out_shapes is None)


class Program:
    """A chain of Stages compiled to one K1 launch.

    Parameters
    ----------
    stages: the per-instruction Stages, in dataflow order.
    name:   display name ("c0_scale+c0_add").
    model:  :class:`BurstModel` or memhier ``Hierarchy`` used to
            negotiate the fused block size.
    smem_budget: on-chip bytes one thread block may pin for its resident
            operand tiles (the paper's BRAM capacity).
    n_buffers: pipelining depth of the tile loads; each resident operand
            tile is held ``ceil(n_buffers)`` times.
    """

    def __init__(self, stages: Sequence[Stage], name: Optional[str] = None,
                 model=H100_HBM,
                 smem_budget: int = SMEM_BYTES,
                 n_buffers: float = 2):
        stages = tuple(stages)
        if not stages:
            raise ValueError("a Program needs at least one stage")
        self.stages = stages
        self.name = name or "+".join(st.name for st in stages)
        self.model = model
        self.smem_budget = smem_budget
        self.n_buffers = n_buffers
        # structural identity: the shared geometry-cache key component.
        self._identity = tuple(_stage_identity(st) for st in stages)
        self._dispatch_cache: dict = {}   # warm __call__ geometry table
        self._exe_cache: dict = {}        # operand signature -> launch
        self._model_fp: Optional[tuple] = None   # (model, fingerprint) memo

        # -- chain validation (raises at fuse() time) ----------------------
        self._n_chained = [0]
        self._n_ext = [stages[0].n_vec_in]
        for prev, st in zip(stages, stages[1:]):
            if not prev.shape_preserving:
                raise ValueError(
                    f"{self.name}: stage {prev.name!r} has shape-changing "
                    f"outputs and cannot feed a chained stage")
            if prev.n_vec_out > st.n_vec_in:
                raise ValueError(
                    f"{self.name}: stage {prev.name!r} produces "
                    f"{prev.n_vec_out} vector outputs but {st.name!r} "
                    f"accepts only {st.n_vec_in} vector inputs")
            self._n_chained.append(prev.n_vec_out)
            self._n_ext.append(st.n_vec_in - prev.n_vec_out)
        if len(stages) > 1 and not stages[-1].shape_preserving:
            raise ValueError(
                f"{self.name}: shape-changing final stage "
                f"{stages[-1].name!r} is only supported in single-stage "
                f"programs")

    # -- merged operand list ------------------------------------------------
    @property
    def n_scalar_in(self) -> int:
        return sum(st.n_scalar_in for st in self.stages)

    @property
    def n_ext_vec_in(self) -> int:
        return sum(self._n_ext)

    @property
    def n_vec_out(self) -> int:
        return self.stages[-1].n_vec_out

    @property
    def n_intermediates(self) -> int:
        return sum(st.n_vec_out for st in self.stages[:-1])

    @property
    def n_inputs(self) -> int:
        return self.n_scalar_in + self.n_ext_vec_in

    def pipeline_depth(self) -> int:
        """Chained latency: column steps before the first block lands."""
        return sum(st.pipeline_depth() for st in self.stages)

    def _current_model_fp(self) -> tuple:
        memo = self._model_fp
        if memo is not None and memo[0] is self.model:
            return memo[1]
        fp = _model_fingerprint(self.model)
        self._model_fp = (self.model, fp)
        return fp

    def split_operands(self, operands):
        """User-order flat operands → per-stage (scalars, ext_vectors)."""
        if len(operands) != self.n_inputs:
            raise TypeError(
                f"{self.name}: expected {self.n_inputs} operands "
                f"({self.n_scalar_in} scalar + {self.n_ext_vec_in} vector, "
                f"per-stage order), got {len(operands)}")
        out, i = [], 0
        for st, ne in zip(self.stages, self._n_ext):
            sc = tuple(operands[i:i + st.n_scalar_in])
            i += st.n_scalar_in
            ext = tuple(operands[i:i + ne])
            i += ne
            out.append((sc, ext))
        return out

    # -- cost model (roofline inputs) ---------------------------------------
    def flops(self, n_elems: int) -> float:
        return float(n_elems) * sum(st.cost_flops_per_elem
                                    for st in self.stages)

    def hbm_bytes_fused(self, n_elems: int, dtype) -> int:
        """HBM traffic of THIS program: externals + final outputs only."""
        return (self.n_ext_vec_in + self.n_vec_out) * n_elems * _bits(dtype) // 8

    def hbm_bytes_unfused(self, n_elems: int, dtype) -> int:
        """HBM traffic of the same chain as N separate launches."""
        per_elem = sum(st.n_vec_in + st.n_vec_out for st in self.stages)
        return per_elem * n_elems * _bits(dtype) // 8

    # -- geometry negotiation ----------------------------------------------
    def negotiate_geometry(self, n_elems: int, dtype):
        """Pick one (block_rows, block_cols) for the whole fused region.

        block_rows is the lcm of the stage row granularities; block_cols
        is the candidate minimising the model's time for the program's
        streamed bytes among those whose resident tiles fit the budget.
        Memoised, and persisted through an active plan cache.
        Returns (block_rows, block_cols, StreamConfig).
        """
        return self._negotiate_scored(n_elems, dtype)[:3]

    def negotiated_time(self, n_elems: int, dtype) -> float:
        """Modeled seconds of one launch at the negotiated geometry —
        the scheduling runtime's model seed (:mod:`repro_torch.sched.
        cost`). Shares the negotiation memo."""
        return self._negotiate_scored(n_elems, dtype)[3]

    def _score_geometry(self, n_elems: int, dtype, block_rows: int,
                        block_cols: int) -> float:
        """Modeled seconds of ONE candidate geometry at ``n_elems``:
        the burst law, or the hierarchy simulation of the candidate."""
        if not isinstance(self.model, BurstModel):
            # deferred: memhier imports core.stream
            from repro_torch.memhier.predict import predict_program
            return predict_program(self.model, self, n_elems, dtype,
                                   block_rows=block_rows,
                                   block_cols=block_cols,
                                   n_buffers=self.n_buffers).time_s
        bits = _bits(dtype)
        block_elems = block_rows * block_cols
        n_io = self.n_ext_vec_in + self.n_vec_out
        padded = round_up(max(n_elems, 1), block_elems)
        return n_io * self.model.time_for(padded * bits / 8,
                                          block_elems * bits / 8)

    def _negotiate_scored(self, n_elems: int, dtype, fresh: bool = False):
        """The negotiation loop; returns (block_rows, block_cols,
        StreamConfig, modeled seconds of the winner). ``fresh`` skips
        the memo and the disk consult."""
        model_fp = self._current_model_fp()
        key = (self._identity, int(n_elems), dtype_name(dtype),
               model_fp, self.smem_budget,
               self.n_buffers)
        hit = None if fresh else _GEOMETRY_CACHE.get(key)
        if hit is not None:
            DISPATCH_STATS.geometry_hits += 1
            if hit[0] == "no-fit":
                raise ValueError(hit[1])
            return hit
        _tr = _trace.ACTIVE
        _sp = (_tr.start_span("negotiate", program=self.name,
                              n_elems=int(n_elems),
                              dtype=dtype_name(dtype),
                              bucket=_n_bucket(n_elems),
                              fingerprint=_artifact.key_hash(key))
               if _tr is not None else None)
        disk = _artifact.plan_cache()
        if disk is not None and not _artifact.persistable_fingerprint(model_fp):
            disk = None
        if disk is not None and not fresh:
            loaded = disk.load("geom", key, decode=_geometry_from_payload)
            if loaded is not None:
                DISPATCH_STATS.geometry_hits += 1
                _cache_geometry(key, loaded)
                if _sp is not None:
                    _tr.finish(_sp, outcome="disk_hit",
                               no_fit=loaded[0] == "no-fit")
                if loaded[0] == "no-fit":
                    raise ValueError(loaded[1])
                return loaded
        DISPATCH_STATS.geometry_misses += 1
        block_rows = 1
        for st in self.stages:
            block_rows = math.lcm(block_rows, st.block_rows)
        bits = _bits(dtype)
        # resident per step: external ins + outs + intermediates and carries
        n_resident = (self.n_ext_vec_in + self.n_vec_out
                      + self.n_intermediates
                      + sum(1 for st in self.stages if st.carry_cols))

        candidates = sorted(set(_BLOCK_COL_CANDIDATES)
                            | {st.block_cols for st in self.stages})
        best = None
        for bc in candidates:
            block_elems = block_rows * bc
            cfg = StreamConfig(vlen_bits=LANES * bits,
                               block_bits=block_elems * bits,
                               n_buffers=self.n_buffers)
            try:
                cfg.check_smem_budget(n_resident, budget=self.smem_budget)
            except ValueError:
                continue
            t = self._score_geometry(n_elems, dtype, block_rows, bc)
            if best is None or t < best[0]:
                best = (t, bc, cfg)
        if best is None:
            msg = (f"{self.name}: no block geometry fits {n_resident} "
                   f"resident operands in the {self.smem_budget}-byte "
                   f"shared-memory budget")
            verdict = ("no-fit", msg)
            _cache_geometry(key, verdict)
            if disk is not None:
                disk.store("geom", key, _geometry_payload(verdict))
            if _sp is not None:
                _tr.finish(_sp, outcome="sweep", no_fit=True)
            raise ValueError(msg)
        t, bc, cfg = best
        result = (block_rows, bc, cfg, t)
        _cache_geometry(key, result)
        if disk is not None:
            disk.store("geom", key, _geometry_payload(result))
        if _sp is not None:
            _tr.finish(_sp, outcome="sweep", block=[block_rows, bc],
                       modeled_s=t)
        return result

    # -- launch ---------------------------------------------------------------
    def call_blocks(self, *operands, block_rows: Optional[int] = None,
                    block_cols: Optional[int] = None,
                    interpret: bool = False):
        """Launch on pre-normalised 2D operands (the strict template path).

        Vector operands must already be (rows, cols) with rows/cols
        divisible by the block geometry; defaults to the stages' declared
        geometry. ``interpret`` runs K1's plain PyTorch emulator instead
        of K1.
        """
        stages = self.stages
        last = stages[-1]
        if block_rows is None:
            block_rows = max(st.block_rows for st in stages)
        if block_cols is None:
            block_cols = max(st.block_cols for st in stages)

        per_stage = self.split_operands(operands)
        scalars = tuple(s for sc, _ in per_stage for s in sc)
        vectors = tuple(v for _, ext in per_stage for v in ext)
        for v in vectors:
            if v.ndim != 2:
                raise ValueError(f"{self.name}: vector operands must be 2D "
                                 f"(rows, cols); got shape {tuple(v.shape)}")
        rows, cols = vectors[0].shape
        if len(stages) > 1:
            for v in vectors[1:]:
                if v.shape != (rows, cols):
                    raise ValueError(
                        f"{self.name}: fused operands must agree on shape; "
                        f"got {tuple(v.shape)} vs {(rows, cols)}")
        if rows % block_rows or cols % block_cols:
            raise ValueError(
                f"{self.name}: operand shape {(rows, cols)} not divisible by "
                f"block ({block_rows}, {block_cols}); pad upstream")
        out_specs = self._out_specs(vectors, block_cols)

        table = _scalar_table([scalars], vectors[0].device)
        items_div = max(1, rows // block_rows)      # one scalar row: all
        sig = (block_rows, block_cols, bool(interpret),
               tuple(table.shape), vectors[0].device.type,
               tuple((tuple(v.shape), dtype_name(v.dtype)) for v in vectors),
               out_specs)
        launch = self._exe_cache.get(sig)
        if launch is None:
            DISPATCH_STATS.call_builds += 1
            with _trace.span("pallas_build", program=self.name,
                             block=[block_rows, block_cols],
                             interpret=bool(interpret)):
                launch = self._build_call(vectors, block_rows, block_cols,
                                          interpret, out_specs=out_specs)
            if len(self._exe_cache) >= _EXE_CACHE_MAX:
                self._exe_cache.pop(next(iter(self._exe_cache)))
            self._exe_cache[sig] = launch
        outs = launch(table, vectors, items_div)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def call_flat(self, *operands, block_rows: int, block_cols: int,
                  interpret: bool = False):
        """Launch once on vector operands of any one shape and dtype, as
        they lie (the entry path under :meth:`__call__` and the c0
        instructions).

        Each operand is flattened (a view where it is contiguous) and
        walked as ⌈n / (block_rows·block_cols)⌉ row blocks of
        ``block_cols``-element rows — the layout the reference pads it to
        (``flatten_to_blocks``) — with the tail past its ``n`` elements
        masked: a load there reads 0, the pad's zeros, and a store is
        dropped, so nothing is padded and every output holds exactly
        ``n`` elements, returned in the operands' shape. A shape-changing
        program's outputs are written whole in that layout (each
        ``block_cols · out_cols / cols`` columns a step, :meth:`_out_specs`
        on the padded shape) and, as the reference's entry path returns
        them, cut to their first ``n`` elements in the operands' shape.
        ``interpret`` runs the same walk in PyTorch
        (:func:`~repro_torch.core.fused_kernel.emulate_items` on one
        item)."""
        per_stage = self.split_operands(operands)
        vecs = self._check_vectors(per_stage)
        scalars = tuple(s for sc, _ in per_stage for s in sc)
        v0 = vecs[0]
        flat = [v.reshape(-1).contiguous() for v in vecs]
        table = _scalar_table([scalars], v0.device)
        n = v0.numel()
        blocks = -(-n // (block_rows * block_cols))
        out_specs = None
        if not self.stages[-1].shape_preserving:
            padded = torch.empty((max(1, blocks) * block_rows, block_cols),
                                 dtype=v0.dtype, device="meta")
            out_specs = self._out_specs([padded] * len(flat), block_cols)
        sig = ("flat", block_rows, block_cols, bool(interpret),
               tuple(table.shape), v0.device.type, dtype_name(v0.dtype),
               len(flat), n)
        launch = self._exe_cache.get(sig)
        if launch is None:
            DISPATCH_STATS.call_builds += 1
            with _trace.span("pallas_build", program=self.name,
                             block=[block_rows, block_cols],
                             interpret=bool(interpret)):
                launch = self._build_call(flat, block_rows, block_cols,
                                          interpret, out_specs=out_specs,
                                          flat=True)
            if len(self._exe_cache) >= _EXE_CACHE_MAX:
                self._exe_cache.pop(next(iter(self._exe_cache)))
            self._exe_cache[sig] = launch
        outs = tuple(o.reshape(-1)[:n].reshape(v0.shape)
                     for o in launch(table, flat, max(1, blocks)))
        return outs[0] if len(outs) == 1 else outs

    def call_items(self, scalar_rows: Sequence[Sequence[Any]],
                   items: Sequence[Sequence[torch.Tensor]], *,
                   block_rows: int, block_cols: int,
                   interpret: bool = False) -> list[list[torch.Tensor]]:
        """Launch once over the items of a batch where they lie (the
        coalesced path below :meth:`call_batch`).

        ``items[k]`` holds item k's external vector operands in program
        order, all of one shape and dtype; ``scalar_rows`` is one row of
        scalar operands shared by every item, or one row per item. Item k
        runs as ``⌈n / (block_rows·block_cols)⌉`` row blocks of
        ``block_cols``-element rows, the layout of a solo call, with the
        tail past its ``n`` elements masked. Returns item k's outputs, new
        flat tensors of ``n`` elements. ``interpret`` runs the plain
        PyTorch version (:func:`~repro_torch.core.fused_kernel.
        emulate_items`)."""
        if not all(st.shape_preserving for st in self.stages):
            raise ValueError(
                f"{self.name}: shape-changing programs cannot be "
                f"batch-coalesced (per-item output shapes differ)")
        v0 = items[0][0]
        device = v0.device
        table = _scalar_table(list(scalar_rows), device)
        blocks_per_item = -(-v0.numel() // (block_rows * block_cols))
        # items_div: row blocks per scalar row (the whole grid when shared)
        items_div = (blocks_per_item if len(scalar_rows) > 1
                     else max(1, len(items) * blocks_per_item))
        sig = ("items", block_rows, block_cols, bool(interpret),
               len(scalar_rows) > 1, tuple(table.shape[1:]), device.type,
               dtype_name(v0.dtype), len(items[0]))
        launch = self._exe_cache.get(sig)
        if launch is None:
            DISPATCH_STATS.call_builds += 1
            with _trace.span("pallas_build", program=self.name,
                             block=[block_rows, block_cols],
                             interpret=bool(interpret)):
                launch = self._build_call([t for it in items for t in it],
                                          block_rows, block_cols, interpret,
                                          batch=True)
            if len(self._exe_cache) >= _EXE_CACHE_MAX:
                self._exe_cache.pop(next(iter(self._exe_cache)))
            self._exe_cache[sig] = launch
        return launch(table, items, items_div)

    def _out_specs(self, vectors, block_cols: int):
        """The outputs of a :meth:`call_blocks` launch as ``((shape,
        dtype name), ...)``: the input's for a shape-preserving program,
        else the last stage's ``out_shapes(*vectors)`` (objects with
        ``.shape`` and ``.dtype``, a ``device="meta"`` tensor serves).
        Output ``j`` keeps the rows and scales the columns: its block is
        ``(block_rows, block_cols · out_cols_j / cols)`` at the same grid
        index, which must be a whole number of columns."""
        last = self.stages[-1]
        rows, cols = vectors[0].shape
        if last.out_shapes is None:
            spec = (tuple(vectors[0].shape), dtype_name(vectors[0].dtype))
            return (spec,) * last.n_vec_out
        outs = tuple(last.out_shapes(*vectors))
        if len(outs) != last.n_vec_out:
            raise ValueError(f"{self.name}: out_shapes gave {len(outs)} "
                             f"outputs, declared {last.n_vec_out}")
        specs = []
        for o in outs:
            shape = tuple(int(d) for d in o.shape)
            if len(shape) != 2 or shape[0] != rows:
                raise ValueError(
                    f"{self.name}: a shape-changing output keeps the "
                    f"input's {rows} rows; got shape {shape}")
            if (block_cols * shape[1]) % cols:
                raise ValueError(
                    f"{self.name}: output width {shape[1]} gives a column "
                    f"block of {block_cols * shape[1] / cols} for input "
                    f"width {cols} at block {block_cols}; it must be whole")
            specs.append((shape, dtype_name(o.dtype)))
        return tuple(specs)

    def _build_call(self, vectors, block_rows, block_cols, interpret,
                    batch: bool = False, out_specs=None, flat: bool = False):
        """The launch closure for one operand signature (the cold half of
        :meth:`call_blocks`, :meth:`call_flat` and :meth:`call_items`):
        K1, or its plain PyTorch emulator; with ``batch`` the per-item
        versions, with ``flat`` the masked walk of flat operands (the
        emulator's as one item). ``out_specs`` (solo launches) sizes the
        outputs."""
        stages, n_ext = self.stages, tuple(self._n_ext)
        if interpret:
            DISPATCH_STATS.kernel_traces += 1
            if batch:
                def launch(table, vecs, items_div):
                    return _fk.emulate_items(stages, n_ext, table, vecs,
                                             block_rows, block_cols,
                                             items_div)
            elif flat:
                def launch(table, vecs, items_div):
                    return _fk.emulate_items(stages, n_ext, table, [vecs],
                                             block_rows, block_cols,
                                             items_div, out_specs)[0]
            else:
                def launch(table, vecs, items_div):
                    return _fk.emulate(stages, n_ext, table, vecs,
                                       block_rows, block_cols, items_div,
                                       out_specs)
            return launch
        if self.stages[-1].shape_preserving:
            out_specs = None                # every output shaped as the inputs
        elif not batch:
            _fk.out_block_widths(out_specs, block_cols,
                                 block_cols if flat else vectors[0].shape[1])
        _fk.check_cuda(vectors)
        ragged = flat and vectors[0].numel() % (block_rows * block_cols) != 0
        kernel, fresh = _fk.K1.compile(stages, n_ext, batch, ragged)
        DISPATCH_STATS.kernel_traces += fresh
        n_out = self.n_vec_out
        if batch:
            def launch(table, vecs, items_div):
                return _fk.K1.launch_items(kernel, table, vecs, n_out,
                                           block_rows, block_cols, items_div)
        else:
            def launch(table, vecs, items_div):   # one scalar row: unused
                return _fk.K1(kernel, table, vecs, n_out, block_rows,
                              block_cols, out_specs)
        return launch

    def _check_vectors(self, per_stage):
        """Validate external vector operand consistency: torch tensors of
        identical shapes and dtypes. Returns them in program order."""
        flat_vecs = [v for _, ext in per_stage for v in ext]
        if not flat_vecs:
            raise TypeError(f"{self.name}: a program needs at least one "
                            f"vector operand")
        for v in flat_vecs:
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"{self.name}: vector operands must be "
                                f"torch tensors; got {type(v).__name__}")
        shape, dtype = flat_vecs[0].shape, flat_vecs[0].dtype
        for v in flat_vecs[1:]:
            if v.shape != shape:
                raise ValueError(
                    f"{self.name}: fused vector operands must agree on "
                    f"shape; got {tuple(v.shape)} vs {tuple(shape)}")
            if v.dtype != dtype:
                raise ValueError(
                    f"{self.name}: fused vector operands must share a "
                    f"dtype; got {v.dtype} vs {dtype}")
        return flat_vecs

    def check_vector_operands(self, operands):
        return self._check_vectors(self.split_operands(operands))

    # ------------------------------------------------------------------
    def _resolve_geometry(self, n: int, dtype) -> tuple[int, int]:
        """Warm-dispatch geometry for ``n`` elements: the per-instance
        bucket table, with the cost-aware drift check. A pending drift
        re-negotiation request for this cell is consumed here."""
        dkey = (_n_bucket(n), dtype_name(dtype),
                self._current_model_fp(), self.smem_budget,
                self.n_buffers)
        entry = self._dispatch_cache.get(dkey)
        fresh = False
        if _RENEGOTIATE:
            rkey = (self._identity, _n_bucket(n), dtype_name(dtype))
            if rkey in _RENEGOTIATE:
                _RENEGOTIATE.discard(rkey)
                DISPATCH_STATS.drift_renegotiated += 1
                _purge_geometry(*rkey)
                self._dispatch_cache.pop(dkey, None)
                entry, fresh = None, True
        if entry is None:
            br, bc, _, t = self._negotiate_scored(n, dtype, fresh=fresh)
            if len(self._dispatch_cache) >= _DISPATCH_CACHE_MAX:
                self._dispatch_cache.pop(next(iter(self._dispatch_cache)))
            entry = _WarmEntry(br, bc, n, t)
            self._dispatch_cache[dkey] = entry
        elif n != entry.anchor_n and n not in entry.checked:
            self._maybe_rebucket(entry, n, dtype)
        return entry.block_rows, entry.block_cols

    def _maybe_rebucket(self, entry: _WarmEntry, n: int, dtype) -> None:
        t_cached = self._score_geometry(n, dtype, entry.block_rows,
                                        entry.block_cols)
        band = 1.0 + REBUCKET_DRIFT
        allowed = band * entry.anchor_t * (n / entry.anchor_n)
        if t_cached <= allowed:
            entry.mark_checked(n)
            return
        br, bc, _, t_best = self._negotiate_scored(n, dtype)
        if t_cached > band * t_best:
            entry.block_rows, entry.block_cols = br, bc
            entry.anchor_n, entry.anchor_t = n, t_best
            entry.checked.clear()
            DISPATCH_STATS.rebucketed += 1
        else:
            entry.anchor_n, entry.anchor_t = n, t_cached
            entry.mark_checked(n)

    def _notify_observed(self, outs, n: int, dtype, t0: float,
                         n_items: int) -> None:
        flat = [o for r in outs for o in (r if isinstance(r, tuple) else (r,))]
        for dev in {o.device for o in flat if o.is_cuda}:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        for hook in list(_OBSERVED_HOOKS):
            hook(self, n, dtype_name(dtype), dt, n_items)

    def __call__(self, *operands, interpret: bool = False):
        """The shared streaming entry path: negotiate the fused geometry
        for arbitrary-shaped vector operands and launch once on them as
        they lie (:meth:`call_flat`: the tail past ``n`` masked, nothing
        padded). Returns the caller's shapes."""
        t0 = time.perf_counter() if _OBSERVED_HOOKS else None
        per_stage = self.split_operands(operands)
        flat_vecs = self._check_vectors(per_stage)
        ref_v = flat_vecs[0]
        n = ref_v.numel()

        with _trace.span("dispatch", program=self.name, n_elems=int(n),
                         dtype=dtype_name(ref_v.dtype),
                         bucket=_n_bucket(n), n_items=1) as _sp:
            block_rows, block_cols = self._resolve_geometry(n, ref_v.dtype)
            if _sp is not None:
                _sp.attrs["block"] = [block_rows, block_cols]
            result = self.call_flat(*operands, block_rows=block_rows,
                                    block_cols=block_cols,
                                    interpret=interpret)
        if t0 is not None:
            self._notify_observed([result], n, ref_v.dtype, t0, 1)
        return result

    # ------------------------------------------------------------------
    def call_batch(self, batch: Sequence[Sequence[Any]], *,
                   interpret: bool = False):
        """Coalesced dispatch: N same-structure requests, ONE launch.

        Items must agree on scalar operand shapes/dtypes and on vector
        shapes/dtype, and every stage must be shape-preserving. One launch
        (:meth:`call_items`) reads and writes every item where it lies:
        each item runs as the row blocks a solo :meth:`__call__` would
        give it, its tail past ``n`` masked where a solo call pads with
        zeros, so per-item results are bit-identical to N solo calls
        (blocks never straddle an item boundary; carried state is per row
        block in both paths). Nothing is stacked or padded; an item that
        is not contiguous or not 16-byte aligned is copied alone
        (``K1.item_copies``). Scalar values may differ between items:
        then every scalar slot becomes one column of a ``(k_items, m)``
        table and each row block reads its item's row
        (``DISPATCH_STATS.batch_mixed``). Returns per-item results, each
        a tensor of its own.
        """
        batch = [tuple(ops) for ops in batch]
        if not batch:
            return []
        if not all(st.shape_preserving for st in self.stages):
            raise ValueError(
                f"{self.name}: shape-changing programs cannot be "
                f"batch-coalesced (per-item output shapes differ)")
        if len(batch) == 1:
            return [self(*batch[0], interpret=interpret)]
        t0 = time.perf_counter() if _OBSERVED_HOOKS else None

        items = [self.split_operands(ops) for ops in batch]
        ref_vecs = [self._check_vectors(per) for per in items]
        shape = ref_vecs[0][0].shape
        dtype = ref_vecs[0][0].dtype
        scalars0 = [_host(s) for sc, _ in items[0] for s in sc]
        mixed = False
        for k, per in enumerate(items[1:], start=1):
            if ref_vecs[k][0].shape != shape:
                raise ValueError(
                    f"{self.name}: batched items must agree on vector "
                    f"shape; item {k} has {tuple(ref_vecs[k][0].shape)} "
                    f"vs {tuple(shape)}")
            if ref_vecs[k][0].dtype != dtype:
                raise ValueError(
                    f"{self.name}: batched items must share a dtype")
            sc_k = [_host(s) for sc, _ in per for s in sc]
            for a, b in zip(scalars0, sc_k):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"{self.name}: batched items must agree on "
                        f"scalar operand shapes/dtypes (item {k} "
                        f"differs)")
                if not np.array_equal(a, b):
                    mixed = True

        n = ref_vecs[0][0].numel()
        k_items = len(batch)
        with _trace.span("dispatch", program=self.name, n_elems=int(n),
                         dtype=dtype_name(dtype), bucket=_n_bucket(n),
                         n_items=k_items) as _sp:
            block_rows, block_cols = self._resolve_geometry(n, dtype)
            if _sp is not None:
                _sp.attrs["block"] = [block_rows, block_cols]
            # scalars in program order: item 0's when all items agree,
            # else one row per item (the mixed-scalar table)
            rows = ([[s for sc, _ in per for s in sc] for per in items]
                    if mixed else [[s for sc, _ in items[0] for s in sc]])
            outs = self.call_items(rows, ref_vecs, block_rows=block_rows,
                                   block_cols=block_cols,
                                   interpret=interpret)
        results = []
        for per_out in outs:
            per_out = tuple(o.view(shape) for o in per_out)
            results.append(per_out[0] if len(per_out) == 1 else per_out)
        DISPATCH_STATS.batch_calls += 1
        DISPATCH_STATS.batch_items += k_items
        if mixed:
            DISPATCH_STATS.batch_mixed += 1
        if t0 is not None:
            self._notify_observed(results, n, dtype, t0, k_items)
        return results


def _host(s) -> np.ndarray:
    """A scalar operand as a host array, for the batch equality check."""
    if isinstance(s, torch.Tensor):
        return s.detach().cpu().numpy()
    return np.asarray(s)

"""Request queue + admission for the predictive scheduling runtime.

Callers submit work items — ``(program_or_plan_or_callable, operands,
deadline?)`` plus tenant/weight metadata — through
:meth:`RequestQueue.submit`. Admission validates the operand list
against the target's merged P'-type arity *at submit time* (a malformed
request is the submitter's bug, not something a lane should discover
mid-schedule), stamps a monotone sequence number (the deterministic
tie-break every policy falls back to) and computes the request's
**coalesce key**.

Coalescing (DESIGN.md §13): requests running the SAME structural program
with scalar operands of the SAME dtypes on vectors of the SAME
shape/dtype form one batch — scalar *values* may differ, since
:meth:`repro_torch.core.program.Program.call_batch` puts mixed scalars in
a per-item table each row block reads. That is exactly the precondition
for ``call_batch`` to run them as ONE ``k1_batch_kernel`` launch on the
items where they lie, sharing one warm dispatch (geometry fingerprints
and the dispatch caches of DESIGN.md §12), so a popped batch costs one
launch instead of N. Plans, shape-changing programs, and arbitrary
callables never coalesce — they batch as singletons.

Observability (DESIGN.md §15): with a tracer active, ``submit`` opens
the per-request root span (``request``, carried on
:attr:`WorkItem.span` and finished by the scheduler at completion)
with an ``admission`` child, and ``pop_ready`` emits one ``coalesce``
span per formed batch, parented to the batch's first member. Queue
depth at every pop is recorded in the
``repro_sched_queue_depth`` histogram.

SLO feedback (DESIGN.md §19): construct with
``RequestQueue(admission=SloShedder(monitor))`` and every submit first
consults the hook — a tenant whose :class:`repro_torch.obs.slo.Slo` is
burning on both windows has its new arrivals shed (never enqueued,
counted in ``repro_sched_shed_total``) or deprioritised (weight scaled
down for the WFQ policy). See :class:`repro_torch.obs.slo.SloShedder`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import math

import torch

from repro_torch.core.isa import FusedProgram
from repro_torch.core.program import Program, _host
from repro_torch.core.stream import dtype_name
from repro_torch.graph.plan import Plan
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# Queue-depth histogram: item counts, so buckets are small integers.
QUEUE_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                       256.0, 512.0, 1024.0)
_QUEUE_DEPTH = _metrics.REGISTRY.histogram(
    "repro_sched_queue_depth",
    help="pending items at each pop_ready drain",
    buckets=QUEUE_DEPTH_BUCKETS)
_SUBMITS = _metrics.REGISTRY.counter(
    "repro_sched_submits_total", help="admitted work items")


def _shed_total(tenant: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_sched_shed_total",
        help="arrivals rejected by the SLO admission hook",
        labels={"tenant": tenant})


def _deprioritised_total(tenant: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_sched_deprioritised_total",
        help="arrivals weight-scaled by the SLO admission hook",
        labels={"tenant": tenant})


def program_of(target) -> Optional[Program]:
    """The underlying fused Program of a target, or None."""
    if isinstance(target, FusedProgram):
        return target.program
    if isinstance(target, Program):
        return target
    return None


def coalesce_key(target, operands) -> Optional[tuple]:
    """Hashable batch key, or None when the request cannot coalesce.

    The key is (structural program identity, scalar operand dtypes,
    vector shape, dtype): two requests with equal keys are guaranteed
    safe to run as one :meth:`Program.call_batch` launch with
    bit-identical per-item results. Scalar *values* are deliberately
    absent — ``call_batch`` puts differing values in a per-item scalar
    table (scalar-batched coalescing, DESIGN.md §13), so e.g.
    ``scale(2.0, x)`` and ``scale(3.0, y)`` share a batch. Scalar and
    vector dtypes are named as numpy names them (``"float64"`` for a
    Python float, ``"float32"``), so the key's ``repr`` equals the JAX
    package's for the same request.
    """
    prog = program_of(target)
    if prog is None:
        return None
    if not all(st.shape_preserving for st in prog.stages):
        return None
    try:
        per = prog.split_operands(operands)
    except TypeError:
        return None                      # admission reports the arity error
    scal = []
    for sc, _ in per:
        for s in sc:
            a = _host(s)
            if a.size != 1:
                return None              # non-scalar "scalar": don't merge
            scal.append(a.dtype.name)
    vecs = [v for _, ext in per for v in ext]
    if not vecs or not all(isinstance(v, torch.Tensor) for v in vecs):
        return None
    shape = tuple(vecs[0].shape)
    dt = dtype_name(vecs[0].dtype)
    for v in vecs[1:]:
        if tuple(v.shape) != shape or dtype_name(v.dtype) != dt:
            return None
    return (prog._identity, tuple(scal), shape, dt)


@dataclasses.dataclass
class WorkItem:
    """One admitted request plus its runtime bookkeeping."""

    seq: int
    target: Any
    operands: tuple
    deadline: Optional[float]            # runtime-clock seconds
    arrival: float
    tenant: str = "default"
    weight: float = 1.0
    mode: Optional[str] = None           # dispatch-mode override
    cost_key: Optional[tuple] = None     # explicit EWMA key (callables)
    key: Optional[tuple] = None          # coalesce key (None = singleton)
    # configured-region identity (repro_torch.regions); lazily filled by the
    # scheduler via region_key_of, preset by replay() from the trace.
    region_key: Optional[tuple] = None
    # filled by the scheduler:
    result: Any = None
    predicted_s: Optional[float] = None
    observed_s: Optional[float] = None
    lane: Optional[int] = None
    start: Optional[float] = None
    finish: Optional[float] = None
    # root "request" span (repro_torch.obs.trace), None when tracing is off;
    # opened at submit, finished by the scheduler at completion.
    span: Any = None
    # True when the SLO admission hook rejected this arrival: the item
    # was never enqueued and will never be scheduled (DESIGN.md §19).
    shed: bool = False

    @property
    def n_elems(self) -> Optional[int]:
        prog = program_of(self.target)
        if prog is not None:
            per = prog.split_operands(self.operands)
            for _, ext in per:
                for v in ext:
                    return math.prod(v.shape)
        if isinstance(self.target, Plan):
            return self.target.n_elems
        return None


@dataclasses.dataclass
class Batch:
    """A popped schedulable group: ≥ 1 items sharing one coalesce key
    (``key=None`` groups are always singletons)."""

    items: list
    key: Optional[tuple]

    @property
    def target(self):
        return self.items[0].target

    @property
    def seq(self) -> int:
        return self.items[0].seq

    @property
    def coalesced(self) -> bool:
        return self.key is not None and len(self.items) > 1

    @property
    def tenant(self) -> str:
        return self.items[0].tenant

    @property
    def weight(self) -> float:
        return sum(it.weight for it in self.items)

    @property
    def deadline(self) -> Optional[float]:
        ds = [it.deadline for it in self.items if it.deadline is not None]
        return min(ds) if ds else None

    @property
    def arrival(self) -> float:
        return min(it.arrival for it in self.items)


class RequestQueue:
    """Admission-validated FIFO of pending work items.

    ``admission`` is the optional SLO feedback hook (DESIGN.md §19,
    normally a :class:`repro_torch.obs.slo.SloShedder`): an object whose
    ``admit(tenant, now) -> "accept" | "shed" | "deprioritise"`` is
    consulted once per submit with the item's arrival time.  ``shed``
    rejects the arrival before it queues (the returned
    :class:`WorkItem` has :attr:`WorkItem.shed` set and is NOT
    pending); ``deprioritise`` admits it with
    ``weight × admission.weight_factor`` so the weighted-fair policy
    starves it gracefully instead.  Off (``None``) by default —
    ``serve.py --slo-shed`` wires it up.
    """

    def __init__(self, admission=None):
        self._seq = itertools.count()
        self.pending: list[WorkItem] = []
        self.admission = admission

    def __len__(self) -> int:
        return len(self.pending)

    def __bool__(self) -> bool:
        return bool(self.pending)

    def _admit(self, target, operands) -> None:
        prog = program_of(target)
        if prog is not None:
            prog.split_operands(operands)        # raises TypeError w/ arity
            prog.check_vector_operands(operands)  # shape/dtype agreement
            return
        if isinstance(target, Plan):
            free = target.graph.free_inputs()
            if len(operands) != len(free):
                raise TypeError(
                    f"{target.graph.name}: plan expects {len(free)} "
                    f"operands, got {len(operands)}")
            return
        if not callable(target):
            raise TypeError(
                f"unsupported work target {type(target).__name__}: expected "
                f"a FusedProgram, Program, Plan, or callable")

    def submit(self, target, operands=(), *, deadline: Optional[float] = None,
               tenant: str = "default", weight: float = 1.0,
               arrival: float = 0.0, mode: Optional[str] = None,
               cost_key: Optional[tuple] = None) -> WorkItem:
        """Admit one request; raises TypeError/ValueError on a malformed
        operand list. ``arrival``/``deadline`` are runtime-clock seconds
        (the scheduler's virtual clock, or seconds since its wall epoch).
        """
        self._admit(target, operands)
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        seq = next(self._seq)
        weight = float(weight)
        verdict = ("accept" if self.admission is None
                   else self.admission.admit(tenant=tenant,
                                             now=float(arrival)))
        tr = _trace.ACTIVE
        root = None
        if tr is not None:
            root = tr.start_span("request", parent=None, seq=seq,
                                 tenant=tenant, arrival=float(arrival),
                                 deadline=deadline)
        if verdict == "shed":
            # rejected before queueing: the root span is finished
            # immediately (no blame inputs, so critical.attribute skips
            # it) and the item never becomes pending
            _shed_total(tenant).inc()
            if tr is not None and root is not None:
                tr.finish(root, shed=True)
            return WorkItem(seq=seq, target=target,
                            operands=tuple(operands), deadline=deadline,
                            arrival=float(arrival), tenant=tenant,
                            weight=weight, mode=mode, cost_key=cost_key,
                            key=None, span=root, shed=True)
        if verdict == "deprioritise":
            _deprioritised_total(tenant).inc()
            weight *= getattr(self.admission, "weight_factor", 0.25)
            if root is not None:
                root.attrs["deprioritised"] = True
        with (_trace.NULL_SPAN if tr is None
              else tr.span("admission", parent=root, seq=seq)) as adm:
            key = coalesce_key(target, operands)
            if adm is not None:
                adm.attrs["coalesce_key"] = (None if key is None
                                             else repr(key))
        item = WorkItem(seq=seq, target=target,
                        operands=tuple(operands), deadline=deadline,
                        arrival=float(arrival), tenant=tenant,
                        weight=weight, mode=mode, cost_key=cost_key,
                        key=key, span=root)
        self.pending.append(item)
        _SUBMITS.inc()
        return item

    def next_arrival(self, after: float) -> Optional[float]:
        """Earliest pending arrival strictly later than ``after``."""
        later = [it.arrival for it in self.pending if it.arrival > after]
        return min(later) if later else None

    def pop_ready(self, now: Optional[float] = None) -> list[Batch]:
        """Drain every arrived item, grouped into coalesced batches.

        Groups keep submission order (a batch sorts at its earliest
        member's seq) so policies tie-break deterministically.
        """
        _QUEUE_DEPTH.observe(len(self.pending))
        if now is None:
            take, keep = self.pending, []
        else:
            take = [it for it in self.pending if it.arrival <= now]
            keep = [it for it in self.pending if it.arrival > now]
        self.pending = keep
        groups: dict[Any, Batch] = {}
        order: list[Batch] = []
        for it in take:
            gk = it.key if it.key is not None else ("solo", it.seq)
            b = groups.get(gk)
            if b is None:
                b = Batch(items=[], key=it.key)
                groups[gk] = b
                order.append(b)
            b.items.append(it)
        tr = _trace.ACTIVE
        if tr is not None:
            for b in order:
                with tr.span("coalesce", parent=b.items[0].span,
                             batch_seq=b.seq, n_items=len(b.items),
                             coalesced=b.coalesced,
                             members=[it.seq for it in b.items]):
                    pass
        return order

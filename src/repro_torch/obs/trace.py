"""Structured spans over the request lifecycle and the model's path.

The PyTorch port's copy of ``repro/obs/trace.py``.  Span names and
attributes are the reference's, so exports from either package read the
same: ``pallas_build`` keeps its name although the port's cold build
generates and compiles a Triton kernel.

Span taxonomy (parent ← child)::

    request                     one submitted WorkItem, root
    ├── admission               arity validation + coalesce key
    ├── coalesce                batch formation (parented to the batch's
    │                           first member; attrs name the rest)
    └── placement               one lane dispatch by the scheduler
        └── dispatch            Program.__call__ / call_batch
            ├── negotiate       geometry sweep on memo miss
            │                   (outcome: disk_hit | sweep)
            ├── pallas_build    cold build of the fused kernel (K1)
            └── part            one Plan part (graph plans only)

The model's path (``models/model.py``, ``models/ssm.py``) and the
trainer (``launch/api.py``), in the port only::

    model.prefill               models.model.prefill: embed, the layers,
    │                           the final norm and the last logits, root
    ├── model.layer             one block of a forward or prefill
    │   │                       (attr ``layer``)
    │   └── ssm.ssd             ssm.ssd_forward, the SSD mixer's forward
    │       └── ssm.intra       its chunk output: g and the chunk-output
    │                           kernel after K4, or the eager intra-chunk
    │                           chain
    └── model.head              the final norm and the LM head (logits;
                                in training the CE and z-loss too)
    step.forward                make_grad_fn: the loss (model.layer …,
                                model.head), root
    step.backward               make_grad_fn: autograd.grad, root
    ├── model.layer.recompute   remat's recompute of one block (attr
    │                           ``layer``; ssm.ssd … inside)
    ├── ssm.ssd.backward        the SSD mixer's backward
    └── model.head.backward     the LM head's backward
    step.clip                   make_train_step: the global-norm clip
    step.update                 make_train_step: the optimizer's update

Tracing is **opt-in and near-zero when off**: the module global
:data:`ACTIVE` is ``None`` by default and every instrumentation site
collapses to two reads, :data:`ACTIVE` and the profiler's flag;
:func:`span` then returns the singleton :data:`NULL_SPAN` no-op context
manager.  While ``torch.profiler`` records, every span is also a
``record_function`` range of its name, on the profiler's clock beside
the device work launched inside it; spans that open in the backward
(:func:`open_span`, :class:`BackwardSpan`) are ranges on the thread
that runs the backward.

Determinism: a :class:`Tracer` built on :class:`VirtualClock` assigns
sequential span ids and synthetic timestamps, so
:meth:`Tracer.export_jsonl` is byte-stable across identical runs.
:meth:`Tracer.export_chrome` emits Chrome-trace/Perfetto JSON
(``traceEvents`` with complete ``"X"`` events, µs timestamps).
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler


class Span:
    """One timed operation.  ``attrs`` is a plain dict the owning site
    may mutate until :meth:`Tracer.finish`."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "attrs",
                 "sampled")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 start: float, attrs: Dict[str, Any], sampled: bool = True):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs
        self.sampled = sampled

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "attrs": {k: _chromable(v) for k, v in self.attrs.items()},
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id})")


class VirtualClock:
    """Deterministic clock: each read advances by ``step``.  Pairing
    this with a fresh tracer makes exports byte-stable across runs."""

    def __init__(self, start: float = 0.0, step: float = 1e-6):
        self._t = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        t = self._t
        self._t += self.step
        return t


class _SpanCtx:
    """Context manager for one span: pushes onto the tracer's stack so
    nested instrumentation sites parent correctly."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        st = self._tracer._stack
        if st and st[-1] is self._span:
            st.pop()
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.finish(self._span)
        return False


class _UnderCtx:
    """Re-parents nested spans under an existing (still-open) span
    without finishing it on exit — the scheduler uses this to hang
    placement/dispatch work off a request's root span."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        st = self._tracer._stack
        if st and st[-1] is self._span:
            st.pop()
        return False


class _NullSpan:
    """Singleton no-op stand-in used when tracing is disabled.  Enters
    to ``None`` so call sites guard attribute writes with
    ``if sp is not None``."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


NULL_SPAN = _NullSpan()

_CURRENT = object()  # sentinel: parent = top of stack


class Tracer:
    """Collects spans with parent/child links.

    ``clock`` defaults to ``time.perf_counter``; pass a
    :class:`VirtualClock` for byte-stable exports.  Span ids are
    sequential from 1 in creation order.  ``max_spans`` bounds memory;
    overflow increments :attr:`dropped` instead of growing.

    ``sample_rate`` enables head-based per-request sampling so tracing
    can stay on under sustained traffic: the keep/drop decision is made
    once per ROOT span (a request) and inherited by every descendant,
    so kept requests keep their *whole* span tree — unlike ``max_spans``
    overflow, which truncates the tail of the run.  The decision is a
    deterministic credit accumulator (no RNG): at rate ``r`` exactly
    every ``1/r``-th root is kept, starting with the first, so tests
    and replays see stable output.  Unsampled spans are never stored
    (they cost one branch + counter); :attr:`unsampled` counts them.
    """

    def __init__(self, clock=None, max_spans: int = 1_000_000,
                 sample_rate: float = 1.0):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0, 1], got "
                             f"{sample_rate}")
        self.clock = clock or time.perf_counter
        self.max_spans = max_spans
        self.sample_rate = float(sample_rate)
        self.spans: List[Span] = []
        self.dropped = 0
        self.unsampled = 0
        #: callbacks fired once per sampled ROOT span, at its first
        #: finish — the attach point for tail-based sampling
        #: (:class:`repro_torch.obs.tail.TailSampler`), which
        #: must see the whole tree only after its outcome is known.
        self.root_listeners: List = []
        self._stack: List[Span] = []
        self._next_id = 1
        # first root always sampled (when rate > 0): start one credit
        # short of the keep threshold
        self._credit = 1.0 - self.sample_rate

    # -- recording ---------------------------------------------------
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def start_span(self, name: str, parent=_CURRENT, **attrs) -> Span:
        """Create an open span.  ``parent``: the sentinel default means
        "current top of stack"; pass ``None`` for an explicit root or a
        :class:`Span` for an explicit parent."""
        if parent is _CURRENT:
            parent = self.current()
        if isinstance(parent, Span):
            pid, sampled = parent.span_id, parent.sampled
        else:
            pid, sampled = None, self._sample_root()
        if not sampled:
            self.unsampled += 1
            return Span(name, 0, pid, self.clock(), attrs, sampled=False)
        sp = Span(name, self._next_id, pid, self.clock(), attrs)
        self._next_id += 1
        if len(self.spans) < self.max_spans:
            self.spans.append(sp)
        else:
            self.dropped += 1
        return sp

    def _sample_root(self) -> bool:
        """Head-based keep/drop for a new root (see class docstring)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        self._credit += self.sample_rate
        if self._credit >= 1.0 - 1e-12:
            self._credit -= 1.0
            return True
        return False

    def finish(self, span: Span, **attrs):
        if attrs:
            span.attrs.update(attrs)
        first = span.end is None
        if first:
            span.end = self.clock()
        if (first and span.parent_id is None and span.sampled
                and self.root_listeners):
            for cb in list(self.root_listeners):
                cb(span)

    def span(self, name: str, parent=_CURRENT, **attrs) -> _SpanCtx:
        """``with tracer.span("negotiate", ...) as sp:`` — starts,
        stacks, and finishes a span around the body."""
        return _SpanCtx(self, self.start_span(name, parent=parent, **attrs))

    def under(self, span: Span) -> _UnderCtx:
        return _UnderCtx(self, span)

    # -- queries (tests / reports) ----------------------------------
    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def subtree_names(self, root: Span) -> List[str]:
        """Names of every span reachable from ``root`` (inclusive),
        in span-id order — the connectivity check for the one-request
        span-tree acceptance gate."""
        by_parent: Dict[Optional[int], List[Span]] = {}
        for s in self.spans:
            by_parent.setdefault(s.parent_id, []).append(s)
        out, todo = [], [root]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(by_parent.get(s.span_id, ()))
        return [s.name for s in sorted(out, key=lambda s: s.span_id)]

    # -- exports -----------------------------------------------------
    def export_jsonl(self) -> str:
        """One sorted-key JSON object per line, span-id order.
        Byte-stable for a given (clock, workload) pair."""
        return "".join(
            json.dumps(s.to_dict(), sort_keys=True,
                       separators=(",", ":")) + "\n"
            for s in sorted(self.spans, key=lambda s: s.span_id))

    def export_chrome(self, process_name: str = "repro") -> str:
        """Chrome-trace / Perfetto JSON: complete ``"X"`` events with
        microsecond timestamps; span ids/parents ride in ``args``."""
        t0 = min((s.start for s in self.spans), default=0.0)
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 1,
            "args": {"name": process_name},
        }]
        for s in sorted(self.spans, key=lambda s: s.span_id):
            end = s.end if s.end is not None else s.start
            args = {"span_id": s.span_id, "parent_id": s.parent_id}
            args.update({k: _chromable(v) for k, v in s.attrs.items()})
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": round((s.start - t0) * 1e6, 3),
                "dur": round(max(end - s.start, 0.0) * 1e6, 3),
                "pid": 1,
                "tid": int(s.attrs.get("lane", 0)) + 1,
                "args": args,
            })
        return json.dumps({"traceEvents": events,
                           "displayTimeUnit": "ms"}, sort_keys=True)


def _chromable(v):
    """Attrs down to JSON scalars: numpy 0-d values unwrap, anything
    else non-JSON falls back to its repr (exports must never throw)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_chromable(x) for x in v]
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        try:
            return _chromable(v.item())
        except (TypeError, ValueError):  # pragma: no cover - exotic dtypes
            pass
    return repr(v)


# ---------------------------------------------------------------------------
# process-global activation
# ---------------------------------------------------------------------------

#: The active tracer, or ``None`` (tracing off).  Instrumentation sites
#: read this once per operation.
ACTIVE: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with ``None``) the process tracer; returns
    the previous one."""
    global ACTIVE
    prev, ACTIVE = ACTIVE, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return ACTIVE


class _UsingTracer:
    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self) -> Optional[Tracer]:
        self._prev = set_tracer(self._tracer)
        return self._tracer

    def __exit__(self, *a):
        set_tracer(self._prev)
        return False


def using_tracer(tracer: Optional[Tracer]) -> _UsingTracer:
    """``with using_tracer(Tracer()) as tr: ...`` — scoped activation
    with restore (tests, benches)."""
    return _UsingTracer(tracer)


class _Profiled:
    """A span's body as a ``torch.profiler`` range of the span's name,
    around the active tracer's span (or :data:`NULL_SPAN`)."""

    __slots__ = ("_range", "_inner")

    def __init__(self, name: str, inner):
        self._range = _profiler.record_function(name)
        self._inner = inner

    def __enter__(self):
        self._range.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)


def span(name: str, parent=_CURRENT, **attrs):
    """Module-level helper: a span on the active tracer, also a
    ``record_function`` range while the profiler records, or
    :data:`NULL_SPAN` when neither is on.  The no-op path costs two
    global reads plus kwargs packing."""
    tr = ACTIVE
    if tr is None:
        if not _profiler._is_profiler_enabled:
            return NULL_SPAN
        return _Profiled(name, NULL_SPAN)
    sp = tr.span(name, parent=parent, **attrs)
    return _Profiled(name, sp) if _profiler._is_profiler_enabled else sp


class OpenSpan:
    """A span opened in one place and closed in another
    (:func:`open_span`): the active tracer's span, not stacked, so spans
    opened meanwhile keep their parents, and the profiler's range."""

    __slots__ = ("_tracer", "span", "_range")

    def __init__(self, name: str, attrs: dict):
        self._tracer = ACTIVE
        self.span = (None if self._tracer is None
                     else self._tracer.start_span(name, **attrs))
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(name)
            self._range.__enter__()

    def close(self) -> None:
        """Finish the span and end the range; a second call does
        nothing."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.span is not None:
            self._tracer.finish(self.span)
            self.span = None


def open_span(name: str, **attrs) -> Optional[OpenSpan]:
    """An :class:`OpenSpan`, or None when neither a tracer nor the
    profiler is on (the same two reads as :func:`span`)."""
    if ACTIVE is None and not _profiler._is_profiler_enabled:
        return None
    return OpenSpan(name, attrs)


class BackwardSpan:
    """A span over the backward of a region of the forward, by gradient
    hooks on its tensors: :meth:`enter` hooks the region's input, whose
    gradient is complete once the region's backward has run, to close
    the span, and :meth:`leave` its output, whose gradient arrives
    before the region's backward runs, to open it (:func:`open_span`).
    A hook adds no node: the autograd graph is the one built without
    the span."""

    __slots__ = ("name", "attrs", "opened", "_entered")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.opened: Optional[OpenSpan] = None
        self._entered = False

    def _open(self, grad):
        self.opened = open_span(self.name, **self.attrs)

    def _close(self, grad):
        if self.opened is not None:
            self.opened.close()
            self.opened = None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad:
            x.register_hook(self._close)
            self._entered = True
        return x

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` hooked to open the span; not where :meth:`enter` hooked
        nothing, so no span is left open."""
        if self._entered and y.requires_grad:
            y.register_hook(self._open)
        return y


def backward_span(name: str, **attrs) -> Optional[BackwardSpan]:
    """A :class:`BackwardSpan`, or None when neither a tracer nor the
    profiler is on or grad is off: with tracing off the forward hooks no
    tensor."""
    if ACTIVE is None and not _profiler._is_profiler_enabled:
        return None
    return BackwardSpan(name, attrs) if torch.is_grad_enabled() else None

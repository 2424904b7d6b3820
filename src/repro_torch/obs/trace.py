"""Structured spans over the request lifecycle.

The PyTorch port's copy of ``repro/obs/trace.py`` (stdlib only).  Span
names and attributes are the reference's, so exports from either
package read the same: ``pallas_build`` keeps its name although the
port's cold build generates and compiles a Triton kernel.

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


Tracing is **opt-in and near-zero when off**: the module global
:data:`ACTIVE` is ``None`` by default and every instrumentation site
collapses to one global read; :func:`span` returns the singleton
:data:`NULL_SPAN` no-op context manager.

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

    def export_otlp_json(self, service_name: str = "repro",
                         scope_name: str = "repro.obs") -> str:
        """OTLP/JSON (OpenTelemetry ``ExportTraceServiceRequest`` shape):
        one resourceSpans → scopeSpans → spans list, ready to POST to an
        OTLP/HTTP collector's ``/v1/traces`` or load into any OTel
        tooling.

        The span model maps directly: each root span starts a *trace*,
        so every span's ``traceId`` is its root ancestor's id (zero-pad
        hex, 16 bytes), ``spanId``/``parentSpanId`` are the internal
        sequential ids (8 bytes), timestamps become unix-epoch
        nanosecond strings (the clock's zero is the epoch — wall spans
        are relative to process start, virtual spans to t=0), and attrs
        become typed OTLP attribute values.  Byte-stable under a
        :class:`VirtualClock`, like the other exports.
        """
        roots: Dict[int, int] = {}
        by_id = {s.span_id: s for s in self.spans}
        for s in sorted(self.spans, key=lambda s: s.span_id):
            p = by_id.get(s.parent_id) if s.parent_id is not None else None
            roots[s.span_id] = (roots[p.span_id] if p is not None
                                else s.span_id)
        out = []
        for s in sorted(self.spans, key=lambda s: s.span_id):
            end = s.end if s.end is not None else s.start
            attrs = [{"key": k, "value": _otlp_value(v)}
                     for k, v in sorted(s.attrs.items())]
            out.append({
                "traceId": f"{roots[s.span_id]:032x}",
                "spanId": f"{s.span_id:016x}",
                "parentSpanId": ("" if s.parent_id is None
                                 else f"{s.parent_id:016x}"),
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(round(s.start * 1e9))),
                "endTimeUnixNano": str(int(round(end * 1e9))),
                "attributes": attrs,
            })
        doc = {"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": service_name},
            }]},
            "scopeSpans": [{
                "scope": {"name": scope_name},
                "spans": out,
            }],
        }]}
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _otlp_value(v) -> dict:
    """One attr as an OTLP ``AnyValue``: typed when the type maps
    (bool/int must be tested in that order — bool is an int subclass),
    everything else through :func:`_chromable` then stringified."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP int64s ride as strings
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_otlp_value(x) for x in v]}}
    c = _chromable(v)
    if type(c) is not type(v):
        return _otlp_value(c)
    return {"stringValue": repr(v)}  # pragma: no cover - defensive


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


def span(name: str, parent=_CURRENT, **attrs):
    """Module-level helper: a span on the active tracer, or
    :data:`NULL_SPAN` when tracing is off.  The no-op path costs one
    global read plus kwargs packing."""
    tr = ACTIVE
    if tr is None:
        return NULL_SPAN
    return tr.span(name, parent=parent, **attrs)

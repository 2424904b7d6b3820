"""Metrics registry: counters, gauges, and fixed-bucket histograms.

The PyTorch port's copy of ``repro/obs/metrics.py`` (stdlib only; the
port imports nothing of the JAX package).  Exposition text and JSON
snapshots are byte-identical to the reference for the same events, so
dashboards read either package.  One process-global :data:`REGISTRY`
backs every metric in the port — including the ``DISPATCH_STATS``
counters in ``repro_torch/core/program.py``, a thin attribute view over
``repro_dispatch_*_total`` counters registered here.  Metric names
follow the Prometheus convention::

    repro_<subsystem>_<what>[_<unit>][_total]

e.g. ``repro_dispatch_geometry_misses_total`` (counter),
``repro_sched_latency_seconds`` (histogram, labelled by tenant),
``repro_sched_queue_depth`` (histogram).

Design constraints, in order:

* **near-zero hot-path overhead** — a counter increment is one Python
  attribute add on a ``__slots__`` object; no locks, no allocation.
  The stack is single-threaded per process (the scheduler dispatches
  serially per round), so increments are not synchronised; the HTTP
  exposition thread (:func:`start_http_server`) only *reads*, and a torn
  read of a monotonically increasing int is harmless.
* **exact exposition** — ``expose_text()`` emits the Prometheus text
  format (``# HELP``/``# TYPE``, cumulative ``_bucket{le=...}``
  lines); ``snapshot()`` emits a JSON-able dict with the same numbers.
  Both are byte-stable for a given registry state (sorted families,
  sorted label sets, ``repr``-stable floats).
* **fixed buckets** — histograms never resize; bucket edges are part
  of the metric's identity and a conflicting re-registration raises.
"""
from __future__ import annotations

import bisect
import json
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default histogram edges: latency-ish seconds, 100µs .. 10s.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name: {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v) -> str:
    """Prometheus sample-value formatting (ints without trailing .0)."""
    if isinstance(v, bool):  # pragma: no cover - defensive
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):  # pragma: no cover - defensive
        return "NaN"
    return repr(float(v))


def _labels_str(label_key: LabelKey, extra: Sequence[Tuple[str, str]] = ()):
    items = list(label_key) + list(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``set()`` exists only so the legacy
    ``DISPATCH_STATS.field += 1`` view (and ``reset``) can write through;
    new call sites should use :meth:`inc`."""

    kind = "counter"
    __slots__ = ("name", "help", "label_key", "_value")

    def __init__(self, name: str, help: str = "",
                 label_key: LabelKey = ()):
        self.name = name
        self.help = help
        self.label_key = label_key
        self._value = 0

    def inc(self, n=1):
        self._value += n

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self._value

    def reset(self):
        self._value = 0

    def sample_lines(self) -> List[str]:
        return [f"{self.name}{_labels_str(self.label_key)} "
                f"{_fmt(self._value)}"]

    def to_snapshot(self):
        return {"labels": dict(self.label_key), "value": self._value}


class Gauge(Counter):
    """Point-in-time value (queue length, cache size, ...)."""

    kind = "gauge"
    __slots__ = ()

    def dec(self, n=1):
        self._value -= n


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (inclusive upper
    bound) semantics plus an implicit ``+Inf`` overflow bucket."""

    kind = "histogram"
    __slots__ = ("name", "help", "label_key", "buckets", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, help: str = "", label_key: LabelKey = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError("histogram buckets must be sorted and unique")
        if math.isinf(edges[-1]):
            edges = edges[:-1]  # +Inf is implicit
        self.name = name
        self.help = help
        self.label_key = label_key
        self.buckets = edges
        self._counts = [0] * (len(edges) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float):
        self._counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def reset(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Upper bucket edge covering quantile ``q`` (Prometheus-style:
        resolution is the bucket grid, not the raw samples).  Returns
        ``nan`` when the histogram is empty or when EVERY sample landed
        in the +Inf overflow bucket — the grid carries no information
        in either case, and consumers (``to_snapshot`` p50/p99, drift
        thresholds) treat both identically.  A quantile that lands in
        the overflow bucket of a *mixed* histogram still returns
        ``inf``: some samples genuinely exceeded the grid."""
        if self._count == 0 or self._counts[-1] == self._count:
            return float("nan")
        target = q * self._count
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= target and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")  # pragma: no cover - defensive

    def sample_lines(self) -> List[str]:
        lines = []
        for edge, cum in zip(list(self.buckets) + [float("inf")],
                             self.cumulative()):
            le = "+Inf" if math.isinf(edge) else _fmt(edge)
            lines.append(f"{self.name}_bucket"
                         f"{_labels_str(self.label_key, [('le', le)])} "
                         f"{cum}")
        lines.append(f"{self.name}_sum{_labels_str(self.label_key)} "
                     f"{_fmt(self._sum)}")
        lines.append(f"{self.name}_count{_labels_str(self.label_key)} "
                     f"{self._count}")
        return lines

    def to_snapshot(self):
        return {
            "labels": dict(self.label_key),
            "count": self._count,
            "sum": self._sum,
            "buckets": [
                {"le": ("+Inf" if math.isinf(e) else e), "cumulative": c}
                for e, c in zip(list(self.buckets) + [float("inf")],
                                self.cumulative())
            ],
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry keyed on ``(name, sorted label items)``.

    Re-requesting an existing series returns the same object; requesting
    the same *name* with a different kind, help text, or bucket layout
    raises — metric identity is fixed for the process lifetime.
    """

    def __init__(self):
        self._series: Dict[Tuple[str, LabelKey], object] = {}
        self._families: Dict[str, Tuple[str, str, Optional[tuple]]] = {}

    # -- creation ----------------------------------------------------
    def _get(self, cls, name, help, labels, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name: {name!r}")
        lk = _label_key(labels)
        key = (name, lk)
        m = self._series.get(key)
        if m is not None:
            if type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            if buckets is not None and m.buckets != tuple(
                    float(b) for b in buckets if not math.isinf(b)):
                raise ValueError(
                    f"histogram {name!r} re-registered with different "
                    f"buckets")
            return m
        fam = self._families.get(name)
        if fam is not None and fam[0] != cls.kind:
            raise TypeError(
                f"metric family {name!r} already registered as {fam[0]}")
        if cls is Histogram:
            m = Histogram(name, help=help, label_key=lk,
                          buckets=buckets or DEFAULT_BUCKETS)
            if fam is not None and fam[2] != m.buckets:
                raise ValueError(
                    f"histogram {name!r} re-registered with different "
                    f"buckets")
            self._families.setdefault(name, (cls.kind, help, m.buckets))
        else:
            m = cls(name, help=help, label_key=lk)
            self._families.setdefault(name, (cls.kind, help, None))
        self._series[key] = m
        return m

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None,
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- introspection ----------------------------------------------
    def families(self):
        for name in sorted(self._families):
            kind, help, _ = self._families[name]
            series = sorted(
                (m for (n, _), m in self._series.items() if n == name),
                key=lambda m: m.label_key)
            yield name, kind, help, series

    def get(self, name, labels=None):
        return self._series.get((name, _label_key(labels)))

    def reset(self):
        """Zero every series in place (objects stay registered — live
        references held by call sites keep working)."""
        for m in self._series.values():
            m.reset()

    # -- exposition --------------------------------------------------
    def expose_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out = []
        for name, kind, help, series in self.families():
            if help:
                out.append(f"# HELP {name} {_escape_help(help)}")
            out.append(f"# TYPE {name} {kind}")
            for m in series:
                out.extend(m.sample_lines())
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """JSON-able snapshot mirroring :meth:`expose_text`."""
        fams = {}
        for name, kind, help, series in self.families():
            fams[name] = {
                "kind": kind,
                "help": help,
                "series": [m.to_snapshot() for m in series],
            }
        return fams

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=1)


#: The process-global registry.  Module-level metric objects across the
#: stack (dispatch counters, scheduler histograms) live here so one
#: ``expose_text()`` call sees everything.
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY


def start_http_server(port: int, registry: Optional[MetricsRegistry] = None,
                      host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` on a
    daemon thread.  Returns the ``ThreadingHTTPServer`` (call
    ``.shutdown()`` to stop).  Used by ``launch/serve.py --metrics``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/metrics", "/"):
                body = reg.expose_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = reg.snapshot_json().encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # keep stdout clean
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="repro-metrics")
    t.start()
    return server

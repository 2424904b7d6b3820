"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer readers take.

Device events (kernels, copies, fills; not the harness's spans, which
the profiler also draws on the device's timeline) give the busy time
(the union of their intervals), the time by kernel name and the idle
gaps between them. Each gap is named by what the host was doing in it:
the innermost host event (a span of the harness, or an operator of the
program) open at the gap's middle. Kinds of kernels are told apart by
words in their names (:data:`KINDS`, the kinds ``chip_smoke.py`` uses).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np

#: kind: a word its kernels' names hold (case-insensitive; the first kind
#: that matches wins, the rest is "other")
KINDS = (("K8", "k8_flash"), ("K7", "k7_topk"), ("K3", "k3_"), ("K4", "k4_"),
         ("matmul", "gemm"), ("matmul", "nvjet"), ("matmul", "xmma"),
         ("matmul", "cutlass"), ("index", "index"), ("cat", "CatArray"),
         ("elementwise", "elementwise"), ("reduce", "reduce"))
NAME_WIDTH = 160         # a kernel's name in the breakdown, cut to this


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, word in KINDS if word.lower() in low), "other")


@dataclasses.dataclass
class Trace:
    window_s: float                      # host seconds of the traced window
    kernels: list                        # (name, start ns, end ns)
    host: list                           # (name, start ns, end ns)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device event ran (their union)."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def seconds_by_name(self) -> dict:
        total: dict = {}
        for name, s, e in self.kernels:
            total[name] = total.get(name, 0.0) + (e - s) * 1e-9
        return total

    def seconds_by_kind(self) -> dict:
        out: dict = {}
        for name, t in self.seconds_by_name().items():
            k = kind_of(name)
            out[k] = out.get(k, 0.0) + t
        return out

    def kernel_seconds(self, word: str) -> tuple[float, int]:
        """(device seconds, count) of the kernels whose name holds
        ``word``."""
        hits = [(e - s) for name, s, e in self.kernels if word in name]
        return sum(hits) * 1e-9, len(hits)

    def idle_gaps(self, top: int = 10, examine: int = 400) -> list:
        """[[what the host was doing, idle seconds], ...]: the
        ``examine`` longest gaps between device events, named and summed
        by name, the ``top`` largest sums."""
        iv = self.busy_intervals()
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1], iv[i + 1][0])
                       for i in range(len(iv) - 1)), reverse=True)[:examine]
        if not gaps or not self.host:
            return []
        starts = np.array([h[1] for h in self.host], dtype=np.int64)
        ends = np.array([h[2] for h in self.host], dtype=np.int64)
        by: dict = {}
        for dur, s, e in gaps:
            mid = (s + e) // 2
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = ("(no host event)" if not len(open_) else
                    self.host[int(open_[np.argmax(starts[open_])])][0])
            by[name] = by.get(name, 0.0) + dur * 1e-9
        return [[n[:NAME_WIDTH], t] for n, t in
                sorted(by.items(), key=lambda it: -it[1])[:top]]

    def breakdown(self) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda it: -it[1])
        return {"device_ops": [[n[:NAME_WIDTH], t] for n, t in ops[:10]],
                "idle_gaps": self.idle_gaps()}


def _events(prof):
    """(device events, host events) as (name, start ns, end ns)."""
    from torch.autograd import DeviceType
    dev, host, spans = [], [], set()
    try:
        for e in prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() != DeviceType.CUDA:
                host.append(row)
                if e.is_user_annotation():
                    spans.add(row[0])
            elif not e.is_user_annotation():
                dev.append(row)
    except AttributeError:           # an older profiler: the parsed events
        for e in prof.events():
            row = (e.name, int(e.time_range.start * 1e3),
                   int(e.time_range.end * 1e3))
            (dev if e.device_type == DeviceType.CUDA else host).append(row)
    # a span of the harness is also drawn on the device's timeline: it is
    # no device work
    return [d for d in dev if d[0] not in spans], host


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the body when ``enabled``; on exit ``out["trace"]`` holds
    its :class:`Trace` (None when the profiler saw no device time)."""
    if not enabled:
        yield
        return
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    if not dev:
        print("torch.profiler saw no device time: the per-layer metrics "
              "of the trace are not measured", file=sys.stderr)
        out["trace"] = None
        return
    out["trace"] = Trace(window, dev, host)


def span(name: str):
    """A host span of the harness around a call into the program (a
    ``record_function`` range, which the profiler records)."""
    import torch
    return torch.profiler.record_function(name)

"""Device time by the program's own spans.

The program opens its spans (``repro_torch.obs.trace.span``) as
``record_function`` ranges while the profiler records, so they are host
events of the traced window (``Trace.host``), on the profiler's clock,
beside the CUDA calls that enqueue device work. The cell's device work
runs on one stream in launch order, so the i-th launch call of the
window (:data:`LAUNCHES`, by start) enqueued the i-th device event (by
start), and each device event is attributed to the spans open when its
launch call started.
"""
from __future__ import annotations

import sys
from collections import Counter

import numpy as np

#: the host calls that enqueue one device event each
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaMemcpyAsync", "cudaMemsetAsync"})


def _device_class(name: str) -> str:
    return next((c for c in ("Memcpy", "Memset") if name.startswith(c)),
                "kernel")


def paired(trace):
    """(launch start ns, device seconds) of each device event in start
    order, or None where the window's launch calls and device events do
    not pair one to one (both counts then go to standard error)."""
    if trace is None:
        return None
    calls = sorted(s for name, s, _ in trace.host if name in LAUNCHES)
    dev = sorted(trace.kernels, key=lambda k: k[1])
    if len(calls) != len(dev):
        by_call = Counter(h[0] for h in trace.host if h[0] in LAUNCHES)
        by_dev = Counter(_device_class(k[0]) for k in dev)
        print(f"spans: {len(calls)} launch calls {dict(by_call)} against "
              f"{len(dev)} device events {dict(by_dev)}: not paired",
              file=sys.stderr)
        return None
    return (np.array(calls, dtype=np.int64),
            np.array([(e - s) * 1e-9 for _, s, e in dev], dtype=np.float64))


def _union(intervals) -> np.ndarray:
    """The union of (start, end) intervals as sorted, disjoint rows."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def inside(trace, names, at: np.ndarray) -> np.ndarray:
    """Whether each time of ``at`` (ns) lies inside a host event named in
    ``names`` (its start and end included)."""
    iv = _union((s, e) for name, s, e in trace.host if name in names)
    i = np.searchsorted(iv[:, 0], at, side="right") - 1
    ok = i >= 0
    ok[ok] = at[ok] <= iv[i[ok], 1]
    return ok


def share(run, names):
    """100 × the device seconds of the events launched inside any span
    named in ``names`` (each event once) over the device seconds of
    every event; None without a trace, without such a span (a program
    that opens none) or without a one-to-one pairing."""
    names = set(names)
    if run.trace is None or not any(h[0] in names for h in run.trace.host):
        return None
    p = paired(run.trace)
    if p is None:
        return None
    starts, secs = p
    total = secs.sum()
    if not total:
        return None
    return 100.0 * secs[inside(run.trace, names, starts)].sum() / total

"""Chosen phases of a checkout's ``chip_smoke.py``, on the H100.

Imports ``chip_smoke.py`` from the checkout at TREE (this one by
default, or a parent commit unpacked with ``git archive``), runs the
named phases in order on one card with that checkout's own code, and
prints one JSON line: the card, the checks that failed, each kernel
row's device ms and the peak device memory. The phases print their own
lines as in the full script (E's app line, H's ``serve`` line, I's
``sched`` line). Two versions are compared in one call by running it
on each in turn (parent, change, change, parent):

    python3 experiments/smoke_phases.py [--tree DIR] [--phases a,c,e,h] [--k4-host]

With ``--k4-host`` it also prints the host µs a call of that checkout's
K4 forward entry and of c4_statescan's backward call at phase L's
states shape (:func:`k4_host_us`).

Needs the card and nvcc; every CUDA source is built first, one nvcc
each, as ``chip_smoke.py`` builds them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def k4_host_us(cs, dev, shape=(4, 16, 64, 64, 128), reps: int = 50) -> dict:
    """Host µs a call, and device ms, of the checkout's K4 forward entry
    (``K4.state_scan``) and of c4_statescan's backward call
    (``prefix_scan.state_scan_grad``) at ``shape``: ``reps`` calls are
    enqueued while a spin kernel holds the device, so the host clock
    reads the host's work alone (argument checks, allocations, the
    launches)."""
    import torch
    a, s = cs.ssd_inputs(cs.SEED + 31, shape[:3], shape[3:], dev)
    g = cs.ssd_inputs(cs.SEED + 32, shape[:3], shape[3:], dev)[1]
    y = cs.K4.state_scan(a, s, 1)
    calls = {"forward": lambda: cs.K4.state_scan(a, s, 1),
             "backward call": lambda: cs.ps.state_scan_grad(a, y, g, 1)}
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.2 * cs.GPU_CYCLES_PER_S))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        out[name] = {"host_us": host, "device_ms": cs.time_ms(fn)[0]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--phases", default="i")
    ap.add_argument("--k4-host", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cs._cuda.build_all()        # every CUDA source first, as the script
    check, rows = cs.Check(), []
    torch.cuda.reset_peak_memory_stats(dev)
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        getattr(cs, f"run_phase_{name}")(dev, check, rows)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    host = k4_host_us(cs, dev) if args.k4_host else None
    print(json.dumps({"tree": str(tree), "card": cs.CARD, "k4_host": host,
                      "failures": check.failures,
                      "ms": {r["name"]: r["ms"] for r in rows},
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}))
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Chosen phases of a checkout's ``chip_smoke.py``, on the H100.

Imports ``chip_smoke.py`` from the checkout at TREE (this one by
default, or a parent commit unpacked with ``git archive``), runs the
named phases in order on one card with that checkout's own code, and
prints one JSON line: the card, the checks that failed, each kernel
row's device ms and the peak device memory. The phases print their own
lines as in the full script (E's app line, H's ``serve`` line, I's
``sched`` line). Two versions are compared in one call by running it
on each in turn (parent, change, change, parent):

    python3 experiments/smoke_phases.py [--tree DIR] [--phases a,c,e,h]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--phases", default="i")
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
    print(json.dumps({"tree": str(tree), "card": cs.CARD,
                      "failures": check.failures,
                      "ms": {r["name"]: r["ms"] for r in rows},
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}))
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())

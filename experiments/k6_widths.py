"""K6 at every merge width the mergesort app runs, on the H100.

The app (``ops.sortnet_mergesort`` on 2²⁶ int32 keys in one row, phase E
of ``chip_smoke.py``) merges halves of w = 8, 16, …, 2048 keys: at each
level ``a`` and ``b`` are the two halves of every pair, views with row
stride 2w. For each w this builds those operands from sorted chunks of
w keys, holds K6 bit for bit against its plain version, and prints one
JSON line per width: K6's device ms (``chip_smoke.time_ms``), its byte
bound (each key read once and written once at 3.35 TB/s), the plain
version's ms and one ``torch.sort`` of the same 2w-key rows. Needs the
card and nvcc; run from the root of a checkout:

    python3 experiments/k6_widths.py [--src DIR]

``--src`` imports the port from another checkout's ``src`` (a parent
commit unpacked with ``git archive``), so two versions of K6 can be
timed in one call on one card; the timing helpers are this checkout's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 26
WIDTHS = tuple(8 << k for k in range(9))          # 8 … 2048


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import sortnet as sn
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("k6_widths: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    dev = torch.device("cuda", 0)
    v = smoke.sort_keys(smoke.SEED + 4, N, dev)
    ok = True
    for w in WIDTHS:
        x = torch.sort(v.view(-1, w)).values.view(-1, 2, w)
        a, b = x[:, 0], x[:, 1]
        lo, hi = sn.merge_sorted_kernel(a, b, width=w)
        plo, phi = sn.merge_sorted_plain(a, b, w)
        exact = torch.equal(lo, plo) and torch.equal(hi, phi)
        ok &= exact
        del lo, hi, plo, phi
        # a merge of 2w keys runs log2(2w) layers of one compare a key
        bound, by = smoke.bound_ms(2 * N * 4, (2 * w).bit_length() * N - N)
        print(json.dumps({
            "src": args.src, "w": w, "exact": exact,
            "ms": smoke.time_ms(lambda: sn.merge_sorted_kernel(
                a, b, width=w))[0],
            "bound_ms": bound, "bound_by": by,
            "plain_ms": smoke.time_ms(lambda: sn.merge_sorted_plain(
                a, b, w), reps=3)[0],
            "sort_ms": smoke.time_ms(lambda: torch.sort(
                x.view(-1, 2 * w)))[0]}), flush=True)
        del x, a, b
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

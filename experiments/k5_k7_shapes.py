"""K5 at each sort width and K7 at the MoE router's shapes, on the H100.

K5 sorts every chunk of one row of 2²⁶ keys (``chip_smoke.py`` phase E's
size): int32 at widths 2 … 4096 (the mergesort app's is 8), and float32
and bfloat16 at 64. K7 runs at Kimi-K2's router shapes (384 experts,
top-8, float32 logits; phase H): 4096 prefill rows and 4 decode rows,
both through ``ops.topk`` on the (rows, 384) logits as the router calls
it, and the kernel alone on rows already padded to 512. Each result is
held bit for bit against the plain network (K5) or the oracle on the
padded rows (K7), and printed as one JSON line: device ms
(``chip_smoke.time_ms``), the byte bound (each key read once, each
output written once, at 3.35 TB/s) and one library call on the same
inputs (``torch.sort``, ``torch.topk``). Needs the card and nvcc; run
from the root of a checkout:

    python3 experiments/k5_k7_shapes.py [--src DIR]

``--src`` imports the port from another checkout's ``src`` (a parent
commit unpacked with ``git archive``), so two versions can be timed in
one call on one card; the timing helpers are this checkout's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 26
K5_CASES = [("int32", 1 << k) for k in range(1, 13)] + [
    ("float32", 64), ("bfloat16", 64)]
K7_ROWS = (("prefill", 4096), ("decode", 4))
EXPERTS, NPOW, TOP_K = 384, 512, 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import sortnet as sn
    from repro_torch.kernels import topk as tk
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("k5_k7_shapes: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    dev = torch.device("cuda", 0)
    ok = True

    def emit(**row):
        print(json.dumps({"src": args.src, **row}), flush=True)

    v = smoke.sort_keys(smoke.SEED + 4, N, dev)[None]
    f32 = smoke.make_inputs(smoke.SEED + 5, [N], dev)[0][None]
    for dtype, w in K5_CASES:
        x = {"int32": v, "float32": f32,
             "bfloat16": f32.to(torch.bfloat16)}[dtype]
        got = sn.sort_chunks_kernel(x, width=w)
        exact = torch.equal(got, sn.sort_chunks_plain(x, w))
        ok &= exact
        del got
        bound, by = smoke.bound_ms(2 * x.numel() * x.element_size(),
                                   sn.n_cas_layers(w) * x.numel())
        emit(kernel="K5", dtype=dtype, w=w, exact=exact,
             ms=smoke.time_ms(lambda: sn.sort_chunks_kernel(x, width=w))[0],
             bound_ms=bound, bound_by=by,
             library_ms=smoke.time_ms(lambda: torch.sort(
                 x.view(-1, w)))[0])
    del v, f32

    rng = np.random.default_rng(smoke.SEED + 14)
    for case, rows in K7_ROWS:
        x = torch.from_numpy(rng.standard_normal(
            (rows, EXPERTS), dtype=np.float32)).to(dev)
        padded = torch.cat([x, x.new_full((rows, NPOW - EXPERTS),
                                          torch.finfo(x.dtype).min)], 1)
        want = ref.topk(padded, TOP_K)
        n_bytes = x.numel() * 4 + rows * TOP_K * 8
        for call, fn in (("ops.topk (rows of 384)",
                          lambda: ops.topk(x, TOP_K)),
                         ("K7 on rows padded to 512",
                          lambda: tk.K7(padded, TOP_K))):
            vals, idx = fn()
            exact = torch.equal(vals, want[0]) and torch.equal(idx, want[1])
            ok &= exact
            bound, by = smoke.bound_ms(n_bytes, x.numel())
            emit(kernel="K7", case=case, rows=rows, call=call, exact=exact,
                 ms=smoke.time_ms(fn)[0], bound_ms=bound, bound_by=by,
                 library_ms=smoke.time_ms(lambda: torch.topk(x, TOP_K))[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

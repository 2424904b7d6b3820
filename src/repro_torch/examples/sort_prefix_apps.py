"""The paper's two applications (§4.3) end-to-end: sort and prefix-sum a
large array with the custom SIMD instructions, vs their baselines —
plus a DAG-shaped streaming pipeline compiled by the repro_torch.graph
partitioner (branching + shared inputs, not just a hand-fused chain).

    PYTHONPATH=src python -m repro_torch.examples.sort_prefix_apps \\
        [--mib 16] [--device cpu]

The port of ``examples/sort_prefix_apps.py``. On the card the sort
launches K5 (c2_sort) and K6 (c1_merge), the prefix sum K3, and the
plan's parts K1; on the CPU the same steps run the kernels' plain
PyTorch versions. Each step is timed after a warm-up call (which builds
the kernel): with CUDA events on the card, with the host clock on the
CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.examples import kernel_mode, pick_device
from repro_torch.graph import partition
from repro_torch.kernels import ops
from repro_torch.memhier import H100


def timed(label, fn, *args):
    """``fn(*args)`` once to warm up, then once timed; prints and returns
    (output, seconds)."""
    fn(*args)                                  # build / compile
    if args[0].is_cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        dt = e0.elapsed_time(e1) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
    print(f"{label:32s} {dt*1e3:9.2f} ms")
    return out, dt


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mib", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = pick_device(args.device)
    mode = kernel_mode(device)
    n = args.mib * (1 << 20) // 4
    npow = 1 << (n.bit_length() - 1)
    rng = np.random.default_rng(0)

    print(f"== sorting {npow/1e6:.1f}M int32 keys (paper §4.3.1) ==")
    keys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, npow).astype(
        np.int32)).to(device)
    s1, t1 = timed("sortnet mergesort (c2+c1)",
                   lambda v: ops.sortnet_mergesort(
                       v[None], max_kernel_width=4096, mode=mode)[0], keys)
    s2, t2 = timed("base-core library sort", lambda v: torch.sort(v).values,
                   keys)
    if not torch.equal(s1, s2):
        raise AssertionError("sort mismatch!")
    print(f"   verified identical; ratio {t2/t1:.2f}x")

    print(f"== prefix sum over {npow/1e6:.1f}M floats (paper §4.3.2) ==")
    x = torch.from_numpy(rng.standard_normal(npow).astype(np.float32)).to(
        device)
    p1, t1 = timed("c3_prefixsum (HS + carry)",
                   lambda v: ops.prefix_sum(v[None], mode=mode)[0], x)
    p2, t2 = timed("base-core cumsum", lambda v: torch.cumsum(v, 0), x)
    err = float((p1 - p2).abs().max() / (p2.abs().max() + 1e-9))
    print(f"   rel err {err:.2e}; ratio {t2/t1:.2f}x")

    print("== DAG pipeline via the graph compiler (§6 exploration) ==")
    g = ops.c0_pipeline_graph("axpby_residual")
    plan = partition(g, model=H100, n_elems=npow)
    print(plan.describe())
    # the plain versions on the CPU: keep it small there
    n = npow if device.type == "cuda" else min(npow, 1 << 16)
    xa = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        device)
    ba = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        device)
    out, res = plan(xa, ba, 2.0, 0.5, mode=mode)
    ref_out, ref_res = plan.ref(xa, ba, 2.0, 0.5)
    if not (torch.allclose(out, ref_out, rtol=1e-6, atol=1e-6)
            and torch.allclose(res, ref_res, rtol=1e-6, atol=1e-6)):
        raise AssertionError("the plan differs from its ref oracle")
    t_plan = plan.predicted_time() * 1e6
    t_unf = partition(g, model=H100, n_elems=npow,
                      method="singletons").predicted_time() * 1e6
    print(f"   plan matches its ref oracle; memhier-predicted "
          f"{t_plan:.1f} us vs {t_unf:.1f} us unfused "
          f"({t_unf/t_plan:.2f}x)")
    return {"keys": keys, "sorted": s1, "library_sorted": s2,
            "x": x, "prefix": p1, "rel_err": err, "plan": plan,
            "plan_inputs": (xa, ba), "plan_outputs": (out, res)}


if __name__ == "__main__":
    main()

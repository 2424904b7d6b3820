#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Drives the port's main path — registered instructions, fused chains and
the coalesced batch path, all launching the generated Triton kernel K1
— at STREAM's size rule (every array ≥ 4× the 50 MB L2: 2²⁶ float32 =
256 MiB), holds K1 against its plain PyTorch emulator and the torch
oracles on the card, times it (CUDA events around each call while the
device is held busy, so the time is device time; and host wall time
per call), and prints one ``kernels`` JSON line and, last, the device
JSON line. Exits non-zero,
printing no result, when no CUDA device is visible or any phase fails.

Phases (float32, inputs from numpy with a fixed seed):
  A  c0_copy / c0_scale / c0_add / c0_triad solo at N = 2²⁶
  B  fuse(c0_scale, c0_add) and fuse(c0_scale, c0_add, c0_copy) at N = 2²⁶
  C  call_batch of 16 scale→add requests, 16 distinct scalars, N = 2²² each
  D  the carried c7_absmax_scale template (examples/quickstart.py) on a
     (4096, 16384) input

Tolerances (fixed before any run):
  * copy, scale, add: bit-exact against the emulator and the oracle;
  * multiply-add chains (triad, scale→add…): |Δ| ≤ 4·eps_f32·(|s·x| + |b|)
    elementwise — Triton contracts a·s + b into one FMA (one rounding),
    torch eager rounds twice;
  * every call_batch item: bit-identical to its solo K1 call;
  * c7_absmax_scale: ≤ 2 ulp — Triton's fp32 ``/`` lowers to
    ``div.full.f32`` (≤ 2 ulp), torch divides with IEEE rounding.

Generated kernel sources go to ``build/repro_torch/`` and Triton's cache
to ``build/triton/`` unless the environment names others.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                      str(ROOT / "build" / "repro_torch"))

import repro_torch.kernels  # noqa: E402,F401  (registers the c0 ISA)
from repro_torch.core import isa  # noqa: E402
from repro_torch.core import program as prog_mod  # noqa: E402
from repro_torch.core.fused_kernel import K1  # noqa: E402
from repro_torch.core.isa import Instruction, OperandSpec  # noqa: E402
from repro_torch.core.template import KernelTemplate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SEED = 0
N_STREAM = 1 << 26                 # 256 MiB per float32 array
N_ITEM, N_ITEMS = 1 << 22, 16      # phase C: 16 requests of 16 MiB
ABSMAX_SHAPE = (4096, 16384)       # phase D
SCALE, TRIAD_S = 2.5, 3.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 outside tensor cores
EPS = float(torch.finfo(torch.float32).eps)
PEAK_MEM_LIMIT = 3 * 1000 ** 3
K1_SOURCE = "src/repro_torch/core/fused_kernel.py"
K1_REPLACES = "src/repro/core/program.py:914"


# ---------------------------------------------------------------------------
# phase D's user-defined instruction (examples/quickstart.py §1–3)
# ---------------------------------------------------------------------------

def _absmax_body(scalars, ins, carry, step):
    blk = ins[0]
    m = torch.maximum(carry, blk.abs().amax(dim=-1, keepdim=True))
    return (blk / torch.clamp_min(m, 1e-9),), m   # running absmax carries


_ABSMAX_TRITON = """
def absmax_scale(x0, carry, step):
    m = tl.maximum(carry, tl.max(tl.abs(x0), axis=1)[:, None])
    return x0 / tl.maximum(m, 1e-9), m
"""

ABSMAX = KernelTemplate(name="c7_absmax_scale", body=_absmax_body,
                        n_vec_in=1, n_vec_out=1, carry_cols=1,
                        carry_init=0.0, triton_body=_ABSMAX_TRITON)


def absmax_ref(x: torch.Tensor, block: int) -> torch.Tensor:
    """Oracle: each block scaled by the running absmax of its row so far."""
    rows, cols = x.shape
    xb = x.reshape(rows, cols // block, block)
    run = torch.cummax(xb.abs().amax(dim=-1), dim=-1).values
    return (xb / torch.clamp_min(run[..., None], 1e-9)).reshape(rows, cols)


def register_absmax() -> None:
    isa.register(Instruction(
        name="c7_absmax_scale",
        spec=OperandSpec(itype="I'", vector_in=1, vector_out=1),
        ref=lambda x: absmax_ref(x, ABSMAX.block_cols),
        kernel=lambda x, interpret=False: ABSMAX(x, interpret=interpret),
        pipeline_depth=ABSMAX.pipeline_depth(),
        doc="streaming blockwise absmax normalisation (stateful demo)"),
        overwrite=True)


# ---------------------------------------------------------------------------
# the main path, phase by phase (also driven at tiny sizes by the tests)
# ---------------------------------------------------------------------------

def make_inputs(seed: int, shapes, device) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device) for s in shapes]


A_CASES = {   # case: (call, bytes per element, operations per element)
    "c0_copy": (lambda a, b, m: ops.stream_copy(a, mode=m), 8, 0),
    "c0_scale": (lambda a, b, m: ops.stream_scale(a, SCALE, mode=m), 8, 1),
    "c0_add": (lambda a, b, m: ops.stream_add(a, b, mode=m), 12, 1),
    "c0_triad": (lambda a, b, m: ops.stream_triad(a, b, TRIAD_S, mode=m),
                 12, 2),
}


def phase_a(a, b, mode):
    """The four STREAM instructions, solo."""
    return {case: call(a, b, mode) for case, (call, _, _) in A_CASES.items()}


def phase_b(x, b, mode):
    """Two fused chains, one launch each."""
    return {"c0_scale+c0_add": isa.fuse("c0_scale", "c0_add")(
                SCALE, x, b, mode=mode),
            "c0_scale+c0_add+c0_copy": isa.fuse(
                "c0_scale", "c0_add", "c0_copy")(SCALE, x, b, mode=mode)}


def batch_scalars(k: int) -> list[float]:
    return [0.25 * (i + 1) for i in range(k)]


def phase_c(xs, bs, interpret: bool):
    """scale→add requests with distinct scalars, coalesced in one launch."""
    prog = isa.fuse("c0_scale", "c0_add").program
    return prog.call_batch(
        [(s, x, b) for s, x, b in zip(batch_scalars(len(xs)), xs, bs)],
        interpret=interpret)


def phase_d(x, mode):
    """The user-defined carried instruction (register_absmax() first)."""
    return isa.call("c7_absmax_scale", x, mode=mode)


# ---------------------------------------------------------------------------
# measurement helpers (card only)
# ---------------------------------------------------------------------------

GPU_CYCLES_PER_S = 2.0e9            # above the H100's top SM clock


def time_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float, float]:
    """(device ms, wall ms, stream ms) of one call of ``fn``.

    Wall: host clock over ``reps`` back-to-back calls ending in a
    synchronize — what a caller waits, dispatch overhead included.
    Stream: CUDA events around the same back-to-back run, per call
    (device time plus any gaps the host leaves).
    Device: median over ``reps`` CUDA-event pairs, each around one call,
    taken while a spin kernel holds the device until the host has
    enqueued every call, so each pair brackets device time only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s0.record()
    for _ in range(reps):
        fn()
    s1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    stream = s0.elapsed_time(s1) / reps
    torch.cuda._sleep(int(1.5 * wall * 1e-3 * reps * GPU_CYCLES_PER_S)
                      + 1_000_000)
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return (float(np.median([e0.elapsed_time(e1) for e0, e1 in pairs])),
            wall, stream)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fma_bound(terms) -> torch.Tensor:
    """4·eps·Σ|term|: the multiply-add tolerance, elementwise."""
    return 4 * EPS * sum(t.abs() for t in terms)


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place (same-sign floats)."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


class Check:
    """Collects comparison verdicts; a phase fails on any False."""

    def __init__(self):
        self.failures: list[str] = []

    def exact(self, what, got, want):
        if not torch.equal(got, want):
            self.failures.append(f"{what}: not bit-exact (max |Δ| "
                                 f"{float((got - want).abs().max()):.3e})")

    def within(self, what, got, want, bound):
        bad = int(((got - want).abs() > bound).sum())
        if bad:
            self.failures.append(f"{what}: {bad} elements outside "
                                 f"the stated tolerance")

    def shaped(self, what, got, shape):
        if tuple(got.shape) != tuple(shape) or not bool(
                torch.isfinite(got).all()):
            self.failures.append(f"{what}: shape {tuple(got.shape)} != "
                                 f"{tuple(shape)} or non-finite values")

    def true(self, what, cond):
        if not cond:
            self.failures.append(what)


def entry(case, launches, err, timed, plain, n_bytes, n_ops, library,
          **extra):
    """One ``kernels`` row; ``timed``/``plain``/``library`` come from
    :func:`time_ms` (library may be None)."""
    b, by = bound_ms(n_bytes, n_ops)
    row = {"name": f"K1 {case}", "route": "triton", "source": K1_SOURCE,
           "replaces": K1_REPLACES, "launches": launches,
           "max_abs_err": err, "ms": timed[0], "plain_ms": plain[0],
           "bound_ms": b, "bound_by": by,
           "library_ms": None if library is None else library[0],
           "wall_ms": timed[1], "stream_ms": timed[2], "bytes": n_bytes,
           "gb_per_s": n_bytes / timed[0] / 1e6}
    row.update(extra)
    return row


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run_phase_a(dev, check, rows):
    a, b = make_inputs(SEED, [N_STREAM, N_STREAM], dev)
    n = N_STREAM
    library = {"c0_copy": lambda out=torch.empty_like(a): out.copy_(a),
               "c0_scale": lambda: torch.mul(a, SCALE),
               "c0_add": lambda: torch.add(a, b),
               "c0_triad": lambda: torch.add(a, b, alpha=TRIAD_S)}
    for case, (call, bytes_per, ops_per) in A_CASES.items():
        K1.launches = 0
        got = call(a, b, "kernel")
        launches = K1.launches
        check.true(f"A {case}: {launches} launches, want 1", launches == 1)
        plain = call(a, b, "interpret")
        ref = call(a, b, "ref")
        check.shaped(f"A {case}", got, a.shape)
        if case == "c0_triad":
            bound = fma_bound((a, TRIAD_S * b))
            check.within(f"A {case} kernel vs emulator", got, plain, bound)
            check.within(f"A {case} kernel vs ref", got, ref, bound)
        else:
            check.exact(f"A {case} kernel vs emulator", got, plain)
            check.exact(f"A {case} kernel vs ref", got, ref)
        rows.append(entry(
            f"A {case}", launches, max_abs(got, plain),
            time_ms(lambda: call(a, b, "kernel")),
            time_ms(lambda: call(a, b, "interpret")),
            bytes_per * n, ops_per * n, time_ms(library[case]),
            max_abs_err_ref=max_abs(got, ref)))
        del got, plain, ref


def run_phase_b(dev, check, rows):
    x, b = make_inputs(SEED + 1, [N_STREAM, N_STREAM], dev)
    n = N_STREAM
    bound = fma_bound((SCALE * x, b))
    for names in (("c0_scale", "c0_add"), ("c0_scale", "c0_add", "c0_copy")):
        fused = isa.fuse(*names)
        case = "+".join(names)
        K1.launches = 0
        got = fused(SCALE, x, b, mode="kernel")
        launches = K1.launches
        check.true(f"B {case}: {launches} launches, want 1", launches == 1)
        plain = fused(SCALE, x, b, mode="interpret")
        ref = fused(SCALE, x, b, mode="ref")
        check.shaped(f"B {case}", got, x.shape)
        check.within(f"B {case} kernel vs emulator", got, plain, bound)
        check.within(f"B {case} kernel vs ref", got, ref, bound)
        rows.append(entry(
            f"B {case}", launches, max_abs(got, plain),
            time_ms(lambda: fused(SCALE, x, b, mode="kernel")),
            time_ms(lambda: fused(SCALE, x, b, mode="interpret")),
            12 * n, 2 * n, time_ms(lambda: torch.add(b, x, alpha=SCALE)),
            max_abs_err_ref=max_abs(got, ref),
            block=list(fused.program.negotiate_geometry(n, x.dtype)[:2])))
        del got, plain, ref


def run_phase_c(dev, check, rows):
    arrays = make_inputs(SEED + 2, [N_ITEM] * (2 * N_ITEMS), dev)
    xs, bs = arrays[:N_ITEMS], arrays[N_ITEMS:]
    scalars = batch_scalars(N_ITEMS)
    fused = isa.fuse("c0_scale", "c0_add")
    prog = fused.program
    K1.launches = 0
    with prog_mod.dispatch_stats_window() as w:
        got = phase_c(xs, bs, interpret=False)
        mixed = w.delta("batch_mixed")
    launches = K1.launches
    check.true(f"C: {launches} launches for one batch, want 1",
               launches == 1)
    check.true(f"C: batch_mixed moved by {mixed}, want 1", mixed == 1)
    plain = phase_c(xs, bs, interpret=True)
    errs = []
    for k, (s, x, b) in enumerate(zip(scalars, xs, bs)):
        check.shaped(f"C item {k}", got[k], x.shape)
        check.exact(f"C item {k} batch vs solo kernel", got[k],
                    fused(s, x, b, mode="kernel"))
        check.within(f"C item {k} kernel vs emulator", got[k], plain[k],
                     fma_bound((s * x, b)))
        check.within(f"C item {k} kernel vs ref", got[k],
                     fused(s, x, b, mode="ref"), fma_bound((s * x, b)))
        errs.append(max_abs(got[k], plain[k]))
    del got, plain
    n = N_ITEM * N_ITEMS
    x2, b2 = torch.stack(xs), torch.stack(bs)
    s2 = torch.tensor(scalars, device=dev).reshape(N_ITEMS, 1)
    # the launch alone, on operands already stacked as call_batch stacks them
    br, bc = prog.negotiate_geometry(N_ITEM, x2.dtype)[:2]
    rows_item = N_ITEM // bc
    xs2, bs2 = x2.reshape(-1, bc), b2.reshape(-1, bc)
    launch_ms = time_ms(lambda: prog.call_blocks(
        scalars, xs2, bs2, block_rows=br, block_cols=bc,
        scalar_items=rows_item // br))[0]
    rows.append(entry(
        "C call_batch 16x scale+add", launches, max(errs),
        time_ms(lambda: phase_c(xs, bs, interpret=False)),
        time_ms(lambda: phase_c(xs, bs, interpret=True)),
        12 * n, 2 * n, time_ms(lambda: torch.addcmul(b2, x2, s2)),
        launch_ms=launch_ms, block=[br, bc]))


def run_phase_d(dev, check, rows):
    (x,) = make_inputs(SEED + 3, [ABSMAX_SHAPE], dev)
    register_absmax()
    K1.launches = 0
    got = phase_d(x, "kernel")
    launches = K1.launches
    check.true(f"D: {launches} launches, want 1", launches == 1)
    plain = phase_d(x, "interpret")
    ref = phase_d(x, "ref")
    check.shaped("D c7_absmax_scale", got, x.shape)
    ulp_plain, ulp_ref = max_ulp(got, plain), max_ulp(got, ref)
    check.true(f"D kernel vs emulator: {ulp_plain} ulp > 2", ulp_plain <= 2)
    check.true(f"D kernel vs ref: {ulp_ref} ulp > 2", ulp_ref <= 2)
    check.exact("D emulator vs ref", plain, ref)
    n = x.numel()
    rows.append(entry(
        "D c7_absmax_scale", launches, max_abs(got, plain),
        time_ms(lambda: phase_d(x, "kernel")),
        time_ms(lambda: phase_d(x, "interpret")),
        8 * n, 3 * n, None, max_abs_err_ref=max_abs(got, ref),
        max_ulp_vs_plain=ulp_plain, max_ulp_vs_ref=ulp_ref,
        block=[ABSMAX.block_rows, ABSMAX.block_cols]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    check, rows = Check(), []
    failed = []
    t_start = time.perf_counter()
    for name, phase in (("A", run_phase_a), ("B", run_phase_b),
                        ("C", run_phase_c), ("D", run_phase_d)):
        t0 = time.perf_counter()
        try:
            phase(dev, check, rows)
            torch.cuda.synchronize()
        except Exception:                 # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(f"phase {name} raised")
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev)
    check.true(f"peak device memory {peak} B >= {PEAK_MEM_LIMIT} B",
               peak < PEAK_MEM_LIMIT)
    failed += check.failures
    if failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows, "peak_bytes": peak,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

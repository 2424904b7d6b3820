#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
registered instructions, fused chains and the coalesced batch path, all
launching the generated Triton kernel K1; the paper's two applications
(§4.3), which launch the sorting networks K5/K6 (CUDA C++) and the
carried scan K3 (Triton); and the Mamba2 SSD state scan, which launches
K4 (Triton) — at full size (every array ≥ 4× the 50 MB L2: 2²⁶ 4-byte
elements = 256 MiB). It builds every kernel from the checkout's sources,
holds each against its plain PyTorch version and the torch oracles on
the card, times it (CUDA events around each call while the device is
held busy, so the time is device time; and host wall time per call),
and prints one ``kernels`` JSON line and, last, the device JSON line.
Exits non-zero, printing no result, when no CUDA device is visible or
any phase fails.

Phases (inputs from numpy with a fixed seed):
  A  c0_copy / c0_scale / c0_add / c0_triad solo at N = 2²⁶ (float32)
  B  fuse(c0_scale, c0_add) and fuse(c0_scale, c0_add, c0_copy) at N = 2²⁶
  C  call_batch of 16 scale→add requests, 16 distinct scalars, N = 2²² each
  D  the carried c7_absmax_scale template (examples/quickstart.py) on a
     (4096, 16384) input
  E  the mergesort app (examples/sort_prefix_apps.py §1): 2²⁶ int32 keys
     in one row through ops.sortnet_mergesort(v[None], max_kernel_width=
     4096) — one K5 launch (width 8), nine K6 launches (w = 8…2048), then
     14 torch.sort levels as in the reference; plus K5 at width 64 in
     float32 and bfloat16, and K6 alone at w = 2048
  F  the prefix-sum app (§2 of the same example): ops.prefix_sum over one
     row of 2²⁶ float32 — one K3 launch
  G  the SSD inter-chunk state scan at Mamba2-1.3B's widths
     (src/repro/configs/mamba2_1p3b.py: headdim 64, state 128, d_inner
     4096 → 64 heads), batch 4, seq 8192 at chunk 256 → 32 chunks:
     ops.chunk_scan_state(a, states, axis=1), states (4, 32, 64, 64, 128)
     float32 — one K4 launch

Tolerances (fixed before any run):
  * copy, scale, add: bit-exact against the emulator and the oracle;
  * multiply-add chains (triad, scale→add…): |Δ| ≤ 4·eps_f32·(|s·x| + |b|)
    elementwise — Triton contracts a·s + b into one FMA (one rounding),
    torch eager rounds twice;
  * every call_batch item: bit-identical to its solo K1 call;
  * c7_absmax_scale: ≤ 2 ulp — Triton's fp32 ``/`` lowers to
    ``div.full.f32`` (≤ 2 ulp), torch divides with IEEE rounding;
  * sorts and merges (E): bit-exact against the plain network, the oracle
    and torch.sort;
  * prefix sum (F), against a float64 cumsum:
    |ŷᵢ − yᵢ| ≤ eps_f32·(⌈log2 bc⌉·Σ_{j≤i}|xⱼ| + Σ_{e<i}|y_e| + |yᵢ|),
    the first-order bound of the kernel's summation order: a tree of
    depth log2 bc inside each block (its errors carried on), plus one add
    of the carry per block, which rounds on a partial sum, not on Σ|x|
    (e runs over the ends of the earlier blocks, bc = the kernel's column
    block). It implies (⌈log2 bc⌉ + ⌈(i+1)/bc⌉ + 1)·eps_f32·Σ_{j≤i}|xⱼ|.
    K3 against its plain version (the same blocks, the carry summed in
    another order): |Δ| ≤ 0.05, a regression limit about 6× the largest
    |Δ| measured on an H100 at this seed;
  * state scan (G), against a float64 sequential recurrence:
    (⌈log2 bc⌉ + ⌈(i+1)/bc⌉ + 2)·eps_f32·Σ_{j≤i}|bⱼ|, valid since
    0 < a ≤ 1 (one more rounding for the products);
  * peak device memory per phase: 3 GB for A–D, 6 GB for E (torch.sort's
    own temporaries in the reference's base-core levels), 4 GB for F and G
    (padding the one-row operand to 8 rows would pass it).

Generated Triton sources go to ``build/repro_torch/``, the CUDA library
to ``build/repro_torch/cuda/`` and Triton's cache to ``build/triton/``
unless the environment names others.
"""
from __future__ import annotations

import json
import math
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

import repro_torch.kernels  # noqa: E402,F401  (registers the ISA)
from repro_torch.core import isa  # noqa: E402
from repro_torch.core import program as prog_mod  # noqa: E402
from repro_torch.core.fused_kernel import K1  # noqa: E402
from repro_torch.core.isa import Instruction, OperandSpec  # noqa: E402
from repro_torch.core.template import KernelTemplate  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import prefix_scan as ps  # noqa: E402
from repro_torch.kernels import sortnet as sn  # noqa: E402
from repro_torch.kernels.prefix_scan import K3, K4  # noqa: E402
from repro_torch.kernels.sortnet import K5, K6  # noqa: E402

SEED = 0
N_STREAM = 1 << 26                 # 256 MiB per float32 array
N_ITEM, N_ITEMS = 1 << 22, 16      # phase C: 16 requests of 16 MiB
ABSMAX_SHAPE = (4096, 16384)       # phase D
SCALE, TRIAD_S = 2.5, 3.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 outside tensor cores
N_SORT = 1 << 26                   # phase E: 256 MiB of int32 keys
MAX_KERNEL_WIDTH = 4096            # the app's merge cut-over to torch.sort
MERGE_W = 2048                     # phase E's K6 row: the widest merge
N_SCAN = 1 << 26                   # phase F: 256 MiB of float32
SSD_SHAPE = (4, 32, 64)            # phase G: (batch, chunks, heads)
SSD_STATE = (64, 128)              # (headdim, state) of mamba2_1p3b
EPS = float(torch.finfo(torch.float32).eps)
K3_PLAIN_LIMIT = 0.05              # phase F: |K3 − plain|, see the docstring
PEAK_MEM_LIMIT = {"A": 3e9, "B": 3e9, "C": 3e9, "D": 3e9,
                  "E": 6e9, "F": 4e9, "G": 4e9}
KERNELS = {   # name: (route, source in the repo, the TPU kernel it replaces)
    "K1": ("triton", "src/repro_torch/core/fused_kernel.py",
           "src/repro/core/program.py:914"),
    "K3": ("triton", "src/repro_torch/kernels/prefix_scan.py",
           "src/repro/kernels/prefix_scan.py:66"),
    "K4": ("triton", "src/repro_torch/kernels/prefix_scan.py",
           "src/repro/kernels/prefix_scan.py:123"),
    "K5": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:139"),
    "K6": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:186"),
}


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


def sort_keys(seed: int, n: int, device) -> torch.Tensor:
    """Uniform int32 keys, as the example draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                         dtype=np.int32)).to(device)


def phase_e(v, mode):
    """The mergesort app (paper §4.3.1): c2_sort, then c1_merge levels."""
    return ops.sortnet_mergesort(v[None], max_kernel_width=MAX_KERNEL_WIDTH,
                                 mode=mode)[0]


def phase_f(x, mode):
    """The prefix-sum app (paper §4.3.2): c3_prefixsum over one row."""
    return ops.prefix_sum(x[None], mode=mode)[0]


def ssd_inputs(seed: int, shape, state, device):
    """Per-(batch, chunk, head) decays in (0, 1] and chunk end-states."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal(shape, dtype=np.float32)))
    b = rng.standard_normal(tuple(shape) + tuple(state), dtype=np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def phase_g(a, states, mode):
    """SSD's inter-chunk recurrence (models/ssm.py): c4_statescan."""
    return ops.chunk_scan_state(a, states, axis=1, mode=mode)


def prefix_bound_misses(got, ref64, abs64, bc: int,
                        step: int = 1 << 22) -> tuple[int, float]:
    """(elements outside eps·(⌈log2 bc⌉·Σ_{j≤i}|xⱼ| + Σ_{e<i}|y_e| + |yᵢ|),
    the largest |Δ|) of a 1-D blocked scan against its float64 reference
    ``ref64`` (``abs64`` = the cumsum of |x|; e = the last index of each
    earlier block of ``bc``); walked in slices to bound the memory."""
    lg = math.ceil(math.log2(bc))
    n = got.numel()
    ends = ref64[bc - 1::bc].abs()
    carried = torch.nn.functional.pad(torch.cumsum(ends, 0), (1, 0))
    bad, worst = 0, 0.0
    for s in range(0, n, step):
        blk = torch.arange(s, min(s + step, n), device=got.device) // bc
        y = ref64[s:s + step]
        err = (got[s:s + step].double() - y).abs()
        bound = EPS * (lg * abs64[s:s + step] + carried[blk] + y.abs())
        bad += int((err > bound).sum())
        worst = max(worst, float(err.max()))
    return bad, worst


def statescan_bound_misses(got, a, states, bc: int,
                           extra: int = 2) -> tuple[int, float]:
    """The same bound for the state scan along axis 1, against a float64
    sequential recurrence y_c = a_c·y_{c-1} + b_c."""
    lg = math.ceil(math.log2(bc))
    y = torch.zeros_like(states[:, 0], dtype=torch.float64)
    s = torch.zeros_like(y)
    bad, worst = 0, 0.0
    for c in range(states.shape[1]):
        b = states[:, c].double()
        y = a[:, c, :, None, None].double() * y + b
        s = s + b.abs()
        err = (got[:, c].double() - y).abs()
        k = lg + math.ceil((c + 1) / bc) + extra
        bad += int((err > k * EPS * s).sum())
        worst = max(worst, float(err.max()))
    return bad, worst


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
          kernel="K1", **extra):
    """One ``kernels`` row; ``timed``/``plain``/``library`` come from
    :func:`time_ms` (library may be None)."""
    b, by = bound_ms(n_bytes, n_ops)
    route, source, replaces = KERNELS[kernel]
    row = {"name": f"{kernel} {case}", "route": route, "source": source,
           "replaces": replaces, "launches": launches,
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


def run_phase_e(dev, check, rows):
    v = sort_keys(SEED + 4, N_SORT, dev)
    K5.launches = K6.launches = 0
    got = phase_e(v, "kernel")
    launches = {"K5": K5.launches, "K6": K6.launches}
    check.true(f"E: {launches['K5']} K5 launches, want 1",
               launches["K5"] == 1)
    check.true(f"E: {launches['K6']} K6 launches, want 9",
               launches["K6"] == 9)
    check.exact("E mergesort app vs torch.sort", got, torch.sort(v).values)
    del got
    app = time_ms(lambda: phase_e(v, "kernel"), reps=10)
    lib = time_ms(lambda: torch.sort(v), reps=10)
    print(f"E sortnet mergesort (c2+c1): {app[0]:.4f} ms device, "
          f"{app[1]:.4f} ms wall; torch.sort(v): {lib[0]:.4f} ms device; "
          f"ratio {lib[0] / app[0]:.3f}x", flush=True)
    app_row = {"app_ms": app[0], "app_wall_ms": app[1],
               "app_torch_sort_ms": lib[0],
               "app_device_ms_by_kind": device_ms_by_kind(
                   lambda: phase_e(v, "kernel"), APP_KINDS)}
    # K5 at the app's shape, and at width 64 in float32 and bfloat16; the
    # last two are not on the app's path, so their launches are those of
    # their own call
    f32 = make_inputs(SEED + 5, [N_SORT], dev)[0]
    for case, x, width in (("int32 w8 (app)", v[None], 8),
                           ("float32 w64", f32[None], 64),
                           ("bfloat16 w64", f32.to(torch.bfloat16)[None], 64)):
        on_app = case.endswith("(app)")
        K5.launches = 0
        got = sn.sort_chunks_kernel(x, width=width)
        own = K5.launches
        plain = sn.sort_chunks_kernel(x, width=width, interpret=True)
        check.exact(f"E K5 {case} kernel vs plain", got, plain)
        check.exact(f"E K5 {case} kernel vs ref", got,
                    ref.sort_chunks(x, width))
        n = x.numel()
        rows.append(entry(
            f"E sort_chunks {case}", launches["K5"] if on_app else own,
            max_abs(got, plain),
            time_ms(lambda: sn.sort_chunks_kernel(x, width=width)),
            time_ms(lambda: sn.sort_chunks_kernel(x, width=width,
                                                  interpret=True), reps=5),
            2 * n * x.element_size(), sn.n_cas_layers(width) * n,
            time_ms(lambda: torch.sort(x.view(-1, width))), kernel="K5",
            width=width, dtype=str(x.dtype).removeprefix("torch."),
            launches_counted_in="main path" if on_app else "own call",
            **(app_row if on_app else {})))
        del got, plain
    del f32
    # K6 alone on the app's operands at its widest level (w = 2048)
    x = torch.sort(v.view(-1, MERGE_W)).values.view(-1, 2, MERGE_W)
    a, b = x[:, 0], x[:, 1]
    lo, hi = sn.merge_sorted_kernel(a, b, width=MERGE_W)
    plo, phi = sn.merge_sorted_kernel(a, b, width=MERGE_W, interpret=True)
    rlo, rhi = ref.merge_sorted(a, b, MERGE_W)
    for half, got, plain, want in (("lo", lo, plo, rlo), ("hi", hi, phi, rhi)):
        check.exact(f"E K6 w={MERGE_W} {half} kernel vs plain", got, plain)
        check.exact(f"E K6 w={MERGE_W} {half} kernel vs ref", got, want)
    n = x.numel()
    rows.append(entry(
        f"E merge_sorted int32 w{MERGE_W}", launches["K6"],
        max(max_abs(lo, plo), max_abs(hi, phi)),
        time_ms(lambda: sn.merge_sorted_kernel(a, b, width=MERGE_W)),
        time_ms(lambda: sn.merge_sorted_kernel(a, b, width=MERGE_W,
                                               interpret=True), reps=5),
        2 * n * x.element_size(), sn.n_cas_layers(2 * MERGE_W) * n,
        time_ms(lambda: torch.sort(x.view(-1, 2 * MERGE_W))), kernel="K6",
        width=MERGE_W, launches_counted_in="main path"))


APP_KINDS = (("K5", "k5_sort"), ("K6", "k6_merge"), ("cat", "CatArray"),
             ("torch.sort", "sort"))   # kind: what its kernels' names hold


def device_ms_by_kind(fn, kinds) -> dict | None:
    """Device ms of one call of ``fn`` from ``torch.profiler``, summed over
    the kernels whose name holds each kind's word (case-insensitive; the
    first kind that matches wins; the rest is "other"); None when the
    profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, word in kinds if word.lower() in e.name.lower()),
                    "other")
        ms[kind] += e.device_time_total / 1e3
    if not any(ms.values()):
        print("torch.profiler saw no device time: breakdown not measured",
              file=sys.stderr)
        return None
    return ms


def run_phase_f(dev, check, rows):
    (x,) = make_inputs(SEED + 6, [N_SCAN], dev)
    K3.launches = 0
    got = phase_f(x, "kernel")
    launches = K3.launches
    check.true(f"F: {launches} K3 launches, want 1", launches == 1)
    check.shaped("F prefix_sum", got, x.shape)
    plain = phase_f(x, "interpret")
    br, bc = ps.block_shape(1, N_SCAN)
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    bad, worst = prefix_bound_misses(got, ref64, abs64, bc)
    check.true(f"F K3: {bad} elements outside the summation bound", bad == 0)
    bad_p, _ = prefix_bound_misses(plain, ref64, abs64, bc)
    check.true(f"F plain: {bad_p} elements outside the summation bound",
               bad_p == 0)
    del ref64, abs64
    err = max_abs(got, plain)
    check.true(f"F K3 vs plain: max |Δ| {err:.3e} > {K3_PLAIN_LIMIT}",
               err <= K3_PLAIN_LIMIT)
    lib = torch.cumsum(x, 0)
    rel = float((got - lib).abs().max() / (lib.abs().max() + 1e-9))
    print(f"F c3_prefixsum: rel err {rel:.3e} against torch.cumsum",
          flush=True)
    rows.append(entry(
        "F prefix_sum (1, 2^26) float32", launches, err,
        time_ms(lambda: phase_f(x, "kernel")),
        time_ms(lambda: phase_f(x, "interpret"), reps=5),
        8 * N_SCAN, N_SCAN, time_ms(lambda: torch.cumsum(x, 0)),
        kernel="K3", block=[br, bc], max_abs_err_f64=worst,
        rel_err_vs_cumsum=rel))


def run_phase_g(dev, check, rows):
    a, states = ssd_inputs(SEED + 7, SSD_SHAPE, SSD_STATE, dev)
    K4.launches = 0
    got = phase_g(a, states, "kernel")
    launches = K4.launches
    check.true(f"G: {launches} K4 launches, want 1", launches == 1)
    check.shaped("G chunk_scan_state", got, states.shape)
    plain = phase_g(a, states, "interpret")
    chunks = SSD_SHAPE[1]
    br, bc = ps.block_shape(states.numel() // chunks, chunks)
    bad, worst = statescan_bound_misses(got, a, states, bc)
    check.true(f"G K4: {bad} elements outside the summation bound", bad == 0)
    bad_p, _ = statescan_bound_misses(plain, a, states, bc)
    check.true(f"G plain: {bad_p} elements outside the summation bound",
               bad_p == 0)
    err = max_abs(got, plain)
    del got, plain
    call = time_ms(lambda: phase_g(a, states, "kernel"))
    # the K4 launch alone, on the operands the wrapper builds (the decay
    # broadcast to state rank and both moved to the last axis)
    ab = torch.movedim(a[..., None, None].expand(states.shape), 1,
                       -1).reshape(-1, chunks)
    bb = torch.movedim(states, 1, -1).reshape(-1, chunks)
    n = states.numel()
    rows.append(entry(
        "G chunk_scan_state (4,32,64,64,128) float32", launches, err,
        time_ms(lambda: ps.chunk_scan_kernel(ab, bb)),
        time_ms(lambda: ps.chunk_scan_kernel(ab, bb, interpret=True),
                reps=5),
        12 * n, 2 * n, None, kernel="K4", block=[br, bc],
        max_abs_err_f64=worst, call_ms=call[0], call_wall_ms=call[1],
        call_bytes=8 * n, call_bound_ms=bound_ms(8 * n, 2 * n)[0]))


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
    check, rows = Check(), []
    failed = []
    peaks = {}
    t_start = time.perf_counter()
    for name, phase in (("A", run_phase_a), ("B", run_phase_b),
                        ("C", run_phase_c), ("D", run_phase_d),
                        ("E", run_phase_e), ("F", run_phase_f),
                        ("G", run_phase_g)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            phase(dev, check, rows)
            torch.cuda.synchronize()
        except Exception:                 # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(f"phase {name} raised")
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        check.true(f"phase {name}: peak device memory {peaks[name]} B >= "
                   f"{PEAK_MEM_LIMIT[name]:.0f} B",
                   peaks[name] < PEAK_MEM_LIMIT[name])
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{peaks[name] / 1e9:.3f} GB", file=sys.stderr, flush=True)
    failed += check.failures
    if failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows, "peak_bytes": max(peaks.values()),
                      "peak_bytes_by_phase": peaks,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

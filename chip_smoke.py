#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
registered instructions, fused chains and the coalesced batch path, all
launching the generated Triton kernel K1; the paper's two applications
(§4.3), which launch the sorting networks K5/K6 (CUDA C++) and the
look-back scan K3 (CUDA C++); the Mamba2 SSD state scan, which launches
K4 (Triton) — at full size (every array ≥ 4× the 50 MB L2: 2²⁶ 4-byte
elements = 256 MiB); and the LM server at Kimi-K2's published widths,
whose MoE router launches K7 (top-k, CUDA C++) and K3 and whose prefill
attention launches K8 (CUDA C++, wgmma and TMA in bfloat16). It builds
every kernel from the checkout's sources (the CUDA sources first, one
nvcc each, in parallel, with ptxas's register and shared-memory report),
holds each against its plain PyTorch version and the torch oracles on
the card, times it (CUDA events around each call while the device is
held busy, so the time is device time; and host wall time per call),
and prints one ``kernels`` JSON line and, last, the device JSON line.
Phase I serves two tenants through the scheduler, whose batches and plan
parts launch K1, and prints a ``sched`` JSON line before the kernels
line.
Exits non-zero, printing no result, when no CUDA device is visible or
any phase fails.

Phases (inputs from numpy with a fixed seed):
  A  c0_copy / c0_scale / c0_add / c0_triad solo at N = 2²⁶ (float32)
  B  fuse(c0_scale, c0_add) and fuse(c0_scale, c0_add, c0_copy) at N = 2²⁶
  C  call_batch of 16 scale→add requests, 16 distinct scalars, N = 2²² each:
     one launch of K1's batch kernel on the items where they lie (no
     item copied; one torch.profiler trace of the batch shows that kernel
     and nothing else), the launch alone timed on the items in place;
     then a ragged batch (16 items of 2²² − 1000, one of them a view at
     storage offset 1, which alone is copied)
  D  the carried c7_absmax_scale template (examples/quickstart.py) on a
     (4096, 16384) input; then its program's call_batch of 4 ragged
     (1000, 16381) items
  E  the mergesort app (examples/sort_prefix_apps.py §1): 2²⁶ int32 keys
     in one row through ops.sortnet_mergesort(v[None], max_kernel_width=
     4096) — one K5 launch (width 8), nine K6 launches (one at each
     w = 8…2048), then 14 torch.sort levels as in the reference; plus K5
     alone at widths 16, 64, 512 and 4096 in float32 and 64 in bfloat16
     (one instance per width), and K6 alone at each of the nine widths on
     that level's operands
  F  the prefix-sum app (§2 of the same example): ops.prefix_sum over one
     row of 2²⁶ float32 — one K3 launch
  G  the SSD inter-chunk state scan at Mamba2-1.3B's widths
     (src/repro/configs/mamba2_1p3b.py: headdim 64, state 128, d_inner
     4096 → 64 heads), batch 4, seq 8192 at chunk 256 → 32 chunks:
     ops.chunk_scan_state(a, states, axis=1), states (4, 32, 64, 64, 128)
     float32 — one K4 launch
  H  the LM server (repro_torch.launch.serve.generate) on Kimi-K2 1T-A32B
     (src/repro/configs/kimi_k2_1t.py) at every published width — d_model
     7168, 64 heads, 8 KV heads of 128, 384 experts top-8 of width 2048,
     vocab 163840, bf16 — with 2 of its 61 layers (2 layers of weights are
     67.9 GiB on the 80 GB card) and attn_impl="kernel" (the switch under
     which prefill launches c6); random weights from a seeded CUDA
     generator. 4 prompts of 1024 tokens, 16 greedy tokens each: K8 twice
     (prefill, one per layer), K7 and K3 2 × 16 = 32 times each (prefill and
     15 decode steps, one per layer). The router's (tokens, 384) logits
     go to K7 in place, standing for rows of 512 (no padded copy: one
     torch.profiler trace of a router top-k call holds one K7 kernel and
     no concatenation). The path's own K7 inputs (layer 0 of prefill and
     of the first decode step) and K8 inputs (layer 0 of prefill) are
     recorded and held against the plain versions and the oracles; K7 and
     K8 are also held off the path at the same shapes (K7: a tile of
     ties, bfloat16, int32, a tile of ±0.0 and NaN of either sign, rows
     of 8192 at k 8 and the full network at k 40; K8 causal at sq < sk;
     K8 in float32). The same
     request through the plain path (isa.use("interpret")) is printed
     beside it, not gated: near-tied router logits may flip an expert
  I  the multi-tenant scheduler (repro_torch.sched) with
     CostModel(hierarchy=H100), weighted fair queueing over two lanes,
     wall clock: tenant A submits 16 fuse(c0_scale, c0_add) requests of
     2²² float32 sharing one scalar (one coalesced batch: one
     k1_batch_kernel launch on the items in place); tenant B submits
     the axpby_residual and saxpby plans of ops.c0_pipeline_graph,
     partitioned under the H100 preset at 2²⁶ (two parts, two K1
     launches each). One torch.profiler trace of the run holds those
     five kernels and no copy; the recorded run replays. Printed in the
     ``sched`` line: each batch's predicted and observed ms, each plan's
     device ms against its unfused partition (one launch a node) on the
     same inputs, host µs per dispatch (wall per batch less device per
     batch) for the same mix at 2¹², and a least-squares fit of
     t = overhead_s + bytes / peak_bw to c0_copy's device time at
     2¹⁰…2¹⁸ (H100_HBM.overhead_s is assumed, 1 µs)

Tolerances (fixed before any run):
  * copy, scale, add: bit-exact against the emulator and the oracle;
  * multiply-add chains (triad, scale→add…): |Δ| ≤ 4·eps_f32·(|s·x| + |b|)
    elementwise — Triton contracts a·s + b into one FMA (one rounding),
    torch eager rounds twice;
  * every call_batch item: bit-identical to its solo K1 call (ragged,
    misaligned and carried items too: the batch masks the tail a solo
    call pads with zeros);
  * I: every scheduled result bit-identical to that request's own solo
    call (A's items to fuse(...)(s, x, b), each plan's outputs to the
    plan called alone), and against ref at the multiply-add bound
    4·eps_f32·Σ|term| (A: |s·x| + |b|; axpby_residual |s·x| + |b| and
    |x| + |t·b|; saxpby |a·x| + |b·y|); the replay of the recorded wall
    run takes the same decisions (item, lane, round, batch, predicted
    time) and replays itself with placements_match true;
  * c7_absmax_scale: ≤ 2 ulp — Triton's fp32 ``/`` lowers to
    ``div.full.f32`` (≤ 2 ulp), torch divides with IEEE rounding;
  * sorts and merges (E): bit-exact against the plain network, the oracle
    and torch.sort;
  * prefix sum (F), against a float64 cumsum, each scan at the
    first-order bound of its own summation order,
    |ŷᵢ − yᵢ| ≤ eps_f32·(k_abs·Σ_{j≤i}|xⱼ| + k_ends·Σ_{e<i}|y_e| + |yᵢ|),
    e over the ends of the earlier 4096-column blocks. The plain version
    (the carried walk): k_abs = ⌈log2 bc⌉, a tree inside each block, and
    k_ends = 1, one add of the carry per block, which rounds on a partial
    sum, not on Σ|x|. K3 (the look-back scan,
    ``prefix_scan.k3_bound_constants``): k_abs = 26, at most 25 adds
    inside a tile plus one unit that absorbs the double-precision
    look-back, and k_ends = 1, the exclusive prefix rounded once from
    double near the previous tile's end. K3 against its plain version:
    |Δ| ≤ 0.05, a regression limit about 6× the largest |Δ| measured on
    an H100 at this seed with the earlier, carried K3;
  * state scan (G), against a float64 sequential recurrence:
    (⌈log2 bc⌉ + ⌈(i+1)/bc⌉ + 2)·eps_f32·Σ_{j≤i}|bⱼ|, valid since
    0 < a ≤ 1 (one more rounding for the products);
  * K7 (H): values (by their bits) and indices bit-exact against the
    oracle ref.topk (lax.top_k's order) everywhere, and against the plain
    network (the JAX kernel's) on every input without NaN and without
    both signed zeros, where the two orders agree; K3 in H (sums of 0/1
    below 2²⁴) bit-exact;
  * K8 (H) in float32, per row i against the plain version and the oracle:
    (D·eps_f32·scale·max_j Σ_d|q_id·k_jd| + sk·eps_f32)·2·max|v| — the
    logits' fp32 dot products, then the weighted sums, in other orders;
    in bfloat16 that bound plus one bfloat16 ulp at |plain| + bound (both
    round the fp32 result once; near zero, and where the random weights
    make the logits large, the fp32 difference alone can exceed an ulp),
    and the number of elements beyond one ulp is printed. In bfloat16
    also against the float64 result (`attn_f64_misses`), on the path's own
    inputs and at the prefill's shape with unit-scale logits: every output
    o_d within half a bf16 ulp plus the row's relative term above times
    2·(Σ_j p_j·|v_jd| + |o_d|) (its own scale, not the head's max|v|); and
    no more outputs beyond one bf16 ulp of float64 than the plain version
    has. On the path's inputs strictly; at unit scale, where K8 and plain
    both sit at fp32's floor (~850 of 33.5 M each) and differ only in which
    elements they miss, give or take UNIT_SCALE_NOISE = 4 standard
    deviations of the paired difference (√ of the elements only one of
    them misses) — two bf16 terms of p, or the three terms chained in one
    accumulator, miss 10× and 4× as many there. "Within one bf16 ulp of the
    plain version" holds only for a kernel that sums q·kᵀ in the plain
    version's own order: at the random weights' logits (~10³, fp32 ulp
    6e-5) a logit's last bit moves an output near zero by more than an
    ulp;
  * H: every prefill and decode logit finite, the greedy tokens of two
    runs on the same inputs bit-identical, the launch counts above;
  * peak device memory per phase: 3 GB for A–D, 6 GB for E (torch.sort's
    own temporaries in the reference's base-core levels), 4 GB for F and G
    (padding the one-row operand to 8 rows would pass it), for H the
    weights' bytes + 8 GB, and 3 GB for I (≈ 0.8 GB for A's requests,
    ≈ 1.6 GB for B's inputs and outputs).

Bounds: the larger of the bytes a call must move at 3.35 TB/s and its
operations at the peak rate of their kind — 67 TFLOP/s for fp32 work on
the CUDA cores, 989 TFLOP/s for K8's products (bf16 on the tensor cores);
each row names the one it used.

Generated Triton sources go to ``build/repro_torch/``, the CUDA libraries
to ``build/repro_torch/cuda/`` and Triton's cache to ``build/triton/``
unless the environment names others.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flashattn as fa  # noqa: E402
from repro_torch.kernels import sortnet as sn  # noqa: E402
from repro_torch.kernels import stream_copy  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402
from repro_torch.kernels.flashattn import K8  # noqa: E402
from repro_torch.kernels.prefix_scan import K3, K4  # noqa: E402
from repro_torch.kernels.sortnet import K5, K6  # noqa: E402
from repro_torch.kernels.topk import K7  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.graph import partition  # noqa: E402
from repro_torch.memhier import H100  # noqa: E402
from repro_torch.sched import (CostModel, RequestQueue, Scheduler,  # noqa: E402
                               TraceRecorder, placements_match, replay)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import DTYPES, param_specs, tree_items  # noqa: E402,E501

SEED = 0
N_STREAM = 1 << 26                 # 256 MiB per float32 array
N_ITEM, N_ITEMS = 1 << 22, 16      # phase C: 16 requests of 16 MiB
N_RAGGED = N_ITEM - 1000           # phase C's second batch: a masked tail
CARRIED_ITEM = (1000, 16381)       # phase D's batch of 4 (ragged) items
ABSMAX_SHAPE = (4096, 16384)       # phase D
SCALE, TRIAD_S = 2.5, 3.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
OPS_PER_S = {"fp32": 67e12,        # H100 SXM, FP32 outside tensor cores
             "bf16 tensor": 989e12}   # bf16 dense on the tensor cores
N_SORT = 1 << 26                   # phase E: 256 MiB of int32 keys
MAX_KERNEL_WIDTH = 4096            # the app's merge cut-over to torch.sort
MERGE_WIDTHS = tuple(8 << k for k in range(9))   # phase E's K6 levels
N_SCAN = 1 << 26                   # phase F: 256 MiB of float32
SSD_SHAPE = (4, 32, 64)            # phase G: (batch, chunks, heads)
SSD_STATE = (64, 128)              # (headdim, state) of mamba2_1p3b
EPS = float(torch.finfo(torch.float32).eps)
K3_PLAIN_LIMIT = 0.05              # phase F: |K3 − plain|, see the docstring
UNIT_SCALE_NOISE = 4.0             # phase H: K8's paired count (docstring)
TOPK_WIDE = (64, 8192)             # phase H: K7 rows above 4096 (k ≤ 32)
TOPK_FULL_K = 40                   # phase H: K7's full network (k > 32)
K5_WIDTHS = (("float32", 16), ("float32", 64), ("bfloat16", 64),
             ("float32", 512), ("float32", 4096))   # phase E, off the app
LM_ARCH = "kimi_k2_1t"             # phase H: the served model
LM_LAYERS = 2                      # of 61 (see the docstring)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 16
N_SCHED_ITEM, N_SCHED_ITEMS = 1 << 22, 16   # phase I: tenant A's requests
N_SCHED_PLAN = 1 << 26             # phase I: tenant B's plans
N_HOST = 1 << 12                   # phase I: the same mix for host overhead
HOST_REPS = 10                     # phase I: runs of that mix
FIT_NS = tuple(1 << k for k in range(10, 19))   # phase I: c0_copy sizes
PLAN_S, PLAN_T = 1.5, 0.5          # axpby_residual's scalars
SAX_A, SAX_B = 2.0, -0.75          # saxpby's scalars
LM_REDUCED = ["n_layers 61 → 2: two layers of bf16 weights are 67.9 GiB "
              "on one 80 GB card",
              "attn_impl chunked → kernel: the switch under which prefill "
              "launches c6 (K8)"]


def lm_config(n_layers: int = LM_LAYERS):
    """Kimi-K2 at its published widths, cut in depth, attention on c6."""
    return dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers,
                               attn_impl="kernel")


def weight_bytes(cfg) -> int:
    return sum(math.prod(s.shape) * DTYPES[s.dtype or cfg.param_dtype].itemsize
               for _, s in tree_items(param_specs(cfg)))


PEAK_MEM_LIMIT = {"A": 3e9, "B": 3e9, "C": 3e9, "D": 3e9,
                  "E": 6e9, "F": 4e9, "G": 4e9,
                  "H": weight_bytes(lm_config()) + 8e9, "I": 3e9}
KERNELS = {   # name: (route, source in the repo, the TPU kernel it replaces)
    "K1": ("triton", "src/repro_torch/core/fused_kernel.py",
           "src/repro/core/program.py:914"),
    "K3": ("cuda", "src/repro_torch/kernels/csrc/prefix_scan.cu",
           "src/repro/kernels/prefix_scan.py:66"),
    "K4": ("triton", "src/repro_torch/kernels/prefix_scan.py",
           "src/repro/kernels/prefix_scan.py:123"),
    "K5": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:139"),
    "K6": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:186"),
    "K7": ("cuda", "src/repro_torch/kernels/csrc/topk.cu",
           "src/repro/kernels/topk.py:50"),
    "K8": ("cuda", "src/repro_torch/kernels/csrc/flashattn.cu",
           "src/repro/kernels/flashattn.py:84"),
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


def serve_prompts(seed: int, cfg, batch: int, prompt_len: int, device):
    """Uniform token ids from seeded numpy."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                            ).to(device)


def phase_h(cfg, params, prompts, gen: int, mode):
    """The LM server (launch/serve.py): prefill, cache growth, greedy
    decode. Returns (tokens (B, gen), prefill s, decode s)."""
    with isa.use(mode):
        return serve.generate(cfg, params, prompts, gen)


def sched_plans(n: int, model=H100):
    """Tenant B's two plans, partitioned under ``model`` at ``n``
    elements: axpby_residual (two parts) and saxpby (two parts)."""
    return (partition(ops.c0_pipeline_graph("axpby_residual"), model=model,
                      n_elems=n),
            partition(ops.c0_pipeline_graph("saxpby"), model=model,
                      n_elems=n))


def phase_i(xs, bs, x, b, plans, mode, recorder=None, hierarchy=H100,
            cost=None):
    """Two tenants through the scheduler (weighted fair, two lanes, wall
    clock): tenant A's fuse(c0_scale, c0_add) requests share one scalar
    and coalesce into one batch; tenant B submits the two plans on
    (x, b). ``cost`` defaults to a fresh CostModel over ``hierarchy``.
    Returns (report, A's items, B's items)."""
    q = RequestQueue()
    fused = isa.fuse("c0_scale", "c0_add")
    a_items = [q.submit(fused, (SCALE, xa, ba), tenant="A")
               for xa, ba in zip(xs, bs)]
    axpby, saxpby = plans
    b_items = [q.submit(axpby, (x, b, PLAN_S, PLAN_T), tenant="B"),
               q.submit(saxpby, (x, b, SAX_A, SAX_B), tenant="B")]
    if cost is None:
        cost = CostModel(hierarchy=hierarchy)
    sched = Scheduler(q, cost=cost, policy="wfq", n_lanes=2, clock="wall",
                      mode=mode, recorder=recorder)
    return sched.drain(), a_items, b_items


def plan_terms(kind: str, x, b):
    """Σ|term| of each output of a tenant B plan (the FMA bound's)."""
    if kind == "axpby_residual":
        return ((PLAN_S * x).abs() + b.abs(), x.abs() + (PLAN_T * b).abs())
    return ((SAX_A * x).abs() + (SAX_B * b).abs(),)


class Tap:
    """Inside ``with``, ``module.name`` passes every call through and keeps
    ``record(args, kwargs, result)`` of each in ``calls`` (by default the
    triple itself); it launches nothing itself."""

    def __init__(self, module, name: str, record=lambda *call: call):
        self.module, self.name, self.calls = module, name, []
        self.record = record

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def tapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append(self.record(args, kw, out))
            return out

        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def attn_row_error(q, k, scale=None) -> torch.Tensor:
    """(..., sq, 1): D·eps·scale·max_j Σ_d|q_id·k_jd| + sk·eps, each row's
    first-order relative error of fp32 attention (the logits' dot
    products, then the weighted sums); walked over the leading axis."""
    d, sk = q.shape[-1], k.shape[-2]
    scale = d ** -0.5 if scale is None else scale
    out = []
    for qb, kb in zip(q, k):
        qk = torch.matmul(qb.float().abs(), kb.float().abs().transpose(-1, -2))
        out.append(d * EPS * scale * qk.amax(-1, keepdim=True) + sk * EPS)
    return torch.stack(out)


def attn_bound(q, k, v, scale=None) -> torch.Tensor:
    """(..., sq, 1): each row's fp32 summation bound for attention computed
    in two orders, :func:`attn_row_error`·2·max|v| (max|v| over the row's
    head)."""
    vmax = torch.stack([vb.float().abs().amax(dim=(-2, -1), keepdim=True)
                        for vb in v])
    return attn_row_error(q, k, scale) * 2 * vmax


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32)
                                                 .tiny)))
    return torch.exp2(e - 7)


def attn_misses(got, want, bound) -> tuple[int, float, int | None]:
    """(elements outside the tolerance, max |Δ|, elements beyond one bf16
    ulp of ``want`` — None for float32): float32 within ``bound``;
    bfloat16 within ``bound`` plus one bf16 ulp at |want| + bound."""
    err = (got.float() - want.float()).abs()
    if got.dtype != torch.bfloat16:
        return int((err > bound).sum()), float(err.max()), None
    w = want.float().abs()
    return (int((err > bound + bf16_ulp(w + bound)).sum()), float(err.max()),
            int((err > bf16_ulp(w)).sum()))


def exact_attention(q, k, v, heads: int = 8):
    """Causal attention (bottom-right aligned) of the same bf16 or fp32
    values in float64, a few heads at a time; and each output's
    Σ_j p_j·|v_jd|, the scale of its summation errors."""
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    mask = (torch.arange(sk, device=q.device)[None, :]
            > torch.arange(sq, device=q.device)[:, None] + sk - sq)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    mass = torch.empty_like(out)
    for b in range(q.shape[0]):
        for h in range(0, q.shape[1], heads):
            s = torch.matmul(q[b, h:h + heads].double(),
                             k[b, h:h + heads].double().transpose(-1, -2))
            p = torch.softmax((s * d ** -0.5).masked_fill(mask, -math.inf),
                              -1)
            vb = v[b, h:h + heads].double()
            out[b, h:h + heads] = torch.matmul(p, vb)
            mass[b, h:h + heads] = torch.matmul(p, vb.abs())
    return out, mass


def attn_f64_misses(got, plain, q, k, v) -> dict:
    """bf16 ``got`` and ``plain`` (attention of q, k, v) against the float64
    result: the elements of each beyond one bf16 ulp of it, the elements
    beyond one ulp for ``got`` alone and for ``plain`` alone, and the
    elements of ``got`` outside their own bound, half a bf16 ulp plus
    :func:`attn_row_error`·2·(Σ_j p_j·|v_jd| + |o_d|) (a logit error δ
    moves o_d by at most max δ·Σ_j p_j·|v_jd − o_d|)."""
    exact, mass = exact_attention(q, k, v)
    ulp = bf16_ulp(exact.float()).double()
    err = (got.double() - exact).abs()
    over, plain_over = err > ulp, (plain.double() - exact).abs() > ulp
    bound = ulp / 2 + attn_row_error(q, k).double() * 2 * (mass
                                                           + exact.abs())
    return {"over_one_bf16_ulp_f64": int(over.sum()),
            "plain_over_one_bf16_ulp_f64": int(plain_over.sum()),
            "over_alone": int((over & ~plain_over).sum()),
            "plain_over_alone": int((plain_over & ~over).sum()),
            "outside_element_bound_f64": int((err > bound).sum())}


def oracle_attention(q, k, v):
    """ref.flash_attention (causal), one batch element at a time."""
    return torch.cat([ref.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                      for i in range(q.shape[0])])


def routing_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of (token, expert) choices of ``a`` (t, k) that ``b`` makes."""
    return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())


def prefix_bound_misses(got, ref64, abs64, bc: int, k_abs: int,
                        k_ends: int = 1,
                        step: int = 1 << 22) -> tuple[int, float]:
    """(elements outside eps·(k_abs·Σ_{j≤i}|xⱼ| + k_ends·Σ_{e<i}|y_e| +
    |yᵢ|), the largest |Δ|) of a 1-D blocked scan against its float64
    reference ``ref64`` (``abs64`` = the cumsum of |x|; e = the last index
    of each earlier block of ``bc``); (k_abs, k_ends) are the constants of
    the scan's summation order; walked in slices to bound the memory."""
    n = got.numel()
    ends = ref64[bc - 1::bc].abs()
    carried = torch.nn.functional.pad(torch.cumsum(ends, 0), (1, 0))
    bad, worst = 0, 0.0
    for s in range(0, n, step):
        blk = torch.arange(s, min(s + step, n), device=got.device) // bc
        y = ref64[s:s + step]
        err = (got[s:s + step].double() - y).abs()
        bound = EPS * (k_abs * abs64[s:s + step] + k_ends * carried[blk]
                       + y.abs())
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

CARD = ""                           # nvidia-smi's name and power limit
GPU_CYCLES_PER_S = 2.0e9            # above the H100's top SM clock
SPIN_CYCLES = 10_000_000            # ~5 ms: a spin around a traced call


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


def bound_ms(n_bytes: float, n_ops: float,
             peak: str = "fp32") -> tuple[float, str]:
    """The least time for the bytes at HBM's rate and the operations at
    the peak rate of their kind (``OPS_PER_S[peak]``), and which binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[peak] * 1e3
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


#: the CUDA sources' build report, filled by :func:`cuda_report` once the
#: sources are built: stem → {"nvcc_seconds", "kernels": {name: usage}};
#: for flashattn also "hgmma", each kernel's HGMMA count in its SASS
CUDA_REPORT: dict = {}


def kernel_name(demangled: str) -> str:
    """``k3_scan_kernel<float>`` from cu++filt's
    ``void (anonymous namespace)::k3_scan_kernel<float>(float const*, …)``
    (``k8_flash_wgmma<128>`` from ``…k8_flash_wgmma<(int)128>(…)``)."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):    # drop the parameters
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0:
            demangled = demangled[:i] if demangled[i] == "(" else demangled
            break
    return demangled.rsplit("::", 1)[-1].removeprefix("void ").replace(
        "(int)", "")


def kernel_names(mangled) -> dict[str, str]:
    """Mangled kernel name → :func:`kernel_name`, through cu++filt (beside
    nvcc)."""
    mangled = sorted(set(mangled))
    filt = Path(_cuda.nvcc()).with_name("cu++filt")
    out = subprocess.run([str(filt), *mangled], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return {m: kernel_name(d) for m, d in zip(mangled, out, strict=True)}


def cuda_report() -> dict:
    """Per CUDA source built in this process: nvcc's seconds and each
    kernel's registers, shared memory and spills (``-Xptxas -v``); and
    the HGMMA instructions in each K8 kernel's SASS."""
    for stem, info in _cuda.BUILD_LOG.items():
        usage = _cuda.ptxas_usage(info["ptxas"])
        names = kernel_names(usage)
        CUDA_REPORT[stem] = {
            "nvcc_seconds": info["seconds"],
            "kernels": {names[k]: u for k, u in usage.items()}}
    cuobjdump = Path(_cuda.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_cuda.library_path("flashattn"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    names = kernel_names(counts)
    CUDA_REPORT.setdefault("flashattn", {})["hgmma"] = {
        names[k]: n for k, n in counts.items()}
    return CUDA_REPORT


def entry(case, launches, err, timed, plain, n_bytes, n_ops, library,
          kernel="K1", peak="fp32", **extra):
    """One ``kernels`` row; ``timed``/``plain``/``library`` come from
    :func:`time_ms` (library may be None); ``peak`` names the operations'
    rate in the bound."""
    b, by = bound_ms(n_bytes, n_ops, peak)
    route, source, replaces = KERNELS[kernel]
    row = {"name": f"{kernel} {case}", "route": route, "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": err, "ms": timed[0], "plain_ms": plain[0],
           "bound_ms": b, "bound_by": by, "ops_peak": peak,
           "ops_per_s": OPS_PER_S[peak],
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
    K1.launches = K1.item_copies = 0
    with prog_mod.dispatch_stats_window() as w:
        got = phase_c(xs, bs, interpret=False)
        mixed = w.delta("batch_mixed")
    launches, copies = K1.launches, K1.item_copies
    check.true(f"C: {launches} launches for one batch, want 1",
               launches == 1)
    check.true(f"C: batch_mixed moved by {mixed}, want 1", mixed == 1)
    check.true(f"C: {copies} items copied, want 0", copies == 0)
    check.true("C: results share storage", len(
        {o.untyped_storage().data_ptr() for o in got}) == N_ITEMS)
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
    # one batch in the profiler: K1 once, and no copy, cat or pad kernel
    kernels = device_kernels(lambda: phase_c(xs, bs, interpret=False))
    if kernels is not None:
        names = [name for name, _ in kernels]
        check.true(f"C: the batch ran {names}, want one k1_batch_kernel",
                   len(names) == 1 and "k1_batch_kernel" in names[0])
    n = N_ITEM * N_ITEMS
    # the launch alone, on the items in place (the scalar and offset
    # tables included)
    br, bc = prog.negotiate_geometry(N_ITEM, xs[0].dtype)[:2]
    per_item = [[x, b] for x, b in zip(xs, bs)]
    launch_ms = time_ms(lambda: prog.call_items(
        [[s] for s in scalars], per_item, block_rows=br, block_cols=bc))[0]
    x2, b2 = torch.stack(xs), torch.stack(bs)
    s2 = torch.tensor(scalars, device=dev).reshape(N_ITEMS, 1)
    rows.append(entry(
        "C call_batch 16x scale+add", launches, max(errs),
        time_ms(lambda: phase_c(xs, bs, interpret=False)),
        time_ms(lambda: phase_c(xs, bs, interpret=True)),
        12 * n, 2 * n, time_ms(lambda: torch.addcmul(b2, x2, s2)),
        launch_ms=launch_ms, block=[br, bc], item_copies=copies,
        device_kernels=kernels))
    del x2, b2, arrays, xs, bs, per_item
    # a ragged batch (the tail of each item masked), one item misaligned
    # by 4 bytes (copied alone): every item as its solo launch
    arrays = make_inputs(SEED + 11, [N_RAGGED + 1] + [N_RAGGED] *
                         (2 * N_ITEMS - 1), dev)
    xs = [arrays[0][1:]] + arrays[1:N_ITEMS]          # storage offset 1
    bs = arrays[N_ITEMS:]
    K1.launches = K1.item_copies = 0
    got = phase_c(xs, bs, interpret=False)
    check.true(f"C ragged: {K1.launches} launches, want 1",
               K1.launches == 1)
    check.true(f"C ragged: {K1.item_copies} items copied, want 1 (the "
               f"misaligned one)", K1.item_copies == 1)
    for k, (s, x, b) in enumerate(zip(scalars, xs, bs)):
        check.shaped(f"C ragged item {k}", got[k], x.shape)
        check.exact(f"C ragged item {k} batch vs solo kernel", got[k],
                    fused(s, x, b, mode="kernel"))
    rows[-1]["ragged_batch"] = {"n": N_RAGGED, "items": N_ITEMS,
                                "item_copies": K1.item_copies,
                                "ms": time_ms(lambda: phase_c(
                                    xs, bs, interpret=False))[0]}


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
    del x, got, plain, ref
    # the same program's coalesced batch: 4 ragged items, each as its
    # solo call (the carry runs along a row; only a tail is masked)
    prog = ABSMAX.program()
    items = [(t,) for t in make_inputs(SEED + 12, [CARRIED_ITEM] * 4, dev)]
    K1.launches = 0
    got = prog.call_batch(items)
    check.true(f"D batch: {K1.launches} launches, want 1",
               K1.launches == 1)
    for k, ((x,), out) in enumerate(zip(items, got)):
        check.shaped(f"D batch item {k}", out, x.shape)
        check.exact(f"D batch item {k} vs solo kernel", out, prog(x))


def run_phase_e(dev, check, rows):
    v = sort_keys(SEED + 4, N_SORT, dev)
    K5.launches = K6.launches = 0
    with Tap(sn, "K6", record=lambda args, kw, out: args[2]) as level:
        got = phase_e(v, "kernel")
    launches = {"K5": K5.launches, "K6": K6.launches}
    check.true(f"E: {launches['K5']} K5 launches, want 1",
               launches["K5"] == 1)
    check.true(f"E: {launches['K6']} K6 launches, want 9",
               launches["K6"] == 9)
    check.exact("E mergesort app vs torch.sort", got, torch.sort(v).values)
    check.true(f"E: K6 ran at widths {level.calls}, want one launch at "
               f"each of {list(MERGE_WIDTHS)}",
               level.calls == list(MERGE_WIDTHS))
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
    # K5 at the app's shape, and at other widths (one instance each); those
    # are not on the app's path, so their launches are those of their own
    # call
    f32 = make_inputs(SEED + 5, [N_SORT], dev)[0]
    cases = [("int32 w8 (app)", v[None], 8)] + [
        (f"{dt} w{w}", f32[None] if dt == "float32"
         else f32.to(torch.bfloat16)[None], w) for dt, w in K5_WIDTHS]
    for case, x, width in cases:
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
    # K6 alone at each level of the app, on the level's own operands
    for w in MERGE_WIDTHS:
        x = torch.sort(v.view(-1, w)).values.view(-1, 2, w)
        a, b = x[:, 0], x[:, 1]
        lo, hi = sn.merge_sorted_kernel(a, b, width=w)
        plo, phi = sn.merge_sorted_kernel(a, b, width=w, interpret=True)
        rlo, rhi = ref.merge_sorted(a, b, w)
        for half, got, plain, want in (("lo", lo, plo, rlo),
                                       ("hi", hi, phi, rhi)):
            check.exact(f"E K6 w={w} {half} kernel vs plain", got, plain)
            check.exact(f"E K6 w={w} {half} kernel vs ref", got, want)
        n = x.numel()
        rows.append(entry(
            f"E merge_sorted int32 w{w}", level.calls.count(w),
            max(max_abs(lo, plo), max_abs(hi, phi)),
            time_ms(lambda: sn.merge_sorted_kernel(a, b, width=w)),
            time_ms(lambda: sn.merge_sorted_kernel(a, b, width=w,
                                                   interpret=True), reps=5),
            # a merge of 2w keys: log2(2w) layers, one compare a key
            2 * n * x.element_size(), ((2 * w).bit_length() - 1) * n,
            time_ms(lambda: torch.sort(x.view(-1, 2 * w))), kernel="K6",
            width=w, launches_counted_in="main path"))
        del x, a, b, lo, hi, plo, phi, rlo, rhi


APP_KINDS = (("K5", "k5_sort"), ("K6", "k6_merge"), ("cat", "CatArray"),
             ("torch.sort", "sort"))   # kind: what its kernels' names hold
LM_KINDS = (("K8", "k8_flash"), ("K7", "k7_topk"), ("K3", "k3_"),
            ("matmul", "gemm"), ("matmul", "nvjet"), ("matmul", "xmma"),
            ("matmul", "cutlass"), ("index", "index"),
            ("cat", "CatArray"), ("elementwise", "elementwise"),
            ("reduce", "reduce"))


def device_events(fn) -> list[tuple[str, float]] | None:
    """(name, device ms) of each device event (kernels, copies, fills) of
    one call of ``fn`` in a ``torch.profiler`` trace; None when the
    profiler sees no device time. The trace runs a warm-up call first and
    keeps only the second: a launch right after the trace starts can be
    missing from it (K5, the mergesort app's first kernel, was). Each
    call also sits between two spin kernels of ~5 ms, left out of the
    result: a trace of a few microseconds of device work came back empty
    on the H100 (the router's top-k, and a cat of the same size, once
    phase E's app trace had run), and the same work inside ~10 ms of
    spinning comes back whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []

    def keep(prof):
        events.extend((e.name, e.device_time_total / 1e3)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("ProfilerStep")
                      and "spin_kernel" not in e.name)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            torch.cuda._sleep(SPIN_CYCLES)
            fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            prof.step()
    if not any(ms for _, ms in events):
        print("torch.profiler saw no device time: breakdown not measured",
              file=sys.stderr)
        return None
    return events


def device_kernels(fn) -> list[tuple[str, float]] | None:
    """The kernels among :func:`device_events` (not a memcpy or memset)."""
    events = device_events(fn)
    if events is None:
        return None
    return [(name, ms) for name, ms in events
            if not name.startswith(("Memcpy", "Memset"))]


def device_ms_by_kind(fn, kinds) -> dict | None:
    """Device ms of one call of ``fn`` from ``torch.profiler``, summed over
    the events whose name holds each kind's word (case-insensitive; the
    first kind that matches wins; the rest is "other"); None when the
    profiler sees no device time."""
    events = device_events(fn)
    if events is None:
        return None
    ms = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for name, t in events:
        kind = next((k for k, word in kinds if word.lower() in name.lower()),
                    "other")
        ms[kind] += t
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
    bad, worst = prefix_bound_misses(
        got, ref64, abs64, bc, *ps.k3_bound_constants(x.dtype, N_SCAN))
    check.true(f"F K3: {bad} elements outside the summation bound", bad == 0)
    bad_p, _ = prefix_bound_misses(plain, ref64, abs64, bc,
                                   *ps.walk_bound_constants(N_SCAN))
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


def hold_attention(check, what, q, k, v, out, plain=None):
    """K8's ``out`` against its plain version and the oracle (see the
    tolerances); returns the row's error fields."""
    plain = fa.flash_attention_plain(q, k, v) if plain is None else plain
    bound = attn_bound(q, k, v)
    res = {}
    for name, want in (("plain", plain), ("oracle", oracle_attention(q, k, v))):
        bad, err, over = attn_misses(out, want, bound)
        check.true(f"{what} vs {name}: {bad} elements outside the bound",
                   bad == 0)
        res[f"max_abs_err_{name}"] = err
        res[f"over_one_bf16_ulp_{name}"] = over
        print(f"{what} vs {name}: max |Δ| {err:.3e}, {bad} outside the "
              f"bound" + ("" if over is None else
                          f", {over} beyond one bf16 ulp"), flush=True)
    return res


def hold_f64(check, what, q, k, v, out, plain, noise: float = 0.0) -> dict:
    """K8's bf16 ``out`` against the float64 result (see the tolerances):
    every element within its own bound, and no more elements beyond one
    bf16 ulp of it than ``plain`` has, give or take ``noise`` standard
    deviations of that difference (√ of the elements beyond one ulp for
    one of the two alone)."""
    res = attn_f64_misses(out, plain, q, k, v)
    got = res["over_one_bf16_ulp_f64"]
    want = res["plain_over_one_bf16_ulp_f64"]
    slack = noise * math.sqrt(res["over_alone"] + res["plain_over_alone"])
    print(f"{what}: {got} elements beyond one bf16 ulp of the float64 "
          f"result, the plain version {want} (allowed {want + slack:.1f}); "
          f"{res['outside_element_bound_f64']} outside their bound",
          flush=True)
    check.true(f"{what}: {res['outside_element_bound_f64']} elements "
               f"outside their bound against float64",
               res["outside_element_bound_f64"] == 0)
    check.true(f"{what}: {got} elements beyond one bf16 ulp of the float64 "
               f"result, more than the plain version's {want} + "
               f"{slack:.1f}", got <= want + slack)
    return res


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN included), through an integer view."""
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def special_topk_rows(seed: int, shape, dtype, device) -> torch.Tensor:
    """Rows of float32 bit patterns (bfloat16: their upper half): row 0
    eight -0.0, eight +0.0, then -1.0; row 1 all NaN; row 2 all sign-bit
    NaN; the rest drawn from ±0.0, NaN of either sign, ±inf, ±1.0, 2.5."""
    rng = np.random.default_rng(seed)
    pool = np.array([0x80000000, 0x0, 0x7FC00000, 0xFFC00000, 0x7F800000,
                     0xFF800000, 0x3F800000, 0xBF800000, 0x40200000],
                    np.uint32)
    bits = rng.choice(pool, shape)
    bits[0] = 0xBF800000
    bits[0, :8], bits[0, 8:16] = 0x80000000, 0x0
    bits[1], bits[2] = 0x7FC00000, 0xFFC00000
    if dtype == torch.bfloat16:
        half = (bits >> 16).astype(np.uint16).view(np.int16)
        return torch.from_numpy(half).to(device).view(torch.bfloat16)
    return torch.from_numpy(bits.view(np.int32)).to(device).view(
        torch.float32)


def hold_topk(check, what, x, k, vals, idx, npow=None, plain=True):
    """K7's (vals, idx) of x (rows standing for rows of npow) against the
    oracle on the padded rows and, where ``plain``, the plain network."""
    xp = tk.pad_to(x, x.shape[1] if npow is None else npow)
    wants = [("oracle", ref.topk(xp, k))]
    if plain:
        wants.append(("plain", tk.topk_plain(xp, k)))
    for name, (wv, wi) in wants:
        check.true(f"{what} values vs {name}: not bit-exact",
                   same_bits(vals, wv))
        check.exact(f"{what} indices vs {name}", idx, wi)
    return max_abs(vals.float(), wants[-1][1][0].float()) if plain else 0.0


def topk_row(case, launches, err, x, k, npow, **extra):
    """One K7 row: the rows read once and k values and int32 indices
    written a row; one comparison a key."""
    return entry(
        case, launches, err, time_ms(lambda: tk.K7(x, k, npow)),
        time_ms(lambda: tk.topk_plain(tk.pad_to(x, npow), k), reps=5),
        x.numel() * x.element_size() + x.shape[0] * k * (x.element_size()
                                                         + 4),
        x.numel(), time_ms(lambda: torch.topk(x, k)), kernel="K7", k=k,
        npow=npow, **extra)


def run_phase_h(dev, check, rows):
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_config()
    n_l = cfg.n_layers
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 8), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(SEED + 9, cfg, LM_BATCH, LM_PROMPT, dev)

    # the main path: the server, with its launches counted
    with Tap(tk, "topk_kernel") as t7, Tap(fa, "K8") as t8, \
            Tap(serve, "sample") as ts:
        K3.launches = K7.launches = K8.launches = K8.aligned_copies = 0
        tokens, prefill_s, decode_s = phase_h(cfg, params, prompts, LM_GEN,
                                              "auto")
        launches = {"K3": K3.launches, "K7": K7.launches, "K8": K8.launches}
        k8_copies = K8.aligned_copies
    for name, want in (("K3", n_l * LM_GEN), ("K7", n_l * LM_GEN),
                       ("K8", n_l)):
        check.true(f"H: {launches[name]} {name} launches, want {want}",
                   launches[name] == want)
    check.true(f"H tokens: {tuple(tokens.shape)}, want ({LM_BATCH}, "
               f"{LM_GEN}) ids below {cfg.vocab}",
               tuple(tokens.shape) == (LM_BATCH, LM_GEN)
               and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    logits = [args[0] for args, _, _ in ts.calls]
    check.true(f"H: {len(logits)} logits sampled, want {LM_GEN}",
               len(logits) == LM_GEN)
    for i, lg in enumerate(logits):
        check.shaped(f"H logits of step {i}", lg, (LM_BATCH, cfg.vocab))
    cold_s = (prefill_s, decode_s)       # the first run builds and loads
    again, prefill_s, decode_s = phase_h(cfg, params, prompts, LM_GEN, "auto")
    check.exact("H greedy tokens, run 2 vs run 1", again, tokens)

    # the kernels on the path's own inputs (the router's rows in place)
    (x7, k7), kw7, (v7, i7) = t7.calls[0]
    npow7 = kw7["npow"]
    check.true(f"H K7: router rows {tuple(x7.shape)} standing for "
               f"{npow7}, want {cfg.n_experts} in place",
               x7.shape[1] == cfg.n_experts and npow7 > x7.shape[1])
    err7 = hold_topk(check, "H K7 prefill", x7, k7, v7, i7, npow7)
    (xd, kd), _, (vd, idd) = t7.calls[n_l]
    errd = hold_topk(check, "H K7 decode", xd, kd, vd, idd, npow7)
    (q, kk, vv), kw8, o8 = t8.calls[0]
    plain8 = fa.flash_attention_plain(q, kk, vv, causal=kw8["causal"])
    res8 = hold_attention(check, "H K8 prefill layer 0", q, kk, vv, o8,
                          plain8)
    res8.update(hold_f64(check, "H K8 prefill layer 0", q, kk, vv, o8,
                         plain8))
    x3 = torch.nn.functional.one_hot(i7.reshape(-1).long(),
                                     cfg.n_experts).float().T.contiguous()
    got3 = ps.prefix_sum_kernel(x3)
    plain3 = ps.prefix_sum_kernel(x3, interpret=True)
    check.exact("H K3 vs plain", got3, plain3)
    check.exact("H K3 vs cumsum", got3, torch.cumsum(x3, 1))

    # the same request through the plain path (printed, not gated)
    with Tap(tk, "topk_kernel") as p7, Tap(serve, "sample") as psamp:
        plain_tokens = phase_h(cfg, params, prompts, LM_GEN, "interpret")[0]
    plain_path = {
        "max_abs_logit_diff_prefill": max_abs(logits[0],
                                              psamp.calls[0][0][0]),
        "routing_agreement_prefill": float(np.mean([
            routing_agreement(t7.calls[i][2][1], p7.calls[i][2][1])
            for i in range(n_l)])),
        "tokens_agree": bool(torch.equal(plain_tokens, tokens))}
    print(f"H plain path (not gated): {json.dumps(plain_path)}", flush=True)
    del p7, psamp, plain_tokens

    # serving times: wall from generate, device from CUDA events
    pre = time_ms(lambda: M.prefill(cfg, params, {"tokens": prompts}),
                  reps=3, warmup=1)
    lg, cache = M.prefill(cfg, params, {"tokens": prompts})
    cache = M.grow_cache(cfg, cache, LM_PROMPT, LM_PROMPT + LM_GEN)
    tok = serve.sample(lg, None, 0.0)
    dec = time_ms(lambda: M.decode_step(cfg, params, cache, tok, LM_PROMPT),
                  reps=5, warmup=1)
    by_kind = {
        "prefill": device_ms_by_kind(
            lambda: M.prefill(cfg, params, {"tokens": prompts}), LM_KINDS),
        "decode_step": device_ms_by_kind(
            lambda: M.decode_step(cfg, params, cache, tok, LM_PROMPT),
            LM_KINDS)}
    del lg, cache
    summary = {
        "phase": "H", "model": LM_ARCH, "reduced": LM_REDUCED,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "weight_bytes": weight_bytes(cfg), "init_s": init_s,
        "prefill_wall_ms": prefill_s * 1e3,
        "decode_wall_ms_per_token": decode_s / (LM_GEN - 1) * 1e3,
        "cold_prefill_wall_ms": cold_s[0] * 1e3,
        "cold_decode_wall_ms_per_token": cold_s[1] / (LM_GEN - 1) * 1e3,
        "prefill_device_ms": pre[0], "decode_device_ms_per_token": dec[0],
        "device_ms_by_kind": by_kind,
        "device_idle_share": {
            "prefill": None if by_kind["prefill"] is None else
            1 - sum(by_kind["prefill"].values()) / (prefill_s * 1e3),
            "decode": None if by_kind["decode_step"] is None else
            1 - sum(by_kind["decode_step"].values())
            / (decode_s / (LM_GEN - 1) * 1e3)},
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_tokens_per_s": LM_BATCH * (LM_GEN - 1) / decode_s,
        "launches": launches, "plain_path": plain_path,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(json.dumps({"serve": summary}), flush=True)

    # kernel rows at the path's shapes: K7's launches on the path are
    # those of both shapes (one a layer in prefill and in each decode step)
    k7_rows = [topk_row(
        f"H topk {tuple(x.shape)} in place of {npow7} float32 k={k7} "
        f"(router, {case})", launches["K7"], err, x, k7, npow7,
        launches_counted_in="main path (prefill and decode)")
        for case, x, err in (("prefill", x7, err7), ("decode", xd, errd))]
    rows.extend(k7_rows)
    bh, sq, d, sk = q.shape[0] * q.shape[1], q.shape[2], q.shape[3], kk.shape[2]
    pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))   # causal
    k8_row = entry(
        f"H flash_attention {tuple(q.shape)} bfloat16 causal (prefill)",
        launches["K8"], res8["max_abs_err_plain"],
        time_ms(lambda: fa.K8(q, kk, vv)),
        time_ms(lambda: fa.flash_attention_plain(q, kk, vv), reps=5),
        4 * q.numel() * q.element_size(), 4 * bh * pairs * d,
        time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, is_causal=True)),
        kernel="K8", peak="bf16 tensor", aligned_copies=k8_copies, **res8)
    rows.append(k8_row)
    rows.append(entry(
        f"H prefix_sum {tuple(x3.shape)} float32 (router slots, prefill)",
        launches["K3"], max_abs(got3, plain3),
        time_ms(lambda: ps.prefix_sum_kernel(x3)),
        time_ms(lambda: ps.prefix_sum_kernel(x3, interpret=True), reps=5),
        8 * x3.numel(), x3.numel(), time_ms(lambda: torch.cumsum(x3, 1)),
        kernel="K3", block=list(ps.block_shape(*x3.shape))))
    del params, t7, t8, ts, q, kk, vv, o8, plain8
    torch.cuda.empty_cache()

    # one router top-k call at the prefill's shape in a torch.profiler
    # trace (the weights freed): one K7 kernel, no padding copy
    router = device_kernels(lambda: ops.topk(x7, k7))
    names = None if router is None else [name for name, _ in router]
    check.true(f"H: a router top-k call ran {names}, want one K7 kernel "
               f"and no concatenation",
               names is not None and len(names) == 1
               and "k7_topk" in names[0])
    k7_rows[0]["device_kernels"] = router

    # off the path, at the same shapes
    rng = np.random.default_rng(SEED + 10)
    ties = torch.from_numpy(rng.integers(0, 4, x7.shape).astype(np.float32))
    ties[0] = 0.0                                  # one row of one value
    for case, x in (("float32 ties", ties.to(dev)),
                    ("bfloat16", x7.to(torch.bfloat16)),
                    ("int32", torch.from_numpy(rng.integers(
                        -10_000, 10_000, x7.shape, dtype=np.int32)).to(dev))):
        hold_topk(check, f"H K7 {case}", x, k7, *tk.K7(x, k7, npow7), npow7)
    # ±0.0 and NaN of either sign: the oracle's order (the plain network
    # compares values as floats and differs there)
    for dt in (torch.float32, torch.bfloat16):
        x = special_topk_rows(SEED + 13, tuple(x7.shape), dt, dev)
        hold_topk(check, f"H K7 ±0.0/NaN {dt}", x, k7,
                  *tk.K7(x, k7, npow7), npow7, plain=False)
    # rows above the full network's 4096 (the partial walk, k ≤ 32), and
    # the full network (k > 32) at the prefill's padded width
    wide = torch.from_numpy(rng.standard_normal(TOPK_WIDE, dtype=np.float32)
                            ).to(dev)
    full = tk.pad_to(x7, npow7)
    for case, x, k in ((f"{TOPK_WIDE} float32 k=8", wide, 8),
                       (f"{tuple(full.shape)} float32 k={TOPK_FULL_K} "
                        f"(full network)", full, TOPK_FULL_K)):
        K7.launches = 0
        vals, idx = tk.topk_kernel(x, k)
        own = K7.launches
        err = hold_topk(check, f"H K7 {case}", x, k, vals, idx)
        rows.append(topk_row(f"H topk {case}", own, err, x, k, x.shape[1],
                             launches_counted_in="own call"))
    del wide, full
    shape_q = (LM_BATCH, cfg.n_heads, LM_PROMPT, cfg.head_dim)
    for case, sq_, dt in (("causal sq < sk bfloat16", LM_PROMPT // 2,
                           torch.bfloat16),
                          ("float32", LM_PROMPT, torch.float32)):
        q, kk, vv = (torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(dev, dt)
            for s in (shape_q[:2] + (sq_,) + shape_q[3:], shape_q, shape_q))
        hold_attention(check, f"H K8 {case}", q, kk, vv, fa.K8(q, kk, vv))
        del q, kk, vv
    # the prefill's shape at unit-scale logits, where softmax rows are
    # spread and p·v's roundings show (the path's ~10³ logits make rows
    # nearly one-hot)
    q, kk, vv = (torch.from_numpy(rng.standard_normal(
        shape_q, dtype=np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    o8, plain8 = fa.K8(q, kk, vv), fa.flash_attention_plain(q, kk, vv)
    what = "H K8 causal bfloat16 unit-scale logits"
    k8_row["unit_scale_logits"] = hold_attention(check, what, q, kk, vv, o8,
                                                 plain8)
    k8_row["unit_scale_logits"].update(hold_f64(
        check, what, q, kk, vv, o8, plain8, noise=UNIT_SCALE_NOISE))
    del q, kk, vv, o8, plain8


def outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


CHUNK = 1 << 22                    # phase I: elements a chunked check holds


def hold_plan(check, what, plan, got, x, b, scalars) -> float:
    """Each output of a tenant B plan against ``plan.ref`` (the FMA bound)
    and the plain path, chunk by chunk (elementwise programs, so a chunk
    of the inputs gives that chunk of the outputs); returns max |Δ| to
    plain."""
    kind = plan.graph.name.removeprefix("c0_")
    err, bad = 0.0, [0] * len(got)
    for lo in range(0, x.numel(), CHUNK):
        xc, bc = x[lo:lo + CHUNK], b[lo:lo + CHUNK]
        refs = outputs(plan.ref(xc, bc, *scalars))
        plains = outputs(plan(xc, bc, *scalars, mode="interpret"))
        for k, (g, r, pl, t) in enumerate(zip(got, refs, plains,
                                              plan_terms(kind, xc, bc))):
            gc = g[lo:lo + CHUNK]
            bad[k] += int(((gc - r).abs() > 4 * EPS * t).sum())
            err = max(err, max_abs(gc, pl))
    for k, n in enumerate(bad):
        check.true(f"{what} output {k} vs ref: {n} elements outside the "
                   f"FMA bound", n == 0)
    return err


def batch_table(report, names) -> list[dict]:
    """Per batch of a scheduler run: lane, round, predicted and observed
    ms (the per-item shares summed: the batch's estimate and its wall
    time) and their ratio."""
    groups: dict = {}
    for p in report.placements:
        groups.setdefault(p.batch_seq, []).append(p)
    table = []
    for seq, ps in sorted(groups.items()):
        pred = sum(p.predicted_s for p in ps) * 1e3
        obs = sum(p.observed_s for p in ps) * 1e3
        table.append({"batch": names[seq], "items": len(ps),
                      "lane": ps[0].lane, "round": ps[0].round,
                      "predicted_ms": pred, "observed_ms": obs,
                      "observed_over_predicted": obs / pred})
    return table


def run_phase_i(dev, check, rows):
    t0 = time.perf_counter()
    plans = sched_plans(N_SCHED_PLAN)
    partition_s = time.perf_counter() - t0
    check.true(f"I: plans split {[p.chains() for p in plans]}, want two "
               f"parts each", all(p.n_parts == 2 for p in plans))
    def a_inputs():
        arrays = make_inputs(SEED + 12, [N_SCHED_ITEM] * (2 * N_SCHED_ITEMS),
                             dev)
        return arrays[:N_SCHED_ITEMS], arrays[N_SCHED_ITEMS:]
    xs, bs = a_inputs()
    x, b = make_inputs(SEED + 15, [N_SCHED_PLAN] * 2, dev)
    fused = isa.fuse("c0_scale", "c0_add")
    shared = CostModel(hierarchy=H100)     # runs whose estimates go unread
    marks = {}                             # peak bytes after each step

    def mark(step):
        marks[step] = [torch.cuda.memory_allocated(dev),
                       torch.cuda.max_memory_allocated(dev)]
    scalars = ((PLAN_S, PLAN_T), (SAX_A, SAX_B))

    # the main path: both tenants through the scheduler, launches counted
    # and the run recorded
    rec = TraceRecorder()
    K1.launches = K1.item_copies = 0
    t0 = time.perf_counter()
    rep, a_items, b_items = phase_i(xs, bs, x, b, plans, "auto",
                                    recorder=rec)
    cold_run_s = time.perf_counter() - t0
    launches, copies = K1.launches, K1.item_copies
    want = 1 + sum(p.n_parts for p in plans)
    check.true(f"I: {launches} K1 launches, want {want} (one for A's "
               f"batch, one per plan part)", launches == want)
    check.true(f"I: {copies} batch items copied, want 0", copies == 0)
    a_seqs = {it.seq for it in a_items}
    check.true("I: A's requests did not run as one coalesced batch",
               len({p.batch_seq for p in rep.placements
                    if p.seq in a_seqs}) == 1
               and all(p.coalesced for p in rep.placements
                       if p.seq in a_seqs))
    names = {a_items[0].seq: f"A {N_SCHED_ITEMS}x scale+add",
             b_items[0].seq: "B axpby_residual", b_items[1].seq: "B saxpby"}
    mark("main run")

    # every result against its own solo call (bit for bit), ref and plain
    errs_a = []
    for it, xa, ba in zip(a_items, xs, bs):
        got = rep.results.pop(it.seq)
        it.result = None
        check.shaped(f"I A item {it.seq}", got, xa.shape)
        check.exact(f"I A item {it.seq} vs its solo call", got,
                    fused(SCALE, xa, ba, mode="kernel"))
        bound = fma_bound((SCALE * xa, ba))
        check.within(f"I A item {it.seq} vs ref", got,
                     fused(SCALE, xa, ba, mode="ref"), bound)
        errs_a.append(max_abs(got, fused(SCALE, xa, ba, mode="interpret")))
        del got, bound
    mark("A's checks")
    a0, b0, b1 = a_items[0].seq, b_items[0].seq, b_items[1].seq
    got_b = [outputs(rep.results.pop(seq)) for seq in (b0, b1)]
    del a_items, b_items, it, xa, ba, xs, bs   # A's inputs, made anew below
    errs_b = []
    for plan, sc, got in zip(plans, scalars, got_b):
        what = f"I B {plan.graph.name}"
        for k, (g, w) in enumerate(zip(got, outputs(
                plan(x, b, *sc, mode="kernel")))):
            check.shaped(f"{what} output {k}", g, x.shape)
            check.exact(f"{what} output {k} vs its solo call", g, w)
        del g, w                       # the loop's last output and solo
        errs_b.append(hold_plan(check, what, plan, got, x, b, sc))
        mark(f"{what} checks")
    del got_b, rep, got

    # the recorded wall run replays: the same decisions, and the replay
    # replays itself exactly (placements_match)
    rec2 = TraceRecorder()
    rep_r = replay(TraceRecorder.loads(rec.dumps()), recorder=rec2)
    rep_rr = replay(TraceRecorder.loads(rec2.dumps()))

    def decisions(ps):
        return [(p.seq, p.lane, p.round, p.batch_seq, p.predicted_s)
                for p in ps]
    wall_places = rec.placements()
    xs, bs = a_inputs()
    replay_ok = {
        "decisions_match_wall_run": decisions(rep_r.placements)
        == decisions(wall_places),
        "placements_match": placements_match(rep_r.placements,
                                             rep_rr.placements)}
    check.true(f"I: replay {replay_ok}", all(replay_ok.values()))

    # one trace of the whole run: one K1 kernel for A's batch and one per
    # plan part, and nothing else on the device but the small host-to-
    # device table copies
    events = device_events(lambda: phase_i(xs, bs, x, b, plans, "auto",
                                           cost=shared))
    mark("trace")
    kernels = None
    if events is not None:
        kernels = [name for name, _ in events
                   if not name.startswith(("Memcpy", "Memset"))]
        n_batch = sum("k1_batch_kernel" in k for k in kernels)
        n_part = sum("k1_kernel" in k for k in kernels)
        check.true(f"I: the run's kernels {kernels}, want one "
                   f"k1_batch_kernel and {want - 1} k1_kernel",
                   len(kernels) == want and n_batch == 1
                   and n_part == want - 1)
        dtod = [name for name, _ in events
                if name.startswith("Memcpy") and "HtoD" not in name]
        check.true(f"I: device copies {dtod}, want none", not dtod)

    # a warm run: each batch's predicted (CostModel over the H100 preset)
    # and observed ms
    t0 = time.perf_counter()
    rep2, a2, b2 = phase_i(xs, bs, x, b, plans, "auto")
    warm_run_s = time.perf_counter() - t0
    drift = batch_table(rep2, {a2[0].seq: names[a0],
                               b2[0].seq: names[b0],
                               b2[1].seq: names[b1]})
    del rep2, a2, b2
    mark("trace and warm run")

    # kernel rows: each batch's launches, timed on the run's own inputs
    # (one tenant's inputs at a time: the plain versions' temporaries)
    del x, b
    reqs = [(SCALE, xa, ba) for xa, ba in zip(xs, bs)]
    n_a = N_SCHED_ITEM * N_SCHED_ITEMS
    timed = time_ms(lambda: fused.program.call_batch(reqs))
    plain = time_ms(lambda: fused.program.call_batch(reqs, interpret=True))
    x2, b2s = torch.stack(xs), torch.stack(bs)
    rows.append(entry(
        f"I sched A: call_batch {N_SCHED_ITEMS}x scale+add, one scalar",
        1, max(errs_a), timed, plain, 12 * n_a, 2 * n_a,
        time_ms(lambda: torch.add(b2s, x2, alpha=SCALE)),
        launches_counted_in="phase I's scheduler run"))
    del x2, b2s, xs, bs, reqs
    mark("A's row")
    x, b = make_inputs(SEED + 15, [N_SCHED_PLAN] * 2, dev)
    fusion = {}
    for plan, sc, err, n_out in zip(plans, scalars, errs_b, (2, 1)):
        unfused = partition(plan.graph, model=H100, n_elems=N_SCHED_PLAN,
                            method="singletons")
        timed = time_ms(lambda: plan(x, b, *sc, mode="kernel"))
        unf = time_ms(lambda: unfused(x, b, *sc, mode="kernel"))
        name = plan.graph.name
        fusion[name] = {
            "parts": plan.n_parts, "chains": plan.chains(),
            "device_ms": timed[0], "unfused_parts": unfused.n_parts,
            "unfused_device_ms": unf[0],
            "unfused_over_fused": unf[0] / timed[0],
            "hbm_bytes": plan.modeled_hbm_bytes(),
            "unfused_hbm_bytes": unfused.modeled_hbm_bytes(),
            "predicted_ms": plan.predicted_time(overlap=False) * 1e3,
            "unfused_predicted_ms":
                unfused.predicted_time(overlap=False) * 1e3}
        rows.append(entry(
            f"I sched B: plan {name}, {plan.n_parts} parts",
            plan.n_parts, err, timed,
            time_ms(lambda: plan(x, b, *sc, mode="interpret"), reps=5),
            (2 + n_out) * 4 * N_SCHED_PLAN, plan.graph.flops(N_SCHED_PLAN),
            None,
            launches_counted_in="phase I's scheduler run",
            unfused_ms=unf[0]))
    del x, b
    mark("B's rows")

    # host overhead: the same mix at N = 2^12, wall per batch less device
    small = make_inputs(SEED + 13, [N_HOST] * (2 * N_SCHED_ITEMS + 2), dev)
    sx, sb = small[:N_SCHED_ITEMS], small[N_SCHED_ITEMS:-2]
    px, pb = small[-2:]
    small_plans = sched_plans(N_HOST)
    walls: dict = {}
    for _ in range(HOST_REPS):
        rep3, a3, b3 = phase_i(sx, sb, px, pb, small_plans, "auto",
                               cost=shared)
        kinds = {a3[0].seq: "A", b3[0].seq: "B axpby_residual",
                 b3[1].seq: "B saxpby"}
        for row in batch_table(rep3, kinds):
            walls.setdefault(row["batch"], []).append(row["observed_ms"])
    sreqs = [(SCALE, xa, ba) for xa, ba in zip(sx, sb)]
    device = {"A": time_ms(lambda: fused.program.call_batch(sreqs))[0],
              "B axpby_residual": time_ms(lambda: small_plans[0](
                  px, pb, PLAN_S, PLAN_T, mode="kernel"))[0],
              "B saxpby": time_ms(lambda: small_plans[1](
                  px, pb, SAX_A, SAX_B, mode="kernel"))[0]}
    host = {k: {"wall_ms_median": float(np.median(v)),
                "device_ms": device[k],
                "host_us": (float(np.median(v)) - device[k]) * 1e3}
            for k, v in walls.items()}
    del small, sx, sb, px, pb

    # H100_HBM.overhead_s by least squares: c0_copy device s against
    # bytes, t = overhead_s + bytes / peak_bw, over the sizes that fill
    # whole 8 × 1024 tiles (a smaller copy also launches a pad kernel,
    # core/stream.py flatten_to_blocks; its times are kept beside)
    tile = stream_copy.COPY.block_rows * stream_copy.COPY.block_cols
    times = {}
    for n in FIT_NS:
        (xf,) = make_inputs(SEED + 14, [n], dev)
        times[n] = time_ms(lambda: ops.stream_copy(xf, mode="kernel"))[0]
    whole = [n for n in FIT_NS if n % tile == 0]
    A = np.array([[1.0, 8.0 * n] for n in whole])
    t_s = np.array([times[n] * 1e-3 for n in whole])
    (c0, c1), *_ = np.linalg.lstsq(A, t_s, rcond=None)
    fit = {"n": whole, "bytes": [8 * n for n in whole],
           "device_s": t_s.tolist(), "overhead_s": float(c0),
           "peak_bw_bytes_per_s": float(1 / c1) if c1 > 0 else None,
           "max_rel_residual": float(np.max(np.abs(A @ [c0, c1] - t_s)
                                            / t_s)),
           "assumed_overhead_s": H100.dram.overhead_s,
           "padded_n_device_s": {str(n): times[n] * 1e-3 for n in FIT_NS
                                 if n % tile}}

    summary = {"phase": "I", "card": CARD, "policy": "wfq", "n_lanes": 2,
               "clock": "wall", "hierarchy": H100.name,
               "partition_s": partition_s, "cold_run_s": cold_run_s,
               "warm_run_s": warm_run_s, "launches": launches,
               "device_kernels": kernels, "batches": drift,
               "fusion": fusion, "host_per_dispatch_at_n": N_HOST,
               "host_per_dispatch": host, "overhead_fit": fit,
               "replay": replay_ok, "peak_bytes_after": marks,
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(json.dumps({"sched": summary}), flush=True)


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
    global CARD
    CARD = smi
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    check, rows = Check(), []
    failed = []
    peaks = {}
    t_start = time.perf_counter()
    _cuda.build_all()           # every CUDA source, one nvcc each, at once
    print(f"nvcc: {time.perf_counter() - t_start:.1f} s", file=sys.stderr,
          flush=True)
    cuda_report()
    for name, phase in (("A", run_phase_a), ("B", run_phase_b),
                        ("C", run_phase_c), ("D", run_phase_d),
                        ("E", run_phase_e), ("F", run_phase_f),
                        ("G", run_phase_g), ("H", run_phase_h),
                        ("I", run_phase_i)):
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
    print(json.dumps({"kernels": rows, "cuda_sources": CUDA_REPORT,
                      "peak_bytes": max(peaks.values()),
                      "peak_bytes_by_phase": peaks,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

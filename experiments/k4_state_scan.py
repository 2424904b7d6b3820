"""K4's state-scan entry against the ways it could have been written, on
the H100.

The c4_statescan kernel path scans the SSD states (B, C, H, P, N) along
the chunk axis with a decay (B, C, H). Three ways, at ``chip_smoke.py``
phase G's shape (Mamba2-1.3B, 4 × 8192 tokens), Hymba-1.5B's (P·N = 800)
and a ragged one, decays in (0, 1] from seeded numpy:

* ``copies``: K4 (``k4_chunk_scan``) on the decay broadcast to state
  rank and both moved so the chunks are the last axis (the former path;
  its launch alone is timed too, as ``k4_on_copies``; and, as
  ``triton_k4_on_copies``, the same launch of K4 as it was written in
  Triton before it moved to Gluon, its source below, whose register
  layout Triton picked from its loads);
* ``triton_in_place``: a plain Triton kernel (its source below) that
  reads the states where they lie with the same (br, bc) blocks and the
  same ``tl.associative_scan``; Triton picks its scan's register layout
  from these loads;
* ``entry``: the port's state-scan entry (``K4.state_scan``, Gluon),
  which loads along the payload rows and scans in the layout K4 states
  for both its entries (``prefix_scan.scan_layout``).

Each is held bit for bit against ``copies`` (elements that differ, max
|Δ|) and timed (``chip_smoke.time_ms``: device ms). One JSON line per
shape with the card's name and power limit. Needs the card; run from
the root of a checkout:

    python3 experiments/k4_state_scan.py
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {   # name: (decay shape, states shape)
    "G mamba2_1p3b": ((4, 32, 64), (4, 32, 64, 64, 128)),
    "hymba_1p5b": ((4, 8, 64), (4, 8, 64, 50, 16)),
    "ragged": ((3, 5, 7), (3, 5, 7, 9, 11)),
}

TRITON_IN_PLACE = '''
import triton
import triton.language as tl


@triton.jit
def _affine(pa, pb, qa, qb):
    return pa * qa, qb + qa * pb


@triton.jit
def k4_triton(A, B, O, rows, cols, stride_a, stride_b,
              BR: tl.constexpr, BC: tl.constexpr):
    r = tl.program_id(0).to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)
    arow = A + r[:, None] * stride_a
    brow = B + r[:, None] * stride_b
    orow = O + r[:, None] * cols
    last = (tl.arange(0, BC) == BC - 1)[None, :]
    carry = tl.zeros((BR,), O.dtype.element_ty)
    for c0 in range(0, cols, BC):
        c = c0 + tl.arange(0, BC)
        m = (r < rows)[:, None] & (c < cols)[None, :]
        a = tl.load(arow + c[None, :], mask=m, other=1).to(O.dtype.element_ty)
        b = tl.load(brow + c[None, :], mask=m, other=0).to(O.dtype.element_ty)
        acum, bcum = tl.associative_scan((a, b), 1, _affine)
        y = (acum * carry[:, None] + bcum).to(O.dtype.element_ty)
        tl.store(orow + c[None, :], y, mask=m)
        carry = tl.sum(tl.where(last, y, 0), axis=1).to(O.dtype.element_ty)


@triton.jit
def k4_in_place(A, S, O, n_rb, rows, cols, inner, a_in,
                BR: tl.constexpr, BC: tl.constexpr):
    pid = tl.program_id(0)
    g = pid // n_rb
    o = g // a_in
    ai = g % a_in
    sbase = o.to(tl.int64) * cols * inner + ai.to(tl.int64) * rows
    abase = o.to(tl.int64) * cols * a_in + ai
    r = (pid % n_rb) * BR + tl.arange(0, BR)
    last = (tl.arange(0, BC) == BC - 1)[None, :]
    carry = tl.zeros((BR,), O.dtype.element_ty)
    for c0 in range(0, cols, BC):
        c = c0 + tl.arange(0, BC)
        cm = c < cols
        m = (r < rows)[:, None] & cm[None, :]
        ac = tl.load(A + abase + c.to(tl.int64) * a_in, mask=cm, other=1)
        a = tl.broadcast_to(ac.to(O.dtype.element_ty)[None, :], (BR, BC))
        off = sbase + c.to(tl.int64)[None, :] * inner + r[:, None]
        b = tl.load(S + off, mask=m, other=0).to(O.dtype.element_ty)
        acum, bcum = tl.associative_scan((a, b), 1, _affine)
        y = (acum * carry[:, None] + bcum).to(O.dtype.element_ty)
        tl.store(O + off, y, mask=m)
        carry = tl.sum(tl.where(last, y, 0), axis=1).to(O.dtype.element_ty)
'''


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.fused_kernel import load_module
    from repro_torch.kernels import prefix_scan as ps
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("k4_state_scan: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    dev = torch.device("cuda", 0)
    variant = load_module(TRITON_IN_PLACE, prefix="k4variant")[0]

    def in_place(a, s):                 # axis 1, a at the states' rank
        out = torch.empty_like(s)
        rows_total, cols = s.numel() // s.shape[1], s.shape[1]
        br, bc = ps.block_shape(rows_total, cols)
        rows = s[0, 0, 0].numel()
        n_rb = -(-rows // br)
        variant.k4_in_place[(s.shape[0] * s.shape[2] * n_rb,)](
            a, s, out, n_rb, rows, cols, s[0, 0].numel(), s.shape[2],
            BR=br, BC=bc, num_warps=ps._num_warps(br, bc))
        return out

    def triton_k4(ab, bb):              # K4 as it was written in Triton
        out = torch.empty_like(bb)
        rows, cols = bb.shape
        br, bc = ps.block_shape(rows, cols)
        variant.k4_triton[(-(-rows // br),)](
            ab, bb, out, rows, cols, cols, cols, BR=br, BC=bc,
            num_warps=ps._num_warps(br, bc))
        return out

    rng = np.random.default_rng(0)
    for name, (a_shape, s_shape) in SHAPES.items():
        a = torch.from_numpy(np.exp(-np.abs(rng.standard_normal(
            a_shape, dtype=np.float32)))).to(dev)
        s = torch.from_numpy(rng.standard_normal(
            s_shape, dtype=np.float32)).to(dev)
        want = smoke.former_statescan(a, s)
        ab, bb = smoke.materialised(a, s)
        row = {"shape": name, "states": list(s_shape),
               "bound_ms": smoke.bound_ms(8 * s.numel() + 4 * a.numel(),
                                          2 * s.numel())[0],
               "copies_ms": smoke.time_ms(
                   lambda: smoke.former_statescan(a, s))[0],
               "k4_on_copies_ms": smoke.time_ms(
                   lambda: ps.chunk_scan_kernel(ab, bb))[0],
               "triton_k4_on_copies_ms": smoke.time_ms(
                   lambda: triton_k4(ab, bb))[0]}
        old = triton_k4(ab, bb).reshape(want.movedim(1, -1).shape)
        row["triton_k4_vs_gluon_k4"] = {
            "differing": int((old.movedim(-1, 1) != want).sum()),
            "max_abs_diff": float((old.movedim(-1, 1) - want).abs().max())}
        del ab, bb, old
        for way, fn in (("triton_in_place", lambda: in_place(a, s)),
                        ("entry", lambda: ps.K4.state_scan(a, s, 1))):
            got = fn()
            row[way] = {"differing": int((got != want).sum()),
                        "of": want.numel(),
                        "max_abs_diff": float((got - want).abs().max()),
                        "ms": smoke.time_ms(fn)[0]}
        br, bc = ps.block_shape(s.numel() // s.shape[1], s.shape[1])
        row["k4_scan_layout"] = ps.scan_layout(br, bc,
                                               ps._num_warps(br, bc))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

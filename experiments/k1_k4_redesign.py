"""K1's solo walk and K4's fold on the H100, against their former designs.

    python3 experiments/k1_k4_redesign.py [--phases a,b,d,o1,g,k,l] [--k1-designs] [--k4-walks] [--k1-sass] [--k4-rows]

Builds every CUDA source and prints K4's ptxas report (registers, spills),
then runs ``chip_smoke.py``'s K1 phases A, B, D and O1, its phase G, and
K4's rows at phase K's and L's shapes (L: forward, reverse walk and
c4_statescan's backward against the former path), each timing the new
kernel against the former one (``experiments/former_kernels.py``) in
turns, was, new, new, was, on the same inputs. With ``--k1-designs`` it
also times K1's solo kernel at A's, B's, D's and O1's shapes under other
walks: the port's under each of PORT_WALKS, and the former kernel's
source with one change each (FORMER_EDITS), in turns, forward then back,
each held bit for bit against the former kernel. With ``--k4-walks`` it
times K4's state walk under other vector widths (K4_WALKS). With
``--k1-sass`` it reads the global loads and stores in the SASS of K1's
solo kernel at A's, B's, D's and O1's cases (K1_SASS_CASES; the cubin
Triton compiled, disassembled with the ``cuobjdump`` that ships with
Triton), and times the same kernel with a 16-byte hint on its row
offsets against it, in turns, bit for bit. With ``--k4-rows`` it times
K4's rows entry at the shapes of K4_ROWS (few long rows to many short
ones) against the Gluon kernel (its route past 64 columns, the former
design below them) and, past 64 columns, against a fold of segments a
thread (``experiments/k4_rows_fold.cu``, built here with the port's
nvcc flags and held bit for bit to :func:`seg_plain`), in turns. Prints
the card, one JSON line per row and the checks that failed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# K1's solo walk, designs timed against the former kernel on the same
# (rows, cols) operands: the port's own walk under (K1_PREFETCH,
# K1_WIDE_WARPS), and the former kernel's source with one change each
# (loads marked evict_first, 1-D row offsets with a 16-byte hint, the next
# column step's loads issued before the current one is computed, a warp
# count)
PORT_WALKS = [(0, 8), (1, 8), (1, 16), (2, 16), (0, 16)]
FORMER_EDITS = [dict(), dict(evict=True), dict(offsets_1d=True),
                dict(prefetch=True), dict(warps=1), dict(warps=2),
                dict(warps=16)]


def edited_source(former, stages, n_ext, evict=False, offsets_1d=False,
                  prefetch=False) -> str:
    """The former solo kernel's source with the named edits."""
    lines = former.k1_solo_source(stages, n_ext).splitlines()
    out = []
    loads = [ln.strip() for ln in lines if "= tl.load(X" in ln]
    for ln in lines:
        st = ln.strip()
        if offsets_1d and st.startswith("base = rows[:, None] * row_len"):
            ln = ("    base = tl.multiple_of(rows * row_len, 4)[:, None] + "
                  "tl.arange(0, BC)[None, :]")
        if evict and "= tl.load(X" in st:
            ln = ln.replace(" + offs)", " + offs, eviction_policy="
                                        "'evict_first')")
        if prefetch:
            if st.startswith("for step in range(0, n_steps):"):
                out += ["    " + l.replace(" + offs", " + base").replace(
                    "x", "n", 1) for l in loads]
            elif st in loads:
                name = st.split(" = ")[0]
                src = st.split("(", 1)[1].split(" + offs")[0]
                out += [f"        {name} = n{name[1:]}",
                        f"        n{name[1:]} = tl.load({src} + offs + BC, "
                        f"mask=step + 1 < n_steps, other=0)"]
                continue
        out.append(ln)
    return "\n".join(out) + "\n"


def edited_launch(cs, src, table, vectors, n_out, br, bc, warps=None,
                  out_specs=None):
    """One launch of an edited former kernel, as the former wrapper."""
    kernel = cs.fk.load_module(src, prefix="k1var")[0].k1_kernel
    v0 = vectors[0]
    rows, cols = v0.shape
    widths = {}
    if out_specs is None:
        outs = [cs.torch.empty_like(v0) for _ in range(n_out)]
    else:
        outs = cs.fk._out_tensors(out_specs, v0.device)
        widths = cs.fk.out_block_widths(out_specs, bc, cols)
    args = ([table] if table.shape[1] else []) + list(vectors) + outs
    if warps is None:
        warps = 8 if br * bc >= 8192 else 4
    kernel[(rows // br,)](*args, cols // bc, cols, BR=br, BC=bc,
                          num_warps=warps, **widths)
    return outs


def k1_designs(cs, dev) -> list[dict]:
    """Device ms of each solo K1 case: the former kernel, the port's walk
    under PORT_WALKS and the former source under FORMER_EDITS, in turns
    (forward, then back), bits held against the former kernel."""
    import torch
    import former_kernels as former
    from repro_torch.core.program import _scalar_table
    from repro_torch.kernels import stream_copy
    a, b = cs.make_inputs(cs.SEED, [cs.N_STREAM, cs.N_STREAM], dev)
    (x,) = cs.make_inputs(cs.SEED + 3, [cs.ABSMAX_SHAPE], dev)
    (xo,) = cs.make_inputs(cs.SEED + 13, [cs.O1_SHAPE], dev)
    fused = cs.isa.fuse("c0_scale", "c0_add").program
    a2, b2 = a.view(-1, 1024), b.view(-1, 1024)
    cases = {   # name: (program, scalars, (rows, cols) operands, br, bc)
        "A c0_copy": (stream_copy.COPY.program(), (), [a2], 8, 1024),
        "A c0_add": (stream_copy.ADD.program(), (), [a2, b2], 8, 1024),
        "A c0_triad": (stream_copy.TRIAD.program(), (cs.TRIAD_S,),
                       [a2, b2], 8, 1024),
        "B c0_scale+c0_add": (fused, (cs.SCALE,), None, None, None),
        "D c7_absmax_scale": (cs.ABSMAX.program(), (), [x], 8, 128),
        "O1 to_bf16": (cs.TO_BF16.program(), (), [xo], 8, 1024),
        "O1 pairsum": (cs.PAIRSUM.program(), (), [xo], 8, 1024),
    }
    out = []
    for name, (prog, scalars, vecs, br, bc) in cases.items():
        if vecs is None:
            br, bc = prog.negotiate_geometry(cs.N_STREAM, a.dtype)[:2]
            vecs = [a.view(-1, bc), b.view(-1, bc)]
        stages, n_ext = prog.stages, tuple(prog._n_ext)
        table = _scalar_table([scalars], dev)
        n_out = stages[-1].n_vec_out
        out_specs = (None if stages[-1].shape_preserving
                     else prog._out_specs(vecs, bc))
        calls = {"was": lambda: former.k1_solo(stages, n_ext, table, vecs,
                                               n_out, br, bc, out_specs)}
        for pf, warps in PORT_WALKS:
            def port(pf=pf, warps=warps):
                saved = cs.fk.K1_PREFETCH, cs.fk.K1_WIDE_WARPS
                cs.fk.K1_PREFETCH, cs.fk.K1_WIDE_WARPS = pf, warps
                try:
                    kern = cs.fk.K1.compile(stages, n_ext)[0]
                    return cs.fk.K1(kern, table, vecs, n_out, br, bc,
                                    out_specs)
                finally:
                    cs.fk.K1_PREFETCH, cs.fk.K1_WIDE_WARPS = saved
            calls[f"port prefetch {pf}, {warps} wide warps"] = port
        for edit in FORMER_EDITS:
            warps = edit.get("warps")
            src = edited_source(former, stages, n_ext,
                                **{k: v for k, v in edit.items()
                                   if k != "warps"})
            calls["former " + (", ".join(f"{k}={v}" for k, v in edit.items())
                               or "as it was")] = (
                lambda src=src, warps=warps: edited_launch(
                    cs, src, table, vecs, n_out, br, bc, warps, out_specs))
        want = [t.clone() for t in calls["was"]()]
        bits = {k: all(cs.same_bits(g, w) for g, w in zip(fn(), want))
                for k, fn in calls.items()}
        ms = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                ms[k].append(cs.time_ms(calls[k])[0])
        row = {"case": name, "card": cs.CARD, "block": [br, bc], "ms": ms,
               "bits_equal_was": bits}
        print(json.dumps({"k1_design": row}), flush=True)
        out.append(row)
        del want
        torch.cuda.synchronize()
    return out


# K4's state walk under other vector widths than state_walk's (the ring
# follows from the width: the kernel's ring_depth), at phase K's, G's and
# L's shapes (L also the backward's reverse walk with da)
K4_WALKS = {
    "K": ((4, 8, 64, 50, 16), False, [1, 2, 4]),
    "G": ((4, 32, 64, 64, 128), False, [4, 2, 1]),
    "L": ((4, 16, 64, 64, 128), False, [4, 2]),
    "L da": ((4, 16, 64, 64, 128), True, [4, 2, 1]),
}


def k4_walks(cs, dev) -> list[dict]:
    """Device ms of K4's state walk under each vector width of K4_WALKS,
    in turns (forward, then back), with the former Gluon kernel and the
    port's own choice; outputs (and λ) bit for bit against the port's."""
    import former_kernels as former
    ps = cs.ps
    real = ps.state_walk
    out = []
    for label, (shape, da, walks) in K4_WALKS.items():
        a, s = cs.ssd_inputs(cs.SEED + 40, shape[:3], shape[3:], dev)
        if da:
            y = cs.K4.state_scan(a, s, 1)
            g = cs.ssd_inputs(cs.SEED + 41, shape[:3], shape[3:], dev)[1]
            run = lambda: ps.state_scan_grad(a, y, g, 1)       # noqa: E731
            was = lambda: former.state_scan_grad(a, y, g, 1)   # noqa: E731
        else:
            run = lambda: cs.K4.state_scan(a, s, 1)             # noqa: E731
            was = lambda: former.k4_state_scan(a, s, 1)         # noqa: E731

        def forced(vec):
            def call():
                ps.state_walk = lambda rows, cols, itemsize, da=False: dict(
                    real(rows, cols, itemsize, da), vec=vec,
                    sp=-(-(rows // vec) // 32) * 32)
                try:
                    return run()
                finally:
                    ps.state_walk = real
            return call

        want = cs.outputs(run())[-1].clone()
        calls = {"was": was, f"port {real(shape[3] * shape[4], shape[1], 4, da)}": run}
        calls.update({f"vec {v}": forced(v) for v in walks})
        bits = {k: bool(cs.torch.equal(cs.outputs(fn())[-1], want))
                for k, fn in calls.items() if k != "was"}
        ms = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                ms[k].append(cs.time_ms(calls[k])[0])
        row = {"case": label, "card": cs.CARD, "shape": list(shape),
               "ms": ms, "same_bits": bits}
        print(json.dumps({"k4_walk": row}), flush=True)
        out.append(row)
    return out


# K4's rows entry, (rows, cols): a few long rows to many short ones
K4_ROWS = [(1, 1), (1, 32), (8, 32), (1000, 32), (2097152, 32), (1, 96),
           (1, 1024), (8, 96), (8, 1024), (8, 4096), (3, 5000), (64, 1024),
           (1024, 1024), (4096, 4096)]
SEGMENT = 32                 # SEG of experiments/k4_rows_fold.cu


def seg_plain(a, b, reverse: bool = False):
    """The segmented fold of ``k4_rows_fold.cu`` in torch, bit for bit:
    segments of SEGMENT columns in walk order, each folded from 0 (l)
    beside the running product of its decays (q); the carry entering
    segment k is c_k = q·c_{k−1} + l at segment k − 1's end (segment 0's:
    its l), and y = q·c + l (segment 0: y = l)."""
    import torch
    if reverse:
        return seg_plain(a.flip(1), b.flip(1)).flip(1)
    rows, cols = a.shape
    pad = (-cols) % SEGMENT
    av = torch.nn.functional.pad(a, (0, pad), value=1).view(rows, -1, SEGMENT)
    bv = torch.nn.functional.pad(b, (0, pad), value=0).view(rows, -1, SEGMENT)
    ls, qs = [], []
    l = torch.zeros(av.shape[:2], dtype=a.dtype, device=a.device)
    for i in range(SEGMENT):
        l = av[:, :, i] * l + bv[:, :, i]
        q = av[:, :, i] if i == 0 else q * av[:, :, i]
        ls.append(l)
        qs.append(q)
    l, q = torch.stack(ls, -1), torch.stack(qs, -1)
    carry = torch.zeros(av.shape[:2], dtype=a.dtype, device=a.device)
    c = l[:, 0, -1]
    for k in range(1, av.shape[1]):
        carry[:, k] = c
        c = q[:, k, -1] * c + l[:, k, -1]
    y = q * carry[:, :, None] + l
    y[:, 0] = l[:, 0]
    return y.reshape(rows, -1)[:, :cols].contiguous()


def seg_kernel():
    """The segmented fold (``experiments/k4_rows_fold.cu``) built with the
    port's nvcc flags into the build directory, as a call (a, b) → out on
    float32 rows."""
    import ctypes
    import torch
    from repro_torch.kernels import _cuda
    src = ROOT / "experiments" / "k4_rows_fold.cu"
    out = _cuda.build_dir() / "cuda" / "k4_rows_fold.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I32, I64 = _cuda.P, _cuda.I32, _cuda.I64
    lib.k4_seg_scan.argtypes = [I32, P, P, P, I64, I64, I64, I64, I32, I32,
                                P]
    lib.k4_seg_scan.restype = ctypes.c_int

    def call(a, b):
        rows, cols = a.shape
        o = torch.empty_like(a)
        vec = 4 if cols % 4 == 0 else 1
        err = lib.k4_seg_scan(0, a.data_ptr(), b.data_ptr(), o.data_ptr(),
                              rows, cols, a.stride(0), b.stride(0), vec, 0,
                              torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o
    return call


def k4_rows(cs, dev) -> list[dict]:
    """Device ms of K4's rows entry, of the Gluon kernel (its route past
    64 columns, the former design below them) and, past 64 columns, of
    the segmented fold at each shape of K4_ROWS, in turns (forward, then
    back); the segmented fold bit for bit to :func:`seg_plain`."""
    import torch
    ps = cs.ps
    seg = seg_kernel()
    out = []
    for shape in K4_ROWS:
        a, b = cs.ssd_inputs(cs.SEED + 60, shape, (), dev)
        calls = {"port": lambda: ps.chunk_scan_kernel(a, b),
                 "gluon": lambda: ps.gluon_chunk_scan(a, b,
                                                      torch.empty_like(a))}
        row = {"shape": list(shape), "card": cs.CARD}
        if shape[1] > ps.K4_FOLD_COLS:
            calls["segmented fold"] = lambda: seg(a, b)
            row["fold_bits_equal_plain"] = bool(torch.equal(
                seg(a, b), seg_plain(a, b)))
        ms = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                ms[k].append(cs.time_ms(calls[k])[0])
        row["ms"] = ms
        print(json.dumps({"k4_rows": row}), flush=True)
        out.append(row)
    return out


class _Grab:
    """A Triton JIT function whose launch keeps the compiled kernel it
    ran (``fn[grid](...)`` returns it)."""

    def __init__(self, fn):
        self.fn, self.compiled = fn, None

    def __getitem__(self, grid):
        def run(*args, **kw):
            self.compiled = self.fn[grid](*args, **kw)
            return self.compiled
        return run


def global_accesses(compiled) -> dict:
    """Counts of the global load and store instructions of a compiled
    Triton kernel by their full opcode (``LDG.E.128``, ``STG.E.64``, …)
    in its SASS, and of the PTX's ``ld.global``/``st.global`` forms."""
    import re
    import shutil
    import tempfile
    import triton
    out = {"ptx": {}, "sass": None}
    for m in re.finditer(r"\b((?:ld|st)\.global[.\w:]*)", compiled.asm["ptx"]):
        op = re.sub(r"\.L1::\w+|\.L2::\w+", "", m.group(1))
        out["ptx"][op] = out["ptx"].get(op, 0) + 1
    tool = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
    if not tool.exists():
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    with tempfile.NamedTemporaryFile(suffix=".cubin", dir=ROOT / "build") as f:
        f.write(compiled.asm["cubin"])
        f.flush()
        proc = subprocess.run([str(tool), "-sass", f.name],
                              capture_output=True, text=True)
    if proc.returncode == 0:
        out["sass"] = {}
        for m in re.finditer(r"\b((?:LDG|STG)(?:\.[A-Z0-9_]+)*)",
                             proc.stdout):
            out["sass"][m.group(1)] = out["sass"].get(m.group(1), 0) + 1
    else:
        out["sass_error"] = proc.stderr[-500:]
    return out


# K1's solo cases whose SASS is read: (program, scalars, operands, block)
# as the main path launches them (A and B flat through Program.call_flat,
# D and O1 on (rows, cols) blocks through the template)
def k1_sass_cases(cs, dev) -> dict:
    from repro_torch.kernels import stream_copy
    a, b = cs.make_inputs(cs.SEED, [cs.N_STREAM, cs.N_STREAM], dev)
    (x,) = cs.make_inputs(cs.SEED + 3, [cs.ABSMAX_SHAPE], dev)
    (xo,) = cs.make_inputs(cs.SEED + 13, [cs.O1_SHAPE], dev)
    fused = cs.isa.fuse("c0_scale", "c0_add").program
    br, bc = fused.negotiate_geometry(cs.N_STREAM, a.dtype)[:2]
    rag = cs.N_STREAM - 1000
    return {
        "A c0_copy": (stream_copy.COPY.program(), (), [a], 8, 1024),
        "A c0_scale": (stream_copy.SCALE.program(), (cs.SCALE,), [a], 8,
                       1024),
        "A c0_add": (stream_copy.ADD.program(), (), [a, b], 8, 1024),
        "A c0_add ragged": (stream_copy.ADD.program(), (),
                            [a[:rag], b[:rag]], 8, 1024),
        "B c0_scale+c0_add": (fused, (cs.SCALE,), [a, b], br, bc),
        "D c7_absmax_scale": (cs.ABSMAX.program(), (), [x], 8, 128),
        "O1 to_bf16": (cs.TO_BF16.program(), (), [xo], 8, 1024),
        "O1 pairsum": (cs.PAIRSUM.program(), (), [xo], 8, 1024),
    }


def hinted_source(src: str) -> str:
    """K1's solo source with its row offsets declared multiples of 16
    elements (every case's row length is)."""
    old = "    base = rows[:, None] * row_len + tl.arange(0, BC)[None, :]"
    assert old in src
    return src.replace(old, "    base = tl.multiple_of(rows * row_len, 16)"
                            "[:, None] + tl.arange(0, BC)[None, :]")


def k1_sass(cs, dev) -> list[dict]:
    """Per K1_SASS case: the global accesses of the port's solo kernel and
    of the same kernel with hinted row offsets; the two timed in turns
    (port, hinted, hinted, port), bit for bit."""
    from repro_torch.core.program import _scalar_table
    out = []
    for name, (prog, scalars, vecs, br, bc) in k1_sass_cases(cs, dev).items():
        stages, n_ext = prog.stages, tuple(prog._n_ext)
        n = vecs[0].numel()
        ragged = vecs[0].ndim == 1 and n % (br * bc) != 0
        table = _scalar_table([scalars], dev)
        n_out = stages[-1].n_vec_out
        out_specs = (None if stages[-1].shape_preserving
                     else prog._out_specs(vecs, bc))
        src = cs.fk.kernel_source(stages, n_ext, False, ragged)
        kernels = {
            "port": cs.fk.load_module(src)[0].k1_kernel,
            "hinted": cs.fk.load_module(hinted_source(src),
                                        prefix="k1hint")[0].k1_kernel}
        row = {"case": name, "card": cs.CARD, "block": [br, bc],
               "ragged": ragged, "accesses": {}, "ms": {}}
        got = {}
        for key, kern in kernels.items():
            grab = _Grab(kern)
            got[key] = cs.fk.K1(grab, table, vecs, n_out, br, bc, out_specs)
            row["accesses"][key] = global_accesses(grab.compiled)
        row["bits_equal"] = all(cs.same_bits(g, w) for g, w in
                                zip(got["hinted"], got["port"]))
        del got

        def call(kern):
            return lambda: cs.fk.K1(kern, table, vecs, n_out, br, bc,
                                    out_specs)
        w1, n1, n2, w2 = (cs.time_ms(call(kernels[k]))[0]
                          for k in ("port", "hinted", "hinted", "port"))
        row["ms"] = {"port": [w1, w2], "hinted": [n1, n2]}
        print(json.dumps({"k1_sass": row}), flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="a,b,d,o1,g,k,l")
    ap.add_argument("--k1-designs", action="store_true")
    ap.add_argument("--k4-walks", action="store_true")
    ap.add_argument("--k1-sass", action="store_true")
    ap.add_argument("--k4-rows", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("k1_k4_redesign: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(cs.CARD, flush=True)
    for lib in cs._cuda.CSRC.parent.parent.parent.parent.glob(
            "build/repro_torch/cuda/prefix_scan_*.so"):
        lib.unlink()                   # rebuilt here, for ptxas's report
    cs._cuda.build_all()
    report = cs.cuda_report()
    print(json.dumps({"ptxas_prefix_scan": report.get("prefix_scan")}),
          flush=True)
    check, rows = cs.Check(), []
    for ph in args.phases.split(","):
        try:
            if ph == "k":
                shape = (4, 8, 64, 50, 16)
                a, s = cs.ssd_inputs(cs.SEED + 22, shape[:3], shape[3:], dev)
                rows.append(cs.k4_row(check, "K", a, s, 0, "chunk_scan_state",
                                      "not counted here"))
            elif ph == "l":
                cs.hold_train_scan(dev, check, rows, (4, 16, 64, 64, 128),
                                   {"K4 forward": 0, "K4 reverse": 0})
            else:
                getattr(cs, f"run_phase_{ph}")(dev, check, rows)
        except Exception:                       # report and go on
            import traceback
            traceback.print_exc()
            check.failures.append(f"phase {ph} raised")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for r in rows:
        print(json.dumps({"row": r}, default=str), flush=True)
    if args.k1_designs:
        k1_designs(cs, dev)
    if args.k4_walks:
        k4_walks(cs, dev)
    if args.k1_sass:
        k1_sass(cs, dev)
    if args.k4_rows:
        k4_rows(cs, dev)
    print(json.dumps({"failures": check.failures}), flush=True)
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())

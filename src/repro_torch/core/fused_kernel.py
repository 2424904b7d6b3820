"""K1 — the generic fused streaming kernel, in Triton for Hopper.

Replaces ``repro/core/program.py:Program._fused_kernel`` (built by
``_build_call``, carry reset in ``repro/core/template.py:emit_stage``):
the Pallas kernel that runs a chain of stage bodies back to back over a
grid of (parallel row blocks, sequential column blocks), keeps
intermediates in VMEM, reads scalars from SMEM (per item in a
mixed-scalar coalesced batch) and carries per-stage state across column
steps.

What bounds it on the H100: device-memory bytes. A launch must move
``(n_ext_vec_in + n_vec_out) · N · bytes`` through HBM (3.35 TB/s on the
H100 SXM); the stage bodies do a handful of operations per element,
far below the card's ~20 FP32 operations per byte. The design keeps
everything else off HBM:

* one generated ``@triton.jit`` kernel per chain identity; one program
  per row block, which loops over that block's column blocks itself —
  Hopper blocks run in no order, so a carry cannot pass between
  programs; it lives in registers, set to ``carry_init`` before the
  loop (this replaces ``pl.when(step == 0)``);
* intermediates stay in registers (rounded to the operand dtype, as the
  reference's VMEM scratch rounds them); only the last stage stores;
* scalars come from one ``(k_items, m)`` float32 device table; program
  ``pid`` reads row ``pid // items_div`` — ``items_div`` is the row
  blocks per item in a mixed-scalar batch and the whole grid otherwise,
  so solo and batched launches run the same kernel; no host sync;
* offsets are int64, since a stacked batch can pass 2³¹ elements.

Stage bodies arrive as Triton *source text* (:class:`Stage.triton_body`)
because ``triton.jit`` reads a function's source through ``inspect``:
the generator writes one module per chain into the build directory
(``build/repro_torch/`` under the checkout unless
``REPRO_TORCH_BUILD_DIR`` names another) and imports it from there.

:func:`emulate` is the plain PyTorch version of the same grid walk —
vectorised across all row blocks, looping over column steps, carry set
at step 0, per-item scalar rows — which ``interpret`` mode runs on any
device and which the chip smoke test holds the kernel against.
"""
from __future__ import annotations

import ast
import hashlib
import importlib.util
import os
import sys
import textwrap
from pathlib import Path
from typing import Sequence

import torch

from .stream import dtype_name
from .template import Stage, emit_stage

BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"


def build_dir() -> Path:
    """Where generated kernel sources go: ``$REPRO_TORCH_BUILD_DIR`` or
    ``build/repro_torch`` at the root of the checkout."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _split(stages: Sequence[Stage], n_ext: Sequence[int]):
    """Per stage: (scalar slice, external-vector slice)."""
    si = vi = 0
    out = []
    for st, ne in zip(stages, n_ext):
        out.append((slice(si, si + st.n_scalar_in), slice(vi, vi + ne)))
        si += st.n_scalar_in
        vi += ne
    return out


# ---------------------------------------------------------------------------
# the plain PyTorch version (``interpret`` mode)
# ---------------------------------------------------------------------------

def emulate(stages: Sequence[Stage], n_ext: Sequence[int],
            table: torch.Tensor, vectors: Sequence[torch.Tensor],
            block_rows: int, block_cols: int,
            items_div: int) -> list[torch.Tensor]:
    """K1's grid walk in torch eager, on the vectors' device.

    ``table`` is the ``(k_items, m)`` float32 scalar table; row block
    ``r`` reads row ``r // items_div``. Each column step runs every
    stage body once on all row blocks together."""
    rows, cols = vectors[0].shape
    nrb, ncs = rows // block_rows, cols // block_cols
    dev, dtype = vectors[0].device, vectors[0].dtype
    views = [v.view(nrb, block_rows, ncs, block_cols) for v in vectors]
    outs = [torch.empty((rows, cols), dtype=dtype, device=dev)
            for _ in range(stages[-1].n_vec_out)]
    out_views = [o.view(nrb, block_rows, ncs, block_cols) for o in outs]
    scal: list = []
    if table.shape[1]:
        item = torch.arange(nrb, device=dev) // items_div
        per_block = table.to(dev).index_select(0, item)
        scal = [per_block[:, j].view(nrb, 1, 1)
                for j in range(table.shape[1])]
    carries = [torch.full((nrb, block_rows, st.carry_cols), st.carry_init,
                          dtype=st.carry_dtype, device=dev)
               if st.carry_cols else None for st in stages]
    slices = _split(stages, n_ext)
    last = len(stages) - 1
    for step in range(ncs):
        ext = [v[:, :, step, :] for v in views]
        prev: tuple = ()
        for k, (st, (ss, vs)) in enumerate(zip(stages, slices)):
            outs_k, carries[k] = emit_stage(st, tuple(scal[ss]),
                                            prev + tuple(ext[vs]),
                                            carries[k], step)
            if k < last:       # intermediates round to the operand dtype
                outs_k = tuple(t.to(dtype) for t in outs_k)
            prev = outs_k
        for ov, t in zip(out_views, prev):
            ov[:, :, step, :] = t
    return outs


# ---------------------------------------------------------------------------
# Triton source generation
# ---------------------------------------------------------------------------

def _stage_function(st: Stage, fname: str) -> str:
    if st.triton_body is None:
        raise ValueError(f"{st.name}: stage has no Triton body; run it in "
                         f"'interpret' or 'ref' mode")
    tree = ast.parse(textwrap.dedent(st.triton_body))
    if len(tree.body) != 1 or not isinstance(tree.body[0], ast.FunctionDef):
        raise ValueError(f"{st.name}: triton_body must hold exactly one "
                         f"function definition")
    fn = tree.body[0]
    want = st.n_scalar_in + st.n_vec_in + 2
    if len(fn.args.args) != want:
        raise ValueError(
            f"{st.name}: triton_body takes {len(fn.args.args)} parameters; "
            f"the contract is (s0..s{st.n_scalar_in - 1}, "
            f"x0..x{st.n_vec_in - 1}, carry, step) = {want}")
    fn.name = fname
    fn.decorator_list = []
    return "@triton.jit\n" + ast.unparse(fn) + "\n"


def kernel_source(stages: Sequence[Stage], n_ext: Sequence[int]) -> str:
    """The Triton module for one chain: stage device functions + K1."""
    ns = sum(st.n_scalar_in for st in stages)
    nv = sum(n_ext)
    no = stages[-1].n_vec_out
    last = len(stages) - 1
    head = ["# generated by repro_torch.core.fused_kernel — do not edit",
            "import triton", "import triton.language as tl", ""]
    fnames = []
    for k, st in enumerate(stages):
        fname = f"_stage{k}_" + "".join(c if c.isalnum() else "_"
                                        for c in st.name)
        fnames.append(fname)
        if st.carry_cols:
            init = repr(str(float(st.carry_init)))       # 'inf' spells too
            head.append(f"_CINIT{k} = tl.constexpr(float({init}))")
        head.append(_stage_function(st, fname))
    params = ((["S"] if ns else []) + [f"X{i}" for i in range(nv)]
              + [f"O{i}" for i in range(no)]
              + ["n_steps", "row_len", "items_div",
                 "BR: tl.constexpr", "BC: tl.constexpr"])
    body = [
        "pid = tl.program_id(0)",
        "rows = pid.to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)",
        "base = rows[:, None] * row_len + tl.arange(0, BC)[None, :]",
    ]
    if ns:
        body.append(f"srow = S + (pid // items_div).to(tl.int64) * {ns}")
        body += [f"s{j} = tl.load(srow + {j})" for j in range(ns)]
    body.append("nocarry = tl.zeros((BR, 1), tl.float32)")
    for k, st in enumerate(stages):
        if st.carry_cols:
            body.append(f"c{k} = tl.full((BR, {st.carry_cols}), _CINIT{k}, "
                        f"tl.{dtype_name(st.carry_dtype)})")
    loop = ["offs = base + step * BC"]
    loop += [f"x{i} = tl.load(X{i} + offs)" for i in range(nv)]
    prev: list = []
    for k, (st, (ss, vs)) in enumerate(zip(stages, _split(stages, n_ext))):
        args = ([f"s{j}" for j in range(ss.start, ss.stop)] + prev
                + [f"x{i}" for i in range(vs.start, vs.stop)]
                + [f"c{k}" if st.carry_cols else "nocarry", "step"])
        outs = [f"v{k}_{j}" for j in range(st.n_vec_out)]
        carry = f"c{k}" if st.carry_cols else "_"
        loop.append(f"{', '.join(outs + [carry])} = "
                    f"{fnames[k]}({', '.join(args)})")
        if st.carry_cols:
            loop.append(f"c{k} = c{k}.to(tl.{dtype_name(st.carry_dtype)})")
        if k < last:
            loop += [f"{o} = {o}.to(X0.dtype.element_ty)" for o in outs]
        prev = outs
    loop += [f"tl.store(O{j} + offs, {o}.to(O{j}.dtype.element_ty))"
             for j, o in enumerate(prev)]
    lines = head + ["@triton.jit", f"def k1_kernel({', '.join(params)}):"]
    lines += ["    " + ln for ln in body]
    lines.append("    for step in range(0, n_steps):")
    lines += ["        " + ln for ln in loop]
    return "\n".join(lines) + "\n"


def load_module(source: str, prefix: str = "k1"):
    """Write ``source`` into the build directory (once per content, as
    ``<prefix>_<hash>.py``) and import it from there, so ``inspect`` finds
    the kernels' source. Returns (module, whether this call loaded it)."""
    digest = hashlib.sha256(source.encode()).hexdigest()[:20]
    modname = f"repro_torch_{prefix}_{digest}"
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod, False
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{prefix}_{digest}.py"
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod, True


def check_cuda(tensors: Sequence[torch.Tensor], what: str = "K1") -> None:
    """A kernel runs on one CUDA device; anything else raises (the caller
    asks for the emulator or the oracle explicitly, nothing falls back)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise RuntimeError(
                f"{what} launches on CUDA tensors of one device only (got "
                f"{t.device}); place the operands on the GPU or call with "
                f"mode='interpret' or mode='ref'")


class K1Kernel:
    """The K1 wrapper: generates, loads and launches the Triton kernel.
    ``launches`` counts kernel launches, and only those."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def compile(stages: Sequence[Stage], n_ext: Sequence[int]):
        """(the chain's ``k1_kernel`` JIT function, whether this call
        generated its module). Triton compiles the function per block
        shape and dtype at its first launch."""
        mod, fresh = load_module(kernel_source(stages, n_ext))
        return mod.k1_kernel, fresh

    def __call__(self, kernel, table: torch.Tensor,
                 vectors: Sequence[torch.Tensor], n_out: int,
                 block_rows: int, block_cols: int,
                 items_div: int) -> list[torch.Tensor]:
        v0 = vectors[0]
        check_cuda(list(vectors) + [table])
        for v in vectors:
            if not v.is_contiguous() or v.dtype != v0.dtype:
                raise ValueError("K1 needs contiguous vector operands of "
                                 "one dtype")
        rows, cols = v0.shape
        outs = [torch.empty_like(v0) for _ in range(n_out)]
        args = ([table] if table.shape[1] else []) + list(vectors) + outs
        # 8 warps for an 8×1024 tile (32 elements per thread per operand)
        warps = 8 if block_rows * block_cols >= 8192 else 4
        with torch.cuda.device(v0.device):
            kernel[(rows // block_rows,)](
                *args, cols // block_cols, cols, items_div,
                BR=block_rows, BC=block_cols, num_warps=warps)
        self.launches += 1
        return outs


#: The process-wide K1 wrapper; ``K1.launches`` is the launch count.
K1 = K1Kernel()

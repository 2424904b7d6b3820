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
  loop (this replaces ``pl.when(step == 0)``). The solo kernel issues
  the loads of the next ``K1_PREFETCH`` column steps before it computes
  the current one, so a walk's loads stream while its chain runs (D,
  the carried 128-step walk, 0.2077 → 0.2018 ms; O1's 8-step walks
  0.1426 → 0.1373 and 0.1415 → 0.1381; one-step chains as before, within
  0.1–2.3% of one PyTorch call: ``chip_smoke.py``, NVIDIA H100 80GB HBM3,
  700 W). Loads carry no eviction hint: ``evict_first`` cost 1–3% on
  every one-step chain (``experiments/k1_k4_redesign.py --k1-designs``);
* a solo launch takes the operands where they lie: flat operands of
  ``n`` elements are walked as the reference's padded (rows, cols) and
  the tail past ``n`` masked — a load reads 0, the pad's zeros, a store
  is dropped — so nothing is padded (``Program.call_flat``; a ragged
  c0_add at 2²⁶ − 1000 0.7984 → 0.2656 ms with the pad copies gone); a
  shape-changing stage's outputs are written whole in that layout;
* intermediates stay in registers (rounded to the operand dtype, as the
  reference's VMEM scratch rounds them); only the last stage stores;
* scalars come from a float32 device table, no host sync: one row for
  a solo launch, one row per item in a mixed-scalar batch, where program
  ``pid`` reads row ``pid // items_div`` (``items_div`` the row blocks
  per item);
* offsets are int64, since an operand can pass 2³¹ elements;
* a solo shape-changing stage (``Stage.out_shapes``) keeps the rows and
  scales the columns of each output: output ``j`` is stored at its own
  column block ``BO{j} = BC · out_cols_j / cols`` (a power of two, as
  ``tl.arange`` needs; :func:`out_block_widths` raises otherwise) at the
  same (row block, column step), in its own dtype, with its own row
  length ``n_steps · BO{j}``;
* a coalesced batch (``k1_batch_kernel``) reads and writes every item
  where it lies: program ``pid`` runs row block ``pid % blocks_per_item``
  of item ``pid // blocks_per_item``, whose address is item 0's typed
  pointer plus an element offset from a small ``(k_items, slots)`` int64
  table. The offsets are stored in 16-byte units and multiplied by the
  elements per 16 bytes in the kernel, so Triton sees them as multiples
  of a 16-byte vector (``tl.multiple_of`` says so too); the wrapper makes
  that true by copying, alone, any item that is not contiguous or not
  16-byte aligned (``K1.item_copies``). The tail past an item's ``n``
  elements is masked (loads read 0, the zero padding of a solo call;
  stores are dropped), so each item's result is bit-identical to its
  solo launch. The table's host-to-device copy (k_items · slots · 8
  bytes, about 10 µs) is the only work beyond the launch.

Stage bodies arrive as Triton *source text* (:class:`Stage.triton_body`)
because ``triton.jit`` reads a function's source through ``inspect``:
the generator writes one module per chain into the build directory
(``build/repro_torch/`` under the checkout unless
``REPRO_TORCH_BUILD_DIR`` names another) and imports it from there.

:func:`emulate` is the plain PyTorch version of the same grid walk —
vectorised across all row blocks, looping over column steps, carry set
at step 0, per-item scalar rows — which ``interpret`` mode runs on any
device and which the chip smoke test holds the kernel against;
:func:`emulate_items` is the batch kernel's: the same walk over the
items' row blocks, through the same item/row-block mapping and masked
tail.
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

def _out_tensors(out_specs, device) -> list[torch.Tensor]:
    """New tensors for ``((shape, dtype name), ...)`` on ``device``."""
    return [torch.empty(shape, dtype=getattr(torch, dt), device=device)
            for shape, dt in out_specs]


def emulate(stages: Sequence[Stage], n_ext: Sequence[int],
            table: torch.Tensor, vectors: Sequence[torch.Tensor],
            block_rows: int, block_cols: int,
            items_div: int, out_specs=None) -> list[torch.Tensor]:
    """K1's grid walk in torch eager, on the vectors' device.

    ``table`` is the ``(k_items, m)`` float32 scalar table; row block
    ``r`` reads row ``r // items_div``. Each column step runs every
    stage body once on all row blocks together. ``out_specs`` (``((shape,
    dtype name), ...)``, default the input's) sizes the outputs of a
    shape-changing stage: output ``j`` of ``out_cols`` columns takes a
    ``out_cols / n_steps``-wide block each step, stored in its dtype."""
    rows, cols = vectors[0].shape
    nrb, ncs = rows // block_rows, cols // block_cols
    dev, dtype = vectors[0].device, vectors[0].dtype
    views = [v.view(nrb, block_rows, ncs, block_cols) for v in vectors]
    if out_specs is None:
        outs = [torch.empty((rows, cols), dtype=dtype, device=dev)
                for _ in range(stages[-1].n_vec_out)]
    else:
        outs = _out_tensors(out_specs, dev)
    out_views = [o.view(nrb, block_rows, ncs, o.shape[1] // ncs)
                 for o in outs]
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


def emulate_items(stages: Sequence[Stage], n_ext: Sequence[int],
                  table: torch.Tensor,
                  items: Sequence[Sequence[torch.Tensor]],
                  block_rows: int, block_cols: int,
                  items_div: int, out_specs=None) -> list[list[torch.Tensor]]:
    """The batch kernel's grid walk in torch eager: ``items[k]`` holds item
    k's vector operands (one shape, ``n`` elements each). Program ``pid``
    runs row block ``rb = pid % bpi`` of item ``pid // bpi`` (``bpi`` row
    blocks of ``block_rows × block_cols`` elements an item): it loads the
    item's elements ``rb · block + 0 … block − 1``, 0 from ``n`` on, and
    stores only those below ``n``. Returns item k's outputs, each a new
    tensor of ``n`` elements. ``out_specs`` (one item: a solo
    shape-changing launch on the padded layout) sizes the outputs as
    :func:`emulate`'s, each cut to its first ``n`` elements."""
    k, n = len(items), items[0][0].numel()
    dev, dtype = items[0][0].device, items[0][0].dtype
    bpi = -(-n // (block_rows * block_cols))
    loaded = []
    for slot in range(len(items[0])):
        # (item, row block, element): program pid = item · bpi + rb
        x = torch.zeros((k, bpi * block_rows * block_cols), dtype=dtype,
                        device=dev)
        for i, it in enumerate(items):
            x[i, :n] = it[slot].reshape(-1)          # the masked load
        loaded.append(x.view(k * bpi * block_rows, block_cols))
    outs = emulate(stages, n_ext, table, loaded, block_rows, block_cols,
                   items_div, out_specs)
    del loaded
    return [[o.view(k, -1)[i, :n].clone() for o in outs]   # masked store
            for i in range(k)]


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


def _chain_loop(stages: Sequence[Stage], n_ext: Sequence[int], fnames,
                load, store) -> list[str]:
    """One column step of the chain: load the external vectors
    (``load(i)``), run the stage functions, store (``store(j, value)``)."""
    nv = sum(n_ext)
    last = len(stages) - 1
    loop = [f"x{i} = {load(i)}" for i in range(nv)]
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
    loop += [store(j, o) for j, o in enumerate(prev)]
    return loop


#: Column steps whose loads a solo program issues ahead of the step it
#: computes (2: O1's 8-step walks 0.1371 / 0.1381 ms against 0.1392 /
#: 0.1384 with 1 and 0.1423 / 0.1413 with none; D as with 1; one-step
#: chains unchanged; ``experiments/k1_k4_redesign.py --k1-designs``,
#: NVIDIA H100 80GB HBM3, 700 W).
K1_PREFETCH = 2
#: Warps of a solo program on a tile of 8192 elements or more (16
#: elements a thread an operand; 8 ran B's chain 0.2652 ms against 0.2672,
#: same script and card); 4 below (16 slowed D's 1024-element carried
#: tile 0.2088 → 0.2234).
K1_WIDE_WARPS = 16


def _solo_source(stages, n_ext, head, fnames, params, ns, nv, no,
                 ragged: bool) -> str:
    """``k1_kernel``: a solo launch, one program per row block, which
    walks the block's column steps in order with its carries in
    registers (a loop inside the block in place of the TPU's sequential
    grid axis). The loads of the next ``K1_PREFETCH`` steps are issued
    before the current step is computed (masked off past the last), so
    a carried walk's loads stream while its chain runs. With ``ragged``
    every access past ``n_valid`` is masked: a load reads 0, the zero
    padding of the reference's call, and a store is dropped."""
    pf = K1_PREFETCH
    params = params + ["n_units", "n_steps", "row_len", "BR: tl.constexpr",
                       "BC: tl.constexpr", "NUNIT: tl.constexpr"]
    body = [
        "pid = tl.program_id(0)",
        "rows = pid.to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)",
        "base = rows[:, None] * row_len + tl.arange(0, BC)[None, :]",
    ]
    if ragged:
        # n_units · NUNIT: NUNIT = 16 bytes of elements when they divide n
        # (below 2³¹), so the mask keeps 16-byte vectors whole
        body.append("n_valid = n_units * NUNIT")
    pre = []
    if stages[-1].shape_preserving:
        store = (lambda j, o: f"tl.store(O{j} + offs, "
                              f"{o}.to(O{j}.dtype.element_ty)"
                              + (", mask=offs < n_valid)" if ragged else ")"))
    else:
        # output j of a shape-changing stage: BO{j} columns a step, rows of
        # n_steps · BO{j} elements (int64 offsets: rows is)
        params += [f"BO{j}: tl.constexpr" for j in range(no)]
        body += [f"obase{j} = rows[:, None] * (n_steps * BO{j}) "
                 f"+ tl.arange(0, BO{j})[None, :]" for j in range(no)]
        pre = [f"oofs{j} = obase{j} + step * BO{j}" for j in range(no)]
        store = (lambda j, o: f"tl.store(O{j} + oofs{j}, "
                              f"{o}.to(O{j}.dtype.element_ty))")
    if ns:
        body += [f"s{j} = tl.load(S + {j})" for j in range(ns)]
    body.append("nocarry = tl.zeros((BR, 1), tl.float32)")
    for k, st in enumerate(stages):
        if st.carry_cols:
            body.append(f"c{k} = tl.full((BR, {st.carry_cols}), _CINIT{k}, "
                        f"tl.{dtype_name(st.carry_dtype)})")

    for d in range(pf):          # the first steps' loads, before the walk
        for i in range(nv):
            off = f"base + {d} * BC" if d else "base"
            mask = ([f"({d} < n_steps)"] if d else []) + (
                [f"({off} < n_valid)"] if ragged else [])
            body.append(f"x{i}_{d} = tl.load(X{i} + {off}" + (
                f", mask={' & '.join(mask)}, other=0)" if mask else ")"))
    loop = ["offs = base + step * BC"] + pre
    if pf:
        for i in range(nv):
            loop.append(f"x{i} = x{i}_0")
            loop += [f"x{i}_{d} = x{i}_{d + 1}" for d in range(pf - 1)]
            off = f"offs + {pf} * BC"
            mask = f"(step + {pf} < n_steps)" + (f" & ({off} < n_valid)"
                                                  if ragged else "")
            loop.append(f"x{i}_{pf - 1} = tl.load(X{i} + {off}, "
                        f"mask={mask}, other=0)")
        xload = lambda i: f"x{i}"                        # noqa: E731
    else:
        xload = lambda i: (f"tl.load(X{i} + offs" +       # noqa: E731
                           (", mask=offs < n_valid, other=0)" if ragged
                            else ")"))
    chain = _chain_loop(stages, n_ext, fnames, xload, store)
    # with the prefetch the operands are already x0, x1, …
    loop += [ln for ln in chain if ln.split(" = ") != [ln.split(" = ")[0]] * 2]
    lines = head + ["@triton.jit", f"def k1_kernel({', '.join(params)}):"]
    lines += ["    " + ln for ln in body]
    lines.append("    for step in range(0, n_steps):")
    lines += ["        " + ln for ln in loop]
    return "\n".join(lines) + "\n"


def kernel_source(stages: Sequence[Stage], n_ext: Sequence[int],
                  batch: bool = False, ragged: bool = False) -> str:
    """The Triton module for one chain: stage device functions and K1 —
    ``k1_kernel`` on a solo launch's operands (with ``ragged``, their
    tail past ``n`` masked), or with ``batch`` ``k1_batch_kernel`` on
    the items of a coalesced batch in place."""
    ns = sum(st.n_scalar_in for st in stages)
    nv = sum(n_ext)
    no = stages[-1].n_vec_out
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
              + [f"O{i}" for i in range(no)])
    if not batch:
        return _solo_source(stages, n_ext, head, fnames, params, ns, nv, no,
                            ragged)
    # T: (k_items, nv + no) int64, each item's offset from item 0's
    # pointer per slot in units of VEC elements (16 bytes)
    params += ["T", "n_units", "n_steps", "row_len", "items_div",
               "blocks_per_item", "BR: tl.constexpr", "BC: tl.constexpr",
               "VEC: tl.constexpr", "NUNIT: tl.constexpr",
               "RAGGED: tl.constexpr"]
    body = [
        "pid = tl.program_id(0)",
        "item = pid // blocks_per_item",
        "rb = pid - item * blocks_per_item",
        "rows = rb.to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)",
        "base = rows[:, None] * row_len + tl.arange(0, BC)[None, :]",
        f"trow = T + item.to(tl.int64) * {nv + no}",
    ]
    body += [f"xo{i} = tl.multiple_of(tl.load(trow + {i}) * VEC, VEC)"
             for i in range(nv)]
    body += [f"oo{j} = tl.multiple_of(tl.load(trow + {nv + j}) * VEC, "
             f"VEC)" for j in range(no)]
    # n_units · NUNIT: NUNIT = VEC when VEC divides n (below 2³¹), so
    # the mask keeps 16-byte vectors whole
    body += ["n_valid = n_units * NUNIT",
             "zero = 0 if RAGGED else None"]
    load = (lambda i: f"tl.load(X{i} + xo{i} + offs, mask=mask, "
                      f"other=zero)")
    store = (lambda j, o: f"tl.store(O{j} + oo{j} + offs, "
                          f"{o}.to(O{j}.dtype.element_ty), mask=mask)")
    if ns:
        body.append(f"srow = S + (pid // items_div).to(tl.int64) * {ns}")
        body += [f"s{j} = tl.load(srow + {j})" for j in range(ns)]
    body.append("nocarry = tl.zeros((BR, 1), tl.float32)")
    for k, st in enumerate(stages):
        if st.carry_cols:
            body.append(f"c{k} = tl.full((BR, {st.carry_cols}), _CINIT{k}, "
                        f"tl.{dtype_name(st.carry_dtype)})")
    loop = (["offs = base + step * BC",
             "mask = offs < n_valid if RAGGED else None"]
            + _chain_loop(stages, n_ext, fnames, load, store))
    lines = head + ["@triton.jit",
                    f"def k1_batch_kernel({', '.join(params)}):"]
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


def place_items(items: Sequence[Sequence[torch.Tensor]]
                ) -> tuple[list[list[torch.Tensor]], int]:
    """The batch kernel's operands: each item's vectors flat, contiguous
    and 16-byte aligned, as the kernel assumes. A vector that is not is
    copied alone; returns (the operands, the number of copies)."""
    v0 = items[0][0]
    ops, copies = [], 0
    for vecs in items:
        row = []
        for v in vecs:
            if v.dtype != v0.dtype or v.numel() != v0.numel():
                raise ValueError("K1 batch items need vector operands of "
                                 "one dtype and size")
            if not v.is_contiguous() or v.data_ptr() % 16:
                v = v.contiguous() if not v.is_contiguous() else v.clone()
                copies += 1
            row.append(v.view(-1))
        ops.append(row)
    return ops, copies


def item_offsets(rows: Sequence[Sequence[torch.Tensor]]) -> list[list[int]]:
    """The batch kernel's table: per item, each slot's distance from item
    0's tensor in that slot, in 16-byte units (every tensor 16-byte
    aligned)."""
    return [[(t.data_ptr() - t0.data_ptr()) // 16
             for t, t0 in zip(row, rows[0])] for row in rows]


def out_block_widths(out_specs, block_cols: int, cols: int) -> dict:
    """The ``BO{j}`` column blocks of a shape-changing stage's outputs,
    ``block_cols · out_cols_j / cols`` each; ``tl.arange`` needs each to
    be a power of two, and anything else raises."""
    widths = {}
    for j, (shape, _) in enumerate(out_specs):
        bo, rem = divmod(block_cols * shape[1], cols)
        if rem or bo < 1 or bo & (bo - 1):
            raise ValueError(
                f"K1: output {j}'s column block is {block_cols} · "
                f"{shape[1]} / {cols} = {block_cols * shape[1] / cols}; "
                f"K1 needs a power of two (tl.arange)")
        widths[f"BO{j}"] = bo
    return widths


class K1Kernel:
    """The K1 wrapper: generates, loads and launches the Triton kernel.
    ``launches`` counts kernel launches, and only those; ``item_copies``
    counts the batch operands copied because they were not contiguous or
    not 16-byte aligned."""

    def __init__(self):
        self.launches = 0
        self.item_copies = 0

    @staticmethod
    def compile(stages: Sequence[Stage], n_ext: Sequence[int],
                batch: bool = False, ragged: bool = False):
        """(the chain's ``k1_kernel`` — with ``ragged`` the one that masks
        the tail, with ``batch`` its ``k1_batch_kernel`` — JIT function,
        whether this call generated its module). Triton compiles the
        function per block shape and dtype at its first launch."""
        mod, fresh = load_module(kernel_source(stages, n_ext, batch, ragged))
        return (mod.k1_batch_kernel if batch else mod.k1_kernel), fresh

    def __call__(self, kernel, table: torch.Tensor,
                 vectors: Sequence[torch.Tensor], n_out: int,
                 block_rows: int, block_cols: int,
                 out_specs=None) -> list[torch.Tensor]:
        """One ``k1_kernel`` launch. ``vectors`` are (rows, cols) operands
        of whole blocks, or flat operands of ``n`` elements, walked as
        ⌈n / (block_rows·block_cols)⌉ row blocks of ``block_cols``-element
        rows (the reference's padded layout) by a kernel compiled to mask
        the tail past ``n`` when there is one; their outputs are flat
        tensors of ``n`` elements. ``out_specs`` (``((shape, dtype
        name), ...)``) sizes the outputs of a shape-changing stage (on
        flat operands, in their padded layout), each stored ``block_cols ·
        out_cols / cols`` columns a step; without it every output is
        shaped like the inputs."""
        v0 = vectors[0]
        check_cuda(list(vectors) + [table])
        for v in vectors:
            if not v.is_contiguous() or v.dtype != v0.dtype:
                raise ValueError("K1 needs contiguous vector operands of "
                                 "one dtype")
        n = v0.numel()
        if v0.ndim == 2:
            rows, cols = v0.shape
        else:
            cols = block_cols
            rows = -(-n // (block_rows * block_cols)) * block_rows
        widths = {}
        if out_specs is None:
            outs = [torch.empty_like(v0) for _ in range(n_out)]
        else:
            outs = _out_tensors(out_specs, v0.device)
            widths = out_block_widths(out_specs, block_cols, cols)
        if n == 0:
            return outs
        args = ([table] if table.shape[1] else []) + list(vectors) + outs
        vec = 16 // v0.element_size()
        nunit = vec if n % vec == 0 and n < 1 << 31 else 1
        warps = K1_WIDE_WARPS if block_rows * block_cols >= 8192 else 4
        with torch.cuda.device(v0.device):
            kernel[(rows // block_rows,)](
                *args, n // nunit, cols // block_cols, cols,
                BR=block_rows, BC=block_cols, NUNIT=nunit, num_warps=warps,
                **widths)
        self.launches += 1
        return outs

    def launch_items(self, kernel, table: torch.Tensor,
                     items: Sequence[Sequence[torch.Tensor]], n_out: int,
                     block_rows: int, block_cols: int,
                     items_div: int) -> list[list[torch.Tensor]]:
        """One ``k1_batch_kernel`` launch over the items in place:
        ``items[k]`` holds item k's vector operands (one shape and dtype
        for all). Returns item k's ``n_out`` outputs, new tensors of the
        items' ``n`` elements each."""
        check_cuda([t for vecs in items for t in vecs] + [table])
        ops, copies = place_items(items)
        self.item_copies += copies
        v0 = ops[0][0]
        n, k = v0.numel(), len(items)
        outs = [[torch.empty(n, dtype=v0.dtype, device=v0.device)
                 for _ in range(n_out)] for _ in range(k)]
        if n == 0:
            return outs
        offsets = torch.tensor(
            item_offsets([row + out for row, out in zip(ops, outs)]),
            dtype=torch.int64, pin_memory=True)
        offsets = offsets.to(v0.device, non_blocking=True)
        vec = max(1, 16 // v0.element_size())
        blk = block_rows * block_cols
        blocks_per_item = -(-n // blk)
        nunit = vec if n % vec == 0 and n < 1 << 31 else 1
        args = (([table] if table.shape[1] else []) + ops[0] + outs[0]
                + [offsets])
        warps = 8 if blk >= 8192 else 4
        with torch.cuda.device(v0.device):
            kernel[(k * blocks_per_item,)](
                *args, n // nunit, 1, block_cols, items_div,
                blocks_per_item, BR=block_rows, BC=block_cols, VEC=vec,
                NUNIT=nunit, RAGGED=n % blk != 0, num_warps=warps)
        self.launches += 1
        return outs


#: The process-wide K1 wrapper; ``K1.launches`` is the launch count.
K1 = K1Kernel()

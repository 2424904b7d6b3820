"""The parent designs of K1's solo route and of K4, kept only so that
``chip_smoke.py`` can time them as "was" beside the kernels that replaced
them, on the same inputs in the same call (nothing in ``src/repro_torch``
calls them).

* ``k1_solo``: K1's solo kernel before its pipelined walk — one program
  per row block, a plain ``for step in range(0, n_steps)`` over the
  column blocks (one step's loads in flight), 2-D int64 offsets, whole
  blocks only (a ragged operand was padded by a copy first).
* ``k4_state_scan``: K4's state-scan entry in Gluon — a program of br
  payload rows loads (br, bc) tiles in a rows-first ``MOVE`` layout,
  converts them through shared memory to ``SCAN``, scans each tile with
  ``gl.associative_scan`` (a log-depth tree) and carries the last
  column. (The rows entry's Gluon kernel is still the port's past 64
  columns: ``prefix_scan.gluon_chunk_scan``.)

Both need the card and Triton; Triton is imported at launch.
"""
from __future__ import annotations

import torch

from repro_torch.core import fused_kernel as fk
from repro_torch.core.stream import dtype_name
from repro_torch.kernels import prefix_scan as ps


# ---------------------------------------------------------------------------
# K1's former solo kernel
# ---------------------------------------------------------------------------

def k1_solo_source(stages, n_ext) -> str:
    """The former ``k1_kernel`` module of a chain."""
    ns = sum(st.n_scalar_in for st in stages)
    nv = sum(n_ext)
    no = stages[-1].n_vec_out
    head = ["# former K1 solo kernel (chip_smoke's was)", "import triton",
            "import triton.language as tl", ""]
    fnames = []
    for k, st in enumerate(stages):
        fname = f"_stage{k}_" + "".join(c if c.isalnum() else "_"
                                        for c in st.name)
        fnames.append(fname)
        if st.carry_cols:
            init = repr(str(float(st.carry_init)))
            head.append(f"_CINIT{k} = tl.constexpr(float({init}))")
        head.append(fk._stage_function(st, fname))
    params = ((["S"] if ns else []) + [f"X{i}" for i in range(nv)]
              + [f"O{i}" for i in range(no)])
    params += ["n_steps", "row_len", "BR: tl.constexpr", "BC: tl.constexpr"]
    body = [
        "pid = tl.program_id(0)",
        "rows = pid.to(tl.int64) * BR + tl.arange(0, BR).to(tl.int64)",
        "base = rows[:, None] * row_len + tl.arange(0, BC)[None, :]",
    ]
    pre = []
    load = lambda i: f"tl.load(X{i} + offs)"                    # noqa: E731
    if stages[-1].shape_preserving:
        store = (lambda j, o: f"tl.store(O{j} + offs, "
                              f"{o}.to(O{j}.dtype.element_ty))")
    else:
        params += [f"BO{j}: tl.constexpr" for j in range(no)]
        body += [f"obase{j} = rows[:, None] * (n_steps * BO{j}) "
                 f"+ tl.arange(0, BO{j})[None, :]" for j in range(no)]
        pre = [f"oofs{j} = obase{j} + step * BO{j}" for j in range(no)]
        store = (lambda j, o: f"tl.store(O{j} + oofs{j}, "
                              f"{o}.to(O{j}.dtype.element_ty))")
    if ns:
        body.append("srow = S")
        body += [f"s{j} = tl.load(srow + {j})" for j in range(ns)]
    body.append("nocarry = tl.zeros((BR, 1), tl.float32)")
    for k, st in enumerate(stages):
        if st.carry_cols:
            body.append(f"c{k} = tl.full((BR, {st.carry_cols}), _CINIT{k}, "
                        f"tl.{dtype_name(st.carry_dtype)})")
    loop = (["offs = base + step * BC"] + pre
            + fk._chain_loop(stages, n_ext, fnames, load, store))
    lines = head + ["@triton.jit", f"def k1_kernel({', '.join(params)}):"]
    lines += ["    " + ln for ln in body]
    lines.append("    for step in range(0, n_steps):")
    lines += ["        " + ln for ln in loop]
    return "\n".join(lines) + "\n"


def k1_solo(stages, n_ext, table, vectors, n_out, block_rows, block_cols,
            out_specs=None):
    """One launch of the former solo kernel on (rows, cols) operands of
    whole blocks (as the former ``K1.__call__``); not counted."""
    kernel = fk.load_module(k1_solo_source(stages, n_ext),
                            prefix="k1was")[0].k1_kernel
    v0 = vectors[0]
    rows, cols = v0.shape
    widths = {}
    if out_specs is None:
        outs = [torch.empty_like(v0) for _ in range(n_out)]
    else:
        outs = fk._out_tensors(out_specs, v0.device)
        widths = fk.out_block_widths(out_specs, block_cols, cols)
    args = ([table] if table.shape[1] else []) + list(vectors) + outs
    warps = 8 if block_rows * block_cols >= 8192 else 4
    with torch.cuda.device(v0.device):
        kernel[(rows // block_rows,)](
            *args, cols // block_cols, cols,
            BR=block_rows, BC=block_cols, num_warps=warps, **widths)
    return outs


# ---------------------------------------------------------------------------
# K4's former Gluon kernels
# ---------------------------------------------------------------------------

GLUON_SOURCE = '''
from triton.experimental import gluon
from triton.experimental.gluon import language as gl


@gluon.jit
def _affine(pa, pb, qa, qb):
    return pa * qa, qb + qa * pb


@gluon.jit
def _scan_block(a, b, carry, last):
    acum, bcum = gl.associative_scan((a, b), 1, _affine)
    y = (acum * gl.expand_dims(carry, 1) + bcum).to(carry.dtype)
    return y, gl.sum(gl.where(last, y, 0), axis=1).to(carry.dtype)


@gluon.jit
def k4_state_scan(A, S, O, n_rb, rows, cols, inner, a_in, a_div, a_outer,
                  a_col, BR: gl.constexpr, BC: gl.constexpr,
                  SCAN: gl.constexpr, MOVE: gl.constexpr,
                  REVERSE: gl.constexpr):
    pid = gl.program_id(0)
    g = pid // n_rb
    o = g // a_in
    ai = g % a_in
    sbase = o.to(gl.int64) * cols * inner + ai.to(gl.int64) * rows
    abase = (o // a_div).to(gl.int64) * a_outer + ai
    r = (pid % n_rb) * BR + gl.arange(0, BR, layout=gl.SliceLayout(1, MOVE))
    cmove = gl.arange(0, BC, layout=gl.SliceLayout(0, MOVE))
    cscan = gl.arange(0, BC, layout=gl.SliceLayout(0, SCAN))
    last = gl.expand_dims(cscan == BC - 1, 0)
    carry = gl.zeros([BR], O.dtype.element_ty, layout=gl.SliceLayout(1, SCAN))
    for c0 in range(0, cols, BC):
        c = c0 + cmove
        m = gl.expand_dims(r < rows, 1) & gl.expand_dims(c < cols, 0)
        if REVERSE:
            c = cols - 1 - c
        off = (sbase + gl.expand_dims(c.to(gl.int64), 0) * inner
               + gl.expand_dims(r, 1))
        b = gl.load(S + off, mask=m, other=0).to(O.dtype.element_ty)
        b = gl.convert_layout(b, SCAN)
        ca = c0 + cscan
        ma = ca < cols
        if REVERSE:
            ca = cols - 1 - ca
        ac = gl.load(A + abase + ca.to(gl.int64) * a_col, mask=ma,
                     other=1).to(O.dtype.element_ty)
        a, b = gl.broadcast(gl.expand_dims(ac, 0), b)
        y, carry = _scan_block(a, b, carry, last)
        gl.store(O + off, gl.convert_layout(y, MOVE), mask=m)
'''


def _num_warps(br: int, bc: int) -> int:
    return 8 if br * bc >= 2048 else 4


def scan_layout(br: int, bc: int, num_warps: int) -> tuple:
    spt = min(4, bc)
    tc = min(32, bc // spt)
    wc = min(num_warps, max(1, bc // (spt * tc)))
    return (1, spt), (32 // tc, tc), (num_warps // wc, wc), (1, 0)


def move_layout(br: int, bc: int, num_warps: int) -> tuple:
    spt = min(4, max(1, br // 32))
    tpw = min(32, max(1, br // spt))
    wpc = max(1, min(num_warps, br // (spt * tpw)))
    return ((spt, 1), (tpw, 32 // tpw), (wpc, num_warps // wpc), (0, 1))


def _layout(shape: tuple):
    from triton.experimental.gluon import language as gl
    return gl.BlockedLayout(*map(list, shape))


def _gluon():
    return fk.load_module(GLUON_SOURCE, prefix="scanwas")[0]


def block_shape(rows: int, cols: int) -> tuple[int, int]:
    """The former K4's (br, bc): the whole row up to 4096 columns, and as
    many rows as fill 4096 elements."""
    return ps.block_shape(rows, cols)


def k4_state_scan(a, states, axis: int, reverse: bool = False):
    """The former K4 state-scan entry, on the states where they lie; not
    counted."""
    dt = torch.promote_types(a.dtype, states.dtype)
    a, w = ps.state_scan_map(a, states, axis)
    states = states.contiguous()
    out = torch.empty(states.shape, dtype=dt, device=states.device)
    cols, rows = w["cols"], w["rows"]
    br, bc = block_shape(states.numel() // cols, cols)
    nw = _num_warps(br, bc)
    n_rb = -(-rows // br)
    with torch.cuda.device(states.device):
        _gluon().k4_state_scan[(w["outer"] * w["a_in"] * n_rb,)](
            a, states, out, n_rb, rows, cols, w["inner"], w["a_in"],
            w["a_div"], w["a_outer"], w["a_col"], BR=br, BC=bc,
            SCAN=_layout(scan_layout(br, bc, nw)),
            MOVE=_layout(move_layout(br, bc, nw)),
            REVERSE=reverse, num_warps=nw)
    return out


def state_scan_grad(a, y, g, axis: int):
    """The former c4_statescan backward: the former K4's reverse walk on
    the shifted decay, then da as the product at the states' size and
    its torch reduction (``prefix_scan._prev_product``)."""
    ax = axis % y.ndim
    a = a.expand(y.shape[:a.ndim])
    shifted_a = ps.next_decay(a, ax) if ax < a.ndim else a
    lam = k4_state_scan(shifted_a, g, axis, reverse=True)
    return ps._prev_product(lam, y, ax, a.ndim), lam

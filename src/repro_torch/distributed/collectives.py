"""Collectives of the mesh: one transport, autograd-aware wrappers, and
the int8 ring all-reduce with error feedback
(``src/repro/distributed/collectives.py``).

**Transport.** Every collective of the port goes through :func:`_run`.
On a gloo group a CUDA tensor is staged through a pinned host buffer
(gloo moves CPU tensors only) and copied back; on NCCL, device tensors
pass straight through. ``STAGED_BYTES`` counts the bytes copied to the
host for gloo. A group of None is one rank: every collective is then
the identity. Nothing falls back to a local result when a collective
fails: its error is raised.

**Recording and dry groups.** Inside :func:`recording` every
collective that :func:`_run` issues is logged as (kind, result bytes,
group size), the kinds named as XLA names them (``all-reduce``,
``all-gather``, ``all-to-all``, ``collective-permute``, and
``broadcast``). A :class:`DryGroup` is a group that moves nothing: a
collective on it is logged and returns its outputs unfilled, so one
process can walk one rank's step of a mesh of any size on meta tensors
(``launch/dryrun.py``).

**Autograd.** :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter` and :func:`all_to_all` are
``torch.autograd.Function``s whose backward is the adjoint of their
forward under the SPMD objective Σ_ranks loss_r: an all-reduce's is an
all-reduce, an all-gather's a reduce-scatter and a reduce-scatter's an
all-gather, an all-to-all's the reverse all-to-all. Every rank runs the
same backward, so the collectives meet. The model's tensor-parallel
regions use them as they are (``sharding.ModelSplit``): model peers
compute the same loss, so the world's sum counts each row's loss once a
model peer, and every rank's gradient of a leaf is its share of that
sum, whether the leaf is split over ``model`` or whole.

**The ring.** :func:`compressed_ring_allreduce` is the reference's
int8 block-quantised ring (a reduce-scatter, then an all-gather, each
hop one ``batch_isend_irecv`` to the next rank), hop for hop. The
owner of a chunk keeps its unquantised sum (``collectives.py:97``), so
the ranks end with slightly different bits, as in the reference.
:func:`ring_allreduce_plain` replays the same hops for every rank in one
process: the ring on any device is held against it bit for bit (every
step is one IEEE operation: abs, max, divide, round, multiply, add).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

#: bytes copied to the host to move CUDA tensors over gloo
STAGED_BYTES = 0
#: host seconds spent in collectives staged through host (CUDA work
#: queued before one is waited for first, outside this count)
SECONDS = 0.0
#: the open :func:`recording` logs
_LOGS: list[list] = []


class DryGroup:
    """A group of ``size`` ranks in which this process is rank ``rank``
    and nothing moves: collectives on it are logged and leave their
    outputs as allocated (a dry run's meta tensors keep their shapes)."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = int(size), int(rank)

    def __repr__(self):
        return f"DryGroup(size={self.size}, rank={self.rank})"


@contextlib.contextmanager
def recording():
    """Log every collective issued inside, on any group: yields a list
    that gains one ``(kind, result bytes, group size)`` per collective
    (a hop's bytes are those it sends, or receives when it only
    receives). ``roofline.analysis.collective_bytes_of`` turns it into
    the reference's per-kind traffic."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _dist():
    import torch.distributed as dist
    return dist


def _staged(group) -> bool:
    return _dist().get_backend(group) == "gloo"


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global STAGED_BYTES
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED_BYTES += t.numel() * t.element_size()
    return h


def _run(group, op: Callable, outs: list, ins: list, kind: str) -> None:
    """``op(outs, ins)`` on ``group``: CUDA tensors through host buffers
    on gloo (the results copied back into ``outs``), as they are on
    NCCL; logged as ``kind`` in every open :func:`recording`; on a
    :class:`DryGroup`, only logged."""
    global SECONDS
    if _LOGS:
        moved = ((_nbytes(ins) or _nbytes(outs))
                 if kind == "collective-permute" else _nbytes(outs))
        for log in _LOGS:
            log.append((kind, moved, size(group)))
    if isinstance(group, DryGroup):
        return
    if not any(t.is_cuda for t in outs + ins) or not _staged(group):
        op(outs, ins)
        return
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_ins = [_to_host(t) for t in ins]
    h_outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in outs]
    op(h_outs, h_ins)
    for t, h in zip(outs, h_outs):
        t.copy_(h)
    torch.cuda.synchronize()
    SECONDS += time.perf_counter() - t0


def size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, DryGroup):
        return group.size
    return _dist().get_world_size(group)


def rank(group) -> int:
    if group is None:
        return 0
    if isinstance(group, DryGroup):
        return group.rank
    return _dist().get_rank(group)


def _global(group, r: int) -> int:
    return _dist().get_global_rank(group, r)


# ---------------------------------------------------------------------------
# the raw collectives (no autograd)
# ---------------------------------------------------------------------------

def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns it."""
    if group is None:
        return x
    dist = _dist()
    buf = x if x.is_contiguous() else x.contiguous()

    def op(outs, ins):
        if outs[0].data_ptr() != ins[0].data_ptr():
            outs[0].copy_(ins[0])
        dist.all_reduce(outs[0], group=group)
    _run(group, op, [buf], [buf], "all-reduce")
    if buf is not x:
        x.copy_(buf)
    return x


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    dist = _dist()

    def op(outs, ins):
        if outs[0].data_ptr() != ins[0].data_ptr():
            outs[0].copy_(ins[0])
        dist.all_reduce(outs[0], op=dist.ReduceOp.MAX, group=group)
    _run(group, op, [x], [x], "all-reduce")
    return x


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` into every rank's ``x``, in place."""
    if group is None:
        return x
    dist = _dist()

    def op(outs, ins):
        dist.broadcast(outs[0], src=_global(group, src), group=group)
    _run(group, op, [x], [x], "broadcast")
    return x


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    dist = _dist()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    _run(group, lambda o, i: dist.all_gather_into_tensor(o[0], i[0],
                                                         group=group),
         [out], [src], "all-gather")
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of the group's ``x`` (of one shape), this rank's block of
    it along ``dim`` (equal blocks in group-rank order)."""
    n = size(group)
    if n == 1:
        return x
    dist = _dist()
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {x.shape[dim]} does not split in "
                         f"{n}")
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    _run(group, lambda o, i: dist.reduce_scatter_tensor(o[0], i[0],
                                                        group=group),
         [out], [src], "reduce-scatter")
    return out.movedim(0, dim)


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Row block j of ``x`` (dim 0 in equal blocks) to group rank j;
    returns the received blocks in source order."""
    if size(group) == 1:
        return x
    dist = _dist()
    src = x.contiguous()
    out = torch.empty_like(src)
    _run(group, lambda o, i: dist.all_to_all_single(o[0], i[0], group=group),
         [out], [src], "all-to-all")
    return out


def shift(tensors: list[torch.Tensor], group, send_to: int | None,
          recv_from: int | None, like: list[torch.Tensor] | None = None):
    """One hop: send ``tensors`` to group rank ``send_to`` and receive
    as many, shaped as ``like`` (default ``tensors``), from
    ``recv_from`` in one ``batch_isend_irecv`` (either may be None).
    Returns the received tensors (None when nothing is received)."""
    if send_to is None and recv_from is None:
        return None
    dist = _dist()
    like = tensors if like is None else like
    recv = ([torch.empty_like(t) for t in like] if recv_from is not None
            else None)

    def op(outs, ins):
        ops = []
        if send_to is not None:
            ops += [dist.P2POp(dist.isend, t, _global(group, send_to),
                               group=group) for t in ins]
        if recv_from is not None:
            ops += [dist.P2POp(dist.irecv, t, _global(group, recv_from),
                               group=group) for t in outs]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    ins = [t.contiguous() for t in tensors] if send_to is not None else []
    _run(group, op, recv or [], ins, "collective-permute")
    return recv


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` (autograd: the backward sums the cotangents)."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenation along ``dim`` over ``group`` (autograd: the
    backward reduce-scatters)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group``
    (autograd: the backward all-gathers)."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all_rows` (autograd: the reverse all-to-all)."""
    return x if group is None else _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# int8 block quantisation and the compressed ring
# ---------------------------------------------------------------------------

def quantize_blockwise(x: torch.Tensor, qblock: int = 256):
    """int8 symmetric quantisation with one fp32 absmax scale per block.

    x: 1D (caller flattens/pads). Returns (q int8 (nb, qblock), scales
    (nb, 1))."""
    if x.ndim != 1 or x.numel() % qblock:
        raise ValueError(f"need 1D size divisible by qblock={qblock}, "
                         f"got {tuple(x.shape)}")
    xb = x.reshape(-1, qblock)
    scale = xb.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xb / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor):
    return (q.to(torch.float32) * scale).reshape(-1)


def _pad_to(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, int]:
    pad = (-x.numel()) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    return x, pad


def _ring_chunks(x: torch.Tensor, n: int, qblock: int) -> torch.Tensor:
    flat, _ = _pad_to(x.to(torch.float32).reshape(-1), n * qblock)
    return flat.reshape(n, -1)


def compressed_ring_allreduce(x: torch.Tensor, group,
                              qblock: int = 256) -> torch.Tensor:
    """Ring all-reduce (sum) over ``group`` with int8-per-hop payloads.

    Every rank of the group calls it with a tensor of one shape. The
    semantics are a sum over the group up to quantisation error (the
    tests bound it at 8/127 of the result's absmax)."""
    n = size(group)
    if n == 1:
        return x
    shape, dtype, numel = x.shape, x.dtype, x.numel()
    chunks = _ring_chunks(x, n, qblock)
    me = rank(group)
    nxt, prv = (me + 1) % n, (me - 1) % n

    def hop(acc):
        q, s = quantize_blockwise(acc, qblock)
        q, s = shift([q, s], group, nxt, prv)
        return dequantize_blockwise(q, s)

    # reduce-scatter: after n-1 hops rank `me` holds the full sum of
    # chunk (me+1) mod n
    acc = chunks[me]
    for step in range(n - 1):
        acc = hop(acc) + chunks[(me - step - 1) % n]
    # all-gather: circulate the completed chunks
    out = torch.zeros_like(chunks)
    out[(me + 1) % n] = acc
    cur = acc
    for step in range(n - 1):
        cur = hop(cur)
        out[(me - step) % n] = cur
    return out.reshape(-1)[:numel].reshape(shape).to(dtype)


def ring_allreduce_plain(stacked: torch.Tensor,
                         qblock: int = 256) -> torch.Tensor:
    """What :func:`compressed_ring_allreduce` returns on each of n ranks
    whose inputs are ``stacked[r]``, replayed in one process hop for
    hop: (n, ...) → (n, ...)."""
    n = stacked.shape[0]
    if n == 1:
        return stacked.clone()
    shape, dtype = stacked.shape[1:], stacked.dtype
    numel = stacked[0].numel()
    chunks = [_ring_chunks(stacked[r], n, qblock) for r in range(n)]

    def hop(accs):
        sent = [quantize_blockwise(a, qblock) for a in accs]
        return [dequantize_blockwise(*sent[(r - 1) % n]) for r in range(n)]

    accs = [chunks[r][r] for r in range(n)]
    for step in range(n - 1):
        recv = hop(accs)
        accs = [recv[r] + chunks[r][(r - step - 1) % n] for r in range(n)]
    del chunks
    outs = accs[0].new_zeros((n, n) + accs[0].shape)
    for r in range(n):
        outs[r, (r + 1) % n] = accs[r]
    cur = accs
    for step in range(n - 1):
        cur = hop(cur)
        for r in range(n):
            outs[r, (r - step) % n] = cur[r]
    return outs.reshape(n, -1)[:, :numel].reshape((n,) + shape).to(dtype)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class ErrorFeedback:
    """Error-feedback wrapper: residual = what compression dropped last
    step.

    Usage (per training step, per slow-axis reduction)::

        ef = ErrorFeedback.init(grads)
        reduced, ef = ef.apply(grads, lambda g: compressed_ring_allreduce(
            g, mesh.group("pod")))

    The state is a tree shaped like the grads (float32)."""

    def __init__(self, residual):
        self.residual = residual

    @staticmethod
    def init(tree):
        return ErrorFeedback(_tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), tree))

    def apply(self, grads, reduce_fn: Callable, qblock: int = 256):
        def one(g, r):
            e = g.to(torch.float32) + r
            flat, _ = _pad_to(e.reshape(-1), qblock)
            q, s = quantize_blockwise(flat, qblock)
            sent = dequantize_blockwise(q, s)[:e.numel()].reshape(e.shape)
            return sent.to(g.dtype), e - sent

        pairs = _tree_map(one, grads, self.residual)
        is_pair = lambda p: isinstance(p, tuple)  # noqa: E731

        def pick(tree, i):
            if is_pair(tree):
                return tree[i]
            return {k: pick(v, i) for k, v in tree.items()}
        reduced = _tree_map(reduce_fn, pick(pairs, 0))
        return reduced, ErrorFeedback(pick(pairs, 1))

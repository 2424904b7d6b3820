"""Optimizers over nested dicts of tensors (``src/repro/optim/optimizers.py``).

AdamW for the ≤100B archs; Adafactor (factored second moment, no first
moment) for the ≥300B MoEs where Adam's fp32 m/v cannot fit. Both are
functional, as the reference's: ``init(params)`` gives the state tree,
``update(grads, state, params, step)`` returns (new params, new state)
and leaves its arguments as they are. The math is the reference's, leaf
by leaf, in float32 (the schedule, the bias corrections and the
moments), with states in ``state_dtype`` and each new param cast back
to its own dtype. (``torch.optim.AdamW`` is another update: it decays
the weights before the step and keeps no dtype of its own.)

Leaves are walked in sorted key order at every level, the order of the
reference's ``jax.tree.leaves``, so a global norm sums in its order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import reshard, spec_axes


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor``·peak at ``total``; computed in float32 as the
    reference does. ``lr(step)`` is a 0-d float32 tensor on the host."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(_f32(math.pi) * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys sorted at every level (the
    reference's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """√Σ x² over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to a global norm of at most ``max_norm``, each
    leaf in its own dtype; the norm before clipping)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), tree), n


def _scalar(lr, step):
    """The learning rate at ``step`` as a float32 value (a Python float
    holds it exactly)."""
    return float(_f32(lr(step) if callable(lr) else lr))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"

    def init(self, params):
        dt = _DTYPES[self.state_dtype]
        z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
        return {"m": _map(z, params), "v": _map(z, params)}

    def state_logical_axes(self, param_axes):
        return {"m": param_axes, "v": param_axes}

    def update(self, grads, state, params, step):
        lr = _scalar(self.lr, step)
        t = _f32(int(step)) + 1.0
        c1 = float(1 - _f32(self.b1) ** t)
        c2 = float(1 - _f32(self.b2) ** t)
        dt = _DTYPES[self.state_dtype]

        def upd(g, m, v, p):
            g = g.float()
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * p.float()
            new_p = (p.float() - lr * u).to(p.dtype)
            return new_p, m.to(dt), v.to(dt)

        out = _map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: _map(lambda o: o[i], out)  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2)}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moment, no momentum (Shazeer & Stern, 2018)."""
    lr: Callable | float = 1e-3
    decay: float = 0.8           # t^-decay second-moment decay schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params):
        def z(p):
            zeros = lambda shape: torch.zeros(  # noqa: E731
                shape, dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        return {"f": _map(z, params)}

    def state_logical_axes(self, param_axes):
        def ax(a):
            if len(a) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}
        return {"f": _map(ax, param_axes)}

    def update(self, grads, state, params, step, specs=None, mesh=None):
        """With the train state's ``specs`` (``{"params", "opt"}``) and a
        ``mesh``, the leaves are each rank's shards: a mean over a dim
        that the mesh splits sums its shards' parts over the ranks that
        hold them (the factored row and column means, the update's RMS),
        so no rank holds a whole leaf."""
        lr = _scalar(self.lr, step)
        t = _f32(int(step)) + 1.0
        beta = float(1.0 - t ** (-self.decay))
        sharded = mesh is not None and mesh.size > 1

        def upd(g, p, f, pspec, fspec):
            def mean(x, spec, dim=None, keepdim=False):
                return _mean(x, spec, mesh, dim, keepdim)

            def to(x, a, b):        # from the layout of spec a to b's
                return reshard(x, a, b, mesh) if sharded else x
            g = g.float()
            g2 = g * g + self.eps
            if p.ndim >= 2:
                rspec, cspec = pspec[:-1], pspec[:-2] + pspec[-1:]
                vr = beta * f["vr"] + (1 - beta) * to(
                    mean(g2, pspec, -1), rspec, fspec["vr"])
                vc = beta * f["vc"] + (1 - beta) * to(
                    mean(g2, pspec, -2), cspec, fspec["vc"])
                r, c = to(vr, fspec["vr"], rspec), to(vc, fspec["vc"], cspec)
                denom = (r[..., None] / mean(r, rspec, -1, keepdim=True)[
                    ..., None]) * c[..., None, :]
                u = g * torch.rsqrt(denom + self.eps)
                nf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + self.eps)
                nf = {"v": v}
            rms = torch.sqrt(mean(u * u, pspec))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            new_p = (p.float() - lr * u).to(p.dtype)
            return new_p, nf

        def walk(g, p, f, pspec, fspec):
            if isinstance(p, dict):
                out = {k: walk(g[k], p[k], f[k], pspec and pspec[k],
                               fspec and fspec[k]) for k in p}
                return ({k: o[0] for k, o in out.items()},
                        {k: o[1] for k, o in out.items()})
            if not sharded:         # one rank: no dim is split
                pspec = (None,) * p.ndim
                fspec = {k: (None,) * v.ndim for k, v in f.items()}
            return upd(g, p, f, pspec, fspec)

        new_p, new_f = walk(grads, params, state["f"],
                            specs and specs["params"],
                            specs and specs["opt"]["f"])
        return new_p, {"f": new_f}


def _mean(x: torch.Tensor, spec, mesh, dim=None, keepdim=False):
    """``torch.mean(x, dim)`` of the logical array whose shard (by
    ``spec`` on ``mesh``) ``x`` is; ``dim`` None is every dim. A dim no
    mesh axis splits takes the local mean as it is."""
    dims = range(x.ndim) if dim is None else [dim % x.ndim]
    axes = tuple(a for d in dims for a in spec_axes(spec[d]))
    if not axes:
        return torch.mean(x) if dim is None else torch.mean(
            x, dim=dim, keepdim=keepdim)
    n = math.prod(x.shape[d] for d in dims) * mesh.axis_size(axes)
    part = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                      keepdim=keepdim)
    return C.all_reduce_(part.contiguous(), mesh.group(axes)) / n


def get_optimizer(name: str, lr=None, total_steps: int = 10_000,
                  state_dtype: str = "float32"):
    sched = warmup_cosine(lr or 3e-4, min(2000, total_steps // 10 + 1),
                          total_steps)
    if name == "adamw":
        return AdamW(lr=sched, state_dtype=state_dtype)
    if name == "adafactor":
        return Adafactor(lr=sched)   # second moment factored; fp32 tiny
    raise ValueError(f"unknown optimizer {name}")

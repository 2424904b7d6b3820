"""Step builders, abstract input specs and sharding specs for every cell
(``src/repro/launch/api.py``).

For each (arch × shape): the function an entry point runs (the train step,
prefill, the serve step), the shapes and dtypes of its inputs, their
logical axes and, on a mesh, their specs (:func:`build_cell`).
:func:`lower_cell` is what the dry run counts: one rank's step with meta
tensors of that rank's shards for its arguments (the reference lowers
the cell through XLA instead).

The train step is functional, as the reference's: ``step(state, batch)
→ (new state, metrics)`` over ``{"params", "opt", "step"}`` (nested
dicts of tensors; ``step`` a 0-d int32 tensor), with gradients from
autograd through :func:`repro_torch.models.model.loss_fn`, accumulated
in float32 over ``grad_accum`` microbatches, clipped by global norm and
applied by the config's optimizer.

On a mesh (``make_train_step(cfg, mesh=, specs=)``) the state is each
rank's shards and the batch its rows. The loss's gradient flows back
through the per-layer gathers over the FSDP axes (their backward
reduce-scatters), the split layers' entries and exits over ``model``
and the MoE's collectives, every backward the adjoint of its forward,
so autograd on each rank gives that rank's part of the gradient of the
world's sum of losses, Σ_ranks loss_r. Every model peer computes the
loss of its rows whole (its vocabulary block's share is reduced over
``model``), so the world's sum is M × Σ_(pod, data) loss_rows with M
the ``model`` axis's size. A leaf split over ``model`` is on one model
peer only, but all M peers' losses reach it through the exits, so its
gradient carries the factor M too; a whole leaf's parts on the M peers
(their sequence blocks under SP, their heads' share, or the whole
computation repeated) sum to M times its gradient. Either way, each
shard's gradient summed over the ranks that hold the same shard and
divided by the world's size (M × pod × data) is the gradient of the
global batch's loss, the mean of the (pod, data) ranks' losses. The
global norm sums every shard once. Both optimizers
update the shards alone: AdamW is elementwise, and Adafactor's factored
row and column means and its update's RMS sum their shards' parts over
the ranks that split the dims, so no rank holds a whole leaf.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.models.params import (DTYPES, abstract_params, logical_axes,
                                       param_specs, params_from_numpy,
                                       tensor_from_numpy, tree_items,
                                       tree_map)
from repro_torch.obs import trace as obs
from repro_torch.optim import AdamW, clip_by_global_norm, get_optimizer
from repro_torch.optim.optimizers import tree_leaves

# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_abstract(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch's leaves as (shape, dtype)."""
    b, s = shape.global_batch, shape.seq_len
    act = DTYPES[cfg.act_dtype]
    if shape.kind == "train":
        if cfg.frontend != "none":
            return {"embeddings": ((b, s, cfg.d_model), act),
                    "targets": ((b, s), torch.int32)}
        return {"tokens": ((b, s), torch.int32),
                "targets": ((b, s), torch.int32)}
    if shape.kind == "prefill":
        if cfg.frontend != "none":
            return {"embeddings": ((b, s, cfg.d_model), act)}
        return {"tokens": ((b, s), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((b, 1), torch.int32), "pos": ((), torch.int32)}


def batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch's logical dim names (the reference's)."""
    key = "embeddings" if cfg.frontend != "none" else "tokens"
    ax = ("batch", None, "act_embed")[:3 if key == "embeddings" else 2]
    if shape.kind == "train":
        return {key: ax, "targets": ("batch", None)}
    if shape.kind == "prefill":
        return {key: ax}
    return {"tokens": ("batch", None), "pos": ()}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _optimizer(cfg: ModelConfig):
    return get_optimizer(cfg.optimizer, state_dtype=cfg.opt_state_dtype)


def make_train_state_abstract(cfg: ModelConfig) -> dict:
    """The train state's leaves as (shape, dtype): the restore template."""
    params = tree_map(lambda s: torch.empty(s.shape, device="meta",
                                            dtype=DTYPES[s.dtype
                                                         or cfg.param_dtype]),
                      param_specs(cfg))
    state = {"params": params, "opt": _optimizer(cfg).init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    return tree_map(lambda t: (tuple(t.shape), t.dtype), state)


def train_state_logical(cfg: ModelConfig) -> dict:
    pax = logical_axes(cfg)
    return {"params": pax, "opt": _optimizer(cfg).state_logical_axes(pax),
            "step": ()}


def state_specs(cfg: ModelConfig, mesh, rules=None, opt_rules=None) -> dict:
    """The train state's specs on ``mesh`` (the driver's: default rules;
    :func:`build_cell` passes :func:`_rules`)."""
    ax, ab = train_state_logical(cfg), make_train_state_abstract(cfg)
    return {"params": sharding.tree_specs(ax["params"], ab["params"], mesh,
                                          rules),
            "opt": sharding.tree_specs(ax["opt"], ab["opt"], mesh, opt_rules),
            "step": ()}


def train_state_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The port's train state from the JAX package's (``{"params",
    "opt", "step"}`` as nested dicts of numpy arrays), bit for bit: the
    params through :func:`params_from_numpy`, the optimizer's tree
    (AdamW's ``m``/``v``, Adafactor's ``f`` of ``vr``/``vc`` or ``v``)
    and the step. Raises if a leaf's path, shape or dtype differs from
    the state the config's optimizer makes."""
    want = dict(tree_items(make_train_state_abstract(cfg)["opt"]))
    got = dict(tree_items(tree["opt"]))
    if sorted(got) != sorted(want):
        raise ValueError(f"optimizer tree differs: got {sorted(got)}, "
                         f"want {sorted(want)}")

    def carry(path: str, arr) -> torch.Tensor:
        t = tensor_from_numpy(arr)
        shape, dtype = want[path]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"opt leaf {path} {tuple(t.shape)} {t.dtype} "
                             f"!= {shape} {dtype}")
        return t.to(device)

    def build(sub, prefix=""):
        return {k: build(v, f"{prefix}{k}.") if isinstance(v, dict)
                else carry(f"{prefix}{k}", v) for k, v in sub.items()}

    step = tensor_from_numpy(tree["step"])
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"step {tuple(step.shape)} {step.dtype} != () int32")
    return {"params": params_from_numpy(cfg, tree["params"], device),
            "opt": build(tree["opt"]), "step": step.to(device)}


def make_train_state(cfg: ModelConfig, params: dict) -> dict:
    """A fresh train state around ``params`` (zero optimizer state, step
    0), on the params' device."""
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": _optimizer(cfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> dict:
    return make_train_state(cfg, M.init_params(cfg, generator, device))


def make_grad_fn(cfg: ModelConfig, grad_accum: int = 0):
    """``grads(params, batch) → (grads, metrics)``: the loss's gradient
    in each param's dtype, or, over ``grad_accum`` > 1 microbatches (the
    batch's rows split evenly), their mean accumulated in float32, with
    the mean loss. Each microbatch's loss is the span ``step.forward``,
    its gradient ``step.backward``."""
    grad_accum = grad_accum or cfg.grad_accum

    def one(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tracked = _rebuild(params, it)
        with obs.span("step.forward"):
            loss, metrics = M.loss_fn(cfg, tracked, batch)
        with obs.span("step.backward"):
            gs = torch.autograd.grad(loss, live, materialize_grads=True)
        return _rebuild(params, iter(gs)), {k: v.detach()
                                            for k, v in metrics.items()}

    def grads(params, batch):
        if grad_accum <= 1:
            return one(params, batch)
        acc, l_sum = None, 0.0
        for mb in range(grad_accum):
            part = {k: v.reshape((grad_accum, -1) + v.shape[1:])[mb]
                    for k, v in batch.items()}
            g, metrics = one(params, part)
            g = tree_map(lambda x: x.float(), g)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            l_sum = l_sum + metrics["loss"]
        return (tree_map(lambda x: x / grad_accum, acc),
                {"loss": l_sum / grad_accum})

    return grads


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in the
    sorted-key order of :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def reduce_grads(grads: dict, specs: dict, mesh) -> dict:
    """Each shard's gradient summed (in float32) over the ranks that hold
    the same shard, over the world's size, in its own dtype: the
    gradient of the world's sum of losses counts each row's loss once a
    model peer (module docstring), so the world's size divides."""
    def one(g, spec):
        acc = C.all_reduce_(g.float(), mesh.group(
            sharding.replica_axes(spec, mesh)))
        return (acc / mesh.size).to(g.dtype)
    return tree_map(one, grads, specs)


def sharded_clip(grads: dict, specs: dict, mesh, max_norm: float):
    """``clip_by_global_norm`` of the logical gradient from its shards:
    each shard's Σg² counted once over the ranks that hold it."""
    sq = sum(torch.sum(torch.square(g.float()))
             / mesh.axis_size(sharding.replica_axes(spec, mesh))
             for g, spec in zip(tree_leaves(grads), tree_leaves(specs)))
    n = torch.sqrt(C.all_reduce_(sq.reshape(1), mesh.group(
        mesh.axis_names))[0])
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), n


def _sharded_update(opt, grads, opt_state, params, step, specs, mesh):
    if isinstance(opt, AdamW):          # elementwise: the shards alone
        return opt.update(grads, opt_state, params, step)
    return opt.update(grads, opt_state, params, step, specs, mesh)


def make_train_step(cfg: ModelConfig, grad_accum: int = 0,
                    clip_norm: float = 1.0, mesh=None,
                    specs: dict | None = None):
    """``step(state, batch) → (new state, metrics)``; on a ``mesh`` of
    more than one rank, over each rank's shards (``specs``: the state's,
    :func:`state_specs`) and rows. On one rank the clip is the span
    ``step.clip`` and the optimizer's update ``step.update``."""
    opt = _optimizer(cfg)
    grads_of = make_grad_fn(cfg, grad_accum)
    if mesh is not None and mesh.size > 1:
        return _sharded_step(opt, grads_of, clip_norm, mesh, specs)

    def step(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        with obs.span("step.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        with obs.span("step.update"):
            new_params, new_opt = opt.update(grads, state["opt"],
                                             state["params"], state["step"])
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return step


def _sharded_step(opt, grads_of, clip_norm, mesh, specs):
    def step(state, batch):
        world = mesh.group(mesh.axis_names)
        with sharding.use(mesh, specs["params"]):
            grads, metrics = grads_of(state["params"], batch)
        grads = reduce_grads(grads, specs["params"], mesh)
        metrics = {k: C.all_reduce_(v.float().reshape(1).clone(), world)[0]
                   / mesh.size for k, v in metrics.items()}
        grads, gnorm = sharded_clip(grads, specs["params"], mesh, clip_norm)
        with torch.no_grad():
            new_params, new_opt = _sharded_update(
                opt, grads, state["opt"], state["params"], state["step"],
                specs, mesh)
        metrics["grad_norm"] = gnorm
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return step


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def make_prefill(cfg: ModelConfig):
    def fn(params, batch):
        return M.prefill(cfg, params, batch)
    return fn


def make_serve_step(cfg: ModelConfig):
    def fn(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch["tokens"],
                             int(batch["pos"]))
    return fn


# ---------------------------------------------------------------------------
# cell assembly: (fn, abstract args, in/out specs)
# ---------------------------------------------------------------------------

def _rules(cfg: ModelConfig):
    """(param_rules, opt_rules): fsdp shards both over data; zero2 keeps
    params replicated (no per-layer gathers) but shards optimizer states
    (one u-gather per step — ZeRO-2); off replicates both over data."""
    if cfg.fsdp:
        return None, None
    if cfg.zero2:
        return {"embed": [None]}, None
    return {"embed": [None]}, {"embed": [None]}


def _meta(tree):
    return tree_map(lambda leaf: torch.empty(leaf[0], dtype=leaf[1],
                                             device="meta"), tree)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               grad_accum: int = 0):
    """Returns (fn, abstract args as meta tensors, in specs, out specs,
    donate_argnums) — the reference's cell, with spec trees (per-dim
    tuples of mesh axes) in place of its NamedShardings. The train cell's
    ``fn`` is the sharded train step on ``mesh``; prefill and decode are
    the model's own (their params gathered per layer on a mesh)."""
    pax = logical_axes(cfg)
    params_abs = abstract_params(cfg)
    batch_abs = batch_abstract(cfg, shape)
    batch_ax = batch_logical(cfg, shape)
    rules, opt_rules = _rules(cfg)
    batch_sp = sharding.tree_specs(batch_ax, batch_abs, mesh, rules)
    if shape.kind == "train":
        state_sp = state_specs(cfg, mesh, rules, opt_rules)
        fn = make_train_step(cfg, grad_accum=grad_accum, mesh=mesh,
                             specs=state_sp)
        in_sp = (state_sp, batch_sp)
        return (fn, (_meta(make_train_state_abstract(cfg)), _meta(batch_abs)),
                in_sp, (state_sp, None), (0,))
    params_sp = sharding.tree_specs(pax, params_abs, mesh, rules)
    cache_abs = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cache_sp = sharding.tree_specs(M.cache_logical_axes(cfg), cache_abs, mesh)
    if shape.kind == "prefill":
        return (make_prefill(cfg), (_meta(params_abs), _meta(batch_abs)),
                (params_sp, batch_sp), (None, cache_sp), ())
    return (make_serve_step(cfg),
            (_meta(params_abs), _meta(cache_abs), _meta(batch_abs)),
            (params_sp, cache_sp, batch_sp), (None, cache_sp), (1,))


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               grad_accum: int = 0):
    """One rank's cell, ready to walk: ``(step, args, in specs, out
    specs, donate_argnums)``, where ``args`` are meta tensors of the
    rank's shards of :func:`build_cell`'s arguments and ``step(*args)``
    runs the cell as that rank (prefill and decode inside
    :func:`sharding.use`, as the server runs them; the train step enters
    it itself). The train state's ``step`` is a CPU tensor holding 0 and
    the decode batch's ``pos`` one holding ``seq_len − 1``: the walk
    reads both as numbers. The cache (decode's argument, the output of
    prefill and decode) is laid out as the port holds it
    (``model.port_cache_specs``). On a ``DryMesh`` the step's collectives
    move nothing."""
    fn, args, in_sp, out_sp, donate = build_cell(cfg, shape, mesh,
                                                 grad_accum=grad_accum)
    if shape.kind != "train":
        cache_sp = M.port_cache_specs(cfg, shape.global_batch,
                                      shape.seq_len, mesh)
        out_sp = (None, cache_sp)
    if shape.kind == "decode":
        in_sp = (in_sp[0], cache_sp, in_sp[2])

    def local(x, spec):
        return torch.empty(sharding.local_shape(x.shape, spec, mesh),
                           dtype=x.dtype, device="meta")
    args = tuple(tree_map(local, a, sp) for a, sp in zip(args, in_sp))
    if shape.kind == "train":
        args[0]["step"] = torch.zeros((), dtype=torch.int32)
        return fn, args, in_sp, out_sp, donate
    if shape.kind == "decode":
        args[2]["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    params_sp = in_sp[0]

    def step(*a):
        with sharding.use(mesh, params_sp):
            return fn(*a)
    return step, args, in_sp, out_sp, donate

"""Step builders and abstract input specs (``src/repro/launch/api.py``,
on one device).

For each (arch × shape): the function an entry point runs (the train step,
prefill, the serve step) and the shapes and dtypes of its inputs.
``build_cell`` / ``lower_cell`` (the sharded cells of the dry run) wait
for ``distributed/`` and the dry run.

The train step is functional, as the reference's: ``step(state, batch)
→ (new state, metrics)`` over ``{"params", "opt", "step"}`` (nested
dicts of tensors; ``step`` a 0-d int32 tensor), with gradients from
autograd through :func:`repro_torch.models.model.loss_fn`, accumulated
in float32 over ``grad_accum`` microbatches, clipped by global norm and
applied by the config's optimizer.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.params import (DTYPES, param_specs, params_from_numpy,
                                       tensor_from_numpy, tree_items,
                                       tree_map)
from repro_torch.optim import clip_by_global_norm, get_optimizer
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
    the mean loss."""
    grad_accum = grad_accum or cfg.grad_accum

    def one(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tracked = _rebuild(params, it)
        loss, metrics = M.loss_fn(cfg, tracked, batch)
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


def make_train_step(cfg: ModelConfig, grad_accum: int = 0,
                    clip_norm: float = 1.0):
    opt = _optimizer(cfg)
    grads_of = make_grad_fn(cfg, grad_accum)

    def step(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = opt.update(grads, state["opt"],
                                         state["params"], state["step"])
        metrics = dict(metrics)
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

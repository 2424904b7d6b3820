"""The ``train`` driver: back-to-back steps of the port's trainer.

Set-up builds one training step (``launch.api.make_train_step``, the
configuration's optimizer, clipping at the ``train`` block's norm) and
one train state around the weights drawn from the seed, and drives that
same state through the first ``check.steps`` steps, through the same
call and feed as the window; those steps are the warm-up too. From them
it keeps what the check compares: each step's loss, each leaf's norm of
the first gradient as the optimizer got it (worked out from the first
moment after one step, m / (1 - b1)) and of each layer's slice of it,
each leaf's norm of the float32 first moment after those steps (every
checked step's gradient, leaf by leaf, with no bf16 rounding of the
stored parameters between them) and each leaf's norm of the change of
the parameters over those steps, as the next step receives them. The
window then runs steps until ``seconds`` have passed. Every step's rows
are new token ids, uniform over the vocabulary, drawn from the seed.

The check (:meth:`Train.check`) frees the program's state and runs the
plain reference over the same first steps from the same weights:
float32 arithmetic, each new parameter stored in its leaf's dtype
(:mod:`perfbench.reference.adamw`). The per-layer norms cover every
stack of the weight tree (:func:`.weights.stacked_paths`).
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
import time

import torch

from . import weights
from .trace import span


@dataclasses.dataclass
class Step:
    index: int
    rows: int
    seq_len: int


def _flat(tree: dict) -> dict:
    return dict(weights.leaves(tree))


def _norms(flat: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            flat.items()}


def _layer_norms(flat: dict, stacked: set) -> dict:
    """The norm of each layer's slice of every leaf in a stack (dotted
    paths ``stacked``)."""
    return {k: v.float().flatten(1).norm(dim=1).tolist()
            for k, v in flat.items() if k in stacked}


def _store(m: dict):
    """``store(name, value)``: a leaf's new value rounded to the dtype it
    is served in, back in float32."""
    dtypes = weights.dtypes(m)
    return lambda k, x: x.to(dtypes[k]).float()


class Train:
    """One training cell's program, feed and check."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.model, self.hyper = config["model"], config["train"]
        self.device = torch.device(device)
        self.stacked = weights.stacked_paths(self.model)

    # -- the feed -------------------------------------------------------------
    def feed(self, n: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(weights.stream_seed(self.seed, "train", n))
        t = torch.randint(0, self.model["vocab"],
                          (self.mix["batch"], self.mix["seq_len"] + 1),
                          generator=gen, device=self.device,
                          dtype=torch.int32)
        return {"tokens": t[:, :-1], "targets": t[:, 1:]}

    # -- set-up ---------------------------------------------------------------
    def _check_optimizer(self, api) -> None:
        """The configuration's ``train`` block is what the program runs."""
        from perfbench.reference import adamw
        opt = api._optimizer(self.cfg)
        h = self.hyper
        stated = (h["b1"], h["b2"], h["eps"], h["weight_decay"])
        runs = (opt.b1, opt.b2, opt.eps, opt.weight_decay)
        lrs = [(float(opt.lr(s)), adamw.lr_at(h, s))
               for s in (0, 1, 2, 3, h["warmup"], h["total_steps"] // 2)]
        if type(opt).__name__.lower() != h["optimizer"] or stated != runs \
                or any(abs(a - b) > 1e-6 * max(abs(b), 1e-12)
                       for a, b in lrs):
            raise ValueError(f"the configuration's train block {h} is not "
                             f"what the program runs: {opt}")

    def setup(self) -> None:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.launch import api
        from repro_torch.models.params import abstract_params
        self.cfg = ModelConfig(**self.model)
        self._check_optimizer(api)
        params = weights.make(self.model, self.seed, self.device)
        weights.check(params, abstract_params(self.cfg))
        self.step_fn = self._spanned_step(api)
        self.state = api.make_train_state(self.cfg, params)
        del params
        b1 = self.hyper["b1"]
        self.losses, self.grad_norms = [], None
        for n in range(self.mix["check"]["steps"]):
            metrics = self.step(n)
            self.losses.append(metrics["loss"])
            if n == 0:
                grad = {k: m / (1 - b1) for k, m in
                        _flat(self.state["opt"]["m"]).items()}
                self.grad_norms = _norms(grad)
                self.layer_norms = _layer_norms(grad, self.stacked)
                del grad
        self.losses = [float(v) for v in self.losses]
        self.moment_norms = _norms(_flat(self.state["opt"]["m"]))
        start = _flat(weights.make(self.model, self.seed, self.device))
        now = _flat(self.state["params"])
        self.change_norms = _norms({k: now[k].float() - start[k].float()
                                    for k in now})
        del start, now
        self.next = self.mix["check"]["steps"]
        self._sync()

    def _spanned_step(self, api):
        """The program's train step, built with spans around its gradient
        and its optimizer's update (the rest of a step is the clip)."""
        make_grad_fn, optimizer = api.make_grad_fn, api._optimizer

        def grad_fn(*a, **k):
            fn = make_grad_fn(*a, **k)

            def grads(*args):
                with span("train.grad"):
                    return fn(*args)
            return grads

        class Spanned:
            def __init__(self, opt):
                self.opt = opt

            def init(self, params):
                return self.opt.init(params)

            def update(self, *args):
                with span("train.update"):
                    return self.opt.update(*args)

        api.make_grad_fn = grad_fn
        api._optimizer = lambda cfg: Spanned(optimizer(cfg))
        try:
            return api.make_train_step(self.cfg,
                                       clip_norm=self.hyper["clip_norm"])
        finally:
            api.make_grad_fn, api._optimizer = make_grad_fn, optimizer

    def step(self, n: int) -> dict:
        batch = self.feed(n)
        with span("train.step"):
            self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, min_batches: int = 1):
        steps = []
        t0 = time.perf_counter()
        while True:
            self.step(self.next)
            self._sync()
            done = time.perf_counter() - t0
            steps.append(Step(self.next, self.mix["batch"],
                              self.mix["seq_len"]))
            self.next += 1
            if done >= seconds and len(steps) >= min_batches:
                return steps, done

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> dict:
        """The reference's losses, first clipped gradient's norms (whole
        and by layer), first moment's norms and change norms over the
        first steps, from the same weights and feed."""
        from perfbench.reference import adamw
        from perfbench.reference.layers import no_tf32
        ref = importlib.import_module(
            f"perfbench.reference.{self.model['family']}")
        no_tf32()
        store = _store(self.model)
        params = {k: v.float() for k, v in
                  _flat(weights.make(self.model, self.seed,
                                     self.device)).items()}
        start = {k: v.clone() for k, v in params.items()}
        state: dict = {}
        losses, grad_norms, layer_norms = [], None, None
        for n in range(self.mix["check"]["steps"]):
            b = self.feed(n)
            loss, grads = ref.loss_and_grads(self.model, params, b["tokens"],
                                             b["targets"], precision,
                                             self.hyper["z_loss"])
            grads = adamw.clip(grads, self.hyper["clip_norm"])
            losses.append(loss)
            if n == 0:
                grad_norms = _norms(grads)
                layer_norms = _layer_norms(grads, self.stacked)
            adamw.step(self.hyper, params, grads, state, n, store)
            del grads
        change = _norms({k: params[k] - start[k] for k in params})
        moments = _norms({k: m for k, (m, _) in state.items()})
        return {"losses": losses, "grad_norms": grad_norms,
                "layer_norms": layer_norms, "moment_norms": moments,
                "change_norms": change}

    def check(self, batches: list, against: str | None = None) -> dict:
        """The numbers of :func:`compare`. With ``against``, the reference
        in that precision takes the program's place."""
        if not hasattr(self, "_want"):
            self._want = self.reference("fp32")
        want = self._want
        got = (self.reference(against) if against else
               {"losses": self.losses, "grad_norms": self.grad_norms,
                "layer_norms": self.layer_norms,
                "moment_norms": self.moment_norms,
                "change_norms": self.change_norms})
        return compare(want, got)


def _worst(got: dict, want: dict, keys):
    """(gap, leaf) of the worst leaf: the gap between the program's norm
    and the reference's, over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    med = statistics.median(want.values())
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def compare(want: dict, got: dict) -> dict:
    """The training check's numbers, reference ``want`` against ``got``.

    ``loss_gap``: the widest gap between a checked step's loss and the
    reference's. ``grad_gap``: by the worst leaf, the gap between the norms
    of the first clipped gradient, over the reference's norm of that leaf
    or of the median leaf, whichever is larger; ``m_gap``: the same for
    the first moment after the checked steps. ``layer_gap``: by the worst
    layer of any leaf, the gap between the norms of that layer's slice of
    the first clipped gradient, over the reference's: the one number that
    a zero gradient for the chunks' decays (da) moves, through the small
    leaves ``A_log`` and ``dt_bias``, but by no more than a few times its
    sound readings (read by ``control.py``, not compared).
    ``change_leaf_gap``: by the worst leaf, the gap between the norms of
    the parameters' change over the checked steps, as ``grad_gap`` takes
    it; ``change_gap``: the gap between the norms of the whole model's
    change, over the reference's. The layer and change numbers leave out
    leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by rounding alone). Each ``*_leaf`` names the worst
    leaf of its number; the cell's limits name the numbers compared."""
    g = want["grad_norms"]
    med = statistics.median(g.values())
    keep = [k for k in g if g[k] >= 1e-3 * med]

    def whole(norms: dict) -> float:
        return sum(norms[k] ** 2 for k in keep) ** 0.5
    change = whole(want["change_norms"])
    out = {"loss_gap": max(abs(a - b) for a, b in
                           zip(got["losses"], want["losses"])),
           "change_gap": abs(whole(got["change_norms"]) - change)
           / max(change, 1e-30)}
    out["grad_gap"], out["grad_gap_leaf"] = _worst(got["grad_norms"], g, g)
    out["m_gap"], out["m_gap_leaf"] = _worst(
        got["moment_norms"], want["moment_norms"], g)
    out["change_leaf_gap"], out["change_leaf_gap_leaf"] = _worst(
        got["change_norms"], want["change_norms"], keep)
    layers = {(k, i): abs(a - b) / max(b, 1e-30)
              for k in keep if k in want["layer_norms"]
              for i, (a, b) in enumerate(zip(got["layer_norms"][k],
                                             want["layer_norms"][k]))}
    worst = max(layers, key=layers.get)
    out["layer_gap"], out["layer_gap_leaf"] = layers[worst], \
        f"{worst[0]}[{worst[1]}]"
    return out

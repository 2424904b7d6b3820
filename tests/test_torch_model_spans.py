"""The spans of the port's model path and trainer, on the CPU.

Under a :class:`~repro_torch.obs.trace.Tracer` a prefill and a train step
of the reduced Mamba2-1.3B give the span trees of ``obs/trace.py``'s
taxonomy; under ``torch.profiler`` the same names are user annotations
on the profiler's clock, nested as in the tree; with neither on, the
path enters no ``record_function``, builds the autograd graph a traced
run builds and gives the same bits.
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import api
from repro_torch.models import model as M
from repro_torch.models import params as tparams
from repro_torch.models import ssm
from repro_torch.obs import trace as T
from repro_torch.optim.optimizers import tree_leaves

B, S = 2, 32


@pytest.fixture(scope="module")
def cfg():
    c = configs.get_config("mamba2_1p3b").reduced()
    assert c.remat == "full" and c.n_layers == 2
    return c


@pytest.fixture(scope="module")
def params(cfg):
    return tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def batch(cfg):
    t = torch.randint(0, cfg.vocab, (B, S + 1), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(1))
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def _prefill(cfg, params, batch):
    return M.prefill(cfg, params, {"tokens": batch["tokens"]})


def _step(cfg, params, batch):
    step = api.make_train_step(cfg)
    return step(api.make_train_state(cfg, params), batch)


def _traced(fn, *args):
    tr = T.Tracer()
    with T.using_tracer(tr):
        out = fn(*args)
    return tr, out


def _by_id(tr):
    return {s.span_id: s for s in tr.spans}


def _parent(tr, s):
    return _by_id(tr).get(s.parent_id)


def _profiled(fn, *args):
    """(user annotations as (name, start ns, end ns), fn's result)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    ev = [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation()]
    return ev, out


def _within(inner, outers) -> bool:
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


# -- under a Tracer -------------------------------------------------------

def test_prefill_tree(cfg, params, batch):
    tr, _ = _traced(_prefill, cfg, params, batch)
    assert all(s.end is not None for s in tr.spans)
    (root,) = tr.named("model.prefill")
    assert root.parent_id is None
    layers = tr.named("model.layer")
    assert [s.attrs["layer"] for s in layers] == list(range(cfg.n_layers))
    assert all(s.parent_id == root.span_id for s in layers)
    ssd = tr.named("ssm.ssd")
    assert [_parent(tr, s) for s in ssd] == layers
    assert [_parent(tr, s) for s in tr.named("ssm.intra")] == ssd
    (head,) = tr.named("model.head")
    assert head.parent_id == root.span_id
    assert tr.subtree_names(root).count("ssm.intra") == cfg.n_layers


def test_train_step_tree(cfg, params, batch):
    tr, _ = _traced(_step, cfg, params, batch)
    assert all(s.end is not None for s in tr.spans)
    roots = {s.name: s for s in tr.spans if s.parent_id is None}
    assert set(roots) == {"step.forward", "step.backward", "step.clip",
                          "step.update"}
    fwd, bwd = roots["step.forward"], roots["step.backward"]
    layers = tr.named("model.layer")
    assert [s.attrs["layer"] for s in layers] == list(range(cfg.n_layers))
    assert all(s.parent_id == fwd.span_id for s in layers)
    (head,) = tr.named("model.head")
    assert head.parent_id == fwd.span_id
    # the backward walks the layers last to first, each recomputed once
    recompute = tr.named("model.layer.recompute")
    assert [s.attrs["layer"] for s in recompute] == \
        list(range(cfg.n_layers))[::-1]
    back = tr.named("ssm.ssd.backward")
    assert len(back) == cfg.n_layers
    (head_back,) = tr.named("model.head.backward")
    for s in recompute + back + [head_back]:
        assert s.parent_id == bwd.span_id
        assert bwd.start <= s.start <= s.end <= bwd.end
    # the head's backward comes first, each layer's mixer backward holds
    # its recompute
    assert head_back.end <= back[0].start
    for b, r in zip(back, recompute):
        assert b.start <= r.start <= r.end <= b.end
    ssd = tr.named("ssm.ssd")
    assert len(ssd) == 2 * cfg.n_layers
    assert {_parent(tr, s).name for s in ssd} == {"model.layer",
                                                  "model.layer.recompute"}
    order = [roots[n].start for n in ("step.forward", "step.backward",
                                      "step.clip", "step.update")]
    assert order == sorted(order)


def test_grad_accum_gives_a_forward_and_backward_a_microbatch(cfg, params,
                                                              batch):
    grads = api.make_grad_fn(cfg, grad_accum=2)
    tr, _ = _traced(grads, params, batch)
    assert len(tr.named("step.forward")) == len(tr.named("step.backward")) \
        == 2
    assert len(tr.named("model.head.backward")) == 2


# -- under torch.profiler -------------------------------------------------

def test_prefill_ranges_nest_as_the_tree(cfg, params, batch):
    ev, _ = _profiled(_prefill, cfg, params, batch)
    by = {}
    for e in ev:
        by.setdefault(e[0], []).append(e)
    assert len(by["model.prefill"]) == 1
    assert len(by["model.layer"]) == len(by["ssm.ssd"]) == \
        len(by["ssm.intra"]) == cfg.n_layers
    assert all(_within(e, by["model.prefill"]) for e in by["model.layer"])
    assert all(_within(e, by["model.layer"]) for e in by["ssm.ssd"])
    assert all(_within(e, by["ssm.ssd"]) for e in by["ssm.intra"])
    assert _within(by["model.head"][0], by["model.prefill"])


def test_train_ranges_nest_as_the_tree(cfg, params, batch):
    ev, _ = _profiled(_step, cfg, params, batch)
    by = {}
    for e in ev:
        by.setdefault(e[0], []).append(e)
    for name in ("step.forward", "step.backward", "step.clip",
                 "step.update", "model.head", "model.head.backward"):
        assert len(by[name]) == 1, name
    for name in ("model.layer", "model.layer.recompute",
                 "ssm.ssd.backward"):
        assert len(by[name]) == cfg.n_layers, name
    assert all(_within(e, by["step.forward"])
               for e in by["model.layer"] + by["model.head"])
    assert all(_within(e, by["step.backward"]) for e in
               by["model.layer.recompute"] + by["ssm.ssd.backward"]
               + by["model.head.backward"])
    assert all(_within(e, by["ssm.ssd.backward"])
               for e in by["model.layer.recompute"])
    assert all(_within(e, by["model.layer"] + by["model.layer.recompute"])
               for e in by["ssm.ssd"])


def test_ranges_are_on_the_profilers_clock(cfg, params, batch):
    # the profiler stamps in Unix-epoch ns; perf_counter's zero is not
    # the epoch
    t0 = time.time_ns()
    ev, _ = _profiled(_prefill, cfg, params, batch)
    t1 = time.time_ns()
    (root,) = [e for e in ev if e[0] == "model.prefill"]
    slack = 1_000_000_000
    assert t0 - slack <= root[1] <= root[2] <= t1 + slack
    assert abs(root[1] - time.perf_counter_ns()) > 1e17


def test_tracer_and_profiler_together(cfg, params, batch):
    tr = T.Tracer()
    with T.using_tracer(tr):
        ev, _ = _profiled(_step, cfg, params, batch)
    names = [e[0] for e in ev if e[0].startswith(("model.", "ssm.",
                                                 "step."))]
    assert sorted(names) == sorted(s.name for s in tr.spans)


# -- with tracing off -----------------------------------------------------

@pytest.fixture
def entered(monkeypatch):
    """Counts every ``record_function`` entered."""
    count = []
    real = torch.autograd.profiler.record_function.__enter__

    def spy(self):
        count.append(self.name)
        return real(self)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", spy)
    return count


def test_off_enters_no_record_function(cfg, params, batch, entered):
    assert T.ACTIVE is None
    _prefill(cfg, params, batch)
    _step(cfg, params, batch)
    assert entered == []
    # the spy sees ranges when the profiler records
    _profiled(_prefill, cfg, params, batch)
    assert "model.prefill" in entered


def _graph(loss) -> list:
    """The names of every node of the autograd graph under ``loss``."""
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _loss(cfg, params, batch):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tracked = api._rebuild(params, iter(live))
    return M.loss_fn(cfg, tracked, batch)[0]


def test_off_builds_the_unmarked_graph(cfg, params, batch):
    # the backward spans hook tensors and add no node
    off = _graph(_loss(cfg, params, batch))
    _, loss = _traced(_loss, cfg, params, batch)
    _, prof = _profiled(_loss, cfg, params, batch)
    assert sorted(_graph(loss)) == sorted(_graph(prof)) == sorted(off)


def _bits(tree) -> list:
    return [t.detach().clone() for t in tree_leaves(tree)]


def _run_all(cfg, params, batch):
    logits, cache = _prefill(cfg, params, batch)
    grads, metrics = api.make_grad_fn(cfg)(params, batch)
    return [logits, *_bits(cache), metrics["loss"], *_bits(grads)]


def test_bits_equal_off_and_traced(cfg, params, batch):
    off = _run_all(cfg, params, batch)
    _, tracer = _traced(_run_all, cfg, params, batch)
    _, prof = _profiled(_run_all, cfg, params, batch)
    for got in (tracer, prof):
        assert len(got) == len(off)
        assert all(torch.equal(a, b) for a, b in zip(off, got))


# -- the helpers ------------------------------------------------------------

def test_span_gates():
    assert T.ACTIVE is None
    assert T.span("ssm.ssd") is T.NULL_SPAN
    assert T.open_span("ssm.ssd.backward") is None
    assert T.backward_span("ssm.ssd.backward") is None
    with profile(activities=[ProfilerActivity.CPU]):
        with T.span("ssm.ssd") as sp:
            assert sp is None
        assert T.open_span("x") is not None
        with torch.no_grad():
            assert T.backward_span("x") is None


def test_open_span_does_not_stack():
    tr = T.Tracer(clock=T.VirtualClock())
    with T.using_tracer(tr):
        with T.span("step.backward") as outer:
            h = T.open_span("ssm.ssd.backward", layer=3)
            with T.span("model.layer.recompute") as inner:
                pass
            h.close()
            h.close()
    back = tr.named("ssm.ssd.backward")[0]
    assert back.parent_id == inner.parent_id == outer.span_id
    assert back.attrs == {"layer": 3} and back.end is not None
    assert back.start < inner.start < inner.end < back.end


def test_backward_span_unmarked_without_grad():
    x = torch.ones(3)
    y = torch.ones(3, requires_grad=True) * 2
    with T.using_tracer(T.Tracer()):
        mark = T.backward_span("m")
        assert mark.enter(x) is x
        assert mark.leave(y) is y and y._backward_hooks is None


def test_backward_span_opens_and_closes_around_the_region():
    tr = T.Tracer(clock=T.VirtualClock())
    seen = []
    u = torch.ones(3, requires_grad=True)
    with T.using_tracer(tr):
        mark = T.backward_span("m", layer=1)
        v = mark.enter(u * 1.0)
        w = v * 3.0
        w.register_hook(lambda g: seen.append(mark.opened is not None))
        y = mark.leave(w + 1.0)
        (g,) = torch.autograd.grad(y.sum(), u)
    (sp,) = tr.named("m")
    assert seen == [True] and mark.opened is None
    assert sp.end is not None and sp.attrs == {"layer": 1}
    assert torch.equal(g, torch.full((3,), 3.0))


def test_ssd_backward_span_under_grad_of_the_input_alone(cfg, params):
    # the mixer's backward reached through its input only: the span opens
    # and closes once
    p = tparams.tree_map(lambda t: t[0], params["layers"]["ssm"])
    u = torch.randn(1, 32, cfg.d_model, requires_grad=True,
                    generator=torch.Generator().manual_seed(2))
    tr = T.Tracer()
    with T.using_tracer(tr):
        out = ssm.ssd_forward(cfg, p, u)
        (g,) = torch.autograd.grad(out.sum(), u)
    (back,) = tr.named("ssm.ssd.backward")
    assert back.end is not None and g.shape == u.shape

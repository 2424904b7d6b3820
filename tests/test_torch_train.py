"""repro_torch's training side against the JAX package, on the CPU.

``loss_fn`` and its gradients (autograd) are held against
``jax.value_and_grad(repro.models.model.loss_fn)`` for every arch's
reduced config, on the same numpy-carried params and batch: the loss
within rtol 1e-5, each gradient leaf within a tolerance of its own
largest |g| that depends on the depth. The reduced models at their
random init amplify a last-bit difference of the forward by about 10×
a layer (the reference's own jit and eager gradients differ by 2e-5 of
max |g| at 2 layers; the port against the reference: ≈ 5e-6 at one
layer, ≈ 1e-4 at two, ≈ 1e-3 at three), so each arch is held at one
layer within 2e-5 and at its reduced depth (two layers) within 2e-4.
The JAX model runs with no mesh, so its ``moe_layer`` is
``_moe_dense``: the port runs under ``moe_impl="dense"`` there, and its
``_dispatch_combine`` is held against the reference's on its own.

Then the port against itself: the train step of every arch (the twin
of ``tests/test_archs_smoke.py::test_one_train_step``), gradient
accumulation against one batch of twice the size, the three remat
policies bit for bit, the kernels' plain walks (``interpret``) against
the oracles (``ref``) under autograd, the SSD's training forward
against its serving forward bit for bit, and ``train.main``'s loss
and resume (the twins of ``tests/test_system.py``'s, which fail on this
tree under jax 0.9.0, held here to their behaviour).
"""
import contextlib
import dataclasses
import io
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import configs as jconfigs
from repro.core import isa as jisa
from repro.launch import api as japi
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.core import isa
from repro_torch.kernels import ops
from repro_torch.kernels import prefix_scan as ps
from repro_torch.launch import api
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import params as tparams
from repro_torch.models import ssm
from repro_torch.optim.optimizers import tree_leaves

LOSS_RTOL = 1e-5
GRAD_TOL = {1: 2e-5, 2: 2e-4}   # of each leaf's own max |g|, by depth
B, S = 2, 32


def cfgs(arch, **over):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(configs.get_config(arch).reduced(), **over))


def dense(arch):
    """The reference's unsharded MoE is ``_moe_dense``."""
    return {"moe_impl": "dense"} if jconfigs.get_config(arch).n_experts \
        else {}


def weights(jcfg, cfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tparams.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                         "cpu")


def batch_np(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend != "none":
        out["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_grads(cfg, tp, batch, grad_accum=1):
    grads, metrics = api.make_grad_fn(cfg, grad_accum)(tp, torch_batch(batch))
    return grads, metrics


def assert_grads_close(got: dict, want, tol=GRAD_TOL[1]):
    """Each leaf of ``got`` (port) within ``tol`` of the max |g| of the
    same leaf of ``want`` (a JAX tree), leaves matched by path."""
    want = dict(tparams.tree_items(jax.tree.map(np.asarray, want)))
    got = dict(tparams.tree_items(got))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        err = np.abs(g.float().numpy() - w).max() / max(np.abs(w).max(),
                                                        1e-30)
        assert err <= tol, (path, err)


def bits(tree) -> list:
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# loss_fn and its gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", sorted(GRAD_TOL))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_loss_and_grads_match_the_reference(arch, n_layers):
    jcfg, cfg = cfgs(arch, n_layers=n_layers, **dense(arch))
    jp, tp = weights(jcfg, cfg)
    batch = batch_np(cfg)
    with jisa.use("ref"):
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
                jp, jax.tree.map(jnp.asarray, batch))
    grads, metrics = port_grads(cfg, tp, batch)
    for key in ("loss", "ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=LOSS_RTOL)
    assert_grads_close(grads, jg, GRAD_TOL[n_layers])


def test_ce_chunk_loss_and_grads_match_the_reference():
    jcfg, cfg = cfgs("llama3_8b", ce_chunk=8, n_layers=1)
    jp, tp = weights(jcfg, cfg, seed=1)
    batch = batch_np(cfg, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    grads, metrics = port_grads(cfg, tp, batch)
    assert float(metrics["z_loss"]) == 0.0 == float(jm["z_loss"])
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=LOSS_RTOL)
    assert_grads_close(grads, jg)


@pytest.mark.parametrize("over", [{}, {"mlp_gated": False},
                                  {"capacity_factor": 0.5}])
def test_dispatch_combine_grads_match_the_reference(over):
    # the port's capacity-bucketed dispatch (K7 and K3 under interpret)
    # against the reference's, both differentiated: gradients to the
    # tokens, the router (through the gates) and the expert weights
    jcfg, cfg = cfgs("kimi_k2_1t", **over)
    jp, tp = weights(jcfg, cfg, seed=2)
    rng = np.random.default_rng(2)
    toks = rng.standard_normal((32, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((32, cfg.d_model)).astype(np.float32)
    keys = ("router", "w_in", "w_out") + (("w_gate",) if cfg.mlp_gated
                                          else ())
    jlayer = {k: jp["layers"]["moe"][k][0] for k in keys}

    def jloss(p, x):
        out, aux = jmoe._dispatch_combine(jcfg, x, p, None, None, 1)
        return jnp.sum(out * cot) + aux

    with jisa.use("ref"):
        jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jlayer, jnp.asarray(toks))
    layer = {k: tp["layers"]["moe"][k][0].clone().requires_grad_()
             for k in keys}
    x = torch.from_numpy(toks).requires_grad_()
    with isa.use("interpret"):
        out, aux = moe._dispatch_combine(cfg, x, layer)
        loss = torch.sum(out * torch.from_numpy(cot)) + aux
        gs = torch.autograd.grad(loss, [x, *layer.values()])
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert_grads_close({"x": gs[0], **dict(zip(layer, gs[1:]))},
                       {"x": jgx, **jgp})


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def small_batch(cfg, seed=0):
    return torch_batch(batch_np(cfg, seed))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_one_train_step(arch):
    _, cfg = cfgs(arch)
    state = api.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    step = api.make_train_step(cfg)
    mid_state, metrics = step(state, small_batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    # step 0 has lr=0 (warmup): the params are those before it
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(mid_state["params"])))
    # params must move on step 1
    new_state, metrics = step(mid_state, small_batch(cfg, 1))
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(new_state["step"]) == 2
    moved = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(mid_state["params"]), tree_leaves(new_state["params"]))]
    assert max(moved) > 0


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_1p3b", "grok1_314b"])
def test_train_step_matches_the_reference(arch):
    # both packages from one numpy train state, two steps each: the loss
    # and the global norm of the gradient agree step by step (the params
    # after an update are not compared: Adam's first steps move each
    # param by ±lr, so a last-bit gradient near 0 flips one)
    jcfg, cfg = cfgs(arch, **dense(arch))
    jstate = japi.init_train_state(jcfg, jax.random.PRNGKey(4))
    state = api.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(japi.make_train_step(jcfg))
    step = api.make_train_step(cfg)
    for i in range(2):
        batch = batch_np(cfg, 10 + i)
        with jisa.use("ref"):
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        # carry the reference's state on, so each step starts equal
        state = api.train_state_from_numpy(
            cfg, jax.tree.map(np.asarray, jstate), "cpu")


def test_train_state_from_numpy_carries_every_leaf_bit_for_bit():
    jcfg, cfg = cfgs("kimi_k2_1t", param_dtype="bfloat16")
    for name in ("adamw", "adafactor"):
        jc = dataclasses.replace(jcfg, optimizer=name)
        c = dataclasses.replace(cfg, optimizer=name)
        tree = jax.tree.map(np.asarray, japi.init_train_state(
            jc, jax.random.PRNGKey(5)))
        state = api.train_state_from_numpy(c, tree, "cpu")
        want = dict(tparams.tree_items(tree))
        got = dict(tparams.tree_items(state))
        assert got.keys() == want.keys()
        for path, t in got.items():
            w = want[path]
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              w.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), w)
        assert state["step"].dtype == torch.int32
        with pytest.raises(ValueError, match="optimizer tree differs"):
            api.train_state_from_numpy(
                dataclasses.replace(c, optimizer="adafactor" if name ==
                                    "adamw" else "adamw"), tree, "cpu")


def test_grad_accum_matches_one_batch_of_twice_the_size():
    _, cfg = cfgs("llama3_8b")
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = batch_np(cfg, 3, b=4)
    one, m1 = port_grads(cfg, tp, batch)
    two, m2 = port_grads(cfg, tp, batch, grad_accum=2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(two), tree_leaves(one)):
        assert a.dtype == torch.float32
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_1p3b", "kimi_k2_1t"])
def test_remat_policies_give_identical_grads(arch):
    _, cfg = cfgs(arch)
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    batch = batch_np(cfg, 4)
    got = {}
    for remat in ("full", "dots", "none"):
        g, m = port_grads(dataclasses.replace(cfg, remat=remat), tp, batch)
        got[remat] = (bits(g), m["loss"])
    for remat in ("dots", "none"):
        assert torch.equal(got[remat][1], got["full"][1])
        assert all(torch.equal(a, b) for a, b in zip(got[remat][0],
                                                     got["full"][0]))


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b", "kimi_k2_1t"])
def test_interpret_grads_match_ref(arch):
    # the kernels' plain walks under autograd (K4 forward and its reverse
    # walk, K7 with its scatter, K3 in _slots) against the oracles that
    # autograd differentiates; Kimi-K2 through the dispatch path
    _, cfg = cfgs(arch, capacity_factor=8.0)
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = batch_np(cfg, 5)
    grads = {}
    for mode in ("ref", "interpret"):
        with isa.use(mode):
            grads[mode], _ = port_grads(cfg, tp, batch)
    for a, b in zip(tree_leaves(grads["interpret"]), tree_leaves(grads["ref"])):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)


def test_interpret_train_step_launches_the_scans_under_remat():
    # remat full: each layer's K4 forward runs twice (forward and
    # recompute), its reverse walk once
    _, cfg = cfgs("mamba2_1p3b")
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    calls = []
    real = ps.chunk_scan_state_kernel

    def spy(a, states, axis=1, interpret=False, reverse=False):
        calls.append(reverse)
        return real(a, states, axis, interpret, reverse)

    ps.chunk_scan_state_kernel = spy
    try:
        with isa.use("interpret"):
            port_grads(cfg, tp, batch_np(cfg, 6))
    finally:
        ps.chunk_scan_state_kernel = real
    assert calls.count(False) == 2 * cfg.n_layers
    assert calls.count(True) == cfg.n_layers


def test_remat_recompute_keeps_the_forward_mode_on_another_thread():
    # autograd runs a CUDA backward on a thread of its own, where the
    # registry's thread-local mode is the default: the recompute must
    # still run the forward's mode (here the backward runs on a thread we
    # start, with the default mode, which on CPU tensors means ref)
    import threading
    _, cfg = cfgs("mamba2_1p3b")
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    live = [p.requires_grad_() for p in tree_leaves(tp)]
    calls = []
    real = ps.chunk_scan_state_kernel

    def spy(a, states, axis=1, interpret=False, reverse=False):
        calls.append((threading.current_thread().name, interpret, reverse))
        return real(a, states, axis, interpret, reverse)

    ps.chunk_scan_state_kernel = spy
    try:
        with isa.use("interpret"):
            loss, _ = M.loss_fn(cfg, tp, small_batch(cfg, 8))
        done = []
        worker = threading.Thread(
            target=lambda: done.append(torch.autograd.grad(loss, live)),
            name="backward")
        worker.start()
        worker.join()
    finally:
        ps.chunk_scan_state_kernel = real
    assert done and all(g is not None for g in done[0])
    on_worker = [c for c in calls if c[0] == "backward"]
    # the recompute's forward walks and the reverse walks, all interpret
    assert sorted(on_worker) == sorted(
        [("backward", True, False)] * cfg.n_layers
        + [("backward", True, True)] * cfg.n_layers)


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b"])
def test_ssd_train_forward_is_the_serving_forward_bit_for_bit(arch):
    _, cfg = cfgs(arch)
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    p = tparams.tree_map(lambda t: t[0], tp["layers"]["ssm"])
    u = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        serve = ssm.ssd_forward(cfg, p, u)
    tracked = tparams.tree_map(lambda t: t.clone().requires_grad_(), p)
    train_out = ssm.ssd_forward(cfg, tracked, u)
    assert train_out.requires_grad
    assert torch.equal(train_out.detach(), serve)
    train_out.sum().backward()          # the out-of-place form has a backward
    assert all(t.grad is not None for t in tracked.values())


# ---------------------------------------------------------------------------
# train.main (twins of tests/test_system.py)
# ---------------------------------------------------------------------------

def test_training_loss_decreases():
    """~200 steps of a reduced model on synthetic data: loss must drop."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = train.main(["--arch", "llama3-8b", "--reduced",
                            "--steps", "200", "--batch", "8",
                            "--seq", "128", "--log-every", "20",
                            "--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step")]
    losses = [float(ln.split()[3]) for ln in lines]
    assert losses[-1] < losses[0] - 0.1, losses
    assert np.isfinite(final)
    assert buf.getvalue().splitlines()[-1] == f"done: final loss {final:.4f}"


def test_train_resume_continues(tmp_path):
    args = ["--arch", "mamba2-1.3b", "--reduced", "--batch", "4", "--seq",
            "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--log-every", "3", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(args + ["--steps", "6"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(args + ["--steps", "9"])
    assert "resumed from step 6" in buf.getvalue()
    assert [ln.split()[1] for ln in buf.getvalue().splitlines()
            if ln.startswith("step")] == ["9"]


def test_resume_continues_the_uninterrupted_run(tmp_path):
    # the data stream is addressed by the step and the state is restored
    # bit for bit, so 3 + 3 steps are the 6 steps of one run
    args = ["--arch", "mamba2-1.3b", "--reduced", "--batch", "2", "--seq",
            "32", "--log-every", "1", "--device", "cpu"]
    whole = io.StringIO()
    with contextlib.redirect_stdout(whole):
        train.main(args + ["--steps", "6"])
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path)])
    part = io.StringIO()
    with contextlib.redirect_stdout(part):
        train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path)])

    def losses(text):
        return [ln.split()[3] for ln in text.splitlines()
                if ln.startswith("step")]
    assert losses(part.getvalue()) == losses(whole.getvalue())[3:]


def test_train_main_leaves_no_preemption_handler(tmp_path):
    # the SIGTERM handler and the state it keeps end with main: a later
    # signal in the same process writes no checkpoint
    before = signal.getsignal(signal.SIGTERM)
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "1",
                    "--batch", "2", "--seq", "32", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_main_refuses_what_needs_the_mesh():
    """On a world of one the mesh flags run on the trivial mesh (1×1, no
    ``pod`` axis to sync, as in the reference); a mesh the world cannot
    hold is refused."""
    for flag in (["--model-parallel", "2"], ["--pod-sync-every", "1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = train.main(["--arch", "mamba2-1.3b", "--reduced",
                               "--device", "cpu", "--steps", "2", "--batch",
                               "2", "--seq", "16", "--log-every", "1", *flag])
        assert "mesh 1x1 axes ('data', 'model') (1 devices)" in \
            buf.getvalue()
        assert np.isfinite(loss)
    from repro_torch.launch.mesh import make_elastic_mesh
    with pytest.raises(ValueError, match="the world 1"):
        make_elastic_mesh(n_devices=2, model_parallel=2)


def test_abstract_state_is_the_reference_state():
    for arch in ("mamba2_1p3b", "kimi_k2_1t"):
        jcfg, cfg = (jconfigs.get_config(arch), configs.get_config(arch))
        want = {path: (tuple(s.shape), np.dtype(s.dtype).name) for path, s in
                tparams.tree_items(japi.make_train_state_abstract(jcfg))}
        got = {path: (shape, str(dt).removeprefix("torch."))
               for path, (shape, dt) in tparams.tree_items(
                   api.make_train_state_abstract(cfg))}
        assert got == want
        shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=64,
                                    global_batch=2)
        jb = japi.batch_abstract(jcfg, dataclasses.replace(
            jconfigs.SHAPES["train_4k"], seq_len=64, global_batch=2))
        tb = api.batch_abstract(cfg, shape)
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jb.items()} == {
            k: (s, str(d).removeprefix("torch.")) for k, (s, d) in tb.items()}


def test_isa_guard_leaves_the_router_scan_alone():
    # _slots scans a one-hot of integer ids (K3): no operand requires
    # grad, so the guard lets it through while the router's logits do
    _, cfg = cfgs("kimi_k2_1t")
    ids = torch.tensor([[0, 3], [3, 1], [0, 2]], dtype=torch.int32)
    with isa.use("interpret"):
        dst = moe._slots(cfg, ids, 8)
    assert dst.tolist() == [0, 24, 25, 8, 1, 16]
    logits = torch.randn(3, cfg.n_experts, requires_grad=True)
    with isa.use("interpret"):
        gates, _, _ = moe._route(cfg, logits)
    assert gates.requires_grad
    with pytest.raises(ValueError, match="c3_prefixsum"):
        with isa.use("interpret"):
            ops.prefix_sum(logits)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase L helpers, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_splits_k4_by_direction_in_trace_order(smoke):
    # forward of 3 layers, then per layer the recompute and the reverse
    fwd, rec, rev = 1.0, 2.0, 10.0
    events = ([("k4_state_scan", fwd)] * 3 + [("gemm", 5.0)]
              + [("k4_state_scan", rec), ("elementwise", 1.0),
                 ("k4_state_scan", rev)] * 3)
    got = smoke.k4_by_direction(events, 3)
    assert got == {"k4_events": 9, "forward_ms": 3 * fwd + 3 * rec,
                   "reverse_ms": 3 * rev}
    assert smoke.k4_by_direction(events[:4], 3)["reverse_ms"] is None


def test_smoke_train_peak_limit_counts_the_step(smoke):
    cfg = configs.get_config("mamba2_1p3b")
    params = smoke.weight_bytes(cfg)
    limit = smoke.train_peak_limit(cfg, 4, 4096)
    assert smoke.PEAK_MEM_LIMIT["L"] == limit
    # above the state a step holds (params, grads, two fp32 moments) and
    # the logits, below the card
    assert 6 * params + 2 * 4 * 4096 * cfg.vocab * 4 < limit < 80e9


def ssd_broken(kind):
    """c4_statescan's backward with one fault (see
    ``test_torch_prefix_scan.broken_state_scan_grad``)."""
    real = ps.state_scan_grad
    if kind == "carry dropped":
        return lambda a, y, g, axis, interpret=False: real(
            torch.zeros_like(a), y, g, axis, interpret)
    if kind == "da dropped":
        def da_dropped(a, y, g, axis, interpret=False):
            da, ds = real(a, y, g, axis, interpret)
            return torch.zeros_like(da), ds
        return da_dropped

    def unshifted(a, y, g, axis, interpret=False):
        lam = ps.chunk_scan_state_kernel(a, g, axis, interpret, reverse=True)
        return ps._prev_product(lam, y, axis % y.ndim, a.ndim), lam
    return unshifted


def carrying_grads(smoke, arch, modes=("interpret", "ref")):
    """Phase L's gradient check at a reduced config: 4 chunks of 16,
    carrying decays; the grads per mode and the forward scans' decays."""
    _, cfg = cfgs(arch)
    tp = tparams.init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    smoke.carrying_decays(tp, cfg.ssm_chunk, 9)
    batch = batch_np(cfg, 8, s=4 * cfg.ssm_chunk)
    decays, grads = [], {}
    real = ps.chunk_scan_state_kernel

    def spy(a, states, axis=1, interpret=False, reverse=False):
        if not reverse:
            decays.append(a.detach().flatten())
        return real(a, states, axis, interpret, reverse)

    ps.chunk_scan_state_kernel = spy
    try:
        for mode in modes:
            with isa.use(mode):
                grads[mode], _ = port_grads(cfg, tp, batch)
    finally:
        ps.chunk_scan_state_kernel = real
    return grads, torch.cat(decays)


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b"])
def test_smoke_carrying_decays_make_the_scans_carry(smoke, arch):
    # under carrying_decays the chunks' decays spread over (0, 1), and
    # the plain walks' gradients stay within phase L's bound of ref's
    grads, decays = carrying_grads(smoke, arch)
    assert float(decays.median()) > 0.05 and float(decays.max()) < 1.0
    ratios = smoke.grad_ratios(grads["interpret"], grads["ref"])
    assert max(ratios.values()) <= smoke.TRAIN_GRAD_REL, ratios


@pytest.mark.parametrize("kind", ["carry dropped", "da dropped",
                                  "unshifted decay"])
def test_smoke_train_grad_hold_rejects_a_broken_ssd_backward(
        smoke, monkeypatch, kind):
    monkeypatch.setattr(ps, "state_scan_grad", ssd_broken(kind))
    grads, _ = carrying_grads(smoke, "mamba2_1p3b")
    ratios = smoke.grad_ratios(grads["interpret"], grads["ref"])
    assert max(ratios.values()) > 100 * smoke.TRAIN_GRAD_REL, ratios


# ---------------------------------------------------------------------------
# chip_smoke.py's phase N3 holds, on the CPU
# ---------------------------------------------------------------------------

def n3_steps(smoke, cfg, batches, grad_accum):
    """Two train steps from one init (step 0 at lr 0, step 1 at lr(1)),
    with each step's gradient as it enters the clip."""
    state = api.init_train_state(cfg, torch.Generator().manual_seed(4),
                                 "cpu")
    step = api.make_train_step(cfg, grad_accum=grad_accum)
    grads = []
    for b in batches:
        with smoke.Tap(api, "clip_by_global_norm",
                       lambda a, kw, o: a[0]) as tap:
            state, _ = step(state, b)
        grads.append(dict(tparams.tree_items(tap.calls[0])))
    return state["params"], grads


def test_smoke_n3_holds_pass_a_split_batch_and_reject_faults(smoke):
    """Phase N3's holds at Mamba2's reduced config in bf16, against the
    reference of the phase (the batch in two row blocks, their gradients
    summed in float32): the gradient of the whole batch at once, which
    differs from it in rounding alone at this size, passes both holds;
    a gradient of the wrong rows fails the gradient hold; params moved
    by the wrong rows' gradient fail the param hold against the right
    gradients; a NaN param fails."""
    _, cfg = cfgs("mamba2_1p3b")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              act_dtype="bfloat16")
    rng = np.random.default_rng(6)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                    .astype(np.int32))
                for k in ("tokens", "targets")} for _ in range(2)]
    wrong = [{k: torch.cat([v[:2], v[:2]]) for k, v in b.items()}
             for b in batches]
    ref_params, ref_grads = n3_steps(smoke, cfg, batches, 2)
    ref = {"params": dict(tparams.tree_items(ref_params)),
           "grads": ref_grads}
    gmax = [{p: float(g.abs().max()) for p, g in gs.items()}
            for gs in ref_grads]
    pspecs = {p: (None,) * g.ndim for p, g in ref_grads[0].items()}
    lr = float(api._optimizer(cfg).lr(1))
    assert lr > 0

    def holds(params, grads):
        ratios = [smoke.n3_grad_errors(g, rg, gm, pspecs, None, "cpu")[1]
                  for g, rg, gm in zip(grads, ref_grads, gmax)]
        grad_ok = all(v <= smoke.N3_GRAD_REL for r in ratios
                      for v in r.values())
        return grad_ok, smoke.n3_hold_params(params, grads, ref, pspecs,
                                             None, lr, "cpu")

    whole_params, whole_grads = n3_steps(smoke, cfg, batches, 1)
    grad_ok, held = holds(whole_params, whole_grads)
    assert grad_ok and held["params_finite"]
    assert held["params_outside_bound"] == 0
    assert held["params_held"] >= held["params_total"] / 2
    wrong_params, wrong_grads = n3_steps(smoke, cfg, wrong, 1)
    assert not holds(wrong_params, wrong_grads)[0]
    assert holds(wrong_params, whole_grads)[1]["params_outside_bound"] > 0
    whole_params["embed"].view(-1)[0] = float("nan")
    assert not holds(whole_params, whole_grads)[1]["params_finite"]

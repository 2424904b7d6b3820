"""The port's sharded training, its entry points on several ranks and the
scheduler's mesh lanes (gloo on the CPU), against the JAX package.

* The sharded train step on a (data 2, model 2) mesh of 4 ranks for
  reduced llama3_8b, mamba2_1p3b and kimi_k2_1t (EP over ``data``, each
  expert's FFN over ``model``; capacity factor 8, so no token is dropped,
  as in the reference's MoE test): the loss within rtol 2e-4 of the
  *unsharded* reference's ``loss_fn`` (the reference's own sharded train
  step fails on this tree under jax 0.9.0), and every gradient leaf,
  gathered from its shards, within 2e-4 of that leaf's max |g| (the
  two-layer tolerance of ``test_torch_train.py``).
* ``train.main --model-parallel 2`` for 4 steps on 4 ranks (a 2×2 mesh)
  with checkpoints, then a resume on 2 ranks (2×1) that prints
  ``resumed from step 4``; every step's loss within rtol 2e-4 of a world
  of one's on the same token file (``TokenFileData`` draws the global
  batch, then slices it, so every mesh sees the same rows). Kimi-K2 and
  ``--pod-sync-every`` run on the 2×2 mesh too (no ``pod`` axis: nothing
  to sync, as in the reference).
* ``serve.main --model-parallel 2`` on 2 ranks (a 1×2 mesh, the MoE's
  expert FFN split over ``model``) and on a 2×1 mesh (rows over
  ``data``): greedy tokens equal to a world of one's.
* ``sharded_program_call`` and ``Scheduler(mesh=, mesh_axis="parts")`` on
  2 ranks against the reference's on 2 fake devices: c0_add's results
  bit-exact, scale→add within the multiply-add bound ``4·eps·Σ|term|``
  (XLA contracts it into one FMA), the virtual-clock trace byte-identical;
  a wall-clock run (interpret mode: each rank's chunk is one
  ``call_batch``) returns each request's solo result bit for bit, and both
  ranks take the same decisions.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import torch_dist_cases as T
from repro import configs as jconfigs
from repro.core.stream import VMEM_BYTES
from repro.memhier import TPU_V5E
from repro.models import model as JM
from repro_torch.models import params as tparams
from test_torch_sched import port_hier

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.dirname(os.path.abspath(__file__))
EPS = float(np.finfo(np.float32).eps)
ARCHS = ("llama3_8b", "mamba2_1p3b", "kimi_k2_1t")
LOSS_RTOL, GRAD_TOL = 2e-4, 2e-4


def _cfgs(arch):
    over = {"capacity_factor": 8.0} if "kimi" in arch else {}
    from repro_torch import configs
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(configs.get_config(arch).reduced(), **over))


@pytest.fixture(scope="module")
def train_cases():
    out = []
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
                 for k in ("tokens", "targets")}
        out.append((arch, jcfg, cfg, jax.tree.map(np.asarray, jp), batch))
    return out


@pytest.fixture(scope="module")
def sharded_steps(train_cases):
    res = T.spawn(T.train_step_ranks, 4,
                  [(a, cfg, p, b) for a, _, cfg, p, b in train_cases])
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_the_unsharded_reference(
        arch, train_cases, sharded_steps):
    _, jcfg, cfg, params, batch = next(c for c in train_cases
                                       if c[0] == arch)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jax.tree.map(jax.numpy.asarray,
                                                   batch)),
        has_aux=True)(jax.tree.map(jax.numpy.asarray, params))
    for rank in sharded_steps:
        got = rank[arch]
        assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(
            float(jloss)), (got["loss"], float(jloss))
        assert np.isfinite(got["gnorm"]) and got["step"] == 1
        for path, g in tparams.tree_items(jax.tree.map(np.asarray, jgrads)):
            g = np.asarray(g, np.float32)
            scale = float(np.abs(g).max()) or 1.0
            err = float(np.abs(got["grads"][path] - g).max())
            assert err <= GRAD_TOL * scale, (path, err / scale)


def test_sharded_ranks_agree(sharded_steps):
    for arch in ARCHS:
        losses = {r[arch]["loss"] for r in sharded_steps}
        assert len(losses) == 1, losses


# ---------------------------------------------------------------------------
# train.main and serve.main on several ranks
# ---------------------------------------------------------------------------

def _losses(text):
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step")]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    data = str(d / "tokens.bin")
    np.random.default_rng(0).integers(0, 512, 20000).astype(
        np.int32).tofile(data)
    common = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
              "--log-every", "1", "--data", data, "--ckpt-every", "2"]
    four = T.spawn(T.train_main_ranks, 4, [
        ["--arch", "mamba2-1.3b", "--steps", "4", "--model-parallel", "2",
         "--ckpt-dir", str(d / "m"), *common],
        ["--arch", "kimi-k2-1t", "--steps", "2", "--model-parallel", "2",
         "--pod-sync-every", "1", "--ckpt-dir", str(d / "k"), *common]])
    two = T.spawn(T.train_main_ranks, 2, [
        ["--arch", "mamba2-1.3b", "--steps", "6", "--model-parallel", "1",
         "--ckpt-dir", str(d / "m"), *common]])
    one = T._main(__import__("repro_torch.launch.train",
                             fromlist=["main"]).main,
                  ["--arch", "mamba2-1.3b", "--steps", "6", *common[:-2]])
    return four, two, one


def test_train_main_on_a_2x2_mesh_then_resumes_on_2x1(train_runs):
    four, two, one = train_runs
    assert "mesh 2x2 axes ('data', 'model') (4 devices)" in four[0][0]
    assert "mesh 2x1" in two[0][0]
    assert "resumed from step 4" in two[0][0]
    want = _losses(one)
    assert len(want) == 6
    got = _losses(four[0][0]) + _losses(two[0][0])
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_preemption_on_a_mesh_saves_every_rank_at_the_step_end(tmp_path):
    """Rank 1 alone is signalled in the middle of step 2, while rank 0
    is in the step's collectives: the ranks agree on it after the step
    and save together, and the checkpoint is the one an uninterrupted
    run writes at step 2, bit for bit (no collective of the save was
    paired with one of the step's); the run goes on as before."""
    from repro_torch.checkpoint import load_checkpoint
    data = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 512, 20000).astype(
        np.int32).tofile(data)
    common = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--log-every", "1", "--data",
              data, "--steps", "4", "--model-parallel", "1"]
    plain, preempted = str(tmp_path / "plain"), str(tmp_path / "preempted")
    ranks = T.spawn(T.preempted_train_ranks, 2, [
        [*common, "--ckpt-dir", plain, "--ckpt-every", "2"],
        [*common, "--ckpt-dir", preempted, "--ckpt-every", "100"]], 1, 2)
    assert sorted(os.listdir(preempted)) == ["step_00000002",
                                             "step_00000004"]
    want, _ = load_checkpoint(plain, 2)
    got, manifest = load_checkpoint(preempted, 2)
    assert manifest["step"] == 2 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert len(_losses(ranks[0][0])) == 4          # rank 0 logs the steps
    assert _losses(ranks[0][1]) == _losses(ranks[0][0])
    for text_plain, text_preempted in ranks:
        assert text_preempted.split("done")[1] == text_plain.split("done")[1]


def _leaf_ratio(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def test_sharded_optimizer_update_matches_one_process():
    """AdamW (llama3_8b) and Adafactor (kimi_k2_1t) on the shards of a
    (2, 2) mesh against the same update on one process, from the same
    params, gradients and state: AdamW bit for bit (elementwise);
    Adafactor's means sum their shards' parts in another order, so its
    new params and state (float32 at the reduced size) are within 1e-5
    of each leaf's max."""
    from repro_torch.launch import api
    import ml_dtypes
    from repro_torch.models.params import init_params, tree_map
    cases, local = [], {}
    for arch in ("llama3_8b", "kimi_k2_1t"):
        _, cfg = _cfgs(arch)
        rng = np.random.default_rng(5)
        params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        grads = tree_map(lambda p: torch.from_numpy(rng.standard_normal(
            p.shape, dtype=np.float32)).to(p.dtype), params)
        opt = tree_map(lambda z: torch.from_numpy(np.abs(rng.standard_normal(
            z.shape, dtype=np.float32)) + 0.1),
            api._optimizer(cfg).init(params))
        step = torch.tensor(5, dtype=torch.int32)
        # a unit learning rate, so the new params are mostly the update
        optimizer = dataclasses.replace(api._optimizer(cfg), lr=1.0)
        with torch.no_grad():
            local[arch] = optimizer.update(grads, opt, params, step)
        to_np = lambda t: tree_map(  # noqa: E731   (bf16 as JAX's dtype)
            lambda x: x.float().numpy().astype(ml_dtypes.bfloat16)
            if x.dtype == torch.bfloat16 else x.numpy(), t)
        cases.append((arch, cfg, optimizer, {"params": to_np(params),
                                  "opt": to_np(opt)}, to_np(grads), 5))
    ranks = T.spawn(T.sharded_update_ranks, 4, cases)
    for arch in local:
        want_p, want_o = local[arch]
        adamw = arch == "llama3_8b"
        for rank in ranks:
            got = {k: dict(tparams.tree_items(v))
                   for k, v in rank[arch].items()}
            for path, w in tparams.tree_items(want_p):
                w = w.float().numpy()
                g = got["params"][path]
                if adamw:
                    np.testing.assert_array_equal(g, w)
                else:
                    assert _leaf_ratio(g, w) <= 1e-5, path
            for path, w in tparams.tree_items(want_o):
                w, g = w.float().numpy(), got["opt"][path]
                if adamw:
                    np.testing.assert_array_equal(g, w)
                else:
                    assert _leaf_ratio(g, w) <= 1e-5, path


def test_train_main_kimi_with_pod_sync_on_a_2x2_mesh(train_runs):
    four, _, _ = train_runs
    text = four[0][1]
    assert "mesh 2x2" in text and "done: final loss" in text
    assert all(np.isfinite(_losses(text)))
    assert len({f[1].split("done")[1] for f in four}) == 1   # ranks agree


def test_serve_main_model_parallel_matches_a_world_of_one():
    runs = [["--arch", "kimi-k2-1t", "--reduced", "--device", "cpu",
             "--model-parallel", "2", "--gen", "4", "--prompt-len", "16"],
            ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
             "--gen", "4", "--prompt-len", "16", "--sched"]]
    two = T.spawn(T.serve_main_ranks, 2, runs)
    one = T.serve_main_ranks(0, runs)          # the world of one
    for i in range(len(runs)):
        assert "mesh 1x1" in one[i][0]
        for rank in two:
            text, gen = rank[i]
            assert ("mesh 1x2" if i == 0 else "mesh 2x1") in text
            np.testing.assert_array_equal(gen, one[i][1])


def _shed(text: str) -> list:
    m = re.search(r"slo-shed: \d+ decode steps shed at admission: "
                  r"\[([\d, ]*)\]", text)
    return [] if m is None else [int(v) for v in m.group(1).split(",")]


def test_serve_main_refuses_slo_shed_on_several_ranks():
    """It no longer refuses: ``--slo-shed`` on 2 ranks sheds by rank 0's
    SLO monitor, its verdict broadcast each step, so both ranks shed the
    same steps (at least one: a 0.5 ms per-token target that every CPU
    step misses) and return the same tokens; a world of one sheds by its
    own monitor, as before."""
    runs = [["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
             "--gen", "8", "--prompt-len", "16", "--sched", "--slo-shed",
             "--slo-ms", "0.5"]]
    two = T.spawn(T.serve_main_ranks, 2, runs)
    (text0, gen0), (text1, gen1) = two[0][0], two[1][0]
    assert "mesh 2x1" in text0 and "mesh 2x1" in text1
    assert _shed(text0) and _shed(text0) == _shed(text1)
    np.testing.assert_array_equal(gen0, gen1)
    assert gen0.shape == (4, 8 - len(_shed(text0)))
    text, gen = T.serve_main_ranks(0, runs)[0]
    assert "mesh 1x1" in text and _shed(text)
    assert gen.shape == (4, 8 - len(_shed(text)))


# ---------------------------------------------------------------------------
# sharded scheduler lanes
# ---------------------------------------------------------------------------

JAX_SCHED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.kernels
import torch_dist_cases as T
from repro import sched as js
from repro.core import isa as jisa
from repro.memhier import TPU_V5E
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("parts",))
add, sa = jisa.fuse("c0_add"), jisa.fuse("c0_scale", "c0_add")
reqs = [tuple(jnp.asarray(a) for a in r) for r in T.sched_requests()]
out = {{"call": [np.asarray(o) for o in js.sharded_program_call(
    add, reqs, mesh)]}}
out["call_sa"] = [np.asarray(o) for o in js.sharded_program_call(
    sa, [(2.5,) + r for r in reqs], mesh)]
rec = js.TraceRecorder()
js.Scheduler(T.sched_queue(js, jisa.fuse, jnp.asarray),
             cost=js.CostModel(hierarchy=TPU_V5E), clock="virtual",
             mesh=mesh, mesh_axis="parts", recorder=rec).drain()
out["trace"] = rec.dumps()
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def sched_runs(tmp_path_factory):
    import pickle
    path = str(tmp_path_factory.mktemp("sched") / "ref.pkl")
    res = subprocess.run([sys.executable, "-c", JAX_SCHED.format(
        src=SRC, tests=TESTS, path=path)], capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    return ref, T.spawn(T.sched_ranks, 2, port_hier(TPU_V5E), VMEM_BYTES)


def test_sharded_program_call_matches_the_reference(sched_runs):
    ref, ranks = sched_runs
    reqs = T.sched_requests()
    for rank in ranks:
        assert len(rank["call"]) == len(reqs)
        for got, want in zip(rank["call"], ref["call"]):
            np.testing.assert_array_equal(got, want)
        for got, want, (x, b) in zip(rank["call_sa"], ref["call_sa"], reqs):
            bound = 4 * EPS * (np.abs(2.5 * x) + np.abs(b))
            assert np.all(np.abs(got - want) <= bound)


def test_mesh_scheduler_virtual_trace_is_the_references(sched_runs):
    ref, ranks = sched_runs
    for rank in ranks:
        assert rank["trace"] == ref["trace"]


def test_mesh_scheduler_wall_clock_results_and_decisions(sched_runs):
    _, ranks = sched_runs
    for rank in ranks:
        assert rank["n_lanes"] == 2
        for got, solo in zip(rank["wall"], rank["solo"]):
            np.testing.assert_array_equal(got, solo)
    assert ranks[0]["placements"] == ranks[1]["placements"]
    assert any(p[4] for p in ranks[0]["placements"])     # one coalesced batch

"""repro_torch.distributed on several ranks (gloo on the CPU) against the
JAX package on fake CPU devices.

The JAX reference runs once, in a subprocess with 8 fake devices (as
``tests/test_distributed.py`` runs it): the compressed ring on 4
devices, GPipe on 4 stages and the MoE's ``_moe_sharded`` (EP and TP) on
a (4, 2) mesh. The port's side runs in two spawns (``torch_dist_cases``):
4 ranks for the ring, GPipe, pod sync, the batch rows, elastic
checkpoints and the sharded init, and 8 ranks, a (data 4, model 2) mesh,
for the MoE. Held:

* the ring: every rank bit-exact against ``ring_allreduce_plain`` (its
  one-process replay); within 1e-5·absmax of the reference's jitted ring
  (3.8e-6 here: XLA's fused loop rounds elsewhere, in the last bits of
  ~22 000 of the 65 536 values); one int8 rounding flip — a whole
  quantisation step, ~0.13 at these inputs — exceeds that bound, and
  the test says so (with the same law at generator seed 7, three values
  flip); within 8/127 of the exact sum (the reference test's bound);
* GPipe: the last stage's outputs against the reference's and the
  sequential product, rtol and atol 1e-5; each stage runs its body on its
  M active ticks only;
* MoE EP and TP: against the reference's ``_moe_sharded`` and the port's
  ``_moe_dense``, rtol and atol 2e-3 (the reference test's); the input
  gradient through the all_to_alls and the all-reduce against the dense
  oracle's (summed over the ``model`` peers, whose partial sums the
  all-reduce's backward carries);
* pod sync averages diverging pods; the batch's rows follow the data
  coordinate; a checkpoint saved on (4,) restores on (2, 2), on a world
  of one and in the reference, exactly; DTensor placements give the
  logical array back; every rank's init shard is the world of one's.
* A rank that raises fails the spawn; a mesh that is not the world's
  size raises on every rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_cases as T
from repro_torch.checkpoint import restore_sharded
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models import params as tparams

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.dirname(os.path.abspath(__file__))

JAX_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
import torch_dist_cases as T
from repro.configs import get_config
from repro.distributed.collectives import compressed_ring_allreduce
from repro.distributed.pipeline import gpipe_forward
from repro.distributed.sharding import shard_map
from repro.models import moe
from repro.models.params import init_params
import dataclasses
out = {{}}
devs = jax.devices()
mesh = jax.sharding.Mesh(np.array(devs[:4]), ("d",))
x = jnp.asarray(T.ring_inputs())
out["ring"] = np.asarray(jax.jit(shard_map(
    lambda xl: compressed_ring_allreduce(xl[0], "d")[None], mesh,
    in_specs=P("d"), out_specs=P("d"), check_vma=False))(x))
w, mbs = T.gpipe_inputs()
smesh = jax.sharding.Mesh(np.array(devs[:4]), ("stage",))
def run(w_all, mbs):
    o = gpipe_forward(lambda wl, xx: jnp.tanh(xx @ wl[0]), w_all, mbs,
                      "stage", 4)
    return jax.lax.psum(o, "stage")
out["gpipe"] = np.asarray(jax.jit(shard_map(
    run, smesh, in_specs=(P("stage"), P()), out_specs=P(),
    check_vma=False))(jnp.asarray(w), jnp.asarray(mbs)))
cfg = dataclasses.replace(get_config("kimi_k2_1t").reduced(), n_experts=8,
                          top_k=2, capacity_factor=8.0)
mmesh = jax.make_mesh((4, 2), ("data", "model"))
rng = jax.random.PRNGKey(0)
p = jax.tree.map(lambda a: a[0], init_params(cfg, rng)["layers"]["moe"])
xm = jax.random.normal(rng, (4, 8, cfg.d_model), jnp.float32)
for k, v in p.items():
    out["p_" + k] = np.asarray(v)
out["x"] = np.asarray(xm)
out["dense"] = np.asarray(moe._moe_dense(cfg, p, xm)[0])
with mmesh:
    for name, ep in (("ep", True), ("tp", False)):
        out[name] = np.asarray(jax.jit(lambda xx: moe._moe_sharded(
            cfg, p, xx, mmesh, use_ep=ep))(xm)[0])
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jref") / "ref.npz")
    res = subprocess.run([sys.executable, "-c", JAX_REFERENCE.format(
        src=SRC, tests=TESTS, path=path)], capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def four(ckpt_dir):
    return T.spawn(T.four_ranks, 4, ckpt_dir)


@pytest.fixture(scope="module")
def moe8(jref):
    p = {k[2:]: v for k, v in jref.items() if k.startswith("p_")}
    return T.spawn(T.moe_ranks, 8, p, jref["x"])


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_ring_is_bit_exact_against_its_plain_replay(four):
    plain = C.ring_allreduce_plain(torch.from_numpy(T.ring_inputs()))
    for r in range(4):
        np.testing.assert_array_equal(four[r]["ring"], plain[r].numpy())


def test_ring_owner_keeps_unquantised_bits(four):
    """As in the reference: the ranks end with slightly different bits
    (each keeps its own chunk's unquantised sum)."""
    assert any(not np.array_equal(four[0]["ring"], four[r]["ring"])
               for r in range(1, 4))


def test_ring_matches_the_reference_ring(four, jref):
    want = jref["ring"]
    scale = float(np.abs(want).max())
    for r in range(4):
        err = float(np.abs(four[r]["ring"] - want[r]).max())
        assert err <= 1e-5 * scale, (
            f"rank {r}: {err} > 1e-5·absmax ({1e-5 * scale}); an int8 "
            f"rounding flipped between the port and XLA's fused ring")


def test_ring_is_within_the_int8_bound_of_the_sum(four):
    want = T.ring_inputs().sum(0)
    for r in range(4):
        err = float(np.abs(four[r]["ring"] - want).max())
        assert err / float(np.abs(want).max()) < 8 / 127


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def test_gpipe_matches_the_reference_and_the_sequential_product(four, jref):
    w, mbs = T.gpipe_inputs()
    want = mbs
    for s in range(4):
        want = np.tanh(want @ w[s])
    got = four[3]["gpipe"]
    np.testing.assert_allclose(got, jref["gpipe"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for r in range(3):                   # valid on the last stage only
        assert not np.any(four[r]["gpipe"])


def test_gpipe_stages_skip_their_bubble_ticks(four):
    assert [four[r]["gpipe_ticks"] for r in range(4)] == [6] * 4


# ---------------------------------------------------------------------------
# pod sync, batch rows, checkpoints, DTensor, init
# ---------------------------------------------------------------------------

def test_pod_sync_averages_the_pods(four):
    for r in range(4):
        np.testing.assert_allclose(four[r]["pod_sync"]["w"], 1.5, rtol=1e-2)
        np.testing.assert_allclose(four[r]["pod_sync"]["b"], 2.0, rtol=1e-2)
        assert four[r]["no_pod"]


def test_batch_rows_follow_the_data_coordinate(four):
    by = {(f["coords"]["data"], f["coords"]["model"]): f["batch"]
          for f in four}
    for d in (0, 1):
        np.testing.assert_array_equal(by[(d, 0)], by[(d, 1)])
        assert by[(d, 0)].shape == (4, 16)
    assert not np.array_equal(by[(0, 0)], by[(1, 0)])


def test_checkpoint_restores_on_another_mesh(four):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for f in four:
        d, m = f["coords"]["data"], f["coords"]["model"]
        np.testing.assert_array_equal(f["restored"]["w"],
                                      w[4 * d:4 * d + 4, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(f["restored"]["b"],
                                      np.arange(8)[4 * d:4 * d + 4])
        assert f["restored_step"] == 5
        np.testing.assert_array_equal(f["dtensor_full"], w)


def test_sharded_checkpoint_restores_on_one_rank_and_in_the_reference(
        four, ckpt_dir):
    tmpl = {"w": ((8, 8), torch.float32), "b": ((8,), torch.bfloat16)}
    specs = {"w": (None, None), "b": (None,)}
    got, man = restore_sharded(ckpt_dir, tmpl, specs,
                               Mesh((1, 1), ("data", "model")), "cpu")
    assert man["step"] == 5
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(64).reshape(8, 8))
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].float().numpy(), np.arange(8))
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import load_checkpoint
    jt = {"w": jax.ShapeDtypeStruct((8, 8), jnp.float32),
          "b": jax.ShapeDtypeStruct((8,), jnp.bfloat16)}
    tree, man = load_checkpoint(ckpt_dir, template=jt)
    assert man["step"] == 5
    np.testing.assert_array_equal(np.asarray(tree["w"]),
                                  np.arange(64).reshape(8, 8))
    np.testing.assert_array_equal(np.asarray(tree["b"], np.float32),
                                  np.arange(8))


def test_every_ranks_init_shard_is_the_world_of_ones(four):
    from repro_torch.configs import get_config
    cfg = get_config("kimi_k2_1t").reduced()
    whole = tparams.init_params(cfg, torch.Generator().manual_seed(11),
                                "cpu")
    specs = dict(tparams.tree_items(four[0]["init_specs"]))
    for f in four:
        m = _coord_mesh(f["coords"])
        mine = dict(tparams.tree_items(f["init"]))
        for path, leaf in tparams.tree_items(whole):
            want = sharding.local_shard(leaf, specs[path], m)
            np.testing.assert_array_equal(mine[path], want.float().numpy(),
                                          err_msg=path)


def _coord_mesh(coords):
    return T.CoordMesh((2, 2), ("data", "model"),
                       coords["data"] * 2 + coords["model"])


# ---------------------------------------------------------------------------
# MoE expert and tensor parallel
# ---------------------------------------------------------------------------

def _rows(moe8, name):
    by_data = {}
    for f in moe8:
        by_data.setdefault(f["coords"]["data"], []).append(f[name])
    return by_data


@pytest.mark.parametrize("name", ("ep", "tp"))
def test_moe_matches_the_reference_and_the_dense_oracle(moe8, jref, name):
    by = _rows(moe8, name)
    for outs in by.values():             # model peers agree
        np.testing.assert_array_equal(outs[0], outs[1])
    got = np.concatenate([by[d][0] for d in sorted(by)])
    np.testing.assert_allclose(got, jref[name], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, jref["dense"], rtol=2e-3, atol=2e-3)
    cfg = T.moe_cfg()
    p = {k[2:]: torch.from_numpy(v) for k, v in jref.items()
         if k.startswith("p_")}
    dense, _ = moe._moe_dense(cfg, p, torch.from_numpy(jref["x"]))
    np.testing.assert_allclose(got, dense.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ("ep", "tp"))
def test_moe_input_gradient_matches_the_dense_oracle(moe8, jref, name):
    cfg = T.moe_cfg()
    p = {k[2:]: torch.from_numpy(v) for k, v in jref.items()
         if k.startswith("p_")}
    x = torch.from_numpy(jref["x"]).requires_grad_()
    y, _ = moe._moe_dense(cfg, p, x)
    (dx,) = torch.autograd.grad(y.square().sum(), x)
    by = _rows(moe8, name + "_dx")
    got = np.concatenate([(by[d][0] + by[d][1]) / 2 for d in sorted(by)])
    np.testing.assert_allclose(got, dx.numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# failures surface
# ---------------------------------------------------------------------------

def test_a_failing_rank_fails_the_spawn():
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException,
                       match="rank 1 fails|closed by peer"):
        T.spawn(T.failing_rank, 2)


def test_a_mesh_not_of_the_worlds_size_raises_on_every_rank():
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="the world 2"):
        T.spawn(T.mesh_of_three, 2)

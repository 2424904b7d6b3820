"""repro_torch.distributed's rules, quantisation and shards against the JAX
package, in one process (no ranks spawned).

* For every arch in ``configs`` (published widths) × its params, optimizer
  state, batch (train, prefill, decode) and decode-cache trees × the
  meshes (16, 16), (2, 16, 16), (4, 2), (8, 1) and (2, 1), the port's
  spec equals the reference's ``PartitionSpec`` entry for entry. The JAX
  side needs no devices: ``shard_fit`` reads only ``axis_names`` and
  ``devices.shape``, so a duck-typed mesh stands in. ``build_cell``'s
  spec trees (train, prefill, decode) are held the same way, with the
  reference's ``logical_sharding`` made to return the spec.
* ``quantize_blockwise``, ``dequantize_blockwise`` and
  ``ErrorFeedback.apply`` are bit-exact against the reference (run
  eagerly); the twin of ``test_error_feedback_reduces_bias``.
* The sharded init: every rank's shard, drawn alone, is the same block of
  the world of one's params (a stand-in mesh gives each coordinate).
* The mesh factories refuse a mesh that is not the world's size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import collectives as jcol
from repro.distributed import pipeline as jpipe
from repro.distributed import sharding as jsharding
from repro.launch import api as japi
from repro.models import model as JM
from repro.models import params as jparams
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.distributed import collectives as C
from repro_torch.distributed import pipeline
from repro_torch.distributed import sharding
from repro_torch.launch import api
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as M
from repro_torch.models import params as tparams
from torch_dist_cases import CoordMesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model"))}


class DuckMesh:
    """What the reference's ``shard_fit`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)
        self.shape = dict(zip(names, shape))


def jspec_tree(ax, ab, mesh, rules=None):
    return jax.tree.map(
        lambda names, sds: tuple(jsharding.logical_spec(
            names, sds.shape, mesh, rules)),
        ax, ab, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def trees(arch, kind):
    """(reference logical tree, reference abstract tree, port logical
    tree, port abstract tree) of one of an arch's trees."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    if kind == "params":
        return (jparams.logical_axes(jcfg), jparams.abstract_params(jcfg),
                tparams.logical_axes(cfg), tparams.abstract_params(cfg))
    if kind == "opt":
        return (japi.train_state_logical(jcfg)["opt"],
                japi.make_train_state_abstract(jcfg)["opt"],
                api.train_state_logical(cfg)["opt"],
                api.make_train_state_abstract(cfg)["opt"])
    if kind == "cache":
        shp = SHAPES["decode_32k"]
        return (JM.cache_logical_axes(jcfg),
                JM.abstract_cache(jcfg, shp.global_batch, shp.seq_len),
                M.cache_logical_axes(cfg),
                M.abstract_cache(cfg, shp.global_batch, shp.seq_len))
    shp, jshp = SHAPES[kind], JSHAPES[kind]
    return (japi.batch_logical(jcfg, jshp), japi.batch_abstract(jcfg, jshp),
            api.batch_logical(cfg, shp), api.batch_abstract(cfg, shp))


KINDS = ("params", "opt", "cache", "train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_specs_equal_the_reference(arch, mesh, kind):
    shape, names = MESHES[mesh]
    jax_, jab, tax, tab = trees(arch, kind)
    assert flat(tax) == flat(jax.tree.map(
        lambda x: x, jax_, is_leaf=lambda x: isinstance(x, tuple)))
    want = flat(jspec_tree(jax_, jab, DuckMesh(shape, names)))
    got = flat(sharding.tree_specs(tax, tab, tmesh.AbstractMesh(shape,
                                                                 names)))
    assert got == want


def _jcell_specs(monkeypatch, jcfg, jshp, mesh):
    """The reference's build_cell with spec trees in place of
    NamedShardings (its ``logical_sharding`` returns the spec)."""
    monkeypatch.setattr(jsharding, "logical_sharding",
                        lambda names, shape, m, rules=None: tuple(
                            jsharding.logical_spec(names, shape, m, rules)))
    _, _, in_sh, out_sh, donate = japi.build_cell(jcfg, jshp, mesh)
    return in_sh, out_sh, donate


@pytest.mark.parametrize("kind", ("train_4k", "prefill_32k", "decode_32k"))
@pytest.mark.parametrize("mesh", ("16x16", "2x16x16", "4x2"))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_build_cell_specs_equal_the_reference(arch, mesh, kind,
                                              monkeypatch):
    shape, names = MESHES[mesh]
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jin, jout, jdonate = _jcell_specs(monkeypatch, jcfg, JSHAPES[kind],
                                      DuckMesh(shape, names))
    fn, args, tin, tout, donate = api.build_cell(
        cfg, SHAPES[kind], tmesh.AbstractMesh(shape, names))
    assert donate == jdonate
    assert len(tin) == len(jin) and len(tout) == len(jout)
    for got, want in zip(tin + tout, jin + jout):
        if want is None:
            assert got is None
        else:
            assert flat(got) == flat(want)
    # the abstract args are meta tensors of the reference's shapes
    for a, spec_tree in zip(args, tin):
        for t, sp in zip(flat(a).values(), flat(spec_tree).values()):
            assert t.device.type == "meta" and len(sp) == t.ndim
    assert callable(fn)


def test_rules_are_the_reference_rules():
    assert sharding.DEFAULT_RULES == {k: list(v) for k, v in
                                      jsharding.DEFAULT_RULES.items()}
    for over in ({}, {"fsdp": False}, {"fsdp": False, "zero2": True}):
        jcfg = dataclasses.replace(jconfigs.get_config("llama3_8b"), **over)
        cfg = dataclasses.replace(configs.get_config("llama3_8b"), **over)
        assert api._rules(cfg) == japi._rules(jcfg)


def test_shard_fit_falls_back_as_the_reference():
    m, dm = tmesh.AbstractMesh((2, 4), ("data", "model")), \
        DuckMesh((2, 4), ("data", "model"))
    for size in (1, 2, 3, 4, 6, 8, 12):
        for cands in ([("pod", "data"), ("data",), None], [("model",), None],
                      [("data", "model"), None]):
            for used in (set(), {"data"}, {"model"}):
                assert sharding.shard_fit(size, cands, m, used) == \
                    jsharding.shard_fit(size, cands, dm, used)
    with pytest.raises(KeyError, match="no sharding rule"):
        sharding.logical_spec(("nope",), (4,), m)
    with pytest.raises(ValueError, match="rank"):
        sharding.logical_spec(("embed",), (4, 4), m)


def test_placements_name_the_sharded_dims():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert sharding.placements((None, "data", "model"), m) == [
        Replicate(), Shard(1), Shard(2)]
    assert sharding.placements((("pod", "data"), None), m) == [
        Shard(0), Shard(0), Replicate()]
    assert sharding.placements((), m) == [Replicate()] * 3


# ---------------------------------------------------------------------------
# quantisation and error feedback
# ---------------------------------------------------------------------------

def _q_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    halves = (np.arange(1024, dtype=np.float32) - 512) / 2   # exact .5 ties
    zeros = np.zeros(512, np.float32)
    mixed = np.concatenate([zeros[:256], 1e-30 * x[:256],
                            1e6 * x[256:512]]).astype(np.float32)
    return {"normal": 3 * x, "halves": halves, "zeros": zeros,
            "mixed": mixed}


@pytest.mark.parametrize("case", sorted(_q_inputs()))
@pytest.mark.parametrize("qblock", (256, 128))
def test_quantize_blockwise_is_bit_exact(case, qblock):
    x = _q_inputs()[case]
    jq, js = jcol.quantize_blockwise(jnp.asarray(x), qblock)
    tq, ts = C.quantize_blockwise(torch.from_numpy(x), qblock)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jcol.dequantize_blockwise(jq, js)
    td = C.dequantize_blockwise(tq, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jp, jn = jcol._pad_to(jnp.asarray(x[:1000]), qblock)
    tp, tn = C._pad_to(torch.from_numpy(x[:1000]), qblock)
    assert tn == jn
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_quantize_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="divisible"):
        C.quantize_blockwise(torch.zeros(100))
    with pytest.raises(ValueError, match="divisible"):
        C.quantize_blockwise(torch.zeros(2, 256))


def test_error_feedback_apply_is_bit_exact():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((7, 50)).astype(np.float32) * 1e-3,
         "b": {"c": rng.standard_normal(300).astype(np.float32)}}
    jef = jcol.ErrorFeedback.init(jax.tree.map(jnp.asarray, g))
    tef = C.ErrorFeedback.init(tparams.tree_map(torch.from_numpy, g))
    for _ in range(5):
        js_, jef = jef.apply(jax.tree.map(jnp.asarray, g), lambda x: x)
        ts_, tef = tef.apply(tparams.tree_map(torch.from_numpy, g),
                             lambda x: x)
        for (pa, a), (pb, b) in zip(tparams.tree_items(ts_),
                                    tparams.tree_items(
                                        jax.tree.map(np.asarray, js_))):
            np.testing.assert_array_equal(a.numpy(), b)
        for (_, a), (_, b) in zip(tparams.tree_items(tef.residual),
                                  tparams.tree_items(jax.tree.map(
                                      np.asarray, jef.residual))):
            np.testing.assert_array_equal(a.numpy(), b)


def test_error_feedback_reduces_bias():
    """Twin of tests/test_distributed.py's: an identical tiny gradient
    every step; error feedback recovers its mean, plain quantisation
    does not."""
    g_true = torch.from_numpy(np.random.default_rng(1).standard_normal(
        512).astype(np.float32)) * 1e-3

    def lossy(g):
        q, s = C.quantize_blockwise(C._pad_to(g, 256)[0])
        return C.dequantize_blockwise(q, s)[:g.numel()]
    ef = C.ErrorFeedback.init({"g": g_true})
    acc_ef = torch.zeros_like(g_true)
    acc_naive = torch.zeros_like(g_true)
    for _ in range(64):
        sent, ef = ef.apply({"g": g_true}, lambda x: x)
        acc_ef = acc_ef + sent["g"]
        acc_naive = acc_naive + lossy(g_true)
    err_ef = float(torch.mean(torch.abs(acc_ef / 64 - g_true)))
    err_naive = float(torch.mean(torch.abs(acc_naive / 64 - g_true)))
    assert err_ef < err_naive * 0.5 or err_naive == 0.0, (err_ef, err_naive)


def test_ring_plain_of_one_rank_is_the_input():
    x = torch.randn(1, 1000)
    assert torch.equal(C.ring_allreduce_plain(x), x)


@pytest.mark.parametrize("n", (2, 3, 4))
def test_ring_plain_is_within_the_int8_bound_of_the_sum(n):
    x = torch.from_numpy(3 * np.random.default_rng(n).standard_normal(
        (n, 5000)).astype(np.float32))
    out = C.ring_allreduce_plain(x)
    want = x.sum(0)
    for r in range(n):
        assert float((out[r] - want).abs().max()) < 8 / 127 * float(
            want.abs().max())


def test_bubble_fraction_is_the_reference():
    for s, m in ((4, 8), (2, 6), (8, 1)):
        assert pipeline.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)


# ---------------------------------------------------------------------------
# shards without ranks: a stand-in mesh for each coordinate
# ---------------------------------------------------------------------------

def _assemble(shards, spec, meshes):
    """The logical array from every rank's shard."""
    full = None
    for shard, m in zip(shards, meshes):
        if full is None:
            shape = tuple(s * m.axis_size(sharding.spec_axes(e)) for s, e in
                          zip(shard.shape, spec))
            full = torch.empty(shape, dtype=shard.dtype)
        sharding.local_shard(full, spec, m).copy_(shard)
    return full


@pytest.mark.parametrize("mesh", ("4x2", "2x1", "8x1"))
@pytest.mark.parametrize("arch", ("kimi_k2_1t", "mamba2_1p3b", "hymba_1p5b",
                                  "grok1_314b"))
def test_sharded_init_is_the_world_of_ones(arch, mesh):
    cfg = configs.get_config(arch).reduced()
    shape, names = MESHES[mesh]
    meshes = [CoordMesh(shape, names, r) for r in range(int(np.prod(shape)))]
    specs = sharding.tree_specs(tparams.logical_axes(cfg),
                                tparams.abstract_params(cfg), meshes[0])
    gen = torch.Generator().manual_seed(21)
    whole = tparams.init_params(cfg, gen, "cpu")
    parts = [tparams.init_params(cfg, gen, "cpu", m, specs) for m in meshes]
    for path, leaf in tparams.tree_items(whole):
        spec = dict(tparams.tree_items(specs))[path]
        got = _assemble([dict(tparams.tree_items(p))[path] for p in parts],
                        spec, meshes)
        assert torch.equal(got, leaf), path


def test_init_blocks_are_seeded_per_leaf_and_block():
    cfg = configs.get_config("mamba2_1p3b").reduced()
    a = tparams.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    b = tparams.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    c = tparams.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    for (p, x), (_, y), (_, z) in zip(tparams.tree_items(a),
                                      tparams.tree_items(b),
                                      tparams.tree_items(c)):
        assert torch.equal(x, y), p
        if x.std() > 0:
            assert not torch.equal(x, z), p
    # two layers of one leaf are drawn from different blocks
    w = a["layers"]["ssm"]["w_x"]
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.float().std()) - cfg.d_model ** -0.5) < 0.01


def test_shard_from_numpy_keeps_each_ranks_block():
    cfg = configs.get_config("llama3_8b").reduced()
    whole = tparams.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tree = tparams.tree_map(lambda t: t.numpy(), whole)
    meshes = [CoordMesh((2, 2), ("data", "model"), r) for r in range(4)]
    specs = sharding.tree_specs(tparams.logical_axes(cfg),
                                tparams.abstract_params(cfg), meshes[0])
    parts = [tparams.shard_from_numpy(tree, specs, m, "cpu") for m in meshes]
    for path, leaf in tparams.tree_items(whole):
        spec = dict(tparams.tree_items(specs))[path]
        got = _assemble([dict(tparams.tree_items(p))[path] for p in parts],
                        spec, meshes)
        assert torch.equal(got, leaf), path


def test_logical_trees_are_the_reference_trees():
    for arch in configs.ARCHS:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        is_t = lambda x: isinstance(x, tuple)  # noqa: E731
        assert flat(tparams.logical_axes(cfg)) == flat(jax.tree.map(
            lambda x: x, jparams.logical_axes(jcfg), is_leaf=is_t))
        assert flat(M.cache_logical_axes(cfg)) == flat(
            JM.cache_logical_axes(jcfg))
        assert flat(api.train_state_logical(cfg)) == flat(jax.tree.map(
            lambda x: x, japi.train_state_logical(jcfg), is_leaf=is_t))
        ab = JM.abstract_cache(jcfg, 2, 64)
        assert flat(tparams.tree_map(lambda leaf: leaf[0],
                                     M.abstract_cache(cfg, 2, 64))) == flat(
            jax.tree.map(lambda s: tuple(s.shape), ab))


# ---------------------------------------------------------------------------
# meshes on a world of one
# ---------------------------------------------------------------------------

def test_elastic_mesh_on_a_world_of_one_is_trivial():
    m = tmesh.make_elastic_mesh(model_parallel=16)
    assert (m.devices_shape, m.axis_names, m.size) == ((1, 1),
                                                       ("data", "model"), 1)
    assert tmesh.mesh_name(m) == "1x1"
    assert m.group("data") is None and m.group(("data", "model")) is None
    assert m.axis_index(("data", "model")) == 0


def test_a_mesh_not_of_the_worlds_size_raises():
    with pytest.raises(ValueError, match="the world 1"):
        tmesh.make_elastic_mesh(n_devices=2)
    with pytest.raises(ValueError, match="the world 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="the world 1"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="the world 1"):
        tmesh.Mesh((2, 1), ("data", "model"))


def test_mesh_names_are_the_references():
    for shape, names in MESHES.values():
        assert tmesh.mesh_name(tmesh.AbstractMesh(shape, names)) == \
            "x".join(map(str, shape))

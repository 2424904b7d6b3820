"""The dense layers' compute split over ``model`` (tensor and sequence
parallelism) on gloo ranks on the CPU, against the JAX package's
*unsharded* calls (its own sharded drivers fail on this tree under
jax 0.9.0; ROADMAP "Reference caveats").

Meshes (data, model): (1, 2), (2, 2) and (1, 4); configs, all reduced
(two layers, float32): Llama-3-8B (dense, SwiGLU; on (1, 4) its 2 KV
heads are fewer than the ranks), Kimi-K2 (MoE + attention, capacity
factor 8 so no token is dropped), Mamba2 (tied vocabulary of 500,
padded to 512), Hymba (attention and SSM heads, sliding window), a
dense config with 3 query heads (whole on every model peer) and one
without SP (``sp=False``; an untied vocabulary of 300 padded to 512, so
on 4 ranks the last block is all padding). Every case runs ``loss_fn``
and its gradient (reduced, gathered), ``prefill`` and ``grow_cache`` +
two ``decode_step``s, each rank on its shards (the JAX package's numpy
params carried with ``params_from_numpy``) and its rows.

Tolerances (float32), each of the reference's max |value| over the
compared tensor, and each *beyond the port's own one-process distance
from the reference* on the same case: forward — the loss (the mean of
the data ranks' losses), prefill's and decode's logits — within 1e-5;
each gradient leaf within 1e-4 of its max |g|. The one-process port is
already that far from the reference in places (the reduced models at
their random init amplify a last-bit difference about 10× a layer:
3-head prefill logits 1.0e-5 of their max, gradients up to 1e-4 of
max |g| at two layers, ``test_torch_train.py``), so the split is held
to adding no more than the stated tolerance to it, and to staying
within it of the one-process port.

Also: every model peer sees only its blocks (attention's ``wq``, the
SSM's heads, the MLP's columns, the unembedding's vocabulary block) and
K4 scans the rank's SSM heads; K4's plain walk (``interpret``) on the
rank's heads agrees with the oracle; the SSM's gated norm sums its
squares over the peers (values and gradients); the vocabulary-split
cross-entropy with a padded vocabulary equals the whole one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.kernels  # noqa: F401 — registers the JAX ISA
import torch_dist_cases as T
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs
from repro_torch.models import params as tparams

MESHES = ((1, 2), (2, 2), (1, 4))
FWD_TOL = 1e-5                  # of the reference's max |value|
GRAD_TOL = 1e-4                 # of each leaf's max |g|
B, S = 4, 32

CASES = {   # name: (arch, overrides)
    "llama": ("llama3_8b", {}),
    "kimi": ("kimi_k2_1t", {"capacity_factor": 8.0}),
    "mamba2": ("mamba2_1p3b", {"vocab": 500}),
    "hymba": ("hymba_1p5b", {}),
    "heads3": ("llama3_8b", {"n_heads": 3, "n_kv_heads": 1}),
    "nosp": ("qwen3_14b", {"sp": False, "vocab": 300}),
}


def _cfgs(name):
    arch, over = CASES[name]
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(configs.get_config(arch).reduced(), **over))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, name in enumerate(CASES):
        jcfg, cfg = _cfgs(name)
        jp = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(11 + i)))
        rng = np.random.default_rng(11 + i)
        batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                 for k in ("tokens", "targets")}
        out[name] = (jcfg, cfg, jp, batch)
    return out


@pytest.fixture(scope="module")
def reference(cases):
    """The JAX package's unsharded loss, gradient, prefill and decode."""
    out = {}
    for name, (jcfg, _, jp, batch) in cases.items():
        jb = jax.tree.map(jnp.asarray, batch)
        jpj = jax.tree.map(jnp.asarray, jp)
        (loss, _), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(jpj)
        logits, cache = JM.prefill(jcfg, jpj, {"tokens": jb["tokens"]})
        cache = JM.grow_cache(jcfg, cache, S, S + 2)
        dec = []
        for i in range(2):
            lg, cache = JM.decode_step(jcfg, jpj, cache,
                                       jb["targets"][:, i:i + 1],
                                       jnp.int32(S + i))
            dec.append(np.asarray(lg))
        out[name] = {"loss": float(loss), "prefill": np.asarray(logits),
                     "decode": dec, "grads": dict(tparams.tree_items(
                         jax.tree.map(np.asarray, grads)))}
    return out


@pytest.fixture(scope="module")
def one_process(cases):
    """The port's own unsharded calls on the same cases (no mesh)."""
    import torch
    from repro_torch.launch import api
    from repro_torch.models import model as M
    out = {}
    for name, (_, cfg, jp, batch) in cases.items():
        p = tparams.params_from_numpy(cfg, jp, "cpu")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        grads, metrics = api.make_grad_fn(cfg)(p, tb)
        with torch.no_grad():
            logits, cache = M.prefill(cfg, p, {"tokens": tb["tokens"]})
            res = {"loss": float(metrics["loss"]),
                   "prefill": logits.numpy(), "decode": [],
                   "grads": {k: g.numpy() for k, g in
                             tparams.tree_items(grads)}}
            cache = M.grow_cache(cfg, cache, S, S + 2)
            for i in range(2):
                logits, cache = M.decode_step(
                    cfg, p, cache, tb["targets"][:, i:i + 1], S + i)
                res["decode"].append(logits.numpy())
        out[name] = res
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    """Every mesh's ranks, all cases in one spawn a mesh."""
    run = [(name, cfg, jp, batch) for name, (_, cfg, jp, batch)
           in cases.items()]
    return {shape: T.spawn(T.tp_ranks, shape[0] * shape[1], shape, run,
                           shape == (1, 2))
            for shape in MESHES}


def _rows(shape, rank) -> slice:
    per = B // shape[0]
    d = rank["coords"]["data"]
    return slice(d * per, (d + 1) * per)


def _close(got, want, one, tol, what):
    """|got − want| within ``tol`` of max |want| beyond |one − want|, and
    |got − one| within ``tol`` of it."""
    got, want, one = (np.asarray(a) for a in (got, want, one))
    scale = float(np.abs(want).max()) or 1.0
    base = float(np.abs(one - want).max())
    err = float(np.abs(got - want).max())
    assert err <= base + tol * scale, (what, err / scale, base / scale)
    split = float(np.abs(got - one).max())
    assert split <= tol * scale, (what, split / scale)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_split_loss_and_grads_match_the_unsharded_reference(
        name, shape, ranks, reference, one_process):
    want, one = reference[name], one_process[name]
    got = ranks[shape]
    loss = np.mean([r[name]["loss"] for r in got])
    _close(loss, want["loss"], one["loss"], FWD_TOL, "loss")
    for rank in got:
        for path, g in want["grads"].items():
            _close(rank[name]["grads"][path], g, one["grads"][path],
                   GRAD_TOL, path)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_split_prefill_and_decode_match_the_unsharded_reference(
        name, shape, ranks, reference, one_process):
    want, one = reference[name], one_process[name]
    for rank in ranks[shape]:
        got = rank[name]
        rows = _rows(shape, rank)
        _close(got["prefill"], want["prefill"][rows], one["prefill"][rows],
               FWD_TOL, "prefill")
        for i, (g, w, o) in enumerate(zip(got["decode"], want["decode"],
                                          one["decode"])):
            _close(g, w[rows], o[rows], FWD_TOL, f"decode {i}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_model_peer_sees_only_its_blocks(shape, cases, ranks):
    """No dense layer leaf is gathered over ``model``: each rank's
    attention, SSM, MLP and unembedding get their blocks of the heads,
    columns and vocabulary, whole only where the dim does not divide;
    the KV cache holds the rank's KV heads and K4 scans its SSM heads."""
    m = shape[1]
    for name, (_, cfg, _, _) in cases.items():
        def split(n):
            return n // m if n % m == 0 else n
        want = {"vocab_logits": {(cfg.d_model, cfg.vocab_padded // m)}}
        if cfg.has_attention:
            want["attention"] = {(cfg.d_model, split(cfg.n_heads),
                                  cfg.head_dim)}
        if cfg.has_ssm:
            want["ssd_forward"] = {(cfg.ssm_heads // m,)}
        if cfg.d_ff:
            want["mlp"] = {(cfg.d_model, cfg.d_ff // m)}
        for rank in ranks[shape]:
            got = rank[name]
            assert got["seen"] == want, name
            assert got["k4_heads"] == ([cfg.ssm_heads // m] if cfg.has_ssm
                                       else []), name
            if cfg.has_attention:
                assert got["cache_shapes"]["k"][3] == split(
                    cfg.n_kv_heads), name
            if cfg.has_ssm:
                assert got["cache_shapes"]["state"][2] == \
                    cfg.ssm_heads // m, name
                assert got["cache_shapes"]["conv.x"][3] == \
                    cfg.d_inner // m, name


def test_sp_reduce_scatters_and_no_sp_all_reduces(ranks):
    """The train step's collectives: under SP the residual's entry and
    exit are all-gathers and reduce-scatters; without SP its exits are
    all-reduces (and nothing is reduce-scattered on a (1, M) mesh)."""
    for rank in ranks[(1, 2)]:
        assert "reduce-scatter" in rank["llama"]["coll"]
        assert "reduce-scatter" not in rank["nosp"]["coll"]
        assert "all-reduce" in rank["nosp"]["coll"]


def test_k4_interpret_on_a_ranks_heads_matches_the_oracle(cases, ranks):
    for name in ("mamba2", "hymba"):
        for rank in ranks[(1, 2)]:
            got = rank[name]
            _close(got["prefill_interpret"], got["prefill"], got["prefill"],
                   FWD_TOL, name)


def test_gated_norm_sums_its_squares_over_the_model_peers(ranks):
    for rank in ranks[(1, 2)]:
        err, gerr, scale, gscale = rank["units"]["gated_norm"]
        assert err <= 1e-6 * scale and gerr <= 1e-6 * gscale


def test_vocab_split_cross_entropy_with_a_padded_vocab(ranks):
    for rank in ranks[(1, 2)]:
        loss, whole, gerr, gscale = rank["units"]["ce"]
        assert abs(loss - whole) <= 1e-6 * abs(whole)
        assert gerr <= 1e-6 * gscale


def test_ssm_heads_that_do_not_divide_run_whole():
    """Reduced Mamba2 on 16 model ranks (a DryMesh): its 8 SSM heads do
    not divide 16 while its d_inner of 128 does, so the SSM's leaves and
    cache are whole on every model peer (their d_inner blocks gathered
    by the layer walk) and the prefill walks to its end; the vocabulary
    still splits."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import api
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.roofline.analysis import count_step
    cfg = configs.get_config("mamba2_1p3b").reduced()
    mesh = DryMesh((1, 16), ("data", "model"))
    shape = ShapeConfig("prefill_tiny", 32, 2, "prefill")
    fn, args, in_sp, out_sp, _ = api.lower_cell(cfg, shape, mesh)
    assert in_sp[0]["layers"]["ssm"]["w_x"][2] == "model"
    assert out_sp[1]["conv"]["x"][3] is None
    assert out_sp[1]["state"][2] is None
    counts = count_step(fn, args)
    assert counts["flops"] > 0
    logits, cache = fn(*args)
    assert tuple(logits.shape) == (2, cfg.vocab)
    assert cache["state"].shape[2] == cfg.ssm_heads
    assert cache["conv"]["x"].shape[3] == cfg.d_inner
    assert isinstance(logits, torch.Tensor)

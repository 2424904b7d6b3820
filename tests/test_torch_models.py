"""repro_torch's configs and models against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` and are carried over
with ``params_from_numpy``; inputs are seeded numpy. Reduced configs run
in float32. Tolerances: layers, attention and MoE within 1e-5 of the
output's largest |value| (the same fp32 products summed in other
orders); the whole model's logits within 1e-4 of their largest |value|
(errors compound over the layers and the decode steps), and equal
greedy tokens.

The JAX model runs with no mesh, so its ``moe_layer`` is ``_moe_dense``;
the port's dispatch path is held against the reference's
``_dispatch_combine(cfg, toks, p, None, None, 1)`` directly, and against
the dense model where no token overflows capacity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import configs as jconfigs
from repro.core import isa as jisa
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch import configs
from repro_torch.core import isa
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import params as tparams

RNG = np.random.default_rng(7)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def cfgs(arch, **over):
    """The same reduced config from both packages."""
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(configs.get_config(arch).reduced(), **over))


def weights(jcfg, cfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tparams.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                         "cpu")


def close(got, want, tol=LAYER_TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def normal(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_config_field_equals_the_reference(arch):
    for reduce in (False, True):
        want = jconfigs.get_config(arch)
        got = configs.get_config(arch.replace("_", "-"))
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.vocab_padded, got.n_params(), got.n_active_params()) == \
            (want.vocab_padded, want.n_params(), want.n_active_params())
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: vars(v) for k, v in configs.SHAPES.items()} == \
        {k: vars(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_specs_equal_the_reference(arch):
    jcfg, cfg = (jconfigs.get_config(arch), configs.get_config(arch))
    want = dict(tparams.tree_items(jparams.param_specs(jcfg)))
    got = dict(tparams.tree_items(tparams.param_specs(cfg)))
    assert got.keys() == want.keys()
    for path, spec in got.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(want[path]), path


def test_params_from_numpy_carries_bf16_bit_for_bit():
    jcfg, cfg = cfgs("kimi_k2_1t", param_dtype="bfloat16",
                     act_dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tparams.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    want = dict(tparams.tree_items(jax.tree.map(np.asarray, jp)))
    for path, t in tparams.tree_items(tp):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      want[path].view(np.int16))


def test_params_from_numpy_rejects_another_tree():
    jcfg, cfg = cfgs("llama3_8b")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="tree differs"):
        tparams.params_from_numpy(dataclasses.replace(cfg, qk_norm=True),
                                  tree, "cpu")
    tree["final_norm"] = tree["final_norm"][:3]
    with pytest.raises(ValueError, match="spec"):
        tparams.params_from_numpy(cfg, tree, "cpu")


def test_init_params_follows_the_specs_and_the_seed():
    _, cfg = cfgs("kimi_k2_1t", param_dtype="bfloat16")
    specs = dict(tparams.tree_items(tparams.param_specs(cfg)))
    a = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for path, t in tparams.tree_items(a):
        assert tuple(t.shape) == specs[path].shape
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, dict(tparams.tree_items(b))[path])
    assert (a["final_norm"] == 1).all()
    w = a["layers"]["moe"]["w_in"].float()          # fan-in d_model
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05


def test_lm_state_dict_keys_are_the_reference_paths():
    jcfg, cfg = cfgs("kimi_k2_1t")
    jp, tp = weights(jcfg, cfg)
    lm = M.LM(cfg, tp)
    want = dict(tparams.tree_items(jax.tree.map(np.asarray, jp)))
    assert set(lm.state_dict()) == set(want)
    assert lm.state_dict()["layers.attn.wq"].data_ptr() == \
        tp["layers"]["attn"]["wq"].data_ptr()
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 8)))
    logits, _ = lm.prefill({"tokens": toks})
    assert torch.equal(logits, M.prefill(cfg, tp, {"tokens": toks})[0])


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b"])
def test_init_cache_leaves_are_the_reference_abstract_cache(arch):
    # the SSM leaves (conv windows in the activation dtype, the state in
    # float32) beside the attention half's k and v
    for reduce in (True, False):
        jcfg, cfg = (jconfigs.get_config(arch), configs.get_config(arch))
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        want = {path: (tuple(s.shape), np.dtype(s.dtype).name) for path, s in
                tparams.tree_items(JM.abstract_cache(jcfg, 3, 40))}
        if reduce:
            got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                   for path, t in tparams.tree_items(
                       M.init_cache(cfg, 3, 40, "cpu"))}
            assert all(not t.any() for _, t in tparams.tree_items(
                M.init_cache(cfg, 3, 40, "cpu")))
        else:                       # full width: the specs, not the zeros
            got = {path: (tuple((cfg.n_layers,) + shape),
                          str(dt).removeprefix("torch."))
                   for path, (shape, dt) in tparams.tree_items(
                       M._abstract_layer_cache(cfg, 3, 40))}
        assert got == want
        assert ("state" in got) and ("conv.x" in got)
        assert ("k" in got) == (arch == "hymba_1p5b")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_embed_unembed_and_ce():
    x, w = normal(3, 5, 32), normal(32)
    close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
          jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    close(layers.rope_freqs(16, 1e4), jlayers.rope_freqs(16, 1e4))
    x = normal(2, 7, 3, 16)
    pos = np.arange(7, dtype=np.int32)
    close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    table, toks = normal(40, 8), RNG.integers(0, 40, (2, 5)).astype(np.int32)
    close(layers.embed_tokens(torch.from_numpy(table), torch.from_numpy(toks)),
          jlayers.embed_tokens(jnp.asarray(table), jnp.asarray(toks)))
    wu, h = normal(8, 40), normal(2, 8)
    logits = layers.unembed(torch.from_numpy(wu), torch.from_numpy(h), 37)
    close(logits, jlayers.unembed(jnp.asarray(wu), jnp.asarray(h), 37))
    tg = RNG.integers(0, 37, (2,)).astype(np.int32)
    got, m = layers.cross_entropy(logits, torch.from_numpy(tg))
    want, jm = jlayers.cross_entropy(jnp.asarray(logits.numpy()),
                                     jnp.asarray(tg))
    close(got, want)
    close(m["z_loss"], jm["z_loss"])


def test_unembed_in_vocabulary_chunks(monkeypatch):
    wu, h = normal(8, 100), normal(3, 8)
    whole = layers.unembed(torch.from_numpy(wu), torch.from_numpy(h), 90)
    monkeypatch.setattr(layers, "UNEMBED_CHUNK", 16)
    chunked = layers.unembed(torch.from_numpy(wu), torch.from_numpy(h), 90)
    assert chunked.shape == (3, 90)
    close(chunked, whole.numpy())


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    p = {"w_in": normal(16, 24), "w_out": normal(24, 16),
         "w_gate": normal(16, 24)}
    x = normal(2, 3, 16)
    close(layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), gated),
          jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), gated))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "full": dict(attn_impl="full"),
    "chunked": dict(attn_impl="chunked"),
    "chunked ragged": dict(attn_impl="chunked", attn_chunk=12),
    "flat heads": dict(attn_impl="chunked", attn_flat_heads=True),
    "swa": dict(attn_impl="chunked", swa_window=8),
    "kernel": dict(attn_impl="kernel"),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_14b"])
def test_attention_prefill(arch, case):
    jcfg, cfg = cfgs(arch, **ATTN_CASES[case])
    jp, tp = weights(jcfg, cfg)
    x = normal(2, 20, cfg.d_model)
    pos = np.arange(20, dtype=np.int32)
    with jisa.use("interpret"), isa.use("interpret"):
        got, (k, v) = attn.attention(cfg, M._layer(tp["layers"], 0)["attn"],
                                     torch.from_numpy(x),
                                     torch.from_numpy(pos), return_cache=True)
        want, (wk, wv) = jattn.attention(
            jcfg, jax.tree.map(lambda a: a[0], jp["layers"])["attn"],
            jnp.asarray(x), jnp.asarray(pos), return_cache=True)
    close(got, want)
    close(k, wk)
    close(v, wv)


@pytest.mark.parametrize("swa", [0, 8])
def test_attention_decode(swa):
    jcfg, cfg = cfgs("llama3_8b", swa_window=swa)
    jp, tp = weights(jcfg, cfg)
    t = 8 if swa else 16
    kc, vc = normal(2, t, 2, 16), normal(2, t, 2, 16)
    x = normal(2, 1, cfg.d_model)
    for pos in (3, 11):
        got, k2, v2 = attn.attention_decode(
            cfg, M._layer(tp["layers"], 0)["attn"], torch.from_numpy(x),
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos)
        want, wk, wv = jattn.attention_decode(
            jcfg, jax.tree.map(lambda a: a[0], jp["layers"])["attn"],
            jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos))
        close(got, want)
        close(k2, wk)
        close(v2, wv)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_weights(arch, **over):
    jcfg, cfg = cfgs(arch, **over)
    jp, tp = weights(jcfg, cfg)
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"])["moe"],
            M._layer(tp["layers"], 0)["moe"])


@pytest.mark.parametrize("mode", ["interpret", "ref"])
def test_route_and_slots(mode):
    jcfg, cfg, _, _ = moe_weights("kimi_k2_1t", n_experts=384, top_k=8)
    logits = normal(24, 384)
    with jisa.use(mode), isa.use(mode):
        g, ids, aux = moe._route(cfg, torch.from_numpy(logits))
        wg, wids, waux = jmoe._route(jcfg, jnp.asarray(logits))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
        close(g, wg)
        close(aux, waux)
        for cap in (8, 16):
            dst = moe._slots(cfg, ids, cap)
            np.testing.assert_array_equal(
                dst.numpy(), np.asarray(jmoe._slots(jcfg, wids, cap)))
    assert moe._capacity(cfg, 24) == jmoe._capacity(jcfg, 24)
    assert moe._capacity(cfg, 4096) == jmoe._capacity(jcfg, 4096) == 112


@pytest.mark.parametrize("arch,over", [
    ("kimi_k2_1t", {"capacity_factor": 0.5}),
    ("kimi_k2_1t", {"capacity_factor": 8.0}),
    ("grok1_314b", {"capacity_factor": 0.5}),
    ("kimi_k2_1t", {"mlp_gated": False}),       # the GELU expert FFN
])
def test_dispatch_combine_matches_the_reference(arch, over):
    cf = over.get("capacity_factor", 1.25)
    jcfg, cfg, jp, tp = moe_weights(arch, **over)
    toks = normal(32, cfg.d_model)
    with jisa.use("interpret"), isa.use("interpret"):
        got, aux = moe._dispatch_combine(cfg, torch.from_numpy(toks), tp)
        want, waux = jmoe._dispatch_combine(jcfg, jnp.asarray(toks), jp,
                                            None, None, 1)
    close(got, want)
    close(aux, waux)
    if cf < 1:      # tokens overflowed: some (token, expert) pairs dropped
        ids = jmoe._route(jcfg, jnp.asarray(toks) @ jp["router"])[1]
        cap = jmoe._capacity(jcfg, 32)
        assert int((jmoe._slots(jcfg, ids, cap) == cfg.n_experts * cap)
                   .sum()) > 0


@pytest.mark.parametrize("impl", ["dense", "ep", "ep microbatch"])
def test_moe_layer(impl):
    over = ({"moe_impl": "dense"} if impl == "dense" else
            {"dispatch_microbatch": 2} if impl == "ep microbatch" else {})
    jcfg, cfg, jp, tp = moe_weights("kimi_k2_1t", capacity_factor=0.75,
                                    **over)
    x = normal(2, 8, cfg.d_model)
    got, aux = moe.moe_layer(cfg, tp, torch.from_numpy(x))
    if impl == "dense":
        want, waux = jmoe.moe_layer(jcfg, jp, jnp.asarray(x))
    else:   # what the reference's shard_map body computes on one device
        mb = 2 if impl == "ep microbatch" else 1
        parts = [jmoe._dispatch_combine(jcfg, blk, jp, None, None, 1)
                 for blk in jnp.asarray(x).reshape(mb, -1, cfg.d_model)]
        want = jnp.concatenate([o for o, _ in parts]).reshape(x.shape)
        waux = jnp.mean(jnp.stack([a for _, a in parts]))
    close(got, want)
    close(aux, waux)


# ---------------------------------------------------------------------------
# the whole model: prefill, grow_cache, decode
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "llama3_8b": ("llama3_8b", {}, None),
    "qwen3_14b qk_norm": ("qwen3_14b", {}, None),
    "granite_20b": ("granite_20b", {}, None),
    "musicgen_medium embeddings": ("musicgen_medium", {}, None),
    "grok1_314b dense": ("grok1_314b", {"moe_impl": "dense"}, None),
    "kimi_k2_1t dense": ("kimi_k2_1t", {"moe_impl": "dense"}, None),
    "kimi_k2_1t dispatch": ("kimi_k2_1t", {"capacity_factor": 8.0}, None),
    "kimi_k2_1t 384 experts top-8": (
        "kimi_k2_1t", {"capacity_factor": 8.0, "n_experts": 384,
                       "top_k": 8}, None),
    "kimi_k2_1t attn kernel interpret": (
        "kimi_k2_1t", {"capacity_factor": 8.0, "attn_impl": "kernel"},
        "interpret"),
    "llama3_8b swa 16": ("llama3_8b", {"swa_window": 16}, None),
    "mamba2_1p3b ref": ("mamba2_1p3b", {}, "ref"),
    "mamba2_1p3b interpret": ("mamba2_1p3b", {}, "interpret"),
    "hymba_1p5b ref": ("hymba_1p5b", {}, "ref"),
    "hymba_1p5b interpret": ("hymba_1p5b", {}, "interpret"),
}


def run_model(jcfg, cfg, jp, tp, batch_np, n_decode, seq):
    """Prefill, grow, then greedy decode steps in both packages; yields
    (port logits, reference logits) per step."""
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    jl, jc = jax.jit(lambda p, b: JM.prefill(jcfg, p, b))(jp, jb)
    tl, tc = M.prefill(cfg, tp, tb)
    yield tl, jl
    cap = seq + n_decode
    jc = JM.grow_cache(jcfg, jc, seq, cap)
    tc = M.grow_cache(cfg, tc, seq, cap)
    assert {k: tuple(v.shape) for k, v in tparams.tree_items(tc)} == \
        {k: v.shape for k, v in tparams.tree_items(jc)}
    jdec = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    for i in range(n_decode):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jdec(jp, jc, jt, jnp.int32(seq + i))
        tl, tc = M.decode_step(cfg, tp, tc, tt, seq + i)
        yield tl, jl


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_grow_and_decode_match_the_reference(case):
    arch, over, mode = MODEL_CASES[case]
    jcfg, cfg = cfgs(arch, **over)
    # the SSM mixer takes whole chunks (16 reduced); Hymba's sequence
    # also outruns its reduced window (32), so the rolled cache is used
    seq = 48 if cfg.has_ssm else 24 if cfg.swa_window else 16
    jp, tp = weights(jcfg, cfg)
    if cfg.frontend != "none":
        batch = {"embeddings": normal(2, seq, cfg.d_model)}
    else:
        batch = {"tokens": RNG.integers(0, cfg.vocab, (2, seq))
                 .astype(np.int32)}
    with jisa.use(mode or "auto"), isa.use(mode or "auto"):
        steps = list(run_model(jcfg, cfg, jp, tp, batch, 8, seq))
    assert len(steps) == 9
    for got, want in steps:
        assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
        close(got, want, MODEL_TOL)


def test_forward_matches_the_reference():
    jcfg, cfg = cfgs("kimi_k2_1t", moe_impl="dense")
    jp, tp = weights(jcfg, cfg)
    toks = RNG.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    got, aux = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, waux = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            train=False)
    close(got, want)
    close(aux, waux)
    # the training forward (each block rematerialised) is the same function
    got, aux = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)},
                         train=True)
    want, waux = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            train=True)
    close(got, want)
    close(aux, waux)

"""The weight tree a cell draws (``perfbench/lib/weights.py``).

A family that gives one layer's layout draws the uniform tree, bit for
bit as the harness drew it before a family could give the whole tree
(digests recorded on that tree); Mamba2-1.3B's tree keeps its paths,
shapes and laws. A family that gives the whole tree can lay out a
leading stack before a stack of another layout, a stack for each kind
of layer, a leaf outside any stack and a leaf in a dtype of its own, and
each leaf is drawn in its shape, dtype and law. Set-up refuses a tree
that the program lacks, naming each leaf that differs."""
from __future__ import annotations

import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import serve, train, weights  # noqa: E402
from perfbench.reference import adamw  # noqa: E402
from perfbench.reference import ssm as ref_ssm  # noqa: E402

SEED = 2 ** 40 + 3
SSM = {"name": "tiny-ssm", "family": "ssm", "n_layers": 2, "d_model": 64,
       "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab": 512,
       "ssm_state": 16, "ssm_headdim": 16, "ssm_expand": 2, "ssm_chunk": 16,
       "conv_width": 4, "tie_embeddings": True, "param_dtype": "bfloat16",
       "act_dtype": "bfloat16", "remat": "full", "optimizer": "adamw"}
# sha256 of every leaf's path, (shape, dtype) and bytes in sorted order,
# drawn on the CPU by the harness before the whole tree could be given
DIGESTS = {
    (True, SEED):
        "635f6347164336d8b7d1f35d2d21b638e151dab528b521fa86b9db03698faeb2",
    (True, 7):
        "cba1ed0f81000b925abd0bdd7bd2d821837d0badf9c8b06572593757b9b71d1f",
    (False, SEED):
        "334c619462953a0d478b6334cc89704d30755a37d0e6c4dd66030df2e8e62f92",
    (False, 7):
        "76c40ce0e846f933ba91c6ca8e0b36f2a3b88f00f819f45f5c7824c807dcd819",
}
# mamba2-1.3b's tree as it was: (path, shape, law)
MAMBA2 = [
    ("embed", (50432, 2048), "embed"), ("final_norm", (2048,), "ones"),
    ("layers.norm1", (48, 2048), "ones"),
    ("layers.ssm.A_log", (48, 64), "a_log"),
    ("layers.ssm.D", (48, 64), "ones"),
    ("layers.ssm.conv_B", (48, 4, 128), 4),
    ("layers.ssm.conv_C", (48, 4, 128), 4),
    ("layers.ssm.conv_x", (48, 4, 4096), 4),
    ("layers.ssm.dt_bias", (48, 64), "dt_bias"),
    ("layers.ssm.norm", (48, 4096), "ones"),
    ("layers.ssm.out_proj", (48, 4096, 2048), 4096),
    ("layers.ssm.w_B", (48, 2048, 128), 2048),
    ("layers.ssm.w_C", (48, 2048, 128), 2048),
    ("layers.ssm.w_dt", (48, 2048, 64), 2048),
    ("layers.ssm.w_x", (48, 2048, 4096), 2048),
    ("layers.ssm.w_z", (48, 2048, 4096), 2048),
]


def digest(params: dict) -> str:
    h = hashlib.sha256()
    for k, v in weights.leaves(params):
        h.update(k.encode())
        h.update(repr((tuple(v.shape), str(v.dtype))).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("tied,seed", sorted(DIGESTS))
def test_uniform_tree_drawn_bit_for_bit(tied, seed):
    m = dict(SSM, tie_embeddings=tied)
    assert not hasattr(ref_ssm, "layout")
    assert digest(weights.make(m, seed, "cpu")) == DIGESTS[(tied, seed)]


def test_mamba2_tree_unchanged():
    m = json.loads((ROOT / "perfbench" / "configs" / "mamba2-1.3b.json")
                   .read_text())["model"]
    tree = weights.layout(m)
    assert [(k, tuple(v[0]), v[1]) for k, v in weights.leaves(tree)] \
        == MAMBA2
    assert all(len(v) == 2 for _, v in weights.leaves(tree))
    assert weights.stacked_paths(m) == {k for k, _, _ in MAMBA2
                                        if k.startswith("layers.")}
    assert set(weights.dtypes(m).values()) == {torch.bfloat16}


# -- a family that gives the whole tree -----------------------------------

TREE_MODEL = {"name": "tiny-tree", "family": "treetest", "n_layers": 4,
              "d_model": 64, "d_ff": 96, "n_experts": 8, "d_expert": 32,
              "vocab": 300, "tie_embeddings": False,
              "param_dtype": "bfloat16"}


def _uniform_1_2(t, gen):
    t.copy_(torch.empty(t.shape).uniform_(1.0, 2.0, generator=gen))


def _tree_layout(m):
    d, f, e, fe = m["d_model"], m["d_ff"], m["n_experts"], m["d_expert"]
    dense = {"norm1": ((d,), "ones"),
             "mlp": {"w_in": ((d, f), d), "w_out": ((f, d), f)}}
    moe = {"norm1": ((d,), "ones"),
           "moe": {"router": ((d, e), d),
                   "router_bias": ((e,), "uniform_1_2", "float32"),
                   "w_in": ((e, d, fe), d), "w_out": ((e, fe, d), fe)}}
    ssm = {"norm1": ((d,), "ones"), "A_log": ((8,), "uniform_1_2")}
    return {**weights.ends(m),
            "dense_layers": weights.stacked(dense, 1),          # (a)
            "moe_layers": weights.stacked(moe, m["n_layers"] - 1),
            "ssm_layers": weights.stacked(ssm, 3),              # (b)
            "meta_tokens": ((16, d), "embed"),                  # (c)
            "meta_scale": ((d,), d, "float32")}                 # (d)


@pytest.fixture
def tree_family(monkeypatch):
    fam = types.ModuleType("perfbench.reference.treetest")
    fam.layout = _tree_layout
    fam.LAWS = {"uniform_1_2": _uniform_1_2}
    monkeypatch.setitem(sys.modules, "perfbench.reference.treetest", fam)
    return TREE_MODEL


SHAPES = {
    "embed": ((512, 64), torch.bfloat16, "embed"),
    "final_norm": ((64,), torch.bfloat16, "ones"),
    "unembed": ((64, 512), torch.bfloat16, 64),
    "dense_layers.norm1": ((1, 64), torch.bfloat16, "ones"),
    "dense_layers.mlp.w_in": ((1, 64, 96), torch.bfloat16, 64),
    "dense_layers.mlp.w_out": ((1, 96, 64), torch.bfloat16, 96),
    "moe_layers.norm1": ((3, 64), torch.bfloat16, "ones"),
    "moe_layers.moe.router": ((3, 64, 8), torch.bfloat16, 64),
    "moe_layers.moe.router_bias": ((3, 8), torch.float32, "uniform_1_2"),
    "moe_layers.moe.w_in": ((3, 8, 64, 32), torch.bfloat16, 64),
    "moe_layers.moe.w_out": ((3, 8, 32, 64), torch.bfloat16, 32),
    "ssm_layers.norm1": ((3, 64), torch.bfloat16, "ones"),
    "ssm_layers.A_log": ((3, 8), torch.bfloat16, "uniform_1_2"),
    "meta_tokens": ((16, 64), torch.bfloat16, "embed"),
    "meta_scale": ((64,), torch.float32, 64),
}


def test_whole_tree_shapes_dtypes_and_stacks(tree_family):
    m = tree_family
    params = weights.make(m, SEED, "cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in weights.leaves(params)}
    assert got == {k: (s, d) for k, (s, d, _) in SHAPES.items()}
    assert weights.dtypes(m) == {k: d for k, (_, d, _) in SHAPES.items()}
    assert weights.stacked_paths(m) == {
        k for k in SHAPES if k.split(".")[0].endswith("_layers")}


def test_whole_tree_laws(tree_family):
    """Ones are ones; a family law's leaves lie in its range; a normal
    law's sample has its mean within five standard errors of 0 and its
    standard deviation within five of the law's (the sample's relative
    standard error being 1/sqrt(2n))."""
    params = dict(weights.leaves(weights.make(tree_family, SEED, "cpu")))
    for k, (_, _, law) in SHAPES.items():
        v = params[k].double().flatten()
        if law == "ones":
            assert bool((v == 1).all()), k
        elif law == "uniform_1_2":
            assert 1.0 <= float(v.min()) and float(v.max()) <= 2.0, k
            assert float(v.std()) > 0.1, k
        else:
            std = 0.02 if law == "embed" else law ** -0.5
            n = v.numel()
            assert abs(float(v.mean())) < 5 * std / n ** 0.5, k
            assert abs(float(v.std()) / std - 1) < 5 / (2 * n) ** 0.5, k


def test_whole_tree_same_seed_same_bits(tree_family):
    assert digest(weights.make(tree_family, SEED, "cpu")) \
        == digest(weights.make(tree_family, SEED, "cpu"))
    a = dict(weights.leaves(weights.make(tree_family, SEED, "cpu")))
    b = dict(weights.leaves(weights.make(tree_family, SEED + 1, "cpu")))
    for k, (_, _, law) in SHAPES.items():
        assert torch.equal(a[k], b[k]) == (law == "ones"), k


def test_training_check_follows_the_tree(tree_family):
    """Each stacked leaf gets a norm a layer; the reference's update is
    stored in each leaf's own dtype."""
    m = tree_family
    flat = {k: v.float() for k, v in
            weights.leaves(weights.make(m, SEED, "cpu"))}
    norms = train._layer_norms(flat, weights.stacked_paths(m))
    assert {k: len(v) for k, v in norms.items()} == {
        k: s[0] for k, (s, _, _) in SHAPES.items()
        if k.split(".")[0].endswith("_layers")}
    hyper = {"lr": 1e-3, "warmup": 0, "total_steps": 10, "floor": 0.1,
             "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0}
    grads = {k: torch.full_like(v, 1e-3) for k, v in flat.items()}
    adamw.step(hyper, flat, grads, {}, 0, train._store(m))
    for k, (_, dtype, _) in SHAPES.items():
        assert torch.equal(flat[k], flat[k].to(dtype).float()), k
    # a float32 leaf moves by less than a bf16 spacing near 1.5
    bias = flat["moe_layers.moe.router_bias"]
    assert not torch.equal(bias, bias.bfloat16().float())


# -- set-up refuses a tree the program lacks -------------------------------

def _cell(kind: str):
    config = json.loads((ROOT / "perfbench" / "configs" / "mamba2-1.3b.json")
                        .read_text())
    config["model"] = dict(SSM)
    mix = json.loads((ROOT / "perfbench" / "traffic" /
                      f"{'prefill-8k' if kind == 'serve' else 'train-4k'}"
                      ".json").read_text())
    mix.update(batch=2, prompt_len=32, seq_len=32)
    return config, mix


def _wrong_layout(m):
    tree = weights.uniform(m)
    tree["meta_tokens"] = ((16, m["d_model"]), "embed")       # extra
    tree["final_norm"] = ((m["d_model"],), "ones", "float32")  # dtype
    del tree["layers"]["norm1"]                                # missing
    w_b = tree["layers"]["ssm"]["w_B"]
    tree["layers"]["ssm"]["w_B"] = ((2, 64, 8), w_b[1])        # shape
    return tree


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_setup_refuses_a_tree_the_program_lacks(kind, monkeypatch):
    monkeypatch.setattr(ref_ssm, "layout", _wrong_layout, raising=False)
    config, mix = _cell(kind)
    driver = serve.Serve if kind == "serve" else train.Train
    with pytest.raises(ValueError) as err:
        driver(config, mix, SEED, "cpu").setup()
    said = str(err.value)
    for leaf in ("meta_tokens", "final_norm", "layers.norm1",
                 "layers.ssm.w_B"):
        assert leaf in said, said
    assert "layers.ssm.w_C" not in said

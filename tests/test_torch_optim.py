"""repro_torch's optimizers against the JAX package's, on the CPU.

Twins of ``tests/test_substrates.py``'s optimizer tests, and one update
of AdamW and of Adafactor on identical numpy params (bfloat16), states
(float32) and gradients in both packages: the new states within 4
float32 ulp of the reference's (Adafactor's means sum in another order),
the new params within 1 bfloat16 ulp; and ``warmup_cosine`` on steps
0…3000 within one float32 ulp of ``cos`` (which may round differently
in the two packages, and near the schedule's end 1 + cos cancels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as J
from repro_torch.optim import (Adafactor, AdamW, clip_by_global_norm,
                               get_optimizer, global_norm, warmup_cosine)
from repro_torch.optim.optimizers import tree_leaves

SHAPES = {"a": (16, 24), "b": {"c": (8,), "d": (3, 4, 5)}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _quadratic_converges(opt, steps=400):
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3), "m": torch.zeros((2, 3))}

    def loss(p):
        return (torch.sum((p["w"] - target) ** 2)
                + torch.sum((p["m"] - 1.0) ** 2))

    state = opt.init(params)
    for step in range(steps):
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(live, torch.autograd.grad(loss(live), list(live.values()))))
        params, state = opt.update(g, state, params, step)
    return float(loss(params))


def test_adamw_converges():
    assert _quadratic_converges(AdamW(lr=5e-2, weight_decay=0.0)) < 1e-3


def test_adafactor_converges():
    assert _quadratic_converges(Adafactor(lr=5e-2)) < 1e-2


def test_adafactor_state_is_factored():
    st = Adafactor().init({"w": torch.zeros((64, 32))})
    assert st["f"]["w"]["vr"].shape == (64,)
    assert st["f"]["w"]["vc"].shape == (32,)


def test_state_logical_axes_follow_params():
    ax = {"w": ("embed", "ffn")}
    assert AdamW().state_logical_axes(ax) == {"m": ax, "v": ax}
    f = Adafactor().state_logical_axes(ax)["f"]["w"]
    assert f["vr"] == ("embed",) and f["vc"] == ("ffn",)
    assert Adafactor().state_logical_axes(ax) == \
        J.Adafactor().state_logical_axes(ax)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 20.0
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


def test_clip_and_norm_match_the_reference():
    rng = np.random.default_rng(1)
    tree = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    jc, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 0.5)
    tc, tn = clip_by_global_norm(_tree_torch(tree), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(_tree_torch(tree))),
                               float(J.global_norm(tree)), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6)


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, rel=1e-2)
    assert float(lr(55)) < float(lr(20))


def test_warmup_cosine_matches_the_reference_on_every_step():
    steps = np.arange(3001)
    for args in ((3e-4, 2000, 10_000), (1.0, 10, 100), (5e-2, 301, 3000)):
        want = np.asarray(jax.vmap(J.warmup_cosine(*args))(steps))
        got = np.array([float(warmup_cosine(*args)(int(s))) for s in steps],
                       np.float32)
        # one float32 ulp of cos near ±1 (2⁻²⁴·2), times the schedule's
        # peak·(1 − floor)/2, plus the result's own rounding
        np.testing.assert_allclose(got, want, rtol=2 ** -24,
                                   atol=args[0] * 2 ** -24)


def _tree_torch(tree, dtype=None):
    def conv(x):
        t = torch.from_numpy(np.array(x))
        return t if dtype is None else t.to(dtype)
    return jax.tree.map(conv, tree)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16).astype(np.int64)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("step", [0, 1, 7, 400])
def test_update_matches_the_reference_on_identical_grads(name, step):
    rng = np.random.default_rng(step)
    p32 = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    g32 = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    jo = J.get_optimizer(name, lr=1e-2, total_steps=1000)
    to = get_optimizer(name, lr=1e-2, total_steps=1000)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p32)
    jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g32)
    # a state past its zeros: the reference's update on other gradients
    js = jo.init(jp)
    _, js = jo.update(jax.tree.map(lambda x: x * 0.5, jg), js, jp, 3)
    jp2, js2 = jo.update(jg, js, jp, step)
    tp = jax.tree.map(lambda x: torch.from_numpy(
        np.asarray(x).view(np.int16).copy()).view(torch.bfloat16), jp)
    tg = jax.tree.map(lambda x: torch.from_numpy(
        np.asarray(x).view(np.int16).copy()).view(torch.bfloat16), jg)
    ts = _tree_torch(js)
    tp2, ts2 = to.update(tg, ts, tp, step)
    for a, b in zip(tree_leaves(ts2), jax.tree.leaves(js2)):
        assert a.dtype == torch.float32
        ulp = np.abs(a.numpy().view(np.int32).astype(np.int64)
                     - np.asarray(b).view(np.int32).astype(np.int64))
        assert ulp.max() <= 4
    for a, b in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        assert a.dtype == torch.bfloat16
        want = np.asarray(b).view(np.uint16).astype(np.int64)
        assert np.abs(_bf16_bits(a) - want).max() <= 1
    # functional: the arguments are left as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ts), tree_leaves(_tree_torch(js))))


def test_state_dtype_bfloat16_moments():
    opt = AdamW(lr=1e-2, state_dtype="bfloat16")
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = opt.init(params)
    assert st["m"]["w"].dtype == torch.bfloat16
    new_p, st = opt.update({"w": torch.ones(4)}, st, params, 1)
    assert st["v"]["w"].dtype == torch.bfloat16
    assert new_p["w"].dtype == torch.bfloat16


def test_get_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("sgd")

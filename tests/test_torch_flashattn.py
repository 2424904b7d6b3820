"""repro_torch's c6_flashattn against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its jnp oracle) and ``repro_torch`` (the plain
blocked online softmax K8 is held against, in ``interpret`` mode, and
its torch oracle). Tolerances: float32 within 2e-5 absolute at
unit-scale inputs (both sum the same products in fp32 in other orders);
bfloat16 within one bfloat16 ulp of the reference's value (both compute
in fp32 and round once). A causal call with sq < sk is held against the
oracles only: the Pallas kernel rejects it.

K8 itself runs only on the card (tests/test_torch_lm_kernels.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import isa
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import flashattn as fa

RNG = np.random.default_rng(42)
TOL = 2e-5


def qkv(shape_q, shape_kv=None, dtype="float32"):
    out = [RNG.standard_normal(s).astype(np.float32)
           for s in (shape_q, shape_kv or shape_q, shape_kv or shape_q)]
    if dtype == "bfloat16":
        out = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in out]
    return out


def to_torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def to_jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("b,h,s,d", [
    (1, 1, 128, 64), (2, 4, 128, 64), (1, 2, 256, 128), (2, 2, 64, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(b, h, s, d, causal):
    xs = qkv((b, h, s, d))
    got = ops.flash_attention(*to_torch(xs), causal=causal, mode="interpret")
    want = jops.flash_attention(*to_jax(xs), causal=causal, mode="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    got = ops.flash_attention(*to_torch(xs), causal=causal, mode="ref")
    want = jref.flash_attention(*to_jax(xs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("mode", ["interpret", "ref"])
def test_flash_attention_bf16_within_one_ulp(mode):
    xs = qkv((1, 2, 128, 64), dtype="bfloat16")
    got = ops.flash_attention(*to_torch(xs, torch.bfloat16), causal=True,
                              mode=mode).float().numpy()
    want = (jops.flash_attention(*to_jax(xs, jnp.bfloat16), causal=True,
                                 mode="interpret") if mode == "interpret"
            else jref.flash_attention(*to_jax(xs, jnp.bfloat16), causal=True))
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got - want) <= bf16_ulp(want)).all()


@pytest.mark.parametrize("sq,sk", [(64, 128), (1, 96), (100, 228)])
def test_causal_sq_below_sk_is_aligned_bottom_right(sq, sk):
    xs = qkv((2, 2, sq, 32), (2, 2, sk, 32))
    want = np.asarray(jref.flash_attention(*to_jax(xs), causal=True))
    for got in (fa.flash_attention_plain(*to_torch(xs), causal=True),
                ops.flash_attention(*to_torch(xs), causal=True,
                                    mode="interpret"),
                ref.flash_attention(*to_torch(xs), causal=True)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("s", [1, 70, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_takes_ragged_blocks(s, causal):
    # K8's own 64-row tiling on lengths that are not a multiple of it
    xs = qkv((1, 3, s, 16))
    got = fa.flash_attention_plain(*to_torch(xs), causal=causal)
    want = np.asarray(jref.flash_attention(*to_jax(xs), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_plain_version_skipping_no_tile_equals_kernel_order():
    # masked tiles give p = 0 and alpha = 1 exactly, so the plain walk over
    # every tile equals one that stops at the diagonal (what K8 does)
    xs = to_torch(qkv((2, 2, 128, 32)))
    full = fa.flash_attention_plain(*xs, causal=True)
    first = fa.flash_attention_plain(xs[0][:, :, :64], xs[1][:, :, :64],
                                     xs[2][:, :, :64], causal=True)
    assert torch.equal(full[:, :, :64], first)


def test_auto_follows_the_tensors_and_kernel_needs_cuda():
    xs = to_torch(qkv((1, 2, 64, 16)))
    with isa.use("auto"):
        assert torch.equal(ops.flash_attention(*xs),
                           ref.flash_attention(*xs))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(*xs, mode="kernel")
    assert fa.K8.launches == 0


def test_checks():
    q, k, v = to_torch(qkv((1, 1, 8, 48)))
    with pytest.raises(ValueError, match="head dims"):
        fa.K8(q, k, v)
    q, k, v = to_torch(qkv((1, 1, 8, 16), (1, 1, 4, 16)))
    with pytest.raises(ValueError, match="no visible key"):
        fa.flash_attention_plain(q, k, v, causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.K8(q.half(), k.half(), v.half(), causal=False)
    with pytest.raises(ValueError, match="same leading dims"):
        fa.flash_attention_plain(q, k[:, :, :, :8], v, causal=False)


def test_cuda_source_exports_the_bound_launcher():
    src = (_cuda.CSRC / "flashattn.cu").read_text()
    for name, argtypes in fa._SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src, re.S)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes)
    assert "repro_cuda_error_string" in src
    for d in fa.HEAD_DIMS:
        assert f"case {d}:" in src

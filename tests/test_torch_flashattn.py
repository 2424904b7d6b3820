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


def qkv(shape_q, shape_kv=None, dtype="float32", rng=None):
    rng = RNG if rng is None else rng
    out = [rng.standard_normal(s).astype(np.float32)
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


# ---------------------------------------------------------------------------
# K8's bfloat16 arithmetic (csrc/flashattn.cu, the tensor-core path),
# emulated on the CPU
# ---------------------------------------------------------------------------

def k8_bf16_emulated(q, k, v, causal=True, block_k=128, terms=3):
    """K8's bf16 instance: q·kᵀ of bf16 values summed in fp32 (the products
    are exact), the online softmax in fp32 over 128-key tiles, p·v with p
    split into ``terms`` bf16 terms (p1 = bf16(p), p2 = bf16(p - p1),
    p3 = bf16(p - p1 - p2)), each 16 keys' products summed apart and then
    added to the fp32 accumulator, l summed from the fp32 p,
    out = acc / max(l, 1e-30) rounded to bf16 (in fp32 rounding to
    nearest: the card's tensor cores round their sums toward zero)."""
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    qf, kf, vf = (t.float().reshape(-1, t.shape[-2], d) for t in (q, k, v))
    qi = torch.arange(sq)[:, None]
    m = torch.full((qf.shape[0], sq, 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, sk, block_k):
        kj = torch.arange(k0, k0 + block_k)
        short = k0 + block_k - min(sk, k0 + block_k)   # rows past sk
        kt = torch.nn.functional.pad(kf[:, k0:k0 + block_k], (0, 0, 0, short))
        vt = torch.nn.functional.pad(vf[:, k0:k0 + block_k], (0, 0, 0, short))
        s = torch.matmul(qf, kt.transpose(-1, -2)) * d ** -0.5
        if causal:
            s = torch.where(kj > qi + sk - sq, fa.NEG_INF, s)
        s = torch.where(kj >= sk, float("-inf"), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for c in range(0, block_k, 16):           # a k-step's 16 keys
            rest, t = p[..., c:c + 16], 0.0
            for _ in range(terms):
                term = rest.to(torch.bfloat16).float()
                t = t + torch.matmul(term, vt[:, c:c + 16])
                rest = rest - term
            acc = acc + t
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(torch.bfloat16)
    return out.reshape(*lead, sq, d)


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_attn",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("logit_scale", [1.0, 1000.0])
def test_k8_bf16_arithmetic_within_the_gate(smoke, logit_scale):
    xs = qkv((1, 2, 256, 128), dtype="bfloat16",
             rng=np.random.default_rng(11))
    xs[0] = torch.from_numpy(xs[0] * logit_scale).to(
        torch.bfloat16).float().numpy()              # logits ~ logit_scale
    q, k, v = to_torch(xs, torch.bfloat16)
    got = k8_bf16_emulated(q, k, v)
    bound = smoke.attn_bound(q, k, v)
    want = torch.from_numpy(np.array(jops.flash_attention(
        *to_jax(xs, jnp.bfloat16), causal=True,
        mode="interpret").astype(jnp.float32)))
    assert smoke.attn_misses(got, want, bound)[0] == 0
    plain = fa.flash_attention_plain(q, k, v)
    assert smoke.attn_misses(got, plain, bound)[0] == 0
    # and against float64 each element within its own bound and no more
    # elements beyond one bf16 ulp than the plain version (chip_smoke's
    # gate on the LM path's own inputs, whose logits are ~10^3)
    res = smoke.attn_f64_misses(got, plain, q, k, v)
    assert res["outside_element_bound_f64"] == 0
    assert res["over_one_bf16_ulp_f64"] <= res["plain_over_one_bf16_ulp_f64"]


def test_k8_bf16_three_terms_carry_p_to_fp32():
    # each bf16 term of the split leaves at most 2^-8 of what it splits,
    # and the differences are exact in fp32: p1 errs by up to 2^-8·p,
    # p1 + p2 by 2^-16·p, p1 + p2 + p3 by 2^-24·p
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.uniform(0, 1, (64, 128)).astype(np.float32))
    rest, total = p, torch.zeros_like(p, dtype=torch.float64)
    for n in (1, 2, 3):
        term = rest.to(torch.bfloat16).float()
        assert torch.equal((rest - term).double(),
                           rest.double() - term.double())     # exact
        rest = rest - term
        total = total + term.double()
        err = (total - p.double()).abs()
        assert bool((err <= 2.0 ** (-8 * n) * p.double()).all())


def test_k8_bf16_two_terms_fall_short_of_fp32(smoke):
    # why K8 takes three terms: with two, at unit-scale logits, more
    # outputs land beyond one bf16 ulp of the float64 result than the fp32
    # plain version's (inside the bound all the same)
    q, k, v = to_torch(qkv((1, 2, 256, 128), dtype="bfloat16",
                           rng=np.random.default_rng(12)), torch.bfloat16)
    plain = fa.flash_attention_plain(q, k, v)
    two = k8_bf16_emulated(q, k, v, terms=2)
    assert smoke.attn_misses(two, plain, smoke.attn_bound(q, k, v))[0] == 0
    res = smoke.attn_f64_misses(two, plain, q, k, v)
    assert res["outside_element_bound_f64"] == 0
    assert res["over_one_bf16_ulp_f64"] > res["plain_over_one_bf16_ulp_f64"]
    res = smoke.attn_f64_misses(k8_bf16_emulated(q, k, v), plain, q, k, v)
    assert res["over_one_bf16_ulp_f64"] <= res["plain_over_one_bf16_ulp_f64"]

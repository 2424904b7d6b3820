"""K7 (top-k) and K8 (flash attention) against their plain PyTorch
versions, and the LM server's kernel path against its plain path, on the
card.

Both kernels are CUDA C++ (built with nvcc at first use) with no CPU
mode, so every test here is marked ``gpu`` and skips without a CUDA
device. Run them on an H100 with
``pytest -m gpu tests/test_torch_lm_kernels.py``.

Tolerances: K7 bit-exact (values by their bits, and indices) against
the oracle ``ref.topk`` (lax.top_k's order: ties in ascending index,
+0.0 above -0.0, NaN by its sign above +inf or below -inf), and against
the plain network (the JAX kernel's) on rows without NaN and without
both signed zeros, where the two orders agree. K8 (in
bfloat16 on the tensor cores, p·v with p split into three bf16 terms) per
row within the fp32 summation bound of two orders,
``(D·eps·scale·max_j Σ_d|q_id·k_jd| + sk·eps)·2·max|v|``, and in
bfloat16 that bound plus one bfloat16 ulp (chip_smoke.attn_misses). The
server on reduced Kimi-K2 (float32): logits within 1e-4 of their largest
|value| and equal greedy tokens.
"""
import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the ISA
from repro_torch.configs import get_config
from repro_torch.core import isa
from repro_torch.kernels import _cuda
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topk as tk
from repro_torch.kernels.prefix_scan import K3
from repro_torch.launch import serve
from repro_torch.models import model as M

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 and K8 are CUDA kernels with "
                    "no CPU mode (their plain versions are tested in "
                    "test_torch_topk / test_torch_flashattn)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_lm",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def keys(shape, dtype, seed, dev, ties=False):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32 or ties:
        hi = 4 if ties else 10_000
        x = torch.from_numpy(rng.integers(-hi, hi, shape).astype(np.int32))
        return x.to(dev, dtype)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dev, dtype)


def same_bits(a, b):
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("ties", [False, True, "special"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [8, 64, 512, 4096, 8192])
def test_k7_matches_plain_and_oracle(cuda, smoke, n, dtype, ties):
    # k ≤ 32 takes the partial walk, k > 32 the full network (n ≤ 4096);
    # "special": ±0.0 and NaN of either sign, against the oracle only
    if ties == "special" and dtype == "int32":
        x = keys((37, n), torch.int32, n, cuda, True)
    elif ties == "special":
        x = smoke.special_topk_rows(n, (37, n), DTYPES[dtype], cuda)
    else:
        x = keys((37, n), DTYPES[dtype], n, cuda, ties)
    for k in sorted({1, 8, 32, 40, n}):
        if k > n or (k > tk.MAX_PARTIAL_K and n > tk.MAX_WIDTH):
            continue
        vals, idx = tk.topk_kernel(x, k)
        wants = [ref.topk(x, k)]
        if ties != "special":
            wants.append(tk.topk_plain(x, k))
        for want in wants:
            assert same_bits(vals, want[0]) and torch.equal(idx, want[1])
        assert idx.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("cols", [384, 5, 100])
def test_k7_reads_rows_in_place(cuda, cols, dtype):
    # rows of n standing for rows of npow: as the padded copy, with rows
    # strided (stride 387: key-by-key loads) and not, on both routes
    npow = 1 << (cols - 1).bit_length()
    wide = keys((50, 387), DTYPES[dtype], cols, cuda)
    for k in (k for k in (1, 8, 32, 40) if k <= npow):
        for x in (wide[:, :cols], wide[:, :cols].contiguous()):
            vals, idx = tk.K7(x, k, npow)
            want = ref.topk(tk.pad_to(x, npow), k)
            assert same_bits(vals, want[0]) and torch.equal(idx, want[1])


def test_k7_router_shape_through_the_isa(cuda):
    x = keys((4096, 384), torch.float32, 0, cuda)
    tk.K7.launches = 0
    v, i = ops.topk(x, 8)                       # auto → K7 on CUDA, in place
    assert tk.K7.launches == 1
    w = ref.topk(tk.pad_to(x, 512), 8)
    assert torch.equal(v, w[0]) and torch.equal(i, w[1])
    pv, pi = ops.topk(x, 8, mode="interpret")
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_k7_rejects_what_it_does_not_take(cuda):
    # k ≤ 32 at n 8192 is served (the partial walk); k > 32 is not
    assert tk.topk_kernel(torch.zeros(2, 8192, device=cuda), 32)[1].shape \
        == (2, 32)
    with pytest.raises(ValueError, match="at most 4096"):
        tk.topk_kernel(torch.zeros(2, 8192, device=cuda), 33)
    with pytest.raises(ValueError, match="k=9"):
        tk.topk_kernel(torch.zeros(2, 8, device=cuda), 9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (100, 230), (64, 512)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_k8_within_the_summation_bound(cuda, smoke, d, causal, sq, sk,
                                       dtype):
    rng = np.random.default_rng(d + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, s, d),
                                                    dtype=np.float32))
               .to(cuda, DTYPES[dtype]) for s in (sq, sk, sk))
    got = fa.K8(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    bound = smoke.attn_bound(q, k, v)
    for want in (fa.flash_attention_plain(q, k, v, causal=causal),
                 ref.flash_attention(q, k, v, causal=causal)):
        assert smoke.attn_misses(got, want, bound)[0] == 0


def test_k8_reads_strided_heads_in_place(cuda):
    # the model's (B, S, H, D) activations, viewed as (B, H, S, D)
    x = keys((2, 200, 6, 3, 64), torch.bfloat16, 1, cuda)
    q, k, v = (x[:, :, :, i].transpose(1, 2) for i in range(3))
    got = fa.K8(q, k, v)
    assert got.transpose(1, 2).is_contiguous()
    want = fa.K8(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_k8_bf16_copies_an_operand_tma_cannot_read(cuda, smoke, d):
    # k's seq stride of d + 1 elements is no whole number of 16-byte units,
    # so the wrapper copies it once (inside K8, counted) for TMA
    rng = np.random.default_rng(d)
    q, v = (torch.from_numpy(rng.standard_normal((2, 3, 130, d),
                                                 dtype=np.float32))
            .to(cuda, torch.bfloat16) for _ in range(2))
    wide = torch.from_numpy(rng.standard_normal(
        (2, 3, 130, d + 1), dtype=np.float32)).to(cuda, torch.bfloat16)
    k = wide[..., :d]
    assert not fa.tma_aligned(k) and fa.tma_aligned(q)
    copies, launches = fa.K8.aligned_copies, fa.K8.launches
    got = fa.K8(q, k, v)
    assert fa.K8.aligned_copies == copies + 1
    assert fa.K8.launches == launches + 1
    bound = smoke.attn_bound(q, k, v)
    for want in (fa.flash_attention_plain(q, k, v),
                 ref.flash_attention(q, k, v)):
        assert smoke.attn_misses(got, want, bound)[0] == 0


def test_k8_launches_once_per_call(cuda):
    x = keys((2, 4, 300, 64), torch.bfloat16, 2, cuda)
    before = fa.K8.launches
    for i in range(3):
        fa.K8(x, x, x)
        assert fa.K8.launches == before + i + 1
    with isa.use("auto"):
        ops.flash_attention(x, x, x)
    assert fa.K8.launches == before + 4


def test_k8_unit_scale_check_rejects_two_terms_of_p(cuda, smoke, tmp_path,
                                                    monkeypatch):
    # chip_smoke's check at the prefill's shape with unit-scale logits
    # passes K8 and fails the same kernel with p in two bf16 terms (built
    # from a copy of the source with the third term zeroed)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (4, 64, 1024, 128), dtype=np.float32)).to(cuda, torch.bfloat16)
        for _ in range(3))
    plain = fa.flash_attention_plain(q, k, v)
    verdicts = []
    for terms in (3, 2):
        if terms == 2:
            src = (_cuda.CSRC / "flashattn.cu").read_text()
            third = "a3[r] = pack_bf16(x0, x1);"
            assert src.count(third) == 1
            shutil.copytree(_cuda.CSRC, tmp_path / "csrc")
            (tmp_path / "csrc" / "flashattn.cu").write_text(
                src.replace(third, "a3[r] = 0u;"))
            monkeypatch.setattr(_cuda, "CSRC", tmp_path / "csrc")
            monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
            monkeypatch.delitem(_cuda._LOADED, "flashattn")
        check = smoke.Check()
        smoke.hold_f64(check, f"K8, {terms} terms", q, k, v, fa.K8(q, k, v),
                       plain, noise=smoke.UNIT_SCALE_NOISE)
        verdicts.append(check.failures)
    assert verdicts[0] == []
    assert len(verdicts[1]) == 1 and "more than the plain" in verdicts[1][0]


def test_k8_checks_on_card(cuda):
    q = torch.zeros(1, 1, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.K8(q, q, q)
    q = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="no visible key"):
        fa.K8(q, q[:, :, :4], q[:, :, :4])


def test_generate_kernel_path_against_plain_path(cuda):
    cfg = dataclasses.replace(get_config("kimi_k2_1t").reduced(),
                              n_experts=384, top_k=8, attn_impl="kernel",
                              capacity_factor=8.0)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 128))).to(cuda)
    K3.launches = tk.K7.launches = fa.K8.launches = 0
    with isa.use("auto"):
        got = serve.generate(cfg, params, prompts, 8)[0]
        logits, _ = M.prefill(cfg, params, {"tokens": prompts})
    assert (K3.launches, tk.K7.launches, fa.K8.launches) == (18, 18, 4)
    with isa.use("interpret"):
        want = serve.generate(cfg, params, prompts, 8)[0]
        plain, _ = M.prefill(cfg, params, {"tokens": prompts})
    assert torch.equal(got, want)
    err = float((logits - plain).abs().max() / plain.abs().max())
    assert err <= 1e-4, err


# ---------------------------------------------------------------------------
# under autograd on the card: K7's gradient, and a train step through the
# kernels against the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((4096, 384), 8), ((4, 384), 8),
                                     ((64, 40), 40)])
def test_k7_grad_is_the_scatter_of_the_oracle(cuda, shape, k):
    x = keys(shape, torch.float32, 3, cuda).requires_grad_()
    g = keys((shape[0], k), torch.float32, 4, cuda)
    tk.K7.launches = 0
    vals, idx = ops.topk(x, k, mode="kernel")
    assert tk.K7.launches == 1
    (got,) = torch.autograd.grad(vals, x, g)
    _, want_idx = ref.topk(x.detach(), k)
    want = torch.zeros_like(x).scatter_(-1, want_idx.long(), g)
    assert torch.equal(got, want)
    (plain,) = torch.autograd.grad(ops.topk(x, k, mode="interpret")[0], x, g)
    assert torch.equal(got, plain)


def test_kimi_train_step_kernel_is_ref_bit_for_bit(cuda):
    # K7 and K3 are exact against their oracles, so the grads are too
    from repro_torch.launch import api
    from repro_torch.models import params as tparams
    from repro_torch.optim.optimizers import tree_leaves
    cfg = dataclasses.replace(get_config("kimi_k2_1t").reduced(),
                              capacity_factor=8.0)
    params = tparams.init_params(cfg, torch.Generator(device=cuda)
                                 .manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))
                                 .astype(np.int32)).to(cuda)
             for k in ("tokens", "targets")}
    grads = {}
    for mode in ("kernel", "ref"):
        tk.K7.launches = K3.launches = 0
        with isa.use(mode):
            grads[mode], _ = api.make_grad_fn(cfg)(params, batch)
        # remat full: each layer's router runs twice (forward and the
        # recompute, which keeps the forward's mode on autograd's thread)
        want = 2 * cfg.n_layers if mode == "kernel" else 0
        assert tk.K7.launches == K3.launches == want
    for a, b in zip(tree_leaves(grads["kernel"]), tree_leaves(grads["ref"])):
        assert torch.equal(a, b)

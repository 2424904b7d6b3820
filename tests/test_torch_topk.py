"""repro_torch's c5_topk (the MoE router's top-k) against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its ``lax.top_k`` oracle) and ``repro_torch``
(the plain network K7 is held against, in ``interpret`` mode, and its
stable-sort oracle). Top-k is exact, ties included (equal keys in
ascending index order), so every comparison is bit-exact. bfloat16
inputs are float32 values that bfloat16 represents exactly.

K7 itself runs only on the card (tests/test_torch_lm_kernels.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.core import isa as jisa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import isa
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import topk as tk

RNG = np.random.default_rng(42)
JNP = {"float32": jnp.float32, "int32": jnp.int32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "int32": torch.int32,
         "bfloat16": torch.bfloat16}
SHAPES = [(1, 8, 2), (16, 384, 8), (32, 8, 2), (8, 512, 16), (4, 151, 5)]


def arr(shape, dtype):
    if dtype == "int32":
        return RNG.integers(-10_000, 10_000, shape).astype(np.int32)
    x = RNG.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def same_topk(got, want):
    (v, i), (wv, wi) = got, want
    np.testing.assert_array_equal(as_np(v), as_np(wv))
    np.testing.assert_array_equal(as_np(i), as_np(wi))
    assert i.dtype == torch.int32


@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("rows,n,k", SHAPES)
def test_topk_matches_jax(rows, n, k, dtype, mode):
    x = arr((rows, n), dtype)
    want = (jops.topk(jnp.asarray(x, JNP[dtype]), k, mode="interpret")
            if mode == "interpret" else jref.topk(jnp.asarray(x, JNP[dtype]), k))
    got = ops.topk(torch.from_numpy(x).to(TORCH[dtype]), k, mode=mode)
    same_topk(got, want)


@pytest.mark.parametrize("mode", ["interpret", "ref"])
def test_topk_ties_in_ascending_index_order(mode):
    x = np.zeros((4, 16), np.float32)
    x[1, ::3] = 1.0                      # ties at the top and below it
    x[2] = np.repeat(np.arange(4, dtype=np.float32), 4)
    got = ops.topk(torch.from_numpy(x), 4, mode=mode)
    same_topk(got, jops.topk(jnp.asarray(x), 4, mode="interpret"))
    same_topk(got, jref.topk(jnp.asarray(x), 4))
    assert got[1][0].tolist() == [0, 1, 2, 3]


def test_topk_plain_matches_oracle_on_many_ties():
    x = torch.from_numpy(RNG.integers(0, 3, (64, 512)).astype(np.float32))
    same_topk(tk.topk_plain(x, 40), ref.topk(x, 40))


@pytest.mark.parametrize("dtype,fill", [
    ("float32", torch.finfo(torch.float32).min),
    ("bfloat16", torch.finfo(torch.bfloat16).min),
    ("int32", torch.iinfo(torch.int32).min),
])
def test_topk_pads_to_a_power_of_two_with_the_dtype_minimum(dtype, fill):
    # k > n: the padded lanes come out, so their value shows
    x = arr((3, 5), dtype)
    got = ops.topk(torch.from_numpy(x).to(TORCH[dtype]), 8, mode="interpret")
    same_topk(got, jops.topk(jnp.asarray(x, JNP[dtype]), 8,
                             mode="interpret"))
    assert (got[0][:, 5:].float() == float(fill)).all()
    assert got[1][:, 5:].tolist() == [[5, 6, 7]] * 3


def test_topk_leading_axes_and_route_shape():
    x = arr((2, 3, 384), "float32")
    v, i = ops.topk(torch.from_numpy(x), 8, mode="interpret")
    wv, wi = jops.topk(jnp.asarray(x), 8, mode="interpret")
    assert v.shape == i.shape == (2, 3, 8)
    same_topk((v, i), (wv, wi))


def test_c5_registration_mirrors_the_jax_spec():
    for name in ("c5_topk", "c6_flashattn"):
        got, want = isa.get(name), jisa.get(name)
        assert got.spec == type(got.spec)(**vars(want.spec))
        assert got.pipeline_depth == want.pipeline_depth
        assert got.doc == want.doc


def test_topk_checks():
    x = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="power of two"):
        tk.topk_kernel(x, 2, interpret=True)
    with pytest.raises(ValueError, match="k=9"):
        tk.topk_kernel(torch.zeros(2, 8), 9, interpret=True)
    with pytest.raises(ValueError, match="at most 4096"):
        tk.topk_kernel(torch.zeros(1, 8192), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.topk(torch.zeros(2, 8), 2, mode="kernel")
    with pytest.raises(ValueError, match="float32, int32 or bfloat16"):
        tk.K7(torch.zeros(2, 8, dtype=torch.float16), 2)
    assert tk.K7.launches == 0


def test_cuda_source_exports_the_bound_launcher():
    src = (_cuda.CSRC / "topk.cu").read_text()
    for name, argtypes in tk._SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes)
    assert "repro_cuda_error_string" in src
    assert "__shfl_xor_sync" in src and "__syncthreads" in src


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    for f in _cuda.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda.library_path("topk")
    header = tmp_path / "bitonic_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda.library_path("topk") != before
    assert '#include "bitonic_tile.cuh"' in (tmp_path / "topk.cu").read_text()

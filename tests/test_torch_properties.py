"""Hypothesis twins of tests/test_properties.py on the port.

The eight properties, each on the port's ``ref`` and ``interpret``
dispatch where the operation has modes (the sort and merge
instructions beside their networks, prefix sum, chunk scan, top-k);
top-k against ``lax.top_k``, the data pipeline's stream and the burst
model under the converted reference preset against the JAX package's.
Examples are capped (``max_examples``) so the file stays well under
20 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed; "
                    "property tests are exercised in CI")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.burst_model import TPU_V5E_HBM  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401 — registers the port's ISA
from repro_torch.core.burst_model import H100_HBM, BurstModel  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    dequantize_blockwise, quantize_blockwise)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sortnet import (  # noqa: E402
    bitonic_merge_network, bitonic_sort_network)

SETTINGS = dict(max_examples=20, deadline=None)
MODES = ("ref", "interpret")
#: the reference's TPU burst model, converted field by field (the port
#: carries no TPU preset)
TPU_AS_PORT = BurstModel(peak_bw=TPU_V5E_HBM.peak_bw,
                         overhead_s=TPU_V5E_HBM.overhead_s)


@st.composite
def rows_pow2(draw, max_log=7):
    rows = draw(st.integers(1, 6))
    w = 2 ** draw(st.integers(1, max_log))
    data = draw(st.lists(
        st.floats(-1e6, 1e6, allow_nan=False, width=32),
        min_size=rows * w, max_size=rows * w))
    x = np.asarray(data, np.float32).reshape(rows, w)
    # the reference's XLA-CPU comparisons flush denormals to zero:
    # normalise them so every order agrees
    x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    return x


@given(rows_pow2())
@settings(**SETTINGS)
def test_sort_network_sorts_and_permutes(x):
    """Output is (a) sorted, (b) a permutation of the input — per row, in
    the network and both dispatch modes of c2_sort."""
    want = np.sort(x, axis=-1)
    out = bitonic_sort_network(torch.from_numpy(x)).numpy()
    assert np.all(np.diff(out, axis=-1) >= 0)
    np.testing.assert_array_equal(out, want)
    for mode in MODES:
        got = ops.sort_chunks(torch.from_numpy(x), width=x.shape[1],
                              mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


@given(rows_pow2(max_log=6))
@settings(**SETTINGS)
def test_merge_network_merges(x):
    """Concat(sorted a, reversed sorted b) is bitonic → merge sorts it;
    c1_merge of the two sorted halves gives the sorted row's halves."""
    w = x.shape[1]
    a = np.sort(x[:, :w // 2], axis=-1)
    b = np.sort(x[:, w // 2:], axis=-1)
    bit = np.concatenate([a, b[:, ::-1]], axis=-1)
    want = np.sort(x, axis=-1)
    out = bitonic_merge_network(torch.from_numpy(bit.copy())).numpy()
    np.testing.assert_array_equal(out, want)
    for mode in MODES if w >= 4 else ():        # c1_merge: halves of ≥ 2
        lo, hi = ops.merge_sorted(torch.from_numpy(a), torch.from_numpy(b),
                                  width=w // 2, mode=mode)
        np.testing.assert_array_equal(
            np.concatenate([lo.numpy(), hi.numpy()], axis=-1), want)


@given(st.integers(1, 4), st.integers(1, 9), st.data())
@settings(**SETTINGS)
def test_prefix_sum_linearity(rows, logn, data):
    """prefix(αx + y) == α·prefix(x) + prefix(y) (scan is linear)."""
    n = 2 ** logn
    x = np.asarray(data.draw(st.lists(
        st.floats(-100, 100, width=32), min_size=rows * n,
        max_size=rows * n)), np.float32).reshape(rows, n)
    y = np.roll(x, 1, axis=-1)
    a = 2.0
    for mode in MODES:
        lhs = ops.prefix_sum(torch.from_numpy(a * x + y), mode=mode)
        rhs = (a * ops.prefix_sum(torch.from_numpy(x), mode=mode)
               + ops.prefix_sum(torch.from_numpy(y), mode=mode))
        np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4,
                                   atol=1e-3)


@given(st.integers(2, 64), st.integers(1, 16))
@settings(**SETTINGS)
def test_chunkscan_composition(cols, rows):
    """Carried scan over [x ; y] == scan y with carry from scan x — the
    paper's 'cumulative sum of the previous batch' invariant."""
    rng = np.random.default_rng(cols * 131 + rows)
    a = rng.uniform(0.3, 1.0, (rows, 2 * cols)).astype(np.float32)
    b = rng.standard_normal((rows, 2 * cols)).astype(np.float32)
    a2cum = np.cumprod(a[:, cols:], axis=-1)
    for mode in MODES:
        def scan(aa, bb):
            return ops.chunk_scan(torch.from_numpy(np.ascontiguousarray(aa)),
                                  torch.from_numpy(np.ascontiguousarray(bb)),
                                  mode=mode).numpy()
        full = scan(a, b)
        carry = scan(a[:, :cols], b[:, :cols])[:, -1:]
        second = scan(a[:, cols:], b[:, cols:])
        np.testing.assert_allclose(full[:, cols:], second + a2cum * carry,
                                   rtol=2e-3, atol=2e-3)


@given(st.integers(1, 2048))
@settings(**SETTINGS)
def test_quantization_error_bounded(n):
    """int8 blockwise quantisation error ≤ scale/2 = absmax/254."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(256 * ((n + 255) // 256)).astype(np.float32)
    q, s = quantize_blockwise(torch.from_numpy(x))
    back = dequantize_blockwise(q, s).numpy()
    bound = np.repeat(s.numpy()[:, 0], 256) / 2 + 1e-7
    assert np.all(np.abs(back - x) <= bound)


@given(st.floats(1e6, 1e12), st.floats(1e-9, 1e-3))
@settings(**SETTINGS)
def test_burst_model_monotone(bw, ovh):
    blocks = [2 ** i for i in range(4, 24)]
    for m in (BurstModel(peak_bw=bw, overhead_s=ovh), H100_HBM,
              TPU_AS_PORT):
        effs = [m.effective_bw(b) for b in blocks]
        assert all(e2 >= e1 for e1, e2 in zip(effs, effs[1:]))
        assert effs[-1] <= m.peak_bw
    assert [TPU_AS_PORT.effective_bw(b) for b in blocks] == [
        TPU_V5E_HBM.effective_bw(b) for b in blocks]


@given(st.integers(0, 100_000))
@settings(**SETTINGS)
def test_data_pipeline_deterministic_and_resumable(step):
    """batch(step) is a pure function — restart reproduces the stream,
    the reference's stream."""
    from repro.data import SyntheticLMData as JData
    from repro_torch.data import SyntheticLMData
    d1 = SyntheticLMData(vocab=512, seq_len=16, global_batch=4, seed=7)
    d2 = SyntheticLMData(vocab=512, seq_len=16, global_batch=4, seed=7)
    b1, b2 = d1.host_batch(step), d2.host_batch(step)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # autoregressive alignment invariant
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    want = JData(vocab=512, seq_len=16, global_batch=4, seed=7).host_batch(
        step)
    np.testing.assert_array_equal(b1["tokens"], want["tokens"])
    np.testing.assert_array_equal(b1["targets"], want["targets"])


@given(st.integers(1, 6), st.integers(2, 5))
@settings(max_examples=15, deadline=None)
def test_topk_agrees_with_lax(rows, k):
    rng = np.random.default_rng(rows * 7 + k)
    x = rng.standard_normal((rows, 32)).astype(np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    for mode in MODES:
        v, i = ops.topk(torch.from_numpy(x), k, mode=mode)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))

"""repro_torch's carried scans (c3_prefixsum, c4_chunkscan, c4_statescan)
against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its jnp oracles) and ``repro_torch`` (the plain
blocked walk K3/K4 are held against, in ``interpret`` mode, and its
torch oracles). The two packages sum in different orders (the port's
column block is its own), so the scans agree within the JAX tests' own
tolerances: rtol 2e-5 / atol 1e-4 for the prefix sum, 2e-4 for the
affine scans.

The Triton kernels themselves run only on the card
(tests/test_torch_scan_sort_kernels.py).
"""
import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.kernels import ops as jops
from repro.kernels import prefix_scan as jps
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import prefix_scan as ps

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)
PREFIX_TOL = dict(rtol=2e-5, atol=1e-4)
AFFINE_TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's associative-scan oracles, compiled once per shape rather
# than op by op (eagerly they take seconds a shape on the CPU)
jref_chunk_scan = jax.jit(jref.chunk_scan)
jref_chunk_scan_state = jax.jit(jref.chunk_scan_state,
                                static_argnames="axis")


def normal(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def decay(shape):
    return RNG.uniform(0.2, 1.0, shape).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------------------
# c3_prefixsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8), (4, 128), (8, 1024), (3, 4096),
                                   (2, 10_000), (37, 300)])
def test_prefix_sum_matches_jax(shape):
    x = normal(shape)
    want = np.cumsum(x, axis=-1)
    if shape[1] <= 4096:      # the reference's kernel needs whole blocks
        close(jops.prefix_sum(jnp.asarray(x), mode="interpret"), want,
              PREFIX_TOL)
    got = ops.prefix_sum(torch.from_numpy(x), mode="interpret")
    close(got, want, PREFIX_TOL)
    close(got, jref.prefix_sum(jnp.asarray(x)), PREFIX_TOL)
    close(ops.prefix_sum(torch.from_numpy(x), mode="ref"), want, PREFIX_TOL)


def test_exclusive_prefix_sum_matches_jax():
    x = normal((4, 64))
    want = jops.exclusive_prefix_sum(jnp.asarray(x), mode="interpret")
    for mode in ("interpret", "ref"):
        close(ops.exclusive_prefix_sum(torch.from_numpy(x), mode=mode), want,
              PREFIX_TOL)


def test_serial_prefix_sum_matches_jax():
    x = normal((3, 40))
    got = ref.serial_prefix_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.serial_prefix_sum(
                                      jnp.asarray(x))))


def test_hillis_steele_block_is_the_references():
    x = normal((8, 512))
    np.testing.assert_array_equal(
        ps._hs_shift_add(torch.from_numpy(x)).numpy(),
        np.asarray(jps._hs_shift_add(jnp.asarray(x))))
    a, b = decay((8, 512)), normal((8, 512))
    ta, tb = ps._affine_hs(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jps._affine_hs(jnp.asarray(a), jnp.asarray(b))
    close(ta, ja, dict(rtol=1e-6, atol=1e-6))
    close(tb, jb, dict(rtol=1e-6, atol=1e-6))


def test_blocked_walk_matches_the_reference_kernel_at_its_block():
    # the same column block in both: the same Hillis–Steele steps and the
    # same carried totals, only the order of the carry's sum may differ
    x = normal((8, 2048))
    want = jps.prefix_sum_pallas(jnp.asarray(x), block_cols=512,
                                 interpret=True)
    close(ps.prefix_sum_plain(torch.from_numpy(x), 512), want,
          dict(rtol=1e-6, atol=1e-5))
    a, b = decay((8, 2048)), normal((8, 2048))
    want = jps.chunk_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                 block_cols=512, interpret=True)
    close(ps.chunk_scan_plain(torch.from_numpy(a), torch.from_numpy(b), 512),
          want, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# c4_chunkscan / c4_statescan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 16), (4, 256), (8, 1024), (3, 5000)])
def test_chunk_scan_matches_jax(shape):
    a, b = decay(shape), normal(shape)
    want = jref_chunk_scan(jnp.asarray(a), jnp.asarray(b))
    if shape[1] <= 4096:
        close(jops.chunk_scan(jnp.asarray(a), jnp.asarray(b),
                              mode="interpret"), want, AFFINE_TOL)
    for mode in ("interpret", "ref"):
        close(ops.chunk_scan(torch.from_numpy(a), torch.from_numpy(b),
                             mode=mode), want, AFFINE_TOL)


def test_chunk_scan_matches_sequential():
    a, b = decay((2, 64)), normal((2, 64))
    got = ops.chunk_scan(torch.from_numpy(a), torch.from_numpy(b),
                         mode="interpret").numpy()
    y = np.zeros(2)
    for i in range(64):
        y = a[:, i] * y + b[:, i]
        np.testing.assert_allclose(got[:, i], y, **AFFINE_TOL)


def test_chunk_scan_promotes_like_jax():
    a = torch.full((2, 32), 0.5, dtype=torch.bfloat16)
    b = torch.from_numpy(normal((2, 32)))
    want = jref_chunk_scan(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                           jnp.asarray(b.numpy()))
    for fn in (ref.chunk_scan,
               lambda a, b: ops.chunk_scan(a, b, mode="interpret")):
        got = fn(a, b)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        close(got, want, AFFINE_TOL)


@pytest.mark.parametrize("a_shape,axis", [((2, 8, 4), 1), ((8, 4), 0)])
def test_chunk_scan_state_matches_jax_at_ssd_rank(a_shape, axis):
    # SSD's layout: a (B, C, H), states (B, C, H, P, N), scan along C
    a = np.exp(-np.abs(normal(a_shape)))
    s = normal(a_shape + (3, 5))
    ja, js = jnp.asarray(a), jnp.asarray(s)
    want = jops.chunk_scan_state(ja, js, axis=axis, mode="interpret")
    close(jref_chunk_scan_state(ja, js, axis=axis), want, AFFINE_TOL)
    ta, ts = torch.from_numpy(a), torch.from_numpy(s)
    for mode in ("interpret", "ref"):
        got = ops.chunk_scan_state(ta, ts, axis=axis, mode=mode)
        assert got.shape == ts.shape
        close(got, want, AFFINE_TOL)


def test_chunk_scan_state_negative_axis_follows_each_reference_path():
    # The reference's two paths read a negative axis differently: the
    # oracle counts it on a (here the chunk axis), the kernel path on the
    # states (here the P axis). The port keeps each path as it is.
    a = np.exp(-np.abs(normal((2, 8, 4))))
    s = normal((2, 8, 4, 3, 5))
    ja, js = jnp.asarray(a), jnp.asarray(s)
    ta, ts = torch.from_numpy(a), torch.from_numpy(s)
    close(ops.chunk_scan_state(ta, ts, axis=-2, mode="ref"),
          jref_chunk_scan_state(ja, js, axis=-2), AFFINE_TOL)
    close(ops.chunk_scan_state(ta, ts, axis=-2, mode="interpret"),
          jops.chunk_scan_state(ja, js, axis=-2, mode="interpret"),
          AFFINE_TOL)


# ---------------------------------------------------------------------------
# wrappers, dispatch, the Triton source
# ---------------------------------------------------------------------------

def test_kernel_mode_on_cpu_tensors_raises():
    x = torch.from_numpy(normal((2, 64)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.prefix_sum(x, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.chunk_scan(x, x, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.chunk_scan_state(x[:, :8], x.reshape(2, 8, 8), mode="kernel")
    with pytest.raises(ValueError, match="floating-point"):
        ps.prefix_sum_kernel(x.int())
    with pytest.raises(ValueError, match="must match"):
        ps.chunk_scan_kernel(x, x[:, :8], interpret=True)
    assert torch.equal(ops.prefix_sum(x, mode="auto"), ref.prefix_sum(x))


@pytest.mark.parametrize("rows,cols,want", [
    (1, 1 << 26, (1, 4096)), (2_097_152, 32, (128, 32)), (3, 5000, (1, 4096)),
    (37, 300, (8, 512)), (1, 1, (1, 1))])
def test_block_shape(rows, cols, want):
    assert ps.block_shape(rows, cols) == want


def test_scan_registrations_mirror_jax():
    from repro.core import isa as jisa
    from repro_torch.core import isa
    for name in ("c3_prefixsum", "c4_chunkscan", "c4_statescan"):
        got, want = isa.get(name), jisa.get(name)
        assert got.spec == type(got.spec)(**vars(want.spec))
        assert got.pipeline_depth == want.pipeline_depth
        assert got.doc == want.doc
        assert got.template is None and want.template is None


def test_triton_source_defines_k3_and_k4():
    tree = ast.parse(ps.TRITON_SOURCE)
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"_affine", "k3_prefix_sum", "k4_chunk_scan"} <= set(fns)
    for fn in fns.values():
        assert [ast.unparse(d) for d in fn.decorator_list] == ["triton.jit"]


# ---------------------------------------------------------------------------
# chip_smoke.py's phases F and G at tiny size, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_scan",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_phase_f_matches_jax(smoke):
    (x,) = smoke.make_inputs(6, [1 << 14], "cpu")
    got = smoke.phase_f(x, "interpret")
    want = jops.prefix_sum(jnp.asarray(x.numpy())[None], mode="interpret")[0]
    close(got, want, PREFIX_TOL)
    bc = ps.block_shape(1, x.numel())[1]
    bad, _ = smoke.prefix_bound_misses(got, torch.cumsum(x.double(), 0),
                                       torch.cumsum(x.abs().double(), 0),
                                       bc, step=1000)
    assert bad == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_f(x, "kernel")


def test_smoke_phase_g_matches_jax(smoke):
    a, s = smoke.ssd_inputs(7, (2, 8, 4), (3, 5), "cpu")
    got = smoke.phase_g(a, s, "interpret")
    want = jops.chunk_scan_state(jnp.asarray(a.numpy()),
                                 jnp.asarray(s.numpy()), axis=1,
                                 mode="interpret")
    close(got, want, AFFINE_TOL)
    bad, _ = smoke.statescan_bound_misses(got, a, s,
                                          ps.block_shape(s.numel() // 8, 8)[1])
    assert bad == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_g(a, s, "kernel")


def test_smoke_phase_f_bound_rejects_a_broken_carry(smoke):
    # the gate phase F holds K3 to must fail a scan whose carry is lost
    # part-way along the row, or whose tail is left unwritten
    n = 1 << 18
    (x,) = smoke.make_inputs(6, [n], "cpu")
    bc = 4096
    good = ps.prefix_sum_plain(x[None], bc)[0]
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    assert smoke.prefix_bound_misses(good, ref64, abs64, bc)[0] == 0
    reset = good.clone()
    reset.view(-1, bc)[16:] -= good.view(-1, bc)[15, -1]
    zeros = good.clone()
    zeros[n // 4:] = 0
    for broken in (reset, zeros):
        assert smoke.prefix_bound_misses(broken, ref64, abs64, bc)[0] > 0

"""repro_torch's carried scans (c3_prefixsum, c4_chunkscan, c4_statescan)
against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its jnp oracles) and ``repro_torch`` (the plain
blocked walk K3/K4 are held against, in ``interpret`` mode, and its
torch oracles). The two packages sum in different orders (the port's
column block is its own), so the scans agree within the JAX tests' own
tolerances: rtol 2e-5 / atol 1e-4 for the prefix sum, 2e-4 for the
affine scans.

The kernels themselves run only on the card
(tests/test_torch_scan_sort_kernels.py).
"""
import ast
import math
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.core.isa
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.kernels import ops as jops
from repro.kernels import prefix_scan as jps
from repro.kernels import ref as jref
from repro_torch.kernels import _cuda, ops, ref
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
    # K3 and K4 are CUDA C++ in one source (csrc/prefix_scan.cu), each
    # launcher's C signature as its ctypes one; K4's rows entry past
    # K4_FOLD_COLS columns keeps the former Gluon kernel
    tree = ast.parse(ps.GLUON_SOURCE)
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert set(fns) == {"_affine", "_scan_block", "k4_chunk_scan"}
    for fn in fns.values():
        assert [ast.unparse(d) for d in fn.decorator_list] == ["gluon.jit"]
    src = (_cuda.CSRC / "prefix_scan.cu").read_text()
    for name, argtypes in {**ps._K3_SIGNATURES,
                           **ps._K4_SIGNATURES}.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src, re.S)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes)
    assert "repro_cuda_error_string" in src
    assert "atomicAdd" in src and "__ballot_sync" in src      # look-back
    assert "k3_walk_kernel" in src                             # walk
    for kernel in ("k4_state_kernel", "k4_rows_kernel", "k4_da_kernel"):
        assert f"{kernel}(" in src


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
                                       bc, *ps.walk_bound_constants(
                                           x.numel()), step=1000)
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
    bad, _ = smoke.statescan_bound_misses(got, a, s)
    assert bad == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_g(a, s, "kernel")


def test_smoke_statescan_hold_rejects_a_wrong_decay(smoke):
    # the hold J and K give K4 at their path's shape must pass the walk
    # and fail a scan that reads the next chunk's decay or drops the carry
    a, s = smoke.ssd_inputs(22, (2, 8, 4), (5, 16), "cpu")
    good = smoke.phase_g(a, s, "interpret")
    check = smoke.Check()
    assert smoke.hold_statescan(check, "walk", good, good, a, s) < 1e-5
    assert check.failures == []
    shifted_a = torch.roll(a, 1, dims=1)
    no_carry = s.clone()
    for bad in (smoke.phase_g(shifted_a, s, "interpret"), no_carry):
        check = smoke.Check()
        smoke.hold_statescan(check, "broken", bad, good, a, s)
        assert len(check.failures) == 2      # the bound and K4 == plain


def broken_carries(good: torch.Tensor, bc: int) -> list[torch.Tensor]:
    """A scan whose carry is lost part-way along the row, and one whose
    tail is left unwritten."""
    reset = good.clone()
    reset.view(-1, bc)[16:] -= good.view(-1, bc)[15, -1]
    zeros = good.clone()
    zeros[good.numel() // 4:] = 0
    return [reset, zeros]


def broken_state_scan_grad(kind):
    """c4_statescan's backward with one fault: the adjoint's carry
    dropped, da dropped, or the reverse walk on the unshifted decay."""
    real = ps.state_scan_grad

    def carry_dropped(a, y, g, axis, interpret=False):
        return real(torch.zeros_like(a), y, g, axis, interpret)

    def da_dropped(a, y, g, axis, interpret=False):
        da, ds = real(a, y, g, axis, interpret)
        return torch.zeros_like(da), ds

    def unshifted(a, y, g, axis, interpret=False):
        lam = ps.chunk_scan_state_kernel(a, g, axis, interpret, reverse=True)
        return ps._prev_product(lam, y, axis % y.ndim, a.ndim), lam

    return {"carry dropped": carry_dropped, "da dropped": da_dropped,
            "unshifted decay": unshifted}[kind]


def statescan_grads(smoke, seed, modes=("interpret", "ref")):
    a, s = smoke.ssd_inputs(seed, (2, 12, 4), (5, 16), "cpu")
    g = smoke.ssd_inputs(seed + 1, (2, 12, 4), (5, 16), "cpu")[1]
    grads = {}
    for mode in modes:
        ar, sr = a.clone().requires_grad_(), s.clone().requires_grad_()
        y = ops.chunk_scan_state(ar, sr, axis=1, mode=mode)
        grads[mode] = torch.autograd.grad(y, (ar, sr), g)
    return grads, a, s, g


def test_smoke_statescan_grad_hold_passes_the_backward(smoke):
    # phase L's hold of c4_statescan's backward: the plain walk's
    # gradients and the oracle's autograd both within its bounds
    grads, a, s, g = statescan_grads(smoke, 24)
    bad, worst = smoke.statescan_grad_misses(grads, a, s, g)
    assert set(bad) == {"interpret ds", "interpret da", "ref ds", "ref da",
                        "|ds interpret - ref|", "|da interpret - ref|"}
    assert not any(bad.values()), bad
    assert max(worst.values()) < 1e-4


@pytest.mark.parametrize("kind", ["carry dropped", "da dropped",
                                  "unshifted decay"])
def test_smoke_statescan_grad_hold_rejects_a_broken_backward(
        smoke, monkeypatch, kind):
    monkeypatch.setattr(ps, "state_scan_grad", broken_state_scan_grad(kind))
    grads, a, s, g = statescan_grads(smoke, 26)
    bad, _ = smoke.statescan_grad_misses(grads, a, s, g)
    assert bad["interpret ds"] + bad["interpret da"] > 0
    assert bad["ref ds"] == bad["ref da"] == 0


def test_smoke_phase_f_bound_rejects_a_broken_carry(smoke):
    # the gate phase F holds the plain walk to must fail a scan whose carry
    # is lost part-way along the row, or whose tail is left unwritten
    n = 1 << 18
    (x,) = smoke.make_inputs(6, [n], "cpu")
    bc = 4096
    good = ps.prefix_sum_plain(x[None], bc)[0]
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    consts = ps.walk_bound_constants(n)
    assert smoke.prefix_bound_misses(good, ref64, abs64, bc, *consts)[0] == 0
    for broken in broken_carries(good, bc):
        assert smoke.prefix_bound_misses(broken, ref64, abs64, bc,
                                         *consts)[0] > 0


# ---------------------------------------------------------------------------
# K3's summation order (csrc/prefix_scan.cu), emulated in float32
# ---------------------------------------------------------------------------

def _hs(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inclusive Hillis–Steele over the last axis, as __shfl_up_sync does
    it: lane l adds lane l - d for d = 1, 2, … < n."""
    d = 1
    while d < n:
        x = x + torch.nn.functional.pad(x[..., :-d], (d, 0))
        d *= 2
    return x


def _exclusive(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _k3_tiles(x: torch.Tensor):
    """K3's in-tile order on one float32 row: (local prefixes (tiles, 8,
    32, 16) in float32, aggregates (tiles,) in float32)."""
    n = x.numel()
    tiles = -(-n // 4096)
    v = torch.nn.functional.pad(x, (0, tiles * 4096 - n)).reshape(
        tiles, 8, 32, 16)
    items = [v[..., 0]]
    for i in range(1, 16):
        items.append(items[-1] + v[..., i])      # fp32, one add at a time
    local = torch.stack(items, -1)
    lanes = _hs(local[..., -1], 32)              # (tiles, 8, 32)
    warps = _hs(lanes[..., -1], 8)               # (tiles, 8)
    off = _exclusive(lanes) + _exclusive(warps)[..., None]
    return local + off[..., None], warps[:, -1]


def k3_walk_emulated(x: torch.Tensor) -> torch.Tensor:
    """K3's walk mode on one float32 row: the in-tile order, then
    y = local + carry and carry += aggregate, both in float32."""
    local, agg = _k3_tiles(x)
    carry = torch.zeros((), dtype=torch.float32)
    out = []
    for t in range(local.shape[0]):
        out.append(local[t] + carry)
        carry = carry + agg[t]
    return torch.stack(out).reshape(-1)[:x.numel()]


def k3_emulated(x: torch.Tensor, depth: int) -> torch.Tensor:
    """K3 on one float32 row, its in-tile order exactly: 16 items a thread
    summed serially, the 32 lanes' totals by Hillis–Steele, the 8 warps'
    totals by Hillis–Steele, offset = lane prefix + warp prefix, each item
    + offset; then the look-back in double, as if every tile met its
    nearest inclusive prefix ``depth`` tiles back (tile 0's always), read
    in windows of 32 lanes summed by a butterfly; y = local + exclusive
    prefix rounded once to float32."""
    n = x.numel()
    local, agg = _k3_tiles(x)
    agg = agg.double()
    tiles = agg.numel()
    incl = torch.zeros(tiles, dtype=torch.float64)
    excl = torch.zeros(tiles, dtype=torch.float64)
    for t in range(tiles):
        s = max(t - depth, 0)                    # the nearest inclusive
        e, back = 0.0, t - 1
        while t:
            p = back - torch.arange(32)
            val = torch.where(p >= s, agg[p.clamp_min(0)], 0.0)
            val = torch.where(p == s, incl[s], val)
            for d in (16, 8, 4, 2, 1):           # the butterfly
                val = val + val[torch.arange(32) ^ d]
            e += float(val[0])
            if back - 31 <= s:
                break
            back -= 32
        excl[t] = e
        incl[t] = e + agg[t]
    y = local + excl.float()[:, None, None, None]
    return y.reshape(-1)[:n]


@pytest.mark.parametrize("depth", [1, 2, 31, 64])
def test_k3_order_within_its_bound(smoke, depth):
    n = 1 << 18                                  # 64 tiles of 4096
    (x,) = smoke.make_inputs(6, [n], "cpu")
    got = k3_emulated(x, depth)
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    consts = ps.k3_bound_constants(torch.float32, n)
    bad, worst = smoke.prefix_bound_misses(got, ref64, abs64, 4096, *consts)
    assert bad == 0, worst
    # the same order at a ragged length agrees with the plain walk
    close(k3_emulated(x[:10_000], depth), ps.prefix_sum_plain(
        x[None, :10_000], 4096)[0], PREFIX_TOL)


def test_k3_walk_order_within_its_bound(smoke):
    n = 1 << 18
    (x,) = smoke.make_inputs(6, [n], "cpu")
    got = k3_walk_emulated(x)
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    consts = ps.k3_bound_constants(torch.float32, n)
    bad, worst = smoke.prefix_bound_misses(got, ref64, abs64, 4096, *consts)
    assert bad == 0, worst
    close(k3_walk_emulated(x[:10_000]), ps.prefix_sum_plain(
        x[None, :10_000], 4096)[0], PREFIX_TOL)


@pytest.mark.parametrize("which", ["reset", "zeros"])
def test_k3_bound_rejects_a_broken_carry(smoke, which):
    n = 1 << 18
    (x,) = smoke.make_inputs(6, [n], "cpu")
    good = k3_emulated(x, 2)
    broken = dict(zip(["reset", "zeros"], broken_carries(good, 4096)))[which]
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    consts = ps.k3_bound_constants(torch.float32, n)
    assert smoke.prefix_bound_misses(broken, ref64, abs64, 4096,
                                     *consts)[0] > 0


def test_k3_bound_constants():
    assert ps.k3_bound_constants(torch.float32, 1 << 26) == (26, 1)
    assert ps.k3_bound_constants(torch.bfloat16, 5) == (26, 1)
    # float64: 5 butterfly levels, one add per window past the second,
    # 3 units lost to the status bits of each published value
    assert ps.k3_bound_constants(torch.float64, 4096 * 64) == (33, 4)
    assert ps.k3_bound_constants(torch.float64, 4096 * 65) == (34, 4)
    assert ps.walk_bound_constants(1 << 26) == (12, 1)


# ---------------------------------------------------------------------------
# K4's state-scan entry: the states in place
# ---------------------------------------------------------------------------

def former_statescan(a, b, axis, interpret=True):
    """The c4_statescan kernel path before the state-scan entry: the decay
    broadcast to state rank, both moved to the last axis, K4's walk (or
    K4) on the (rows, chunks) copies, moved back."""
    extra = b.ndim - a.ndim
    ab = torch.movedim(a.reshape(a.shape + (1,) * extra).expand(b.shape),
                       axis, -1)
    bb = torch.movedim(b, axis, -1)
    out = ps.chunk_scan_kernel(ab.reshape(-1, ab.shape[-1]),
                               bb.reshape(-1, bb.shape[-1]),
                               interpret=interpret)
    return torch.movedim(out.reshape(bb.shape), -1, axis)


STATE_CASES = {   # name: (decay shape, states shape, axis)
    "ssd": ((2, 8, 4), (2, 8, 4, 16, 16), 1),
    "hymba P*N 800": ((2, 3, 4), (2, 3, 4, 50, 16), 1),
    "ragged": ((3, 5, 7), (3, 5, 7, 9, 11), 1),
    "negative axis on the states (P)": ((2, 8, 4), (2, 8, 4, 3, 5), -2),
    "negative axis on the chunks": ((2, 8, 4), (2, 8, 4, 3, 5), -4),
    "past the decay's dims": ((2, 8, 4), (2, 8, 4, 3, 5), 4),
    "leading axis": ((8, 4), (8, 4, 3, 5), 0),
    "chunks beyond one block": ((2, 40, 3), (2, 40, 3, 4, 4), 1),
    "broadcast decay": ((2, 8, 1), (2, 8, 4, 3, 5), 1),
}


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_state_scan_walk_is_the_former_composition_bit_for_bit(case):
    a_shape, s_shape, axis = STATE_CASES[case]
    a, s = torch.from_numpy(decay(a_shape)), torch.from_numpy(normal(s_shape))
    want = former_statescan(a, s, axis)
    got = ops.chunk_scan_state(a, s, axis=axis, mode="interpret")
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ps.state_scan_plain(a, s, axis), want)


ORACLE_CASES = [c for c, (a_shape, s_shape, axis) in STATE_CASES.items()
                if 0 <= axis < len(a_shape) and "broadcast" not in c]


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_state_scan_walk_matches_the_oracle(case):
    # the fold against the reference's associative-scan oracle: two
    # orders of one recurrence, within the JAX tests' affine tolerance
    a_shape, s_shape, axis = STATE_CASES[case]
    a, s = decay(a_shape), normal(s_shape)
    want = jref_chunk_scan_state(jnp.asarray(a), jnp.asarray(s), axis=axis)
    got = ps.state_scan_plain(torch.from_numpy(a), torch.from_numpy(s), axis)
    close(got, want, AFFINE_TOL)


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_fused_da_plain_is_the_prev_product(case):
    # da as the fused reverse walk sums it (each thread's vector, the
    # warp's butterfly, the warps, the blocks) against the product at the
    # states' size and torch's sum: the same products in two orders, so
    # |Δ| ≤ n·eps·Σ|λ·y| for n terms a decay element
    a_shape, s_shape, axis = STATE_CASES[case]
    a = torch.from_numpy(decay(a_shape))
    lam, y = (torch.from_numpy(normal(s_shape)) for _ in range(2))
    ax = axis % len(s_shape)
    ae = a.expand(s_shape[:a.ndim])
    got = ps.state_da_plain(lam, y, ae, axis)
    want = ps._prev_product(lam, y, ax, a.ndim)
    absum = ps._prev_product(lam.abs(), y.abs(), ax, a.ndim)
    terms = math.prod(s_shape) // math.prod(want.shape)
    assert got.shape == want.shape and got.dtype == want.dtype
    eps = float(torch.finfo(torch.float32).eps)
    assert bool(((got - want).abs() <= terms * eps * absum).all())
    # in float64 the two orders agree to float64's rounding
    g64 = ps.state_da_plain(lam.double(), y.double(), ae.double(), axis)
    w64 = ps._prev_product(lam.double(), y.double(), ax, a.ndim)
    close(g64, w64, dict(rtol=1e-12, atol=1e-12))


@pytest.mark.parametrize("shape", [(4, 3000), (16, 64), (3, 37)])
def test_k4_bound_steps_hold_the_fold(shape):
    # the fold within k4_bound_steps(c)·eps·Σ_{j≤c}|b_j| of float64, for
    # decays in (0, 1]
    a = torch.from_numpy(1 - RNG.uniform(0, 1, shape).astype(np.float32))
    b = torch.from_numpy(normal(shape))
    got = ps.state_scan_plain(a.t(), b.t()[..., None], 0)[..., 0].t().double()
    y = torch.zeros(shape[0], dtype=torch.float64)
    s = torch.zeros_like(y)
    eps = float(torch.finfo(torch.float32).eps)
    for c in range(shape[1]):
        y = a[:, c].double() * y + b[:, c].double()
        s = s + b[:, c].double().abs()
        assert bool(((got[:, c] - y).abs()
                     <= ps.k4_bound_steps(c) * eps * s).all())


def test_state_scan_promotes_and_takes_strided_states():
    a = torch.from_numpy(decay((2, 6, 3))).to(torch.bfloat16)
    s = torch.from_numpy(normal((2, 6, 3, 5, 8)))
    got = ops.chunk_scan_state(a, s, axis=1, mode="interpret")
    assert got.dtype == torch.float32
    assert torch.equal(got, former_statescan(a, s, 1))
    st = torch.from_numpy(normal((2, 6, 3, 8, 5))).transpose(-1, -2)
    assert torch.equal(ops.chunk_scan_state(a, st, axis=1, mode="interpret"),
                       former_statescan(a, st, 1))


def test_state_scan_map_walks_each_group_in_place():
    a, s = torch.zeros(4, 32, 64), torch.zeros(4, 32, 64, 64, 128)
    a2, w = ps.state_scan_map(a, s, 1)
    assert a2.is_contiguous() and a2.shape == a.shape
    assert w == dict(outer=4, cols=32, inner=64 * 64 * 128, a_in=64,
                     rows=64 * 128, a_div=1, a_outer=32 * 64, a_col=64)
    _, w = ps.state_scan_map(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4, 3, 5),
                             -2)                      # the P axis
    assert w == dict(outer=2 * 8 * 4, cols=3, inner=5, a_in=1, rows=5,
                     a_div=1, a_outer=1, a_col=0)
    with pytest.raises(IndexError):
        ps.state_scan_map(a, s, 5)


def test_state_scan_on_cpu_tensors_raises():
    a, s = torch.ones(2, 4, 3), torch.zeros(2, 4, 3, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.chunk_scan_state_kernel(a, s, 1)
    with pytest.raises(ValueError, match="floating-point"):
        ps.K4.state_scan(a.int(), s.int(), 1)


@pytest.mark.parametrize("br,bc", [(128, 32), (512, 8), (2, 16), (8, 512),
                                   (4096, 1)])
def test_move_layout_covers_the_rows_first(br, bc):
    # the state walk moves along a group's br contiguous payload rows: a
    # thread's vector divides them, whole warps cover each row once, and
    # a thread's ring holds at most K4_RING_BYTES of each operand it loads
    # (y too, with da), all the chunks where that covers them
    for da in (False, True):
        w = ps.state_walk(br, bc, 4, da)
        assert br % w["vec"] == 0 and w["vec"] in (1, 2, 4)
        assert w["sp"] % 32 == 0 and w["sp"] - 32 < br // w["vec"] <= w["sp"]
        assert 4 <= w["ring"] <= 32
        per = w["vec"] * 4 * (2 if da else 1)
        assert w["ring"] * per <= max(ps.K4_RING_BYTES, 4 * per)
        if bc * per <= ps.K4_RING_BYTES:
            assert w["ring"] >= bc         # every chunk's load in flight


@pytest.mark.parametrize("br,bc", [(128, 32), (512, 8), (2, 16), (8, 512),
                                   (4096, 1), (1, 4096), (1, 8)])
def test_scan_layout_coalesces_the_columns(br, bc):
    nw = ps._num_warps(br, bc)
    spt, tpw, wpc, order = ps.scan_layout(br, bc, nw)
    assert order == (1, 0) and spt == (1, min(4, bc))
    assert tpw[0] * tpw[1] == 32 and wpc[0] * wpc[1] == nw
    assert spt[1] * tpw[1] * wpc[1] <= bc       # no column held twice
    if bc >= 4 * 32:
        assert tpw == (1, 32)                   # a warp spans 128 columns


@pytest.mark.parametrize("rows,cols,want", [
    (8192, 32, dict(vec=4, ring=8, sp=2048)),     # G, J
    (8192, 16, dict(vec=4, ring=8, sp=2048)),     # L, N7a forward
    (800, 8, dict(vec=4, ring=8, sp=224)),        # K: 7 warps, 24 lanes idle
    (99, 5, dict(vec=1, ring=32, sp=128)),        # ragged: one element
    (8192, 100, dict(vec=4, ring=8, sp=2048)),    # a ring over 100 chunks
])
def test_state_walk_at_the_paths_shapes(rows, cols, want):
    assert ps.state_walk(rows, cols, 4) == want


@pytest.mark.parametrize("br,bc", [(128, 32), (512, 8), (2, 16), (4096, 1),
                                   (1, 8), (3, 64), (8, 65), (2, 512)])
def test_rows_entry_is_the_state_entrys_fold_up_to_64_columns(br, bc):
    # up to K4_FOLD_COLS columns the rows entry's plain walk on (br, bc)
    # rows is the sequential fold and the state entry's on the same
    # numbers laid out as states (a group a row, one payload element),
    # bit for bit, both ways; past it the Gluon kernel's blocked walk,
    # within k4_rows_bound_steps of float64
    a = torch.from_numpy(decay((br, bc)))
    b = torch.from_numpy(normal((br, bc)))
    eps = float(torch.finfo(torch.float32).eps)
    for reverse in (False, True):
        step = (lambda t: t.flip(1)) if reverse else (lambda t: t)
        rows = step(ps.chunk_scan_plain(a, b, reverse=reverse))
        if bc <= ps.K4_FOLD_COLS:
            states = ps.state_scan_plain(a.t(), b.t()[..., None], 0, reverse)
            assert torch.equal(rows, step(states[..., 0].t()))
            y = torch.zeros(br)
            for c in range(bc):
                y = step(a)[:, c] * y + step(b)[:, c]
                assert torch.equal(rows[:, c], y)
            continue
        y = torch.zeros(br, dtype=torch.float64)
        s = torch.zeros_like(y)
        for c in range(bc):
            y = step(a)[:, c].double() * y + step(b)[:, c].double()
            s = s + step(b)[:, c].double().abs()
            bound = ps.k4_rows_bound_steps(c, br, bc) * eps * s
            assert bool(((rows[:, c].double() - y).abs() <= bound).all())


def test_gluon_source_defines_the_state_scan_entry():
    # the state entry (k4_state_kernel) and the rows entry (k4_rows_kernel)
    # share one fold, each product and add rounded alone (no FMA), and the
    # reverse walk's da is reduced without atomics
    src = (_cuda.CSRC / "prefix_scan.cu").read_text()
    k4 = src[src.index("namespace k4 {"):src.index("}  // namespace k4")]
    assert k4.count("fold(") >= 6         # four dtypes, two entries
    assert "__fadd_rn(__fmul_rn(a, y), b)" in k4
    assert "__dadd_rn(__dmul_rn(a, y), b)" in k4
    assert "carry.v[e] = fold(dk, carry.v[e], cur.v[e])" in k4
    assert "carry = fold(x.v[ee], carry, y.v[ee])" in k4      # rows entry
    # past 64 columns the rows entry is the Gluon tree
    assert "gl.associative_scan((a, b), 1, _affine)" in ps.GLUON_SOURCE
    assert "atomic" not in k4
    assert "__shfl_xor_sync" in k4
    assert "convert_layout" not in src and "associative_scan" not in src


def test_gluon_entries_take_the_reverse_walk():
    # both entries map the walk's step j to chunk cols - 1 - j: the
    # ring's first loads, its refills and each step's fold (states,
    # decays, y and da's partials alike)
    src = (_cuda.CSRC / "prefix_scan.cu").read_text()
    k4 = src[src.index("namespace k4 {"):src.index("}  // namespace k4")]
    for step in ("k", "j", "jn"):
        assert f"reverse ? cols - 1 - {step} : {step}" in k4
    assert "(REV ? cpr - 1 - j : j)" in k4                  # rows entry
    assert "c = cols - 1 - c" in ps.GLUON_SOURCE             # past 64


# ---------------------------------------------------------------------------
# under autograd: the Functions of c4_chunkscan and c4_statescan, whose
# backward is K4's reverse walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 37), (1, 1), (5, 8), (2, 300)])
def test_reverse_walk_is_the_forward_walk_on_flipped_rows(shape):
    a = torch.from_numpy(decay(shape))
    b = torch.from_numpy(normal(shape))
    got = ps.chunk_scan_kernel(a, b, interpret=True, reverse=True)
    want = ps.chunk_scan_kernel(a.flip(1), b.flip(1), interpret=True).flip(1)
    assert torch.equal(got, want)
    # and it is the adjoint recurrence λ[c] = b[c] + a[c]·λ[c+1]
    lam = torch.zeros(shape[0], dtype=torch.float64)
    seq = []
    for c in reversed(range(shape[1])):
        lam = b[:, c].double() + a[:, c].double() * lam
        seq.append(lam)
    close(got, torch.stack(seq[::-1], 1), AFFINE_TOL)


@pytest.mark.parametrize("a_shape,s_shape,axis", [
    ((2, 7, 3), (2, 7, 3, 4, 5), 1), ((2, 7, 3), (2, 7, 3, 4, 5), -4),
    ((3, 5), (3, 5, 6, 2), 2), ((2, 40, 3), (2, 40, 3, 2, 2), 1)])
def test_reverse_state_walk_is_the_forward_walk_on_flipped_chunks(
        a_shape, s_shape, axis):
    a = torch.from_numpy(decay(a_shape))
    s = torch.from_numpy(normal(s_shape))
    ax = axis % len(s_shape)
    got = ps.chunk_scan_state_kernel(a, s, axis, interpret=True,
                                     reverse=True)
    fa = a.flip(ax) if ax < a.ndim else a
    want = ps.chunk_scan_state_kernel(fa, s.flip(ax), axis,
                                      interpret=True).flip(ax)
    assert torch.equal(got, want)


def _decay64(shape, seed):
    # random decays in (0, 1]: the model's own are ≈ 0 (PERF.md §4)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(1.0 - rng.uniform(0.0, 1.0, shape)
                            ).requires_grad_()


@pytest.mark.parametrize("shape", [(3, 37), (2, 1), (4, 9)])
def test_chunk_scan_function_passes_gradcheck(shape):
    a = _decay64(shape, 1)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: ops.chunk_scan(a, b, mode="interpret"), (a, b))


@pytest.mark.parametrize("a_shape,s_shape,axis", [
    ((2, 5, 3), (2, 5, 3, 4, 2), 1),        # SSD rank
    ((2, 5, 3), (2, 5, 3, 4, 2), -4),       # a negative axis
    ((2, 11, 2), (2, 11, 2, 3, 1), 1),      # ragged chunk count
    ((2, 5), (2, 5, 3, 2), 2),              # the decay constant along it
    ((2, 5, 1), (2, 5, 3, 2, 2), 1),        # the decay broadcast
])
def test_state_scan_function_passes_gradcheck(a_shape, s_shape, axis):
    a = _decay64(a_shape, 3)
    s = torch.from_numpy(np.random.default_rng(4).standard_normal(s_shape)
                         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, s: ops.chunk_scan_state(a, s, axis=axis,
                                          mode="interpret"), (a, s))


@pytest.mark.parametrize("shape", [(3, 37), (8, 64)])
def test_chunk_scan_grads_match_jax(shape):
    a, b = decay(shape), normal(shape)
    g = normal(shape)
    ja, jb = jax.grad(lambda a, b: jnp.sum(jref.chunk_scan(a, b) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    for mode in ("interpret", "ref"):
        y = ops.chunk_scan(ta, tb, mode=mode)
        da, db = torch.autograd.grad(y, (ta, tb), torch.from_numpy(g))
        close(da, ja, AFFINE_TOL)
        close(db, jb, AFFINE_TOL)


def test_state_scan_grads_match_jax():
    a, s, g = decay((2, 12, 3)), normal((2, 12, 3, 4, 5)), \
        normal((2, 12, 3, 4, 5))
    ja, js = jax.grad(lambda a, s: jnp.sum(
        jref.chunk_scan_state(a, s, axis=1) * g), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(s))
    ta = torch.from_numpy(a).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    for mode in ("interpret", "ref"):
        y = ops.chunk_scan_state(ta, ts, axis=1, mode=mode)
        da, ds = torch.autograd.grad(y, (ta, ts), torch.from_numpy(g))
        close(da, ja, AFFINE_TOL)
        close(ds, js, AFFINE_TOL)


def test_scan_functions_keep_dtypes_and_save_their_output():
    a = torch.from_numpy(decay((2, 6, 3))).to(torch.bfloat16).requires_grad_()
    s = torch.from_numpy(normal((2, 6, 3, 2, 2))).requires_grad_()
    y = ops.chunk_scan_state(a, s, axis=1, mode="interpret")
    assert y.dtype == torch.float32 and y.grad_fn is not None
    da, ds = torch.autograd.grad(y.sum(), (a, s))
    assert da.dtype == torch.bfloat16 and ds.dtype == torch.float32
    assert da.shape == a.shape and ds.shape == s.shape


def test_isa_guard_refuses_kernels_without_a_backward():
    # K1 (c0, fused chains), K5 (c2_sort), K6 (c1_merge), K3
    # (c3_prefixsum) and K8 (c6_flashattn) have no backward: on the
    # kernel and interpret paths they raise rather than detach
    x = torch.randn(2, 64, requires_grad=True)
    y = torch.randn(2, 64)
    calls = {
        "c0_scale": lambda m: ops.stream_scale(x, 2.0, mode=m),
        "c0_scale+c0_add": lambda m: repro_torch.core.isa.fuse(
            "c0_scale", "c0_add")(2.0, x, y, mode=m),
        "c2_sort": lambda m: ops.sort_chunks(x, 8, mode=m),
        "c1_merge": lambda m: ops.merge_sorted(x, y, mode=m),
        "c3_prefixsum": lambda m: ops.prefix_sum(x, mode=m),
        "c6_flashattn": lambda m: ops.flash_attention(
            x[None, None], y[None, None], y[None, None], mode=m),
    }
    for name, call in calls.items():
        for mode in ("interpret", "kernel"):
            with pytest.raises(ValueError, match=re.escape(name)):
                call(mode)
        call("ref")                          # autograd differentiates ref
        with torch.no_grad():
            call("interpret")                # nothing to lose
    # K3's one-hot of integer ids needs no gradient: no raise
    onehot = torch.nn.functional.one_hot(torch.tensor([0, 2, 1, 2]), 3)
    ops.prefix_sum(onehot.float().T, mode="interpret")

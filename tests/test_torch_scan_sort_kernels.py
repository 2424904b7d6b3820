"""K3–K6 against their plain PyTorch versions, on the card.

K3 (the look-back scan), K4 (the affine fold), K5 and K6 are CUDA C++
(built with nvcc at first use), and K4's rows entry past 64 columns is
Gluon (Triton); none has a CPU mode, so every test here is marked
``gpu`` and skips without a CUDA device. Run them on an H100 with
``pytest -m gpu tests/test_torch_scan_sort_kernels.py``.

Tolerances: sorts and merges bit-exact (the kernels take the same
selects as the plain network); scans within the first-order bound of
their summation order against float64: for the sum,
``eps·(k_abs·Σ_{j≤i}|x_j| + k_ends·Σ_{e<i}|y_e| + |y_i|)`` (e over the
ends of the earlier blocks of ``bc`` columns) with K3's constants
(``prefix_scan.k3_bound_constants``: at most 25 adds inside a 4096-column
tile, the exclusive prefix rounded once from the double look-back) and
the plain walk's (⌈log2 bc⌉, 1: a tree inside each block, one add of the
carry per block); for K4's rows entry with 0 < a ≤ 1,
``prefix_scan.k4_rows_bound_steps(i)·eps·Σ_{j≤i}|b_j|`` (the fold's
i + 2 up to 64 columns, bit for bit to its plain walk; past them the
Gluon tree's ⌈log2 bc⌉ + ⌈(i+1)/bc⌉ + 2); K4's state-scan entry (the
fold) bit for bit against its plain walk.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the ISA
from repro_torch.kernels import ops
from repro_torch.kernels import prefix_scan as ps
from repro_torch.kernels import sortnet as sn

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3–K6 are Triton and CUDA kernels "
                    "with no CPU mode (their plain versions are tested in "
                    "test_torch_sortnet / test_torch_prefix_scan)")
    return torch.device("cuda", 0)


def keys(shape, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-10_000, 10_000, shape,
                                          dtype=np.int32))
    else:
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(dtype).to(dev)


def prefix_bound(x, bc, eps, k_abs, k_ends=1):
    """(float64 inclusive sum along the last axis, its elementwise bound
    for a summation order of constants (k_abs, k_ends))."""
    y = torch.cumsum(x.double(), -1)
    ends = y[..., bc - 1::bc].abs()
    carried = torch.nn.functional.pad(torch.cumsum(ends, -1), (1, 0))
    blk = torch.arange(x.shape[-1], device=x.device) // bc
    return y, eps * (k_abs * torch.cumsum(x.abs().double(), -1)
                     + k_ends * carried[..., blk] + y.abs())


def within_k3_bound(x, got, eps=None):
    """K3's output within its own order's bound (its 4096-column tiles)."""
    eps = float(torch.finfo(x.dtype).eps) if eps is None else eps
    want, bound = prefix_bound(x, ps.TILE_ELEMS, eps,
                               *ps.k3_bound_constants(x.dtype, x.shape[-1]))
    return bool(((got.double() - want).abs() <= bound).all())


def scan_bound(abs_cum, eps, rows, cols):
    """K4's rows entry's elementwise bound along the last axis, its
    route's (``prefix_scan.k4_rows_bound_steps``)."""
    k = torch.tensor([ps.k4_rows_bound_steps(i, rows, cols)
                      for i in range(cols)], device=abs_cum.device,
                     dtype=torch.float64)
    return k * eps * abs_cum


# ---------------------------------------------------------------------------
# K5 / K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,width", [
    ((1, 8), 8), ((5, 64), 8), ((16, 256), 16), ((3, 128), 4),
    ((7, 32), 32), ((2, 1024), 64), ((3, 8192), 4096), ((5, 1000 * 8), 8)])
@pytest.mark.parametrize("descending", [False, True])
def test_k5_matches_network(cuda, shape, width, dtype, descending):
    x = keys(shape, DTYPES[dtype], 0, cuda)
    before = sn.K5.launches
    got = sn.sort_chunks_kernel(x, width=width, descending=descending)
    assert sn.K5.launches == before + 1
    assert torch.equal(got, sn.sort_chunks_kernel(
        x, width=width, descending=descending, interpret=True))


def same_bits(x, y):
    """Bit for bit (NaN included), through an integer view."""
    view = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(x.view(view), y.view(view))


def special_keys(shape, dtype, seed, dev):
    """Few values: ties, ±0.0 and (for floats) NaN."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-3, 3, shape,
                                             dtype=np.int32)).to(dev)
    pool = np.array([-2.5, -0.0, 0.0, 1.0, 1.0, np.nan, 7.0], np.float32)
    return torch.from_numpy(rng.choice(pool, shape)).to(dtype).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [1 << k for k in range(1, 13)])  # L 1 … 12
@pytest.mark.parametrize("descending", [False, True])
def test_k5_sorts_ties_zeros_and_nan_as_the_network(cuda, width, dtype,
                                                    descending):
    # ±0.0, NaN and ties, a ragged last tile, and a start one key past a
    # 16-byte boundary (key-by-key loads)
    cols = width * -(-1500 // width)
    x = special_keys((3, cols + 1), DTYPES[dtype], width, cuda)
    for t in (x[:, :cols].contiguous(), x.view(-1)[1:3 * cols + 1].view(
            3, cols)):
        got = sn.sort_chunks_kernel(t, width=width, descending=descending)
        want = sn.sort_chunks_kernel(t, width=width, descending=descending,
                                     interpret=True)
        assert same_bits(got, want)


def k6_merge(a, b, w, descending):
    """K6 through its wrapper; w = 1 (L = 1), which the wrapper rejects as
    the reference does, through K6 itself."""
    if w == 1:
        return sn.K6(a, b, 1, descending)
    return sn.merge_sorted_kernel(a, b, width=w, descending=descending)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [1 << k for k in range(12)])   # L = 1 … 12
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("values", ["random", "special"])
def test_k6_matches_network(cuda, w, dtype, descending, values):
    rows = 5                       # 40w merged keys: a ragged last tile
    make = keys if values == "random" else special_keys

    def sorted_chunks(seed):
        x = make((rows, 4, w), DTYPES[dtype], seed, cuda)
        return torch.sort(x).values.reshape(rows, 4 * w)

    a, b = sorted_chunks(1), sorted_chunks(2)
    before = sn.K6.launches
    lo, hi = k6_merge(a, b, w, descending)
    assert sn.K6.launches == before + 1
    plo, phi = sn.merge_sorted_plain(a, b, w, descending)
    assert same_bits(lo, plo) and same_bits(hi, phi)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("layout", ["misaligned", "cols not 8-aligned",
                                    "odd row stride"])
def test_k6_loads_key_by_key_where_runs_do_not_fit(cuda, w, dtype, layout):
    # at L ≤ 4 K6 loads 8-key runs only from 16-byte aligned rows whose
    # length is a multiple of 8; these operands take its per-key loads
    cols = (3 if layout == "cols not 8-aligned" else 8) * w
    stride = -(-(2 * cols + 1) // 8) * 8 + (layout == "odd row stride")
    start = int(layout == "misaligned")
    x = special_keys((4, stride), DTYPES[dtype], 5, cuda)
    a = x[:, start:start + cols]
    b = x[:, start + cols:start + 2 * cols]
    for t in (a, b):
        t.copy_(torch.sort(t.reshape(4, -1, w)).values.reshape(4, cols))
    lo, hi = k6_merge(a, b, w, False)
    plo, phi = sn.merge_sorted_plain(a.contiguous(), b.contiguous(), w)
    assert same_bits(lo, plo) and same_bits(hi, phi)


def test_k6_strided_rows_as_the_app_passes_them(cuda):
    w = 256
    x = torch.sort(keys((64, w), torch.int32, 3, cuda)).values.view(-1, 2, w)
    a, b = x[:, 0], x[:, 1]                      # row stride 2w
    assert a.stride() == (2 * w, 1)
    lo, hi = sn.merge_sorted_kernel(a, b, width=w)
    rlo, rhi = sn.merge_sorted_kernel(a.contiguous(), b.contiguous(),
                                      width=w, interpret=True)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


@pytest.mark.parametrize("n", [8, 64, 4096, 1 << 16])
def test_mergesort_app_on_card(cuda, n):
    x = keys((3, n), torch.float32, 4, cuda)
    k5, k6 = sn.K5.launches, sn.K6.launches
    got = ops.sortnet_mergesort(x, max_kernel_width=1024, mode="kernel")
    assert torch.equal(got, torch.sort(x).values)
    levels = max(int(math.log2(n)) - 3, 0)
    assert sn.K5.launches == k5 + 1
    assert sn.K6.launches == k6 + min(levels, int(math.log2(1024)) - 3)


def test_sortnet_wrappers_reject_bad_widths_on_card(cuda):
    x = keys((2, 8192), torch.float32, 5, cuda)
    with pytest.raises(ValueError, match="power of two"):
        sn.sort_chunks_kernel(x, width=12)
    with pytest.raises(ValueError, match="4096"):
        sn.sort_chunks_kernel(x, width=8192)
    with pytest.raises(ValueError, match="2048"):
        sn.merge_sorted_kernel(x, x, width=4096)
    with pytest.raises(ValueError, match="float32, int32 or bfloat16"):
        sn.sort_chunks_kernel(x.double(), width=8)


# ---------------------------------------------------------------------------
# K3 / K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8), (4, 128), (8, 1024), (3, 4096),
                                   (2, 10_000), (37, 300), (1, 1 << 20)])
def test_k3_within_summation_bound(cuda, shape):
    x = keys(shape, torch.float32, 6, cuda)
    before = ps.K3.launches
    got = ps.prefix_sum_kernel(x)
    assert ps.K3.launches == before + 1
    plain = ps.prefix_sum_kernel(x, interpret=True)
    bc = ps.block_shape(*shape)[1]
    assert within_k3_bound(x, got)
    want, bound = prefix_bound(x, bc, float(torch.finfo(torch.float32).eps),
                               *ps.walk_bound_constants(shape[1]))
    assert bool(((plain.double() - want).abs() <= bound).all())


def test_k3_bfloat16(cuda):
    x = keys((4, 3000), torch.bfloat16, 7, cuda)
    got = ps.prefix_sum_kernel(x)
    assert got.dtype == torch.bfloat16
    assert within_k3_bound(x, got, 2.0 ** -8)


def test_k3_forward_progress_with_tiles_beyond_the_resident_blocks(cuda):
    # 4096 tiles of one row: far more than the blocks resident at once, so
    # a block must never wait on a tile no running block has taken
    x = keys((1, 1 << 24), torch.float32, 13, cuda)
    got = ps.prefix_sum_kernel(x)
    torch.cuda.synchronize()
    assert within_k3_bound(x, got)


def test_k3_router_rows_and_their_counts(cuda):
    x = keys((384, 32768), torch.float32, 14, cuda)
    assert within_k3_bound(x, ps.prefix_sum_kernel(x))
    ones = (x > 1.0).float()                    # 0/1 rows: sums exact
    assert torch.equal(ps.prefix_sum_kernel(ones), torch.cumsum(ones, 1))


@pytest.mark.parametrize("cols", [5000, 4096 * 3, 4097])
def test_k3_strided_rows(cuda, cols):
    big = keys((6, cols + 7), torch.float32, 15, cuda)
    for x in (big[:, 3:cols + 3], big[::2, :cols]):   # unaligned, every other
        assert x.stride(0) != cols
        got = ps.prefix_sum_kernel(x)
        assert within_k3_bound(x, got)
        assert torch.allclose(got, ps.prefix_sum_kernel(x.contiguous()),
                              rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float64])
def test_k3_walk_mode_on_many_rows(cuda, dtype):
    # rows enough to fill the card take the walk (one block a row): a
    # ragged last tile, a strided view and the 16-bit and float64 cases
    big = keys((300, 2 * 4096 + 9), torch.float32, 18, cuda).to(dtype)
    for x in (big, big[:, 1:]):
        got = ps.prefix_sum_kernel(x)
        assert got.dtype == dtype
        assert within_k3_bound(x, got)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k3_float16_and_float64(cuda, dtype):
    x = keys((3, 3 * 4096 + 11), torch.float32, 16, cuda).to(dtype)
    got = ps.prefix_sum_kernel(x)
    assert got.dtype == dtype
    assert within_k3_bound(x, got)


def test_k3_state_is_reset_between_calls(cuda):
    x = keys((2, 40_000), torch.float32, 17, cuda)
    first = ps.prefix_sum_kernel(x)
    assert within_k3_bound(x, first)
    before = ps.K3.launches
    for _ in range(10):
        got = ps.prefix_sum_kernel(x)
        assert within_k3_bound(x, got)
        # the look-back's depth varies with timing: last bits only
        assert torch.allclose(got, first, rtol=0, atol=1e-3)
    assert ps.K3.launches == before + 10


def test_k3_rejects_other_dtypes(cuda):
    with pytest.raises(ValueError, match="floating-point"):
        ps.prefix_sum_kernel(torch.zeros(2, 8, dtype=torch.int32,
                                         device=cuda))


@pytest.mark.parametrize("shape", [(1, 16), (4, 256), (8, 1024), (3, 5000),
                                   (1000, 32)])
def test_k4_within_summation_bound(cuda, shape):
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, shape).astype(np.float32))
    a = a.to(cuda)
    b = keys(shape, torch.float32, 9, cuda)
    before = ps.K4.launches
    got = ps.chunk_scan_kernel(a, b)
    assert ps.K4.launches == before + 1
    plain = ps.chunk_scan_kernel(a, b, interpret=True)
    y = torch.zeros(shape[0], dtype=torch.float64, device=cuda)
    s = torch.zeros_like(y)
    want, sums = [], []
    for i in range(shape[1]):
        y = a[:, i].double() * y + b[:, i].double()
        s = s + b[:, i].double().abs()
        want.append(y)
        sums.append(s)
    want, sums = torch.stack(want, -1), torch.stack(sums, -1)
    bound = scan_bound(sums, float(torch.finfo(torch.float32).eps), *shape)
    assert bool(((got.double() - want).abs() <= bound).all())
    assert bool(((plain.double() - want).abs() <= bound).all())
    if shape[1] <= ps.K4_FOLD_COLS:           # the fold: its plain walk
        assert torch.equal(got, plain)


def test_k4_promotes_mixed_dtypes(cuda):
    a = torch.full((4, 64), 0.5, dtype=torch.bfloat16, device=cuda)
    b = keys((4, 64), torch.float32, 10, cuda)
    got = ps.chunk_scan_kernel(a, b)
    assert got.dtype == torch.float32
    want = ps.chunk_scan_kernel(a, b, interpret=True)
    assert torch.allclose(got, want, rtol=2e-5, atol=1e-5)


def test_statescan_on_card_matches_plain(cuda):
    rng = np.random.default_rng(11)
    a = torch.from_numpy(np.exp(-np.abs(rng.standard_normal(
        (2, 16, 4), dtype=np.float32)))).to(cuda)
    s = keys((2, 16, 4, 8, 16), torch.float32, 12, cuda)
    before = ps.K4.launches
    got = ops.chunk_scan_state(a, s, axis=1, mode="kernel")
    assert ps.K4.launches == before + 1
    want = ops.chunk_scan_state(a, s, axis=1, mode="interpret")
    assert torch.allclose(got, want, rtol=2e-4, atol=2e-4)


def former_statescan(a, s, axis):
    """The c4_statescan kernel path before K4's state-scan entry: K4 on
    the decay broadcast to state rank and both moved to the last axis."""
    extra = s.ndim - a.ndim
    ab = torch.movedim(a.reshape(a.shape + (1,) * extra).expand(s.shape),
                       axis, -1)
    bb = torch.movedim(s, axis, -1)
    out = ps.chunk_scan_kernel(ab.reshape(-1, ab.shape[-1]),
                               bb.reshape(-1, bb.shape[-1]))
    return torch.movedim(out.reshape(bb.shape), -1, axis)


@pytest.mark.parametrize("a_shape,s_shape,axis", [
    ((4, 32, 64), (4, 32, 64, 64, 128), 1),      # chip_smoke G, Mamba2-1.3B
    ((4, 16, 64), (4, 16, 64, 64, 128), 1),      # chip_smoke L's train step
    ((4, 8, 64), (4, 8, 64, 50, 16), 1),         # Hymba-1.5B: P·N = 800
    ((3, 5, 7), (3, 5, 7, 9, 11), 1),            # ragged
    ((2, 40, 3), (2, 40, 3, 4, 4), 1),           # chunks beyond one block
    ((2, 8, 4), (2, 8, 4, 3, 5), -2),            # counted on the states
])
def test_k4_state_scan_is_the_former_composition_bit_for_bit(
        cuda, a_shape, s_shape, axis):
    rng = np.random.default_rng(13)
    a = torch.from_numpy(np.exp(-np.abs(rng.standard_normal(
        a_shape, dtype=np.float32)))).to(cuda)
    s = keys(s_shape, torch.float32, 14, cuda)
    before = ps.K4.launches
    got = ops.chunk_scan_state(a, s, axis=axis, mode="kernel")
    assert ps.K4.launches == before + 1
    want = former_statescan(a, s, axis)
    assert got.dtype == want.dtype and torch.equal(got, want)
    plain = ops.chunk_scan_state(a, s, axis=axis, mode="interpret")
    assert torch.allclose(got, plain, rtol=2e-4, atol=2e-4)


def test_k4_state_scan_bit_for_bit_in_bfloat16(cuda):
    # bf16 states and decay: the entry scans in the promoted dtype in the
    # same order as K4 on the materialised operands
    rng = np.random.default_rng(15)
    a = torch.from_numpy(np.exp(-np.abs(rng.standard_normal(
        (2, 16, 4), dtype=np.float32)))).to(cuda, torch.bfloat16)
    s = keys((2, 16, 4, 8, 16), torch.bfloat16, 16, cuda)
    got = ops.chunk_scan_state(a, s, axis=1, mode="kernel")
    want = former_statescan(a, s, 1)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# K4's reverse walk: the backward of c4_chunkscan and c4_statescan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_shape,s_shape,axis", [
    ((4, 32, 64), (4, 32, 64, 64, 128), 1),      # chip_smoke G's shape
    ((4, 16, 64), (4, 16, 64, 64, 128), 1),      # chip_smoke L's train step
    ((4, 8, 64), (4, 8, 64, 50, 16), 1),         # Hymba-1.5B: P·N = 800
    ((3, 5, 7), (3, 5, 7, 9, 11), 1),            # ragged
    ((2, 40, 3), (2, 40, 3, 4, 4), 1),           # chunks beyond one block
    ((2, 8, 4), (2, 8, 4, 3, 5), -2),            # counted on the states
])
def test_k4_reverse_state_walk_is_the_forward_on_flipped_chunks(
        cuda, a_shape, s_shape, axis):
    # the reverse entry maps indices only: its layout and combine order
    # are the forward's, so it is the forward on flipped copies bit for bit
    rng = np.random.default_rng(17)
    a = torch.from_numpy(1 - rng.uniform(0, 1, a_shape).astype(np.float32)
                         ).to(cuda)
    g = keys(s_shape, torch.float32, 18, cuda)
    ax = axis % len(s_shape)
    before = ps.K4.reverse_launches
    got = ps.chunk_scan_state_kernel(a, g, axis, reverse=True)
    assert ps.K4.reverse_launches == before + 1
    fa = a.flip(ax) if ax < a.ndim else a     # past a's dims: constant
    want = ps.chunk_scan_state_kernel(fa, g.flip(ax), axis).flip(ax)
    assert torch.equal(got, want)
    plain = ps.chunk_scan_state_kernel(a, g, axis, interpret=True,
                                       reverse=True)
    assert torch.allclose(got, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(1, 16), (4, 256), (3, 5000), (1000, 32)])
def test_k4_reverse_walk_is_the_forward_on_flipped_rows(cuda, shape):
    rng = np.random.default_rng(19)
    a = torch.from_numpy(1 - rng.uniform(0, 1, shape).astype(np.float32)
                         ).to(cuda)
    g = keys(shape, torch.float32, 20, cuda)
    got = ps.chunk_scan_kernel(a, g, reverse=True)
    want = ps.chunk_scan_kernel(a.flip(1), g.flip(1)).flip(1)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_k4", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k4_statescan_backward_within_the_summation_bound(cuda, smoke):
    # the Function's backward on the card, in kernel and interpret modes,
    # held as chip_smoke's phase L holds it (statescan_grad_misses): λ
    # within G's first-order bound of float64 counted from the end, the
    # two modes' λ within it of each other, da = Σ_{P,N} λ[c]·y[c−1]
    # within the bound carried through the product and the reduction
    rng = np.random.default_rng(21)
    shape = (2, 24, 4)
    a = torch.from_numpy(1 - rng.uniform(0, 1, shape).astype(np.float32)
                         ).to(cuda).requires_grad_()
    s = keys(shape + (8, 16), torch.float32, 22, cuda).requires_grad_()
    g = keys(shape + (8, 16), torch.float32, 23, cuda)
    grads = {}
    for mode in ("kernel", "interpret"):
        y = ops.chunk_scan_state(a, s, axis=1, mode=mode)
        grads[mode] = torch.autograd.grad(y, (a, s), g)
    bad, _ = smoke.statescan_grad_misses(grads, a.detach(), s.detach(), g)
    assert not any(bad.values()), bad
    # the fused da: the interpret mode's reduction bit for bit, and the
    # same bits on a second run (no atomics)
    for i in (0, 1):
        assert torch.equal(grads["kernel"][i], grads["interpret"][i])
    y = ops.chunk_scan_state(a.detach(), s.detach(), axis=1, mode="kernel")
    first = ps.state_scan_grad(a.detach(), y, g, 1)
    assert torch.equal(first[0], ps.state_scan_grad(a.detach(), y, g, 1)[0])


@pytest.mark.parametrize("a_shape,s_shape,axis", [
    ((4, 16, 64), (4, 16, 64, 64, 128), 1),      # chip_smoke L's train step
    ((4, 8, 64), (4, 8, 64, 50, 16), 1),         # Hymba-1.5B: P·N = 800
    ((3, 5, 7), (3, 5, 7, 9, 11), 1),            # ragged
    ((2, 8, 4), (2, 8, 4, 3, 5), -2),            # past the decay's dims
    ((2, 8, 1), (2, 8, 4, 3, 5), 1),             # a broadcast decay
    ((2, 80, 3), (2, 80, 3, 4, 4), 1),           # batches of chunks
])
def test_k4_fused_da_is_its_plain_reduction(cuda, a_shape, s_shape, axis):
    # the reverse walk's da and its second pass against state_da_plain
    # (the same reduction in torch) bit for bit, λ against the plain
    # walk, and da within n·eps·Σ|λ·y| of the unfused product's sum
    rng = np.random.default_rng(24)
    a = torch.from_numpy(1 - rng.uniform(0, 1, a_shape).astype(np.float32)
                         ).to(cuda)
    s = keys(s_shape, torch.float32, 25, cuda)
    g = keys(s_shape, torch.float32, 26, cuda)
    y = ps.chunk_scan_state_kernel(a, s, axis)
    before = (ps.K4.reverse_launches, ps.K4.da_launches)
    da, lam = ps.state_scan_grad(a, y, g, axis)
    assert (ps.K4.reverse_launches, ps.K4.da_launches) == (
        before[0] + 1, before[1] + 1)
    pda, plam = ps.state_scan_grad(a, y, g, axis, interpret=True)
    assert torch.equal(lam, plam) and torch.equal(da, pda)
    ax = axis % len(s_shape)
    want = ps._prev_product(lam, y, ax, a.ndim)
    absum = ps._prev_product(lam.abs(), y.abs(), ax, a.ndim)
    terms = math.prod(s_shape) // want.numel()
    eps = float(torch.finfo(torch.float32).eps)
    assert da.shape == want.shape
    assert bool(((da - want).abs() <= terms * eps * absum).all())

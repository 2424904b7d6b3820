"""repro_torch's sorting networks (c2_sort, c1_merge, the mergesort app)
against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its jnp oracles) and ``repro_torch`` (the plain
network K5/K6 are held against, in ``interpret`` mode, and its torch
oracles). Sorts and merges are exact, so every comparison is bit-exact.
bfloat16 inputs are float32 values that bfloat16 represents exactly, so
both frameworks hold identical bits.

The CUDA kernels themselves run only on the card
(tests/test_torch_scan_sort_kernels.py).
"""
import importlib.util
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sortnet as jsn
from repro_torch.kernels import _cuda
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sortnet as sn

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)
JNP = {"float32": jnp.float32, "int32": jnp.int32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "int32": torch.int32,
         "bfloat16": torch.bfloat16}
# the reference's mergesort app in interpret mode, compiled once per shape
# rather than op by op (eagerly it takes seconds a shape on the CPU)
jmergesort = jax.jit(jops.sortnet_mergesort,
                     static_argnames=("base_width", "max_kernel_width", "mode"))


def arr(shape, dtype):
    """numpy input for both packages (bf16: exactly representable f32)."""
    if dtype == "int32":
        return RNG.integers(-10_000, 10_000, shape).astype(np.int32)
    x = RNG.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def both(x, dtype):
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def same(got, want):
    np.testing.assert_array_equal(as_np(got), as_np(want))


# ---------------------------------------------------------------------------
# c2_sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("shape,width", [
    ((1, 8), 8), ((5, 64), 8), ((16, 256), 16), ((3, 128), 4),
    ((7, 32), 32), ((2, 1024), 64),
])
def test_sort_chunks_matches_jax(shape, width, dtype):
    jx, tx = both(arr(shape, dtype), dtype)
    want = jops.sort_chunks(jx, width=width, mode="interpret")
    same(want, jref.sort_chunks(jx, width=width))
    same(ops.sort_chunks(tx, width=width, mode="interpret"), want)
    same(ops.sort_chunks(tx, width=width, mode="ref"), want)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 32)], ids=["2d", "3d"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_descending_and_3d_match_jax(shape, descending):
    jx, tx = both(arr(shape, "float32"), "float32")
    want = jops.sort_chunks(jx, width=8, descending=descending,
                            mode="interpret")
    for mode in ("interpret", "ref"):
        same(ops.sort_chunks(tx, width=8, descending=descending, mode=mode),
             want)


@pytest.mark.parametrize("descending", [False, True])
def test_payload_network_matches_jax(descending):
    # the key/payload tiebreak K7 (top-k) needs: heavy ties on purpose
    keys = RNG.integers(0, 4, (6, 64)).astype(np.float32)
    lane = np.broadcast_to(np.arange(64, dtype=np.int32), keys.shape).copy()
    jk, jp = jsn.bitonic_sort_network(jnp.asarray(keys), jnp.asarray(lane),
                                      descending=descending)
    tk, tp = sn.bitonic_sort_network(torch.from_numpy(keys),
                                     torch.from_numpy(lane),
                                     descending=descending)
    same(tk, jk)
    same(tp, jp)


@pytest.mark.parametrize("width", [2, 8, 64, 4096])
def test_n_cas_layers_matches_jax(width):
    assert sn.n_cas_layers(width) == jsn.n_cas_layers(width)


# ---------------------------------------------------------------------------
# c1_merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("rows,w", [(1, 8), (4, 16), (9, 64), (16, 128)])
def test_merge_sorted_matches_jax(rows, w, dtype):
    a = np.sort(arr((rows, w), dtype), axis=-1)
    b = np.sort(arr((rows, w), dtype), axis=-1)
    (ja, ta), (jb, tb) = both(a, dtype), both(b, dtype)
    wlo, whi = jops.merge_sorted(ja, jb, mode="interpret")
    for mode in ("interpret", "ref"):
        lo, hi = ops.merge_sorted(ta, tb, mode=mode)
        same(lo, wlo)
        same(hi, whi)


@pytest.mark.parametrize("descending", [False, True])
def test_merge_kernel_plain_matches_jax_chunked(descending):
    w = 16
    order = -1 if descending else 1
    a = np.sort(arr((3, 4 * w), "float32").reshape(3, 4, w),
                axis=-1)[..., ::order].reshape(3, 4 * w).copy()
    b = np.sort(arr((3, 4 * w), "float32").reshape(3, 4, w),
                axis=-1)[..., ::order].reshape(3, 4 * w).copy()
    # the reference's kernel merges ascending chunks; descending reverses
    # the merged order, as the plain network does
    wlo, whi = jsn.merge_sorted_pallas(jnp.asarray(a), jnp.asarray(b),
                                       width=w, descending=descending,
                                       block_rows=3, interpret=True)
    lo, hi = sn.merge_sorted_kernel(torch.from_numpy(a), torch.from_numpy(b),
                                    width=w, descending=descending,
                                    interpret=True)
    same(lo, wlo)
    same(hi, whi)


# ---------------------------------------------------------------------------
# the mergesort application (paper §4.3.1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64, 512, 4096])
def test_mergesort_app_matches_jax(n):
    x = arr((3, n), "float32")
    want = jmergesort(jnp.asarray(x), mode="interpret")
    np.testing.assert_array_equal(np.asarray(want), np.sort(x, axis=-1))
    for mode in ("interpret", "ref"):
        same(ops.sortnet_mergesort(torch.from_numpy(x), mode=mode), want)


def test_mergesort_large_fallback_matches_jax():
    # above max_kernel_width the base core (a library sort) finishes
    x = arr((1, 16384), "float32")
    want = jmergesort(jnp.asarray(x), max_kernel_width=1024,
                                  mode="interpret")
    got = ops.sortnet_mergesort(torch.from_numpy(x), max_kernel_width=1024,
                                mode="interpret")
    same(got, want)
    same(got, np.sort(x, axis=-1))
    assert torch.equal(ref.mergesort(torch.from_numpy(x)), got)


def test_mergesort_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        ops.sortnet_mergesort(torch.zeros(1, 24), mode="interpret")


# ---------------------------------------------------------------------------
# odd-even mergesort topology (paper §2.2's other network)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 8, 32, 128, 512])
def test_oddeven_network_matches_jax(w):
    x = arr((6, w), "float32")
    got = sn.oddeven_sort_network(torch.from_numpy(x))
    same(got, jsn.oddeven_sort_network(jnp.asarray(x)))
    same(got, np.sort(x, axis=-1))


def test_oddeven_matches_bitonic():
    x = torch.from_numpy(arr((4, 64), "float32"))
    assert torch.equal(sn.oddeven_sort_network(x),
                       sn.bitonic_sort_network(x))


# ---------------------------------------------------------------------------
# wrapper checks and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interpret", [True, False])
def test_wrappers_reject_what_the_reference_rejects(interpret):
    x = torch.zeros(2, 48)
    jx = jnp.zeros((2, 48))
    with pytest.raises(ValueError, match="power of two"):
        jsn.sort_chunks_pallas(jx, width=12, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        sn.sort_chunks_kernel(x, width=12, interpret=interpret)
    with pytest.raises(ValueError, match="nest evenly"):
        sn.sort_chunks_kernel(x, width=32, interpret=interpret)
    with pytest.raises(ValueError, match="operands must match"):
        jsn.merge_sorted_pallas(jx, jnp.zeros((2, 48), jnp.int32),
                                interpret=True)
    with pytest.raises(ValueError, match="operands must match"):
        sn.merge_sorted_kernel(x, x.int(), interpret=interpret)
    with pytest.raises(ValueError, match="power of two"):
        sn.merge_sorted_kernel(x, x, width=3, interpret=interpret)


def test_kernel_limits_are_named():
    x = torch.zeros(2, 8192)
    with pytest.raises(ValueError, match="at most 4096"):
        sn.sort_chunks_kernel(x, width=8192)
    with pytest.raises(ValueError, match="at most 2048"):
        sn.merge_sorted_kernel(x, x, width=4096)
    # the plain network has no such limit
    assert sn.sort_chunks_kernel(x, width=8192, interpret=True).shape == (
        2, 8192)


def test_kernel_mode_on_cpu_tensors_raises():
    x = torch.from_numpy(arr((2, 64), "float32"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sort_chunks(x, width=8, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.merge_sorted(x, x, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sortnet_mergesort(x, mode="kernel")
    # auto follows the tensors: the oracle for CPU tensors
    assert torch.equal(ops.sort_chunks(x, width=8, mode="auto"),
                       ref.sort_chunks(x, width=8))


def test_sort_registrations_mirror_jax():
    from repro.core import isa as jisa
    from repro_torch.core import isa
    for name in ("c2_sort", "c1_merge"):
        got, want = isa.get(name), jisa.get(name)
        assert got.spec == type(got.spec)(**vars(want.spec))
        assert got.pipeline_depth == want.pipeline_depth
        assert got.doc == want.doc
        assert got.template is None and want.template is None


def test_cuda_source_exports_the_bound_launchers():
    src = (_cuda.CSRC / "sortnet.cu").read_text()
    for name, argtypes in sn._SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes)
    assert "repro_cuda_error_string" in src
    assert "__shfl_xor_sync" in src and "__syncthreads" in src


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114k3_scan_kernelIfEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114k3_scan_kernelIfEEvPKT_
    0 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 18480 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12tc14k8_flash_wgmmaILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Used 242 registers, used 1 barriers
"""


def test_ptxas_report_and_kernel_names_are_read(smoke):
    # what chip_smoke.py reports of each CUDA source's build (the mangled
    # names go through cu++filt on the card's machine)
    usage = _cuda.ptxas_usage(_PTXAS)
    assert usage == {
        "_ZN12_GLOBAL__N_114k3_scan_kernelIfEEvPKT_": {
            "registers": 32, "smem_bytes": 18480, "spill_stores": 28},
        "_ZN12_GLOBAL__N_12tc14k8_flash_wgmmaILi128EEEv14CUtensorMap_st": {
            "registers": 242, "smem_bytes": 0, "spill_stores": 0}}
    assert smoke.kernel_name(
        "void (anonymous namespace)::k3_scan_kernel<float>(float const*, "
        "float*, long, long, long, unsigned long long*, unsigned long "
        "long*, int, int)") == "k3_scan_kernel<float>"
    assert smoke.kernel_name(
        "void (anonymous namespace)::tc::k8_flash_wgmma<(int)128>"
        "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
        "int, int, int, int, int, (anonymous namespace)::Strides, float, "
        "int)") == "k8_flash_wgmma<128>"
    assert smoke.kernel_name("k7_topk_kernel<__nv_bfloat16>") \
        == "k7_topk_kernel<__nv_bfloat16>"


def test_library_name_follows_the_source_hash(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    p = _cuda.library_path("sortnet")
    assert p.parent == tmp_path / "cuda" and p.name.startswith("sortnet_")
    assert p == _cuda.library_path("sortnet")


_CHILD = textwrap.dedent("""
    import sys
    import repro_torch.kernels
    from repro_torch.kernels import _cuda, ops
    assert ops.sortnet_mergesort and _cuda._LOADED == {}
    bad = [m for m in ("jax", "repro", "triton") if m in sys.modules]
    assert not bad, bad
    print("ok")
""")


def test_import_loads_no_jax_triton_or_cuda_library():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# chip_smoke.py's phase E at tiny size, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_sortnet",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_phase_e_matches_jax(smoke):
    v = smoke.sort_keys(0, 1 << 13, "cpu")
    want = jmergesort(jnp.asarray(v.numpy())[None],
                                  max_kernel_width=1024, mode="interpret")[0]
    got = smoke.phase_e(v, "interpret")
    same(got, want)
    assert torch.equal(got, torch.sort(v).values)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_e(v, "kernel")


# ---------------------------------------------------------------------------
# K6's layouts (csrc/sortnet.cu), emulated on the CPU: where each key sits
# in each layout, the swizzled shared tile, the vector runs and the masked
# tail, thread by thread, held against the plain network. The kernel
# itself runs only on the card.
# ---------------------------------------------------------------------------

K6_THREADS, K6_TILE, K6_PER = 256, 4096, 16


def k6_swz(i):
    return i ^ ((i >> 5) & 15) ^ ((i >> 4) & 16)


def k6_layout_base(q):
    t = torch.arange(K6_THREADS)
    lane, warp = t & 31, t >> 5
    if q == 2:
        return lane | (warp << 5)
    if q == 1:
        return (lane & 15) | ((lane >> 4) << 8) | (warp << 9)
    return (lane << 4) | (warp << 9)


def k6_cas(x, y, up):
    """cas(x, y, lower=True, up) and cas(y, x, lower=False, up)."""
    return (torch.where((x <= y) == up, x, y),
            torch.where((y < x) == (not up), y, x))


def k6_emulated(a, b, w, descending=False, aligned=True):
    """K6's data flow for the tiles of (a, b): per thread, the first
    layout's loads (8-key runs at L ≤ 4 where the launcher allows them;
    ``aligned`` stands for its pointer check), each layout's in-register
    layers, the transposes through the swizzled tile and the stores from
    layout 0."""
    rows, cols = a.shape
    L = (2 * w).bit_length() - 1
    W, q0, up = w, (L - 1) // 4, not descending
    cpr = cols // w
    per_vec = 16 // a.element_size()
    vec = (aligned and cols % 8 == 0 and a.stride(0) % per_vec == 0
           and b.stride(0) % per_vec == 0)
    n_virtual = 2 * rows * cpr * w
    ac, bc = ((t.float() if t.dtype == torch.bfloat16 else t) for t in (a, b))
    lo = torch.zeros(rows * cols, dtype=ac.dtype)
    hi = torch.zeros_like(lo)

    def locate(c):
        row = c // cpr
        return row, (c - row * cpr) << (L - 1)

    def key_at(g):
        valid = g < n_virtual
        g = torch.where(valid, g, 0)
        row, col = locate(g >> L)
        m = g & (2 * W - 1)
        ka = ac[row, (col + m).clamp(max=cols - 1)]
        kb = bc[row, (col + 2 * W - 1 - m).clamp(min=0, max=cols - 1)]
        return torch.where(valid, torch.where(m < W, ka, kb),
                           torch.zeros((), dtype=ac.dtype))

    def layers(v, q):
        for bit in range(min(4 * q + 3, L - 1), 4 * q - 1, -1):
            s = bit - 4 * q
            for e in range(K6_PER):
                f = e | (1 << s)
                if f != e:
                    v[:, e], v[:, f] = k6_cas(v[:, e], v[:, f], up)

    def transpose(v, qf, qt):
        smem = torch.empty(K6_TILE, dtype=v.dtype)
        for e in range(K6_PER):
            smem[k6_swz(k6_layout_base(qf)) ^ k6_swz(e << 4 * qf)] = v[:, e]
        for e in range(K6_PER):
            v[:, e] = smem[k6_swz(k6_layout_base(qt)) ^ k6_swz(e << 4 * qt)]

    for tile in range(-(-n_virtual // K6_TILE)):
        v = torch.empty((K6_THREADS, K6_PER), dtype=ac.dtype)
        base = k6_layout_base(q0)
        if L <= 4:
            g0 = tile * K6_TILE + base
            for t in range(K6_PER):
                v[:, t] = key_at(g0 + t)
            run = vec & (g0 + K6_PER <= n_virtual)
            if run.any():
                row, col = locate(g0[run] >> L)
                k8 = torch.arange(8)
                ra = ac[row[:, None], col[:, None] + k8]
                rb = bc[row[:, None], col[:, None] + k8]
                for t in range(K6_PER):
                    j, m = t >> L, t & (2 * W - 1)
                    v[run, t] = (ra[:, j * W + m] if m < W
                                 else rb[:, j * W + 2 * W - 1 - m])
        else:
            for e in range(K6_PER):
                v[:, e] = key_at(tile * K6_TILE + (base | (e << 4 * q0)))
        layers(v, q0)
        if q0 == 2:
            transpose(v, 2, 1)
            layers(v, 1)
        if q0 >= 1:
            transpose(v, 1, 0)
            layers(v, 0)
        g0 = tile * K6_TILE + k6_layout_base(0)
        for th in range(K6_THREADS):
            g = int(g0[th])
            if g >= n_virtual:
                continue
            if L >= 5:
                m0 = g & (2 * W - 1)
                at = ((g >> L) << (L - 1)) + (m0 & (W - 1))
                (lo if m0 < W else hi)[at:at + K6_PER] = v[th]
                continue
            for t in range(min(K6_PER, n_virtual - g)):
                m = t & (2 * W - 1)
                at = (((g + t) >> L) << (L - 1)) + (m & (W - 1))
                (lo if m < W else hi)[at] = v[th, t]
    return (lo.to(a.dtype).reshape(rows, cols),
            hi.to(a.dtype).reshape(rows, cols))


@pytest.mark.parametrize("q", [0, 1, 2])
def test_k6_layouts_cover_the_tile_and_hit_every_bank(q):
    base = k6_layout_base(q)
    idx = torch.stack([base | (e << 4 * q) for e in range(K6_PER)], 1)
    assert torch.equal(idx.flatten().sort().values, torch.arange(K6_TILE))
    assert torch.equal(k6_swz(torch.arange(K6_TILE)).sort().values,
                       torch.arange(K6_TILE))
    for e in range(K6_PER):
        word = k6_swz(idx[:, e])
        # XOR-linear: the kernel adds each register's part as a constant
        assert torch.equal(word, k6_swz(base) ^ k6_swz(e << 4 * q))
        for warp in (word % 32).view(8, 32):      # one warp access
            assert len(set(warp.tolist())) == 32


def k6_keys(shape, dtype, seed):
    """Sorted chunks drawn from few values, with ties, ±0.0 and NaN."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-3, 3, shape, dtype=np.int32))
    pool = np.array([-2.5, -0.0, 0.0, 1.0, 1.0, np.nan, 7.0], np.float32)
    x = torch.from_numpy(rng.choice(pool, shape))
    return x.to(TORCH[dtype])


@pytest.mark.parametrize("w", [1 << k for k in range(12)])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("rows,chunks", [(3, 0), (1, 5)])
def test_k6_layouts_merge_as_the_network(w, dtype, descending, rows, chunks):
    # 3 rows of ≥ 3 chunks (at least 24 keys, so that L ≤ 4 takes its
    # 8-key runs), or one row of 5 chunks (10w merged keys: at w < 8 a
    # thread's last run is cut short); both leave a ragged last tile
    cols = chunks * w or 3 * max(w, 8)
    x = k6_keys((rows, 2 * cols), dtype, w)
    x = torch.sort(x.view(rows, 2, -1, w), -1).values.view(rows, 2 * cols)
    a, b = x[:, :cols], x[:, cols:]               # rows strided 2·cols
    want = sn.merge_sorted_plain(a, b, w, descending)
    for aligned in (True, False):
        got = k6_emulated(a, b, w, descending, aligned)
        for g, p in zip(got, want):
            assert torch.equal(g.view(torch.int16 if g.dtype ==
                                      torch.bfloat16 else torch.int32),
                               p.view(torch.int16 if p.dtype ==
                                      torch.bfloat16 else torch.int32))


# ---------------------------------------------------------------------------
# K5's layouts (csrc/sortnet.cu): one instance per width, emulated on the
# CPU thread by thread — 16 consecutive keys a thread in layout 0, layers
# on register bits in the thread, on lane bits through the shuffle
# partner, stages past bit 8 through layout 2 and back — held against the
# plain network. The kernel itself runs only on the card.
# ---------------------------------------------------------------------------

def k5_cas(x, y, lower, up):
    """cas(self=x, other=y, lower, up), elementwise over threads."""
    keep_lo = up if lower else ~up
    self_is_lo = (x <= y) if lower else (x < y)
    return torch.where(keep_lo == self_is_lo, x, y)


def k5_stage_slot(u, per_thread_vectors):
    """sortnet.cu stage_slot<U>: where vector u of a warp's span sits."""
    U = per_thread_vectors
    t = u // U
    return t * U + ((u % U) ^ ((t // (8 // U)) & (U - 1)))


def k5_emulated(x, width, descending=False, aligned=True):
    """K5's data flow for the tiles of x (rows of whole chunks): each
    warp whose 512 keys all exist (and ``aligned``: the pointer check)
    moves them as 16-byte vectors through its swizzled stage, the others
    key by key (keys past the end are 0), giving each thread 16
    consecutive keys of layout 0; stages S = 1 … L, each its layers on
    bits S-1 … 0 — in layout 0 up to S = 9; from S = 10 bits S-1 … 8 in
    layout 2 between two transposes through the swizzled tile — and the
    stores from layout 0 the same way back."""
    flat = x.reshape(-1)
    n = flat.numel()
    L = width.bit_length() - 1
    keys = flat.float() if flat.dtype == torch.bfloat16 else flat
    out = torch.zeros(n, dtype=keys.dtype)
    t = torch.arange(K6_THREADS)
    lane, warp = t & 31, t >> 5
    per_vec = 16 // x.element_size()               # keys of one vector
    U = K6_PER // per_vec                          # vectors a thread
    slot = lambda u: k5_stage_slot(u, U)           # noqa: E731

    def layer(v, q, bit, s):
        base = k6_layout_base(q)
        for e in range(K6_PER):
            up = ((s == L) | ((((base | (e << 4 * q)) >> s) & 1) == 0)
                  ) != descending
            if 4 * q <= bit < 4 * q + 4:          # a register bit
                f = e | (1 << (bit - 4 * q))
                if f != e:
                    a, b = v[:, e].clone(), v[:, f].clone()
                    v[:, e], v[:, f] = (k5_cas(a, b, True, up),
                                        k5_cas(b, a, False, up))
            else:                                 # a lane bit of layout 0
                assert q == 0 and 4 <= bit <= 8
                m = 1 << (bit - 4)
                lower = (t & m) == 0
                other = v[t ^ m, e]
                v[:, e] = torch.where(lower, k5_cas(v[:, e], other, True, up),
                                      k5_cas(v[:, e], other, False, up))

    def transpose(v, qf, qt):
        smem = torch.empty(K6_TILE, dtype=v.dtype)
        for e in range(K6_PER):
            smem[k6_swz(k6_layout_base(qf)) ^ k6_swz(e << 4 * qf)] = v[:, e]
        for e in range(K6_PER):
            v[:, e] = smem[k6_swz(k6_layout_base(qt)) ^ k6_swz(e << 4 * qt)]

    for tile in range(-(-n // K6_TILE)):
        w0 = tile * K6_TILE + warp * 32 * K6_PER
        g0 = w0 + lane * K6_PER                    # layout 0
        whole = aligned & (w0 + 32 * K6_PER <= n)  # warp-uniform
        v = torch.stack([torch.where(g0 + e < n, keys[(g0 + e).clamp(
            max=n - 1)], torch.zeros((), dtype=keys.dtype))
            for e in range(K6_PER)], 1)
        for w in range(8):                         # the staged warps
            if not bool(whole[32 * w]):
                continue
            span = keys[int(w0[32 * w]):][:32 * K6_PER].view(-1, per_vec)
            stage = torch.empty_like(span)
            for j in range(U):
                u = j * 32 + torch.arange(32)
                stage[slot(u)] = span[u]
            for ln in range(32):
                got = stage[slot(ln * U + torch.arange(U))].reshape(-1)
                v[32 * w + ln] = got
        for s in range(1, L + 1):
            if s <= 9:
                for bit in range(s - 1, -1, -1):
                    layer(v, 0, bit, s)
                continue
            transpose(v, 0, 2)
            for bit in range(s - 1, 7, -1):
                layer(v, 2, bit, s)
            transpose(v, 2, 0)
            for bit in range(7, -1, -1):
                layer(v, 0, bit, s)
        for w in range(8):
            if bool(whole[32 * w]):                # back through the stage
                stage = torch.empty(32 * U, per_vec, dtype=v.dtype)
                for ln in range(32):
                    stage[slot(ln * U + torch.arange(U))] = v[
                        32 * w + ln].view(U, per_vec)
                at = int(w0[32 * w])
                out[at:at + 32 * K6_PER] = stage[slot(torch.arange(
                    32 * U))].reshape(-1)
                continue
            for e in range(K6_PER):
                g = g0[32 * w:32 * w + 32] + e
                out[g[g < n]] = v[32 * w:32 * w + 32][g < n, e]
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("per_thread_vectors", [4, 2])   # 4-byte, bf16
def test_k5_stage_is_a_permutation_without_bank_conflicts(per_thread_vectors):
    U = per_thread_vectors
    u = torch.arange(32 * U)
    slots = k5_stage_slot(u, U)
    assert torch.equal(slots.sort().values, u)
    for j in range(U):
        # lanes store consecutive vectors, then each reads its own U; a
        # 128-bit access runs a quarter-warp (8 lanes) at a time and needs
        # 8 distinct 16-byte bank groups (slot mod 8)
        for access in (k5_stage_slot(j * 32 + torch.arange(32), U),
                       k5_stage_slot(torch.arange(32) * U + j, U)):
            for quarter in access.view(4, 8):
                assert len(set((quarter % 8).tolist())) == 8


@pytest.mark.parametrize("width", [1 << k for k in range(1, 13)])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("descending", [False, True])
def test_k5_layouts_sort_as_the_network(width, dtype, descending):
    # ≥ 4500 keys: two tiles or more, and below width 4096 a ragged last
    # tile (at width < 16 a thread's last run is cut short)
    cols = width * -(-1500 // width)
    x = k6_keys((3, cols), dtype, width)
    got = k5_emulated(x, width, descending, aligned=width != 64)
    want = sn.sort_chunks_plain(x, width, descending)
    view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))

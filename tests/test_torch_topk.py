"""repro_torch's c5_topk (the MoE router's top-k) against the JAX package.

The same seeded numpy inputs go through ``repro`` (Pallas in
``interpret`` mode, and its ``lax.top_k`` oracle) and ``repro_torch``
(the JAX kernel's network as plain PyTorch, in ``interpret`` mode, and
the oracle ``ref.topk``). Top-k is exact, ties included (equal keys in
ascending index order), so every comparison is bit-exact. bfloat16
inputs are float32 values that bfloat16 represents exactly, or bit
patterns (NaN of either sign, ±0.0) given to both packages as bits.

K7 itself runs only on the card (tests/test_torch_lm_kernels.py); its
partial walk (k ≤ 32) is emulated here lane by lane (``topk_emulated``).
"""
import re

import jax
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
    # k ≤ 32 takes rows of any width (the CPU tensor then stops at the
    # device check); the full network (k > 32) rows of at most 4096
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.topk_kernel(torch.zeros(1, 8192), 32)
    with pytest.raises(ValueError, match="at most 4096 keys for k > 32"):
        tk.topk_kernel(torch.zeros(1, 8192), 33)
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


# ---------------------------------------------------------------------------
# lax.top_k's order on signed zeros and NaN, and K7's partial walk
# ---------------------------------------------------------------------------

NAN, NEG_NAN = 0x7FC00000, 0xFFC00000
POOL = np.array([0x80000000, 0x0, NAN, NEG_NAN, 0x7F800000, 0xFF800000,
                 0x3F800000, 0xBF800000, 0x40200000], np.uint32)


def special_bits(rows, n, seed):
    """float32 bit patterns: row 0 eight -0.0, eight +0.0, then -1.0; row 1
    all NaN; row 2 all sign-bit NaN; the rest drawn from ±0.0, NaN of
    either sign, ±inf, ±1.0 and 2.5."""
    rng = np.random.default_rng(seed)
    bits = rng.choice(POOL, (rows, n))
    bits[0] = 0xBF800000
    bits[0, :min(n, 8)] = 0x80000000
    bits[0, 8:16] = 0x0
    bits[1], bits[2] = NAN, NEG_NAN
    return bits


def from_bits(bits, dtype):
    """The same bits in both packages (bfloat16: the upper half)."""
    if dtype == "bfloat16":
        b = (bits >> 16).astype(np.uint16)
        return (torch.from_numpy(b.view(np.int16)).view(torch.bfloat16),
                jax.lax.bitcast_convert_type(jnp.asarray(b), jnp.bfloat16))
    return (torch.from_numpy(bits.view(np.int32)).view(torch.float32),
            jnp.asarray(bits.view(np.float32)))


def bits_of(t):
    if isinstance(t, torch.Tensor):
        view = {2: torch.int16, 4: torch.int32}[t.element_size()]
        return t.view(view).numpy()
    view = {2: jnp.int16, 4: jnp.int32}[t.dtype.itemsize]
    return np.asarray(jax.lax.bitcast_convert_type(t, view))


def same_topk_bits(got, want):
    (v, i), (wv, wi) = got, want
    np.testing.assert_array_equal(bits_of(v), bits_of(wv))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
    assert i.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_topk_orders_signed_zeros_and_nan_as_lax_top_k(dtype):
    x, jx = from_bits(special_bits(8, 64, 3), dtype)
    for k in (1, 8, 16, 64):
        same_topk_bits(ref.topk(x, k), jref.topk(jx, k))
    assert ref.topk(x, 8)[1][0].tolist() == list(range(8, 16))


def k7_lanes(rows, npow, vw):
    """G, the lanes that own a row (topk.cu, launch_partial_kp)."""
    log2_g = 5
    while log2_g > 3 and rows << log2_g > 32768:
        log2_g -= 1
    return 1 << min(log2_g, max(npow.bit_length() - vw.bit_length(), 0))


def merge_top(lists, b):
    """topk.cu merge_top: lists (..., KP) ∪ b (..., M ≤ KP), both
    descending: the elementwise max with b reversed (padded with empty
    slots), then the half-cleaners."""
    kp, m = lists.shape[-1], b.shape[-1]
    lists = lists.clone()
    lists[..., kp - m:] = torch.maximum(lists[..., kp - m:], b.flip(-1))
    h = kp // 2
    while h:
        for j in range(kp):
            if not j & h:
                a, c = lists[..., j].clone(), lists[..., j + h].clone()
                lists[..., j] = torch.maximum(a, c)
                lists[..., j + h] = torch.minimum(a, c)
        h //= 2
    return lists


def topk_emulated(x, k, npow=None, aligned=True):
    """K7's partial walk (csrc/topk.cu, k ≤ 32) on the CPU: the G lanes
    that own each row, each lane's stream in batches of B keys (16-byte
    vectors where ``aligned`` — the pointer check — and the row stride
    allow, else key by key), each batch sorted and merged into the
    lane's descending list of KP packed (key, index) words, the first KP
    pad lanes inserted one by one, and the shuffle rounds that merge the
    lists. Words pack (key + 2³¹, 2³¹ − 1 − index) into 62 bits, the
    kernel's (key ^ 2³¹, ~index) order; -1 is an empty slot."""
    rows, n = x.shape
    npow = n if npow is None else npow
    kp = 1 << (k - 1).bit_length()
    vw = 16 // x.element_size()
    bsz = min(max(kp, vw), 16)
    g = k7_lanes(rows, npow, vw)
    vec = aligned and x.stride(0) % vw == 0
    low = torch.finfo(x.dtype).min if x.dtype.is_floating_point else \
        torch.iinfo(x.dtype).min
    key = ref.sortable_key(x).long()
    low_key = int(ref.sortable_key(torch.tensor([low], dtype=x.dtype))[0])

    def words(idx):                      # (rows, len(idx)); None: empty
        cols = [((key[:, i] + 2**31) << 31) | (2**31 - 1 - i)
                if i is not None else torch.full((rows,), -1)
                for i in idx]
        return torch.stack(cols, 1)

    nv = n // vw if vec else 0
    lists = torch.full((rows, g, kp), -1, dtype=torch.long)
    for sub in range(g):
        batches = [[v * vw + t if v < nv else None
                    for v in range(v0, v0 + g * (bsz // vw), g)
                    for t in range(vw)]
                   for v0 in range(sub, nv, g * (bsz // vw))]
        batches += [[i if i < n else None for i in range(i0, i0 + g * bsz,
                                                         g)]
                    for i0 in range(nv * vw + sub, n, g * bsz)]
        lane = lists[:, sub]
        for batch in batches:                    # sort, then merge
            b = words(batch).sort(-1, descending=True).values
            lane = merge_top(lane, b[:, :min(bsz, kp)])
        for i in range(n + sub, min(npow, n + kp), g):   # the pads
            p = torch.full((rows,), ((low_key + 2**31) << 31)
                           | (2**31 - 1 - i))
            take = p > lane[:, -1]
            for j in range(kp):
                hi, p = (torch.maximum(lane[:, j], p),
                         torch.minimum(lane[:, j], p))
                lane[:, j] = torch.where(take, hi, lane[:, j])
        lists[:, sub] = lane
    off = 1
    while off < g:                               # the shuffle rounds
        lists = merge_top(lists, lists[:, torch.arange(g) ^ off])
        off *= 2
    assert (lists == lists[:, :1]).all()         # every lane of a row agrees
    top = lists[:, 0, :k]
    idx = (2**31 - 1 - (top & (2**31 - 1))).to(torch.int32)
    skey = (top >> 31) - 2**31
    if not x.dtype.is_floating_point:
        return skey.to(x.dtype), idx
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    sb = skey.to(bits)
    return (sb ^ ((sb >> (8 * sb.element_size() - 1))
                  & torch.iinfo(bits).max)).view(x.dtype), idx


def emulated_cases():
    """(n, npow, k) at the widths the walk must serve; 384 in place."""
    for n in (8, 384, 512, 4096, 8192):
        npow = 1 << (n - 1).bit_length()
        for k in (1, 2, 8, 32):
            if k <= npow:
                yield n, npow, k


def test_k7_lanes_a_row():
    # the decode step's 4 rows: a warp each; the prefill's 4096: 8 lanes
    assert [k7_lanes(r, 512, 4) for r in (4, 1024, 2048, 4096, 10**6)] \
        == [32, 32, 16, 8, 8]
    assert [k7_lanes(4, npow, vw) for npow, vw in ((8, 4), (8, 8), (2, 4))] \
        == [2, 1, 1]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,npow,k", list(emulated_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_walk_emulated_matches_the_oracle(dtype, n, npow, k, aligned):
    # the oracle on the padded rows (in place, lanes n … npow-1 are the
    # dtype minimum); at n = 384 a row stride of 387 keys takes the
    # key-by-key loads
    x, _ = from_bits(special_bits(5, n, n + k), dtype)
    if n == 384 and not aligned:
        wide = torch.zeros((5, 387), dtype=x.dtype)
        wide[:, :n] = x
        x = wide[:, :n]
    want = ref.topk(tk.pad_to(x.contiguous(), npow), k)
    same_topk_bits(topk_emulated(x, k, npow, aligned), want)


@pytest.mark.parametrize("n,npow,k", list(emulated_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_k7_walk_emulated_matches_the_network(dtype, n, npow, k):
    # no NaN and one sign of zero: the JAX kernel's network agrees
    x = torch.from_numpy(arr((6, n), dtype)).to(TORCH[dtype])
    x[1] = x[1, 0]                                  # one row of ties
    want = tk.topk_plain(tk.pad_to(x, npow), k)
    same_topk_bits(topk_emulated(x, k, npow), want)
    same_topk_bits(topk_emulated(x, k, npow), ref.topk(tk.pad_to(x, npow),
                                                       k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_walk_emulated_at_the_prefill_rows(dtype):
    # 4096 router rows of 384 in place of 512: 8 lanes a row
    x, _ = from_bits(special_bits(4096, 384, 11), dtype)
    x[3:] = torch.from_numpy(arr((4093, 384), dtype)).to(x.dtype)
    same_topk_bits(topk_emulated(x, 8, 512),
                   ref.topk(tk.pad_to(x, 512), 8))


# ---------------------------------------------------------------------------
# under autograd: c5_topk's Function, whose backward is lax.top_k's VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("rows,n,k,ties", [
    (16, 384, 8, False), (4, 151, 5, False), (8, 16, 4, True),
    (3, 8, 8, True)])
def test_topk_grad_is_lax_top_k_vjp_exactly(mode, rows, n, k, ties):
    # the values' cotangent scattered to the picked indices: ties go to
    # the index the forward picked (ascending index among equal keys),
    # as in jax.grad through lax.top_k
    x = (RNG.integers(0, 3, (rows, n)).astype(np.float32) if ties
         else arr((rows, n), "float32"))
    g = arr((rows, k), "float32")
    want = jax.grad(lambda x: jnp.sum(jax.lax.top_k(x, k)[0] * g))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    vals, idx = ops.topk(tx, k, mode=mode)
    assert not idx.requires_grad
    (got,) = torch.autograd.grad(vals, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_grad_keeps_the_input_dtype_and_leading_axes():
    x = torch.from_numpy(arr((2, 3, 64), "bfloat16")).to(
        torch.bfloat16).requires_grad_()
    vals, _ = ops.topk(x, 4, mode="interpret")
    (got,) = torch.autograd.grad(vals.float().sum(), x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert int((got != 0).sum()) == 2 * 3 * 4


def test_topk_function_passes_gradcheck():
    x = torch.from_numpy(RNG.standard_normal((5, 40))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: ops.topk(x, 6, mode="interpret")[0], (x,))

"""K1 (the generated Triton kernel) against its plain PyTorch emulator, on
the card. Every test here is marked ``gpu`` and skips without a CUDA
device; run them on an H100 with ``pytest -m gpu tests/test_torch_kernels.py``.

Tolerances: bit-exact where one rounding is involved (copy, scale, add,
per-item batch results against solo launches); ``4·eps·|chain on
|operands||`` where Triton contracts a multiply-add into an FMA; 2 ulp
where a body divides (Triton's fp32 ``/`` is ``div.full.f32``).
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the c0 ISA
from repro_torch.core import isa
from repro_torch.core.fused_kernel import K1
from repro_torch.core.template import KernelTemplate

pytestmark = pytest.mark.gpu

EPS = float(torch.finfo(torch.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a Triton kernel with no "
                    "CPU mode (its emulator is tested in test_torch_program)")
    return torch.device("cuda", 0)


def rand(n, seed, dev):
    x = np.random.default_rng(seed).standard_normal(n, dtype=np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("n", [1, 1000, 3 * 4096 + 5, 1 << 20])
@pytest.mark.parametrize("name,nv,scalars", [
    ("c0_copy", 1, ()), ("c0_scale", 1, (2.5,)), ("c0_add", 2, ()),
    ("c0_triad", 2, (3.0,))])
def test_c0_single_matches_emulator(cuda, name, nv, scalars, n):
    ops = [rand(n, k, cuda) for k in range(nv)] + list(scalars)
    before = K1.launches
    got = isa.call(name, *ops, mode="kernel")
    assert K1.launches == before + 1
    want = isa.call(name, *ops, mode="interpret")
    if name == "c0_triad":
        bound = 4 * EPS * (ops[0].abs() + 3.0 * ops[1].abs())
        assert bool(((got - want).abs() <= bound).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("names", [
    ("c0_scale", "c0_add"), ("c0_add", "c0_scale"), ("c0_copy", "c0_triad"),
    ("c0_scale", "c0_add", "c0_copy"), ("c0_triad", "c0_triad")],
    ids="+".join)
def test_fused_chain_one_launch(cuda, names):
    fused = isa.fuse(*names)
    n = 3 * 4096 + 5
    ops, seed = [], 0
    for sc, ext in fused.program.split_operands([None] * fused.spec.n_inputs):
        ops += [0.75] * len(sc)
        for _ in ext:
            ops.append(rand(n, seed, cuda))
            seed += 1
    before = K1.launches
    got = fused(*ops, mode="kernel")
    assert K1.launches == before + 1
    want = fused(*ops, mode="interpret")
    absops = [o.abs() if isinstance(o, torch.Tensor) else abs(o) for o in ops]
    bound = 4 * EPS * fused(*absops, mode="ref")
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("mixed", [False, True])
def test_call_batch_bit_identical_to_solo(cuda, mixed):
    fused = isa.fuse("c0_scale", "c0_add")
    n = 3 * 4096 + 5
    batch = [(0.5 + k if mixed else 2.0, rand(n, 2 * k, cuda),
              rand(n, 2 * k + 1, cuda)) for k in range(6)]
    before = K1.launches
    got = fused.program.call_batch(batch)
    assert K1.launches == before + 1
    for item, out in zip(batch, got):
        assert torch.equal(out, fused(*item, mode="kernel"))


def _absmax_template():
    def body(scalars, ins, carry, step):
        m = torch.maximum(carry, ins[0].abs().amax(dim=-1, keepdim=True))
        return (ins[0] / torch.clamp_min(m, 1e-9),), m

    return KernelTemplate(name="absmax", body=body, carry_cols=1,
                          triton_body="""
def absmax(x0, carry, step):
    m = tl.maximum(carry, tl.max(tl.abs(x0), axis=1)[:, None])
    return x0 / tl.maximum(m, 1e-9), m
""")


@pytest.mark.parametrize("n", [5, 3 * 4097 + 1, (1 << 20) - 1000, 1 << 20])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_call_batch_reads_items_in_place(cuda, n, mixed, dtype):
    # ragged n (odd, or a multiple of 4 but not of a block) is masked in
    # the kernel; each item is its own tensor and nothing is copied
    fused = isa.fuse("c0_scale", "c0_add")
    batch = [(0.5 + k if mixed else 2.0, rand(n, 2 * k, cuda).to(dtype),
              rand(n, 2 * k + 1, cuda).to(dtype)) for k in range(5)]
    before, copies = K1.launches, K1.item_copies
    got = fused.program.call_batch(batch)
    assert K1.launches == before + 1
    assert K1.item_copies == copies
    ptrs = {out.untyped_storage().data_ptr() for out in got}
    assert len(ptrs) == len(batch)
    for item, out in zip(batch, got):
        assert out.shape == (n,) and out.dtype == dtype
        assert out.untyped_storage().nbytes() == n * out.element_size()
        assert torch.equal(out, fused(*item, mode="kernel"))


def test_call_batch_copies_only_misaligned_or_strided_items(cuda):
    fused = isa.fuse("c0_scale", "c0_add")
    n = 3 * 4096 + 5
    big = rand(2 * n + 2, 9, cuda)
    batch = [(1.5, rand(n, 0, cuda), rand(n, 1, cuda)),
             (2.5, big[1:n + 1], rand(n, 2, cuda)),        # 4-byte offset
             (3.5, rand(n, 3, cuda), big[::2][:n]),         # strided
             (4.5, rand(n, 4, cuda), rand(n, 5, cuda))]
    assert big[1:n + 1].data_ptr() % 16
    before, copies = K1.launches, K1.item_copies
    got = fused.program.call_batch(batch)
    assert K1.launches == before + 1
    assert K1.item_copies == copies + 2
    for item, out in zip(batch, got):
        assert torch.equal(out, fused(*item, mode="kernel"))


def test_call_batch_of_a_carried_stage(cuda):
    prog = _absmax_template().program()
    items = [(rand(1000 * 4097, k, cuda).reshape(1000, 4097),)
             for k in range(4)]
    before = K1.launches
    got = prog.call_batch(items)
    assert K1.launches == before + 1
    plain = prog.call_batch(items, interpret=True)
    for (x,), out, p in zip(items, got, plain):
        assert out.shape == x.shape
        assert torch.equal(out, prog(x))
        ulp = (out.view(torch.int32).long()
               - p.view(torch.int32).long()).abs()
        assert int(ulp.max()) <= 2


def test_carried_template_within_two_ulp(cuda):
    def body(scalars, ins, carry, step):
        m = torch.maximum(carry, ins[0].abs().amax(dim=-1, keepdim=True))
        return (ins[0] / torch.clamp_min(m, 1e-9),), m

    t = KernelTemplate(name="absmax", body=body, carry_cols=1,
                       triton_body="""
def absmax(x0, carry, step):
    m = tl.maximum(carry, tl.max(tl.abs(x0), axis=1)[:, None])
    return x0 / tl.maximum(m, 1e-9), m
""")
    x = rand(64 * 4096, 7, cuda).reshape(64, 4096)
    got, want = t(x), t(x, interpret=True)
    ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 2


def test_bf16_chain_matches_emulator(cuda):
    fused = isa.fuse("c0_scale", "c0_add")
    x = rand(5000, 0, cuda).to(torch.bfloat16)
    b = rand(5000, 1, cuda).to(torch.bfloat16)
    got = fused(1.5, x, b, mode="kernel")
    want = fused(1.5, x, b, mode="interpret")
    assert got.dtype == torch.bfloat16
    # intermediates round to bf16 in both; the final add may differ by
    # one bf16 rounding of an FMA-contracted value
    bound = 2 * 2.0 ** -8 * (1.5 * x.float().abs() + b.float().abs())
    assert bool(((got.float() - want.float()).abs() <= bound).all())


# ---------------------------------------------------------------------------
# solo shape-changing stages: each output at its own width and dtype
# ---------------------------------------------------------------------------

def _split_body(scalars, ins, carry, step):
    x = ins[0]
    return (x[..., 0::2], x.to(torch.bfloat16)), carry


# two outputs of other widths and dtypes: x's even columns (rows, cols/2)
# float32, and x in bfloat16 (rows, cols)
SPLIT = KernelTemplate(
    name="even_and_bf16", body=_split_body, n_vec_out=2, block_rows=8,
    block_cols=1024, triton_body="""
def even_and_bf16(x0, carry, step):
    a, b = tl.split(tl.reshape(x0, (x0.shape[0], x0.shape[1] // 2, 2)))
    return a, x0.to(tl.bfloat16), carry
""", out_shapes=lambda x: [
        torch.empty((x.shape[0], x.shape[1] // 2), device="meta"),
        torch.empty(x.shape, dtype=torch.bfloat16, device="meta")])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def o1_templates():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_k1", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.O1_TEMPLATES


@pytest.mark.parametrize("shape", [(8, 1024), (24, 4096), (1024, 2048)])
@pytest.mark.parametrize("name", ["pairsum", "to_bf16"])
def test_shape_changing_stage_matches_emulator(cuda, o1_templates, name,
                                               shape):
    tpl, plain = o1_templates[name]
    x = rand(shape[0] * shape[1], 7, cuda).view(shape)
    before = K1.launches
    got = tpl(x)
    assert K1.launches == before + 1
    want = tpl(x, interpret=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(plain(x)))


def test_two_outputs_of_their_own_widths(cuda):
    x = rand(16 * 4096, 8, cuda).view(16, 4096)
    even, low = SPLIT(x)
    want_even, want_low = SPLIT(x, interpret=True)
    assert even.shape == (16, 2048) and low.dtype == torch.bfloat16
    assert torch.equal(even, want_even) and torch.equal(even, x[:, 0::2])
    assert torch.equal(_bits(low), _bits(want_low))
    assert torch.equal(_bits(low), _bits(x.to(torch.bfloat16)))

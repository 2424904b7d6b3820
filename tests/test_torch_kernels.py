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

"""repro_torch fused programs against the JAX package.

The same numpy inputs (seeded) go through ``repro`` (Pallas in
``interpret`` mode, or its jnp oracles) and ``repro_torch`` (K1's plain
PyTorch emulator in ``interpret`` mode, or its torch oracles):

* geometry negotiation picks the same ``(block_rows, block_cols)`` under
  the same model values and budget;
* c0 singles, the chains of tests/test_fusion.py and carried templates
  agree — bit-exact where the arithmetic is one rounding (copy, scale,
  add, max/divide), within ``4·eps_f32·|chain on |operands||`` where a
  multiply-add may be contracted into one FMA by XLA (and by Triton on
  the card) but is rounded twice by torch eager;
* ``call_batch`` items, shared and mixed scalars, are bit-identical to
  solo calls; warm calls renegotiate and rebuild nothing;
* ``kernel`` mode on CPU tensors raises;
* the chip smoke test's phases A–D, at tiny size through the emulator,
  match the JAX package.

The Triton kernel itself runs only on the card (tests/test_torch_kernels.py).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's c0 ISA
from repro.core import isa as jisa
from repro.core import program as jprog
from repro.core.burst_model import PAPER_AXI as JAX_AXI
from repro.core.burst_model import TPU_V5E_HBM
from repro.core.stream import VMEM_BYTES
from repro.core.template import KernelTemplate as JaxTemplate
from repro_torch.core import fused_kernel as fk
from repro_torch.core import isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import BurstModel
from repro_torch.core.isa import Instruction, OperandSpec, Registry
from repro_torch.core.program import Program
from repro_torch.core.stream import LANES
from repro_torch.core.template import KernelTemplate

EPS = float(np.finfo(np.float32).eps)
F32 = torch.float32


def rand(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n, dtype=np.float32)


def to_t(ops):
    return [torch.from_numpy(o) if isinstance(o, np.ndarray) else o
            for o in ops]


def to_j(ops):
    return [jnp.asarray(o) if isinstance(o, np.ndarray) else o for o in ops]


def abs_ops(ops):
    return [np.abs(o) if isinstance(o, np.ndarray) else abs(o) for o in ops]


@pytest.fixture
def fresh_caches():
    prog_mod.clear_dispatch_caches()
    prog_mod.reset_dispatch_stats()
    yield
    prog_mod.clear_dispatch_caches()


def jax_model_program(names, model=TPU_V5E_HBM, budget=VMEM_BYTES):
    """(JAX Program, port Program) for one chain under the same model
    values and budget — the port carries no TPU numbers itself."""
    jp = jprog.Program(tuple(jisa.get(n).template.stage() for n in names),
                       model=model, vmem_budget=budget)
    tp = Program(tuple(isa.get(n).template.stage() for n in names),
                 model=BurstModel(peak_bw=model.peak_bw,
                                  overhead_s=model.overhead_s),
                 smem_budget=budget)
    return jp, tp


CHAINS = [("c0_copy",), ("c0_scale",), ("c0_add",), ("c0_triad",),
          ("c0_scale", "c0_add"), ("c0_add", "c0_scale"),
          ("c0_copy", "c0_triad"), ("c0_scale", "c0_copy"),
          ("c0_scale", "c0_add", "c0_copy"), ("c0_add", "c0_triad"),
          ("c0_triad", "c0_triad")]


# ---------------------------------------------------------------------------
# geometry parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_geometry_parity(names):
    for model, budget in ((TPU_V5E_HBM, VMEM_BYTES), (JAX_AXI, 1 << 20),
                          (JAX_AXI, 1 << 16)):
        jp, tp = jax_model_program(names, model, budget)
        for n in (1, 777, 4096, 3 * 4096 + 5, 1 << 20, 1 << 26):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                want = jp._negotiate_scored(n, jdt)
                got = tp._negotiate_scored(n, tdt)
                assert got[:2] == want[:2], (names, model, budget, n)
                assert got[3] == want[3]
                assert got[2].block_bits == want[2].block_bits


def test_hopper_defaults_pick_register_sized_tiles():
    # a triad's 3 resident float32 tiles in the 232,448-byte budget bound
    # the tile to 8×1024; a two-stage chain (4 resident) to 8×512.
    triad = isa.fuse("c0_triad").program
    assert triad.negotiate_geometry(1 << 26, F32)[:2] == (8, 1024)
    chain = isa.fuse("c0_scale", "c0_add").program
    assert chain.negotiate_geometry(1 << 26, F32)[:2] == (8, 512)


def test_no_geometry_fits_raises():
    prog = Program(isa.fuse("c0_scale", "c0_add").program.stages,
                   smem_budget=1024)
    with pytest.raises(ValueError, match="shared-memory budget"):
        prog.negotiate_geometry(1 << 20, F32)


# ---------------------------------------------------------------------------
# numerical parity with the JAX package
# ---------------------------------------------------------------------------

SINGLES = {"c0_copy": (1, ()), "c0_scale": (1, (2.5,)),
           "c0_add": (2, ()), "c0_triad": (2, (3.0,))}


@pytest.mark.parametrize("n", [1000, 3 * 4096 + 5])
@pytest.mark.parametrize("name", sorted(SINGLES))
def test_c0_single_matches_jax(name, n):
    nv, scalars = SINGLES[name]
    ops = [rand(n, k) for k in range(nv)] + list(scalars)
    got_int = isa.call(name, *to_t(ops), mode="interpret").numpy()
    got_ref = isa.call(name, *to_t(ops), mode="ref").numpy()
    want_int = np.asarray(jisa.call(name, *to_j(ops), mode="interpret"))
    want_ref = np.asarray(jisa.call(name, *to_j(ops), mode="ref"))
    np.testing.assert_array_equal(got_int, got_ref)
    if name == "c0_triad":     # a + s·b: XLA may contract into one FMA
        bound = 4 * EPS * (np.abs(ops[0]) + abs(ops[2]) * np.abs(ops[1]))
        assert np.all(np.abs(got_int - want_int) <= bound)
        assert np.all(np.abs(got_ref - want_ref) <= bound)
    else:
        np.testing.assert_array_equal(got_int, want_int)
        np.testing.assert_array_equal(got_ref, want_ref)


FUSION_CASES = [
    (("c0_scale", "c0_add"), lambda: [3.0, rand(1000), rand(1000, 1)]),
    (("c0_add", "c0_scale"), lambda: [rand(777), rand(777, 1), 0.5]),
    (("c0_copy", "c0_triad"), lambda: [rand(4096), 2.0, rand(4096, 1)]),
    (("c0_scale", "c0_copy"), lambda: [-1.5, rand(300).reshape(6, 50)]),
    (("c0_scale", "c0_add", "c0_copy"),
     lambda: [2.0, rand(3000), rand(3000, 1)]),
    (("c0_add", "c0_triad"),
     lambda: [rand(512), rand(512, 1), 3.0, rand(512, 2)]),
    (("c0_triad", "c0_triad"),
     lambda: [2.0, rand(256), rand(256, 1), 0.5, rand(256, 2)]),
]


@pytest.mark.parametrize("names,make", FUSION_CASES,
                         ids=["+".join(c[0]) for c in FUSION_CASES])
def test_fused_chain_matches_jax(names, make):
    ops = make()
    fused, jfused = isa.fuse(*names), jisa.fuse(*names)
    got_int = fused(*to_t(ops), mode="interpret").numpy()
    got_ref = fused(*to_t(ops), mode="ref").numpy()
    np.testing.assert_array_equal(got_int, got_ref)
    want_int = np.asarray(jfused(*to_j(ops), mode="interpret"))
    want_ref = np.asarray(jfused(*to_j(ops), mode="ref"))
    assert got_int.shape == want_int.shape
    # rounding error bound: 4·eps times the chain run on |operands|
    bound = 4 * EPS * fused(*to_t(abs_ops(ops)), mode="ref").numpy()
    assert np.all(np.abs(got_int - want_int) <= bound)
    assert np.all(np.abs(got_ref - want_ref) <= bound)


def _running_sum_torch(scalars, ins, carry, step):
    s = carry + ins[0].sum(dim=-1, keepdim=True)
    return (ins[0] + 0 * s,), s


def _running_sum_jax(scalars, ins, outs, carry, step):
    s = carry[...] + jnp.sum(ins[0][...], axis=-1, keepdims=True)
    outs[0][...] = ins[0][...] + 0 * s
    carry[...] = s


def _prefix_max_torch(scalars, ins, carry, step):
    m = torch.maximum(carry, ins[0].amax(dim=-1, keepdim=True))
    return (ins[0] - m,), m


def _prefix_max_jax(scalars, ins, outs, carry, step):
    m = jnp.maximum(carry[...], jnp.max(ins[0][...], axis=-1,
                                        keepdims=True))
    outs[0][...] = ins[0][...] - m
    carry[...] = m


def test_carry_persists_across_column_steps():
    # twin of tests/test_template.py::test_carry_persists_across_grid_steps
    t = KernelTemplate(name="t", body=_running_sum_torch, block_rows=8,
                       block_cols=128, carry_cols=1)
    x = torch.ones((8, 1024), dtype=F32)
    assert torch.equal(t(x, interpret=True), x)
    assert t.pipeline_depth() == 2


def test_carried_template_matches_jax():
    """A carry_cols=1 template whose output reads the carry: the running
    row max, reset to -inf at column step 0, over 8 column steps."""
    x = rand(16 * 1024).reshape(16, 1024)
    t = KernelTemplate(name="pmax", body=_prefix_max_torch, block_rows=8,
                       block_cols=128, carry_cols=1,
                       carry_init=float("-inf"))
    j = JaxTemplate(name="pmax", body=_prefix_max_jax, block_rows=8,
                    block_cols=128, carry_cols=1, carry_init=float("-inf"))
    got = t(torch.from_numpy(x), interpret=True).numpy()
    want = np.asarray(j(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, want)
    run = np.maximum.accumulate(x.reshape(16, 8, 128).max(-1), axis=1)
    np.testing.assert_array_equal(
        got, (x.reshape(16, 8, 128) - run[..., None]).reshape(16, 1024))


# ---------------------------------------------------------------------------
# template / fusion contract (twins of tests/test_template.py, test_fusion.py)
# ---------------------------------------------------------------------------

def _copy_body(scalars, ins, carry, step):
    return (ins[0],), carry


def _axpy_body(scalars, ins, carry, step):
    return (scalars[0] * ins[0] + ins[1],), carry


class TestTemplateContract:
    def test_stateless_streaming(self):
        t = KernelTemplate(name="t", body=_copy_body, block_rows=8,
                           block_cols=128)
        x = torch.arange(16 * 512, dtype=F32).reshape(16, 512)
        assert torch.equal(t(x, interpret=True), x)

    def test_scalar_operand(self):
        t = KernelTemplate(name="t", body=_axpy_body, n_scalar_in=1,
                           n_vec_in=2, block_rows=8, block_cols=128)
        a = torch.ones((8, 256))
        b = torch.full((8, 256), 2.0)
        assert torch.equal(t(3.0, a, b, interpret=True),
                           torch.full((8, 256), 5.0))

    def test_operand_count_enforced(self):
        t = KernelTemplate(name="t", body=_copy_body)
        with pytest.raises(TypeError):
            t(torch.zeros((8, 128)), torch.zeros((8, 128)), interpret=True)

    def test_shape_divisibility_enforced(self):
        t = KernelTemplate(name="t", body=_copy_body, block_rows=8,
                           block_cols=128)
        with pytest.raises(ValueError):
            t(torch.zeros((8, 100)), interpret=True)
        with pytest.raises(ValueError):
            t(torch.zeros((8,)), interpret=True)

    def test_body_output_count_enforced(self):
        t = KernelTemplate(name="t", body=lambda sc, i, c, s: ((), c))
        with pytest.raises(ValueError, match="declared 1"):
            t(torch.zeros((8, 128)), interpret=True)

    def test_template_launch_stays_warm(self, fresh_caches):
        t = KernelTemplate(name="t", body=_copy_body)
        t(torch.zeros((8, 128)), interpret=True)
        with prog_mod.dispatch_stats_window() as w:
            t(torch.zeros((8, 128)), interpret=True)
            assert w.delta("call_builds") == 0


class TestFusionContract:
    def test_vector_over_budget_raises_at_fuse_time(self):
        with pytest.raises(ValueError, match="vector sources"):
            isa.fuse("c0_add", "c0_add", "c0_add", "c0_add")

    def test_scalar_over_budget_raises_at_fuse_time(self):
        with pytest.raises(ValueError, match="scalar"):
            isa.fuse("c0_scale", "c0_scale", "c0_scale")

    def test_budget_boundary_is_accepted(self):
        fused = isa.fuse("c0_triad", "c0_triad")
        assert fused.spec.itype == "P'"
        assert fused.spec.vector_in == 3 and fused.spec.scalar_in == 2

    def test_non_fusable_instruction_rejected(self):
        reg = Registry()
        reg.register(isa.get("c0_scale"))
        reg.register(Instruction(name="soft", spec=OperandSpec(),
                                 ref=lambda x: x))
        with pytest.raises(ValueError, match="not fusable"):
            reg.fuse("c0_scale", "soft")

    def test_operand_count_checked_at_call(self):
        with pytest.raises(TypeError):
            isa.fuse("c0_scale", "c0_add")(2.0, torch.zeros(128), mode="ref")

    def test_all_modes_reject_same_operand_shapes(self):
        fused = isa.fuse("c0_scale", "c0_add")
        a, b = torch.ones((64, 1)), torch.ones((1, 64))
        for mode in ("ref", "interpret"):
            with pytest.raises(ValueError, match="agree on shape"):
                fused(2.0, a, b, mode=mode)

    def test_fused_bytes_model(self):
        prog = isa.fuse("c0_scale", "c0_add", "c0_copy").program
        assert prog.hbm_bytes_fused(1000, F32) == 3 * 1000 * 4
        assert prog.hbm_bytes_unfused(1000, F32) == 7 * 1000 * 4

    def test_pipeline_depth_is_chained(self):
        assert isa.fuse("c0_scale", "c0_add", "c0_copy").pipeline_depth() == 3

    def test_chain_arity_mismatch_raises(self):
        three_in = KernelTemplate(name="t3", body=_copy_body,
                                  n_vec_in=3).stage()
        two_out = KernelTemplate(name="t2", body=_copy_body,
                                 n_vec_out=2).stage()
        Program((two_out, three_in))           # 2 chained + 1 external
        with pytest.raises(ValueError, match="accepts only"):
            Program((three_in, KernelTemplate(name="t0", body=_copy_body,
                                              n_vec_in=0).stage()))

    @pytest.mark.parametrize("name", ["pairsum", "to_bf16"])
    def test_shape_changing_stage_bit_exact_against_jax(self, smoke, name,
                                                        fresh_caches):
        """A solo stage with ``out_shapes`` through ``call_blocks`` (the
        template launch): the JAX package's Pallas run in interpret mode
        and the port's K1 emulator and oracle give the same bits (each
        output element is one IEEE operation: an add, a rounding)."""
        (x,) = smoke.make_inputs(11, [(16, 4096)], "cpu")
        tpl, plain = smoke.O1_TEMPLATES[name]
        want = bits(JAX_O1[name](jnp.asarray(x.numpy()), interpret=True))
        got = tpl(x, interpret=True)
        assert tuple(got.shape) == want.shape
        assert got.dtype == (torch.float32 if name == "pairsum"
                             else torch.bfloat16)
        np.testing.assert_array_equal(bits(got), want)
        np.testing.assert_array_equal(bits(plain(x)), want)

    def test_shape_changing_stage_refuses_batching(self, smoke):
        prog = smoke.PAIRSUM.program()
        with pytest.raises(ValueError, match="batch-coalesced"):
            prog.call_batch([(torch.zeros(8),), (torch.zeros(8),)])
        with pytest.raises(ValueError, match="batch-coalesced"):
            prog.call_items([[]], [[torch.zeros(8)], [torch.zeros(8)]],
                            block_rows=8, block_cols=128)

    def test_shape_changing_output_blocks_must_be_whole(self):
        def widths(cols):
            return KernelTemplate(
                name="w", body=_copy_body, block_cols=128,
                out_shapes=lambda x: [torch.empty((x.shape[0], cols),
                                                  device="meta")])
        with pytest.raises(ValueError, match="whole"):
            widths(3)(torch.zeros((8, 256)), interpret=True)   # 1.5 a step
        with pytest.raises(ValueError, match="rows"):
            KernelTemplate(
                name="r", body=_copy_body, block_cols=128,
                out_shapes=lambda x: [torch.empty((4, 128), device="meta")]
            )(torch.zeros((8, 128)), interpret=True)
        # 96 of 128 columns is whole, so the emulator takes it; K1 needs a
        # power of two and says so before it looks for a card
        k1_95 = KernelTemplate(
            name="k", body=lambda s, ins, c, st: ((ins[0][..., :96],), c),
            block_cols=128, triton_body="def k(x0, carry, step):\n"
                                        "    return x0, carry\n",
            out_shapes=lambda x: [torch.empty((x.shape[0], 96),
                                              device="meta")])
        x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
        assert torch.equal(k1_95(x, interpret=True), x[:, :96])
        with pytest.raises(ValueError, match="power of two"):
            k1_95(x, interpret=False)

    def test_two_outputs_of_their_own_widths_and_dtypes(self):
        tpl = KernelTemplate(
            name="even_and_bf16", n_vec_out=2, block_cols=256,
            body=lambda s, ins, c, st: ((ins[0][..., 0::2],
                                         ins[0].to(torch.bfloat16)), c),
            out_shapes=lambda x: [
                torch.empty((x.shape[0], x.shape[1] // 2), device="meta"),
                torch.empty(x.shape, dtype=torch.bfloat16, device="meta")])
        x = torch.from_numpy(rand(16 * 1024, 13)).view(16, 1024)
        even, low = tpl(x, interpret=True)
        assert torch.equal(even, x[:, 0::2])
        assert low.dtype == torch.bfloat16
        assert torch.equal(low.view(torch.int16),
                           x.to(torch.bfloat16).view(torch.int16))

    def test_k1_gets_output_widths_only_for_shape_changing_stages(
            self, smoke, monkeypatch, fresh_caches):
        """What the kernel route hands K1's launch: no output specs for a
        shape-preserving program (its kernel takes no ``BO`` widths), the
        outputs' shapes and dtypes for a shape-changing one."""
        seen = []
        monkeypatch.setattr(fk, "check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(fk.K1Kernel, "compile",
                            staticmethod(lambda *a, **k: (None, False)))
        monkeypatch.setattr(fk.K1Kernel, "__call__",
                            lambda self, *a: seen.append(a[-1]) or [])
        x = torch.zeros((8, 2048))
        isa.get("c0_copy").template(x)
        smoke.PAIRSUM(x)
        smoke.TO_BF16(x)
        assert seen == [None, (((8, 1024), "float32"),),
                        (((8, 2048), "bfloat16"),)]

    def test_generated_source_stores_each_output_at_its_width(self, smoke):
        for tpl in (smoke.PAIRSUM, smoke.TO_BF16):
            src = fk.kernel_source((tpl.stage(),), (1,))
            compile(src, "<k1>", "exec")
            assert "BO0: tl.constexpr" in src
            assert "tl.store(O0 + oofs0" in src
        src = fk.kernel_source((isa.get("c0_copy").template.stage(),), (1,))
        assert "BO0" not in src           # shape-preserving: unchanged

    def test_identity_equals_reference(self):
        for names in CHAINS:
            jp, tp = jax_model_program(names)
            assert tp._identity == jp._identity


# ---------------------------------------------------------------------------
# coalesced batches and the warm path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True])
def test_call_batch_items_bit_identical_to_solo(fresh_caches, mixed):
    fused = isa.fuse("c0_scale", "c0_add")
    n = 3 * 4096 + 5                       # ragged: the last tile is padded
    scalars = [0.5 + k if mixed else 2.0 for k in range(5)]
    batch = [(s, torch.from_numpy(rand(n, 2 * k)),
              torch.from_numpy(rand(n, 2 * k + 1)))
             for k, s in enumerate(scalars)]
    with prog_mod.dispatch_stats_window() as w:
        got = fused.program.call_batch(batch, interpret=True)
        assert w.delta("batch_calls") == 1
        assert w.delta("batch_items") == 5
        assert w.delta("batch_mixed") == int(mixed)
    for item, out in zip(batch, got):
        assert out.shape == (n,)
        assert torch.equal(out, fused(*item, mode="interpret"))
        assert torch.equal(out, fused(*item, mode="ref"))


def test_call_batch_matches_jax(fresh_caches):
    n = 2500
    items = [(0.25 * (k + 1), rand(n, 2 * k), rand(n, 2 * k + 1))
             for k in range(4)]
    got = isa.fuse("c0_scale", "c0_add").program.call_batch(
        [to_t(i) for i in items], interpret=True)
    want = jisa.fuse("c0_scale", "c0_add").program.call_batch(
        [to_j(i) for i in items], interpret=True)
    for (s, x, b), g, w in zip(items, got, want):
        bound = 4 * EPS * (abs(s) * np.abs(x) + np.abs(b))
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= bound)


def test_call_batch_rejects_mismatched_items():
    fused = isa.fuse("c0_scale", "c0_add")
    x = torch.zeros(256)
    with pytest.raises(ValueError, match="vector shape"):
        fused.program.call_batch([(1.0, x, x), (1.0, x[:128], x[:128])],
                                 interpret=True)


class TestWarmDispatch:
    def test_warm_call_no_renegotiation_no_rebuild(self, fresh_caches):
        prog = Program(isa.fuse("c0_scale", "c0_add").program.stages)
        x, b = torch.from_numpy(rand(3000)), torch.from_numpy(rand(3000, 1))
        first = prog(2.0, x, b, interpret=True)
        with prog_mod.dispatch_stats_window() as w:
            second = prog(2.0, x, b, interpret=True)
            assert w.delta("geometry_misses") == 0
            assert w.delta("geometry_hits") == 0   # dispatch table hit
            assert w.delta("kernel_traces") == 0
            assert w.delta("call_builds") == 0
        assert torch.equal(second, first)

    def test_new_shape_rebuilds_once(self, fresh_caches):
        prog = Program(isa.fuse("c0_scale", "c0_add").program.stages)
        x, b = torch.from_numpy(rand(3000)), torch.from_numpy(rand(3000, 1))
        prog(2.0, x, b, interpret=True)
        traces = prog_mod.DISPATCH_STATS.kernel_traces
        y = torch.from_numpy(rand(100_000))
        c = torch.from_numpy(rand(100_000, 1))
        prog(2.0, y, c, interpret=True)
        assert prog_mod.DISPATCH_STATS.kernel_traces > traces
        traces = prog_mod.DISPATCH_STATS.kernel_traces
        prog(2.0, y, c, interpret=True)
        assert prog_mod.DISPATCH_STATS.kernel_traces == traces

    def test_interpret_launches_no_kernel(self, fresh_caches):
        before = fk.K1.launches
        isa.fuse("c0_scale", "c0_add")(2.0, torch.ones(300), torch.ones(300),
                                       mode="interpret")
        assert fk.K1.launches == before

    def test_drift_request_renegotiates_next_dispatch(self, fresh_caches):
        prog = Program(isa.fuse("c0_scale", "c0_add").program.stages)
        x = torch.ones(3000)
        prog(2.0, x, x, interpret=True)
        prog_mod.request_renegotiation(prog._identity,
                                       prog_mod._n_bucket(3000), "float32")
        with prog_mod.dispatch_stats_window() as w:
            prog(2.0, x, x, interpret=True)
            assert w.delta("drift_renegotiated") == 1
            assert w.delta("geometry_misses") == 1

    def test_observed_time_hook_reports_each_call(self, fresh_caches):
        seen = []
        hook = lambda *a: seen.append(a)            # noqa: E731
        prog_mod.push_observed_time_hook(hook)
        try:
            prog = isa.fuse("c0_scale", "c0_add").program
            x = torch.ones(500)
            prog(2.0, x, x, interpret=True)
            prog.call_batch([(1.0, x, x), (2.0, x, x)], interpret=True)
        finally:
            prog_mod.pop_observed_time_hook(hook)
        assert [(s[1], s[2], s[4]) for s in seen] == [(500, "float32", 1),
                                                      (500, "float32", 2)]
        assert all(s[3] >= 0 for s in seen)


# ---------------------------------------------------------------------------
# K1 generation (the source text runs only on the card; here it must parse)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_generated_kernel_source_parses(names):
    # the solo walk: each operand's block loaded for the first
    # K1_PREFETCH steps before the loop and, in it, for the step that far
    # ahead of the one computed; with ragged, every load and store masked
    # past n_valid; the batch kernel as it was
    prog = isa.fuse(*names).program
    nv = prog.n_ext_vec_in
    loads = (fk.K1_PREFETCH + 1) * nv
    for ragged in (False, True):
        src = fk.kernel_source(prog.stages, prog._n_ext, ragged=ragged)
        compile(src, "<k1>", "exec")
        assert src.count("tl.load(X") == loads
        assert src.count("tl.store(O") == prog.n_vec_out
        assert src.count("@triton.jit") == len(names) + 1
        assert "def k1_kernel(" in src
        assert "for step in range(0, n_steps)" in src
        assert src.count("< n_valid") == ((loads + prog.n_vec_out) if ragged
                                          else 0)
        assert "evict" not in src
    src = fk.kernel_source(prog.stages, prog._n_ext, batch=True)
    compile(src, "<k1>", "exec")
    assert src.count("tl.load(X") == prog.n_ext_vec_in
    assert "def k1_batch_kernel(" in src


def test_generated_source_carries_state_in_registers():
    t = KernelTemplate(name="pmax", body=_prefix_max_torch, carry_cols=1,
                       carry_init=float("-inf"), triton_body="""
def pmax(x0, carry, step):
    m = tl.maximum(carry, tl.max(x0, axis=1)[:, None])
    return x0 - m, m
""")
    src = fk.kernel_source((t.stage(),), (1,))
    compile(src, "<k1>", "exec")
    assert "_CINIT0 = tl.constexpr(float('-inf'))" in src
    loop = src.index("for step in range(0, n_steps)")
    assert src.index("c0 = tl.full((BR, 1), _CINIT0") < loop
    # the next step's block is loaded before this step's chain runs
    body = src[loop:]
    assert body.index(f"x0_{fk.K1_PREFETCH - 1} = tl.load(") < body.index(
        "_stage0_pmax(")


def test_stage_without_triton_body_has_no_kernel():
    t = KernelTemplate(name="t", body=_copy_body)
    with pytest.raises(ValueError, match="no Triton body"):
        fk.kernel_source((t.stage(),), (1,))
    bad = KernelTemplate(name="t", body=_copy_body,
                         triton_body="def f(x0, step):\n    return x0\n")
    with pytest.raises(ValueError, match="contract"):
        fk.kernel_source((bad.stage(),), (1,))


def test_kernel_mode_on_cpu_raises_before_any_build(fresh_caches):
    x = torch.ones(300)
    with prog_mod.dispatch_stats_window() as w:
        with pytest.raises(RuntimeError, match="CUDA"):
            isa.fuse("c0_scale", "c0_add").program(2.0, x, x)
        assert w.delta("kernel_traces") == 0


# ---------------------------------------------------------------------------
# the slice as a whole: chip_smoke.py's phases at tiny size, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_absmax_body(scalars, ins, outs, carry, step):
    blk = ins[0][...]
    m = jnp.maximum(carry[...], jnp.max(jnp.abs(blk), axis=-1,
                                        keepdims=True))
    outs[0][...] = blk / jnp.maximum(m, 1e-9)
    carry[...] = m


def test_smoke_phase_a_matches_jax(smoke):
    n = 3 * 4096 + 5
    a, b = smoke.make_inputs(0, [n, n], "cpu")
    got = smoke.phase_a(a, b, "interpret")
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    want = {"c0_copy": jisa.call("c0_copy", ja, mode="interpret"),
            "c0_scale": jisa.call("c0_scale", ja, smoke.SCALE,
                                  mode="interpret"),
            "c0_add": jisa.call("c0_add", ja, jb, mode="interpret"),
            "c0_triad": jisa.call("c0_triad", ja, jb, smoke.TRIAD_S,
                                  mode="interpret")}
    for case in ("c0_copy", "c0_scale", "c0_add"):
        np.testing.assert_array_equal(got[case].numpy(),
                                      np.asarray(want[case]))
    bound = smoke.fma_bound((a, smoke.TRIAD_S * b)).numpy()
    assert np.all(np.abs(got["c0_triad"].numpy()
                         - np.asarray(want["c0_triad"])) <= bound)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_a(a, b, "kernel")


def test_smoke_phase_b_matches_jax(smoke):
    n = 3 * 4096 + 5
    x, b = smoke.make_inputs(1, [n, n], "cpu")
    got = smoke.phase_b(x, b, "interpret")
    bound = smoke.fma_bound((smoke.SCALE * x, b)).numpy()
    for case, out in got.items():
        want = jisa.fuse(*case.split("+"))(
            smoke.SCALE, jnp.asarray(x.numpy()), jnp.asarray(b.numpy()),
            mode="interpret")
        assert np.all(np.abs(out.numpy() - np.asarray(want)) <= bound)


def test_smoke_phase_c_matches_jax_and_solo(smoke, fresh_caches):
    n, k = 4096 + 5, 3
    arrays = smoke.make_inputs(2, [n] * (2 * k), "cpu")
    xs, bs = arrays[:k], arrays[k:]
    with prog_mod.dispatch_stats_window() as w:
        got = smoke.phase_c(xs, bs, interpret=True)
        assert w.delta("batch_mixed") == 1
    want = jisa.fuse("c0_scale", "c0_add").program.call_batch(
        [(s, jnp.asarray(x.numpy()), jnp.asarray(b.numpy()))
         for s, x, b in zip(smoke.batch_scalars(k), xs, bs)],
        interpret=True)
    fused = isa.fuse("c0_scale", "c0_add")
    for s, x, b, g, w_ in zip(smoke.batch_scalars(k), xs, bs, got, want):
        assert torch.equal(g, fused(s, x, b, mode="interpret"))
        bound = smoke.fma_bound((s * x, b)).numpy()
        assert np.all(np.abs(g.numpy() - np.asarray(w_)) <= bound)


def _jax_pairsum_body(scalars, ins, outs, carry, step):
    x = ins[0][...]
    outs[0][...] = x[:, 0::2] + x[:, 1::2]


def _jax_to_bf16_body(scalars, ins, outs, carry, step):
    outs[0][...] = ins[0][...].astype(jnp.bfloat16)


# phase O1's stages, defined the same way in the JAX package
JAX_O1 = {
    "pairsum": JaxTemplate(
        name="pairsum", body=_jax_pairsum_body, block_rows=8,
        block_cols=1024, out_shapes=lambda x: [jax.ShapeDtypeStruct(
            (x.shape[0], x.shape[1] // 2), x.dtype)]),
    "to_bf16": JaxTemplate(
        name="to_bf16", body=_jax_to_bf16_body, block_rows=8,
        block_cols=1024, out_shapes=lambda x: [jax.ShapeDtypeStruct(
            x.shape, jnp.bfloat16)]),
}


def bits(a) -> np.ndarray:
    """An array's bits (bfloat16 as uint16), from torch or JAX."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


# ---------------------------------------------------------------------------
# K1's solo route on operands as they lie, the tail masked, against the
# reference's call on operands padded to whole blocks
# ---------------------------------------------------------------------------

SOLO_CHAINS = [("c0_copy",), ("c0_add",), ("c0_triad",),
               ("c0_scale", "c0_add"), ("c0_scale", "c0_add", "c0_copy")]
SOLO_SIZES = [1000, 3 * 4096 + 5, 2 * 8 * 1024]   # ragged, ragged, whole


def _operands(prog, n: int, seed: int):
    """Scalars 2.5, -0.75, … and seeded float32 vectors of n, in program
    order, as numpy."""
    rng = np.random.default_rng(seed)
    ops, k = [], 0
    for st, ne in zip(prog.stages, prog._n_ext):
        for _ in range(st.n_scalar_in):
            ops.append(np.float32((2.5, -0.75)[k % 2]))
            k += 1
        ops += [rng.standard_normal(n).astype(np.float32) for _ in range(ne)]
    return ops


@pytest.mark.parametrize("n", SOLO_SIZES)
@pytest.mark.parametrize("names", SOLO_CHAINS, ids="+".join)
def test_masked_solo_call_is_the_references_padded_call(names, n,
                                                        fresh_caches):
    # the port walks the operands where they lie, masked past n; the
    # reference pads them to whole blocks: at the reference's own
    # geometry the outputs agree — bit for bit for copies and adds, within
    # the multiply-add bound 4·eps·Σ|term| where XLA may contract s·x + b
    jp = jisa.fuse(*names).program
    tp = isa.fuse(*names).program
    br, bc = jp.negotiate_geometry(n, jnp.float32)[:2]
    ops = _operands(tp, n, 40 + n)
    want = np.asarray(jp(*[jnp.asarray(o) for o in ops], interpret=True))
    got = tp.call_flat(*[torch.from_numpy(np.asarray(o)) if np.ndim(o)
                         else float(o) for o in ops],
                       block_rows=br, block_cols=bc, interpret=True)
    assert tuple(got.shape) == (n,) and got.dtype == torch.float32
    if any(st.n_scalar_in for st in tp.stages):
        terms = sum(np.abs(o) for o in ops if np.ndim(o)) * 2.5
        assert np.all(np.abs(got.numpy() - want) <= 4 * EPS * terms)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SOLO_SIZES)
def test_masked_solo_call_carries_as_the_references_padded_call(
        smoke, n, fresh_caches):
    # the carried c7_absmax_scale: a masked load reads the pad's zeros,
    # so each row's running absmax is the reference's, bit for bit
    jt = JaxTemplate(name="c7_absmax_scale", body=_jax_absmax_body,
                     n_vec_in=1, n_vec_out=1, carry_cols=1, carry_init=0.0)
    jp = jprog.Program((jt.stage(),))
    tp = Program((smoke.ABSMAX.stage(),))
    br, bc = jp.negotiate_geometry(n, jnp.float32)[:2]
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = np.asarray(jp(jnp.asarray(x), interpret=True))
    got = tp.call_flat(torch.from_numpy(x), block_rows=br, block_cols=bc,
                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SOLO_SIZES[:2])
def test_ragged_shape_changing_call_is_the_references(smoke, n,
                                                      fresh_caches):
    # a shape-changing stage (to_bf16: another dtype) under
    # Program.__call__: the operand as it lies, the tail masked, against
    # the reference's padded call
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    want = bits(jprog.Program((JAX_O1["to_bf16"].stage(),))(
        jnp.asarray(x), interpret=True))
    got = Program((smoke.TO_BF16.stage(),))(torch.from_numpy(x),
                                            interpret=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(bits(got), want)


def test_ragged_pairsum_call_refuses_as_the_references(smoke, fresh_caches):
    # an output narrower than the operand (pairsum: half the columns) is
    # written whole in the padded layout and cut to its first n elements,
    # as the reference's entry path does: fewer than n, so neither gives
    # back the operand's shape
    x = np.random.default_rng(7).standard_normal(1000).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jprog.Program((JAX_O1["pairsum"].stage(),))(jnp.asarray(x),
                                                    interpret=True)
    with pytest.raises(RuntimeError, match="shape"):
        Program((smoke.PAIRSUM.stage(),))(torch.from_numpy(x),
                                          interpret=True)


@pytest.mark.parametrize("n", SOLO_SIZES[:2])
def test_ragged_stream_instructions_are_the_references(n):
    # the c0 instructions launch at their template's block on the
    # operands as they lie (no pad copy)
    rng = np.random.default_rng(n + 2)
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    from repro_torch.kernels import ops
    for got, want in (
            (ops.stream_copy(ta, mode="interpret"),
             jisa.call("c0_copy", ja, mode="interpret")),
            (ops.stream_add(ta, tb, mode="interpret"),
             jisa.call("c0_add", ja, jb, mode="interpret")),
            (ops.stream_scale(ta, 2.5, mode="interpret"),
             jisa.call("c0_scale", ja, 2.5, mode="interpret"))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smoke_phase_o1_matches_jax(smoke):
    """O1 through ``isa.define``/``bind_kernel``: interpret and ref
    dispatch against the JAX package's interpret run, bit for bit."""
    smoke.define_o1()
    (x,) = smoke.make_inputs(12, [(16, 2048)], "cpu")
    got = smoke.phase_o1(x, "interpret")
    ref = smoke.phase_o1(x, "ref")
    for name, out in got.items():
        want = bits(JAX_O1[name](jnp.asarray(x.numpy()), interpret=True))
        np.testing.assert_array_equal(bits(out), want)
        np.testing.assert_array_equal(bits(ref[name]), want)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_o1(x, "kernel")


def test_smoke_phase_d_matches_jax(smoke):
    (x,) = smoke.make_inputs(3, [(16, 1024)], "cpu")
    smoke.register_absmax()
    got = smoke.phase_d(x, "interpret")
    ref = smoke.phase_d(x, "ref")
    jt = JaxTemplate(name="c7_absmax_scale", body=_jax_absmax_body,
                     n_vec_in=1, n_vec_out=1, carry_cols=1, carry_init=0.0)
    want = np.asarray(jt(jnp.asarray(x.numpy()), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.numpy(), want)
    assert smoke.max_ulp(got, ref) == 0

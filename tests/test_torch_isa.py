"""repro_torch ISA layer and burst model: twins of tests/test_isa.py and
tests/test_burst_model.py, plus the port's dispatch rule (no hidden
fallback: ``auto`` follows the tensors' device, ``kernel`` on CPU
tensors raises)."""
import math

import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the c0 ISA
from repro_torch.core import isa
from repro_torch.core.burst_model import H100_HBM, PAPER_AXI, BurstModel
from repro_torch.core.isa import (ITYPE_LIMITS, Instruction, OperandSpec,
                                  Registry, resolve_auto)
from repro_torch.core.stream import (SMEM_BYTES, StreamConfig, as_rows,
                                     dtype_name, flatten_to_blocks, pad_rows)

MODELS = (PAPER_AXI, H100_HBM)


class TestOperandSpec:
    def test_itype_budget_six_operands(self):
        s = OperandSpec(itype="I'", scalar_in=1, scalar_out=1,
                        vector_in=2, vector_out=2)
        assert s.n_operands == 6

    def test_itype_rejects_over_budget(self):
        with pytest.raises(ValueError):
            OperandSpec(itype="I'", vector_in=3)
        with pytest.raises(ValueError):
            OperandSpec(itype="I'", scalar_in=2)

    def test_stype_trades_vectors_for_scalar(self):
        OperandSpec(itype="S'", scalar_in=2, vector_in=1, vector_out=1)
        with pytest.raises(ValueError):
            OperandSpec(itype="S'", vector_in=2)

    def test_unknown_itype(self):
        with pytest.raises(ValueError):
            OperandSpec(itype="R'")

    def test_limits_equal_reference(self):
        from repro.core.isa import ITYPE_LIMITS as JAX_LIMITS
        assert ITYPE_LIMITS == JAX_LIMITS


class TestRegistry:
    def _mk(self, reg, name="t0"):
        return reg.register(Instruction(
            name=name, spec=OperandSpec(vector_in=1, vector_out=1),
            ref=lambda x: x + 1,
            kernel=lambda x, interpret=False: x + 1))

    def test_register_and_call(self):
        reg = Registry()
        self._mk(reg)
        assert float(reg.dispatch("t0", torch.zeros(()))) == 1.0

    def test_duplicate_rejected(self):
        reg = Registry()
        self._mk(reg)
        with pytest.raises(ValueError):
            self._mk(reg)

    def test_operand_count_checked(self):
        reg = Registry()
        self._mk(reg)
        with pytest.raises(TypeError):
            reg.dispatch("t0", torch.zeros(()), torch.zeros(()))

    def test_mode_context(self):
        reg = Registry()
        calls = []
        reg.register(Instruction(
            name="probe", spec=OperandSpec(vector_in=1, vector_out=1),
            ref=lambda x: calls.append("ref") or x,
            kernel=lambda x, interpret=False: calls.append(
                "interpret" if interpret else "kernel") or x))
        with reg.use("ref"):
            reg.dispatch("probe", torch.zeros(()))
        with reg.use("interpret"):
            reg.dispatch("probe", torch.zeros(()))
        reg.dispatch("probe", torch.zeros(()))        # default: auto → ref
        assert calls == ["ref", "interpret", "ref"]

    def test_ref_only_instruction_cannot_run_kernel(self):
        reg = Registry()
        reg.register(Instruction(
            name="soft", spec=OperandSpec(vector_in=1, vector_out=1),
            ref=lambda x: x))
        with pytest.raises(ValueError):
            reg.dispatch("soft", torch.zeros(()), mode="kernel")
        assert reg.dispatch("soft", torch.zeros(()), mode="auto") == 0

    def test_global_registry_has_c0_instructions(self):
        for name in ("c0_copy", "c0_scale", "c0_add", "c0_triad"):
            assert name in isa.registry, name
            assert isa.get(name).template is not None

    def test_c0_specs_equal_reference(self):
        import repro.kernels  # noqa: F401
        from repro.core import isa as jisa
        for name in ("c0_copy", "c0_scale", "c0_add", "c0_triad"):
            assert isa.get(name).spec == OperandSpec(
                **vars(jisa.get(name).spec))


def _np(seed, n=257):
    import numpy as np
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# (itype, scalar_in, scalar_out, vector_in, vector_out), each within its
# budget, and over-budget ones
SPECS = [("I'", 0, 0, 1, 1), ("I'", 1, 0, 2, 1), ("I'", 1, 1, 2, 2),
         ("S'", 2, 0, 1, 1), ("S'", 1, 1, 1, 1)]
OVER = [("I'", 0, 0, 3, 1), ("I'", 2, 0, 1, 1), ("S'", 0, 0, 2, 1),
        ("S'", 3, 0, 1, 1), ("R'", 0, 0, 1, 1), ("I'", 0, 0, 1, -1)]


def _spec_kw(itype, si, so, vi, vo):
    return dict(itype=itype, scalar_in=si, scalar_out=so, vector_in=vi,
                vector_out=vo)


class TestDefine:
    """``Registry.define`` / ``bind_kernel`` / ``current_mode`` against the
    JAX package's: the same definition through both decorators."""

    @pytest.mark.parametrize("spec", SPECS)
    def test_define_gives_the_reference_spec(self, spec):
        from repro.core.isa import Registry as JRegistry

        def body(*ops):
            """a user's oracle"""
            return ops[0]
        got = Registry().define("u", **_spec_kw(*spec),
                                pipeline_depth=3)(body)
        want = JRegistry().define("u", **_spec_kw(*spec),
                                  pipeline_depth=3)(body)
        assert got.spec == OperandSpec(**vars(want.spec))
        assert (got.name, got.pipeline_depth, got.doc, got.ref) == (
            want.name, want.pipeline_depth, want.doc, want.ref)
        assert got.kernel is None and got.template is None
        assert got.differentiable is False

    @pytest.mark.parametrize("spec", OVER)
    def test_over_budget_definitions_raise_the_reference_errors(self, spec):
        from repro.core.isa import Registry as JRegistry
        with pytest.raises(ValueError) as got:
            Registry().define("u", **_spec_kw(*spec))
        with pytest.raises(ValueError) as want:
            JRegistry().define("u", **_spec_kw(*spec))
        assert str(got.value) == str(want.value)

    def test_ref_dispatch_equals_reference(self):
        import jax.numpy as jnp
        import numpy as np
        from repro.core.isa import Registry as JRegistry
        treg, jreg = Registry(), JRegistry()
        for reg in (treg, jreg):
            reg.define("u_axpy", itype="I'", scalar_in=1, vector_in=2)(
                lambda x, y, s: x * s + y)
            reg.define("u_sub", itype="S'", scalar_in=2, vector_in=1)(
                lambda x, a, b: (x - a) - b)
        x, y = _np(0), _np(1)
        got = treg.dispatch("u_axpy", torch.from_numpy(x),
                            torch.from_numpy(y), 0.75, mode="ref")
        want = jreg.dispatch("u_axpy", jnp.asarray(x), jnp.asarray(y), 0.75,
                             mode="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = treg.dispatch("u_sub", torch.from_numpy(x), 0.5, -2.0)
        want = jreg.dispatch("u_sub", jnp.asarray(x), 0.5, -2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(TypeError):
            treg.dispatch("u_axpy", torch.from_numpy(x))

    def test_bind_kernel_swaps_what_kernel_and_interpret_reach(self):
        reg, calls = Registry(), []
        reg.define("u")(lambda x: x)
        x = torch.zeros(3)
        with pytest.raises(ValueError, match="no GPU kernel bound"):
            reg.dispatch("u", x, mode="interpret")
        reg.bind_kernel("u", lambda x, interpret=False: calls.append(
            ("first", interpret)) or x)
        reg.dispatch("u", x, mode="interpret")
        reg.bind_kernel("u", lambda x, interpret=False: calls.append(
            ("second", interpret)) or x)
        reg.dispatch("u", x, mode="interpret")
        reg.dispatch("u", x, mode="kernel")
        assert calls == [("first", True), ("second", True),
                         ("second", False)]
        with pytest.raises(KeyError):
            reg.bind_kernel("absent", lambda x, interpret=False: x)

    def test_define_with_kernel_and_differentiable(self):
        reg = Registry()
        kern = lambda x, interpret=False: x * 2   # noqa: E731
        instr = reg.define("u", kernel=kern, differentiable=True)(
            lambda x: x * 2)
        assert instr.kernel is kern and instr.differentiable
        x = torch.ones(3, requires_grad=True)
        # a differentiable kernel path takes operands that require grad
        assert reg.dispatch("u", x, mode="interpret").requires_grad
        reg.define("v", kernel=kern, overwrite=True)(lambda x: x * 2)
        with pytest.raises(ValueError, match="no backward"):
            reg.dispatch("v", x, mode="interpret")

    def test_overwrite_false_on_a_taken_name_raises_in_both(self):
        from repro.core.isa import Registry as JRegistry
        for reg in (Registry(), JRegistry()):
            first = reg.define("u")(lambda x: x)
            with pytest.raises(ValueError, match="already registered"):
                reg.define("u")(lambda x: x + 1)
            assert reg.get("u") is first
            second = reg.define("u", overwrite=True)(lambda x: x + 1)
            assert reg.get("u") is second

    def test_module_aliases_and_current_mode(self):
        from repro.core import isa as jisa
        assert isa.define.__self__ is isa.registry
        assert isa.bind_kernel.__self__ is isa.registry
        # the port's default mode is auto (follows the tensors' device),
        # the reference's ref; each follows use()
        assert isa.current_mode() == "auto"
        assert jisa.current_mode() == "ref"
        for mode in ("ref", "interpret", "kernel"):
            with isa.use(mode), jisa.use(mode):
                assert isa.current_mode() == jisa.current_mode() == mode
        assert isa.current_mode() == "auto"


class TestDispatchRule:
    def test_auto_follows_tensor_device(self):
        assert resolve_auto("auto", (torch.zeros(3),)) == "ref"
        assert resolve_auto("auto", (2.0, torch.zeros(3))) == "ref"
        assert resolve_auto("kernel", (torch.zeros(3),)) == "kernel"
        assert isa.registry.mode == "auto"

    def test_kernel_on_cpu_tensors_raises(self):
        x = torch.ones(300)
        with pytest.raises(RuntimeError, match="CUDA"):
            isa.call("c0_scale", x, 2.0, mode="kernel")
        with pytest.raises(RuntimeError, match="CUDA"):
            isa.fuse("c0_scale", "c0_add")(2.0, x, x, mode="kernel")

    def test_auto_on_cpu_is_ref(self):
        x = torch.arange(10, dtype=torch.float32)
        assert torch.equal(isa.call("c0_scale", x, 2.0), 2.0 * x)


class TestStreamConfig:
    def test_sub_blocks(self):
        s = StreamConfig(vlen_bits=256 * 128, block_bits=16384 * 128)
        assert s.sub_blocks() == 64

    def test_block_must_hold_whole_subblocks(self):
        with pytest.raises(ValueError):
            StreamConfig(vlen_bits=3 * 128 * 8, block_bits=4 * 128 * 8)

    def test_smem_budget(self):
        s = StreamConfig()
        with pytest.raises(ValueError, match="shared memory"):
            s.check_smem_budget(6, budget=1024)

    def test_smem_footprint_is_dtype_independent(self):
        s = StreamConfig()
        assert s.smem_footprint_bytes(3) == 3 * s.n_buffers * s.block_bits // 8

    def test_hopper_budget_bounds_a_triad_tile(self):
        # 3 resident float32 tiles, double-buffered, in 232,448 B: 8×1024
        # fits, 8×2048 does not.
        assert SMEM_BYTES == 232_448
        StreamConfig(vlen_bits=4096, block_bits=8 * 1024 * 32
                     ).check_smem_budget(3)
        with pytest.raises(ValueError):
            StreamConfig(vlen_bits=4096, block_bits=8 * 2048 * 32
                         ).check_smem_budget(3)

    def test_defaults_equal_reference(self):
        from repro.core.stream import LANES, SUBLANES
        from repro.core.stream import StreamConfig as JaxConfig
        from repro_torch.core import stream
        assert (stream.LANES, stream.SUBLANES) == (LANES, SUBLANES)
        j, t = JaxConfig(), StreamConfig()
        assert (j.vlen_bits, j.block_bits, j.n_buffers) == (
            t.vlen_bits, t.block_bits, t.n_buffers)

    @pytest.mark.parametrize("dtype,name", [
        (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
        (torch.float16, "float16"), (torch.int32, "int32")])
    def test_dtype_names_match_numpy(self, dtype, name):
        assert dtype_name(dtype) == name

    @pytest.mark.parametrize("n", [1, 1000, 8 * 128, 8 * 128 + 1])
    def test_flatten_to_blocks_matches_reference(self, n):
        import jax.numpy as jnp
        import numpy as np
        from repro.core.stream import flatten_to_blocks as jflat
        x = np.arange(n, dtype=np.float32)
        got, m = flatten_to_blocks(torch.from_numpy(x), 128)
        want, k = jflat(jnp.asarray(x), 128)
        assert m == k == n
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("shape", [(3, 128), (2, 5, 256), (8, 128)])
    def test_as_rows_and_pad_rows_match_reference(self, shape):
        import jax.numpy as jnp
        import numpy as np
        from repro.core.stream import as_rows as jrows
        from repro.core.stream import pad_rows as jpad
        x = np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
        got, lead = as_rows(torch.from_numpy(x), shape[-1])
        want, jlead = jrows(jnp.asarray(x), shape[-1])
        assert lead == tuple(jlead) == shape[:-1]
        (gp, gr), (wp, wr) = pad_rows(got), jpad(want)
        assert gr == wr == got.shape[0]
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))

    def test_burst_model_plateau(self):
        bws = [PAPER_AXI.effective_bw(2 ** b) for b in range(6, 16)]
        assert all(b2 >= b1 for b1, b2 in zip(bws, bws[1:]))
        assert bws[-1] > 0.9 * PAPER_AXI.peak_bw


# -- twin of tests/test_burst_model.py ---------------------------------------

class TestNHalf:
    def test_n_half_is_overhead_times_peak(self):
        for m in MODELS:
            assert m.n_half_bytes == pytest.approx(m.peak_bw * m.overhead_s)

    def test_half_peak_at_n_half(self):
        for m in MODELS:
            assert m.effective_bw(m.n_half_bytes) == pytest.approx(
                0.5 * m.peak_bw)

    def test_paper_n_half_is_128_bytes(self):
        assert PAPER_AXI.n_half_bytes == pytest.approx(128.0)

    def test_paper_model_equals_reference(self):
        from repro.core.burst_model import PAPER_AXI as JAX_AXI
        assert PAPER_AXI.fingerprint() == JAX_AXI.fingerprint()

    def test_h100_peak_is_data_sheet_hbm(self):
        assert H100_HBM.peak_bw == 3.35e12


class TestEffectiveBw:
    def test_monotonically_increasing_in_block_size(self):
        for m in MODELS:
            bws = [m.effective_bw(2.0 ** k) for k in range(0, 28)]
            assert all(b2 > b1 for b1, b2 in zip(bws, bws[1:]))

    def test_bounded_by_peak(self):
        for m in MODELS:
            assert m.effective_bw(1 << 30) < m.peak_bw
            assert m.effective_bw(1 << 30) > 0.9 * m.peak_bw

    def test_zero_block_is_zero_bandwidth(self):
        assert PAPER_AXI.effective_bw(0.0) == 0.0


class TestPlateau:
    def test_paper_plateau_is_about_1kib(self):
        plateau = PAPER_AXI.plateau_block_bytes(0.9)
        assert plateau == pytest.approx(9.0 * PAPER_AXI.n_half_bytes)
        assert abs(plateau - 1024) / 1024 < 0.15

    def test_plateau_block_achieves_fraction(self):
        for m in MODELS:
            for frac in (0.5, 0.9, 0.99):
                blk = m.plateau_block_bytes(frac)
                assert m.effective_bw(blk) == pytest.approx(frac * m.peak_bw)

    def test_plateau_at_half_is_n_half(self):
        for m in MODELS:
            assert m.plateau_block_bytes(0.5) == pytest.approx(m.n_half_bytes)


class TestTimeFor:
    def test_whole_blocks(self):
        m = BurstModel(peak_bw=1e9, overhead_s=1e-6)
        assert m.time_for(4096, 1024) == pytest.approx(4 * (1e-6 + 1024 / 1e9))

    def test_partial_single_block_pays_one_full_burst(self):
        m = BurstModel(peak_bw=1e9, overhead_s=1e-6)
        assert m.time_for(100, 1024) == pytest.approx(1e-6 + 1024 / 1e9)
        assert m.time_for(100, 1024) == m.time_for(1024, 1024)

    def test_fractional_bursts_scale_linearly(self):
        m = BurstModel(peak_bw=1e9, overhead_s=1e-6)
        assert m.time_for(1536, 1024) == pytest.approx(
            1.5 * m.time_for(1024, 1024))

    def test_monotone_in_total_bytes_above_one_block(self):
        ts = [PAPER_AXI.time_for(n, 256) for n in (256, 512, 1024, 4096)]
        assert all(t2 > t1 for t1, t2 in zip(ts, ts[1:]))

    def test_wider_blocks_never_slower_for_aligned_totals(self):
        m = PAPER_AXI
        total = 1 << 20
        ts = [m.time_for(total, 1 << k) for k in range(5, 15)]
        assert all(t2 <= t1 for t1, t2 in zip(ts, ts[1:]))
        assert math.isclose(total / ts[-1],
                            m.effective_bw(1 << 14), rel_tol=1e-9)

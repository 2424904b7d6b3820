"""repro_torch.memhier against repro.memhier.

The same traces and hierarchy values go through both simulators; the
JAX package's presets are converted into the port's ``Hierarchy`` field
by field here (the port carries no TPU preset). Everything is exact —
the engines are the same integer counters and the same float
expressions:

* level, DRAM and per-channel statistics identical, on every trace
  generator, replacement policy, buffer depth and channel mapping
  (twins of tests/test_memhier.py, the model half of
  tests/test_channels.py and the fast-engine cases of
  tests/test_hotpath.py);
* ``simulate_fast == simulate`` in the port, on the same traces and on
  the H100 preset;
* a ``Program`` given a hierarchy negotiates the same
  ``(block_rows, block_cols)`` as the JAX package's under the same
  preset and budget, and still computes its chain;
* the fluid contention model gives the same makespans and finishes.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import memhier as jm
from repro.core import isa as jisa
from repro.core.program import Program as JProgram
from repro.core.stream import VMEM_BYTES
from repro.core.stream import StreamConfig as JStreamConfig
from repro_torch import memhier as tm
from repro_torch.core import isa
from repro_torch.core.burst_model import BurstModel
from repro_torch.core.program import Program
from repro_torch.core.stream import LANES, SMEM_BYTES, StreamConfig
from repro_torch.memhier import (H100, PAPER_ULTRA96, CacheLevel,
                                 ChannelModel, FluidItem, Hierarchy,
                                 LastLevelCache)
from repro_torch.memhier.fastsim import simulate_fast
from repro_torch.memhier.predict import simulate


def port_hier(h) -> Hierarchy:
    """A JAX-package Hierarchy as the port's, field for field."""
    levels = tuple(
        (LastLevelCache if type(lv).__name__ == "LastLevelCache"
         else CacheLevel)(**dataclasses.asdict(lv)) for lv in h.levels)
    ch = (None if h.channels is None
          else ChannelModel(**dataclasses.asdict(h.channels)))
    return Hierarchy(h.name, levels,
                     BurstModel(h.dram.peak_bw, h.dram.overhead_s), ch)


def same(a, b) -> bool:
    """Two Predictions (one per package) hold identical statistics."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def acc(mod, tuples):
    return [mod.Access(*t) for t in tuples]


JDRAM = jm.hierarchy.BurstModel(peak_bw=1e9, overhead_s=64e-9)


def jtiny(**kw):
    return jm.Hierarchy("tiny", (jm.CacheLevel(
        "l1", block_bytes=64, capacity_bytes=kw.pop("capacity", 128),
        bandwidth=1e12, **kw),), JDRAM)


def jsub():
    return jm.Hierarchy("sub", (jm.LastLevelCache(
        "llc", block_bytes=256, capacity_bytes=1024, bandwidth=1e12,
        sub_block_bytes=64),), JDRAM)


# the engine scenarios of tests/test_memhier.py, as (hierarchy, trace)
ENGINE_CASES = {
    "second_read_hits": (jtiny, [(0, 64, "r", "a"), (0, 64, "r", "a")]),
    "lru_eviction_order": (jtiny, [(a, 64, "r", "a")
                                   for a in (0, 64, 128, 0)]),
    "lru_refresh_on_hit": (jtiny, [(a, 64, "r", "a")
                                   for a in (0, 64, 0, 128, 0)]),
    "full_block_write_skip": (jtiny, [(0, 64, "w", "a")]),
    "partial_write_fetches": (jtiny, [(0, 16, "w", "a")]),
    "write_through": (lambda: jtiny(write_allocate=False,
                                    full_block_write_skips_fetch=False),
                      [(0, 16, "w", "a")]),
    "dirty_eviction": (jtiny, [(0, 64, "w", "a"), (64, 64, "r", "b"),
                               (128, 64, "r", "c")]),
    "split_across_lines": (jtiny, [(32, 64, "r", "a")]),
    "sub_blocked_write_skip": (jsub, [(0, 64, "w", "a")]),
    "unaligned_sub_block_write": (jsub, [(16, 32, "w", "a")]),
    "direct_mapped_conflict": (lambda: jtiny(capacity=256, n_ways=1),
                               [(a, 64, "r", "s") for a in (0, 256, 0, 256)]),
    "two_way": (lambda: jtiny(capacity=256, n_ways=2),
                [(a, 64, "r", "s") for a in (0, 256, 0, 256)]),
    "set_lru_per_set": (lambda: jtiny(capacity=256, n_ways=2),
                        [(0, 64, "r", "s"), (128, 64, "r", "s"),
                         (0, 64, "r", "s")]),
    "dirty_conflict": (lambda: jtiny(capacity=256, n_ways=1),
                       [(0, 64, "w", "s"), (256, 64, "r", "s")]),
    "fifo_reuse": (lambda: jtiny(policy="fifo"),
                   [(a, 64, "r", "s") for a in (0, 64, 0, 128, 0)]),
    "plru_reuse": (lambda: jtiny(capacity=256, policy="plru"),
                   [(a, 64, "r", "s")
                    for a in (0, 64, 128, 0, 192, 256, 0, 64)]),
    "slow_level_bottleneck": (
        lambda: jm.Hierarchy("slow", (jm.CacheLevel(
            "l1", block_bytes=64, capacity_bytes=128, bandwidth=1.0),),
            JDRAM), [(0, 64, "r", "a")]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_scenarios_identical(case):
    make, tuples = ENGINE_CASES[case]
    jh = make()
    want = jm.simulate(jh, iter(acc(jm, tuples)))
    got = simulate(port_hier(jh), iter(acc(tm, tuples)))
    assert same(got, want)
    assert same(simulate_fast(port_hier(jh), acc(tm, tuples)), want)


def test_engine_semantics_hold_in_the_port():
    """A few of tests/test_memhier.py's hand-checked numbers, on the
    port alone."""
    h = port_hier(jtiny())
    p = simulate(h, iter(acc(tm, [(0, 64, "r", "a"), (0, 64, "r", "a")])))
    assert (p.level("l1").misses, p.level("l1").hits) == (1, 1)
    p = simulate(h, iter(acc(tm, [(0, 64, "w", "a")])))
    assert p.level("l1").write_skips == 1 and p.dram.read_bytes == 0
    assert p.dram.write_bytes == 64
    p = simulate(port_hier(jsub()), iter(acc(tm, [(16, 32, "w", "a")])))
    assert p.dram.read_bytes == 256


def test_validation_matches_the_reference():
    with pytest.raises(ValueError, match="holds no"):
        CacheLevel("x", block_bytes=128, capacity_bytes=64, bandwidth=1e9)
    with pytest.raises(ValueError, match="sub-block"):
        LastLevelCache("x", block_bytes=100, capacity_bytes=1000,
                       bandwidth=1e9, sub_block_bytes=64)
    with pytest.raises(ValueError, match="n_ways"):
        CacheLevel("x", block_bytes=64, capacity_bytes=256, bandwidth=1e9,
                   n_ways=0)
    with pytest.raises(ValueError, match="policy"):
        CacheLevel("x", block_bytes=64, capacity_bytes=256, bandwidth=1e9,
                   policy="mru")
    with pytest.raises(ValueError, match="whole"):
        Hierarchy("bad", (
            CacheLevel("a", block_bytes=48, capacity_bytes=96,
                       bandwidth=1e9),
            CacheLevel("b", block_bytes=64, capacity_bytes=128,
                       bandwidth=1e9)), BurstModel(1e9, 1e-9))
    with pytest.raises(ValueError, match="kind"):
        simulate(port_hier(jtiny()), [tm.Access(0, 64, "x", "a")])
    with pytest.raises(ValueError, match="n_buffers"):
        simulate_fast(PAPER_ULTRA96, (), n_buffers=0)


# ---------------------------------------------------------------------------
# presets and trace generators
# ---------------------------------------------------------------------------

PRESET_PAIRS = {
    "paper_ultra96": jm.PAPER_ULTRA96,
    "tpu_v5e": jm.TPU_V5E,
    "tpu_v5e_2stack": jm.TPU_V5E_2STACK,
}


@pytest.mark.parametrize("name", sorted(PRESET_PAIRS))
def test_converted_presets_share_fingerprints(name):
    jh = PRESET_PAIRS[name]
    assert port_hier(jh).fingerprint() == jh.fingerprint()
    assert port_hier(jh).n_channels == jh.n_channels


def test_paper_preset_is_the_reference_preset():
    assert PAPER_ULTRA96.fingerprint() == jm.PAPER_ULTRA96.fingerprint()
    assert PAPER_ULTRA96.channels == port_hier(jm.PAPER_ULTRA96).channels


def test_port_carries_no_tpu_preset():
    assert set(tm.PRESETS) == {"paper_ultra96", "h100"}
    for name in ("TPU_V5E", "TPU_V5E_2STACK"):
        assert not hasattr(tm, name)


N = 1 << 18


def _traces(mod, isa_mod, hier, dtype):
    prog = isa_mod.fuse("c0_scale", "c0_add").program
    stage = isa_mod.get("c0_add").template.stage()
    cfg = (JStreamConfig if mod is jm else StreamConfig)()
    return {
        "stream": mod.stream_trace(1 << 21, hier.llc.block_bytes,
                                   ["a", "b"], ["o"]),
        "stream_truncated": mod.stream_trace(
            (1 << 21) + 333, hier.llc.block_bytes, ["a"], ["o"]),
        "config": mod.trace_config(cfg, 1 << 19, dtype, n_in=2, n_out=1),
        "stage": mod.trace_stage(stage, N, dtype),
        "program": mod.trace_program(prog, N, dtype),
        "program_unfused": mod.trace_program_unfused(prog, N, dtype),
    }


TAGS = ("stream", "stream_truncated", "config", "stage", "program",
        "program_unfused")


@pytest.mark.parametrize("tag", TAGS)
def test_trace_generators_identical(tag):
    jt = _traces(jm, jisa, jm.TPU_V5E, jnp.float32)[tag]
    tt = _traces(tm, isa, port_hier(jm.TPU_V5E), torch.float32)[tag]
    assert ([dataclasses.astuple(a) for a in tt]
            == [dataclasses.astuple(a) for a in jt])


@pytest.mark.parametrize("name", ["paper_ultra96", "tpu_v5e",
                                  "tpu_v5e_2stack"])
@pytest.mark.parametrize("tag", TAGS)
def test_simulation_identical_on_every_generator(name, tag):
    jh = PRESET_PAIRS[name]
    th = port_hier(jh)
    want = jm.simulate(jh, _traces(jm, jisa, jh, jnp.float32)[tag])
    got = simulate(th, _traces(tm, isa, th, torch.float32)[tag])
    assert same(got, want)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("hier", [PAPER_ULTRA96, H100],
                         ids=["paper_ultra96", "h100"])
def test_fast_engine_exact_on_every_generator(hier, tag):
    ref = simulate(hier, _traces(tm, isa, hier, torch.float32)[tag])
    fast = simulate_fast(hier, _traces(tm, isa, hier, torch.float32)[tag])
    assert ref == fast


@pytest.mark.parametrize("policy", CacheLevel.POLICIES)
def test_fast_engine_exact_under_every_policy(policy):
    hier = dataclasses.replace(
        PAPER_ULTRA96, levels=tuple(dataclasses.replace(lv, policy=policy)
                                    for lv in PAPER_ULTRA96.levels))
    prog = isa.fuse("c0_scale", "c0_add").program
    trace = list(tm.trace_program(prog, N, torch.float32))
    assert simulate(hier, trace) == simulate_fast(hier, trace)
    jhier = dataclasses.replace(
        jm.PAPER_ULTRA96, levels=tuple(dataclasses.replace(lv, policy=policy)
                                       for lv in jm.PAPER_ULTRA96.levels))
    jtrace = list(jm.trace_program(jisa.fuse("c0_scale", "c0_add").program,
                                   N, jnp.float32))
    assert same(simulate(hier, trace), jm.simulate(jhier, jtrace))


@pytest.mark.parametrize("n_buffers", [1, 1.5, 2])
def test_buffer_depths_identical(n_buffers):
    jt = list(jm.stream_trace(1 << 20, 2048, ["a"], ["o"]))
    tt = list(tm.stream_trace(1 << 20, 2048, ["a"], ["o"]))
    want = jm.simulate(jm.PAPER_ULTRA96, jt, n_buffers=n_buffers)
    assert same(simulate(PAPER_ULTRA96, tt, n_buffers=n_buffers), want)
    assert same(simulate_fast(PAPER_ULTRA96, tt, n_buffers=n_buffers), want)


def test_irregular_trace_identical_and_fast_falls_back():
    rng = np.random.default_rng(7)
    tuples = [(int(a) * 64, 64, "r" if k < 0.7 else "w", f"s{int(a) % 3}")
              for a, k in zip(rng.integers(0, 64, 500), rng.random(500))]
    jh = jtiny(capacity=256)
    want = jm.simulate(jh, acc(jm, tuples))
    assert same(simulate(port_hier(jh), acc(tm, tuples)), want)
    assert same(simulate_fast(port_hier(jh), acc(tm, tuples)), want)


def test_multi_stride_limit_cycle_identical():
    jh = jm.Hierarchy("dm", dram=JDRAM, levels=(jm.CacheLevel(
        "l1", block_bytes=32, capacity_bytes=6 * 32, bandwidth=1e9,
        n_ways=1),))
    tuples = []
    for step in range(400):
        tuples.append((step * 64, 64, "r", "a"))
        tuples.append(((1 << 40) + step * 96, 96, "r", "b"))
    want = jm.simulate(jh, acc(jm, tuples))
    assert same(simulate_fast(port_hier(jh), acc(tm, tuples)), want)


def test_reuse_loop_identical():
    tuples = [(a, 64, "r", "s") for a in range(0, 128, 64)] * 200
    jh = jtiny(capacity=256)
    want = jm.simulate(jh, acc(jm, tuples))
    got = simulate_fast(port_hier(jh), acc(tm, tuples))
    assert same(got, want) and got.levels[0].hit_rate > 0.9


def test_empty_trace_identical():
    assert same(simulate_fast(port_hier(jm.TPU_V5E), ()),
                jm.simulate(jm.TPU_V5E, ()))


@pytest.mark.parametrize("bits", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_stream_bandwidth_sweep_identical(bits):
    blk = bits // 8
    want = jm.stream_bandwidth(jm.PAPER_ULTRA96.with_llc_block(blk), 1 << 20)
    got = tm.stream_bandwidth(PAPER_ULTRA96.with_llc_block(blk), 1 << 20)
    assert same(got, want)
    # the Fig. 3 acceptance gate of tests/test_memhier.py, in the port
    law = PAPER_ULTRA96.dram.effective_bw(blk)
    if bits >= 512:
        assert abs(got.effective_bw - law) / law <= 0.15


def test_large_stream_extrapolation_identical():
    want = jm.stream_bandwidth(jm.PAPER_ULTRA96, 1 << 28)
    got = tm.stream_bandwidth(PAPER_ULTRA96, 1 << 28)
    assert same(got, want) and got.scale > 1.0


@pytest.mark.parametrize("block", [4096, 48, 16])
def test_with_llc_block_identical(block):
    j = jm.PAPER_ULTRA96.with_llc_block(block)
    t = PAPER_ULTRA96.with_llc_block(block)
    assert t.fingerprint() == j.fingerprint()


@pytest.mark.parametrize("name", ["paper_ultra96", "tpu_v5e"])
def test_stream_config_from_hierarchy_identical(name):
    jh = PRESET_PAIRS[name]
    j = JStreamConfig.from_hierarchy(jh)
    t = StreamConfig.from_hierarchy(port_hier(jh))
    assert (t.vlen_bits, t.block_bits, t.n_buffers) == (
        j.vlen_bits, j.block_bits, j.n_buffers)


# ---------------------------------------------------------------------------
# programs under a hierarchy
# ---------------------------------------------------------------------------

FUSION_CHAINS = [
    ("c0_scale", "c0_add"),
    ("c0_add", "c0_scale"),
    ("c0_copy", "c0_triad"),
    ("c0_scale", "c0_copy"),
    ("c0_scale", "c0_add", "c0_copy"),
    ("c0_add", "c0_triad"),
    ("c0_triad", "c0_triad"),
]
IDS = ["+".join(c) for c in FUSION_CHAINS]


def _programs(names, jh, budget):
    jp = JProgram(tuple(jisa.get(n).template.stage() for n in names),
                  model=jh, vmem_budget=budget)
    tp = Program(tuple(isa.get(n).template.stage() for n in names),
                 model=port_hier(jh), smem_budget=budget)
    return jp, tp


@pytest.mark.parametrize("names", FUSION_CHAINS, ids=IDS)
@pytest.mark.parametrize("n", [3000, 1 << 18])
def test_negotiation_under_hierarchy_identical(names, n):
    jp, tp = _programs(names, jm.TPU_V5E, VMEM_BYTES)
    jbr, jbc, jcfg = jp.negotiate_geometry(n, jnp.float32)
    tbr, tbc, tcfg = tp.negotiate_geometry(n, torch.float32)
    assert (tbr, tbc) == (jbr, jbc)
    assert tcfg.block_bits == jcfg.block_bits
    assert tp.negotiated_time(n, torch.float32) == jp.negotiated_time(
        n, jnp.float32)


@pytest.mark.parametrize("names", FUSION_CHAINS[:3], ids=IDS[:3])
def test_negotiation_under_paper_preset_identical(names):
    jp, tp = _programs(names, jm.PAPER_ULTRA96, 1 << 20)
    assert (tp.negotiate_geometry(1 << 16, torch.float32)[:2]
            == jp.negotiate_geometry(1 << 16, jnp.float32)[:2])


@pytest.mark.parametrize("names", FUSION_CHAINS, ids=IDS)
def test_predict_program_and_best_geometry_identical(names):
    jprog, tprog = _programs(names, jm.TPU_V5E, VMEM_BYTES)
    th = tprog.model
    assert same(tm.predict_program(th, tprog, N, torch.float32),
                jm.predict_program(jm.TPU_V5E, jprog, N, jnp.float32))
    jbr, jbc, jpred = jm.best_geometry(jm.TPU_V5E, jprog, N, jnp.float32)
    tbr, tbc, tpred = tm.best_geometry(th, tprog, N, torch.float32)
    assert (tbr, tbc) == (jbr, jbc) and same(tpred, jpred)


def test_fused_traffic_elides_intermediates():
    prog = isa.fuse("c0_scale", "c0_add").program
    th = port_hier(jm.TPU_V5E)
    fused = simulate(th, tm.trace_program(prog, N, torch.float32))
    unfused = simulate(th, tm.trace_program_unfused(prog, N, torch.float32))
    assert fused.dram.bytes < unfused.dram.bytes


def test_program_with_hierarchy_computes_its_chain():
    stages = tuple(isa.get(n).template.stage() for n in ("c0_scale",
                                                         "c0_add"))
    prog = Program(stages, model=H100)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(2000, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(2000, dtype=np.float32))
    got = prog(3.0, x, b, interpret=True)
    want = isa.fuse("c0_scale", "c0_add")(3.0, x, b, mode="ref")
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_budget_filter_applies_under_hierarchy():
    stages = tuple(isa.get(n).template.stage() for n in ("c0_scale",
                                                         "c0_add"))
    prog = Program(stages, model=H100, smem_budget=1024)
    with pytest.raises(ValueError, match="shared-memory budget"):
        prog.negotiate_geometry(1 << 20, torch.float32)


# ---------------------------------------------------------------------------
# the H100 preset
# ---------------------------------------------------------------------------

def test_h100_preset_fields():
    assert H100.dram.peak_bw == 3.35e12
    assert H100.n_channels == 1 and H100.channels.n_channels == 1
    assert H100.dl1.capacity_bytes == SMEM_BYTES
    assert H100.llc.capacity_bytes == 50 * 1024 * 1024
    assert H100.llc.block_bytes % H100.dl1.block_bytes == 0
    cfg = StreamConfig.from_hierarchy(H100)
    assert cfg.vlen_bits == StreamConfig().vlen_bits
    assert cfg.block_bits == H100.llc.block_bytes * 8


@pytest.mark.parametrize("names", FUSION_CHAINS, ids=IDS)
def test_h100_negotiates_within_budget(names):
    prog = Program(tuple(isa.get(n).template.stage() for n in names),
                   model=H100)
    br, bc, cfg = prog.negotiate_geometry(1 << 20, torch.float32)
    assert bc % LANES == 0 and br % 8 == 0
    cfg.check_smem_budget(prog.n_ext_vec_in + prog.n_vec_out
                          + prog.n_intermediates)
    assert prog.negotiated_time(1 << 20, torch.float32) > 0


# ---------------------------------------------------------------------------
# channels (the model half of tests/test_channels.py)
# ---------------------------------------------------------------------------

def _ch_trace(mod):
    return list(mod.stream_trace(1 << 20, 4096, ["a", "b"], ["c"]))


@pytest.mark.parametrize("mapping,n", [("interleave", 1), ("interleave", 2),
                                       ("interleave", 3), ("pinned", 2),
                                       ("pinned", 4)])
@pytest.mark.parametrize("engine", ["simulate", "simulate_fast"])
def test_channel_statistics_identical(mapping, n, engine):
    jh = jm.TPU_V5E.with_channels(n_channels=n, mapping=mapping)
    th = port_hier(jh)
    want = getattr(jm, engine)(jh, iter(_ch_trace(jm)))
    got = (simulate if engine == "simulate" else simulate_fast)(
        th, iter(_ch_trace(tm)))
    assert same(got, want)
    assert got.dram_busy_by_channel == want.dram_busy_by_channel
    assert got.dram_bytes_by_channel == want.dram_bytes_by_channel


def test_one_channel_reduction_in_the_port():
    base = port_hier(jm.TPU_V5E)
    one = base.with_channels(n_channels=1)
    assert one.fingerprint() == base.fingerprint()
    for engine in (simulate, simulate_fast):
        a = engine(base, iter(_ch_trace(tm)))
        b = engine(one, iter(_ch_trace(tm)))
        assert a == b and a.dram_channels == ()
    two = base.with_channels(n_channels=2)
    assert two.fingerprint() != base.fingerprint()


@pytest.mark.parametrize("addr", [0, 4095, 4096, 3 * 4096 + 7,
                                  (1 << 40) + 5, (3 << 40) + 9000])
def test_channel_mapping_identical(addr):
    for kw in ({"n_channels": 4}, {"n_channels": 4, "mapping": "pinned"},
               {"n_channels": 3, "mapping": "pinned",
                "pins": ((3, 0), (1, 2))},
               {"n_channels": 2, "interleave_bytes": 1024}):
        assert (ChannelModel(**kw).channel_of(addr)
                == jm.ChannelModel(**kw).channel_of(addr))


def test_channel_validation():
    with pytest.raises(ValueError):
        ChannelModel(n_channels=0)
    with pytest.raises(ValueError):
        ChannelModel(mapping="striped")
    with pytest.raises(ValueError):
        ChannelModel(n_channels=2, pins=((0, 2),))


FLUID_CASES = [
    [(1.0, (1.0,)), (0.05, (0.1,))],
    [(1.0, (0.8, 0.0)), (0.4, (0.5, 0.0))],
    [(0.3, (0.2, 0.1)), (0.2, (0.0, 0.3)), (0.5, (0.1, 0.1))],
    [(0.1, (0.0,)), (0.2, (0.05,)), (0.15, (0.3,)), (0.01, (0.01,))],
]


@pytest.mark.parametrize("case", range(len(FLUID_CASES)))
def test_fluid_sharing_identical(case):
    ti = [FluidItem(t, d) for t, d in FLUID_CASES[case]]
    ji = [jm.FluidItem(t, d) for t, d in FLUID_CASES[case]]
    assert tm.fluid_makespan(ti) == jm.fluid_makespan(ji)
    assert tm.fluid_finish_times(ti) == jm.fluid_finish_times(ji)


def test_contended_makespan_identical():
    th = port_hier(jm.TPU_V5E)
    tp = [simulate(th, iter(_ch_trace(tm))),
          simulate(th, iter(tm.stream_trace(1 << 18, 4096, ["a"])))]
    jp = [jm.simulate(jm.TPU_V5E, iter(_ch_trace(jm))),
          jm.simulate(jm.TPU_V5E, iter(jm.stream_trace(1 << 18, 4096,
                                                       ["a"])))]
    assert tm.contended_makespan(tp) == jm.contended_makespan(jp)
    items = [FluidItem.pinned(p.time_s, p.dram_busy_s, 0, 1) for p in tp]
    assert tm.fluid_makespan(items) == tm.contended_makespan(tp)
    assert FluidItem.from_prediction(tp[0], 2).demands == \
        jm.FluidItem.from_prediction(jp[0], 2).demands

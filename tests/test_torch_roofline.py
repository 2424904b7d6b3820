"""repro_torch.roofline against the JAX package's roofline module.

Twins of tests/test_system.py's ``test_roofline_terms``,
``test_collective_parser`` and ``test_long500k_skips_full_attention``,
tests/test_fusion.py's ``TestRoofline``, tests/test_graph.py's
``test_plan_report_shape``, tests/test_memhier.py's two roofline tests
and the ``dispatch_cache_report`` test of tests/test_obs.py. Every pure
function gives the reference's numbers on the same inputs within 1e-12
relative; the port carries no TPU constant, so the reference's
``HW_V5E`` dict and its ``TPU_V5E`` memhier preset (converted field by
field) are passed in where the TPU's numbers are compared.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.core import isa as jisa
from repro.graph import partition as jpartition
from repro.kernels import ops as jops
from repro.memhier import TPU_V5E
from repro.roofline import analysis as ja
from repro_torch.configs import SHAPES, cell_applicable, get_config
from repro_torch.core import isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import BurstModel
from repro_torch.graph import partition
from repro_torch.kernels import ops
from repro_torch.memhier import (H100, CacheLevel, ChannelModel, Hierarchy,
                                 LastLevelCache)
from repro_torch.roofline import analysis as ta
from repro_torch.roofline import dispatch_cache_report

REL = 1e-12
F32 = torch.float32


def port_hier(h) -> Hierarchy:
    levels = tuple(
        (LastLevelCache if type(lv).__name__ == "LastLevelCache"
         else CacheLevel)(**dataclasses.asdict(lv)) for lv in h.levels)
    ch = (None if h.channels is None
          else ChannelModel(**dataclasses.asdict(h.channels)))
    return Hierarchy(h.name, levels,
                     BurstModel(h.dram.peak_bw, h.dram.overhead_s), ch)


TH = port_hier(TPU_V5E)


def close(a, b) -> bool:
    """Equal within 1e-12 relative, recursively (strings and bools
    exactly)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, (bool, str)) or a is None:
        return a == b
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# twins of tests/test_system.py
# ---------------------------------------------------------------------------

def test_roofline_terms():
    t = ta.roofline_terms(197e12, 819e9 * 2, 0.0, hw=ja.HW_V5E)
    assert t["dominant"] == "memory_s"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["roofline_fraction"] == pytest.approx(0.5)


def test_roofline_terms_default_to_the_h100():
    hw = ta.HW_H100
    t = ta.roofline_terms(989e12, 3.35e12 * 2, 0.0)
    assert t["dominant"] == "memory_s"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert (hw["flops_bf16"], hw["hbm_bw"], hw["ici_bw"]) == (989e12, 3.35e12,
                                                               450e9)
    assert hw["hbm_gib"] * 2**30 == pytest.approx(80e9)


HLO = """
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[16,16]<=[256]
  %ag = bf16[64,128]{1,0} all-gather(%y), replica_groups=[16,16]<=[256]
  %done = f32[8] all-reduce-done(%z)
  %tup = (f32[256]{0}, f32[256]{0}) all-reduce(%a, %b), replica_groups=[1,4]<=[4]
  %rs = f32[32]{0} reduce-scatter(%c), replica_groups={{0,1,2,3}}
  %a2a = s8[4,64]{1,0} all-to-all(%d), replica_groups=[2,8]<=[16]
  %cp = bf16[16]{0} collective-permute-start(%e), source_target_pairs={{0,1}}
"""


def test_collective_parser():
    got = ta.collective_bytes(HLO)
    assert got["counts"]["all-reduce"] == 2
    assert got["counts"]["all-gather"] == 1
    ar1 = 1024 * 4 * 2 * 15 / 16
    ag = 64 * 128 * 2 * 15 / 16
    ar2 = 2 * 256 * 4 * 2 * 3 / 4
    rs = 32 * 4 * 3
    a2a = 4 * 64 * 7 / 8
    cp = 16 * 2
    assert abs(got["total"] - (ar1 + ag + ar2 + rs + a2a + cp)) < 1e-6


def test_collective_parser_equals_reference():
    assert ta.collective_bytes(HLO) == ja.collective_bytes(HLO)


def test_log_tally_is_the_parser_layout():
    log = [("all-reduce", 4096, 16), ("all-gather", 16384, 16),
           ("all-reduce", 2048, 4), ("all-to-all", 256, 8),
           ("collective-permute", 32, 2)]
    got = ta.collective_bytes_of(log)
    want = ta.collective_bytes(HLO.replace(
        "  %rs = f32[32]{0} reduce-scatter(%c), "
        "replica_groups={{0,1,2,3}}\n", ""))
    assert got == want


def test_long500k_skips_full_attention():
    ok, why = cell_applicable(get_config("llama3_8b"), SHAPES["long_500k"])
    assert not ok and "quadratic" in why
    ok, _ = cell_applicable(get_config("mamba2_1p3b"), SHAPES["long_500k"])
    assert ok
    ok, _ = cell_applicable(get_config("hymba_1p5b"), SHAPES["long_500k"])
    assert ok


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_1p3b", "hymba_1p5b",
                                  "kimi_k2_1t", "musicgen_medium"])
def test_cell_applicable_equals_reference(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_applicable as jcell
    from repro.configs import get_config as jget
    for name in SHAPES:
        assert cell_applicable(get_config(arch), SHAPES[name]) == jcell(
            jget(arch), JSHAPES[name])


# ---------------------------------------------------------------------------
# equality of the pure functions with the reference
# ---------------------------------------------------------------------------

TERM_CASES = [(197e12, 819e9 * 2, 0.0, 0.0), (1e15, 3e11, 5e9, 0.0),
              (1e9, 1e9, 1e12, 2e9), (0.0, 0.0, 0.0, 0.0)]


@pytest.mark.parametrize("flops,hbm,coll,slow", TERM_CASES)
def test_roofline_terms_equal_reference(flops, hbm, coll, slow):
    for hw_t, hw_j in ((ja.HW_V5E, ja.HW_V5E), (ta.HW_H100, ta.HW_H100)):
        assert close(ta.roofline_terms(flops, hbm, coll, hw_t, slow),
                     ja.roofline_terms(flops, hbm, coll, hw_j, slow))


@pytest.mark.parametrize("hbm", [0.0, 1e6, 3.3e8, 1e9])
def test_hierarchy_memory_term_equals_reference(hbm):
    assert close(ta.hierarchy_memory_term(hbm, TH),
                 ja.hierarchy_memory_term(hbm, TPU_V5E))
    assert close(ta.roofline_terms(1e12, hbm, 0.0, ja.HW_V5E, hierarchy=TH),
                 ja.roofline_terms(1e12, hbm, 0.0, hierarchy=TPU_V5E))


@pytest.mark.parametrize("flops,fused,unfused", [(1e6, 8e6, 2.8e7),
                                                 (2e15, 1e9, 3e9),
                                                 (0.0, 0.0, 0.0)])
def test_fusion_report_equals_reference(flops, fused, unfused):
    assert close(ta.fusion_report(flops, fused, unfused, ja.HW_V5E),
                 ja.fusion_report(flops, fused, unfused))


CHAINS = [("c0_scale", "c0_add"), ("c0_scale", "c0_add", "c0_copy"),
          ("c0_triad", "c0_triad")]


@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_program_fusion_report_equals_reference(names):
    n = 1 << 20
    got = ta.program_fusion_report(isa.fuse(*names).program, n, F32,
                                   ja.HW_V5E)
    want = ja.program_fusion_report(jisa.fuse(*names).program, n,
                                    jnp.float32)
    assert close(got, want)


@pytest.mark.parametrize("kind", ops.C0_PIPELINES)
def test_plan_report_equals_reference(kind):
    n = 1 << 18
    tp = partition(ops.c0_pipeline_graph(kind), model=TH)
    jp = jpartition(jops.c0_pipeline_graph(kind), model=TPU_V5E)
    assert close(ta.plan_report(tp, n, F32, ja.HW_V5E),
                 ja.plan_report(jp, n, jnp.float32))


# ---------------------------------------------------------------------------
# twins of TestRoofline (test_fusion.py), test_plan_report_shape
# (test_graph.py), the memhier roofline tests and dispatch_cache_report
# ---------------------------------------------------------------------------

class TestRoofline:
    def test_fused_bytes_model(self):
        fused = isa.fuse("c0_scale", "c0_add", "c0_copy")
        n = 1000
        assert fused.program.hbm_bytes_fused(n, F32) == 3 * n * 4
        assert fused.program.hbm_bytes_unfused(n, F32) == 7 * n * 4

    def test_fusion_report_speedup_bound(self):
        fused = isa.fuse("c0_scale", "c0_add")
        rep = ta.program_fusion_report(fused.program, 1 << 20, F32)
        assert rep["bytes_reduction"] >= 1.5
        assert rep["speedup_bound"] > 1.0       # memory-bound chain
        assert rep["intensity_fused"] > rep["intensity_unfused"]


def test_plan_report_shape():
    plan = partition(ops.c0_pipeline_graph("axpby_residual"), model=H100)
    rep = ta.plan_report(plan, 1 << 18, F32)
    assert rep["n_parts"] == plan.n_parts
    assert rep["bytes_reduction"] >= 1.5
    assert rep["predicted_speedup"] >= 1.0
    assert rep["n_buffer_slots"] <= rep["n_buffer_values"]


class TestRooflineHierarchyTerm:
    def test_hierarchy_term_charges_burst_overhead(self):
        flops, hbm = 1e12, 1e9
        for hier, hw in ((TH, ja.HW_V5E), (H100, ta.HW_H100)):
            flat = ta.roofline_terms(flops, hbm, 0.0, hw)
            with_h = ta.roofline_terms(flops, hbm, 0.0, hw, hierarchy=hier)
            assert with_h["memory_s"] > flat["memory_s"]   # overhead charged
            assert flat["memory_s"] == pytest.approx(hbm / hw["hbm_bw"])
        assert ta.roofline_terms(flops, hbm, 0.0, ja.HW_V5E, hierarchy=TH)[
            "memory_s"] < 10 * hbm / ja.HW_V5E["hbm_bw"]   # same order

    def test_zero_bytes_zero_term(self):
        assert ta.hierarchy_memory_term(0.0, TH) == 0.0
        assert ta.hierarchy_memory_term(0.0, H100) == 0.0


class TestRooflineReport:
    def test_dispatch_cache_report_counters_and_rates(self):
        prog_mod.reset_dispatch_stats()
        prog_mod.DISPATCH_STATS.geometry_hits += 3
        prog_mod.DISPATCH_STATS.geometry_misses += 1
        prog_mod.DISPATCH_STATS.disk_hit += 1
        prog_mod.DISPATCH_STATS.disk_miss += 1
        rep = dispatch_cache_report()
        prog_mod.reset_dispatch_stats()
        assert rep["geometry_hits"] == 3
        assert rep["geometry_misses"] == 1
        assert rep["geometry_hit_rate"] == pytest.approx(0.75)
        assert rep["disk_hit_rate"] == pytest.approx(0.5)
        json.dumps(rep)                              # JSON-able

    def test_report_keys_equal_reference(self):
        from repro.roofline import dispatch_cache_report as jreport
        assert set(dispatch_cache_report()) == set(jreport())

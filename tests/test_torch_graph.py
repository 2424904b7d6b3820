"""repro_torch.graph against repro.graph (twin of tests/test_graph.py).

The same graphs, budgets and hierarchy values go through both packages'
partitioners (the JAX package's TPU_V5E preset converted into the port's
``Hierarchy`` field by field here; both Programs get the same budget):

* greedy, beam and all-singleton partitions equal for every
  ``c0_pipeline_graph`` kind, with the same cost, predicted time, units,
  schedule and buffer slots;
* plan outputs: the port's plan in ``interpret`` mode (K1's emulator
  per part) against its own ``ref`` oracle and against the JAX
  package's plan on the same numpy inputs — exact for copy/scale/add,
  within ``4·eps_f32·Σ|term|`` for a multiply-add (the JAX package's
  Pallas interpret mode may contract it into one FMA; torch rounds
  twice);
* persisted plans: the entries both packages write into a plan cache
  are byte-equal (names and contents), and each package serves the
  other's plan from disk without a search;
* the IR, tracing and partitioner edge cases of tests/test_graph.py.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import graph as jgraph
from repro.core import artifact as jart
from repro.core import program as jprog
from repro.core.stream import VMEM_BYTES
from repro.kernels import ops as jops
from repro.memhier import TPU_V5E
from repro_torch.core import artifact, isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import BurstModel
from repro_torch.graph import (Graph, chain_graph, fuse_chain, partition,
                               plan_from_chains)
from repro_torch.kernels import ops
from repro_torch.memhier import (H100, CacheLevel, ChannelModel, Hierarchy,
                                 LastLevelCache)

F32 = torch.float32
EPS = float(np.finfo(np.float32).eps)


def port_hier(h) -> Hierarchy:
    levels = tuple(
        (LastLevelCache if type(lv).__name__ == "LastLevelCache"
         else CacheLevel)(**dataclasses.asdict(lv)) for lv in h.levels)
    ch = (None if h.channels is None
          else ChannelModel(**dataclasses.asdict(h.channels)))
    return Hierarchy(h.name, levels,
                     BurstModel(h.dram.peak_bw, h.dram.overhead_s), ch)


TH = port_hier(TPU_V5E)


def rand(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def t(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def tup(out):
    return out if isinstance(out, tuple) else (out,)


def assert_plan_matches_oracle(plan, *operands):
    want = tup(plan.ref(*operands))
    got = tup(plan(*operands, mode="interpret"))
    assert len(want) == len(got)
    for w, o in zip(want, got):
        assert torch.allclose(o, w, rtol=1e-6, atol=1e-6)


def both_partitions(kind, method, **kw):
    jp = jgraph.partition(jops.c0_pipeline_graph(kind), model=TPU_V5E,
                          method=method, vmem_budget=VMEM_BYTES, **kw)
    tp = partition(ops.c0_pipeline_graph(kind), model=TH, method=method,
                   smem_budget=VMEM_BYTES, **kw)
    return jp, tp


KINDS = ops.C0_PIPELINES
METHODS = ("singletons", "greedy", "beam")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_partitions_equal(kind, method):
    jp, tp = both_partitions(kind, method)
    assert tp.chains() == jp.chains()
    assert tp.cost == jp.cost
    assert tp.schedule() == jp.schedule()
    assert (tp.n_slots, tp.n_values) == (jp.n_slots, jp.n_values)
    assert tp.predicted_time() == jp.predicted_time()
    assert tp.predicted_time(overlap=False) == jp.predicted_time(
        overlap=False)
    assert tp.modeled_hbm_bytes() == jp.modeled_hbm_bytes()
    for tu, ju in zip(tp.units(), jp.units()):
        assert dataclasses.astuple(tu) == dataclasses.astuple(ju)


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [4096, 1 << 22])
def test_partitions_equal_at_sizes(kind, method, n):
    jp, tp = both_partitions(kind, method, n_elems=n)
    assert tp.chains() == jp.chains() and tp.cost == jp.cost


@pytest.mark.parametrize("kind", KINDS)
def test_partitions_equal_without_hierarchy(kind):
    jp = jgraph.partition(jops.c0_pipeline_graph(kind),
                          vmem_budget=VMEM_BYTES)
    tp = partition(ops.c0_pipeline_graph(kind), smem_budget=VMEM_BYTES)
    assert tp.chains() == jp.chains() and tp.cost == jp.cost


GRAPH_ARGS = {
    "axpby_residual": lambda n: (rand(n), rand(n, 1), 2.0, 0.5),
    "saxpby": lambda n: (rand(n), rand(n, 1), 1.5, -0.5),
    "diamond": lambda n: (rand(n), 3.0),
}
# |term| sums of each output, for the multiply-add bound
FMA_TERMS = {
    "axpby_residual": lambda x, b, s, tt: (abs(s * x) + abs(b),
                                           abs(x) + abs(tt * b)),
    "saxpby": lambda x, y, a, b: (abs(a * x) + abs(b * y),),
    "diamond": None,
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_plan_outputs_match_ref_and_the_reference(kind, method):
    jp, tp = both_partitions(kind, method)
    args = GRAPH_ARGS[kind](4096 + 77)
    got = tup(tp(*map(t, args), mode="interpret"))
    ref = tup(tp.ref(*map(t, args)))
    want = tup(jp(*map(j, args), mode="interpret"))
    terms = FMA_TERMS[kind]
    bounds = (terms(*args) if terms is not None
              else (np.zeros_like(args[0]),))
    for g_, r, w, bd in zip(got, ref, want, bounds):
        g_ = g_.numpy()
        # the port's emulator and oracle both round twice, like torch
        assert np.array_equal(g_, r.numpy())
        assert np.all(np.abs(g_ - np.asarray(w)) <= 4 * EPS * bd)


@pytest.mark.parametrize("kind", KINDS)
def test_auto_mode_on_cpu_is_ref(kind):
    plan = partition(ops.c0_pipeline_graph(kind), model=TH)
    args = tuple(map(t, GRAPH_ARGS[kind](300)))
    for g_, w in zip(tup(plan(*args, mode="auto")), tup(plan.ref(*args))):
        assert torch.equal(g_, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan(*args, mode="kernel")


# ---------------------------------------------------------------------------
# persisted plans
# ---------------------------------------------------------------------------

def _entries(path):
    return {p: open(os.path.join(path, p), "rb").read()
            for p in sorted(os.listdir(path))}


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_artifacts_byte_equal(kind, method, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jprog.clear_dispatch_caches()
    prog_mod.clear_dispatch_caches()
    with jart.using_plan_cache(jdir):
        jp = jgraph.partition(jops.c0_pipeline_graph(kind), model=TPU_V5E,
                              method=method, vmem_budget=VMEM_BYTES)
    with artifact.using_plan_cache(tdir):
        tp = partition(ops.c0_pipeline_graph(kind), model=TH, method=method,
                       smem_budget=VMEM_BYTES)
    assert tp.chains() == jp.chains()
    je, te = _entries(jdir), _entries(tdir)
    assert any(name.startswith("plan-") for name in te)
    assert te == je


@pytest.mark.parametrize("kind", KINDS)
def test_port_serves_the_reference_plan_from_disk(kind, tmp_path):
    jprog.clear_dispatch_caches()
    prog_mod.clear_dispatch_caches()
    with jart.using_plan_cache(tmp_path):
        jp = jgraph.partition(jops.c0_pipeline_graph(kind), model=TPU_V5E,
                              vmem_budget=VMEM_BYTES)
    prog_mod.clear_dispatch_caches()
    with artifact.using_plan_cache(tmp_path):
        with prog_mod.dispatch_stats_window() as w:
            tp = partition(ops.c0_pipeline_graph(kind), model=TH,
                           smem_budget=VMEM_BYTES)
            assert w.delta("disk_hit") >= 1
            assert w.delta("disk_invalidated") == 0
    assert tp.chains() == jp.chains() and tp.cost == jp.cost
    # and back: the reference reads what the port wrote
    with artifact.using_plan_cache(tmp_path / "port"):
        partition(ops.c0_pipeline_graph(kind), model=TH,
                  smem_budget=VMEM_BYTES)
    jprog.clear_dispatch_caches()
    with jart.using_plan_cache(tmp_path / "port"):
        with jprog.dispatch_stats_window() as w:
            back = jgraph.partition(jops.c0_pipeline_graph(kind),
                                    model=TPU_V5E, vmem_budget=VMEM_BYTES)
            assert w.delta("disk_hit") >= 1
    assert back.chains() == tp.chains()


def test_corrupt_plan_entry_is_researched(tmp_path):
    prog_mod.clear_dispatch_caches()
    with artifact.using_plan_cache(tmp_path):
        first = partition(ops.c0_pipeline_graph("saxpby"), model=TH)
        (entry,) = [p for p in tmp_path.iterdir()
                    if p.name.startswith("plan-")]
        entry.write_text('{"chains": [[0, 1, 2]]')        # truncated
        with prog_mod.dispatch_stats_window() as w:
            again = partition(ops.c0_pipeline_graph("saxpby"), model=TH)
            assert w.delta("disk_corrupt") == 1
    assert again.chains() == first.chains()


# ---------------------------------------------------------------------------
# IR and tracing
# ---------------------------------------------------------------------------

def test_ir_validates_against_the_registry():
    g = Graph("t")
    x = g.input("x")
    with pytest.raises(KeyError, match="unknown instruction"):
        g.apply("c9_nope", x)
    with pytest.raises(ValueError, match="vector"):
        g.apply("c0_add", x)
    with pytest.raises(TypeError, match="keyword"):
        g.apply("c2_sort", x, width=8)
    g2 = Graph("b")
    with pytest.raises(ValueError, match="different graph"):
        g2.apply("c0_copy", x)
    g.apply("c0_copy", x)
    with pytest.raises(ValueError, match="no outputs"):
        g.validate()


def test_literal_scalars_and_consumers():
    g = Graph("t")
    x = g.input("x")
    g.output(g.apply("c0_scale", x, 2.5))
    assert len(g.scalars) == 1 and g.scalars[0].bound == 2.5
    assert len(g.free_inputs()) == 1
    d = ops.c0_pipeline_graph("diamond")
    assert len(d.consumers()[d.nodes[1].vec_in[0]]) == 2


@pytest.mark.parametrize("kind", KINDS)
def test_structure_keys_equal(kind):
    assert (ops.c0_pipeline_graph(kind).structure_key()
            == jops.c0_pipeline_graph(kind).structure_key())
    g = ops.c0_pipeline_graph(kind)
    assert (g.hbm_bytes_unfused(1 << 16, F32)
            == jops.c0_pipeline_graph(kind).hbm_bytes_unfused(
                1 << 16, jnp.float32))
    assert g.flops(1000) == jops.c0_pipeline_graph(kind).flops(1000)


def test_chain_graph_matches_fuse_operand_spec():
    g = chain_graph(["c0_scale", "c0_add"])
    fused = isa.fuse("c0_scale", "c0_add")
    assert len(g.nodes) == 2
    assert len(g.inputs) == fused.spec.vector_in
    assert len(g.scalars) == fused.spec.scalar_in
    assert (g.structure_key()
            == jgraph.chain_graph(["c0_scale", "c0_add"]).structure_key())


def test_trace_records_ops_wrappers():
    with Graph.trace("tr") as g:
        x, b = g.input("x"), g.input("b")
        g.output(ops.stream_add(ops.stream_scale(x, 2.0), b))
    assert [n.name for n in g.nodes] == ["c0_scale", "c0_add"]
    from repro.core import isa as jisa
    assert not jisa._DISPATCH_HOOKS
    from repro_torch.core import isa as tisa
    assert not tisa._DISPATCH_HOOKS
    plan = partition(g)
    assert_plan_matches_oracle(plan, t(rand(512)), t(rand(512, 1)))
    x = t(rand(64))
    with Graph.trace("tr2"):
        y = ops.stream_scale(x, 2.0, mode="ref")     # concrete: executes
    assert torch.equal(y, x * 2.0)


# ---------------------------------------------------------------------------
# partitioner edge cases and search quality
# ---------------------------------------------------------------------------

def test_single_node_graph():
    g = Graph("one")
    g.output(g.apply("c0_copy", g.input("x")))
    plan = partition(g, model=TH)
    assert plan.n_parts == 1 and plan.parts[0].node_ids == (0,)
    assert_plan_matches_oracle(plan, t(rand(300)))


def test_every_budget_exceeded_yields_all_singletons():
    g = ops.c0_pipeline_graph("axpby_residual")
    plan = partition(g, smem_budget=1024)
    assert plan.n_parts == len(g.nodes)
    assert all(p.program is None for p in plan.parts)
    assert_plan_matches_oracle(plan, t(rand(128)), t(rand(128, 1)), 2.0,
                               0.5)


def test_hierarchy_preset_accepted_by_name():
    g = ops.c0_pipeline_graph("axpby_residual")
    by_name = partition(g, model="h100", n_elems=1 << 20)
    by_obj = partition(g, model=H100, n_elems=1 << 20)
    assert by_name.chains() == by_obj.chains() == [(0, 1, 2), (3,)]
    assert by_name.predicted_time() == by_obj.predicted_time()
    with pytest.raises(ValueError, match="unknown hierarchy preset"):
        partition(g, model="tpu_v5e")


def test_max_depth_and_scalar_budget_split():
    g = ops.c0_pipeline_graph("axpby_residual")
    assert partition(g, max_depth=1).n_parts == len(g.nodes)
    g3 = chain_graph(["c0_scale", "c0_scale", "c0_scale"])
    plan = partition(g3)
    assert plan.n_parts >= 2 and plan.n_slots < plan.n_values
    assert all(len(p.node_ids) <= 2 for p in plan.parts)
    assert_plan_matches_oracle(plan, t(rand(256)), 2.0, -1.0, 0.5)


def test_fanout_blocks_fusion():
    d = partition(ops.c0_pipeline_graph("diamond"), model=TH)
    assert (0,) in d.chains()
    assert_plan_matches_oracle(d, t(rand(777)), 3.0)
    g = Graph("t")
    x, s = g.input("x"), g.scalar("s")
    u = g.apply("c0_scale", x, s)
    g.output(u)
    g.output(g.apply("c0_copy", u))
    plan = partition(g)
    assert plan.n_parts == 2
    assert_plan_matches_oracle(plan, t(rand(128)), 2.0)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_never_worse_than_unfused(method):
    for kind in KINDS:
        g = ops.c0_pipeline_graph(kind)
        plan = partition(g, model=H100, method=method)
        unf = partition(g, model=H100, method="singletons")
        assert plan.predicted_time() <= unf.predicted_time() * (1 + 1e-9)
        assert plan.modeled_hbm_bytes() <= unf.modeled_hbm_bytes()


def test_beam_at_least_as_good_as_every_hand_split():
    g = ops.c0_pipeline_graph("axpby_residual")
    plan = partition(g, model=TH)
    for split in ([[0], [1], [2], [3]], [[0, 1], [2], [3]],
                  [[0], [1, 2], [3]], [[0, 1, 2], [3]]):
        hand = plan_from_chains(g, split, model=TH)
        jhand = jgraph.plan_from_chains(jops.c0_pipeline_graph(
            "axpby_residual"), split, model=TPU_V5E)
        assert hand.predicted_time() == jhand.predicted_time()
        assert plan.predicted_time() <= hand.predicted_time() * (1 + 1e-9)


def test_plan_from_chains_checks():
    g = ops.c0_pipeline_graph("axpby_residual")
    with pytest.raises(ValueError, match="cover"):
        plan_from_chains(g, [[0, 1, 2]])
    with pytest.raises(ValueError, match="not a legal"):
        plan_from_chains(ops.c0_pipeline_graph("diamond"), [[0, 1], [2]])
    with pytest.raises(ValueError, match="unknown method"):
        partition(g, method="dp")
    plan = plan_from_chains(g, [[0, 1], [2], [3]])
    assert plan.n_parts == 3
    assert_plan_matches_oracle(plan, t(rand(256)), t(rand(256, 1)), 2.0,
                               0.5)


def test_plan_execution_details():
    plan = partition(ops.c0_pipeline_graph("axpby_residual"))
    with pytest.raises(TypeError, match="expects 4 operands"):
        plan(t(rand(64)), t(rand(64, 1)), 2.0)
    x, b = t(rand(128)), t(rand(128, 1))
    with isa.use("interpret"):
        out, res = plan(x, b, 2.0, 0.5)
    assert torch.allclose(out, 2.0 * x + b, rtol=1e-6, atol=1e-6)
    assert torch.allclose(res, x + 0.5 * b, rtol=1e-6, atol=1e-6)
    g = Graph("reuse")
    xx = g.input("x")
    g.output(g.apply("c0_add", xx, xx))
    assert torch.equal(partition(g)(x, mode="interpret"), x + x)


def test_non_template_singleton_dispatches():
    g = Graph("mixed")
    x = g.input("x")
    y = g.apply("c0_scale", x, 2.0)
    g.output(g.apply("c3_prefixsum", y))
    plan = partition(g)
    assert any(p.program is None for p in plan.parts)
    xv = t(rand(256))
    # K3's plain walk and the cumsum oracle sum in different orders
    assert torch.allclose(plan(xv, mode="interpret"), plan.ref(xv),
                          rtol=1e-4, atol=1e-5)


def test_fuse_chain_is_the_trivial_case():
    prog, spec = fuse_chain([isa.get("c0_scale"), isa.get("c0_add")])
    fused = isa.fuse("c0_scale", "c0_add")
    assert spec == fused.spec and prog.n_inputs == fused.program.n_inputs
    with pytest.raises(ValueError, match="not fusable"):
        fuse_chain([isa.get("c2_sort")])
    with pytest.raises(ValueError, match="vector sources"):
        fuse_chain([isa.get("c0_add")] * 4)
    plan = partition(chain_graph(["c0_scale", "c0_add"]))
    assert plan.n_parts == 1
    assert (plan.modeled_hbm_bytes(1 << 16, F32)
            == fused.program.hbm_bytes_fused(1 << 16, F32))

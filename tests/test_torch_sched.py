"""repro_torch.sched against repro.sched (twin of tests/test_sched.py).

The same requests, made from the same seeded numpy arrays, go through
both packages' queue, cost model and scheduler. The JAX package's
TPU_V5E preset is converted into the port's ``Hierarchy`` field by field
here, and both packages' Programs get the JAX package's budget (the
port's default is one thread block's shared memory). Exact wherever the
reference is exact:

* coalesce keys, admission errors and batches equal;
* cost estimates (memhier seed, burst seed, plan seed), EWMA
  corrections and contention terms equal to the last bit; ``kind="ewma"``
  artifacts byte-equal and shared;
* virtual-clock runs (every policy, one and two lanes, multi-channel,
  two tenants with plans and coalesced batches) record byte-identical
  trace JSONL and identical placements; their span trees under a
  virtual-clock tracer export byte-identical JSONL;
* a trace the reference recorded replays in the port with the same
  placements;
* wall-clock runs in ``interpret`` mode return every item's result bit
  for bit as its solo call, and within the multiply-add bound
  ``4·eps_f32·Σ|term|`` of the JAX package's (one rounding there, two in
  torch eager);
* chip_smoke.py's phase I at tiny size.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import sched as js
from repro.core import artifact as jart
from repro.core import isa as jisa
from repro.core import program as jprog
from repro.core.stream import VMEM_BYTES
from repro.graph import partition as jpartition
from repro.kernels import ops as jops
from repro.memhier import TPU_V5E
from repro.obs import trace as jtrace
from repro_torch import sched as ts
from repro_torch.core import artifact, isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import BurstModel
from repro_torch.graph import partition
from repro_torch.graph.ir import Value
from repro_torch.kernels import ops
from repro_torch.memhier import (H100, CacheLevel, ChannelModel, Hierarchy,
                                 LastLevelCache)
from repro_torch.obs import trace as ttrace

N = 4096
EPS = float(np.finfo(np.float32).eps)
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


@pytest.fixture
def fresh_caches():
    prog_mod.clear_dispatch_caches()
    prog_mod.reset_dispatch_stats()
    jprog.clear_dispatch_caches()
    yield


def arrays(*seeds, n=N):
    return [np.random.default_rng(s).standard_normal(n).astype(np.float32)
            for s in seeds]


class Pkg:
    """One package's side of a parity case."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.mod, self.isa, self.arr = js, jisa, jnp.asarray
            self.hier, self.f32 = TPU_V5E, jnp.float32
            self.partition, self.ops = jpartition, jops
        else:
            self.mod, self.isa, self.arr = ts, isa, torch.from_numpy
            self.hier, self.f32 = TH, F32
            self.partition, self.ops = partition, ops

    def cost(self, **kw):
        return self.mod.CostModel(hierarchy=self.hier, **kw)

    def fuse(self, *names):
        """The chain fused with the JAX package's budget in both
        packages (the port's default is one thread block's shared
        memory), so both negotiate from the same candidates."""
        if self.name == "jax":
            return jisa.fuse(*names)
        instrs = tuple(isa.get(n) for n in names)
        prog, spec = isa.fuse_chain(instrs, smem_budget=VMEM_BYTES)
        return isa.FusedProgram(name=prog.name, spec=spec, instrs=instrs,
                                program=prog, registry=isa.registry)

    def plan(self, kind, n=1 << 16, hier=None):
        budget = ({"vmem_budget": VMEM_BYTES} if self.name == "jax"
                  else {"smem_budget": VMEM_BYTES})
        return self.partition(self.ops.c0_pipeline_graph(kind),
                              model=hier or self.hier, n_elems=n, **budget)


PKGS = (Pkg("jax"), Pkg("torch"))


def both(fn):
    """fn(pkg) for both packages: (jax result, torch result)."""
    return tuple(fn(p) for p in PKGS)


# ---------------------------------------------------------------------------
# queue and coalescing
# ---------------------------------------------------------------------------

def _key_cases(p):
    x, b, y = map(p.arr, arrays(0, 1, 2))
    x2 = p.arr(arrays(3, n=2 * N)[0])
    f = p.fuse("c0_scale", "c0_add")
    return [p.mod.coalesce_key(f, ops_) for ops_ in (
        (2.0, x, b), (3.0, y, x), (np.float32(2.0), x, b),
        (np.int32(4), x, b), (2.0, x2, x2), (2.0, x, x2))] + [
        p.mod.coalesce_key(p.fuse("c0_copy"), (x,)),
        p.mod.coalesce_key(p.plan("saxpby"), (x, b, 1.0, 2.0)),
        p.mod.coalesce_key(lambda v: v, (x,))]


def test_coalesce_keys_equal():
    jk, tk = both(_key_cases)
    assert [repr(k) for k in tk] == [repr(k) for k in jk]
    assert tk[0] == tk[1] and tk[0] != tk[2] and tk[5] is None
    assert tk[-1] is None and tk[-2] is None


def test_admission_errors():
    q = ts.RequestQueue()
    f = isa.fuse("c0_scale", "c0_add")
    x, x2 = torch.zeros(N), torch.zeros(2 * N)
    with pytest.raises(TypeError, match="expected 3 operands"):
        q.submit(f, (2.0, x))
    with pytest.raises(ValueError, match="shape"):
        q.submit(f, (2.0, x, x2))
    with pytest.raises(TypeError, match="unsupported work target"):
        q.submit(object(), ())
    with pytest.raises(ValueError, match="weight"):
        q.submit(f, (2.0, x, x), weight=0.0)
    with pytest.raises(TypeError, match="plan expects"):
        q.submit(Pkg("torch").plan("saxpby"), (x,))


def _pop(p):
    q = p.mod.RequestQueue()
    f = p.fuse("c0_scale", "c0_add")
    x, b = map(p.arr, arrays(0, 1))
    for i, arr_t in enumerate((0.0, 0.0, 1.0, 5.0)):
        q.submit(f, (2.0 + i, x, b), arrival=arr_t, tenant=f"t{i % 2}")
    q.submit(p.fuse("c0_copy"), (x,), arrival=0.5)
    out = [[(len(bt.items), bt.coalesced, bt.seq, bt.tenant, bt.weight,
             bt.arrival) for bt in q.pop_ready(1.0)]]
    out.append(q.next_arrival(1.0))
    out.append([(len(bt.items), bt.seq) for bt in q.pop_ready()])
    return out


def test_pop_ready_batches_equal():
    j, t = both(_pop)
    assert t == j
    assert t[0][0][:2] == (3, True) and t[1] == 5.0


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def _estimates(p):
    cost = p.cost()
    x, b = map(p.arr, arrays(0, 1))
    out = []
    for names in (("c0_scale", "c0_add"), ("c0_copy",), ("c0_triad",)):
        f = p.fuse(*names)
        for n in (1000, N, 1 << 16, 1 << 20):
            out.append(cost.estimate(f, n_elems=n, dtype=p.f32))
    f = p.fuse("c0_scale", "c0_add")
    out.append(cost.estimate(f, (2.0, x, b)))
    for kind in p.ops.C0_PIPELINES:
        out.append(cost.estimate(p.plan(kind)))
    out.append(cost.estimate(lambda: None, cost_key=("step",)))
    return [dataclasses.astuple(e) for e in out]


def test_estimates_equal(fresh_caches):
    j, t = both(_estimates)
    assert t == j
    sources = {e[-1] for e in t}
    assert sources == {"memhier", "plan", "default"}


def _burst_seed(p):
    # no hierarchy anywhere: the Program's own burst-law seed. Both
    # packages' programs are built with the same model values and budget.
    bm = (p.mod.cost.BurstModel(1e9, 1e-6) if p.name == "jax"
          else BurstModel(1e9, 1e-6))
    prog = p.isa.fuse("c0_scale", "c0_add").program
    kw = ({"vmem_budget": VMEM_BYTES} if p.name == "jax"
          else {"smem_budget": VMEM_BYTES})
    prog = type(prog)(prog.stages, model=bm, **kw)
    e = p.mod.CostModel().estimate(prog, n_elems=N, dtype=p.f32)
    return dataclasses.astuple(e)


def test_burst_seed_equal(fresh_caches):
    j, t = both(_burst_seed)
    assert t == j and t[-1] == "burst"


def _ewma(p):
    cost = p.cost(alpha=0.5)
    f = p.fuse("c0_copy")
    base = cost.estimate(f, n_elems=N, dtype=p.f32)
    seq = []
    for k in (500.0, 2.0, 3.0, 3.0, 2.5, 3.5):          # cold start first
        cost.observe(f, n_elems=N, dtype=p.f32, seconds=k * base.modeled_s)
        seq.append(dataclasses.astuple(cost.estimate(f, n_elems=N,
                                                     dtype=p.f32)))
    fn = lambda: None  # noqa: E731
    cost.observe(fn, seconds=0.5, cost_key=("step",))
    cost.observe(fn, seconds=0.7, cost_key=("step",), n_items=2)
    seq.append(dataclasses.astuple(cost.estimate(fn, cost_key=("step",))))
    e = cost.estimate(f, n_elems=1 << 20, dtype=p.f32)
    seq.append(cost.contended_makespan([e, e, e]))
    seq.append(cost.contended_makespan([e, e], channels=[0, 1]))
    seq.append(cost.fluid_finishes([e, base], channels=[0, 0]))
    return seq


def test_ewma_and_contention_equal(fresh_caches):
    j, t = both(_ewma)
    assert t == j
    # the cold-start sample was discarded: ratio ≈ the steady samples
    assert 2.0 <= t[5][0] / t[5][1] <= 3.5


def test_seed_cache_keys_on_buffers(fresh_caches):
    cost = ts.CostModel(hierarchy=TH)
    stages = lambda: [isa.get("c0_scale").template.stage(),  # noqa: E731
                      isa.get("c0_add").template.stage()]
    p1 = prog_mod.Program(stages(), n_buffers=1)
    p2 = prog_mod.Program(stages(), n_buffers=2)
    assert (cost.estimate(p1, n_elems=N, dtype=F32).modeled_s
            != cost.estimate(p2, n_elems=N, dtype=F32).modeled_s)


def test_ewma_artifacts_byte_equal_and_shared(tmp_path, fresh_caches):
    for p, d, using in ((PKGS[0], tmp_path / "jax", jart.using_plan_cache),
                        (PKGS[1], tmp_path / "torch",
                         artifact.using_plan_cache)):
        with using(d):
            cost = p.cost()
            f = p.fuse("c0_scale", "c0_add")
            base = cost.estimate(f, n_elems=N, dtype=p.f32)
            for k in (5.0, 2.0, 3.0):
                cost.observe(f, n_elems=N, dtype=p.f32,
                             seconds=k * base.modeled_s)
    jfiles = sorted(x.name for x in (tmp_path / "jax").iterdir()
                    if x.name.startswith("ewma-"))
    tfiles = sorted(x.name for x in (tmp_path / "torch").iterdir()
                    if x.name.startswith("ewma-"))
    assert tfiles == jfiles and len(tfiles) == 1
    assert ((tmp_path / "torch" / tfiles[0]).read_bytes()
            == (tmp_path / "jax" / jfiles[0]).read_bytes())
    # a fresh port worker warm-starts from the reference's correction
    with artifact.using_plan_cache(tmp_path / "jax"):
        cost = ts.CostModel(hierarchy=TH)
        est = cost.estimate(PKGS[1].fuse("c0_scale", "c0_add"), n_elems=N,
                            dtype=F32)
        assert est.seconds != est.modeled_s
    with jart.using_plan_cache(tmp_path / "torch"):
        jest = js.CostModel(hierarchy=TPU_V5E).estimate(
            jisa.fuse("c0_scale", "c0_add"), n_elems=N, dtype=jnp.float32)
    assert dataclasses.astuple(jest) == dataclasses.astuple(est)


# ---------------------------------------------------------------------------
# virtual-clock runs, both packages
# ---------------------------------------------------------------------------

def _mixed_queue(p, arrive=0.0):
    q = p.mod.RequestQueue()
    f = p.fuse("c0_scale", "c0_add")
    copy1 = p.fuse("c0_copy")
    x, b = map(p.arr, arrays(0, 1))
    q.submit(f, (2.0, x, b), deadline=1e-3, tenant="A", arrival=arrive)
    q.submit(f, (2.0, b, x), deadline=2e-3, tenant="A", arrival=arrive)
    q.submit(copy1, (x,), tenant="B", weight=2.0, arrival=arrive)
    q.submit(copy1, (b,), tenant="B", arrival=arrive)
    return q


def _two_tenants(p):
    """Tenant A: coalescible scale→add requests with mixed scalars and
    staggered arrivals; tenant B: the three c0 plans and a copy."""
    q = p.mod.RequestQueue()
    f = p.fuse("c0_scale", "c0_add")
    xs = [p.arr(a) for a in arrays(*range(10, 16))]
    for i in range(6):
        q.submit(f, (0.5 * (i + 1), xs[i], xs[(i + 1) % 6]), tenant="A",
                 arrival=1e-6 * (i // 2), deadline=5e-5 * (i + 1))
    x, b = map(p.arr, arrays(0, 1))
    q.submit(p.plan("axpby_residual"), (x, b, 1.5, 0.5), tenant="B",
             weight=2.0)
    q.submit(p.plan("saxpby"), (x, b, 2.0, -0.75), tenant="B",
             arrival=2e-6)
    q.submit(p.plan("diamond"), (x, 3.0), tenant="B", arrival=3e-6)
    q.submit(p.fuse("c0_copy"), (b,), tenant="B", arrival=3e-6)
    return q


RUNS = {   # name: (queue, scheduler kwargs)
    **{f"mixed-{pol}-{lanes}": (_mixed_queue, dict(policy=pol,
                                                   n_lanes=lanes))
       for pol in ("fifo", "edf", "wfq") for lanes in (1, 2)},
    **{f"tenants-{pol}": (_two_tenants, dict(policy=pol, n_lanes=2))
       for pol in ("fifo", "edf", "wfq")},
    "tenants-wfq-3lanes-channels": (_two_tenants, dict(
        policy="wfq", n_lanes=3, n_channels=2)),
    "tenants-edf-lane-table": (_two_tenants, dict(
        policy="edf", n_lanes=2, lane_channels=[1, 0])),
    "tenants-wfq-regions": (_two_tenants, dict(
        policy="wfq", n_lanes=2, region_slots=1, region_policy="reuse")),
}


def _virtual(p, queue_fn, kw, tracer=False):
    rec = p.mod.TraceRecorder()
    sched = p.mod.Scheduler(queue_fn(p), cost=p.cost(), clock="virtual",
                            recorder=rec, **kw)
    return sched.drain(), rec


@pytest.mark.parametrize("run", sorted(RUNS))
def test_virtual_traces_byte_identical(run, fresh_caches):
    queue_fn, kw = RUNS[run]
    (jrep, jrec), (trep, trec) = both(lambda p: _virtual(p, queue_fn, kw))
    assert trec.dumps() == jrec.dumps()
    assert ts.placements_match(trep.placements, jrep.placements)
    assert (trep.makespan, trep.missed) == (jrep.makespan, jrep.missed)
    for line in trec.dumps().splitlines():
        json.loads(line)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_reference_trace_replays_in_the_port(run, fresh_caches):
    queue_fn, kw = RUNS[run]
    jrep, jrec = _virtual(PKGS[0], queue_fn, kw)
    rep2 = ts.replay(ts.TraceRecorder.loads(jrec.dumps()))
    assert ts.placements_match(jrep.placements, rep2.placements)
    assert rep2.makespan == jrep.makespan


def test_span_trees_byte_identical(fresh_caches):
    out = []
    for p, tmod in zip(PKGS, (jtrace, ttrace)):
        with tmod.using_tracer(tmod.Tracer(clock=tmod.VirtualClock())) as tr:
            _virtual(p, _two_tenants, dict(policy="wfq", n_lanes=2))
        out.append(tr.export_jsonl())
    assert out[1] == out[0]
    assert '"name":"placement"' in out[1]


def test_replay_overrides_and_errors(fresh_caches):
    rep, rec = _virtual(PKGS[1], _mixed_queue, dict(policy="edf",
                                                    n_lanes=2))
    assert len(ts.replay(rec, policy="wfq").placements) == len(
        rep.placements)
    assert len(ts.replay(rec, n_lanes=1).placements) == len(rep.placements)
    with pytest.raises(ValueError, match="no submit events"):
        ts.replay(ts.TraceRecorder())


def test_plan_parts_schedule_with_contention(fresh_caches):
    plan = Pkg("torch").plan("axpby_residual")
    units = plan.units()
    assert all(u.predicted_s is not None for u in units)
    assert tuple(u.deps for u in units) == plan.part_deps()
    q = ts.RequestQueue()
    rng = np.random.default_rng(0)
    ops_ = [torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32))
            if isinstance(key, Value) else 2.0
            for _, key in plan.graph.free_inputs()]
    q.submit(plan, tuple(ops_))
    rep = ts.Scheduler(q, cost=ts.CostModel(hierarchy=TH), clock="virtual",
                       n_lanes=2).drain()
    assert rep.makespan >= plan.predicted_time() - 1e-18
    assert rep.makespan <= plan.predicted_time(overlap=False) + 1e-18


def test_policy_and_mesh_errors():
    with pytest.raises(ValueError, match="unknown policy"):
        ts.Scheduler(ts.RequestQueue(), policy="srtf")
    with pytest.raises(ValueError, match="clock"):
        ts.Scheduler(ts.RequestQueue(), clock="sundial")
    with pytest.raises(NotImplementedError, match="item 15"):
        ts.Scheduler(ts.RequestQueue(), mesh=object())
    with pytest.raises(NotImplementedError, match="distributed"):
        ts.sharded_program_call(isa.fuse("c0_copy"), [], object())


# ---------------------------------------------------------------------------
# wall-clock runs on the CPU (interpret mode)
# ---------------------------------------------------------------------------

def _fma_ok(got, want, terms) -> bool:
    return bool(np.all(np.abs(np.asarray(got) - np.asarray(want))
                       <= 4 * EPS * terms))


def test_wall_results_match_solo_calls_and_the_reference(fresh_caches):
    p = PKGS[1]
    rep = ts.Scheduler(_two_tenants(p), cost=p.cost(), policy="wfq",
                       n_lanes=2, clock="wall", mode="interpret").drain()
    jrep = js.Scheduler(_two_tenants(PKGS[0]), cost=PKGS[0].cost(),
                        policy="wfq", n_lanes=2, clock="wall",
                        mode="interpret").drain()
    assert len(rep.placements) == 10
    assert sorted(p_.seq for p_ in rep.placements) == list(range(10))
    xs = arrays(*range(10, 16))
    f = isa.fuse("c0_scale", "c0_add")
    for i in range(6):
        s, a, b = 0.5 * (i + 1), xs[i], xs[(i + 1) % 6]
        got = rep.results[i]
        assert torch.equal(got, f(s, torch.from_numpy(a),
                                  torch.from_numpy(b), mode="interpret"))
        assert _fma_ok(got, jrep.results[i], np.abs(s * a) + np.abs(b))
    x, b = arrays(0, 1)
    plans = [p.plan(k) for k in ("axpby_residual", "saxpby", "diamond")]
    args = [(x, b, 1.5, 0.5), (x, b, 2.0, -0.75), (x, 3.0)]
    terms = [(np.abs(1.5 * x) + np.abs(b), np.abs(x) + np.abs(0.5 * b)),
             (np.abs(2.0 * x) + np.abs(0.75 * b),), (np.zeros_like(x),)]
    for k, (plan, a_, tm) in enumerate(zip(plans, args, terms)):
        targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                 for v in a_]
        got = rep.results[6 + k]
        got = got if isinstance(got, tuple) else (got,)
        solo = plan(*targs, mode="interpret")
        solo = solo if isinstance(solo, tuple) else (solo,)
        want = jrep.results[6 + k]
        want = want if isinstance(want, tuple) else (want,)
        for g, s_, w, t_ in zip(got, solo, want, tm):
            assert torch.equal(g, s_)
            assert _fma_ok(g, w, t_)
    assert torch.equal(rep.results[9], torch.from_numpy(b))


def test_wall_run_feeds_the_cost_model_and_coalesces(fresh_caches):
    p = PKGS[1]
    cost = p.cost()
    with prog_mod.dispatch_stats_window() as w:
        rep = ts.Scheduler(_mixed_queue(p), cost=cost, policy="fifo",
                           n_lanes=2, clock="wall",
                           mode="interpret").drain()
        assert w.delta("batch_calls") == 2          # A's pair, B's pair
    assert all(p_.coalesced for p_ in rep.placements)
    assert all(p_.observed_s > 0 for p_ in rep.placements)
    assert len(cost.drift_report()) == 2
    # auto on CPU tensors is the oracle: no batch launch at all
    with prog_mod.dispatch_stats_window() as w:
        ts.Scheduler(_mixed_queue(p), cost=cost, clock="wall").drain()
        assert w.delta("batch_calls") == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.Scheduler(_mixed_queue(p), cost=cost, clock="wall",
                     mode="kernel").drain()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase I at tiny size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_phase_i_matches_jax_and_solo(smoke, fresh_caches):
    n_item, k, n_plan = 3 * 4096 + 5, 4, 4 * 4096 + 3
    arrs = smoke.make_inputs(12, [n_item] * (2 * k) + [n_plan] * 2, "cpu")
    xs, bs, (x, b) = arrs[:k], arrs[k:2 * k], arrs[-2:]
    plans = smoke.sched_plans(n_plan)
    assert [pl.n_parts for pl in plans] == [2, 2]
    rec = ts.TraceRecorder()
    with prog_mod.dispatch_stats_window() as w:
        rep, a_items, b_items = smoke.phase_i(xs, bs, x, b, plans,
                                              "interpret", recorder=rec)
        assert w.delta("batch_calls") == 1 and w.delta("batch_items") == k
    assert len({pl.batch_seq for pl in rep.placements}) == 3
    fused = isa.fuse("c0_scale", "c0_add")
    jf = jisa.fuse("c0_scale", "c0_add")
    for it, xa, ba in zip(a_items, xs, bs):
        assert torch.equal(it.result, fused(smoke.SCALE, xa, ba,
                                            mode="interpret"))
        want = jf(smoke.SCALE, jnp.asarray(xa.numpy()),
                  jnp.asarray(ba.numpy()), mode="interpret")
        assert _fma_ok(it.result, want, smoke.fma_bound(
            (smoke.SCALE * xa, ba)).numpy() / (4 * EPS))
    jplans = (jpartition(jops.c0_pipeline_graph("axpby_residual"),
                         n_elems=n_plan),
              jpartition(jops.c0_pipeline_graph("saxpby"), n_elems=n_plan))
    jx, jb = jnp.asarray(x.numpy()), jnp.asarray(b.numpy())
    for it, plan, jplan, sc in zip(b_items, plans, jplans,
                                   ((smoke.PLAN_S, smoke.PLAN_T),
                                    (smoke.SAX_A, smoke.SAX_B))):
        got = smoke.outputs(it.result)
        solo = smoke.outputs(plan(x, b, *sc, mode="interpret"))
        want = smoke.outputs(jplan(jx, jb, *sc, mode="interpret"))
        terms = smoke.plan_terms(plan.graph.name.removeprefix("c0_"), x, b)
        for g, s_, w_, t_ in zip(got, solo, want, terms):
            assert torch.equal(g, s_)
            assert _fma_ok(g, w_, t_.numpy())
        check = smoke.Check()
        smoke.CHUNK = 4096
        smoke.hold_plan(check, plan.graph.name, plan, got, x, b, sc)
        assert not check.failures
    # the recorded wall run replays with the same decisions
    rep_r = ts.replay(ts.TraceRecorder.loads(rec.dumps()))
    assert ([(q.seq, q.lane, q.round, q.batch_seq, q.predicted_s)
             for q in rep_r.placements]
            == [(q.seq, q.lane, q.round, q.batch_seq, q.predicted_s)
                for q in rec.placements()])
    table = smoke.batch_table(rep, {a_items[0].seq: "A",
                                    b_items[0].seq: "axpby",
                                    b_items[1].seq: "saxpby"})
    assert [r["items"] for r in sorted(table, key=lambda r: r["batch"])] \
        == [k, 1, 1]
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_i(xs, bs, x, b, plans, "kernel")


def test_h100_cost_model_prices_the_phase_i_mix(fresh_caches):
    """The H100 preset's seeds for phase I's mix at its full sizes (no
    data: estimates only)."""
    cost = ts.CostModel(hierarchy=H100)
    f = isa.fuse("c0_scale", "c0_add")
    e = cost.estimate(f, n_elems=1 << 22, dtype=F32)
    assert e.source == "memhier" and e.seconds > 0
    assert e.dram_bytes >= 3 * 4 * (1 << 22)

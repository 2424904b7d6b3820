"""repro_torch.obs against repro.obs: the metrics exposition text, the JSON
snapshot and every span export are byte-equal for the same events, and
a dispatch through each package's Program under a virtual clock exports
the same span JSONL."""
import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch.obs import metrics as torch_metrics
from repro_torch.obs import trace as torch_trace


def _fill(mod):
    r = mod.MetricsRegistry()
    r.counter("repro_dispatch_geometry_hits_total",
              help="dispatch counter geometry_hits").inc(3)
    g = r.gauge("repro_sched_queue_depth", help="queue\nlength",
                labels={"lane": "0"})
    g.set(7)
    g.dec(2)
    r.gauge("repro_sched_queue_depth", labels={"lane": 'a"b\\c'}).set(1.5)
    h = r.histogram("repro_sched_latency_seconds", help="latency",
                    labels={"tenant": "A"})
    for v in (1e-4, 3e-3, 0.2, 12.0, 0.25):
        h.observe(v)
    r.histogram("repro_custom", buckets=(1, 2, 4, float("inf"))).observe(3)
    r.histogram("repro_empty")
    return r


@pytest.mark.parametrize("export", ["expose_text", "snapshot_json"])
def test_metrics_exports_byte_equal(export):
    want = getattr(_fill(jax_metrics), export)()
    got = getattr(_fill(torch_metrics), export)()
    assert got == want
    assert "repro_sched_latency_seconds_bucket" in _fill(
        torch_metrics).expose_text()


def test_quantiles_equal():
    j = _fill(jax_metrics).get("repro_sched_latency_seconds",
                               {"tenant": "A"})
    t = _fill(torch_metrics).get("repro_sched_latency_seconds",
                                 {"tenant": "A"})
    for q in (0.0, 0.5, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)


def _trace(mod, **tracer_kw):
    t = mod.Tracer(clock=mod.VirtualClock(), **tracer_kw)
    with t.span("dispatch", program="c0_scale+c0_add", n_elems=10,
                dtype="float32") as sp:
        with t.span("negotiate", outcome="sweep", block=[8, 512]):
            pass
        sp.attrs["block"] = [8, 512]
        sp.attrs["scalar"] = np.float32(2.5)
    root = t.start_span("request", parent=None, tenant="A", seq=0)
    with t.under(root):
        with t.span("placement", lane=1, ok=True, share=0.5):
            pass
    t.finish(root, outcome="ok")
    try:
        with t.span("pallas_build", interpret=True):
            raise KeyError("x")
    except KeyError:
        pass
    return t


@pytest.mark.parametrize("export", ["export_jsonl", "export_chrome"])
@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_span_exports_byte_equal(export, rate):
    want = getattr(_trace(jax_trace, sample_rate=rate), export)()
    got = getattr(_trace(torch_trace, sample_rate=rate), export)()
    assert got == want


def test_null_span_when_off():
    assert torch_trace.ACTIVE is None
    with torch_trace.span("dispatch") as sp:
        assert sp is None


def test_dispatch_spans_byte_equal():
    """The same chain, size and model through both packages' Program
    (interpret mode, cold caches): dispatch → negotiate → pallas_build
    with identical attributes, the negotiate fingerprint included."""
    import repro.kernels  # noqa: F401
    import repro_torch.kernels  # noqa: F401
    from repro.core import isa as jisa
    from repro.core import program as jprog
    from repro.core.burst_model import TPU_V5E_HBM
    from repro.core.stream import VMEM_BYTES
    from repro_torch.core import artifact as tart
    from repro_torch.core import isa as tisa
    from repro_torch.core import program as tprog
    from repro_torch.core.burst_model import BurstModel
    from repro.core import artifact as jart

    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000, dtype=np.float32)
    b = rng.standard_normal(1000, dtype=np.float32)
    names = ("c0_scale", "c0_add")

    jp = jprog.Program(tuple(jisa.get(n).template.stage() for n in names))
    jprog.clear_dispatch_caches()
    with jart.using_plan_cache(None):
        with jax_trace.using_tracer(
                jax_trace.Tracer(clock=jax_trace.VirtualClock())) as jt:
            jp(2.0, x, b, interpret=True)

    model = BurstModel(peak_bw=TPU_V5E_HBM.peak_bw,
                       overhead_s=TPU_V5E_HBM.overhead_s)
    tp = tprog.Program(tuple(tisa.get(n).template.stage() for n in names),
                       model=model, smem_budget=VMEM_BYTES)
    tprog.clear_dispatch_caches()
    with tart.using_plan_cache(None):
        with torch_trace.using_tracer(
                torch_trace.Tracer(clock=torch_trace.VirtualClock())) as tt:
            tp(2.0, torch.from_numpy(x), torch.from_numpy(b), interpret=True)

    assert [s.name for s in tt.spans] == ["dispatch", "negotiate",
                                          "pallas_build"]
    assert tt.export_jsonl() == jt.export_jsonl()


def test_dispatch_counters_exposed_under_reference_names():
    from repro_torch.core import program as tprog
    text = torch_metrics.REGISTRY.expose_text()
    for f in tprog._STAT_FIELDS:
        assert f"# TYPE repro_dispatch_{f}_total counter" in text


# ---------------------------------------------------------------------------
# drift (twins of tests/test_obs.py's drift cases)
# ---------------------------------------------------------------------------

def _drift_mods():
    from repro.obs import drift as jax_drift
    from repro_torch.obs import drift as torch_drift
    return jax_drift, torch_drift


def _tpu_v5e_as_port_hierarchy():
    """The JAX package's TPU_V5E preset converted field by field (the
    port carries no TPU preset)."""
    import dataclasses

    from repro.memhier import TPU_V5E
    from repro_torch.core.burst_model import BurstModel
    from repro_torch.memhier import (CacheLevel, ChannelModel, Hierarchy,
                                     LastLevelCache)
    levels = tuple(
        (LastLevelCache if type(lv).__name__ == "LastLevelCache"
         else CacheLevel)(**dataclasses.asdict(lv)) for lv in TPU_V5E.levels)
    return TPU_V5E, Hierarchy(
        TPU_V5E.name, levels,
        BurstModel(TPU_V5E.dram.peak_bw, TPU_V5E.dram.overhead_s),
        ChannelModel(**dataclasses.asdict(TPU_V5E.channels)))


def _drift_records(mod, threshold=None):
    t = mod.DriftTracker(threshold=threshold)
    assert t.record("k1", 1e-3, 3e-3, name="worst") == 3.0
    t.record("k1", 1e-3, 3e-3)
    t.record("k2", 1e-3, 1.2e-3, name="mild", bucket=4096, dtype="float32")
    assert t.record("k3", 0.0, 1.0) is None            # unusable pair
    t.record(("prog", ("c0_scale", 1), 8192, "float32"), 2e-6, 1e-6,
             name="fast", ewma_ratio=0.5)
    return t


@pytest.mark.parametrize("view", ["report", "format_report", "min2"])
def test_drift_report_equal(view):
    jax_drift, torch_drift = _drift_mods()
    j, t = _drift_records(jax_drift), _drift_records(torch_drift)
    if view == "report":
        assert t.report() == j.report()
        assert [r["name"] for r in t.report()] == ["worst", "fast", "mild"]
    elif view == "format_report":
        assert t.format_report() == j.format_report()
    else:
        assert t.report(min_samples=2) == j.report(min_samples=2)


def test_drift_overflow_and_threshold():
    _, torch_drift = _drift_mods()
    t = torch_drift.DriftTracker(max_cells=1)
    t.record("a", 1.0, 1.0)
    assert t.record("b", 1.0, 1.0) is None
    assert t.overflow == 1 and len(t) == 1
    counter = torch_metrics.REGISTRY.counter("repro_drift_exceeded_total")
    base = counter.value
    t = torch_drift.DriftTracker(threshold=0.5)
    t.record("k", 1.0, 10.0)                 # one outlier: not chronic
    assert counter.value == base
    t.record("k", 1.0, 10.0)
    assert counter.value == base + 1 and t.cell_exceeds("k")
    for _ in range(3):
        t.record("fine", 1.0, 1.1, name="fine")
    assert [r["name"] for r in t.exceeding(threshold=0.05)][-1] == "fine"
    with pytest.raises(ValueError):
        torch_drift.DriftTracker().exceeding()
    with pytest.raises(ValueError):
        torch_drift.DriftTracker(threshold=0.0)


def test_cost_model_drift_equal():
    """Both packages' CostModel under the same hierarchy values, fed the
    same observations: identical drift rows (fingerprints included)."""
    import repro.kernels  # noqa: F401
    import repro_torch.kernels  # noqa: F401
    from repro.core import isa as jisa
    from repro.sched import CostModel as JCost
    from repro_torch.core import isa as tisa
    from repro_torch.sched import CostModel as TCost
    jh, th = _tpu_v5e_as_port_hierarchy()
    rows = []
    for cost, isa_mod, f32 in ((JCost(hierarchy=jh), jisa, "float32"),
                               (TCost(hierarchy=th), tisa, torch.float32)):
        fused = isa_mod.fuse("c0_scale", "c0_add")
        est = cost.estimate(fused, n_elems=5000, dtype=f32)
        for _ in range(3):
            cost.observe(fused, n_elems=5000, dtype=f32,
                         seconds=2.0 * est.modeled_s)
        rows.append(cost.drift_report(min_samples=1))
    assert rows[1] == rows[0]
    (cell,) = rows[1]
    assert cell["samples"] == 3 and cell["drift"] == pytest.approx(1.0)
    assert cell["dtype"] == "float32" and cell["ewma_ratio"] == 2.0


def test_watch_programs_bare_calls():
    import repro_torch.kernels  # noqa: F401
    from repro_torch.core import isa as tisa
    _, torch_drift = _drift_mods()
    t = torch_drift.DriftTracker()
    fused = tisa.fuse("c0_scale", "c0_add")
    rng = np.random.default_rng(0)
    x, b = (torch.from_numpy(rng.standard_normal(5000, dtype=np.float32))
            for _ in range(2))
    with torch_drift.watch_programs(t):
        fused(2.0, x, b, mode="interpret")
    (cell,) = t.report(min_samples=1)
    assert cell["samples"] == 1 and cell["mean_ratio"] > 0
    assert cell["name"] == "c0_scale+c0_add" and cell["bucket"] == 8192


@pytest.mark.parametrize("threshold", [0.4, None])
def test_chronic_drift_renegotiates_next_dispatch(threshold):
    import repro_torch.kernels  # noqa: F401
    from repro_torch.core import isa as tisa
    from repro_torch.core import program as tprog
    from repro_torch.sched import CostModel
    _, th = _tpu_v5e_as_port_hierarchy()
    tprog.clear_dispatch_caches()
    cost = CostModel(hierarchy=th, drift_threshold=threshold)
    fused = tisa.fuse("c0_scale", "c0_add")
    rng = np.random.default_rng(1)
    ops = (2.0,) + tuple(torch.from_numpy(rng.standard_normal(
        5000, dtype=np.float32)) for _ in range(2))
    fused(*ops, mode="interpret")                # warm geometry memo
    base = tprog.DISPATCH_STATS.drift_renegotiated
    est = cost.estimate(fused, n_elems=5000, dtype=torch.float32)
    for _ in range(2):                           # chronic, not one-off
        cost.observe(fused, n_elems=5000, dtype=torch.float32,
                     seconds=est.modeled_s * 10)
    fused(*ops, mode="interpret")
    fused(*ops, mode="interpret")                # the flag is consumed
    want = 1 if threshold is not None else 0
    assert tprog.DISPATCH_STATS.drift_renegotiated == base + want
    assert bool(cost.drift.exceeding(threshold=0.4)) is True


# ---------------------------------------------------------------------------
# blame, tail sampling and SLOs (twins of tests/test_obs.py's §19 cases):
# the same virtual-clock scheduler run or the same events through both
# packages, the exports compared byte for byte
# ---------------------------------------------------------------------------

class _Side:
    """One package's obs and sched modules, with its fused scale→add
    under the JAX package's budget and the TPU_V5E hierarchy (converted
    for the port), so both negotiate and cost the same."""

    def __init__(self, name):
        import repro.kernels  # noqa: F401
        import repro_torch.kernels  # noqa: F401
        from repro.core.stream import VMEM_BYTES
        self.name = name
        if name == "jax":
            import jax.numpy as jnp
            from repro import obs, sched
            from repro.core import isa
            from repro.core import program as prog
            self.hier, _ = _tpu_v5e_as_port_hierarchy()
            self.arr = lambda a: jnp.asarray(a, jnp.float32)
            self.fused = lambda: isa.fuse("c0_scale", "c0_add")
        else:
            from repro_torch import obs, sched
            from repro_torch.core import isa
            from repro_torch.core import program as prog
            _, self.hier = _tpu_v5e_as_port_hierarchy()
            self.arr = torch.from_numpy

            def fused():
                instrs = (isa.get("c0_scale"), isa.get("c0_add"))
                p, spec = isa.fuse_chain(instrs, smem_budget=VMEM_BYTES)
                return isa.FusedProgram(name=p.name, spec=spec,
                                        instrs=instrs, program=p,
                                        registry=isa.registry)
            self.fused = fused
        from importlib import import_module
        pkg = "repro" if name == "jax" else "repro_torch"
        self.trace = import_module(f"{pkg}.obs.trace")
        self.metrics = import_module(f"{pkg}.obs.metrics")
        self.critical = import_module(f"{pkg}.obs.critical")
        self.tail = import_module(f"{pkg}.obs.tail")
        self.slo = import_module(f"{pkg}.obs.slo")
        self.obs, self.sched, self.prog = obs, sched, prog

    def operands(self, n=5000):
        rng = np.random.default_rng(0)
        return (2.0, self.arr(rng.standard_normal(n).astype(np.float32)),
                self.arr(rng.standard_normal(n).astype(np.float32)))

    def tracer(self, **kw):
        return self.trace.Tracer(clock=self.trace.VirtualClock(), **kw)

    def blame_run(self, n=6, arrival_step=1e-4):
        """tests/test_obs.py ``_blame_run``: ``n`` requests, two tenants,
        distinct scalars (separate batches), under the ACTIVE tracer."""
        fused = self.fused()
        _, x, b = self.operands(2048)
        q = self.sched.RequestQueue()
        for i in range(n):
            q.submit(fused, (2.0 + i, x, b), tenant=f"t{i % 2}",
                     arrival=i * arrival_step)
        self.sched.Scheduler(q, cost=self.sched.CostModel(hierarchy=self.hier),
                             policy="fifo", n_lanes=1,
                             clock="virtual").drain()

    def traced_blame_run(self, n):
        self.prog.clear_dispatch_caches()
        t = self.tracer()
        with self.trace.using_tracer(t):
            self.blame_run(n=n)
        return t

    def finish_request(self, t, latency, tenant="default", error=False):
        root = t.start_span("request", parent=None, tenant=tenant,
                            arrival=0.0)
        child = t.start_span("placement", parent=root)
        if error:
            child.attrs["error"] = "RuntimeError: boom"
        t.finish(child)
        t.finish(root, start=0.0, finish=latency)
        return root

    def burning_monitor(self, tenant="b"):
        mon = self.slo.SloMonitor(threshold=2.0)
        mon.add(tenant, target_s=1e-3, objective=0.9, fast_s=1.0, slow_s=10.0)
        for i in range(30):
            mon.record(tenant, 5e-3, now=0.1 + i * 0.3)
        return mon


@pytest.fixture(scope="module")
def sides():
    return _Side("jax"), _Side("torch")


class TestBlame:
    def test_virtual_conservation_and_buckets(self, sides):
        jx, pt = sides
        got = pt.critical.attribute(pt.traced_blame_run(6))
        want = jx.critical.attribute(jx.traced_blame_run(6))
        assert [b.seq for b in got] == list(range(6))
        assert pt.critical.max_residual(got) <= 1e-9
        for b in got:
            assert b.buckets["negotiate"] == 0.0
            assert b.buckets["pallas_build"] == 0.0
            assert b.buckets["compute"] > 0.0
            assert b.buckets["queue_wait"] >= 0.0
            assert b.total_s == pytest.approx(b.finish - b.arrival)
            assert b.critical_path[0] == "request"
            assert len(b.critical_path) >= 2
            assert b.top() in pt.critical.BUCKETS
        assert [b.to_dict() for b in got] == [b.to_dict() for b in want]

    def test_report_ranked_and_formatted(self, sides):
        jx, pt = sides
        got = pt.critical.attribute(pt.traced_blame_run(4))
        want = jx.critical.attribute(jx.traced_blame_run(4))
        rep = pt.critical.blame_report(got)
        assert sorted(rep) == ["t0", "t1"]
        for ranked in rep.values():
            assert {k for k, _ in ranked} == set(pt.critical.BUCKETS)
            totals = [v for _, v in ranked]
            assert totals == sorted(totals, reverse=True)
        assert rep == jx.critical.blame_report(want)
        text = pt.critical.format_report(got)
        assert "blame[t0]:" in text and "blame[t1]:" in text
        assert text == jx.critical.format_report(want)

    def test_export_jsonl_byte_stable_and_id_free(self, sides):
        jx, pt = sides

        def run(side):
            t = side.tracer()
            with side.trace.using_tracer(t):
                side.blame_run(n=4)
            return side.critical.export_jsonl(side.critical.attribute(t))

        run(pt), run(jx)                 # warm geometry/dispatch state
        a, b = run(pt), run(pt)
        assert a == b and a
        assert a == run(jx)
        for line in a.strip().splitlines():
            d = json.loads(line)
            assert "span_id" not in d and "trace_id" not in d
            assert set(d["buckets"]) == set(pt.critical.BUCKETS)

    def test_shed_and_unfinished_roots_skipped(self, sides):
        _, pt = sides
        tracer = pt.trace.Tracer()
        root = tracer.start_span("request", parent=None, seq=0,
                                 tenant="a", arrival=0.0)
        tracer.finish(root, shed=True)   # finished without blame inputs
        tracer.start_span("request", parent=None, seq=1, arrival=0.0)
        assert pt.critical.attribute(tracer) == []

    def test_wall_clock_carves_negotiate(self, sides):
        # the wall clock is the port's own: no byte comparison
        _, pt = sides
        from repro_torch.core import artifact
        pt.prog.clear_dispatch_caches()
        tracer = pt.trace.Tracer()
        with pt.trace.using_tracer(tracer), artifact.using_plan_cache(None):
            q = pt.sched.RequestQueue()
            q.submit(pt.fused(), pt.operands(), arrival=0.0)
            pt.sched.Scheduler(q, cost=pt.sched.CostModel(hierarchy=pt.hier),
                               policy="fifo", n_lanes=1, clock="wall",
                               mode="interpret").drain()
        (b,) = pt.critical.attribute(tracer)
        assert b.clock == "wall"
        assert abs(b.residual_s) <= 1e-9
        assert b.buckets["negotiate"] > 0.0      # cold sweep carved out
        assert b.buckets["pallas_build"] >= 0.0
        assert b.buckets["compute"] >= 0.0       # carve-out never negative


    def test_wall_clock_clamp_leaves_compute_at_zero(self, sides):
        # a cold negotiate and build longer than the solo share: both are
        # scaled into it, and the pair rounds past solo at these values
        _, pt = sides
        solo, neg, build = (0.13436424411240122, 0.9817979810496339,
                            0.381887309488307)
        scale = solo / (neg + build)
        assert solo - neg * scale - build * scale < 0     # the rounding
        t = pt.trace.Tracer(clock=pt.trace.VirtualClock())
        root = t.start_span("request", parent=None, arrival=0.0, start=0.0,
                            finish=2.0, solo_s=solo, batch_s=solo,
                            clock="wall")
        for name, took in (("negotiate", neg), ("pallas_build", build)):
            child = t.start_span(name, parent=root)
            child.start, child.end = 0.0, took
        t.finish(root)
        (b,) = pt.critical.attribute(t)
        assert b.buckets["compute"] == 0.0
        assert b.buckets["negotiate"] >= 0.0 and b.buckets["pallas_build"] >= 0.0
        assert abs(b.residual_s) <= 1e-9

class TestTailSampler:
    def test_requires_full_head_rate(self, sides):
        _, pt = sides
        with pytest.raises(ValueError):
            pt.tail.TailSampler(pt.trace.Tracer(sample_rate=0.5))

    def test_parameter_validation(self, sides):
        _, pt = sides
        t = pt.trace.Tracer()
        for kw in (dict(ring=0), dict(sample_rate=1.5), dict(quantile=1.0)):
            with pytest.raises(ValueError):
                pt.tail.TailSampler(t, **kw)

    def test_error_beats_slo_beats_head(self, sides):
        out = []
        for side in sides:
            t = side.tracer()
            ts = side.tail.TailSampler(t, sample_rate=1.0, slo_s=1e-3)
            e = side.finish_request(t, 5e-3, error=True)
            s = side.finish_request(t, 5e-3)
            f = side.finish_request(t, 1e-4)
            assert [ts.kept[r.span_id] for r in (e, s, f)] == [
                "error", "slo", "head"]
            out.append((ts.stats(), ts.export_jsonl()))
        assert out[1] == out[0]
        assert out[1][0]["by_reason"] == {"error": 1, "slo": 1, "p99": 0,
                                          "head": 1}

    def test_per_tenant_slo_dict(self, sides):
        out = []
        for side in sides:
            t = side.tracer()
            ts = side.tail.TailSampler(t, slo_s={"gold": 1e-3})
            g = side.finish_request(t, 2e-3, tenant="gold")
            side.finish_request(t, 2e-3, tenant="free")   # no SLO
            assert list(ts.kept) == [g.span_id]
            out.append((dict(ts.kept), ts.export_jsonl()))
        assert out[1] == out[0]

    def test_head_credit_deterministic(self, sides):
        out = []
        for side in sides:
            t = side.tracer()
            ts = side.tail.TailSampler(t, sample_rate=0.5)
            kept = [i for i in range(6)
                    if side.finish_request(t, 1e-4).span_id in ts.kept]
            out.append(kept)
        assert out[1] == out[0] == [0, 2, 4]

    def test_p99_threshold_is_causal(self, sides):
        out = []
        for side in sides:
            t = side.tracer()
            ts = side.tail.TailSampler(t, p99_min=2)
            side.finish_request(t, 1e-3)           # window unarmed
            side.finish_request(t, 1e-3)
            slow = side.finish_request(t, 5e-3)    # >= p99 of {1ms, 1ms}
            assert list(ts.kept.values()) == ["p99"]
            assert list(ts.kept) == [slow.span_id]
            out.append(ts.export_jsonl())
        assert out[1] == out[0]

    def test_ring_eviction_prunes_tracer(self, sides):
        out = []
        for side in sides:
            t = side.tracer()
            ts = side.tail.TailSampler(t, ring=2)
            roots = [side.finish_request(t, 1e-4) for _ in range(5)]
            assert ts.kept == {} and ts.evicted == 3
            alive = {s.span_id for s in t.spans}
            assert all(r.span_id not in alive for r in roots[:3])
            assert all(r.span_id in alive for r in roots[3:])
            out.append((ts.stats(), t.export_jsonl()))
        assert out[1] == out[0]
        assert out[1][0]["provisional"] == 2

    def test_export_jsonl_byte_stable(self, sides):
        def run(side):
            t = side.tracer()
            ts = side.tail.TailSampler(t, slo_s=1e-3, sample_rate=0.5)
            side.finish_request(t, 5e-3)
            side.finish_request(t, 1e-4)
            side.finish_request(t, 2e-3, error=True)
            return ts.export_jsonl()

        jx, pt = sides
        a, b = run(pt), run(pt)
        assert a == b == run(jx) and a
        reasons = [json.loads(ln).get("keep_reason")
                   for ln in a.strip().splitlines()]
        assert [r for r in reasons if r] == ["slo", "head", "error"]

    def test_kept_counters_under_the_reference_names(self, sides):
        _, pt = sides
        t = pt.tracer()
        pt.tail.TailSampler(t, slo_s=1e-3)
        pt.finish_request(t, 5e-3)
        text = pt.metrics.REGISTRY.expose_text()
        assert 'repro_obs_tail_kept_total{reason="slo"}' in text


class TestSlo:
    @staticmethod
    def _slo(side, **kw):
        kw.setdefault("objective", 0.9)
        kw.setdefault("fast_s", 1.0)
        kw.setdefault("slow_s", 10.0)
        return side.slo.Slo("a", 1e-3, **kw)

    def test_burn_rate_algebra(self, sides):
        out = []
        for side in sides:
            s = self._slo(side)
            assert s.burn_rate() == 0.0
            assert s.record(2e-3, now=100.0) is True
            assert s.record(0.5e-3, now=100.5) is False
            out.append(s.burn_rate(now=100.5, window="fast"))
        assert out[1] == out[0] == pytest.approx(5.0)

    def test_effective_now_never_rewinds(self, sides):
        _, pt = sides
        s = self._slo(pt)
        s.record(2e-3, now=100.0)
        assert s.burn_rate(now=0.0, window="fast") == \
            s.burn_rate(now=None, window="fast")

    def test_burning_requires_both_windows(self, sides):
        out = []
        for side in sides:
            s = self._slo(side)
            for i in range(18):                    # healthy history
                s.record(1e-4, now=i * 0.5)
            s.record(5e-3, now=9.4)
            s.record(5e-3, now=9.6)
            rates = [s.burn_rate(now=9.6, window=w) for w in ("fast", "slow")]
            assert rates[0] > 2.0 and rates[1] <= 2.0
            assert not s.burning(now=9.6, threshold=2.0)
            for k in range(8):                     # sustained breach
                s.record(5e-3, now=9.61 + k * 0.01)
            assert s.burning(now=9.7, threshold=2.0)
            out.append(rates + [s.burn_rate(now=9.7, window=w)
                                for w in ("fast", "slow")])
        assert out[1] == out[0]

    def test_validation(self, sides):
        _, pt = sides
        for args, kw in (((0.0,), {}), ((1e-3,), dict(objective=1.0)),
                         ((1e-3,), dict(fast_s=10.0, slow_s=1.0))):
            with pytest.raises(ValueError):
                pt.slo.Slo("a", *args, **kw)
        with pytest.raises(ValueError):
            self._slo(pt).burn_rate(window="weird")

    def test_max_events_sweeps_old(self, sides):
        _, pt = sides
        s = self._slo(pt, max_events=4)
        for i in range(10):
            s.record(1e-4, now=float(i * 100))     # far apart in time
        assert len(s._events) <= 4


class TestSloMonitor:
    def test_add_get_and_duplicates(self, sides):
        _, pt = sides
        mon = pt.slo.SloMonitor()
        slo = mon.add("a", target_s=1e-3)
        assert mon.get("a") is slo and mon.tenants() == ["a"]
        with pytest.raises(ValueError):
            mon.add("a", target_s=2e-3)
        assert mon.get("nope") is None

    def test_record_unregistered_is_noop(self, sides):
        _, pt = sides
        mon = pt.slo.SloMonitor()
        mon.record("ghost", 1.0, now=0.0)          # must not raise
        mon.record_shed("ghost", now=0.0)
        assert mon.burn_rates() == {}

    def test_burning_and_report(self, sides):
        out = []
        for side in sides:
            mon = side.burning_monitor()
            mon.add("ok", target_s=1.0)
            mon.record("ok", 1e-4, now=9.0)
            assert mon.burning(now=9.1) == ["b"]
            out.append((mon.report(now=9.1), mon.burn_rates(now=9.1)))
        assert out[1] == out[0]
        text = out[1][0]
        assert "slo[b]:" in text and "BURNING" in text
        assert "slo[ok]:" in text and "(ok)" in text

    def test_gauges_exported(self, sides):
        vals = []
        for side in sides:
            side.burning_monitor(tenant="gauge_t")
            g = side.metrics.REGISTRY.get(
                "repro_slo_burn_rate", {"tenant": "gauge_t",
                                        "window": "fast"})
            assert g is not None and g.value > 2.0
            vals.append(g.value)
        assert vals[1] == vals[0]

    def test_record_shed_holds_burn_signal(self, sides):
        _, pt = sides
        mon = pt.burning_monitor()
        before = mon.get("b").burn_rate(now=9.1, window="fast")
        mon.record_shed("b", now=9.2)              # shed = served-zero
        assert mon.get("b").burn_rate(now=9.2, window="fast") >= before


class TestSloShedder:
    def test_validation(self, sides):
        _, pt = sides
        mon = pt.slo.SloMonitor()
        with pytest.raises(ValueError):
            pt.slo.SloShedder(mon, mode="drop")
        with pytest.raises(ValueError):
            pt.slo.SloShedder(mon, weight_factor=0.0)

    def test_accepts_unregistered_and_healthy(self, sides):
        _, pt = sides
        mon = pt.slo.SloMonitor()
        mon.add("a", target_s=1.0)
        shed = pt.slo.SloShedder(mon)
        assert shed.admit("ghost", now=0.0) == "accept"
        assert shed.admit("a", now=0.0) == "accept"

    @pytest.mark.parametrize("mode", ["shed", "deprioritise"])
    def test_decision_and_recorded_events(self, sides, mode):
        out = []
        for side in sides:
            mon = side.burning_monitor()
            shed = side.slo.SloShedder(mon, mode=mode, weight_factor=0.5)
            n0 = len(mon.get("b")._events)
            decision = shed.admit("b", now=9.1)
            out.append((decision, len(mon.get("b")._events) - n0,
                        mon.report(now=9.1)))
        assert out[1] == out[0]
        assert out[1][:2] == ((mode, 1) if mode == "shed" else (mode, 0))

    def test_queue_sheds_burning_tenant(self, sides):
        _, pt = sides
        mon = pt.burning_monitor()
        q = pt.sched.RequestQueue(admission=pt.slo.SloShedder(mon))
        fused = pt.fused()
        counter = pt.metrics.REGISTRY.counter
        base = counter("repro_sched_shed_total", labels={"tenant": "b"}).value
        it = q.submit(fused, pt.operands(), tenant="b", arrival=9.1)
        assert it.shed and len(q) == 0
        assert counter("repro_sched_shed_total",
                       labels={"tenant": "b"}).value == base + 1
        ok = q.submit(fused, pt.operands(), tenant="healthy", arrival=9.1)
        assert not ok.shed and len(q) == 1

    def test_queue_shed_finishes_root_span(self, sides):
        out = []
        for side in sides:
            mon = side.burning_monitor()
            q = side.sched.RequestQueue(admission=side.slo.SloShedder(mon))
            t = side.tracer()
            with side.trace.using_tracer(t):
                it = q.submit(side.fused(), side.operands(), tenant="b",
                              arrival=9.1)
            assert it.span is not None and it.span.end is not None
            assert it.span.attrs["shed"] is True
            assert side.critical.attribute(t) == []  # no blame inputs
            out.append(t.export_jsonl())
        assert out[1] == out[0]

    def test_queue_deprioritises_weight(self, sides):
        _, pt = sides
        mon = pt.burning_monitor()
        q = pt.sched.RequestQueue(admission=pt.slo.SloShedder(
            mon, mode="deprioritise", weight_factor=0.5))
        counter = pt.metrics.REGISTRY.counter
        base = counter("repro_sched_deprioritised_total",
                       labels={"tenant": "b"}).value
        it = q.submit(pt.fused(), pt.operands(), tenant="b", weight=2.0,
                      arrival=9.1)
        assert not it.shed and len(q) == 1
        assert it.weight == pytest.approx(1.0)
        assert counter("repro_sched_deprioritised_total",
                       labels={"tenant": "b"}).value == base + 1

    def test_scheduler_feeds_the_monitor(self, sides):
        # Scheduler(slo=...) records each completion on its clock
        out = []
        for side in sides:
            side.prog.clear_dispatch_caches()
            mon = side.slo.SloMonitor(threshold=2.0)
            mon.add("t0", target_s=1e-9, objective=0.9, fast_s=1.0,
                    slow_s=10.0)
            q = side.sched.RequestQueue(admission=side.slo.SloShedder(mon))
            _, x, b = side.operands(2048)
            for i in range(4):
                q.submit(side.fused(), (2.0 + i, x, b), tenant="t0",
                         arrival=i * 1e-4)
            side.sched.Scheduler(
                q, cost=side.sched.CostModel(hierarchy=side.hier),
                policy="fifo", n_lanes=1, clock="virtual", slo=mon).drain()
            out.append((mon.report(), len(mon.get("t0")._events)))
        assert out[1] == out[0]
        assert out[1][1] == 4 and "BURNING" in out[1][0]


class TestChromeBlameAttrs:
    @staticmethod
    def _run_doc(side):
        t = side.tracer()
        with side.trace.using_tracer(t):
            side.blame_run(n=3)
        return t.export_chrome()

    def test_blame_inputs_typed(self, sides):
        jx, pt = sides
        doc = json.loads(self._run_doc(pt))
        reqs = [e for e in doc["traceEvents"] if e["name"] == "request"]
        assert len(reqs) == 3
        for e in reqs:
            args = e["args"]
            for k in ("solo_s", "batch_s", "swap_s", "contention_s",
                      "dram_busy_s", "channel_busy_s"):
                assert type(args[k]) is float, (k, args[k])
            assert args["clock"] == "virtual"
            assert args["channel"] == 0 and type(args["channel"]) is int
            assert type(args["lane"]) is int

    def test_stable_across_identical_runs(self, sides):
        jx, pt = sides
        self._run_doc(pt), self._run_doc(jx)     # warm geometry/dispatch
        a, b = self._run_doc(pt), self._run_doc(pt)
        assert a == b == self._run_doc(jx)


def test_metrics_http_endpoint_answers_on_localhost():
    import urllib.request
    reg = torch_metrics.MetricsRegistry()
    reg.counter("repro_probe_total", help="probe").inc(2)
    server = torch_metrics.start_http_server(0, registry=reg)
    try:
        host, port = server.server_address[:2]
        assert host == "127.0.0.1"
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert r.read().decode() == reg.expose_text()
        with urllib.request.urlopen(base + "/metrics.json", timeout=10) as r:
            assert json.loads(r.read()) == json.loads(reg.snapshot_json())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        server.shutdown()
        server.server_close()
    assert torch_metrics.default_registry() is torch_metrics.REGISTRY


def test_obs_exports_name_the_reference_set():
    import repro.obs as jobs
    import repro_torch.obs as tobs
    assert sorted(tobs.__all__) == sorted(jobs.__all__)

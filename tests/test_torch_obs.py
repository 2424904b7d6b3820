"""repro_torch.obs against repro.obs: the metrics exposition text, the JSON
snapshot and every span export are byte-equal for the same events, and
a dispatch through each package's Program under a virtual clock exports
the same span JSONL."""
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


@pytest.mark.parametrize("export", ["export_jsonl", "export_chrome",
                                    "export_otlp_json"])
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

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

"""repro_torch.regions against repro.regions (twin of tests/test_regions.py).

Exact parity throughout — the region file, its policies and the reuse
predictor are the same integer and float bookkeeping in both packages:

* region keys of fused programs, bare programs and plans have equal
  ``repr``s, so traces and ``kind="reconfig"`` artifacts key identically;
* ``kind="reconfig"`` artifacts: byte-equal entries for the same key and
  cost, and each package reads the other's;
* the same touch sequence through both packages' region files (every
  policy, bounded and unbounded) gives identical events and counters;
* a virtual-clock scheduler run with regions (the JAX package's TPU_V5E
  values converted into the port's ``Hierarchy`` here) records
  byte-identical JSONL in both packages, and the reference's recording
  replays in the port with the same placements.
"""
import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import regions as jr
from repro import sched as js
from repro.core import artifact as jart
from repro.core import isa as jisa
from repro.core import program as jprog
from repro.core.stream import VMEM_BYTES
from repro.graph import partition as jpartition
from repro.kernels import ops as jops
from repro.memhier import TPU_V5E
from repro_torch import regions as tr
from repro_torch import sched as ts
from repro_torch.core import artifact, isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import BurstModel
from repro_torch.graph import partition
from repro_torch.kernels import ops
from repro_torch.memhier import (CacheLevel, ChannelModel, Hierarchy,
                                 LastLevelCache)
from repro_torch.regions.cost import _reconfig_payload
from repro_torch.regions.residency import SlotState

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


# ---------------------------------------------------------------------------
# region keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [("c0_scale", "c0_add"), ("c0_add",),
                                   ("c0_copy",), ("c0_triad",),
                                   ("c0_scale", "c0_add", "c0_copy")])
def test_region_keys_equal(names):
    tk = tr.region_key_of(isa.fuse(*names))
    jk = jr.region_key_of(jisa.fuse(*names))
    assert repr(tk) == repr(jk) and tk == jk
    assert tr.region_key_of(isa.fuse(*names).program) == tk
    assert eval(repr(tk)) == tk  # noqa: S307 — repr round-trip


@pytest.mark.parametrize("kind", ops.C0_PIPELINES)
def test_plan_region_keys_equal(kind):
    tp = partition(ops.c0_pipeline_graph(kind), model=TH,
                   smem_budget=VMEM_BYTES)
    jp = jpartition(jops.c0_pipeline_graph(kind), model=TPU_V5E,
                    vmem_budget=VMEM_BYTES)
    assert repr(tr.region_key_of(tp)) == repr(jr.region_key_of(jp))


def test_callable_key_falls_back_to_qualname():
    def opaque(x):
        return x
    assert tr.region_key_of(opaque) == jr.region_key_of(opaque)
    assert tr.region_key_of(opaque)[0] == "fn"


# ---------------------------------------------------------------------------
# the reconfiguration cost model
# ---------------------------------------------------------------------------

def test_default_seed_and_observe():
    m = tr.ReconfigCostModel(default_s=1e-3, alpha=0.5)
    assert m.cost(("prog", "x")) == 1e-3 and not m.known(("prog", "x"))
    m.seed(("prog", "x"), 2e-3)
    assert m.cost(("prog", "x")) == 2e-3 and m.known(("prog", "x"))
    m.observe(("k",), 1.0)
    m.observe(("k",), 3.0)
    assert m.cost(("k",)) == pytest.approx(2.0)
    for bad in (0.0, -1.0, math.inf, math.nan):
        with pytest.raises(ValueError):
            m.seed(("k",), bad)
        with pytest.raises(ValueError):
            m.observe(("k",), bad)
    with pytest.raises(ValueError):
        tr.ReconfigCostModel(alpha=0.0)


def test_measure_seeds_positive_delta():
    m = tr.ReconfigCostModel()
    fused = isa.fuse("c0_scale", "c0_add")
    delta = m.measure(fused, 4096, F32)
    assert delta > 0 and m.cost(tr.region_key_of(fused)) == delta
    with pytest.raises(TypeError):
        m.measure(lambda x: x, 1024, F32)
    prog_mod.clear_dispatch_caches()


@pytest.mark.parametrize("raw", [
    None, [], "x", {}, {"cost_s": -1.0, "count": 1},
    {"cost_s": math.inf, "count": 1}, {"cost_s": True, "count": 1},
    {"cost_s": 1e-3, "count": 0}, {"cost_s": 1e-3, "count": True},
    {"cost_s": 1e-3}, {"count": 2},
])
def test_malformed_payload_invalidated(raw):
    assert _reconfig_payload(raw) is None


def test_reconfig_artifacts_byte_equal_and_shared(tmp_path):
    key_t = tr.region_key_of(isa.fuse("c0_scale", "c0_add"))
    key_j = jr.region_key_of(jisa.fuse("c0_scale", "c0_add"))
    with artifact.using_plan_cache(tmp_path / "torch"):
        tr.ReconfigCostModel().seed(key_t, 3.25e-3)
        assert tr.ReconfigCostModel().cost(key_t) == 3.25e-3
    with jart.using_plan_cache(tmp_path / "jax"):
        jr.ReconfigCostModel().seed(key_j, 3.25e-3)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names[0].startswith("reconfig-")
    for n in names:
        assert ((tmp_path / "torch" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes())
    # each package serves the other's entry
    with artifact.using_plan_cache(tmp_path / "jax"):
        assert tr.ReconfigCostModel().known(key_t)
    with jart.using_plan_cache(tmp_path / "torch"):
        assert jr.ReconfigCostModel().cost(key_j) == 3.25e-3


def test_corrupt_artifact_falls_back_and_pinned_never_touches_disk(
        tmp_path):
    with artifact.using_plan_cache(tmp_path):
        tr.ReconfigCostModel().seed(("prog", "corrupt"), 1e-3)
        (path,) = tmp_path.rglob("*.json")
        path.write_text(json.dumps({"cost_s": -5.0, "count": 1}))
        m = tr.ReconfigCostModel(default_s=7e-4)
        assert not m.known(("prog", "corrupt"))
        assert m.cost(("prog", "corrupt")) == 7e-4
        pinned = tr.PinnedReconfigCost({("trace", "k"): 4e-3})
        pinned.observe(("trace", "k"), 8e-3)
        assert pinned.cost(("prog", "other")) == 0.0
        assert len(list(tmp_path.rglob("*.json"))) <= 1
    assert not tr.ReconfigCostModel().known(("prog", "ephemeral"))


# ---------------------------------------------------------------------------
# reuse history, policies, the region file
# ---------------------------------------------------------------------------

def _arrivals(seed, n=60, keys="ABCDE", tenants=("t0", "t1", "t2")):
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0))
        out.append((keys[int(rng.integers(len(keys)))],
                    tenants[int(rng.integers(len(tenants)))], t))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_reuse_history_predictions_equal(seed):
    th, jh = tr.ReuseHistory(alpha=0.5), jr.ReuseHistory(alpha=0.5)
    for k, ten, t in _arrivals(seed):
        th.note(k, ten, t)
        jh.note(k, ten, t)
        for key in "ABCDEZ":
            assert th.predict_next(key) == jh.predict_next(key)
    assert th.frontier == jh.frontier


def test_reuse_history_semantics():
    h = tr.ReuseHistory(alpha=1.0)
    h.note("A", "t0", 1.0)
    assert h.predict_next("A") == math.inf
    h.note("A", "t0", 2.0)
    h.note("B", "t1", 10.0)
    assert h.predict_next("A") == pytest.approx(10.0)
    with pytest.raises(ValueError):
        tr.ReuseHistory(alpha=0.0)


def _slots(mod, **last_used):
    out = {}
    for i, (k, lu) in enumerate(last_used.items()):
        st = mod.residency.SlotState(float(i))
        st.last_used = lu
        out[k] = st
    return out


@pytest.mark.parametrize("policy", ["lru", "reuse"])
@pytest.mark.parametrize("seed", range(3))
def test_policy_victims_equal(policy, seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        keys = rng.choice(list("ABCDEFG"), size=int(rng.integers(2, 6)),
                          replace=False)
        lu = {str(k): float(rng.integers(0, 10)) for k in keys}
        hists = []
        for mod in (tr, jr):
            h = mod.ReuseHistory(alpha=1.0)
            for k, ten, t in _arrivals(seed, n=20, keys="ABCDEFG"):
                h.note(k, ten, t)
            hists.append(h)
        tv = tr.make_policy(policy).choose_victim(
            _slots(tr, **lu), tr.ReconfigCostModel(), hists[0], 5.0)
        jv = jr.make_policy(policy).choose_victim(
            _slots(jr, **lu), jr.ReconfigCostModel(), hists[1], 5.0)
        assert tv == jv


def test_make_policy_and_oracle():
    assert isinstance(tr.make_policy("lru"), tr.LruResidency)
    assert isinstance(tr.make_policy("reuse"), tr.PredictedReuseResidency)
    for name in ("clairvoyant", "oracle"):
        with pytest.raises(ValueError):
            tr.make_policy(name)
    pol = tr.OracleResidency(["A", "B", "A", "C", "B", "A"])
    pol.note_touch("A")
    pol.note_touch("B")
    assert pol.choose_victim(_slots(tr, A=0.0, B=1.0),
                             tr.ReconfigCostModel(), tr.ReuseHistory(),
                             1.0) == "B"


def _touches(seed, n=80):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(2)), "ABCDEF"[int(rng.integers(6))],
             float(i)) for i in range(n)]


def _events(mod, policy, slots, seq):
    cost = mod.PinnedReconfigCost({}, default_s=1e-3)
    if policy == "oracle":
        policy = mod.OracleResidency([k for _, k, _ in seq])
    rf = mod.RegionFile(n_lanes=2, slots=slots, policy=policy, cost=cost)
    out = []
    for lane, key, now in seq:
        rf.note_arrival(key, "t", now)
        peek = rf.charge(lane, key)
        cost_s, events = rf.place(lane, key, now)
        out.append((peek, cost_s, [tuple(e) for e in events]))
    return out, rf.report(), rf.swap_seconds


@pytest.mark.parametrize("policy", ["lru", "reuse", "oracle"])
@pytest.mark.parametrize("slots", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_region_file_events_equal(policy, slots, seed):
    seq = _touches(seed)
    got, rep, swap = _events(tr, policy, slots, seq)
    want, jrep, jswap = _events(jr, policy, slots, seq)
    assert got == want and rep == jrep and swap == jswap
    assert all(peek == cost_s for peek, cost_s, _ in got)


def test_region_file_semantics():
    rf = tr.RegionFile(n_lanes=1, slots=2,
                       cost=tr.PinnedReconfigCost({}, default_s=1e-3))
    assert rf.place(0, "A", 0.0)[0] == 0.0
    assert rf.place(0, "B", 1.0)[0] == 0.0
    cost_s, events = rf.place(0, "C", 2.0)
    assert cost_s == 1e-3 and [e.op for e in events] == ["evict", "load"]
    assert events[0].key == "A"
    del rf._resident[0]["B"]
    assert rf.charge(0, "A") == 1e-3
    unb = tr.RegionFile(n_lanes=1, slots=0)
    assert not unb.bounded and unb.slots_cfg == 0
    with pytest.raises(ValueError):
        tr.RegionFile(n_lanes=0)
    with pytest.raises(ValueError):
        tr.RegionFile(n_lanes=1, slots=-1)
    assert isinstance(SlotState(0.0).uses, int)


# ---------------------------------------------------------------------------
# the scheduler with regions, both packages
# ---------------------------------------------------------------------------

def _region_queue(mod, isa_mod, arr, n_hot=4):
    """A hot program interleaved with two scans (tests/test_regions.py)."""
    q = mod.RequestQueue()
    hot = isa_mod.fuse("c0_scale", "c0_add")
    scan_a, scan_b = isa_mod.fuse("c0_add"), isa_mod.fuse("c0_copy")

    def vec(seed, n=4096):
        return arr(np.random.default_rng(seed).standard_normal(n).astype(
            np.float32))
    x, b = vec(1), vec(2)
    for i in range(n_hot):
        t = i * 1e-4
        q.submit(hot, (2.0 + i, x, b), arrival=t, tenant="hot")
        q.submit(scan_a, (vec(10 + i), b), arrival=t + 3e-5, tenant="scan")
        q.submit(scan_b, (vec(20 + i),), arrival=t + 6e-5, tenant="scan")
    return q


def _drain(pkg, **kw):
    if pkg == "jax":
        mod, rmod, isa_mod, arr, hier = js, jr, jisa, jnp.asarray, TPU_V5E
    else:
        mod, rmod, isa_mod, arr, hier = ts, tr, isa, torch.from_numpy, TH
    if kw.get("region_cost") == "pinned":
        kw["region_cost"] = rmod.PinnedReconfigCost({}, default_s=1e-3)
    rec = mod.TraceRecorder()
    sched = mod.Scheduler(_region_queue(mod, isa_mod, arr),
                          cost=mod.CostModel(hierarchy=hier),
                          policy=kw.pop("policy", "fifo"),
                          n_lanes=kw.pop("n_lanes", 1), clock="virtual",
                          recorder=rec, **kw)
    return sched.drain(), sched, rec


REGION_CONFIGS = [
    {},
    {"region_slots": 0, "region_policy": "reuse"},
    {"region_slots": 1, "region_policy": "lru", "region_cost": "pinned"},
    {"region_slots": 1, "region_policy": "reuse", "region_cost": "pinned"},
    {"region_slots": 2, "region_policy": "reuse"},
    {"region_slots": 1, "region_policy": "lru", "region_cost": "pinned",
     "n_lanes": 2, "policy": "wfq"},
]


@pytest.mark.parametrize("cfg", range(len(REGION_CONFIGS)))
def test_region_traces_byte_identical(cfg):
    _, tsched, trec = _drain("torch", **dict(REGION_CONFIGS[cfg]))
    _, jsched, jrec = _drain("jax", **dict(REGION_CONFIGS[cfg]))
    assert trec.dumps() == jrec.dumps()
    if tsched.regions is not None:
        assert tsched.regions.report() == jsched.regions.report()


@pytest.mark.parametrize("policy", ["lru", "reuse"])
def test_reference_region_trace_replays_in_the_port(policy):
    rep, _, rec = _drain("jax", region_slots=1, region_policy=policy,
                         region_cost="pinned")
    rep2 = ts.replay(ts.TraceRecorder.loads(rec.dumps()))
    assert ts.placements_match(rep.placements, rep2.placements)
    assert rep2.makespan == rep.makespan


def test_bounded_charges_and_unbounded_identity():
    rep_off, sched_off, rec_off = _drain("torch")
    assert sched_off.regions is None and not rec_off.of_kind("region")
    rep_unb, sched_unb, _ = _drain("torch", region_slots=0)
    assert ts.placements_match(rep_off.placements, rep_unb.placements)
    rep_b, sched_b, _ = _drain("torch", region_slots=1,
                               region_cost="pinned")
    assert sched_b.regions.swap_seconds > 0
    assert rep_b.makespan > rep_off.makespan
    assert sched_b.regions.evictions[0] > 1
    with pytest.raises(ValueError):
        ts.Scheduler(ts.RequestQueue(), n_lanes=1, clock="virtual",
                     region_file=tr.RegionFile(n_lanes=3, slots=2))
    jprog.clear_dispatch_caches()

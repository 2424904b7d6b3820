"""``perfbench/lib/spans.py`` on synthetic traces: launch calls paired
with device events in start order, device time attributed to the spans
open at each launch, and no reading where the two do not pair."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import spans  # noqa: E402
from perfbench.lib.trace import Trace  # noqa: E402


def run_of(host, kernels):
    return SimpleNamespace(trace=Trace(1.0, kernels, host))


def launches(*starts, name="cudaLaunchKernel"):
    return [(name, s, s + 1) for s in starts]


def test_pairs_in_start_order():
    # the device runs the launches in order, later than they were made;
    # host events are listed out of order
    host = launches(30, 10, 20) + [("ssm.ssd", 15, 25)]
    dev = [("k_b", 200, 260), ("k_a", 100, 110), ("k_c", 300, 330)]
    starts, secs = spans.paired(run_of(host, dev).trace)
    assert starts.tolist() == [10, 20, 30]
    assert secs.tolist() == pytest.approx([10e-9, 60e-9, 30e-9])
    # only the second launch (20) lies inside ssm.ssd: k_b's 60 of 100
    assert spans.share(run_of(host, dev), ["ssm.ssd"]) == pytest.approx(60.0)


def test_every_launch_api_pairs():
    names = sorted(spans.LAUNCHES)
    host = [(n, 10 * i, 10 * i + 1) for i, n in enumerate(names)]
    host += [("cudaStreamIsCapturing", 5, 6), ("aten::mul", 0, 100),
             ("model.layer", 0, 100)]
    dev = [(f"k{i}", 1000 + 10 * i, 1005 + 10 * i)
           for i in range(len(names))]
    assert spans.share(run_of(host, dev), ["model.layer"]) == 100.0


def test_a_span_contains_its_launches_start():
    # a launch starting at the span's start or end is inside; one a
    # nanosecond past it is not
    host = launches(100, 200, 201) + [("model.head", 100, 200)]
    dev = [("k", 1000, 1001), ("k", 2000, 2003), ("k", 3000, 3006)]
    assert spans.share(run_of(host, dev), ["model.head"]) == \
        pytest.approx(40.0)


def test_nested_and_overlapping_spans_count_once():
    host = launches(10, 20, 30, 40) + [
        ("ssm.ssd", 5, 35), ("ssm.intra", 15, 25),        # nested
        ("ssm.ssd.backward", 28, 45),                     # overlapping
    ]
    dev = [("k", 100 * i, 100 * i + 10) for i in range(1, 5)]
    run = run_of(host, dev)
    assert spans.share(run, ["ssm.ssd", "ssm.intra"]) == pytest.approx(75.0)
    assert spans.share(run, ["ssm.ssd", "ssm.intra", "ssm.ssd.backward"]) \
        == pytest.approx(100.0)
    # two spans of one name, nested (a span open twice) count once
    host2 = launches(10, 20) + [("model.layer", 0, 30),
                                ("model.layer", 5, 15)]
    assert spans.share(run_of(host2, dev[:2]), ["model.layer"]) == 100.0


def test_events_outside_any_span():
    host = launches(10, 50, 90) + [("step.forward", 40, 60),
                                   ("train.step", 0, 100)]
    dev = [("k", 100, 120), ("k", 200, 220), ("k", 300, 360)]
    # the harness's span is not the program's
    assert spans.share(run_of(host, dev), ["step.forward"]) == \
        pytest.approx(20.0)
    assert spans.share(run_of(host, dev), ["step.backward", "step.forward"]) \
        == pytest.approx(20.0)


def test_no_reading_without_the_span():
    # a program that opens no span of the name (the parent commit's)
    host = launches(10, 20)
    dev = [("k", 100, 110), ("k", 200, 210)]
    assert spans.share(run_of(host, dev), ["ssm.ssd"]) is None
    assert spans.share(SimpleNamespace(trace=None), ["ssm.ssd"]) is None


def test_unpaired_counts_go_to_stderr(capsys):
    host = launches(10, 20) + launches(30, name="cudaMemsetAsync") + [
        ("ssm.ssd", 0, 100)]
    dev = [("k", 100, 110), ("Memset (Device)", 200, 210)]
    assert spans.share(run_of(host, dev), ["ssm.ssd"]) is None
    err = capsys.readouterr().err
    assert "3 launch calls" in err and "2 device events" in err
    assert "'cudaLaunchKernel': 2" in err and "'cudaMemsetAsync': 1" in err
    assert "'kernel': 1" in err and "'Memset': 1" in err


@pytest.mark.parametrize("metric,names", [
    ("ssd_pct.prefill", ["ssm.ssd"]),
    ("ssd_intra_pct.prefill", ["ssm.intra"]),
    ("ssd_pct.train", ["ssm.ssd", "ssm.ssd.backward"]),
    ("recompute_pct.train", ["model.layer.recompute"]),
    ("head_pct.train", ["model.head", "model.head.backward"]),
])
def test_readers_read_their_spans(metric, names):
    path = ROOT / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # one launch inside each named span, one outside; each device event
    # as long as its index + 1
    host = [(n, 100 * i, 100 * i + 50) for i, n in enumerate(names)]
    host += launches(*(100 * i + 10 for i in range(len(names))), 1000)
    dev = [("k", 10_000 + 100 * i, 10_000 + 100 * i + i + 1)
           for i in range(len(names) + 1)]
    total = sum(range(1, len(names) + 2))
    assert mod.read(run_of(host, dev)) == pytest.approx(
        100.0 * sum(range(1, len(names) + 1)) / total)
    assert mod.read(run_of(launches(10), dev[:1])) is None

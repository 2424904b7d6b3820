"""The program's counters over the window: ``run.run_cell`` reads the
program's registry just before the window and just after it, and a
reader takes a counter's increase between the two
(``readers.counter``). Driven here by a stand-in cell on the CPU whose
set-up and window increment counters of the port's ``REGISTRY``."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import readers  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402

K = 5
IN_WINDOW = "perfbench_test_window_total"
IN_SETUP = "perfbench_test_setup_total"
LABELLED = "perfbench_test_labelled_total"
LATE = "perfbench_test_registered_in_window_total"


class Batch:
    rows = 1


class StandIn:
    """A cell whose set-up increments one counter and whose window
    increments others K times (one registered only in the window)."""

    def __init__(self, config, mix, seed, device):
        pass

    def setup(self):
        REGISTRY.counter(IN_SETUP).inc(3)
        REGISTRY.counter(IN_WINDOW).inc(2)
        REGISTRY.counter(LABELLED, labels={"path": "kernel"}).inc(7)

    def window(self, seconds):
        for _ in range(K):
            REGISTRY.counter(IN_WINDOW).inc()
            REGISTRY.counter(LABELLED, labels={"path": "eager"}).inc()
            REGISTRY.counter(LATE).inc(2)
        return [Batch()], 1.0

    def free(self):
        pass

    def check(self, batches):
        return {"gap": 0.0}


READERS = {
    "in_window": lambda run: readers.counter(run, IN_WINDOW),
    "in_setup": lambda run: readers.counter(run, IN_SETUP),
    "absent": lambda run: readers.counter(run, "perfbench_test_never_total"),
    "eager": lambda run: readers.counter(run, LABELLED, path="eager"),
    "kernel": lambda run: readers.counter(run, LABELLED, path="kernel"),
    "unlabelled": lambda run: readers.counter(run, LABELLED),
    "late": lambda run: readers.counter(run, LATE),
}


@pytest.fixture
def result(monkeypatch):
    monkeypatch.setattr(bench_run, "driver", lambda mix: StandIn)
    monkeypatch.setattr(bench_run, "reader", READERS.__getitem__)
    monkeypatch.setattr(bench_run, "limits_of", lambda w: {"gap": 1.0})
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(REGISTRY, "_series", {})
    monkeypatch.setattr(REGISTRY, "_families", {})
    bench = {"end_to_end": [{"name": n, "unit": "1"} for n in READERS],
             "per_layer": []}
    cell = {"name": "stand-in", "chips": 1}
    out, bad = bench_run.run_cell(bench, cell, {"model": {}}, {}, 1, 0.0,
                                  False, device="cpu")
    assert not bad
    return {k: v["value"] for k, v in out["metrics"].items()}


def test_counter_incremented_in_the_window_reads_its_count(result):
    assert result["in_window"] == K
    assert result["late"] == 2 * K


def test_counter_incremented_only_in_setup_reads_zero(result):
    assert result["in_setup"] == 0


def test_counter_labels_pick_the_series(result):
    assert result["eager"] == K
    assert result["kernel"] == 0
    assert "unlabelled" not in result


def test_absent_counter_reads_none(result):
    assert "absent" not in result

"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
# widths that a cut may never name: sizes of hidden, intermediate, latent,
# state and projection dims, head sizes, expansion factors, experts a token
WIDTH_KEY = re.compile(r"(_dim|_rank|headdim|d_model|d_state|expand"
                       r"|experts_per_tok|top_k)$|^(hidden|intermediate"
                       r"|moe_intermediate|latent|state|proj)\w*_size$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def _all_metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + _all_metrics(), ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key]), key
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in _all_metrics()]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH_KEY.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_found_by_name(workload):
    bench = ROOT / "perfbench"
    config = next(c for c in BENCH["configs"]
                  if c["name"] == workload["config"])
    assert (ROOT / config["file"]).is_file()
    assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
    mix = json.loads((bench / "traffic" / f"{workload['traffic']}.json")
                     .read_text())
    limits = json.loads((bench / "limits" / f"{workload['name']}.json")
                        .read_text())
    assert limits and all(v >= 0 for v in limits.values())
    assert mix["kind"] in ("serve", "train")
    reported = [m for m in _all_metrics() if _reports(m, workload["name"])]
    for m in reported:
        assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if _reports(m, workload["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, workload["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_cells_report_what_it_moves(metric):
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert any(w["name"] == cell for w in BENCH["workloads"])
        assert _reports(moved, cell), (metric["name"], cell)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert all(k in data for k in config["reduced"])
    m = data["model"]
    assert m["family"] == data["family"]
    assert m["param_dtype"] == "bfloat16"


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)

"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a
run (``run.run_cell``: set-up, window, metrics, check, against the
cell's own limits) on the CPU at a reduced size, with one fault planted
in the program where the cell can have it (``perfbench/lib/faults.py``):
a served token altered where it is produced, the SSD's carried state
scan returning its states unchanged; in training, a step that returns
its state unchanged, and half of the batch left out, the mean taken over
the rest. A sound run at the same size comes out correct."""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import faults  # noqa: E402

SEED = 2 ** 31 + 977
PREFILL, TRAIN = "mamba2-1.3b.prefill-8k", "mamba2-1.3b.train-4k"


def cell_at_reduced_size(workload: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    m = config["model"]
    m.update(n_layers=2, d_model=128, vocab=2048)
    m.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if mix["kind"] == "train":
        mix.update(batch=4, seq_len=64)
    else:
        mix.update(batch=2, prompt_len=128)
    return bench, cell, config, mix


def run(workload: str, monkeypatch) -> dict:
    # the test process may hold JAX, loaded by other test files; the
    # guard against it is tested on its own below
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [])
    result, bad = bench_run.run_cell(*cell_at_reduced_size(workload), SEED,
                                     0.0, False, device="cpu")
    assert not bad
    return result


FAULTS = {
    (PREFILL, "token_altered"), (PREFILL, "scan_unchanged"),
    (TRAIN, "state_unchanged"), (TRAIN, "half_batch"),
}


@pytest.mark.parametrize("workload", [PREFILL, TRAIN])
def test_sound_run_is_correct(workload, monkeypatch):
    result = run(workload, monkeypatch)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    with faults.planted(fault):
        result = run(workload, monkeypatch)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "repro", "repro.models"])
def test_jax_in_the_process_is_named(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name.split(".")[0] in bench_run.forbidden_modules()


def test_the_port_is_not_jax(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe",
                        types.ModuleType("repro_torch_probe"))
    assert bench_run.forbidden_modules() == []

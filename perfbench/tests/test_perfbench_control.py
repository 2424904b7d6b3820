"""The control, at each cell's own size, on the card: the plain reference
computed in float8 (e4m3), the precision below the configuration's
bfloat16, put in the program's place, fails one of the cell's limits on
three seeds, while the program passes them on the same seeds.

Marked ``gpu``: it needs the H100 (the cells run at full size) and skips
without a CUDA device. Run it there with
``python3 -m pytest -q -m gpu perfbench/tests/test_perfbench_control.py``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("mamba2-1.3b.prefill-8k", "mamba2-1.3b.train-4k")
SEEDS = (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cells run at full size)")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _passes(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(cuda, workload):
    import torch

    from perfbench import run as bench_run
    _, _, config, mix = bench_run.load_cell(workload)
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         f"{workload}.json").read_text())
    for seed in SEEDS:
        cell = bench_run.driver(mix)(config, mix, seed, "cuda")
        cell.setup()
        batches, _ = cell.window(0.0,
                                 min_batches=mix["check"].get("batches", 1))
        cell.free()
        assert _passes(cell.check(batches), limits)
        assert not _passes(cell.check(batches, against="fp8"), limits)
        del cell, batches
        torch.cuda.empty_cache()

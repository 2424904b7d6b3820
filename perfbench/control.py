"""Readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--witness-seeds 1] [--faults name,...]

For each seed, in one process: set-up as a run makes it, the batches or
steps of the mix that the check samples (no timed window), then the
check's numbers for the program (the lower readings); for a control
seed, for the control: the plain reference computed in float8 (e4m3)
in the program's place, the precision below the configuration's
bfloat16 (upper readings); for a witness seed, the reference computed
with its products' operands in bfloat16 in the program's place (what the
configuration's own precision reads); for each fault named
(``perfbench/lib/faults.py``), the program with that fault planted (more
upper readings). One JSON line a seed. The benchmark's own runs do not
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import run as bench_run


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    bench_run.use_checkout()
    _, cell, config, mix = bench_run.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from perfbench.lib import faults
    controls = _seeds(args.control_seeds)
    witnesses = _seeds(args.witness_seeds)
    planted = [f for f in args.faults.split(",") if f]

    def run(seed, fault=None, want=None):
        with (faults.planted(fault) if fault else contextlib.nullcontext()):
            cell_run = bench_run.driver(mix)(config, mix, seed, "cuda")
            if want is not None:        # the training reference of this seed
                cell_run._want = want
            cell_run.setup()
            batches, _ = cell_run.window(
                0.0, min_batches=mix["check"].get("batches", 1))
        cell_run.free()
        return cell_run, batches

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        cell_run, batches = run(seed)
        line = {"workload": args.workload, "seed": seed,
                "program": cell_run.check(batches)}
        if seed in controls:
            line["control_fp8"] = cell_run.check(batches, against="fp8")
        if seed in witnesses:
            line["witness_bf16"] = cell_run.check(batches, against="bf16")
        want = getattr(cell_run, "_want", None)
        del cell_run, batches
        torch.cuda.empty_cache()
        for fault in planted:
            cell_run, batches = run(seed, fault, want)
            line[f"fault_{fault}"] = cell_run.check(batches)
            del cell_run, batches
            torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

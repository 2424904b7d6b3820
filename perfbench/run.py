"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (no PYTHONPATH needed). ``BENCHMARK.json``
names the cell's configuration and traffic mix; the harness finds
``perfbench/configs/<config>.json``, ``perfbench/traffic/<mix>.json``,
``perfbench/metrics/<metric>.py`` and ``perfbench/limits/<cell>.json``
by those names, and the driver the mix's ``kind`` names.

Set-up draws the weights on the card from ``--seed`` and warms the
cell's shapes; ``setup_s`` runs from the start of this process to the
first timed request. The window then runs the traffic for ``--seconds``
(with ``--trace 1`` under ``torch.profiler``). The program's counters
(``repro_torch.obs.metrics.REGISTRY``) are read just before the window
and just after it, outside its timing; the record the metric readers
take (:class:`Record`) holds each counter series' increase over the
window (``counters``). After the window, the device's
peak is read, the program's caches are freed and the plain reference
checks a sample of the served requests (``correct``). The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Kernel builds and compile caches go to ``perfbench/.cache/``.

Exits non-zero with no result without a CUDA device (or with fewer than
the cell asks for), without the program (``src/repro_torch``), or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def use_checkout() -> None:
    """The program from the checkout's ``src``; every kernel build and
    compile cache in fixed directories under ``perfbench/.cache``."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, mix) of ``workload``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    from perfbench.lib import traffic
    return bench, cell, config, traffic.load(cell["traffic"])


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    """What the metric readers read: one run's window."""
    model: dict
    mix: dict
    setup_s: float
    window_s: float
    batches: list
    trace: object                       # lib.trace.Trace or None
    peak_window_bytes: int
    # (name, sorted label pairs) → the counter series' increase over the
    # window, for every counter the program registers
    counters: dict = dataclasses.field(default_factory=dict)


def _counters() -> dict:
    """(name, sorted label pairs) → the value of each counter series the
    program's registry holds now."""
    from repro_torch.obs.metrics import REGISTRY
    return {(name, tuple(sorted(s["labels"].items()))): s["value"]
            for name, fam in REGISTRY.snapshot().items()
            if fam["kind"] == "counter" for s in fam["series"]}


def limits_of(workload: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload}.json").read_text())


def driver(mix: dict):
    """The class that runs a mix of its ``kind``."""
    from perfbench.lib import serve, train
    return {"serve": serve.Serve, "train": train.Train}[mix["kind"]]


def _peak(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def run_cell(bench: dict, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda"):
    """Set up, run the window, read the metrics and check: (result,
    None), or (None, what the run loaded of JAX or the JAX package)."""
    import torch

    from perfbench.lib import trace as tr
    run = driver(mix)(config, mix, seed, device)
    run.setup()
    setup_s = time.perf_counter() - T0
    setup_peak = _peak(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out: dict = {}
    before = _counters()
    with tr.traced(trace, out):
        batches, window_s = run.window(seconds)
    # a series first registered in the window started from 0
    counters = {k: v - before.get(k, 0) for k, v in _counters().items()}
    peak_window = _peak(device)
    bad = forbidden_modules()
    if bad:
        return None, bad

    record = Record(config["model"], mix, setup_s, window_s, batches,
                    out.get("trace"), peak_window, counters)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    run.free()
    numbers = run.check(batches)
    limits = limits_of(cell["name"])
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else device),
                   "count": cell["chips"],
                   "memory_peak_bytes": max(setup_peak, peak_window)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": sum(b.rows for b in batches), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and record.trace is not None:
        device_info["busy_s"] = record.trace.busy_s
        device_info["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = checks
    bad = forbidden_modules()
    return (None, bad) if bad else (result, None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout()
    bench, cell, config, mix = load_cell(args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result, bad = run_cell(bench, cell, config, mix, args.seed, args.seconds,
                           bool(args.trace))
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

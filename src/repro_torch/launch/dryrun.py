"""Multi-pod dry run: count one rank's step of every (arch × shape × mesh)
cell (``src/repro/launch/dryrun.py``).

Per cell: ``api.lower_cell`` on a ``DryMesh`` of the production shape, as
rank 0 sees it (groups that move nothing, so no world of 256 or 512
processes is needed) → one walk of the step on meta tensors
(``roofline.analysis.count_step``: FlopCounterMode FLOPs, each aten op's
bytes, the transport's collectives, the walk's peak memory) → roofline
terms against the H100 → a JSON report in ``--outdir``. The walk is the
port's eager step, every layer of it, so no per-layer extrapolation is
needed; :func:`extrapolated_costs` (the reference's fit from two
probes) equals the direct count.

The memory term is bytes / peak unless ``--hierarchy`` names a memhier
preset: the reference defaults to its TPU preset, but the port's
``h100`` preset charges an assumed 1 µs a 16 KiB tile and overestimates
measured batches 30–40× (PERF.md §7), so it would not give a lower
bound until it is fitted.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # every valid cell
  python -m repro_torch.launch.dryrun --all --multi-pod     # 2×16×16 pass
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback


def _costs(cfg, shape, mesh, grad_accum: int) -> tuple:
    from repro_torch.launch import api
    from repro_torch.roofline.analysis import collective_bytes_of, count_step
    fn, args, _, _, _ = api.lower_cell(cfg, shape, mesh,
                                       grad_accum=grad_accum)
    c = count_step(fn, args)
    return (c["flops"], c["hbm_bytes"],
            collective_bytes_of(c["collectives"])["total"])


def extrapolated_costs(cfg, shape, mesh, grad_accum: int):
    """The reference's fit cost(L) = outside + L · body from probes of
    L = 2 and L = 4 layers, for (flops, HBM bytes, collective bytes).
    The reference needs it because XLA counts a scanned layer once; the
    port's eager walk counts every layer, so the fit equals the direct
    count. Returns (totals, outside, per-layer body), all per chip."""
    vals = {}
    for L in (2, 4):
        probe = dataclasses.replace(cfg, n_layers=L)
        vals[L] = _costs(probe, shape, mesh, grad_accum)
    L = cfg.n_layers
    total, outside_v, body_v = [], [], []
    for i in range(3):
        body = max((vals[4][i] - vals[2][i]) / 2.0, 0.0)
        outside = max(vals[2][i] - 2.0 * body, 0.0)
        total.append(outside + L * body)
        outside_v.append(outside)
        body_v.append(body)
    return tuple(total), tuple(outside_v), tuple(body_v)


def _resolve_hierarchy(hierarchy):
    """None/"flat" → the flat bytes/peak term; a preset name or a
    repro_torch.memhier Hierarchy → the trace-driven burst-aware term."""
    if hierarchy in (None, "flat"):
        return None
    if isinstance(hierarchy, str):
        from repro_torch.memhier import PRESETS
        return PRESETS[hierarchy]
    return hierarchy


def model_flops(cfg, shape) -> float:
    """6·N·D for a train step, 2·N·D for prefill, 2·N a token for
    decode (N active params)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return float(6 * n_active * shape.tokens)
    if shape.kind == "prefill":
        return float(2 * n_active * shape.tokens)
    return float(2 * n_active * shape.global_batch)


def count_cell(cfg, shape, mesh, grad_accum: int = 0,
               hierarchy: str | None = "flat", arch: str | None = None):
    """The :class:`~repro_torch.roofline.analysis.CellReport` of one
    rank's step of (cfg × shape) on ``mesh`` (a ``DryMesh``)."""
    from repro_torch.launch import api
    from repro_torch.launch.mesh import mesh_name
    from repro_torch.roofline.analysis import analyze_step, count_step
    fn, args, _, _, _ = api.lower_cell(cfg, shape, mesh,
                                       grad_accum=grad_accum)
    counts = count_step(fn, args)
    return analyze_step(counts, arch=arch or cfg.name, shape=shape.name,
                        mesh_name=mesh_name(mesh), n_chips=mesh.size,
                        model_flops=model_flops(cfg, shape),
                        hierarchy=_resolve_hierarchy(hierarchy))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: str = "experiments/dryrun", grad_accum: int = 0,
             overrides: dict | None = None, verbose: bool = True,
             hierarchy: str | None = "flat"):
    from repro_torch.configs import SHAPES, cell_applicable, get_config
    from repro_torch.launch.mesh import DryMesh, production_shape

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch} × {shape_name}: {why}")
        return None

    mesh = DryMesh(*production_shape(multi_pod))
    t0 = time.time()
    rep = count_cell(cfg, shape, mesh, grad_accum, hierarchy, arch=arch)
    t1 = time.time()
    if verbose:
        m = rep.memory
        t = rep.terms
        print(f"{arch:18s} {shape_name:12s} mesh={rep.mesh:9s} "
              f"walk={t1-t0:5.1f}s | "
              f"peak={m['peak_gib']:7.2f} GiB fits={m['fits']} | "
              f"comp={t['compute_s']*1e3:8.2f}ms mem={t['memory_s']*1e3:8.2f}ms "
              f"coll={t['collective_s']*1e3:8.2f}ms dom={t['dominant']:12s} "
              f"useful={rep.useful_ratio:5.2f}")

    os.makedirs(outdir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{rep.mesh}"
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        f.write(rep.to_json())
    return rep


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--grad-accum", type=int, default=0)
    p.add_argument("--outdir", default="experiments/dryrun")
    p.add_argument("--hierarchy", default="flat",
                   help="memhier preset for the roofline memory term "
                        "(e.g. 'h100'); 'flat' = bytes / peak")
    p.add_argument("--set", action="append", default=[],
                   help="config override key=value (e.g. attn_impl=chunked)")
    args = p.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    from repro_torch.configs import ARCHS, SHAPES
    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, args.multi_pod, args.outdir,
                     grad_accum=args.grad_accum, overrides=overrides,
                     hierarchy=args.hierarchy)
        except Exception as e:  # noqa: BLE001 — report all cell failures
            failures.append((a, s, repr(e)))
            print(f"FAIL {a} × {s}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for a, s, e in failures:
            print(f"  {a} × {s}: {e}")
        sys.exit(1)
    print("\nall cells counted OK")


if __name__ == "__main__":
    main()

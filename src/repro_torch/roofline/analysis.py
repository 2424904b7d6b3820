"""Three-term roofline of one rank's step (``src/repro/roofline/analysis.py``).

    compute    = FLOPs_per_chip       / peak FLOP/s
    memory     = HBM_bytes_per_chip   / HBM bandwidth
    collective = coll_bytes_per_chip  / link bandwidth

The reference reads the three counts from XLA's compiled artifact. The
port has no compiled artifact: :func:`count_step` runs one rank's step
on meta tensors (``launch.api.lower_cell``) and counts what the port's
eager ops and its transport would do:

* **FLOPs** with ``torch.utils.flop_counter.FlopCounterMode``, which
  counts matrix products, convolutions and attention only (the ops it
  has formulas for). Elementwise work, reductions and the kernels' torch
  oracles (K3, K4 and K7 run as their oracles on meta tensors) count 0.
* **HBM bytes** with a ``TorchDispatchMode`` that sums each aten op's
  input and output bytes, leaving out views and bare allocations: what
  the port's eager ops move one by one, not a fused estimate.
* **Collective bytes** from the port's transport
  (``distributed.collectives.recording``): every collective it issues,
  by kind, with the reference's ring-volume factor for its kind and
  group size (:func:`collective_bytes_of`), in the layout of the
  reference's :func:`collective_bytes`.
* **Memory**: argument and output bytes from the shards' shapes;
  ``temp`` the peak of the storages the walk allocated that were alive
  at once (outputs included), so the predicted peak is argument +
  temp.

The pure functions (:func:`roofline_terms`, :func:`fusion_report`,
:func:`program_fusion_report`, :func:`plan_report`,
:func:`collective_bytes`, :func:`hierarchy_memory_term`,
:func:`dispatch_cache_report`) are the reference's, with
:data:`HW_H100` as their default hardware.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM (per chip), from NVIDIA's H100 data sheet: dense bf16
# tensor-core peak, HBM3 bandwidth, NVLink 4 (900 GB/s total, 450 each
# way), one 400 Gb/s NDR InfiniBand port a GPU across hosts (DGX H100),
# 80 GB of HBM3.
HW_H100 = {
    "flops_bf16": 989e12,        # peak bf16 FLOP/s (dense)
    "hbm_bw": 3.35e12,           # HBM bytes/s
    "ici_bw": 450e9,             # NVLink bytes/s, one direction
    "dcn_bw": 50e9,              # across hosts (pod axis) bytes/s
    "hbm_gib": 80e9 / 2**30,
}

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?P<type>\([^)]*\)|\S+?\[[^\]]*\]\S*)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


def _volume_factor(op: str, n: int) -> float:
    """Per-chip bytes moved per result byte (ring algorithms)."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)          # operand = n × result
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0                        # collective-permute


def _tally(ops) -> dict:
    """(kind, result bytes, group size) triples → per-kind traffic."""
    out: dict[str, float] = {}
    count: dict[str, int] = {}
    for op, b, n in ops:
        out[op] = out.get(op, 0.0) + b * _volume_factor(op, n)
        count[op] = count.get(op, 0) + 1
    out["total"] = sum(v for k, v in out.items())
    out["counts"] = count
    return out


def collective_bytes(hlo_text: str) -> dict:
    """Per-chip collective traffic by op kind, from optimized HLO text."""
    ops = []
    for line in hlo_text.splitlines():
        if "-done" in line:
            continue
        m = _COLL_RE.search(line)
        if not m:
            continue
        ops.append((m.group("op"), _shape_bytes(m.group("type")),
                    _group_size(line)))
    return _tally(ops)


def collective_bytes_of(log) -> dict:
    """Per-chip collective traffic by kind from a
    ``distributed.collectives.recording`` log, in the layout of
    :func:`collective_bytes`."""
    return _tally(log)


def hierarchy_memory_term(hbm_bytes: float, hierarchy,
                          block_bytes: Optional[int] = None) -> float:
    """Memory seconds for ``hbm_bytes`` of streaming traffic, predicted by
    the :mod:`repro_torch.memhier` simulator instead of the flat
    ``bytes/peak`` law: the DRAM burst overhead at the hierarchy's (or
    the given) block size and any slower intermediate level are both
    charged, so small blocks cost more than peak-bandwidth accounting
    admits."""
    from repro_torch.memhier.predict import stream_bandwidth
    n = int(math.ceil(hbm_bytes))
    if n <= 0:
        return 0.0
    pred = stream_bandwidth(hierarchy, n, block_bytes=block_bytes)
    return pred.time_s


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   hw: dict = HW_H100, slow_axis_bytes: float = 0.0,
                   hierarchy=None, hier_block_bytes: Optional[int] = None,
                   ) -> dict:
    """Three-term roofline. With ``hierarchy`` (a repro_torch.memhier
    Hierarchy), the memory term is the trace-driven prediction —
    burst-overhead- and level-aware — instead of ``bytes / peak_bw``."""
    t_compute = flops / hw["flops_bf16"]
    if hierarchy is not None:
        t_memory = hierarchy_memory_term(hbm_bytes, hierarchy,
                                         hier_block_bytes)
    else:
        t_memory = hbm_bytes / hw["hbm_bw"]
    t_coll = coll_bytes / hw["ici_bw"] + slow_axis_bytes / hw["dcn_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    terms.update(
        dominant=dom,
        step_time_lower_bound_s=bound,
        roofline_fraction=t_compute / bound if bound > 0 else 0.0,
    )
    return terms


def fusion_report(flops: float, fused_bytes: float, unfused_bytes: float,
                  hw: dict = HW_H100) -> dict:
    """Roofline terms for a fused instruction program vs its unfused chain.

    A fused N-stage program does N stages of flops per external byte moved
    (intermediates stay on chip), so its arithmetic intensity rises by
    ``unfused_bytes / fused_bytes`` while flops are unchanged. The
    returned ``speedup_bound`` is the ratio of roofline step-time lower
    bounds (≥ 1 when memory-bound, → 1 as the chain becomes
    compute-bound and fusion stops paying).
    """
    fused = roofline_terms(flops, fused_bytes, 0.0, hw)
    unfused = roofline_terms(flops, unfused_bytes, 0.0, hw)
    bound_f = fused["step_time_lower_bound_s"]
    bound_u = unfused["step_time_lower_bound_s"]
    return {
        "fused": fused,
        "unfused": unfused,
        "bytes_reduction": (unfused_bytes / fused_bytes
                            if fused_bytes else float("inf")),
        "intensity_fused": flops / fused_bytes if fused_bytes else float("inf"),
        "intensity_unfused": (flops / unfused_bytes
                              if unfused_bytes else float("inf")),
        "speedup_bound": bound_u / bound_f if bound_f else float("inf"),
    }


def program_fusion_report(program, n_elems: int, dtype,
                          hw: dict = HW_H100) -> dict:
    """fusion_report for a :class:`repro_torch.core.program.Program`."""
    return fusion_report(program.flops(n_elems),
                         program.hbm_bytes_fused(n_elems, dtype),
                         program.hbm_bytes_unfused(n_elems, dtype), hw)


def plan_report(plan, n_elems: int, dtype, hw: dict = HW_H100,
                hierarchy=None) -> dict:
    """fusion_report for a partitioned :class:`repro_torch.graph.plan.Plan`.

    ``fused`` is the plan's modeled HBM traffic (each part moves only its
    external operands), ``unfused`` the all-singleton counterfactual of
    the same graph. On top of the roofline terms it reports the plan's
    shape (parts, fused nodes, buffer-slot reuse) and — when a
    :mod:`repro_torch.memhier` Hierarchy is given or was used to build
    the plan — the simulator-predicted seconds of both executions.
    """
    g = plan.graph
    fused_bytes = plan.modeled_hbm_bytes(n_elems, dtype)
    unfused_bytes = g.hbm_bytes_unfused(n_elems, dtype)
    rep = fusion_report(g.flops(n_elems), fused_bytes, unfused_bytes, hw)
    rep.update(
        n_nodes=len(g.nodes),
        n_parts=plan.n_parts,
        n_fused_nodes=plan.n_fused_nodes,
        chains=[list(c) for c in plan.chains()],
        n_buffer_slots=plan.n_slots,
        n_buffer_values=plan.n_values,
    )
    hier = hierarchy if hierarchy is not None else plan.hierarchy
    if hier is not None:
        from repro_torch.graph.partition import partition
        t_plan = plan.predicted_time(hier, n_elems, dtype)
        t_unf = partition(g, model=hier, n_elems=n_elems, dtype=dtype,
                          method="singletons").predicted_time()
        rep.update(predicted_s=t_plan, predicted_unfused_s=t_unf,
                   predicted_speedup=t_unf / t_plan if t_plan else float("inf"))
    return rep


def dispatch_cache_report() -> dict:
    """``DISPATCH_STATS`` as a JSON-able dict plus derived hit rates:
    every counter of :data:`repro_torch.core.program.DISPATCH_STATS`
    verbatim, plus ``geometry_hit_rate`` (negotiations served from the
    in-process memo or a verified disk artifact) and ``disk_hit_rate``
    (disk consults that loaded a verified artifact)."""
    from repro_torch.core import program as prog_mod
    s = prog_mod.DISPATCH_STATS.snapshot()
    rep = dataclasses.asdict(s)
    n_geo = s.geometry_hits + s.geometry_misses
    rep["geometry_hit_rate"] = s.geometry_hits / n_geo if n_geo else 0.0
    n_disk = s.disk_hit + s.disk_miss + s.disk_invalidated + s.disk_corrupt
    rep["disk_hit_rate"] = s.disk_hit / n_disk if n_disk else 0.0
    return rep


# ---------------------------------------------------------------------------
# counting one rank's step
# ---------------------------------------------------------------------------

def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_aten = torch.ops.aten
#: ops that allocate or relabel without moving data
_NO_TRAFFIC = frozenset((
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default))


class _StepCounter(TorchDispatchMode):
    """HBM bytes of every aten op (inputs read once, outputs written once;
    views and allocations left out) and the peak bytes of the storages
    the walk allocated that were alive at once."""

    def __init__(self, args):
        super().__init__()
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._known: set[int] = {id(t.untyped_storage())
                                 for t in tree_leaves(args)
                                 if isinstance(t, torch.Tensor)}

    def _freed(self, key: int, nbytes: int) -> None:
        self._known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.hbm_bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                               + _tensor_bytes(out))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, st.nbytes())
        return out


def count_step(fn, args) -> dict:
    """Run ``fn(*args)`` once (one rank's step, on meta tensors) and
    count it: ``flops`` (FlopCounterMode), ``hbm_bytes`` (each aten op's
    inputs and outputs, views left out), ``collectives`` (the transport's
    log), ``argument_bytes``, ``output_bytes`` and ``temp_bytes`` (the
    peak of the walk's own storages alive at once)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import collectives as C
    counter = _StepCounter(args)
    with C.recording() as log, FlopCounterMode(display=False) as flops:
        with counter:
            out = fn(*args)
    result = {"flops": float(flops.get_total_flops()),
              "hbm_bytes": float(counter.hbm_bytes),
              "collectives": list(log),
              "argument_bytes": _tensor_bytes(args),
              "output_bytes": _tensor_bytes(out),
              "temp_bytes": counter.peak}
    del out
    return result


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    memory: dict
    terms: dict
    model_flops: float              # 6·N·D (global)
    useful_ratio: float             # MODEL_FLOPS / (counted flops × chips)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)


def analyze_step(counts: dict, *, arch: str, shape: str, mesh_name: str,
                 n_chips: int, model_flops: float, hw: dict = HW_H100,
                 hierarchy=None) -> CellReport:
    """The :class:`CellReport` of :func:`count_step`'s counts (the
    counterpart of the reference's ``analyze_compiled``): ``memory`` in
    GiB, ``fits`` against ``hw["hbm_gib"]``."""
    coll = collective_bytes_of(counts["collectives"])
    gib = 2**30
    peak = counts["argument_bytes"] + counts["temp_bytes"]
    mem = {"argument_gib": counts["argument_bytes"] / gib,
           "output_gib": counts["output_bytes"] / gib,
           "temp_gib": counts["temp_bytes"] / gib,
           "alias_gib": 0.0,
           "peak_gib": peak / gib,
           "fits": peak / gib <= hw["hbm_gib"]}
    flops, hbm = counts["flops"], counts["hbm_bytes"]
    terms = roofline_terms(flops, hbm, coll["total"], hw,
                           hierarchy=hierarchy)
    useful = model_flops / (flops * n_chips) if flops else 0.0
    return CellReport(arch=arch, shape=shape, mesh=mesh_name,
                      n_chips=n_chips, flops_per_chip=flops,
                      hbm_bytes_per_chip=hbm,
                      coll_bytes_per_chip=coll["total"],
                      coll_breakdown=coll, memory=mem, terms=terms,
                      model_flops=model_flops, useful_ratio=useful)

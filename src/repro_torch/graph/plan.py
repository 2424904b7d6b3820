"""Executable partition plans: ordered fused programs + buffer reuse.

A :class:`Plan` is what :func:`repro_torch.graph.partition.partition` returns:
the graph's nodes covered by :class:`Part`\\ s (each a fused
:class:`~repro_torch.core.program.Program` or a direct-dispatch singleton),
topologically ordered, with a level-scan buffer-slot assignment for the
materialised inter-program values (graph inputs and part outputs): a
value's slot is recycled once the dependency level holding its last
consuming part has completed, so the peak number of live inter-program
buffers — ``n_slots`` — is what an allocator must provision for the
overlapped schedule, not one buffer per value. Execution mirrors the
assignment by dropping dead values from the environment, letting the
runtime reuse their storage.

Dispatch honours the registry modes (DESIGN.md §1): ``ref`` runs the
graph node-by-node through the registered oracles — the end-to-end
correctness oracle every emitted Plan is validated against; ``kernel`` /
``interpret`` run the parts' single-launch programs (K1 on the card, its
plain PyTorch emulator for interpret); ``auto`` follows the operands:
``kernel`` for CUDA tensors, ``ref`` for CPU tensors.

Independent parts overlap (DESIGN.md §12): the parts form their own
DAG (an edge wherever one part consumes another's materialised output),
:meth:`Plan.schedule` levels it, ``__call__`` dispatches a whole level
before binding any of its outputs (data-dependency order only — no
false serialisation from the linear part order), and
:meth:`Plan.predicted_time` is the critical-path makespan over that DAG
— the software form of the paper's multiple reconfigurable regions
running concurrently — rather than the serial sum (still available via
``overlap=False``).

Parts are also *schedulable units* (DESIGN.md §13): :meth:`Plan.units`
exposes each part with its dependency edges and per-part byte/time/DRAM
estimates, and :meth:`Plan.dispatch_part` runs one part against a value
environment — what the :mod:`repro_torch.sched` runtime packs onto execution
lanes (with :func:`repro_torch.memhier.predict.contended_makespan` pricing
HBM-bandwidth sharing between concurrently scheduled parts, instead of
the free overlap ``predicted_time`` assumes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from repro_torch.core.stream import _bits
from repro_torch.obs import trace as _trace

from .ir import Graph, Node, Scalar, Value


@dataclasses.dataclass
class Part:
    """One partition element: a chain of graph nodes run as one program.

    ``program`` is the fused (or single-stage) Program for
    template-backed chains; ``None`` means a non-template singleton that
    dispatches through the registry like any standalone instruction.
    ``spec`` is the merged P'-type operand spec (the instruction's own
    spec for singletons).
    """

    node_ids: tuple[int, ...]
    nodes: tuple[Node, ...]
    instrs: tuple[Any, ...]
    program: Optional[Any]
    spec: Any

    @property
    def name(self) -> str:
        return "+".join(nd.name for nd in self.nodes)

    @property
    def last(self) -> Node:
        return self.nodes[-1]

    def external_vec_values(self) -> list[Value]:
        """The vector Values this part reads from outside itself, in
        program operand order (per node: non-chained vector inputs)."""
        ext: list[Value] = []
        for i, node in enumerate(self.nodes):
            k = self.nodes[i - 1].n_vec_out if i else 0
            ext.extend(node.vec_in[k:])
        return ext

    def hbm_bytes(self, n_elems: int, dtype) -> int:
        """Modeled HBM traffic of this part: externals + outputs only for
        fused programs, all operands for direct-dispatch singletons."""
        if self.program is not None:
            return self.program.hbm_bytes_fused(n_elems, dtype)
        per = self.spec.vector_in + self.spec.vector_out
        return per * n_elems * _bits(dtype) // 8

    def pipeline_depth(self) -> int:
        if self.program is not None:
            return self.program.pipeline_depth()
        return self.instrs[0].pipeline_depth


@dataclasses.dataclass(frozen=True)
class PartUnit:
    """One schedulable unit of a Plan: a part, its dependency edges and
    its per-part cost estimates — what :mod:`repro_torch.sched` packs onto
    execution lanes (DESIGN.md §13).

    ``deps`` are indices into ``plan.parts`` (identical to
    :meth:`Plan.part_deps`); ``predicted_s``/``dram_busy_s`` are ``None``
    when no Hierarchy was available to simulate the part.
    ``dram_busy_by_channel`` splits the busy seconds per HBM channel
    when the hierarchy models more than one (DESIGN.md §18); ``None``
    on single-channel hierarchies, where ``dram_busy_s`` is the whole
    story."""

    index: int
    name: str
    node_ids: tuple[int, ...]
    deps: frozenset
    hbm_bytes: int
    predicted_s: Optional[float] = None
    dram_busy_s: Optional[float] = None
    dram_busy_by_channel: Optional[tuple[float, ...]] = None


@dataclasses.dataclass
class Plan:
    """Topologically ordered parts + the buffer-slot assignment."""

    graph: Graph
    parts: tuple[Part, ...]
    slot_of: dict[Value, int]
    n_slots: int
    n_values: int
    cost: float                      # under the partitioner's cost model
    n_elems: int                     # representative size cost was taken at
    dtype: Any
    hierarchy: Optional[Any] = None  # memhier Hierarchy when one scored it
    method: str = "beam"

    # -- bookkeeping ---------------------------------------------------------
    @property
    def n_parts(self) -> int:
        return len(self.parts)

    @property
    def n_fused_nodes(self) -> int:
        return sum(len(p.nodes) for p in self.parts if len(p.nodes) > 1)

    def chains(self) -> list[tuple[int, ...]]:
        return [p.node_ids for p in self.parts]

    def modeled_hbm_bytes(self, n_elems: Optional[int] = None,
                          dtype=None) -> int:
        n = n_elems if n_elems is not None else self.n_elems
        dt = dtype if dtype is not None else self.dtype
        return sum(p.hbm_bytes(n, dt) for p in self.parts)

    def part_deps(self) -> tuple[frozenset, ...]:
        """Per part, the indices of parts whose outputs it consumes.

        Graph inputs contribute no edge; scalars never do. Parts are
        topologically ordered at construction, so ``deps[i] ⊆ {0..i-1}``.
        """
        return _part_deps(self.graph, self.parts)

    def schedule(self) -> tuple[tuple[int, ...], ...]:
        """Dependency levels of the part DAG: every part in a level
        depends only on strictly earlier levels, so a level's parts are
        mutually independent and dispatch together in ``__call__``."""
        return _part_levels(self.graph, self.parts)

    def predicted_time(self, hierarchy=None, n_elems: Optional[int] = None,
                       dtype=None, overlap: bool = True) -> float:
        """memhier-predicted seconds of the whole plan.

        With ``overlap=True`` (default) this is the critical-path
        makespan over the part DAG: independent parts — separate
        reconfigurable regions with no data edge — run concurrently, so
        only the longest dependency chain counts (never less than the
        slowest chain, strictly less than the serial sum whenever any
        two parts are independent). ``overlap=False`` restores the
        serial sum — parts strictly one after another.
        """
        from .partition import part_cost
        hier = hierarchy if hierarchy is not None else self.hierarchy
        if hier is None:
            raise ValueError("predicted_time needs a Hierarchy (none was "
                             "used to build this plan)")
        n = n_elems if n_elems is not None else self.n_elems
        dt = dtype if dtype is not None else self.dtype
        costs = [part_cost(p, n, dt, hier) for p in self.parts]
        if not overlap:
            return sum(costs)
        deps = self.part_deps()
        finish: list[float] = []
        for i, c in enumerate(costs):
            start = max((finish[j] for j in deps[i]), default=0.0)
            finish.append(start + c)
        return max(finish, default=0.0)

    def units(self, hierarchy=None, n_elems: Optional[int] = None,
              dtype=None) -> tuple[PartUnit, ...]:
        """The parts as schedulable units with per-part estimates.

        With a Hierarchy (argument, or the one the plan was built with)
        each unit carries the memhier-predicted solo seconds and the
        full-workload DRAM busy seconds — the inputs to the scheduler's
        bandwidth-sharing contention term. Without one, only the
        analytic byte counts are filled in.
        """
        from .partition import part_prediction
        hier = hierarchy if hierarchy is not None else self.hierarchy
        n = n_elems if n_elems is not None else self.n_elems
        dt = dtype if dtype is not None else self.dtype
        deps = self.part_deps()
        units = []
        for i, p in enumerate(self.parts):
            pred_s = busy_s = by_ch = None
            if hier is not None:
                pred = part_prediction(p, n, dt, hier)
                pred_s, busy_s = pred.time_s, pred.dram_busy_s
                if pred.dram_channels:
                    by_ch = pred.dram_busy_by_channel
            units.append(PartUnit(index=i, name=p.name,
                                  node_ids=p.node_ids, deps=deps[i],
                                  hbm_bytes=p.hbm_bytes(n, dt),
                                  predicted_s=pred_s, dram_busy_s=busy_s,
                                  dram_busy_by_channel=by_ch))
        return tuple(units)

    def describe(self) -> str:
        lines = [f"Plan({self.graph.name}, method={self.method}): "
                 f"{len(self.parts)} parts / {len(self.graph.nodes)} nodes, "
                 f"{self.n_slots} buffer slots for {self.n_values} values"]
        for p in self.parts:
            kind = "fused" if len(p.nodes) > 1 else (
                "single" if p.program is not None else "dispatch")
            lines.append(f"  [{kind}] {p.name}  nodes={list(p.node_ids)}")
        return "\n".join(lines)

    # -- execution -----------------------------------------------------------
    def _bind(self, operands):
        free = self.graph.free_inputs()
        if len(operands) != len(free):
            names = [n for n, _ in free]
            raise TypeError(
                f"{self.graph.name}: plan expects {len(free)} operands "
                f"{names}, got {len(operands)}")
        env: dict[Value, Any] = {}
        scal: dict[Scalar, Any] = {}
        for (_, key), op in zip(free, operands):
            if isinstance(key, Value):
                env[key] = op
            else:
                scal[key] = op
        for s in self.graph.scalars:
            if s.bound is not None:
                scal[s] = s.bound
        return env, scal

    def _outputs(self, vals):
        outs = tuple(vals[v] for v in self.graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    # public aliases for external runtimes (repro_torch.sched drives parts
    # through these instead of Plan.__call__'s private loop):
    def bind_operands(self, operands):
        """Operand list → (vector env, scalar env) for part dispatch."""
        return self._bind(operands)

    def outputs_from(self, vals):
        """Graph outputs out of a value environment (post-execution)."""
        return self._outputs(vals)

    def dispatch_part(self, idx: int, vals, scal,
                      mode: Optional[str] = None):
        """Run ONE part against a value environment — the schedulable
        unit (DESIGN.md §13). Returns the part's raw output (tuple for
        multi-output parts); the caller binds it via
        :meth:`bind_part_outputs` once the whole level has been issued.
        """
        from repro_torch.core.isa import resolve_auto
        reg = self.graph.registry
        part = self.parts[idx]
        mode = resolve_auto(mode or reg.mode, _part_operands(part, vals))
        # "part" span (DESIGN.md §15): one per schedulable unit, so a
        # plan's dispatch tree shows each chain under its placement.
        with _trace.span("part", plan=self.graph.name, index=idx,
                         chain=[n.name for n in part.nodes]):
            if part.program is not None:
                ops: list[Any] = []
                for i, node in enumerate(part.nodes):
                    k = part.nodes[i - 1].n_vec_out if i else 0
                    ops.extend(scal[s] for s in node.scalar_in)
                    ops.extend(vals[v] for v in node.vec_in[k:])
                return part.program(*ops, interpret=(mode == "interpret"))
            node = part.nodes[0]
            ops = [vals[o] if isinstance(o, Value) else scal[o]
                   for o in node.operands]
            return reg.dispatch(node.name, *ops, mode=mode)

    def bind_part_outputs(self, idx: int, out, vals) -> None:
        """Bind one part's outputs into the value environment."""
        part = self.parts[idx]
        outs = out if isinstance(out, tuple) else (out,)
        for i, r in enumerate(outs):
            vals[Value(self.graph.gid, part.last.nid, i)] = r

    def ref(self, *operands):
        """The end-to-end oracle: run the DAG node-by-node through the
        registered ``ref`` implementations, ignoring the partitioning."""
        env, scal = self._bind(operands)
        vals = dict(env)
        for node in self.graph.nodes:
            ops = [vals[o] if isinstance(o, Value) else scal[o]
                   for o in node.operands]
            res = self.graph.registry.dispatch(node.name, *ops, mode="ref")
            outs = res if isinstance(res, tuple) else (res,)
            for i, r in enumerate(outs):
                vals[Value(self.graph.gid, node.nid, i)] = r
        return self._outputs(vals)

    def __call__(self, *operands, mode: Optional[str] = None):
        reg = self.graph.registry
        mode = mode or reg.mode
        if mode not in reg.MODES:
            raise ValueError(f"mode must be one of {reg.MODES}")
        from repro_torch.core.isa import resolve_auto
        mode = resolve_auto(mode, operands)
        if mode == "ref":
            return self.ref(*operands)
        env, scal = self._bind(operands)
        vals = dict(env)
        levels = self.schedule()
        dies = _death_schedule(self.graph, self.parts, levels)
        # dispatch level by level: a level's parts have no data edges
        # between them, so they issue back to back with no value of one
        # feeding another — the async runtime (and real multi-region
        # hardware) is free to overlap them. Outputs bind only after the
        # whole level has been issued, making the independence structural.
        for li, level in enumerate(levels):
            issued: list[tuple[int, Any]] = []
            for idx in level:
                issued.append((idx, self.dispatch_part(idx, vals, scal,
                                                       mode=mode)))
            for idx, out in issued:
                self.bind_part_outputs(idx, out, vals)
            # buffer reuse: drop values whose last consuming level has
            # run so their storage is reclaimable (mirrors the slot
            # assignment's intent under the overlapped schedule).
            for v in dies.get(li, ()):
                vals.pop(v, None)
        return self._outputs(vals)


def _part_operands(part: Part, vals) -> list:
    """The vector operands one part reads, for the ``auto`` rule."""
    return [vals[v] for v in part.external_vec_values()]


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

def _part_deps(graph: Graph,
               parts: Sequence[Part]) -> tuple[frozenset, ...]:
    """Per part, the indices of parts whose outputs it consumes."""
    producer: dict[Value, int] = {}
    for idx, part in enumerate(parts):
        for i in range(part.last.n_vec_out):
            producer[Value(graph.gid, part.last.nid, i)] = idx
    deps = []
    for part in parts:
        deps.append(frozenset(
            producer[v] for v in part.external_vec_values()
            if v in producer))
    return tuple(deps)


def _part_levels(graph: Graph,
                 parts: Sequence[Part]) -> tuple[tuple[int, ...], ...]:
    """Dependency levels of the part DAG (parts are topo-ordered, so
    each part's dependencies precede it)."""
    deps = _part_deps(graph, parts)
    depth: list[int] = []
    for i in range(len(parts)):
        depth.append(1 + max((depth[j] for j in deps[i]), default=-1))
    levels: dict[int, list[int]] = {}
    for i, d in enumerate(depth):
        levels.setdefault(d, []).append(i)
    return tuple(tuple(levels[d]) for d in sorted(levels))


def _death_schedule(graph: Graph, parts: Sequence[Part],
                    levels: Sequence[Sequence[int]]) -> dict[int, list[Value]]:
    """Level index → materialised values whose last consuming LEVEL it is
    (graph outputs never die). Keyed by level, not linear part index:
    under the overlapped schedule a whole level is in flight at once, so
    a value stays live until the last level consuming it completes."""
    level_of = {idx: li for li, lv in enumerate(levels) for idx in lv}
    last_level: dict[Value, int] = {}
    for idx, part in enumerate(parts):
        for v in part.external_vec_values():
            last_level[v] = max(last_level.get(v, -1), level_of[idx])
    alive = set(graph.outputs)
    schedule: dict[int, list[Value]] = {}
    for v, li in last_level.items():
        if v not in alive:
            schedule.setdefault(li, []).append(v)
    return schedule


def _assign_slots(graph: Graph, parts: Sequence[Part]):
    """Level-scan slot allocation over the materialised values.

    Mirrors the overlapped execution schedule: inputs are live from the
    start; each level's part outputs allocate together; a slot frees
    only once the level holding its value's last consumer has completed
    (graph outputs never free) — so ``n_slots`` is what an allocator
    must provision for the *concurrent* schedule, never fewer. On
    serial chains (one part per level) this reduces to the linear scan.
    Returns (slot_of, n_slots, n_values).
    """
    levels = _part_levels(graph, parts)
    dies = _death_schedule(graph, parts, levels)
    slot_of: dict[Value, int] = {}
    free: list[int] = []
    n_slots = 0

    def alloc(v: Value) -> None:
        nonlocal n_slots
        if free:
            slot_of[v] = free.pop()
        else:
            slot_of[v] = n_slots
            n_slots += 1

    for v in graph.inputs:
        alloc(v)
    for li, level in enumerate(levels):
        for idx in level:
            part = parts[idx]
            for i in range(part.last.n_vec_out):
                alloc(Value(graph.gid, part.last.nid, i))
        for v in dies.get(li, ()):
            free.append(slot_of[v])
    return slot_of, n_slots, len(slot_of)


def build_plan(graph: Graph, parts: Sequence[Part], *, cost: float,
               n_elems: int, dtype, hierarchy=None,
               method: str = "beam") -> Plan:
    """Order parts topologically (chains ascend in node id, and every
    cross-part value is produced by a part's LAST node, so sorting by
    last node id is a valid schedule), then assign buffer slots."""
    ordered = tuple(sorted(parts, key=lambda p: p.node_ids[-1]))
    slot_of, n_slots, n_values = _assign_slots(graph, ordered)
    return Plan(graph=graph, parts=ordered, slot_of=slot_of,
                n_slots=n_slots, n_values=n_values, cost=cost,
                n_elems=n_elems, dtype=dtype, hierarchy=hierarchy,
                method=method)


def plan_metadata(plan: Plan) -> dict:
    """JSON-able schedule/slot summary of a Plan — the *verified
    metadata* block of a persistent plan artifact (DESIGN.md §14).

    Chains, dependency levels, the buffer-slot map and the slot counts
    are all deterministically derivable from (graph, chain split), so a
    loaded artifact's metadata must match what rebuilding from its
    chains produces bit-for-bit; any mismatch marks the entry stale and
    the partitioner re-searches (``repro_torch.graph.partition``). Values are
    encoded positionally (``["in", index]`` for graph inputs,
    ``["n", nid, index]`` for node outputs) so the encoding is stable
    across processes — ``gid`` never leaves the process.
    """
    def enc(v: Value) -> list:
        return (["in", v.index] if v.nid is None
                else ["n", v.nid, v.index])

    return {"chains": [[int(i) for i in c] for c in plan.chains()],
            "levels": [[int(i) for i in lv] for lv in plan.schedule()],
            "n_slots": int(plan.n_slots),
            "n_values": int(plan.n_values),
            "slots": sorted([enc(v), int(s)]
                            for v, s in plan.slot_of.items())}

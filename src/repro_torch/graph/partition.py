"""Partition an instruction DAG into fused reconfigurable-region programs.

A :class:`~repro_torch.graph.ir.Graph` is covered with **chains** — paths the
:class:`~repro_torch.core.program.Program` layer can run as ONE K1 launch
(DESIGN.md §5's chaining rule: a stage's vector outputs feed the next
stage's first vector inputs). A chain is legal iff

  * every instruction is template-backed (it has a composable Stage);
  * consecutive edges exist in the graph with the right slot positions;
  * every internal value has exactly one consumer and is not a graph
    output (a fanned-out value must materialise — it cannot be elided
    into registers);
  * the merged external operand list fits the widened P'-type encoding
    budget (:data:`~repro_torch.core.isa.ITYPE_LIMITS`);
  * one common block geometry fits the shared-memory budget
    (:meth:`Program.negotiate_geometry` succeeds);
  * the chained pipeline depth stays within ``max_depth`` when given.

:func:`repro_torch.core.isa.fuse_chain` (re-exported here) packages that
validation + Program construction; it is the primitive both
``Registry.fuse`` (the trivial linear case — one pre-decided chain,
errors propagate) and the partitioner (chains are *candidates*, errors
mean "split here") are built on.

Search: :func:`partition` runs a greedy baseline (extend the current
chain whenever legal) and a beam search over the per-node
extend-vs-cut decisions, scores partitions with the
:mod:`repro_torch.memhier` trace-driven simulator when a
:class:`~repro_torch.memhier.hierarchy.Hierarchy` is given (falling back to
the analytic ``hbm_bytes_fused`` byte count otherwise), and returns the
cheapest of {beam, greedy, all-singleton} — so the result is never worse
than the all-unfused plan under the chosen cost model.

Hot path (DESIGN.md §12): every simulated score routes through the
phase-structured fast engine (:mod:`repro_torch.memhier.fastsim`) via
:func:`~repro_torch.memhier.predict.predict_program`, and every candidate
chain's ``negotiate_geometry`` hits the shared module-level geometry
cache in :mod:`repro_torch.core.program` — so beam search re-pays neither the
per-access Python cache walk nor repeated candidate sweeps. The search
objective stays the *summed* part cost (a serial upper bound, monotone
under chain splits); the emitted :class:`Plan` additionally reports the
overlap-aware critical-path ``predicted_time``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import artifact as _artifact
from repro_torch.core.isa import fuse_chain  # noqa: F401 — re-exported API
from repro_torch.core.stream import SMEM_BYTES, _bits, dtype_name

from .ir import Graph, Node
from .plan import Part, Plan, build_plan, plan_metadata

# ---------------------------------------------------------------------------
# chain legality inside a graph
# ---------------------------------------------------------------------------

class _Partitioner:
    """Shared context for one partitioning run: graph, consumer map,
    memoised chain compilation and cost evaluation."""

    def __init__(self, graph: Graph, model=None, n_elems: int = 1 << 18,
                 dtype=None, max_depth: Optional[int] = None,
                 smem_budget: int = SMEM_BYTES):
        graph.validate()
        self.graph = graph
        if isinstance(model, str):        # memhier preset by name
            from repro_torch.memhier import PRESETS
            try:
                model = PRESETS[model]
            except KeyError:
                raise ValueError(
                    f"unknown hierarchy preset {model!r}; have "
                    f"{sorted(PRESETS)} (or pass a Hierarchy/BurstModel)"
                ) from None
        self.model = model
        self.hier = model if _is_hierarchy(model) else None
        self.n_elems = n_elems
        self.dtype = dtype if dtype is not None else torch.float32
        self.max_depth = max_depth
        self.smem_budget = smem_budget
        self.cons = graph.consumers()
        self._chains: dict[tuple[int, ...], Optional[Part]] = {}
        self._costs: dict[tuple[int, ...], float] = {}

    # -- chain compilation (memoised) ---------------------------------------
    def part_for(self, nids: tuple[int, ...]) -> Optional[Part]:
        """Compile a node-id chain to a Part, or None if illegal."""
        if nids in self._chains:
            return self._chains[nids]
        part = self._compile(nids)
        self._chains[nids] = part
        return part

    def _compile(self, nids: tuple[int, ...]) -> Optional[Part]:
        nodes = [self.graph.nodes[i] for i in nids]
        instrs = [self.graph.node_instr(nd) for nd in nodes]
        if len(nodes) == 1:
            # singletons are always representable: template-backed ones
            # get a single-stage Program; the rest — and template ones
            # whose Program cannot fit a geometry in the budget —
            # dispatch directly as standalone instructions.
            instr = instrs[0]
            prog = None
            if instr.template is not None:
                prog, _ = fuse_chain(instrs, model=self.model,
                                     smem_budget=self.smem_budget)
                try:
                    prog.negotiate_geometry(self.n_elems, self.dtype)
                except ValueError:
                    prog = None
            return Part(node_ids=nids, nodes=tuple(nodes),
                        instrs=tuple(instrs), program=prog, spec=instr.spec)
        # graph-side legality: consecutive chain edges + exclusive use
        for prev, nxt in zip(nodes, nodes[1:]):
            k = prev.n_vec_out
            if len(nxt.vec_in) < k:
                return None
            for j in range(k):
                v = nxt.vec_in[j]
                if v.nid != prev.nid or v.index != j:
                    return None               # not the chain edge
                if self.cons.get(v, []) != [(nxt.nid, j)]:
                    return None               # fan-out / graph output
        try:
            prog, spec = fuse_chain(instrs, model=self.model,
                                    smem_budget=self.smem_budget)
        except ValueError:
            return None                       # budget / composition
        if self.max_depth is not None and prog.pipeline_depth() > self.max_depth:
            return None
        try:                                  # one geometry must fit
            prog.negotiate_geometry(self.n_elems, self.dtype)
        except ValueError:
            return None
        return Part(node_ids=nids, nodes=tuple(nodes), instrs=tuple(instrs),
                    program=prog, spec=spec)

    # -- cost model ----------------------------------------------------------
    def cost(self, nids: tuple[int, ...]) -> float:
        """Modeled cost of one part: memhier-predicted seconds when a
        Hierarchy was given, analytic HBM bytes otherwise."""
        if nids in self._costs:
            return self._costs[nids]
        part = self.part_for(nids)
        assert part is not None, "cost() on an illegal chain"
        c = part_cost(part, self.n_elems, self.dtype, self.hier)
        self._costs[nids] = c
        return c

    def plan_cost(self, chains: Sequence[tuple[int, ...]]) -> float:
        return sum(self.cost(c) for c in chains)

    # -- searches ------------------------------------------------------------
    def extension_candidate(self, node: Node) -> Optional[int]:
        """The unique node id whose open chain this node could extend:
        the producer of its first vector input (chain edges are
        consecutive, so no other tail qualifies)."""
        if not node.vec_in or node.vec_in[0].nid is None:
            return None
        return node.vec_in[0].nid

    def greedy(self) -> list[tuple[int, ...]]:
        """Extend the open chain ending at each node's producer whenever
        the extended chain is legal; else start a singleton."""
        open_by_tail: dict[int, tuple[int, ...]] = {}
        closed: list[tuple[int, ...]] = []
        for node in self.graph.nodes:
            tail = self.extension_candidate(node)
            if tail is not None and tail in open_by_tail:
                ext = open_by_tail[tail] + (node.nid,)
                if self.part_for(ext) is not None:
                    del open_by_tail[tail]
                    open_by_tail[node.nid] = ext
                    continue
            open_by_tail[node.nid] = (node.nid,)
        closed.extend(open_by_tail.values())
        return sorted(closed, key=lambda c: c[-1])

    def beam(self, width: int = 8) -> list[tuple[int, ...]]:
        """Beam search over the per-node extend-vs-cut decisions.

        A state is the set of chains built so far (any chain whose tail
        is still the latest node of its path remains open). Scored by
        the summed part cost; ties keep fewer parts.
        """
        states: list[dict[int, tuple[int, ...]]] = [{}]   # tail nid → chain
        for node in self.graph.nodes:
            nxt: list[dict[int, tuple[int, ...]]] = []
            for st in states:
                # choice 1: start a singleton
                s1 = dict(st)
                s1[node.nid] = (node.nid,)
                nxt.append(s1)
                # choice 2: extend the producer's open chain, if legal
                tail = self.extension_candidate(node)
                if tail is not None and tail in st:
                    ext = st[tail] + (node.nid,)
                    if self.part_for(ext) is not None:
                        s2 = dict(st)
                        del s2[tail]
                        s2[node.nid] = ext
                        nxt.append(s2)
            # dedupe states (different decision orders can converge)
            uniq: dict[tuple, dict[int, tuple[int, ...]]] = {}
            for st in nxt:
                uniq[tuple(sorted(st.values()))] = st
            scored = sorted(
                uniq.values(),
                key=lambda st: (self.plan_cost(tuple(st.values())), len(st)))
            states = scored[:max(1, width)]
        best = states[0]
        return sorted(best.values(), key=lambda c: c[-1])

    def singletons(self) -> list[tuple[int, ...]]:
        return [(nd.nid,) for nd in self.graph.nodes]


def _is_hierarchy(model) -> bool:
    if model is None:
        return False
    from repro_torch.core.burst_model import BurstModel
    return not isinstance(model, BurstModel)


def part_prediction(part: Part, n_elems: int, dtype, hier):
    """Full memhier :class:`~repro_torch.memhier.predict.Prediction` for one
    part (program trace with fused intermediates elided; non-template
    singletons priced as a plain ``n_in``-read / ``n_out``-write
    stream). The scheduling runtime reads its DRAM busy time off this
    for the bandwidth-sharing contention term (DESIGN.md §13)."""
    from repro_torch.memhier.predict import predict_program, stream_bandwidth
    if part.program is not None:
        return predict_program(hier, part.program, n_elems, dtype)
    spec = part.spec
    return stream_bandwidth(hier, n_elems * _bits(dtype) // 8,
                            n_read=spec.vector_in,
                            n_write=spec.vector_out)


def part_cost(part: Part, n_elems: int, dtype, hier=None) -> float:
    """Cost of one part under the chosen model (lower is better).

    With a Hierarchy: memhier-predicted seconds of the part's trace
    (see :func:`part_prediction`). Without: the analytic HBM byte count
    — the ``hbm_bytes_fused`` fallback.
    """
    if hier is not None:
        return part_prediction(part, n_elems, dtype, hier).time_s
    return float(part.hbm_bytes(n_elems, dtype))


# ---------------------------------------------------------------------------
# persistent plan artifacts (core.artifact, DESIGN.md §14)
# ---------------------------------------------------------------------------

def _plan_disk_key(ctx: _Partitioner, method: str, beam_width: int):
    """(cache, key) for one search invocation, or (None, None) when the
    run cannot share disk entries: no cache configured, or the model has
    only a process-local token fingerprint."""
    cache = _artifact.plan_cache()
    if cache is None:
        return None, None
    from repro_torch.core.program import _model_fingerprint
    fp = (_model_fingerprint(ctx.model)
          if ctx.model is not None else None)
    if not _artifact.persistable_fingerprint(fp):
        return None, None
    key = ("plan", ctx.graph.structure_key(), int(ctx.n_elems),
           dtype_name(ctx.dtype), method,
           int(beam_width) if method == "beam" else 0,
           ctx.max_depth, ctx.smem_budget, fp)
    return cache, key


def _plan_payload(plan: Plan) -> dict:
    """What a "plan" disk entry stores: the chain split + the search's
    cost (the expensive memhier scoring) and the derived schedule/slot
    metadata (verified on load — see :func:`repro_torch.graph.plan.
    plan_metadata`)."""
    return {"chains": [[int(i) for i in c] for c in plan.chains()],
            "cost": float(plan.cost), "meta": plan_metadata(plan)}


def _plan_from_payload(ctx: _Partitioner, payload, method: str
                       ) -> Optional[Plan]:
    """Rebuild a Plan from a disk payload, re-validating everything that
    must hold for THIS graph: exact node coverage, every chain still a
    legal fused program (``part_for`` recompiles it — a deregistered
    instruction, shrunk budget or changed stage makes it None), and the
    rebuilt schedule/slot metadata matching the stored block
    bit-for-bit. Any failure returns None, which the cache layer counts
    as ``disk_invalidated`` and deletes — the caller re-searches and
    overwrites."""
    if not isinstance(payload, dict):
        return None
    try:
        chains = [tuple(int(i) for i in c) for c in payload["chains"]]
        cost = float(payload["cost"])
    except (KeyError, TypeError, ValueError):
        return None
    covered = sorted(i for c in chains for i in c)
    if covered != list(range(len(ctx.graph.nodes))):
        return None
    parts = []
    for c in chains:
        part = ctx.part_for(c)
        if part is None:
            return None
        parts.append(part)
    plan = build_plan(ctx.graph, parts, cost=cost, n_elems=ctx.n_elems,
                      dtype=ctx.dtype, hierarchy=ctx.hier, method=method)
    meta = payload.get("meta")
    if (meta is not None
            and _artifact.jsonable(plan_metadata(plan))
            != _artifact.jsonable(meta)):
        return None
    return plan


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def partition(graph: Graph, *, model=None, n_elems: int = 1 << 18,
              dtype=None, method: str = "beam", beam_width: int = 8,
              max_depth: Optional[int] = None,
              smem_budget: int = SMEM_BYTES) -> Plan:
    """Partition ``graph`` into an executable :class:`Plan`.

    model:      a :class:`repro_torch.memhier.hierarchy.Hierarchy` (or a
                preset name like ``"h100"``) → chains are scored by
                the trace-driven simulator and each Part's Program
                negotiates its geometry against it; ``None`` or a
                :class:`BurstModel` → analytic ``hbm_bytes_fused`` cost.
    method:     "beam" (default), "greedy", or "singletons" (the
                all-unfused counterfactual). Beam and greedy results are
                both compared against the all-singleton plan and the
                cheapest wins — the searched plan is never worse than
                all-unfused under the chosen cost model.
    n_elems / dtype: representative operand size for cost evaluation and
                the budget check (defaults: 2^18 elements of float32).
    smem_budget: on-chip bytes each part's Program may pin.
    max_depth:  optional ceiling on a chain's summed pipeline depth.

    With an active plan cache (:mod:`repro_torch.core.artifact`), searched
    partitions persist: the winning chain split and its cost are stored
    under (graph structure hash × size/dtype × search knobs × budget ×
    model fingerprint), and a later process — or another worker in a
    ``repro_torch.sched`` fleet — rebuilds the Plan from the cached chains
    (re-validated against this graph and registry) instead of re-running
    the beam search and its memhier scoring (DESIGN.md §14). Trivial
    ``singletons`` runs never touch the disk.
    """
    ctx = _Partitioner(graph, model=model, n_elems=n_elems, dtype=dtype,
                       max_depth=max_depth, smem_budget=smem_budget)
    cache = dkey = None
    if method == "singletons":
        chains = ctx.singletons()
    elif method in ("greedy", "beam"):
        cache, dkey = _plan_disk_key(ctx, method, beam_width)
        if cache is not None:
            plan = cache.load("plan", dkey,
                              decode=lambda p: _plan_from_payload(
                                  ctx, p, method))
            if plan is not None:
                return plan
        candidates = [ctx.greedy(), ctx.singletons()]
        if method == "beam":
            candidates.insert(0, ctx.beam(beam_width))
        chains = min(candidates, key=ctx.plan_cost)
    else:
        raise ValueError(f"unknown method {method!r}; "
                         f"have beam | greedy | singletons")
    parts = [ctx.part_for(tuple(c)) for c in chains]
    assert all(p is not None for p in parts)
    plan = build_plan(graph, parts, cost=ctx.plan_cost(chains),
                      n_elems=n_elems, dtype=ctx.dtype, hierarchy=ctx.hier,
                      method=method)
    if cache is not None:
        cache.store("plan", dkey, _plan_payload(plan))
    return plan


def plan_from_chains(graph: Graph, chains: Sequence[Sequence[int]], *,
                     model=None, n_elems: int = 1 << 18, dtype=None,
                     smem_budget: int = SMEM_BYTES) -> Plan:
    """Build a Plan from a hand-written chain split (node-id lists).

    Raises ValueError if the chains don't exactly cover the graph or any
    chain is illegal — this is the "hand-written linear-chain split"
    baseline the searched plan is gated against.
    """
    ctx = _Partitioner(graph, model=model, n_elems=n_elems, dtype=dtype,
                       smem_budget=smem_budget)
    seen: list[int] = []
    parts = []
    norm = [tuple(int(i) for i in c) for c in chains]
    for c in norm:
        seen.extend(c)
        part = ctx.part_for(c)
        if part is None:
            raise ValueError(f"{graph.name}: chain {c} is not a legal "
                             f"fused program for this graph")
        parts.append(part)
    if sorted(seen) != list(range(len(graph.nodes))):
        raise ValueError(f"{graph.name}: chains {norm} do not exactly "
                         f"cover nodes 0..{len(graph.nodes) - 1}")
    return build_plan(graph, parts, cost=ctx.plan_cost(norm),
                      n_elems=n_elems, dtype=ctx.dtype, hierarchy=ctx.hier,
                      method="manual")

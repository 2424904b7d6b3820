"""Dataflow IR for instruction DAGs — the unit the partitioner compiles.

The paper's end goal (§6) is deciding which *computation* becomes one
reconfigurable region. A single region is a linear chain (``Registry.
fuse``, DESIGN.md §5); real programs are DAGs: values fan out to several
consumers, inputs are shared between branches, and there is more than
one output. :class:`Graph` is that DAG — nodes wrap registered
:class:`~repro_torch.core.isa.Instruction` names, edges are SSA
:class:`Value`\\ s — and :mod:`repro_torch.graph.partition` covers it with
fused-chain :class:`~repro_torch.core.program.Program`\\ s.

Graphs are built two ways:

  * explicitly — ``g.apply("c0_add", x, b)`` appends a node and returns
    its output Value(s);
  * traced — inside ``with Graph.trace() as g:`` every registry dispatch
    whose operands contain symbolic values records a node instead of
    executing, so existing ``ref``-composition code (the ops wrappers in
    ``kernels/ops.py``) builds the graph unchanged.

Every ``apply`` validates against the registry at build time: the name
must be registered and the operand list must match the instruction's
I'/S' :class:`~repro_torch.core.isa.OperandSpec` arity. Nodes are appended in
dependency order, so ``graph.nodes`` is always a topological order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional, Sequence, Union

_GRAPH_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class Value:
    """One vector SSA value: a graph input (``nid is None``) or the
    ``index``-th vector output of node ``nid``. ``gid`` ties the value to
    its owning graph so values cannot cross graphs silently."""

    gid: int
    nid: Optional[int]
    index: int

    @property
    def is_input(self) -> bool:
        return self.nid is None


@dataclasses.dataclass(frozen=True)
class Scalar:
    """One scalar SSA value — always a graph input (no instruction in the
    fusable set produces scalars). ``bound`` carries a literal captured
    during tracing so the plan can run without the caller re-passing it."""

    gid: int
    index: int
    bound: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Node:
    """One instruction application.

    ``operands`` preserves the dispatch-order interleaving of vectors and
    scalars (what ``Registry.dispatch`` expects); ``vec_in`` / ``scalar_in``
    are the same operands split by kind, order preserved within kind.
    """

    nid: int
    name: str
    operands: tuple[Union[Value, Scalar], ...]
    vec_in: tuple[Value, ...]
    scalar_in: tuple[Scalar, ...]
    n_vec_out: int

    def out(self, index: int, gid: int) -> Value:
        return Value(gid=gid, nid=self.nid, index=index)


class Graph:
    """An instruction DAG: inputs, nodes (topologically ordered), outputs.

    Multiple outputs, fan-out (one value, many consumers) and value reuse
    (one value, several operand slots of one node) are all legal; the
    partitioner decides what that means for fusion (a fanned-out value
    must materialise — it cannot be elided into registers).
    """

    def __init__(self, name: str = "graph", registry=None):
        if registry is None:
            from repro_torch.core import isa
            registry = isa.registry
        self.name = name
        self.registry = registry
        self.gid = next(_GRAPH_IDS)
        self.nodes: list[Node] = []
        self.inputs: list[Value] = []          # declaration order
        self.input_names: list[str] = []
        self.scalars: list[Scalar] = []
        self.scalar_names: list[str] = []
        self.outputs: list[Value] = []

    # -- construction --------------------------------------------------------
    def input(self, name: Optional[str] = None) -> Value:
        v = Value(gid=self.gid, nid=None, index=len(self.inputs))
        self.inputs.append(v)
        self.input_names.append(name or f"in{v.index}")
        return v

    def scalar(self, name: Optional[str] = None,
               bound: Optional[float] = None) -> Scalar:
        s = Scalar(gid=self.gid, index=len(self.scalars), bound=bound)
        self.scalars.append(s)
        self.scalar_names.append(name or f"s{s.index}")
        return s

    def apply(self, name: str, *operands, **kw):
        """Append one instruction node; returns its output Value(s).

        Operands may interleave :class:`Value`\\ s (vector), :class:`Scalar`\\ s
        and python numbers (scalar; literals become bound scalar inputs).
        Validated against the registry's OperandSpec at build time.
        """
        if kw:
            raise TypeError(
                f"{self.name}: keyword arguments {sorted(kw)} are not "
                f"representable in a dataflow graph — bake them into a "
                f"registered instruction instead")
        instr = self.registry.get(name)          # raises KeyError if unknown
        ops: list[Union[Value, Scalar]] = []
        vecs: list[Value] = []
        scs: list[Scalar] = []
        for o in operands:
            if isinstance(o, Value):
                if o.gid != self.gid:
                    raise ValueError(f"{self.name}: operand Value belongs to "
                                     f"a different graph")
                if o.nid is not None and o.nid >= len(self.nodes):
                    raise ValueError(f"{self.name}: operand Value from an "
                                     f"unknown node {o.nid}")
                vecs.append(o)
            elif isinstance(o, Scalar):
                if o.gid != self.gid:
                    raise ValueError(f"{self.name}: operand Scalar belongs "
                                     f"to a different graph")
                scs.append(o)
            elif isinstance(o, (int, float)):
                o = self.scalar(bound=float(o))
                scs.append(o)
            else:
                raise TypeError(
                    f"{self.name}: operand {o!r} is neither a graph Value, "
                    f"a Scalar, nor a number")
            ops.append(o)
        spec = instr.spec
        if len(vecs) != spec.vector_in or len(scs) != spec.scalar_in:
            raise ValueError(
                f"{self.name}: {name} takes {spec.vector_in} vector + "
                f"{spec.scalar_in} scalar operands, got {len(vecs)} vector "
                f"+ {len(scs)} scalar")
        node = Node(nid=len(self.nodes), name=name, operands=tuple(ops),
                    vec_in=tuple(vecs), scalar_in=tuple(scs),
                    n_vec_out=spec.vector_out)
        self.nodes.append(node)
        outs = tuple(node.out(i, self.gid) for i in range(node.n_vec_out))
        return outs[0] if len(outs) == 1 else outs

    def output(self, *values: Value) -> None:
        for v in values:
            if not isinstance(v, Value) or v.gid != self.gid:
                raise ValueError(f"{self.name}: output must be a Value of "
                                 f"this graph, got {v!r}")
            self.outputs.append(v)

    # -- tracing -------------------------------------------------------------
    @classmethod
    @contextlib.contextmanager
    def trace(cls, name: str = "traced", registry=None):
        """Build a Graph by running ``ref``-composition code symbolically.

        Inside the context, any registry dispatch whose operands contain
        this graph's symbolic values appends a node instead of executing;
        dispatches on concrete arrays run normally. Declare symbolic
        operands with ``g.input()`` / ``g.scalar()``, call the ops
        wrappers as usual, then ``g.output(...)``.
        """
        from repro_torch.core import isa
        g = cls(name=name, registry=registry)

        def hook(reg, iname, operands, kw):
            if any(isinstance(o, (Value, Scalar)) and o.gid == g.gid
                   for o in operands):
                kw = {k: v for k, v in kw.items() if k != "mode"}
                return g.apply(iname, *operands, **kw)
            return NotImplemented

        isa.push_dispatch_hook(hook)
        try:
            yield g
        finally:
            isa.pop_dispatch_hook(hook)

    # -- validation / queries ------------------------------------------------
    def node_instr(self, node: Node):
        return self.registry.get(node.name)

    def validate(self) -> None:
        """Re-check the whole graph against the registry: every node's
        instruction still registered with matching arity, every edge in
        topological order, at least one output."""
        if not self.nodes:
            raise ValueError(f"{self.name}: empty graph")
        if not self.outputs:
            raise ValueError(f"{self.name}: graph has no outputs — call "
                             f"output(...)")
        for node in self.nodes:
            spec = self.registry.get(node.name).spec
            if (len(node.vec_in) != spec.vector_in
                    or len(node.scalar_in) != spec.scalar_in):
                raise ValueError(
                    f"{self.name}: node {node.nid} ({node.name}) arity "
                    f"no longer matches the registered OperandSpec")
            for v in node.vec_in:
                if v.nid is not None and v.nid >= node.nid:
                    raise ValueError(
                        f"{self.name}: node {node.nid} reads node {v.nid} "
                        f"out of topological order")

    def consumers(self) -> dict[Value, list[tuple[int, int]]]:
        """Value → [(consumer node id, vector-operand slot)]; graph outputs
        appear as consumer id -1."""
        cons: dict[Value, list[tuple[int, int]]] = {}
        for node in self.nodes:
            for slot, v in enumerate(node.vec_in):
                cons.setdefault(v, []).append((node.nid, slot))
        for v in self.outputs:
            cons.setdefault(v, []).append((-1, 0))
        return cons

    def free_inputs(self) -> list[tuple[str, Union[Value, Scalar]]]:
        """The operands a Plan call must supply: every vector input in
        declaration order, then every scalar input without a bound
        literal in declaration order."""
        free: list[tuple[str, Union[Value, Scalar]]] = []
        free += [(self.input_names[v.index], v) for v in self.inputs]
        free += [(self.scalar_names[s.index], s) for s in self.scalars
                 if s.bound is None]
        return free

    def structure_key(self) -> tuple:
        """Value-based structural identity of the DAG — the graph-side
        component of a persistent plan-artifact key (DESIGN.md §14).

        Two graphs with equal keys have identical nodes, edges, operand
        interleavings, bound scalar literals and outputs (names and
        ``gid`` excluded — they carry no structure), so a chain split
        cached for one is legal, costs the same, and schedules the same
        for the other.
        """
        def enc(v: Value) -> tuple:
            return (("in", v.index) if v.nid is None
                    else ("n", v.nid, v.index))

        nodes = tuple(
            (nd.name,
             tuple(enc(o) if isinstance(o, Value)
                   else ("s", o.index, o.bound) for o in nd.operands),
             nd.n_vec_out)
            for nd in self.nodes)
        return ("graph", len(self.inputs), len(self.scalars), nodes,
                tuple(enc(v) for v in self.outputs))

    # -- cost bookkeeping (roofline inputs) ----------------------------------
    def flops(self, n_elems: int) -> float:
        total = 0.0
        for node in self.nodes:
            instr = self.node_instr(node)
            per = (instr.template.cost_flops_per_elem
                   if instr.template is not None else 1.0)
            total += per * n_elems
        return total

    def hbm_bytes_unfused(self, n_elems: int, dtype) -> int:
        """HBM traffic of the all-singleton execution: every node re-reads
        its vector inputs from and spills its outputs to HBM."""
        from repro_torch.core.stream import _bits
        per_elem = sum(len(n.vec_in) + n.n_vec_out for n in self.nodes)
        return per_elem * n_elems * _bits(dtype) // 8

    def __repr__(self) -> str:
        return (f"Graph({self.name!r}: {len(self.nodes)} nodes, "
                f"{len(self.inputs)} inputs, {len(self.outputs)} outputs)")


def chain_graph(names: Sequence[str], registry=None) -> Graph:
    """The trivial linear graph: each instruction's vector outputs feed the
    next one's first vector inputs, every other operand is external —
    exactly the ``Registry.fuse`` chain as a one-path DAG."""
    g = Graph(name="+".join(names), registry=registry)
    prev: tuple[Value, ...] = ()
    for name in names:
        spec = g.registry.get(name).spec
        ops: list[Union[Value, Scalar]] = list(prev[:spec.vector_in])
        ops += [g.input() for _ in range(spec.vector_in - len(ops))]
        ops += [g.scalar() for _ in range(spec.scalar_in)]
        out = g.apply(name, *ops)
        prev = out if isinstance(out, tuple) else (out,)
    g.output(*prev)
    return g

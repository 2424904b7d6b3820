"""repro_torch.graph — dataflow-graph compiler over the instruction registry.

The exploration loop the paper points at (§6): describe a computation as
a DAG of registered SIMD instructions (:mod:`~repro_torch.graph.ir`), search
over partitions of that DAG into fused reconfigurable-region programs
under the P'-type / shared-memory / pipeline-depth budgets
(:mod:`~repro_torch.graph.partition`, scored by the :mod:`repro_torch.memhier`
simulator), and execute the winning :class:`~repro_torch.graph.plan.Plan`
with inter-program buffer reuse and a ``ref``-mode oracle
(:mod:`~repro_torch.graph.plan`). See DESIGN.md §11.
"""
from .ir import Graph, Node, Scalar, Value, chain_graph
from .partition import (fuse_chain, part_cost, part_prediction, partition,
                        plan_from_chains)
from .plan import Part, PartUnit, Plan, build_plan

__all__ = [
    "Graph", "Node", "Part", "PartUnit", "Plan", "Scalar", "Value",
    "build_plan", "chain_graph", "fuse_chain", "part_cost",
    "part_prediction", "partition", "plan_from_chains",
]

"""repro_torch.sched — predictive multi-tenant scheduling runtime.

The piece that turns the repo from a compiler + simulator into a
*serving system* (DESIGN.md §13): callers submit
``(program_or_plan, operands, deadline?)`` work items to a
:class:`~repro_torch.sched.queue.RequestQueue` (admission-validated;
same-structure requests coalesce into batches sharing one warm
dispatch), an online :class:`~repro_torch.sched.cost.CostModel` predicts each
item (memhier-seeded, EWMA-corrected from observed wall time,
HBM-contention-aware for concurrent work), the
:class:`~repro_torch.sched.scheduler.Scheduler` packs ready work onto
execution lanes (EDF / weighted-fair / FIFO; on one device a round's
lanes run one after another, each coalesced batch ONE ``k1_batch_kernel``
launch; Plan parts schedule individually, one K1 launch each), and
:mod:`~repro_torch.sched.replay` records byte-stable JSONL traces whose
replay reproduces the placements exactly — scheduling policies become
benchmarkable offline like memhier traces. On a mesh
(``Scheduler(mesh=, mesh_axis=)``) lanes are ranks, and
``sharded_program_call`` runs each rank's chunk of a batch and
all-gathers the results.
"""
from .cost import CostModel, Estimate
from .queue import Batch, RequestQueue, WorkItem, coalesce_key
from .replay import (ReplayCost, TraceRecorder, placements_match, replay)
from .scheduler import (POLICIES, EdfPolicy, FifoPolicy, Placement, Report,
                        Scheduler, WeightedFairPolicy, mesh_lane_count,
                        sharded_program_call)

__all__ = [
    "Batch", "CostModel", "EdfPolicy", "Estimate", "FifoPolicy",
    "POLICIES", "Placement", "ReplayCost", "Report", "RequestQueue",
    "Scheduler", "TraceRecorder", "WeightedFairPolicy", "WorkItem",
    "coalesce_key", "mesh_lane_count", "placements_match", "replay",
    "sharded_program_call",
]

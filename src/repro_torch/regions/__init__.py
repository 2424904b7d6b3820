"""repro_torch.regions — reconfigurable-region residency (DESIGN.md §16).

Models each scheduler lane as owning a bounded set of configured-region
slots: which fused-program "bitstreams" are loaded where, what a
(re)configuration costs (measured cold-vs-warm dispatch deltas,
persisted as ``kind="reconfig"`` artifacts), and who gets evicted when
a lane is full (LRU baseline vs. EWMA predicted-reuse).  The scheduler
charges swap penalties through :meth:`RegionFile.charge` and prefers
lanes where the work's region is already resident.
"""
from repro_torch.regions.cost import (PinnedReconfigCost, ReconfigCostModel,
                                region_key_of)
from repro_torch.regions.policy import (RESIDENCY_POLICIES, LruResidency,
                                  OracleResidency,
                                  PredictedReuseResidency, make_policy)
from repro_torch.regions.residency import (RegionEvent, RegionFile, ReuseHistory,
                                     SlotState)

__all__ = [
    "LruResidency",
    "OracleResidency",
    "PinnedReconfigCost",
    "PredictedReuseResidency",
    "RESIDENCY_POLICIES",
    "ReconfigCostModel",
    "RegionEvent",
    "RegionFile",
    "ReuseHistory",
    "SlotState",
    "make_policy",
    "region_key_of",
]

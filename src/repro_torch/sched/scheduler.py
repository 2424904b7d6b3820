"""Cost-driven scheduler: policies, lanes, contention-aware execution.

The runtime's core loop (DESIGN.md §13): drain arrived requests from the
:class:`~repro_torch.sched.queue.RequestQueue` as coalesced batches, order
them by the active **policy** (EDF / weighted-fair / FIFO), pack the
front of the order onto the **lanes**, execute the round, and account
time with the :class:`~repro_torch.sched.cost.CostModel` — predicted per item
before the round, observed fed back after it.

Lanes are the unit of concurrency:

  * on one device they model async dispatch depth: a round's batches run
    one after another on the device (as the JAX package runs them), and
    the *virtual* clock charges the round the bandwidth-sharing
    contended makespan instead of assuming free overlap;
  * on a mesh (``Scheduler(mesh=, mesh_axis=)``, a
    :class:`repro_torch.launch.mesh.Mesh`), lanes are the ranks along
    ``mesh_axis``: every rank runs the same scheduler on the same
    submissions, and a coalescible batch is dispatched through
    :func:`sharded_program_call` — each rank runs its chunk of the
    independent requests (one ``k1_batch_kernel`` on the kernel path)
    and the results are all-gathered. A batch's observed seconds are the
    slowest rank's (agreed by an all-reduce), so the ranks' cost models
    and decisions stay in lockstep.

Plans schedule at *part* granularity: :meth:`Plan.schedule` levels stop
being a private loop — each level's parts are packed onto the lanes in
chunks and the virtual clock charges each chunk its contended makespan.

Two clocks:

  * ``clock="wall"`` executes for real (results bound, observed seconds
    fed to the EWMA correction);
  * ``clock="virtual"`` never touches operands: durations come from the
    cost model, so policies are benchmarkable offline, deterministically
    — the substrate :mod:`repro_torch.sched.replay` records and replays.

Per-channel HBM contention (DESIGN.md §18): each lane maps to one DRAM
channel (explicit ``lane_channels`` table, round-robin over
``n_channels``, or inherited from the
cost hierarchy's :class:`~repro_torch.memhier.hierarchy.ChannelModel`). A
round's DRAM busy times then serialise only *within* a channel
(:meth:`CostModel.contended_makespan` with the lane channels), and the
virtual clock prices each batch's finish with the fluid bandwidth-
sharing model (:meth:`CostModel.fluid_finishes`): short batches finish
when their fair-share drain completes and release their channel's
bandwidth, instead of waiting out the round. A single-channel
scheduler keeps the historic whole-round behaviour bit for bit.

Cold starts (DESIGN.md §14): a worker fleet shares ONE persistent
plan-cache directory — pass ``Scheduler(plan_cache=DIR)`` or export
``REPRO_PLAN_CACHE`` before spawning workers — so each program's
geometry negotiation and each graph's partition search is paid once
across the fleet: the first worker publishes content-addressed
artifacts (:mod:`repro_torch.core.artifact`), every later worker warm-starts
from them with zero candidate sweeps and zero beam searches.

Observability (DESIGN.md §15): each dispatched batch runs under a
``placement`` span parented to its first member's ``request`` root
(so a served request yields ONE connected span tree: admission →
coalesce → placement → dispatch → negotiate/pallas_build), root spans
are finished at completion with predicted/observed seconds, and the
registry carries per-tenant ``repro_sched_latency_seconds`` histograms
(p50/p99 in the snapshot), ``repro_sched_queue_depth``, round/item
counters, and ``repro_sched_deadline_miss_total``.

Blame attribution + SLOs (DESIGN.md §19): each root span's finish call
also stamps the request's blame inputs — ``start``, ``solo_s``,
``batch_s``, ``swap_s`` (region charge), ``contention_s``, ``channel``,
per-round channel DRAM busy seconds — which
:func:`repro_torch.obs.critical.attribute` decomposes into conservation-
checked buckets; pass ``Scheduler(slo=SloMonitor(...))`` to feed each
completion's latency into per-tenant burn-rate windows that the queue's
admission hook (:class:`repro_torch.obs.slo.SloShedder`) acts on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.isa import FusedProgram
from repro_torch.graph.plan import Plan
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.regions import RegionFile, region_key_of

from repro_torch.core.stream import dtype_name

from .cost import CostModel, Estimate
from .queue import Batch, RequestQueue, WorkItem, program_of

_ROUNDS = _metrics.REGISTRY.counter(
    "repro_sched_rounds_total", help="scheduling rounds executed")
_ITEMS = _metrics.REGISTRY.counter(
    "repro_sched_items_total", help="work items completed")

_LATENCY_HELP = ("request latency: completion minus arrival, in the "
                 "scheduler's clock (wall or virtual seconds)")


def _latency_hist(tenant: str) -> _metrics.Histogram:
    """Per-tenant latency histogram (p50/p99 come out of the snapshot's
    quantile fields — DESIGN.md §15)."""
    return _metrics.REGISTRY.histogram(
        "repro_sched_latency_seconds", help=_LATENCY_HELP,
        labels={"tenant": tenant})


def _deadline_miss(tenant: str) -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        "repro_sched_deadline_miss_total",
        help="completions after their deadline",
        labels={"tenant": tenant})


def _channel_busy(channel: int) -> _metrics.Counter:
    """Per-channel DRAM busy-seconds (DESIGN.md §18 model output,
    exposed via the registry so ``serve.py --metrics`` serves it)."""
    return _metrics.REGISTRY.counter(
        "repro_sched_dram_busy_seconds_total",
        help="modeled DRAM busy seconds accumulated per channel",
        labels={"channel": str(channel)})


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

class FifoPolicy:
    """Arrival order (sequence numbers)."""

    name = "fifo"

    def order(self, batches: Sequence[Batch], now: float,
              estimate) -> list[Batch]:
        return sorted(batches, key=lambda b: b.seq)


class EdfPolicy:
    """Earliest deadline first; deadline-free work drains last, FIFO."""

    name = "edf"

    def order(self, batches: Sequence[Batch], now: float,
              estimate) -> list[Batch]:
        inf = float("inf")
        return sorted(batches, key=lambda b: (
            b.deadline if b.deadline is not None else inf, b.seq))


class WeightedFairPolicy:
    """Weighted fair queueing over tenants.

    Each batch gets a virtual finish tag when first seen (in seq order,
    so tagging is deterministic); rounds serve ascending tags. Coalesce
    keys ignore tenants, so a batch may span several — each member
    tenant is billed ITS OWN service share
    (``F_t = max(tenant_tag_t, arrival) + service_t / weight_t``) and
    the batch's tag is the latest member finish, so nobody rides free on
    a shared launch. A tenant with twice the weight advances its virtual
    time half as fast and therefore receives ~2x the service share under
    backlog.
    """

    name = "wfq"

    def __init__(self):
        self._tenant_tag: dict[str, float] = {}
        self._batch_tag: dict[int, float] = {}

    def order(self, batches: Sequence[Batch], now: float,
              estimate) -> list[Batch]:
        for b in sorted(batches, key=lambda b: b.seq):
            if b.seq in self._batch_tag:
                continue
            per_tenant: dict[str, tuple[float, float]] = {}
            for it in b.items:
                s, w = per_tenant.get(it.tenant, (0.0, 0.0))
                per_tenant[it.tenant] = (s + estimate(it).seconds,
                                         w + it.weight)
            tag = 0.0
            for tenant in sorted(per_tenant):
                service, weight = per_tenant[tenant]
                start = max(self._tenant_tag.get(tenant, 0.0), b.arrival)
                f = start + service / max(weight, 1e-12)
                self._tenant_tag[tenant] = f
                tag = max(tag, f)
            self._batch_tag[b.seq] = tag
        return sorted(batches, key=lambda b: (self._batch_tag[b.seq], b.seq))


POLICIES = {"fifo": FifoPolicy, "edf": EdfPolicy, "wfq": WeightedFairPolicy}


# ---------------------------------------------------------------------------
# lanes over a mesh
# ---------------------------------------------------------------------------

def _mesh_axes(axis) -> tuple[str, ...]:
    """Normalise a mesh-axis spec: a single name, or a tuple of names
    for a multi-host lane mesh (e.g. ``("hosts", "devices")``)."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def mesh_lane_count(mesh, axis) -> int:
    """Lanes a mesh provides over ``axis`` (product across a tuple of
    axis names — lanes = hosts × devices on a multi-host mesh)."""
    shape = dict(mesh.shape)
    n = 1
    for a in _mesh_axes(axis):
        n *= shape[a]
    return n


def _stack(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[i] for o in outs])
                     for i in range(len(outs[0])))
    return torch.stack(outs)


def sharded_program_call(fused, operand_tuples, mesh, axis="parts",
                         chunk_call=None):
    """Run N independent same-structure requests across the ranks of
    ``mesh`` along ``axis``.

    Every rank makes the same call with the same operands. N is padded
    up to a multiple of the lane count by repeating the first request;
    rank l (its row-major index along ``axis``: host-major on a tuple of
    axes, matching the scheduler's lane→channel map) runs requests
    [l·chunk, (l+1)·chunk) through ``chunk_call(list of operand tuples)
    → list of results`` — e.g. ``Program.call_batch``, one
    ``k1_batch_kernel`` launch — or, by default, the program's oracle
    composition (``fused._ref``) item by item; the chunks' results are
    all-gathered and the padding dropped. Returns the per-request
    results in order, on every rank. (The reference's ``chunk_call`` is
    per item, inside ``shard_map``; here it takes the rank's chunk.)"""
    from repro_torch.distributed.collectives import gather_dim

    if not isinstance(fused, FusedProgram):
        raise TypeError("sharded_program_call needs a FusedProgram "
                        f"(got {type(fused).__name__})")
    items = [tuple(ops) for ops in operand_tuples]
    if not items:
        return []
    axes = _mesh_axes(axis)
    n_dev = mesh_lane_count(mesh, axes)
    n_real = len(items)
    items = items + [items[0]] * ((-n_real) % n_dev)
    chunk = len(items) // n_dev
    me = mesh.axis_index(axes)
    mine = items[me * chunk:(me + 1) * chunk]
    outs = (list(chunk_call(mine)) if chunk_call is not None
            else [fused._ref(*it) for it in mine])
    group = mesh.group(axes)
    out = _stack(outs)
    if isinstance(out, tuple):
        out = tuple(gather_dim(o, group, 0) for o in out)
        return [tuple(o[k] for o in out) for k in range(n_real)]
    out = gather_dim(out, group, 0)
    return [out[k] for k in range(n_real)]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Placement:
    """One item's scheduling decision + outcome (the replayable record).

    ``channel`` is the HBM channel the item's lane drains on (DESIGN.md
    §18); always 0 on a single-channel scheduler, where it is also
    omitted from recorded traces (byte-stability with pre-channel
    traces)."""

    seq: int
    lane: int
    round: int
    start: float
    finish: float
    predicted_s: float
    observed_s: float
    coalesced: bool
    batch_seq: int
    channel: int = 0


@dataclasses.dataclass
class Report:
    placements: list[Placement]
    makespan: float
    missed: list[int]                 # seqs that finished past deadline
    results: dict[int, Any]

    @property
    def n_items(self) -> int:
        return len(self.placements)


class Scheduler:
    """Pack ready batches onto lanes, execute, account, repeat."""

    def __init__(self, queue: RequestQueue, cost: Optional[CostModel] = None,
                 policy: str = "edf", n_lanes: int = 2, mesh=None,
                 mesh_axis="parts", mode: Optional[str] = None,
                 clock: str = "wall", recorder=None, plan_cache=None,
                 region_slots: Optional[int] = None,
                 region_policy="lru", region_cost=None,
                 region_file: Optional[RegionFile] = None,
                 n_channels: Optional[int] = None,
                 lane_channels: Optional[Sequence[int]] = None,
                 slo=None):
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual', got "
                             f"{clock!r}")
        if plan_cache is not None:
            # fleet-shared persistent artifacts (DESIGN.md §14): point
            # this worker process at the shared cache dir so compiled
            # plans/geometries are published once and warm-started by
            # every other worker (same as REPRO_PLAN_CACHE in the env).
            from repro_torch.core.artifact import set_plan_cache
            set_plan_cache(plan_cache)
        if isinstance(policy, str):
            try:
                self.policy = POLICIES[policy]()
            except KeyError:
                raise ValueError(f"unknown policy {policy!r}; have "
                                 f"{sorted(POLICIES)}") from None
        else:
            self.policy = policy
        self.queue = queue
        self.cost = cost if cost is not None else CostModel()
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.n_lanes = (mesh_lane_count(mesh, mesh_axis) if mesh is not None
                        else max(1, int(n_lanes)))
        self._init_channels(n_channels, lane_channels)
        self.mode = mode
        self.clock = clock
        self.recorder = recorder
        # SLO feedback (DESIGN.md §19): a repro_torch.obs.slo.SloMonitor fed
        # one latency event per completion, on this scheduler's clock —
        # pair it with RequestQueue(admission=SloShedder(monitor)) to
        # close the shed loop.
        self.slo = slo
        self.placements: list[Placement] = []
        self.results: dict[int, Any] = {}
        self._now = 0.0
        self._round = 0
        self._t0 = time.perf_counter()
        self._estimates: dict[int, Estimate] = {}
        self._deadlines: dict[int, Optional[float]] = {}
        self._submitted: set[int] = set()
        self._plan_durations: dict[tuple, float] = {}
        # region residency (repro_torch.regions, DESIGN.md §16): off unless a
        # slot bound (0 = track-but-unbounded) or a RegionFile is given.
        if region_file is not None:
            if region_file.n_lanes != self.n_lanes:
                raise ValueError(
                    f"region_file has {region_file.n_lanes} lanes, "
                    f"scheduler has {self.n_lanes}")
            self.regions: Optional[RegionFile] = region_file
        elif region_slots is not None:
            self.regions = RegionFile(self.n_lanes, slots=region_slots,
                                      policy=region_policy,
                                      cost=region_cost)
        else:
            self.regions = None
        self._region_noted: set[int] = set()
        if recorder is not None:
            cfg = dict(policy=self.policy.name, n_lanes=self.n_lanes,
                       clock=clock)
            if self.regions is not None:
                cfg.update(region_slots=self.regions.slots_cfg,
                           region_policy=self.regions.policy_name)
            if self.n_channels > 1:
                # only multi-channel configs carry channel fields, so a
                # single-channel trace stays byte-identical to pre-
                # channel recordings (the replay identity gate).
                cfg.update(n_channels=self.n_channels,
                           lane_channels=list(self.lane_channels))
            recorder.record("config", **cfg)

    def _init_channels(self, n_channels: Optional[int],
                       lane_channels: Optional[Sequence[int]]) -> None:
        """Resolve the lane→HBM-channel map (DESIGN.md §18).

        Source priority: an explicit ``lane_channels`` table > an
        explicit ``n_channels`` (round-robin ``lane % n``) > a
        multi-host mesh (host-major: each host drains its own channel)
        > the cost model hierarchy's :class:`~repro_torch.memhier.
        hierarchy.ChannelModel` > single-channel. The result feeds the round's
        per-channel contended makespan and fluid finish times.
        """
        if lane_channels is not None:
            table = [int(c) for c in lane_channels]
            if len(table) != self.n_lanes:
                raise ValueError(
                    f"lane_channels has {len(table)} entries for "
                    f"{self.n_lanes} lanes")
            if any(c < 0 for c in table):
                raise ValueError("lane_channels entries must be >= 0")
            self.lane_channels = table
            self.n_channels = max(max(table) + 1,
                                  int(n_channels or 1))
            return
        if n_channels is not None:
            n_ch = max(1, int(n_channels))
        else:
            axes = _mesh_axes(self.mesh_axis)
            if self.mesh is not None and len(axes) > 1:
                # multi-host lane mesh: lanes are host-major (matching
                # sharded_program_call), each host's HBM is a channel.
                n_ch = dict(self.mesh.shape)[axes[0]]
                per_host = self.n_lanes // max(n_ch, 1)
                self.n_channels = max(1, n_ch)
                self.lane_channels = [l // max(per_host, 1)
                                      for l in range(self.n_lanes)]
                return
            hier = self.cost.hierarchy
            n_ch = int(getattr(hier, "n_channels", 1)) if hier is not None \
                else 1
        self.n_channels = max(1, n_ch)
        self.lane_channels = [l % self.n_channels
                              for l in range(self.n_lanes)]

    # -- clocks ---------------------------------------------------------------
    def now(self) -> float:
        if self.clock == "virtual":
            return self._now
        return time.perf_counter() - self._t0

    def _estimate(self, item: WorkItem) -> Estimate:
        est = self._estimates.get(item.seq)
        if est is None:
            # cost pricing can trigger the item's first geometry
            # negotiation — parent that span under the request root
            tr = _trace.get_tracer()
            if tr is not None and item.span is not None:
                with tr.under(item.span):
                    est = self.cost.estimate_item(item)
            else:
                est = self.cost.estimate_item(item)
            if self.clock == "virtual" and isinstance(item.target, Plan):
                # a plan's virtual duration is its levels lane-packed
                # with contention — priced HERE so the recorded submit
                # estimate is exactly what execution charges and
                # replay() reproduces placements bit-for-bit.
                d = self._plan_virtual_duration(item.target)
                if d is not None:
                    est = dataclasses.replace(est, seconds=d)
            self._estimates[item.seq] = est
        return est

    def _batch_estimate(self, batch: Batch) -> Estimate:
        """One estimate for a whole batch. A coalesced batch is ONE
        launch over the items: modeled work and DRAM demand
        sum (conservative — the launch actually amortises per-call
        overhead, which the wall clock then confirms as the win)."""
        ests = [self._estimate(it) for it in batch.items]
        if len(ests) == 1:
            return ests[0]
        return Estimate(
            seconds=sum(e.seconds for e in ests),
            modeled_s=sum(e.modeled_s for e in ests),
            dram_busy_s=sum(e.dram_busy_s for e in ests),
            dram_bytes=sum(e.dram_bytes for e in ests),
            source=ests[0].source)

    # -- execution ------------------------------------------------------------
    @staticmethod
    def _resolve_mode(mode: Optional[str], batch: Batch) -> str:
        """The registry's 'auto' rule (single owner:
        :func:`repro_torch.core.isa.resolve_auto`) on the batch's
        operands — so every batch path (coalesced, per-item) agrees with
        what a direct FusedProgram call would have done."""
        from repro_torch.core.isa import resolve_auto
        return resolve_auto(mode or "auto",
                            [o for it in batch.items for o in it.operands])

    def _dispatch_batch(self, batch: Batch):
        """Run one batch for real; returns per-item results."""
        mode = self._resolve_mode(batch.items[0].mode or self.mode, batch)
        prog = program_of(batch.target)
        if self.mesh is not None and isinstance(batch.target, FusedProgram) \
                and batch.key is not None:
            chunk = None
            if mode != "ref" and prog is not None:
                def chunk(items):
                    return prog.call_batch(items,
                                           interpret=(mode == "interpret"))
            return sharded_program_call(
                batch.target, [it.operands for it in batch.items],
                self.mesh, axis=self.mesh_axis, chunk_call=chunk)
        # coalescing is a kernel-path mechanism (one k1_batch_kernel);
        # ref-mode dispatch composes oracles per item instead.
        if batch.coalesced and prog is not None and mode != "ref":
            return prog.call_batch([it.operands for it in batch.items],
                                   interpret=(mode == "interpret"))
        outs = []
        for it in batch.items:
            if isinstance(it.target, (FusedProgram, Plan)):
                outs.append(it.target(*it.operands, mode=mode))
            elif program_of(it.target) is not None:
                # a bare Program has no oracle: kernel or interpret only
                outs.append(it.target(*it.operands,
                                      interpret=(mode != "kernel")))
            else:
                outs.append(it.target(*it.operands))
        return outs

    def _agreed(self, seconds: float) -> float:
        """On a mesh, the slowest rank's seconds (every rank's)."""
        if self.mesh is None or self.mesh.size == 1:
            return seconds
        from repro_torch.distributed.collectives import all_reduce_max_
        t = torch.tensor([seconds], dtype=torch.float64)
        return float(all_reduce_max_(t, self.mesh.group(
            self.mesh.axis_names))[0])

    def _plan_virtual_duration(self, plan: Plan) -> Optional[float]:
        """Virtual seconds of one Plan item: its dependency levels packed
        onto the lanes in chunks, each chunk charged the contended
        makespan — the scheduler's contention-aware refinement of
        ``Plan.predicted_time`` (which overlaps parts for free).
        Memoised on the plan's structure + model fingerprint (the
        per-part memhier simulations are invariant per structure, and
        repeated submissions of one plan are the common case)."""
        from repro_torch.core.program import _model_fingerprint
        hier = self.cost.hierarchy if self.cost.hierarchy is not None \
            else plan.hierarchy
        if hier is None:
            return None
        key = (plan.graph.name, tuple(plan.chains()), plan.n_elems,
               str(plan.dtype), self.n_lanes, _model_fingerprint(hier),
               self.n_channels, tuple(self.lane_channels))
        if key in self._plan_durations:
            return self._plan_durations[key]
        d = self._plan_duration_uncached(plan, hier)
        self._plan_durations[key] = d
        return d

    def _plan_duration_uncached(self, plan: Plan, hier) -> float:
        units = plan.units(hier)
        total = 0.0
        for level in plan.schedule():
            for lo in range(0, len(level), self.n_lanes):
                chunk = level[lo:lo + self.n_lanes]
                ests = [Estimate(seconds=units[i].predicted_s,
                                 modeled_s=units[i].predicted_s,
                                 dram_busy_s=units[i].dram_busy_s or 0.0,
                                 dram_bytes=units[i].hbm_bytes,
                                 source="plan")
                        for i in chunk]
                chans = (self.lane_channels[:len(chunk)]
                         if self.n_channels > 1 else None)
                total += self.cost.contended_makespan(ests, chans)
        return total

    def _region_key(self, item: WorkItem) -> tuple:
        if item.region_key is None:
            item.region_key = region_key_of(item.target)
        return item.region_key

    def _assign_lanes(self, round_batches: list[Batch],
                      now: float) -> tuple[list[int], list[float]]:
        """Pick a lane per batch (policy order) and commit the region
        loads; returns the lanes plus the charged swap seconds.

        Regions off → lanes are the batch indices, exactly the historic
        ``enumerate`` packing. Regions on → each batch takes the
        cheapest-to-configure free lane (resident > free slot > evict),
        tie-broken on lane index — so when every charge is zero
        (unbounded slots) the assignment degenerates to the historic
        one and placements stay bit-identical (the ``bench_regions``
        identity gate).
        """
        n = len(round_batches)
        if self.regions is None:
            return list(range(n)), [0.0] * n
        tr = _trace.ACTIVE
        lanes, charges = [], []
        free = list(range(self.n_lanes))
        for b in round_batches:
            rk = self._region_key(b.items[0])
            lane = min(free,
                       key=lambda l: (self.regions.charge(l, rk), l))
            free.remove(lane)
            cost_s, events = self.regions.place(lane, rk, now)
            lanes.append(lane)
            charges.append(cost_s)
            if self.recorder is not None:
                for ev in events:
                    self.recorder.record(
                        "region", op=ev.op, lane=ev.lane,
                        key=repr(ev.key), cost_s=ev.cost_s,
                        round=self._round)
            if cost_s and tr is not None:
                with tr.span("reconfig", parent=b.items[0].span,
                             lane=lane, key=repr(rk), cost_s=cost_s,
                             round=self._round):
                    pass
        return lanes, charges

    def _run_round(self, round_batches: list[Batch]) -> None:
        start = self.now()
        lanes, charges = self._assign_lanes(round_batches, start)
        chans = [self.lane_channels[l] for l in lanes]
        channels = chans if self.n_channels > 1 else None
        ests0 = [self._batch_estimate(b) for b in round_batches]
        ests = ests0
        if any(charges):
            # the swap penalty serialises ahead of the batch's own work
            # on its lane, so it joins the round's contended makespan
            ests = [dataclasses.replace(e, seconds=e.seconds + c)
                    for e, c in zip(ests0, charges)]
        makespan = self.cost.contended_makespan(ests, channels)
        busy_by_ch: dict[int, float] = {}
        for ch, e in zip(chans, ests0):
            busy_by_ch[ch] = busy_by_ch.get(ch, 0.0) + e.dram_busy_s
            _channel_busy(ch).inc(e.dram_busy_s)

        tr = _trace.ACTIVE
        if self.clock == "virtual":
            if channels is not None:
                # per-channel fluid sharing (DESIGN.md §18): short
                # batches finish when their channel's fair-share drain
                # completes instead of waiting out the round; the
                # round's end (and the clock step) is still the rigid
                # closed-form makespan, which fluid_finishes clamps to.
                fins = self.cost.fluid_finishes(
                    ests, channels, n_channels=self.n_channels)
                observed = list(fins)
                finishes = [start + f for f in fins]
            else:
                # single channel keeps the historic whole-round finish
                # bit for bit (trace byte-stability with old recordings).
                observed = [makespan] * len(round_batches)
                finishes = [start + makespan] * len(round_batches)
            results = [[None] * len(b.items) for b in round_batches]
            if tr is not None:
                for lane, ch, b in zip(lanes, chans, round_batches):
                    extra = {"channel": ch} if channels is not None else {}
                    with tr.span("placement", parent=b.items[0].span,
                                 lane=lane, round=self._round,
                                 batch_seq=b.seq, n_items=len(b.items),
                                 virtual=True, **extra):
                        pass
        else:
            observed, results, finishes = [], [], []
            done = 0.0
            for lane, b in zip(lanes, round_batches):
                t0 = time.perf_counter()
                if tr is not None and b.items[0].span is not None:
                    # hang the lane's work off the request's root span so
                    # the dispatch/negotiate children nest under it
                    with tr.under(b.items[0].span), \
                            tr.span("placement", lane=lane,
                                    round=self._round, batch_seq=b.seq,
                                    n_items=len(b.items)):
                        out = self._dispatch_batch(b)
                        _block_until_ready(out)
                else:
                    out = self._dispatch_batch(b)
                    _block_until_ready(out)
                dt = self._agreed(time.perf_counter() - t0)
                done += dt
                observed.append(dt)
                results.append(out)
                finishes.append(start + done)
                it0 = b.items[0]
                self.cost.observe(it0.target, n_elems=it0.n_elems,
                                  dtype=_item_dtype(it0), seconds=dt,
                                  n_items=len(b.items),
                                  cost_key=it0.cost_key)

        for lane, ch, b, outs, obs, fin, charge, est0 in zip(
                lanes, chans, round_batches, results, observed, finishes,
                charges, ests0):
            for it, out in zip(b.items, outs):
                it.result = out
                it.predicted_s = self._estimate(it).seconds
                # per-item share, so predicted vs observed compare like
                # with like on coalesced batches
                it.observed_s = obs / max(1, len(b.items))
                it.lane, it.start, it.finish = lane, start, fin
                _ITEMS.inc()
                _latency_hist(it.tenant).observe(max(fin - it.arrival, 0.0))
                if it.deadline is not None and fin > it.deadline:
                    _deadline_miss(it.tenant).inc()
                if it.span is not None and tr is not None:
                    # blame inputs (DESIGN.md §19): the scheduler-time
                    # quantities obs/critical.py decomposes latency
                    # with.  Virtual clock: solo/batch are model
                    # estimates and the region swap charge is real;
                    # wall clock: solo/batch are observed and the
                    # charge is a model fiction execution never paid.
                    if self.clock == "virtual":
                        solo_s, batch_s, swap_s = (
                            it.predicted_s, est0.seconds, charge)
                    else:
                        solo_s, batch_s, swap_s = it.observed_s, obs, 0.0
                    tr.finish(it.span, lane=lane, finish=fin,
                              predicted_s=it.predicted_s,
                              observed_s=it.observed_s,
                              start=start, solo_s=solo_s,
                              batch_s=batch_s, swap_s=swap_s,
                              contention_s=(fin - start) - batch_s
                              - swap_s,
                              channel=ch, clock=self.clock,
                              dram_busy_s=est0.dram_busy_s,
                              channel_busy_s=busy_by_ch[ch])
                if self.slo is not None:
                    self.slo.record(it.tenant,
                                    max(fin - it.arrival, 0.0), now=fin)
                self.results[it.seq] = out
                self.placements.append(Placement(
                    seq=it.seq, lane=lane, round=self._round, start=start,
                    finish=fin, predicted_s=it.predicted_s,
                    observed_s=it.observed_s, coalesced=b.coalesced,
                    batch_seq=b.seq, channel=ch))
                if self.recorder is not None:
                    extra = ({"channel": ch} if self.n_channels > 1
                             else {})
                    self.recorder.record(
                        "place", seq=it.seq, lane=lane, round=self._round,
                        start=start, finish=fin,
                        predicted_s=it.predicted_s,
                        observed_s=it.observed_s,
                        coalesced=b.coalesced, batch_seq=b.seq, **extra)
        if self.clock == "virtual":
            self._now = start + makespan
        self._round += 1
        _ROUNDS.inc()

    def _record_submits(self, batches: list[Batch]) -> None:
        for b in batches:
            for it in b.items:
                self._deadlines.setdefault(it.seq, it.deadline)
                if self.recorder is None or it.seq in self._submitted:
                    continue
                self._submitted.add(it.seq)
                est = self._estimate(it)
                extra = {}
                if self.regions is not None:
                    # region identity + pinned load cost, so replay()
                    # reproduces residency decisions without the targets
                    rk = self._region_key(it)
                    extra = dict(region_key=repr(rk),
                                 region_cost_s=self.regions.cost.cost(rk))
                self.recorder.record(
                    "submit", seq=it.seq, arrival=it.arrival,
                    deadline=it.deadline, tenant=it.tenant,
                    weight=it.weight,
                    key=None if it.key is None else repr(it.key),
                    predicted_s=est.seconds, modeled_s=est.modeled_s,
                    dram_busy_s=est.dram_busy_s, dram_bytes=est.dram_bytes,
                    **extra)

    def drain(self) -> Report:
        """Schedule until the queue is empty; returns the cumulative
        report (drain may be called repeatedly as work keeps arriving).

        One *round* (≤ ``n_lanes`` batches) runs per iteration; batches
        the round did not take re-enter the queue, so later arrivals
        compete under the policy instead of waiting out a long backlog.
        """
        while self.queue:
            now = self.now()
            batches = self.queue.pop_ready(now)
            if not batches:
                nxt = self.queue.next_arrival(now)
                if nxt is None:
                    nxt = min(it.arrival for it in self.queue.pending)
                if self.clock == "virtual":
                    self._now = max(self._now, nxt)
                else:
                    time.sleep(max(0.0, nxt - now))
                continue
            self._record_submits(batches)
            if self.regions is not None:
                # feed the reuse predictor in arrival order, once per item
                fresh = [(it, self._region_key(it)) for b in batches
                         for it in b.items
                         if it.seq not in self._region_noted]
                for it, rk in sorted(fresh,
                                     key=lambda p: (p[0].arrival,
                                                    p[0].seq)):
                    self._region_noted.add(it.seq)
                    self.regions.note_arrival(rk, it.tenant, it.arrival)
            ordered = self.policy.order(batches, self.now(), self._estimate)
            self._run_round(ordered[:self.n_lanes])
            for b in ordered[self.n_lanes:]:
                self.queue.pending.extend(b.items)
        return self.report()

    def report(self) -> Report:
        missed = sorted(
            p.seq for p in self.placements
            if self._deadlines.get(p.seq) is not None
            and p.finish > self._deadlines[p.seq])
        makespan = max((p.finish for p in self.placements), default=0.0)
        return Report(placements=list(self.placements), makespan=makespan,
                      missed=missed, results=dict(self.results))


def _block_until_ready(out) -> None:
    """Wait for the devices of every tensor in ``out`` (nested lists and
    tuples); CPU tensors need no wait."""
    devices, stack = set(), [out]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                devices.add(o.device)
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
    for dev in devices:
        torch.cuda.synchronize(dev)


def _item_dtype(item: WorkItem):
    """The item's dtype name (``"float32"``), as the cost keys hold it."""
    prog = program_of(item.target)
    if prog is not None:
        vecs = prog.check_vector_operands(item.operands)
        return dtype_name(vecs[0].dtype)
    if isinstance(item.target, Plan):
        return item.target.dtype
    return None

"""Event-driven multi-rail collective simulator (ASTRA-lite).

Models the 2xD-stage pipelined execution of chunked hierarchical collectives
on a multi-dimensional network (paper Sec. 2.3/5.1):

  * each network dimension is a serial bandwidth resource with a ready
    queue (FIFO or Smallest-Chunk-First discipline, Sec. 4.3);
  * a chunk's stage ops execute in schedule order (RS-before-AG is embedded
    in the schedule); a stage occupies its dimension for ``wire_bytes/BW``
    and *completes* (readying the chunk's next stage) after an additional
    fixed delay ``A_stage`` — successive chunks pipeline through a
    dimension's steps, so A is latency, not throughput (this matches
    Algorithm 1, which charges A_K once per collective in the tracker
    rather than per chunk);
  * optional small-chunk fusion: if a chunk op cannot saturate a dimension's
    BW (wire time < A), multiple ready ops are fused into one service
    (Sec. 4.3's provision, mirroring NCCL collective fusion);
  * optional enforced per-dim op order (Sec. 4.6.2 consistency) and random
    service-time jitter for consistency experiments.

The engine is *online and arrival-time-aware*: every collective (a "group"
of chunks) carries an issue time, so overlapping collectives — backprop
bucket streams, pipeline stages, multi-tenant jobs — contend for shared
dimensions exactly as they would on real hardware.  ``simulate_requests``
is the high-level entry: a stream of :class:`CollectiveRequest`s is
scheduled incrementally (``ThemisScheduler.schedule_request``, which keeps
the Dim Load Tracker running across requests) and simulated jointly.

Beyond fixed issue times, groups may be *dependency-gated* (``deps`` /
``dep_delay_s``): a group becomes eligible only once all its predecessor
groups have fully finished plus a compute delay — the structure pipeline
1F1B activation streams and serving decode chains need, where a send's
issue time is itself an output of the simulation (Rashidi et al.'s ACE,
arXiv 2007.00156: compute->comm dependencies determine overlap).  Groups
with an empty chunk list act as pure compute nodes: they finish at their
eligibility instant and only exist to gate (and delay) their dependents.
``repro_torch.traffic`` builds these graphs; ``SimResult.group_issue`` reports
the *resolved* issue times.

Multi-tenant fabrics plug in through an *arbiter* (duck-typed; see
``repro_torch.tenancy.FabricArbiter``): when present it replaces the per-dim
queue discipline (inter-tenant policies such as weighted-fair or
strict-priority), batches same-tenant chunks into multi-chunk services,
and may **preempt** an in-flight multi-chunk service at chunk granularity —
chunks whose data has not started draining are returned to the ready queue
so a higher-share tenant does not wait behind a 1 GB collective.  Byte
conservation holds across preemptions: every chunk stage is eventually
served exactly once.  A non-zero ``preempt_penalty_s`` charges a re-arm
latency: requeued chunks only become ready again ``penalty`` seconds after
the split (splitting is free by default for backward compatibility).

Two engines implement identical semantics:

  * ``engine="indexed"`` (default) — struct-of-arrays task storage with
    integer handles, per-dim indexed priority queues (heaps keyed by the
    active discipline) and per-(dim, tenant) bucket heaps for the arbiter's
    quantum batching, so a service start is O(batch x log n) instead of a
    full-queue sort + O(n) removes.  Near-linear in total stage-ops.
  * ``engine="reference"`` — the original list-sorting event loop, kept
    reachable as the differential-testing oracle.

Both engines consume the shared tie-break/jitter sequence in the same
order, so makespans, per-dim wire bytes, service orders and per-request
finish times are bit-identical (``benchmarks/sched_perf.py`` gates on it).

Outputs makespan, per-dim busy time / wire bytes, BW utilization (the
paper's weighted-average metric), per-dim activity timelines (Fig. 9),
per-request completion times, and per-dim service logs attributing every
service interval to the requests it carried.

This is the port's copy of ``repro/core/simulator.py``: the same code,
imports aside.  ``arbiter`` (``repro_torch.tenancy``), ``faults`` and
``replanner`` (``repro_torch.faults``) run as in the reference.  Only
``admission`` needs a package the port does not carry yet (``fleet``,
ROADMAP §1 item 1d): ``simulate`` raises ``NotImplementedError`` when
given one.  The engines keep that path as the reference has it, for when
the package comes.
"""
from __future__ import annotations

import heapq
import itertools
import math
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import NamedTuple

from repro_torch.core.chunking import Chunk
from repro_torch.core.invariants import (
    check_final,
    check_service_start,
    check_work_conserving,
)
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest
from repro_torch.obs.metrics import current_registry
from repro_torch.topology import Phase, Topology

OpId = tuple[int, int]  # (chunk_id, stage_idx)


class ServiceInterval(NamedTuple):
    """One served batch on a dimension.

    A NamedTuple so equality, unpacking, and indexing behave exactly like
    the bare ``(start, end, groups)`` tuple it replaces — existing
    ``for start, end, groups in dim_services[k]`` loops and tuple-literal
    comparisons keep working unchanged.
    """

    start: float
    end: float
    groups: tuple[int, ...]

    @property
    def op(self) -> tuple[int, ...]:
        """Group ids this service carried (alias of ``groups``)."""
        return self.groups

ENGINES = ("indexed", "compiled", "reference")

# Arbiter policies the indexed engine can map onto per-(dim, tenant) bucket
# heaps.  Anything else (a custom duck-typed arbiter with its own order_key)
# falls back to the reference engine, which honors arbitrary keys.
_INDEXABLE_ARBITER_POLICIES = ("fifo", "strict-priority", "weighted-fair",
                               "slo-aware")


@dataclass
class StageTask:
    chunk_id: int
    stage_idx: int
    dim: int
    wire_bytes: float
    fixed_delay: float
    group: int = 0
    priority: int = 0
    arrival_seq: int = 0
    ready_time: float = 0.0
    tenant: str = "default"

    @property
    def op_id(self) -> OpId:
        return (self.chunk_id, self.stage_idx)


@dataclass
class _Service:
    """One in-flight batch on a dimension — the unit of preemption.

    ``batch`` holds :class:`StageTask`s in the reference engine and integer
    task handles in the indexed engine.
    """

    sid: int                   # event validity token; bumped on preemption
    dim: int
    start: float
    end: float
    rate: float                # effective drain rate, bytes/s (incl. jitter)
    batch: list
    svc_idx: int               # index of this service in dim_services[dim]


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolation percentile of pre-sorted data (numpy's default
    method, without requiring numpy)."""
    if not sorted_vals:
        return 0.0
    k = (len(sorted_vals) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (k - lo)


@dataclass(frozen=True)
class StreamStats:
    """Aggregate metrics of one request stream (or tenant)."""

    n: int                     # number of requests carrying the tag
    issue_first: float         # earliest issue time
    finish: float              # latest finish time
    latency_mean: float        # mean issue-to-finish latency
    latency_max: float
    wire_bytes: float          # total wire bytes moved for the tag
    # Latency percentiles — serving SLOs are tail metrics (decode p99), and
    # means hide exactly the contention the arbiter policies differ on.
    latency_p50: float = 0.0
    latency_p95: float = 0.0
    latency_p99: float = 0.0
    # Groups that actually finished: ``n`` minus failed/shed members.  -1 is
    # the legacy sentinel (no failure/shed accounting ran); a tag whose
    # groups all died reports n_live=0 with zeroed latency/finish aggregates
    # instead of NaN/IndexError.
    n_live: int = -1


@dataclass
class SimResult:
    makespan: float
    dim_busy: list[float]
    dim_wire_bytes: list[float]
    dim_activity: list[list[tuple[float, float]]]  # intervals w/ pending work
    dim_op_order: list[list[OpId]]                 # service order per dim
    # -- arrival-time-aware extensions ---------------------------------------
    dim_services: list[list[ServiceInterval]] = field(default_factory=list)
    group_issue: list[float] = field(default_factory=list)
    group_finish: list[float] = field(default_factory=list)
    # -- per-group tags / attribution (populated by simulate_requests) -------
    group_streams: list[str] = field(default_factory=list)
    group_tenants: list[str] = field(default_factory=list)
    group_wire_bytes: list[float] = field(default_factory=list)
    # -- fault-injection accounting (populated only when faults= is given) ---
    failed_groups: list[tuple[int, float]] = field(default_factory=list)
    group_retries: list[int] = field(default_factory=list)
    # -- admission/load-shedding accounting (only when admission= is given) --
    shed_groups: list[tuple[int, float]] = field(default_factory=list)

    def avg_bw_utilization(self, topology: Topology) -> float:
        """Weighted average BW utilization (weights = per-dim BW budget).

        An empty/zero-makespan run moved no bytes over no time — that is
        zero utilization, not perfect utilization.
        """
        if self.makespan <= 0:
            return 0.0
        total_bw = topology.total_bw_bytes
        moved = sum(self.dim_wire_bytes)
        return moved / (self.makespan * total_bw)

    def activity_rate(self, dim: int) -> float:
        if self.makespan <= 0:
            return 0.0
        return sum(e - s for s, e in self.dim_activity[dim]) / self.makespan

    def group_span(self, group: int) -> float:
        """Issue-to-completion latency of one collective."""
        return self.group_finish[group] - self.group_issue[group]

    def _group_tags(self, by: str) -> list[str]:
        if by == "tenant":
            tags = self.group_tenants
        elif by == "stream":
            tags = self.group_streams
        else:
            raise ValueError(f"by must be 'stream' or 'tenant', got {by!r}")
        if not tags:  # plain simulate() call without request tags
            tags = ["default"] * len(self.group_finish)
        return tags

    def stream_stats(self, by: str = "stream") -> dict[str, StreamStats]:
        """Aggregate per-stream (or per-tenant, ``by='tenant'``) metrics:
        finish time, issue-to-finish latency, and wire bytes moved."""
        tags = self._group_tags(by)
        members: dict[str, list[int]] = {}
        for g, tag in enumerate(tags):
            members.setdefault(tag, []).append(g)
        wire = self.group_wire_bytes or [0.0] * len(tags)
        # Failed (faults) and shed (admission) groups never finished —
        # their stale finish==issue entries would read as zero latency and
        # poison the percentiles, so latency/finish aggregate over live
        # groups only.  A tag whose groups all died reports the explicit
        # n_live=0 sentinel with zeroed aggregates (no NaN / IndexError).
        dead = {g for g, _ in self.failed_groups}
        dead.update(g for g, _ in self.shed_groups)
        out: dict[str, StreamStats] = {}
        for tag, gs in members.items():
            live = [g for g in gs if g not in dead] if dead else gs
            # Pure compute groups (no wire moved) finish at their issue
            # instant; counting their zero latencies would drag a traffic
            # graph's per-tenant percentiles toward 0, so latency aggregates
            # only over wire-moving groups (all groups when none moved wire,
            # e.g. a compute-only stream or an untagged simulate() call).
            lat_gs = [g for g in live if wire[g] > 0] or live
            lat = [self.group_finish[g] - self.group_issue[g]
                   for g in lat_gs]
            lat_sorted = sorted(lat)
            out[tag] = StreamStats(
                n=len(gs),
                issue_first=min(self.group_issue[g] for g in gs),
                finish=max(self.group_finish[g] for g in live)
                if live else 0.0,
                latency_mean=sum(lat) / len(lat) if lat else 0.0,
                latency_max=lat_sorted[-1] if lat_sorted else 0.0,
                wire_bytes=sum(wire[g] for g in gs),
                latency_p50=_percentile(lat_sorted, 0.50),
                latency_p95=_percentile(lat_sorted, 0.95),
                latency_p99=_percentile(lat_sorted, 0.99),
                n_live=len(live) if dead else -1,
            )
        return out

    def stream_finish(self, tag: str, by: str = "stream") -> float:
        """Finish time of the last request carrying ``tag``."""
        return self.stream_stats(by)[tag].finish

    def finish_time(self) -> float:
        """Finish time of the last request (drain point of all streams)."""
        return max(self.group_finish) if self.group_finish else self.makespan

    def diff_fields(self, other: "SimResult") -> list[str]:
        """Names of fields that differ from ``other`` — the single source of
        truth for the engine bit-equivalence gate (benchmarks and tests both
        assert this returns [])."""
        import dataclasses

        return [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name) != getattr(other, f.name)]

    def groups_interleave_on(self, dim: int) -> bool:
        """True if the service order on ``dim`` switches between distinct
        groups and back — i.e. collectives genuinely contend rather than
        running back-to-back.  A batch fusing several groups also counts."""
        seen_transitions: set[tuple[int, int]] = set()
        prev: int | None = None
        for _, _, groups in self.dim_services[dim]:
            if len(groups) > 1:
                return True
            g = groups[0]
            if prev is not None and g != prev:
                if (g, prev) in seen_transitions:
                    return True  # came back to an earlier group: A..B..A
                seen_transitions.add((prev, g))
            prev = g
        return False


class TaskArrays:
    """Struct-of-arrays task storage for the indexed engine.

    Everything here is immutable during a simulation run (the run-varying
    arrival-seq array is allocated per run), so one ``TaskArrays`` may be
    shared by many ``simulate()`` calls over the same chunk groups —
    ``repro_torch.core.batch`` builds these once per scenario family and replays
    them across seeds/disciplines/arbiters.  ``group_wire`` is copied into
    each ``SimResult`` so callers can't corrupt the shared arrays.
    """

    __slots__ = ("n_tasks", "chunk", "stage", "dim", "wire", "fixed",
                 "group", "prio", "tenant", "last", "first_handles",
                 "group_wire", "fingerprint", "_validated_groups",
                 "_np_cols", "_pairs", "_cls_cache")

    def __init__(self, n_tasks, chunk, stage, dim, wire, fixed, group,
                 prio, tenant, last, first_handles, group_wire,
                 fingerprint=None):
        self.n_tasks = n_tasks
        self.chunk = chunk
        self.stage = stage
        self.dim = dim
        self.wire = wire
        self.fixed = fixed
        self.group = group
        self.prio = prio
        self.tenant = tenant
        self.last = last
        self.first_handles = first_handles
        self.group_wire = group_wire
        self.fingerprint = fingerprint
        self._validated_groups = None  # last chunk_groups that passed the
        #                                simulate() fingerprint check
        self._np_cols = None  # compiled-engine numpy column cache
        self._pairs = None  # compiled-engine (chunk, stage) tuple cache
        self._cls_cache = None  # compiled-engine size-class discovery cache


def task_arrays_fingerprint(
    chunk_groups: list[list[Chunk]],
    priorities: list[int],
    tenants: list[str],
) -> int:
    """Cheap content hash of everything a :class:`TaskArrays` is built
    from.  ``simulate(task_arrays=...)`` recomputes it to reject a replay
    against a *different* chunk-group family — counts alone would accept a
    same-shaped stream of different sizes/schedules and silently produce
    wrong results."""
    return hash((tuple(priorities), tuple(tenants),
                 tuple((c.index, c.size_bytes, tuple(c.schedule))
                       for g in chunk_groups for c in g)))


def stage_sequence(
    stage_tables, size_bytes: float, schedule
) -> tuple[list[int], list[float], list[float]]:
    """(dims, wire bytes, fixed delays) of one chunk's stages.

    THE scalar stage-transition float sequence — the same expressions as
    :func:`repro_torch.core.latency_model.stage_transition`, evaluated in
    schedule order via the flat stage tables.  Both SoA builders (the
    scalar :func:`build_task_arrays` and the vectorized one in
    ``repro_torch.core.batch``) call this single definition, which is what keeps
    them bit-identical; never duplicate this loop.
    """
    tbl = stage_tables
    rs_phase = Phase.RS
    dims: list[int] = []
    wires: list[float] = []
    fixeds: list[float] = []
    size = size_bytes
    for phase, dim in schedule:
        n = tbl.npus[dim]
        if n <= 1:
            wire = 0.0
        elif phase == rs_phase:
            wire = tbl.rs_wire[dim] * size
            size = size / n
        else:
            wire = tbl.ag_wire[dim] * size
            size = size * n
        dims.append(dim)
        wires.append(wire)
        fixeds.append(tbl.rs_step[dim] if phase == rs_phase
                      else tbl.ag_step[dim])
    return dims, wires, fixeds


def build_task_arrays(
    latency_model: LatencyModel,
    chunk_groups: list[list[Chunk]],
    priorities: list[int],
    tenants: list[str],
) -> TaskArrays:
    """Scalar SoA build — the exact float sequence of the indexed engine.

    One flat pass over every chunk stage (:func:`stage_sequence`), so wire
    bytes and fixed delays are bit-identical to the reference engine's
    :func:`_build_tasks`.  The vectorized equivalent lives in
    ``repro_torch.core.batch``.
    """
    tbl = latency_model.stage_tables
    n_groups = len(chunk_groups)
    n_tasks = sum(len(c.schedule) for g in chunk_groups for c in g)
    t_chunk = [0] * n_tasks    # global chunk id
    t_stage = [0] * n_tasks
    t_dim = [0] * n_tasks
    t_wire = [0.0] * n_tasks
    t_fixed = [0.0] * n_tasks
    t_group = [0] * n_tasks
    t_prio = [0] * n_tasks
    t_tenant = [""] * n_tasks
    t_last = [False] * n_tasks  # final stage of its chunk's chain?
    first_handles: list[int] = []   # stage-0 handle per chunk, build order
    group_wire = [0.0] * n_groups
    h = 0
    offset = 0  # global chunk-id offset, same scheme as the reference engine
    for g, group in enumerate(chunk_groups):
        prio = priorities[g]
        tenant = tenants[g]
        gw = 0.0
        for chunk in group:
            sched = chunk.schedule
            cid = chunk.index + offset
            if sched:
                first_handles.append(h)
            dims, wires, fixeds = stage_sequence(tbl, chunk.size_bytes,
                                                 sched)
            for s in range(len(sched)):
                t_chunk[h] = cid
                t_stage[h] = s
                t_dim[h] = dims[s]
                wire = wires[s]
                t_wire[h] = wire
                t_fixed[h] = fixeds[s]
                t_group[h] = g
                t_prio[h] = prio
                t_tenant[h] = tenant
                gw += wire
                h += 1
            if sched:
                t_last[h - 1] = True
        group_wire[g] = gw
        if group:
            offset += max(c.index for c in group) + 1
    return TaskArrays(n_tasks, t_chunk, t_stage, t_dim, t_wire, t_fixed,
                      t_group, t_prio, t_tenant, t_last, first_handles,
                      group_wire,
                      task_arrays_fingerprint(chunk_groups, priorities,
                                              tenants))


def _build_tasks(
    latency_model: LatencyModel,
    chunks: list[Chunk],
    id_offset: int = 0,
    group: int = 0,
    priority: int = 0,
    tenant: str = "default",
) -> dict[OpId, StageTask]:
    tasks: dict[OpId, StageTask] = {}
    for chunk in chunks:
        size = chunk.size_bytes
        cid = chunk.index + id_offset
        for s, (phase, dim) in enumerate(chunk.schedule):
            wire, size = latency_model.stage_wire_bytes(dim, phase, size)
            tasks[(cid, s)] = StageTask(
                chunk_id=cid,
                stage_idx=s,
                dim=dim,
                wire_bytes=wire,
                fixed_delay=latency_model.step_delay(dim, phase),
                group=group,
                priority=priority,
                tenant=tenant,
            )
    return tasks


def _resolve_penalty(preempt_penalty_s: float | None, arbiter) -> float:
    """Explicit argument wins; otherwise the arbiter's attribute; else 0."""
    if preempt_penalty_s is None:
        preempt_penalty_s = getattr(arbiter, "preempt_penalty_s", 0.0) or 0.0
    if preempt_penalty_s < 0:
        raise ValueError("preempt_penalty_s must be >= 0")
    return preempt_penalty_s


# Arguments that need a package the port does not carry yet (ROADMAP §1
# item 1d), with the package each needs.
_UNPORTED = {"admission": "fleet"}


def _refuse_unported(**given) -> None:
    """Raise ``NotImplementedError`` for the first argument of ``given``
    that is set: each needs a package the port does not carry yet."""
    for arg, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"{arg}= needs repro_torch.{_UNPORTED[arg]}, which the port "
                "does not carry yet (ROADMAP §1 item 1d)")


def _arbiter_indexable(arbiter) -> bool:
    """Can the indexed engine replicate this arbiter's queue ordering?

    The indexed engine never calls ``order_key`` — it hardcodes each known
    policy's canonical key into its bucket heaps — so it may only take
    arbiters whose ``order_key`` is the stock ``FabricArbiter`` one.  A
    subclass overriding ``order_key`` (or any non-FabricArbiter duck type)
    falls back to the reference engine, which honors arbitrary keys.  The
    remaining hooks (``should_preempt``/``on_served``/...) are invoked on
    both engines, so overriding those stays indexable.
    """
    if getattr(arbiter, "policy", None) not in _INDEXABLE_ARBITER_POLICIES:
        return False
    # Lazy import: repro_torch.tenancy depends on repro_torch.core, not vice
    # versa.  An arbiter of another package (the reference's) is not this
    # FabricArbiter, so it runs on the reference engine.
    from repro_torch.tenancy.arbiter import FabricArbiter

    return (isinstance(arbiter, FabricArbiter)
            and type(arbiter).order_key is FabricArbiter.order_key)


def simulate(
    topology: Topology,
    chunk_groups: list[list[Chunk]],
    *,
    issue_times: list[float] | None = None,
    priorities: list[int] | None = None,
    intra: str = "SCF",
    fusion: bool = True,
    fusion_limit: int = 8,
    enforced_order: list[list[OpId]] | None = None,
    jitter: float = 0.0,
    seed: int = 0,
    tenants: list[str] | None = None,
    streams: list[str] | None = None,
    arbiter=None,
    preempt_penalty_s: float | None = None,
    engine: str = "indexed",
    task_arrays: TaskArrays | None = None,
    deps: list[tuple[int, ...]] | None = None,
    dep_delay_s: list[float] | None = None,
    check_invariants: bool = False,
    tracer=None,
    faults=None,
    replanner=None,
    admission=None,
) -> SimResult:
    """Simulate one or more collectives (``chunk_groups``).

    ``issue_times``: per-group arrival time (seconds); default all 0.0.
        A group's chunks become ready only once its collective is issued,
        so staggered groups overlap and contend on shared dims.
    ``priorities``: per-group service priority (higher first within a dim's
        ready queue; default all equal).
    ``intra``: 'FIFO' | 'SCF' intra-dimension discipline (Sec. 4.3).
    ``fusion``: fuse ops that cannot individually saturate a dim's BW.
    ``enforced_order``: per-dim list of op ids that must be served in order
        (Sec. 4.6.2); a dim idles rather than serving out of turn.
    ``jitter``: multiplicative service-time noise amplitude (consistency
        experiments; deterministic given ``seed``).
    ``tenants``/``streams``: per-group tags for multi-tenant attribution
        (``SimResult.stream_stats``).
    ``arbiter``: inter-tenant queue discipline + preemption policy (see
        ``repro_torch.tenancy.FabricArbiter``).  When set it replaces the
        ``intra`` ordering, batches same-tenant chunks into multi-chunk
        services (up to ``arbiter.quantum_chunks``), and — if
        ``arbiter.preemption`` — may split an in-flight service at chunk
        granularity, requeueing chunks whose data has not started draining.
        Mutually exclusive with ``enforced_order``.
    ``preempt_penalty_s``: re-arm latency charged to preempted chunks — they
        re-arrive ``penalty`` seconds after the split instead of instantly.
        ``None`` defers to ``arbiter.preempt_penalty_s`` (default 0.0:
        splits are free, the pre-penalty behavior).
    ``engine``: 'indexed' (default; near-linear in stage-ops),
        'compiled' (the cohort-vectorized fast-path engine in
        ``repro_torch.core.engine_compiled``; ~10x indexed throughput on
        no-preemption streams), or 'reference' (the original
        O(n^2)-per-dim loop, kept as the differential-testing oracle).
        All three produce bit-identical results on their shared domain.
        Fallbacks are automatic and warning-free: a custom arbiter the
        indexed engine cannot bucket-index falls back to 'reference',
        and a fast-path-ineligible feature (``arbiter``,
        ``enforced_order``, ``faults``, ``admission``, ``tracer``,
        ``replanner``, ``check_invariants``) with ``engine="compiled"``
        falls back to 'indexed' — the documented signal is
        ``repro_torch.core.engine_compiled.LAST_FALLBACK`` /
        ``FALLBACK_COUNTS`` plus the ``simulate.compiled.fallback``
        metrics counter.  An unknown engine name raises ``ValueError``
        listing the valid engines.
    ``task_arrays``: advanced — a prebuilt :class:`TaskArrays` for exactly
        these ``chunk_groups``/``priorities``/``tenants`` (see
        :func:`build_task_arrays`).  ``repro_torch.core.batch`` passes this to
        replay one SoA build across many scenarios; ignored when the
        reference engine runs (it rebuilds its own task dict).
    ``deps``: per-group tuple of predecessor group indices — dependency-
        gated issue.  A group with predecessors ignores its static issue
        time as a trigger: it becomes eligible at
        ``max(issue_times[g], latest predecessor finish + dep_delay_s[g])``
        once *all* its predecessors have fully finished (every chunk chain
        retired).  A group without predecessors issues at
        ``issue_times[g] + dep_delay_s[g]``.  Groups with an empty chunk
        list are pure compute nodes: they finish at their eligibility
        instant and exist only to gate dependents.  ``None`` (default) is
        the fixed-time mode — bit-identical to the pre-dependency engine,
        as is a ``deps`` list whose entries are all empty with zero delays.
        The graph must be acyclic (a cycle raises once the event stream
        drains).  ``SimResult.group_issue`` reports the resolved times.
    ``dep_delay_s``: per-group compute delay (seconds) between the gating
        event and the group's issue; requires ``deps``.
    ``check_invariants``: arm the runtime invariant sanitizer
        (``repro_torch.core.invariants``) inside the event loop of either engine:
        bytes conservation across preemption splits, per-dim service
        ordering, work conservation at every event boundary, and (under an
        arbiter) the served-bytes ledger vs the engine's wire accounting —
        the ledger check assumes the arbiter's pre-existing state is the
        ``served_snapshot()`` taken at entry, so reuse across calls is
        fine.  Violations raise
        :class:`repro_torch.core.invariants.InvariantViolation`.  Off (default)
        costs one branch per event.
    ``tracer``: arm the flight recorder (:class:`repro_torch.obs.Tracer`) inside
        either engine.  Records every service start/finish/preempt, ready-
        queue arrival, arbiter grant, dependency-edge resolution and group
        release; export via ``tracer.to_chrome_trace()`` or derive
        timelines with ``repro_torch.obs.BwTimeline.from_tracer``.  Hooks are
        append-only (no tie-break/RNG consumption), so a traced run's
        result is bit-identical to the untraced run; off (default) costs
        one branch per event, same contract as ``check_invariants``.  One
        tracer records exactly one run.
    ``faults``: a :class:`repro_torch.faults.FaultSchedule` (or a pre-compiled
        ``CompiledFaults``) injected into either engine as a fourth event
        class.  At each fault boundary the affected dim's effective BW is
        rescaled: an in-flight service is *re-rated* (bytes already drained
        are conserved, the remainder continues at the new rate), future
        services start at the degraded rate, and straggler-burst windows
        layer extra lognormal sigma on service times.  A fully-out dim cuts
        its in-flight service at chunk granularity (undrained chunks
        requeue) and queued chunks follow the schedule's
        :class:`~repro_torch.faults.RetryPolicy`: timeout, exponential backoff
        with jitter drawn from the simulation RNG, and after
        ``max_attempts`` the chunk's whole request group is marked failed
        (``SimResult.failed_groups``; its unserved work is abandoned and
        dependents of a failed group fail transitively).  ``None``
        (default) is byte-for-byte the fault-free engine.  Mutually
        exclusive with ``enforced_order``.
    ``replanner``: graceful-degradation hook (see
        :func:`repro_torch.faults.make_replanner`), called at every BW-changing
        fault boundary with ``(now, factors, pending)`` where ``pending``
        lists the not-yet-started groups; it returns re-planned chunk
        schedules computed against the degraded fabric, which the engine
        applies to those groups' un-issued work.  Requires ``faults``.
    ``admission``: an admission controller / load shedder (see
        :class:`repro.fleet.AdmissionController`) consulted at each
        group's *first* ready event.  A shed group's queued chunks are
        purged, its unstarted work never issues, and dependents it gates
        are shed with it (shedding a request unit drops the whole unit);
        outcomes land in ``SimResult.shed_groups`` — demand-side losses,
        distinct from the fault fabric's ``failed_groups``.  The
        controller is driven identically (same call sites, same event
        order) by both engines and must consume no RNG, so admission
        runs stay bit-identical indexed vs reference.  Requires
        ``deps`` (admission units are dependency components); mutually
        exclusive with ``enforced_order`` for the same deadlock reason
        as faults.  ``None`` (default) is byte-for-byte the
        admission-free engine.
    """
    _refuse_unported(admission=admission)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; want {ENGINES}")
    n_groups = len(chunk_groups)
    if n_groups and isinstance(chunk_groups[0], Chunk):
        raise TypeError(
            "simulate() expected a list of chunk groups (list[list[Chunk]]), "
            "got a flat chunk list; wrap it in [chunks]")
    if issue_times is None:
        issue_times = [0.0] * n_groups
    if priorities is None:
        priorities = [0] * n_groups
    if len(issue_times) != n_groups or len(priorities) != n_groups:
        raise ValueError("issue_times/priorities must match chunk_groups")
    if tenants is None:
        tenants = ["default"] * n_groups
    if streams is None:
        streams = ["default"] * n_groups
    if len(tenants) != n_groups or len(streams) != n_groups:
        raise ValueError("tenants/streams must match chunk_groups")
    for g, t in enumerate(issue_times):
        if not math.isfinite(t) or t < 0:
            raise ValueError(
                f"issue_times[{g}] = {t!r}: issue times must be finite "
                "and >= 0")
    for g, group in enumerate(chunk_groups):
        for c in group:
            if not math.isfinite(c.size_bytes) or c.size_bytes < 0:
                raise ValueError(
                    f"chunk_groups[{g}] chunk {c.index}: size_bytes "
                    f"{c.size_bytes!r} must be finite and >= 0")
    if arbiter is not None and enforced_order is not None:
        raise ValueError("arbiter and enforced_order are mutually exclusive")
    if faults is not None and enforced_order is not None:
        # An enforced per-dim order would deadlock against retry/abandon
        # reordering (a failed group's ops never arrive; the dim idles
        # forever waiting its turn).  No user needs the combination.
        raise ValueError("faults and enforced_order are mutually exclusive")
    if replanner is not None and faults is None:
        raise ValueError("replanner requires faults")
    if admission is not None and deps is None:
        # Admission units are weakly-connected dependency components; a
        # dep-free run has no request structure to admit or shed.
        raise ValueError("admission requires deps")
    if admission is not None and enforced_order is not None:
        # A shed group's ops never arrive; an enforced per-dim order would
        # idle forever waiting its turn (same deadlock as faults).
        raise ValueError("admission and enforced_order are mutually "
                         "exclusive")
    flt = None
    if faults is not None:
        compile_fn = getattr(faults, "compile", None)
        flt = compile_fn(topology.num_dims) if callable(compile_fn) else faults
        if getattr(flt, "num_dims", None) != topology.num_dims:
            raise ValueError(
                f"faults were compiled for {getattr(flt, 'num_dims', None)} "
                f"dims but the topology has {topology.num_dims}")
    if dep_delay_s is not None and deps is None:
        raise ValueError("dep_delay_s requires deps")
    if deps is not None and enforced_order is not None:
        # An enforced per-dim order can idle a dim waiting for an op whose
        # group is dep-gated behind that very dim — a deadlock the end-of-
        # run cycle check would misreport.  The combination has no user
        # today (enforced orders come from fixed-stream consistency runs).
        raise ValueError("deps and enforced_order are mutually exclusive")
    if deps is not None:
        if len(deps) != n_groups:
            raise ValueError("deps must match chunk_groups")
        if dep_delay_s is None:
            dep_delay_s = [0.0] * n_groups
        elif len(dep_delay_s) != n_groups:
            raise ValueError("dep_delay_s must match chunk_groups")
        if any(d < 0 for d in dep_delay_s):
            raise ValueError("dep_delay_s entries must be >= 0")
        for g, preds in enumerate(deps):
            for p in preds:
                if not 0 <= p < n_groups or p == g:
                    raise ValueError(
                        f"group {g} has an invalid dependency {p}")
    if task_arrays is not None:
        # Replays of the same chunk_groups object (the batch path: one
        # cached TaskArrays per scenario family, many seeds) skip the
        # O(stage-ops) rehash via identity; the strong reference keeps the
        # identity valid.  Per-group tags are covered because scenarios
        # sharing a cached family share the same request tuple.
        if task_arrays._validated_groups is not chunk_groups:
            if (len(task_arrays.group_wire) != n_groups
                    or task_arrays.fingerprint != task_arrays_fingerprint(
                        chunk_groups, priorities, tenants)):
                raise ValueError(
                    "task_arrays was built for a different chunk-group "
                    "family (group count or content fingerprint mismatch); "
                    "rebuild it with build_task_arrays for exactly these "
                    "chunk_groups/priorities/tenants")
            task_arrays._validated_groups = chunk_groups
    penalty = _resolve_penalty(preempt_penalty_s, arbiter)

    # Span timing lives behind the metrics registry (repro_torch.obs); core never
    # reads the wall clock itself.  No registry installed -> nullcontext.
    reg = current_registry()
    if engine == "compiled":
        # Lazy import: engine_compiled imports this module at its top.
        from repro_torch.core import engine_compiled as _ec
        blocker = _ec.fast_path_blocker(
            arbiter=arbiter, enforced_order=enforced_order, faults=faults,
            admission=admission, tracer=tracer, replanner=replanner,
            check_invariants=check_invariants)
        if blocker is None:
            with reg.span("simulate.compiled") if reg is not None \
                    else nullcontext():
                return _ec.simulate_compiled(
                    topology, chunk_groups, issue_times=issue_times,
                    priorities=priorities, intra=intra, fusion=fusion,
                    fusion_limit=fusion_limit, jitter=jitter, seed=seed,
                    tenants=tenants, streams=streams,
                    task_arrays=task_arrays, deps=deps,
                    dep_delay=dep_delay_s)
        _ec.record_fallback(blocker)
        engine = "indexed"
    if engine == "indexed" and (arbiter is None or _arbiter_indexable(arbiter)):
        with reg.span("simulate.indexed") if reg is not None \
                else nullcontext():
            return _simulate_indexed(
                topology, chunk_groups, issue_times=issue_times,
                priorities=priorities, intra=intra, fusion=fusion,
                fusion_limit=fusion_limit, enforced_order=enforced_order,
                jitter=jitter, seed=seed, tenants=tenants, streams=streams,
                arbiter=arbiter, penalty=penalty, task_arrays=task_arrays,
                deps=deps, dep_delay=dep_delay_s, chk=check_invariants,
                tracer=tracer, faults=flt, replanner=replanner,
                admission=admission)
    with reg.span("simulate.reference") if reg is not None else nullcontext():
        return _simulate_reference(
            topology, chunk_groups, issue_times=issue_times,
            priorities=priorities, intra=intra, fusion=fusion,
            fusion_limit=fusion_limit, enforced_order=enforced_order,
            jitter=jitter, seed=seed, tenants=tenants, streams=streams,
            arbiter=arbiter, penalty=penalty, deps=deps,
            dep_delay=dep_delay_s, chk=check_invariants, tracer=tracer,
            faults=flt, replanner=replanner, admission=admission)


# ---------------------------------------------------------------------------
# Reference engine — the original list-sorting event loop (oracle).
# ---------------------------------------------------------------------------
def _simulate_reference(
    topology: Topology,
    chunk_groups: list[list[Chunk]],
    *,
    issue_times: list[float],
    priorities: list[int],
    intra: str,
    fusion: bool,
    fusion_limit: int,
    enforced_order: list[list[OpId]] | None,
    jitter: float,
    seed: int,
    tenants: list[str],
    streams: list[str],
    arbiter,
    penalty: float,
    deps: list[tuple[int, ...]] | None = None,
    dep_delay: list[float] | None = None,
    chk: bool = False,
    tracer=None,
    faults=None,
    replanner=None,
    admission=None,
) -> SimResult:
    import random

    rng = random.Random(seed)
    lm = LatencyModel.for_topology(topology)
    num_dims = topology.num_dims
    n_groups = len(chunk_groups)

    # Flight recorder (repro_torch.obs.Tracer).  Hooks are append-only and never
    # consume seq/RNG, so armed runs stay bit-identical to untraced ones.
    trc = tracer
    if trc is not None:
        trc.begin(num_dims, n_groups, "reference")
    trc_enq = trc.enq_dims.append if trc is not None else None
    trc_enq_t = trc.enq_times.append if trc is not None else None

    tasks: dict[OpId, StageTask] = {}
    group_of_chunk: dict[int, int] = {}
    group_wire = [0.0] * n_groups
    group_cid_offset = [0] * n_groups  # global chunk-id base per group
    offset = 0
    for g, group in enumerate(chunk_groups):
        group_cid_offset[g] = offset
        built = _build_tasks(lm, group, id_offset=offset, group=g,
                             priority=priorities[g], tenant=tenants[g])
        tasks.update(built)
        group_wire[g] += sum(t.wire_bytes for t in built.values())
        for c in group:
            group_of_chunk[c.index + offset] = g
        if group:
            offset += max(c.index for c in group) + 1

    # Chunk chains: stage s+1 becomes ready when stage s completes.
    chain_len: dict[int, int] = {}
    for cid, s in tasks:
        chain_len[cid] = max(chain_len.get(cid, 0), s + 1)

    queues: list[list[StageTask]] = [[] for _ in range(num_dims)]
    busy_until = [0.0] * num_dims
    dim_busy = [0.0] * num_dims
    dim_wire = [0.0] * num_dims
    dim_order: list[list[OpId]] = [[] for _ in range(num_dims)]
    dim_services: list[list[ServiceInterval]] = [[] for _ in range(num_dims)]
    activity: list[list[tuple[float, float]]] = [[] for _ in range(num_dims)]
    pending_since = [None] * num_dims  # type: list[float | None]
    enforced_pos = [0] * num_dims
    group_finish = [t for t in issue_times]  # empty groups finish at issue
    resolved_issue = list(issue_times)       # dep mode: actual issue times
    straggler = [d.straggler_sigma for d in topology.dims]
    seq = itertools.count()

    # In-flight services, keyed by validity token (sid).  Preemption bumps a
    # service's sid so its already-scheduled free/done events become stale.
    services: dict[int, _Service] = {}
    inflight: list[_Service | None] = [None] * num_dims
    use_enforced = enforced_order is not None

    # Arrival hook (the fair-policy virtual-time clamp) + sanitizer baseline.
    on_enq = getattr(arbiter, "on_enqueued", None)
    served_base = (arbiter.served_snapshot()
                   if chk and hasattr(arbiter, "served_snapshot") else None)

    # Event heap: (time, tiebreak, kind, payload)
    events: list[tuple[float, int, str, object]] = []

    def push_ready(task: StageTask, t: float) -> None:
        task.ready_time = t
        task.arrival_seq = next(seq)
        heapq.heappush(events, (t, task.arrival_seq, "ready", task))

    # -- fault injection (repro_torch.faults) --------------------------------------
    # Every fault structure and closure lives behind this one guard; when
    # ``flt`` is None the engine touches none of it (the fault-free path is
    # byte-for-byte the pre-fault engine — no extra seq/RNG consumption).
    flt = faults
    if flt is not None:
        flt_retry = flt.retry
        flt_bounds = flt.boundaries
        cur_factor = [1.0] * num_dims   # current BW multiplier per dim
        cur_sigma = [0.0] * num_dims    # extra straggler sigma per dim
        dim_down = [False] * num_dims
        group_started = [False] * n_groups  # any ready event popped yet?
        group_failed = [False] * n_groups
        group_retries = [0] * n_groups
        failed_log: list[tuple[int, float]] = []
        flt_att: dict[OpId, int] = {}   # retry attempts per op
        flt_ep: dict[OpId, int] = {}    # queue-residency epoch per op

        def flt_enq(task: StageTask, now: float) -> None:
            # New queue residency: bump the op's epoch (invalidating any
            # armed timeout) and, on a down dim, arm the retry timeout.
            op = task.op_id
            ep = flt_ep.get(op, 0) + 1
            flt_ep[op] = ep
            if dim_down[task.dim]:
                heapq.heappush(events, (now + flt_retry.timeout_s,
                                        next(seq), "timeout", (task, ep)))

        def flt_fail(g0: int, now: float) -> None:
            # Exhausted retries: fail the group, purge its queued work, and
            # fail dependents transitively (they can never be released).
            work = [g0]
            while work:
                g = work.pop()
                if group_failed[g] or (adm is not None and group_shed[g]):
                    continue  # a shed group's work is already gone
                group_failed[g] = True
                failed_log.append((g, now))
                if trc is not None:
                    trc.group_failed(g, now)
                for d in range(num_dims):
                    q = queues[d]
                    kept = [t for t in q if t.group != g]
                    if len(kept) != len(q):
                        for t in q:
                            if t.group == g:
                                flt_ep[t.op_id] = flt_ep.get(t.op_id, 0) + 1
                        queues[d][:] = kept
                if use_deps:
                    work.extend(dep_children[g])

        def flt_requeue(cut: list, now: float) -> None:
            for t in cut:
                if group_failed[t.group]:
                    continue
                queues[t.dim].append(t)
                if trc_enq is not None:
                    trc_enq(t.dim)
                    trc_enq_t(now)
                if on_enq is not None:
                    on_enq(t.dim, t.tenant, now)
                flt_enq(t, now)

        def flt_abort(dim: int, svc: _Service, now: float) -> None:
            # Outage hit an in-flight service: chunks whose data already
            # drained complete, the rest are cut and requeued — the same
            # byte-conserving split rule as arbiter preemption, except the
            # keep set may be empty (nothing drained yet).
            nonlocal makespan
            elapsed_bytes = (now - svc.start) * svc.rate
            keep: list[StageTask] = []
            acc = 0.0
            for t in svc.batch:
                if acc + t.wire_bytes > elapsed_bytes:
                    break
                keep.append(t)
                acc += t.wire_bytes
            cut = svc.batch[len(keep):]
            if not cut:
                return
            makespan = max(makespan, now)
            cut_wire = sum(t.wire_bytes for t in cut)
            dim_busy[dim] -= svc.end - now
            dim_wire[dim] -= cut_wire
            busy_until[dim] = now
            cut_ids = {t.op_id for t in cut}
            dim_order[dim] = [o for o in dim_order[dim] if o not in cut_ids]
            s0 = dim_services[dim][svc.svc_idx][0]
            groups_kept = (tuple(sorted({t.group for t in keep})) if keep
                           else dim_services[dim][svc.svc_idx].groups)
            dim_services[dim][svc.svc_idx] = ServiceInterval(
                s0, now, groups_kept)
            if trc is not None:
                trc.service_abort(dim, svc.svc_idx, now, len(keep),
                                  tuple(t.op_id for t in cut), cut_wire)
            services.pop(svc.sid)
            if keep:
                svc.sid = next(seq)
                svc.end = now
                svc.batch = keep
                services[svc.sid] = svc
                a = max(t.fixed_delay for t in keep)
                heapq.heappush(events, (now, next(seq), "free",
                                        (dim, svc.sid)))
                heapq.heappush(events, (now + a, next(seq), "done",
                                        (dim, svc.sid)))
            else:
                inflight[dim] = None
            flt_requeue(cut, now)
            if arbiter is not None:
                arbiter.on_preempted(dim, cut, now)

        def flt_outage_start(dim: int, now: float) -> None:
            # Arm retry timeouts for chunks already queued on the dim (the
            # in-flight cut below re-enters through flt_requeue -> flt_enq,
            # which arms its own), then cut the in-flight service.
            for t in sorted(queues[dim], key=lambda t: t.arrival_seq):
                heapq.heappush(events, (now + flt_retry.timeout_s,
                                        next(seq), "timeout",
                                        (t, flt_ep.get(t.op_id, 0))))
            svc = inflight[dim]
            if svc is not None and svc.end > now:
                flt_abort(dim, svc, now)

        def flt_recover(dim: int, now: float) -> None:
            # Invalidate every armed timeout on the dim: its queued chunks
            # are serviceable again.
            for t in queues[dim]:
                flt_ep[t.op_id] = flt_ep.get(t.op_id, 0) + 1

        def flt_timeout(task: StageTask, ep: int, now: float) -> None:
            op = task.op_id
            if (flt_ep.get(op, 0) != ep or group_failed[task.group]
                    or not dim_down[task.dim]):
                return  # stale arm: the chunk moved, failed, or recovered
            att = flt_att.get(op, 0) + 1
            flt_att[op] = att
            group_retries[task.group] += 1
            if att >= flt_retry.max_attempts:
                if trc is not None:
                    trc.retry(task.dim, op, now, att, now)
                flt_fail(task.group, now)
                return
            queues[task.dim].remove(task)
            delay = flt_retry.backoff_s * flt_retry.multiplier ** (att - 1)
            if flt_retry.jitter > 0.0:
                delay *= 1.0 + flt_retry.jitter * rng.random()
            if trc is not None:
                trc.retry(task.dim, op, now, att, now + delay)
            push_ready(task, now + delay)

        def flt_rerate(dim: int, svc: _Service, now: float,
                       scale: float) -> None:
            # BW changed under an in-flight service: bytes already drained
            # are conserved (virtual-start shift), the remainder continues
            # at the new rate.  ``scale`` is old_factor / new_factor.
            new_end = now + (svc.end - now) * scale
            dim_busy[dim] += new_end - svc.end
            busy_until[dim] = new_end
            svc.start = now - (now - svc.start) * scale
            svc.rate = svc.rate / scale
            iv = dim_services[dim][svc.svc_idx]
            dim_services[dim][svc.svc_idx] = ServiceInterval(
                iv.start, new_end, iv.groups)
            if trc is not None:
                trc.service_rerate(dim, svc.svc_idx, now, new_end, scale)
            services.pop(svc.sid)
            svc.sid = next(seq)
            svc.end = new_end
            services[svc.sid] = svc
            a = max(t.fixed_delay for t in svc.batch)
            heapq.heappush(events, (new_end, next(seq), "free",
                                    (dim, svc.sid)))
            heapq.heappush(events, (new_end + a, next(seq), "done",
                                    (dim, svc.sid)))

        def flt_replan(now: float) -> None:
            # Graceful degradation: recompute the paper's load-balancing
            # objective for every not-yet-started group against the
            # current per-dim BW and rewrite those groups' stage tasks.
            # Deterministic, no seq/RNG — both engines stay in lockstep.
            pend = [g for g in range(n_groups)
                    if not group_started[g] and not group_failed[g]
                    and (adm is None or not group_shed[g])
                    and chunk_groups[g]]
            if not pend:
                return
            pend.sort(key=lambda g: (resolved_issue[g], g))
            new_map = replanner(
                now, list(cur_factor),
                [(g, resolved_issue[g], chunk_groups[g]) for g in pend])
            applied = []
            for g in pend:
                new_chunks = new_map.get(g)
                if new_chunks is None:
                    continue
                old = chunk_groups[g]
                if len(new_chunks) != len(old):
                    raise ValueError(
                        f"replanner changed group {g}'s chunk count "
                        f"({len(old)} -> {len(new_chunks)})")
                gw = 0.0
                for oc, nc in zip(old, new_chunks):
                    if len(nc.schedule) != len(oc.schedule):
                        raise ValueError(
                            f"replanner changed group {g} chunk "
                            f"{oc.index}'s stage count")
                    dims_, wires_, fixeds_ = stage_sequence(
                        lm.stage_tables, oc.size_bytes, nc.schedule)
                    cid = oc.index + group_cid_offset[g]
                    for s in range(len(dims_)):
                        t = tasks[(cid, s)]
                        t.dim = dims_[s]
                        t.wire_bytes = wires_[s]
                        t.fixed_delay = fixeds_[s]
                        gw += wires_[s]
                group_wire[g] = gw
                applied.append(g)
            if trc is not None and applied:
                trc.replan(now, tuple(applied), tuple(cur_factor))

        def flt_boundary(bi: int, now: float) -> None:
            b = flt_bounds[bi]
            d = b.dim
            old_f = cur_factor[d]
            cur_factor[d] = b.factor
            cur_sigma[d] = b.sigma
            if trc is not None:
                trc.fault(d, now, b.factor, b.sigma)
            if b.down_start:
                dim_down[d] = True
                flt_outage_start(d, now)
            elif b.down_end:
                dim_down[d] = False
                flt_recover(d, now)
            elif b.bw_change:
                svc = inflight[d]
                if svc is not None and svc.end > now:
                    flt_rerate(d, svc, now, old_f / b.factor)
            if replanner is not None and b.bw_change:
                flt_replan(now)
            if b.down_end:
                try_start(d, now)

        # Boundaries enter the heap before any ready push, so at equal
        # timestamps a fault is applied before arrivals are served — the
        # indexed engine pushes in the same order (lockstep tie-breaks).
        for bi in range(len(flt_bounds)):
            heapq.heappush(events, (flt_bounds[bi].t, next(seq),
                                    "fault", bi))

    # -- admission control / load shedding (repro.fleet) ---------------------
    # The controller is consulted at each group's *first* ready pop — ready
    # pops are time-ordered and identical across engines, and the controller
    # consumes no seq/RNG, so shed sets are bit-identical by construction.
    # Victims are always pure queue residents (their unit never reached
    # service), so shedding purges queues and skips future events — nothing
    # in flight is ever cut.  When ``adm`` is None none of this state exists.
    adm = admission
    if adm is not None:
        adm.begin(n_groups, "reference")
        group_shed = [False] * n_groups
        adm_started = [False] * n_groups   # first ready pop seen?
        adm_first_svc = [False] * n_groups  # first service seen?
        shed_log: list[tuple[int, float]] = []

        def adm_apply(victims, now: float) -> None:
            # Shed the victim groups, purge their queued chunks, and shed
            # dependents transitively (a gated dependent can never issue).
            work = list(victims)
            while work:
                g = work.pop()
                if group_shed[g] or (flt is not None and group_failed[g]):
                    continue
                group_shed[g] = True
                shed_log.append((g, now))
                if trc is not None:
                    trc.group_shed(g, now)
                for d in range(num_dims):
                    q = queues[d]
                    kept = [t for t in q if t.group != g]
                    if len(kept) != len(q):
                        if flt is not None:
                            # Invalidate any armed retry timeouts.
                            for t in q:
                                if t.group == g:
                                    flt_ep[t.op_id] = (
                                        flt_ep.get(t.op_id, 0) + 1)
                        queues[d][:] = kept
                work.extend(dep_children[g])

    use_deps = deps is not None
    if use_deps:
        # Dependency-gated release.  A group's chunks enter the event stream
        # only once every predecessor group has fully finished (all chunk
        # chains retired) plus the group's compute delay.  Empty groups are
        # pure compute nodes: they finish at their eligibility instant and
        # cascade to their dependents immediately.
        group_roots: list[list[StageTask]] = [[] for _ in range(n_groups)]
        for cid in chain_len:
            group_roots[group_of_chunk[cid]].append(tasks[(cid, 0)])
        dep_children: list[list[int]] = [[] for _ in range(n_groups)]
        n_parents = [len(preds) for preds in deps]
        for g, preds in enumerate(deps):
            for p in preds:
                dep_children[p].append(g)
        parent_fin = [0.0] * n_groups   # running max of predecessor finishes
        chains_left = [len(group_roots[g]) for g in range(n_groups)]

        def complete_group(g: int, t: float) -> None:
            """Group ``g`` fully finished at ``t``: release newly-eligible
            dependents (empty dependents finish instantly and cascade)."""
            work = [(g, t)]
            while work:
                gg, tt = work.pop(0)
                if adm is not None:
                    adm.on_finish(gg, tt)
                for c in dep_children[gg]:
                    if trc is not None:
                        trc.dep_resolved(gg, c, tt)
                    if parent_fin[c] < tt:
                        parent_fin[c] = tt
                    n_parents[c] -= 1
                    if n_parents[c]:
                        continue
                    te = max(issue_times[c], parent_fin[c] + dep_delay[c])
                    resolved_issue[c] = te
                    if trc is not None:
                        trc.release(c, te)
                    if chains_left[c]:
                        for task in group_roots[c]:
                            push_ready(task, te)
                    else:
                        group_finish[c] = te
                        work.append((c, te))

        for g in range(n_groups):
            if deps[g]:
                continue
            te = issue_times[g] + dep_delay[g]
            resolved_issue[g] = te
            if trc is not None:
                trc.release(g, te)
            if chains_left[g]:
                for task in group_roots[g]:
                    push_ready(task, te)
            else:
                group_finish[g] = te
                complete_group(g, te)
    else:
        for cid in chain_len:
            push_ready(tasks[(cid, 0)], issue_times[group_of_chunk[cid]])

    def select_batch(dim: int, now: float) -> list[StageTask]:
        q = queues[dim]
        if not q:
            return []
        if arbiter is not None:
            # Inter-tenant discipline: the arbiter orders the ready queue;
            # same-tenant chunks batch into one multi-chunk (preemptible)
            # service up to the arbiter's quantum.
            q.sort(key=lambda t: arbiter.order_key(t, dim, now))
            batch = [q[0]]
            limit = max(1, getattr(arbiter, "quantum_chunks", 1))
            for t in q[1:]:
                if len(batch) >= limit:
                    break
                if t.tenant == batch[0].tenant:
                    batch.append(t)
            for t in batch:
                q.remove(t)
            return batch
        if enforced_order is not None:
            order = enforced_order[dim]
            pos = enforced_pos[dim]
            if pos >= len(order):
                return []
            want = order[pos]
            head = [t for t in q if t.op_id == want]
            if not head:
                return []  # idle until the mandated op arrives
            batch = [head[0]]
        else:
            if intra == "SCF":
                q.sort(key=lambda t: (-t.priority, t.wire_bytes, t.arrival_seq))
            else:  # FIFO
                q.sort(key=lambda t: (-t.priority, t.arrival_seq))
            batch = [q[0]]
        if fusion:
            bw = topology.dims[dim].aggr_bw_bytes
            sat_bytes = batch[0].fixed_delay * bw  # wire time < A  => unsaturated
            total = batch[0].wire_bytes
            if total < sat_bytes:
                pool = (
                    enforced_candidates(dim, batch[0])
                    if enforced_order is not None
                    else [t for t in q if t is not batch[0]]
                )
                for t in pool:
                    if len(batch) >= fusion_limit or total >= sat_bytes:
                        break
                    batch.append(t)
                    total += t.wire_bytes
        for t in batch:
            q.remove(t)
        if enforced_order is not None:
            enforced_pos[dim] += len(batch)
        return batch

    def enforced_candidates(dim: int, first: StageTask) -> list[StageTask]:
        """Ops that may fuse after ``first`` without violating the order."""
        order = enforced_order[dim]
        pos = enforced_pos[dim] + 1
        ready_ids = {t.op_id: t for t in queues[dim] if t is not first}
        out = []
        while pos < len(order) and order[pos] in ready_ids:
            out.append(ready_ids[order[pos]])
            pos += 1
        return out

    def try_start(dim: int, now: float) -> None:
        if busy_until[dim] > now:
            return
        if flt is not None:
            if dim_down[dim]:
                return  # fully-out dim: queued work waits on RetryPolicy
        batch = select_batch(dim, now)
        if not batch:
            return
        if adm is not None:
            for t in batch:
                if not adm_first_svc[t.group]:
                    adm_first_svc[t.group] = True
                    adm.on_serving(t.group, now)
        bw = topology.dims[dim].aggr_bw_bytes
        a = max(t.fixed_delay for t in batch)
        wire = sum(t.wire_bytes for t in batch)
        occupy = wire / bw  # dim is a BW resource; steps pipeline
        if jitter:
            occupy *= 1.0 + jitter * rng.random()
        if straggler[dim]:
            occupy *= rng.lognormvariate(0.0, straggler[dim])
        if flt is not None:
            f = cur_factor[dim]
            if f < 1.0:
                occupy = occupy / f  # degraded effective BW
            bs = cur_sigma[dim]
            if bs > 0.0:
                occupy *= rng.lognormvariate(0.0, bs)
        if chk and dim_services[dim]:
            check_service_start(dim, now, dim_services[dim][-1][1],
                                "reference")
        free_at = now + occupy
        busy_until[dim] = free_at
        dim_busy[dim] += occupy
        dim_wire[dim] += wire
        for t in batch:
            dim_order[dim].append(t.op_id)
        svc = _Service(
            sid=next(seq), dim=dim, start=now, end=free_at,
            rate=(wire / occupy) if occupy > 0 else float("inf"),
            batch=batch, svc_idx=len(dim_services[dim]))
        groups_served = tuple(sorted({t.group for t in batch}))
        dim_services[dim].append(ServiceInterval(now, free_at, groups_served))
        if trc is not None:
            trc.service_start(dim, now, free_at,
                              tuple(t.op_id for t in batch), groups_served,
                              batch[0].tenant, wire)
            if arbiter is not None:
                trc.grant(dim, now, batch[0].tenant, len(batch), wire)
        services[svc.sid] = svc
        inflight[dim] = svc
        if arbiter is not None:
            arbiter.on_served(dim, batch, now)
        # Chunk stages complete A after their data drains (latency term).
        heapq.heappush(events, (free_at, next(seq), "free", (dim, svc.sid)))
        heapq.heappush(events, (free_at + a, next(seq), "done", (dim, svc.sid)))

    def maybe_preempt(dim: int, cand: StageTask, now: float) -> None:
        """Split the in-flight service at chunk granularity if the arbiter
        rules the candidate should not wait behind it.  Chunks whose data
        already started draining complete; the rest requeue (no lost bytes).
        """
        svc = inflight[dim]
        if svc is None or len(svc.batch) <= 1:
            return
        if not arbiter.should_preempt(dim, svc.batch[0], cand, now):
            return
        elapsed_bytes = (now - svc.start) * svc.rate
        keep = [svc.batch[0]]
        acc = svc.batch[0].wire_bytes
        for t in svc.batch[1:]:
            if acc >= elapsed_bytes:  # this chunk has not started draining
                break
            keep.append(t)
            acc += t.wire_bytes
        cut = svc.batch[len(keep):]
        if not cut:
            return
        new_end = svc.start + acc / svc.rate
        cut_wire = sum(t.wire_bytes for t in cut)
        dim_busy[dim] -= svc.end - new_end
        dim_wire[dim] -= cut_wire
        busy_until[dim] = new_end
        cut_ids = {t.op_id for t in cut}
        dim_order[dim] = [o for o in dim_order[dim] if o not in cut_ids]
        s0 = dim_services[dim][svc.svc_idx][0]
        dim_services[dim][svc.svc_idx] = ServiceInterval(
            s0, new_end, tuple(sorted({t.group for t in keep})))
        if trc is not None:
            trc.service_preempt(dim, svc.svc_idx, now, new_end, len(keep),
                                tuple(t.op_id for t in cut), cut_wire,
                                penalty)
        services.pop(svc.sid)
        svc.sid = next(seq)
        svc.end = new_end
        svc.batch = keep
        services[svc.sid] = svc
        a = max(t.fixed_delay for t in keep)
        heapq.heappush(events, (new_end, next(seq), "free", (dim, svc.sid)))
        heapq.heappush(events, (new_end + a, next(seq), "done", (dim, svc.sid)))
        if penalty > 0:
            # Re-arm latency: preempted chunks re-arrive after the penalty
            # (the arrival hook fires at their re-arm ready event).
            for t in cut:
                push_ready(t, now + penalty)
        else:
            for t in cut:
                queues[dim].append(t)
                if trc_enq is not None:
                    trc_enq(dim)
                    trc_enq_t(now)
                if on_enq is not None:
                    on_enq(dim, t.tenant, now)
                if flt is not None:
                    flt_enq(t, now)
        arbiter.on_preempted(dim, cut, now)

    makespan = max(issue_times) if issue_times else 0.0
    while events:
        now, _, kind, payload = heapq.heappop(events)
        # NB: stale events (from preempted services) must not advance the
        # makespan — their timestamps no longer correspond to real work.
        if kind == "ready":
            task: StageTask = payload  # type: ignore[assignment]
            if flt is not None and group_failed[task.group]:
                continue  # abandoned work must not advance the makespan
            if adm is not None:
                g = task.group
                if group_shed[g]:
                    continue  # shed work must not advance the makespan
                if not adm_started[g]:
                    adm_started[g] = True
                    victims = adm.on_ready(g, now)
                    if victims is not None:
                        if victims:
                            adm_apply(victims, now)
                        if group_shed[g]:
                            continue  # the arrival itself was shed
                        if trc is not None:
                            trc.admit(g, now)
            makespan = max(makespan, now)
            if flt is not None:
                group_started[task.group] = True
            if pending_since[task.dim] is None:
                pending_since[task.dim] = now
            queues[task.dim].append(task)
            if trc_enq is not None:
                trc_enq(task.dim)
                trc_enq_t(now)
            if on_enq is not None:
                on_enq(task.dim, task.tenant, now)
            if flt is not None:
                flt_enq(task, now)
            if (arbiter is not None and getattr(arbiter, "preemption", False)
                    and busy_until[task.dim] > now):
                maybe_preempt(task.dim, task, now)
            try_start(task.dim, now)
            if chk and not use_enforced and (
                    flt is None or not dim_down[task.dim]):
                check_work_conserving(
                    task.dim, now, len(queues[task.dim]),
                    busy_until[task.dim], inflight[task.dim], "reference")
        elif kind == "free":
            dim, sid = payload  # type: ignore[misc]
            if sid not in services:
                continue  # stale: service was preempted and rescheduled
            makespan = max(makespan, now)
            if inflight[dim] is not None and inflight[dim].sid == sid:
                inflight[dim] = None
            if not queues[dim] and pending_since[dim] is not None:
                activity[dim].append((pending_since[dim], now))
                pending_since[dim] = None
            try_start(dim, now)
            if chk and not use_enforced and (
                    flt is None or not dim_down[dim]):
                check_work_conserving(dim, now, len(queues[dim]),
                                      busy_until[dim], inflight[dim],
                                      "reference")
        elif kind == "done":  # chunk's next stage becomes ready
            dim, sid = payload  # type: ignore[misc]
            svc = services.pop(sid, None)
            if svc is None:
                continue  # stale: service was preempted and rescheduled
            makespan = max(makespan, now)
            for t in svc.batch:
                if flt is not None and group_failed[t.group]:
                    continue  # failed mid-flight: chain abandoned
                if adm is not None and group_shed[t.group]:
                    continue  # shed mid-flight: chain abandoned
                nxt = (t.chunk_id, t.stage_idx + 1)
                if nxt in tasks:
                    push_ready(tasks[nxt], now)
                    continue
                if group_finish[t.group] < now:  # chunk chain retired
                    group_finish[t.group] = now
                    if arbiter is not None:
                        arbiter.on_group_finish(
                            t.group, t.tenant, now - resolved_issue[t.group])
                if use_deps:
                    chains_left[t.group] -= 1
                    if not chains_left[t.group]:
                        complete_group(t.group, now)
        elif flt is not None and kind == "fault":
            flt_boundary(payload, now)
        else:  # timeout (only scheduled when flt is armed)
            if flt is not None:
                task, ep = payload  # type: ignore[misc]
                flt_timeout(task, ep, now)

    for dim in range(num_dims):
        if pending_since[dim] is not None:  # pragma: no cover - safety
            activity[dim].append((pending_since[dim], makespan))

    if use_deps:
        for g in range(n_groups):
            if (n_parents[g] > 0 and (flt is None or not group_failed[g])
                    and (adm is None or not group_shed[g])):
                raise ValueError(
                    f"dependency cycle: group {g} never became eligible")
        if group_finish:
            # Trailing compute nodes finish after the last network event.
            makespan = max(makespan, max(group_finish))

    if chk:
        check_final(
            engine="reference", num_dims=num_dims,
            tasks=((op, t.dim, t.wire_bytes, t.tenant, t.group)
                   for op, t in tasks.items()),
            dim_wire=dim_wire, dim_busy=dim_busy, dim_order=dim_order,
            dim_services=dim_services, group_finish=group_finish,
            resolved_issue=resolved_issue, makespan=makespan,
            enforced=use_enforced, arbiter=arbiter, served_base=served_base,
            failed=(frozenset(g for g, _ in failed_log)
                    if flt is not None else None),
            shed=(frozenset(g for g, _ in shed_log)
                  if adm is not None else None))

    res = SimResult(makespan, dim_busy, dim_wire, activity, dim_order,
                    dim_services, resolved_issue, group_finish,
                    list(streams), list(tenants), group_wire)
    if flt is not None:
        res.failed_groups = failed_log
        res.group_retries = group_retries
    if adm is not None:
        res.shed_groups = shed_log
    if trc is not None:
        trc.finalize(res, topology)
    return res


# ---------------------------------------------------------------------------
# Indexed engine — struct-of-arrays tasks + indexed priority queues.
# ---------------------------------------------------------------------------
def _simulate_indexed(
    topology: Topology,
    chunk_groups: list[list[Chunk]],
    *,
    issue_times: list[float],
    priorities: list[int],
    intra: str,
    fusion: bool,
    fusion_limit: int,
    enforced_order: list[list[OpId]] | None,
    jitter: float,
    seed: int,
    tenants: list[str],
    streams: list[str],
    arbiter,
    penalty: float,
    task_arrays: TaskArrays | None = None,
    deps: list[tuple[int, ...]] | None = None,
    dep_delay: list[float] | None = None,
    chk: bool = False,
    tracer=None,
    faults=None,
    replanner=None,
    admission=None,
) -> SimResult:
    """Same semantics as :func:`_simulate_reference`, near-linear cost.

    Tasks live in preallocated parallel arrays (struct-of-arrays) addressed
    by integer handles; each dimension's ready queue is an indexed priority
    queue — a binary heap whose entries embed the discipline key, so a
    service start pops its batch in O(batch x log n) instead of sorting the
    whole queue and removing served tasks one by one.  Under an arbiter the
    queue is a per-(dim, tenant) bucket of heaps: quantum batching pops the
    winning tenant's bucket, and preemption pushes cut chunks back into it.

    Bit-equivalence with the reference engine is by construction: the
    tie-break counter (``seq``) and the jitter RNG are consumed in exactly
    the same order, heap keys replicate the reference sort keys (every key
    ends in the unique arrival seq, so total order is identical), and float
    accumulations run in the same sequence.
    """
    import random

    rng = random.Random(seed)
    lm = LatencyModel.for_topology(topology)
    tbl = lm.stage_tables
    num_dims = topology.num_dims
    n_groups = len(chunk_groups)

    # ---- struct-of-arrays task storage (integer handles) -------------------
    ta = task_arrays
    if ta is None:
        ta = build_task_arrays(lm, chunk_groups, priorities, tenants)
    n_tasks = ta.n_tasks
    t_chunk = ta.chunk
    t_stage = ta.stage
    t_dim = ta.dim
    t_wire = ta.wire
    t_fixed = ta.fixed
    t_group = ta.group
    t_prio = ta.prio
    t_tenant = ta.tenant
    t_last = ta.last
    first_handles = ta.first_handles
    # group_wire is returned inside SimResult — copy so a shared TaskArrays
    # (replayed across a batch of scenarios) can't be mutated via a result.
    group_wire = list(ta.group_wire)
    t_arr = [0] * n_tasks      # arrival seq (assigned when readied; per run)

    # ---- per-dim state ------------------------------------------------------
    busy_until = [0.0] * num_dims
    dim_busy = [0.0] * num_dims
    dim_wire = [0.0] * num_dims
    # Served op ids, one list per service (parallel to dim_services) — a
    # preemption replaces its own service's list instead of filtering the
    # whole per-dim history (which made preemption storms quadratic).  The
    # flat per-dim order is concatenated at the end; a preempted service is
    # always the tail segment of its dim's history at split time, so the
    # concatenation equals the reference engine's incremental filtering.
    svc_ops: list[list[list[OpId]]] = [[] for _ in range(num_dims)]
    dim_services: list[list[ServiceInterval]] = [[] for _ in range(num_dims)]
    activity: list[list[tuple[float, float]]] = [[] for _ in range(num_dims)]
    pending_since: list[float | None] = [None] * num_dims
    enforced_pos = [0] * num_dims
    qlen = [0] * num_dims
    group_finish = [t for t in issue_times]
    resolved_issue = list(issue_times)       # dep mode: actual issue times
    straggler = [d.straggler_sigma for d in topology.dims]
    seq = itertools.count()
    services: dict[int, _Service] = {}
    inflight: list[_Service | None] = [None] * num_dims
    events: list[tuple] = []
    dim_bw = tbl.bw

    # Arrival hook (the fair-policy virtual-time clamp) + sanitizer baseline.
    on_enq = getattr(arbiter, "on_enqueued", None)
    served_base = (arbiter.served_snapshot()
                   if chk and hasattr(arbiter, "served_snapshot") else None)

    # Flight recorder (repro_torch.obs.Tracer).  Hooks are append-only and never
    # consume seq/RNG, so armed runs stay bit-identical to untraced ones.
    trc = tracer
    if trc is not None:
        trc.begin(num_dims, n_groups, "indexed")
    trc_enq = trc.enq_dims.append if trc is not None else None
    trc_enq_t = trc.enq_times.append if trc is not None else None

    # Ready-queue index, one flavor per mode:
    #  * plain: per-dim heap keyed by the intra discipline;
    #  * arbiter: per-(dim, tenant) bucket heaps (quantum batching / preempt
    #    requeue pop and push per-tenant);
    #  * enforced: per-dim {op_id: handle} map (service order is dictated,
    #    so the "queue" only answers membership).
    use_arbiter = arbiter is not None
    use_enforced = enforced_order is not None
    scf = intra == "SCF"
    heaps: list[list] = [[] for _ in range(num_dims)]
    buckets: list[dict[str, list]] = [{} for _ in range(num_dims)]
    ready_map: list[dict[OpId, int]] = [{} for _ in range(num_dims)]
    if use_arbiter:
        arb_policy = arbiter.policy
        arb_fair = arb_policy in ("weighted-fair", "slo-aware")
        arb_quantum = max(1, getattr(arbiter, "quantum_chunks", 1))
        arb_preempt = getattr(arbiter, "preemption", False)
        arb_vt = arbiter.virtual_time
        # StageTask views handed to arbiter hooks (materialized lazily).
        views: list[StageTask | None] = [None] * n_tasks

        def view(hh: int) -> StageTask:
            v = views[hh]
            if v is None:
                v = views[hh] = StageTask(
                    chunk_id=t_chunk[hh], stage_idx=t_stage[hh],
                    dim=t_dim[hh], wire_bytes=t_wire[hh],
                    fixed_delay=t_fixed[hh], group=t_group[hh],
                    priority=t_prio[hh], tenant=t_tenant[hh])
            v.arrival_seq = t_arr[hh]
            return v

    def push_ready(hh: int, t: float) -> None:
        s = next(seq)
        t_arr[hh] = s
        heapq.heappush(events, (t, s, 0, hh))  # kind 0 = ready

    # -- lazy queue deletion (shared by faults and admission) ----------------
    # Queue membership under faults or admission uses lazy heap deletion:
    # ``t_inq`` plus the arrival seq embedded in every heap entry decide
    # whether an entry is alive (a purged/retried/shed handle's stale
    # entries are skipped on pop).  When neither is armed none of this
    # state exists and select_batch takes the branch-free fast path.
    flt = faults
    adm = admission
    lazyq = (flt is not None) or (adm is not None)
    if lazyq:
        t_inq = [False] * n_tasks  # currently queued?
        # Group -> contiguous handle range (build order groups handles).
        group_h0 = [n_tasks] * n_groups
        group_h1 = [0] * n_groups
        for hh in range(n_tasks):
            g = t_group[hh]
            if hh < group_h0[g]:
                group_h0[g] = hh
            group_h1[g] = hh + 1

        def q_alive(entry) -> bool:
            hh = entry[-1]
            return t_inq[hh] and entry[-2] == t_arr[hh]

    # -- fault injection (repro_torch.faults) --------------------------------------
    # Mirrors the reference engine's fault block event-for-event (same seq
    # and RNG consumption order); when ``flt`` is None none of this state
    # exists and the engine is byte-for-byte the pre-fault engine.
    if flt is not None:
        flt_retry = flt.retry
        flt_bounds = flt.boundaries
        cur_factor = [1.0] * num_dims
        cur_sigma = [0.0] * num_dims
        dim_down = [False] * num_dims
        group_started = [False] * n_groups
        group_failed = [False] * n_groups
        group_retries = [0] * n_groups
        failed_log: list[tuple[int, float]] = []
        t_att = [0] * n_tasks      # retry attempts per op
        t_ep = [0] * n_tasks       # queue-residency epoch per op
        if replanner is not None:
            # Replanning rewrites stage tasks in place — copy the (possibly
            # shared/replayed) TaskArrays columns it touches.
            t_dim = list(t_dim)
            t_wire = list(t_wire)
            t_fixed = list(t_fixed)

        def flt_enq(hh: int, now: float) -> None:
            t_ep[hh] += 1
            if dim_down[t_dim[hh]]:
                heapq.heappush(events, (now + flt_retry.timeout_s,
                                        next(seq), 4, (hh, t_ep[hh])))

        def flt_queued(dim: int) -> list[int]:
            # Alive queued handles on ``dim`` in arrival order — the same
            # set and order as the reference engine's queue scan.
            if use_arbiter:
                entries = [e for heap in buckets[dim].values() for e in heap]
            else:
                entries = heaps[dim]
            out = [e[-1] for e in entries if q_alive(e)]
            out.sort(key=t_arr.__getitem__)
            return out

        def flt_fail(g0: int, now: float) -> None:
            work = [g0]
            while work:
                g = work.pop()
                if group_failed[g] or (adm is not None and group_shed[g]):
                    continue  # a shed group's work is already gone
                group_failed[g] = True
                failed_log.append((g, now))
                if trc is not None:
                    trc.group_failed(g, now)
                for hh in range(group_h0[g], group_h1[g]):
                    if t_inq[hh]:
                        t_inq[hh] = False
                        t_ep[hh] += 1
                        qlen[t_dim[hh]] -= 1
                if use_deps:
                    work.extend(dep_children[g])

        def flt_abort(dim: int, svc: _Service, now: float) -> None:
            nonlocal makespan
            elapsed_bytes = (now - svc.start) * svc.rate
            keep: list[int] = []
            acc = 0.0
            for hh in svc.batch:
                if acc + t_wire[hh] > elapsed_bytes:
                    break
                keep.append(hh)
                acc += t_wire[hh]
            cut = svc.batch[len(keep):]
            if not cut:
                return
            if now > makespan:
                makespan = now
            cut_wire = sum(t_wire[hh] for hh in cut)
            dim_busy[dim] -= svc.end - now
            dim_wire[dim] -= cut_wire
            busy_until[dim] = now
            svc_ops[dim][svc.svc_idx] = [(t_chunk[hh], t_stage[hh])
                                         for hh in keep]
            s0 = dim_services[dim][svc.svc_idx][0]
            groups_kept = (tuple(sorted({t_group[hh] for hh in keep}))
                           if keep
                           else dim_services[dim][svc.svc_idx].groups)
            dim_services[dim][svc.svc_idx] = ServiceInterval(
                s0, now, groups_kept)
            if trc is not None:
                trc.service_abort(dim, svc.svc_idx, now, len(keep),
                                  tuple((t_chunk[hh], t_stage[hh])
                                        for hh in cut), cut_wire)
            services.pop(svc.sid)
            if keep:
                svc.sid = next(seq)
                svc.end = now
                svc.batch = keep
                services[svc.sid] = svc
                a = max(t_fixed[hh] for hh in keep)
                heapq.heappush(events, (now, next(seq), 1, (dim, svc.sid)))
                heapq.heappush(events, (now + a, next(seq), 2,
                                        (dim, svc.sid)))
            else:
                inflight[dim] = None
            for hh in cut:
                if not group_failed[t_group[hh]]:
                    enqueue(hh, now)
            if use_arbiter:
                arbiter.on_preempted(dim, [view(hh) for hh in cut], now)

        def flt_outage_start(dim: int, now: float) -> None:
            for hh in flt_queued(dim):
                heapq.heappush(events, (now + flt_retry.timeout_s,
                                        next(seq), 4, (hh, t_ep[hh])))
            svc = inflight[dim]
            if svc is not None and svc.end > now:
                flt_abort(dim, svc, now)

        def flt_recover(dim: int, now: float) -> None:
            for hh in flt_queued(dim):
                t_ep[hh] += 1

        def flt_timeout(hh: int, ep: int, now: float) -> None:
            if (t_ep[hh] != ep or group_failed[t_group[hh]]
                    or not dim_down[t_dim[hh]]):
                return  # stale arm: the chunk moved, failed, or recovered
            att = t_att[hh] + 1
            t_att[hh] = att
            group_retries[t_group[hh]] += 1
            if att >= flt_retry.max_attempts:
                if trc is not None:
                    trc.retry(t_dim[hh], (t_chunk[hh], t_stage[hh]),
                              now, att, now)
                flt_fail(t_group[hh], now)
                return
            t_inq[hh] = False
            qlen[t_dim[hh]] -= 1
            delay = flt_retry.backoff_s * flt_retry.multiplier ** (att - 1)
            if flt_retry.jitter > 0.0:
                delay *= 1.0 + flt_retry.jitter * rng.random()
            if trc is not None:
                trc.retry(t_dim[hh], (t_chunk[hh], t_stage[hh]), now, att,
                          now + delay)
            push_ready(hh, now + delay)

        def flt_rerate(dim: int, svc: _Service, now: float,
                       scale: float) -> None:
            new_end = now + (svc.end - now) * scale
            dim_busy[dim] += new_end - svc.end
            busy_until[dim] = new_end
            svc.start = now - (now - svc.start) * scale
            svc.rate = svc.rate / scale
            iv = dim_services[dim][svc.svc_idx]
            dim_services[dim][svc.svc_idx] = ServiceInterval(
                iv.start, new_end, iv.groups)
            if trc is not None:
                trc.service_rerate(dim, svc.svc_idx, now, new_end, scale)
            services.pop(svc.sid)
            svc.sid = next(seq)
            svc.end = new_end
            services[svc.sid] = svc
            a = max(t_fixed[hh] for hh in svc.batch)
            heapq.heappush(events, (new_end, next(seq), 1, (dim, svc.sid)))
            heapq.heappush(events, (new_end + a, next(seq), 2,
                                    (dim, svc.sid)))

        def flt_replan(now: float) -> None:
            pend = [g for g in range(n_groups)
                    if not group_started[g] and not group_failed[g]
                    and (adm is None or not group_shed[g])
                    and chunk_groups[g]]
            if not pend:
                return
            pend.sort(key=lambda g: (resolved_issue[g], g))
            new_map = replanner(
                now, list(cur_factor),
                [(g, resolved_issue[g], chunk_groups[g]) for g in pend])
            applied = []
            for g in pend:
                new_chunks = new_map.get(g)
                if new_chunks is None:
                    continue
                old = chunk_groups[g]
                if len(new_chunks) != len(old):
                    raise ValueError(
                        f"replanner changed group {g}'s chunk count "
                        f"({len(old)} -> {len(new_chunks)})")
                gw = 0.0
                hh = group_h0[g]
                for oc, nc in zip(old, new_chunks):
                    if len(nc.schedule) != len(oc.schedule):
                        raise ValueError(
                            f"replanner changed group {g} chunk "
                            f"{oc.index}'s stage count")
                    dims_, wires_, fixeds_ = stage_sequence(
                        tbl, oc.size_bytes, nc.schedule)
                    for s in range(len(dims_)):
                        t_dim[hh] = dims_[s]
                        t_wire[hh] = wires_[s]
                        t_fixed[hh] = fixeds_[s]
                        gw += wires_[s]
                        hh += 1
                group_wire[g] = gw
                applied.append(g)
            if trc is not None and applied:
                trc.replan(now, tuple(applied), tuple(cur_factor))

        def flt_boundary(bi: int, now: float) -> None:
            b = flt_bounds[bi]
            d = b.dim
            old_f = cur_factor[d]
            cur_factor[d] = b.factor
            cur_sigma[d] = b.sigma
            if trc is not None:
                trc.fault(d, now, b.factor, b.sigma)
            if b.down_start:
                dim_down[d] = True
                flt_outage_start(d, now)
            elif b.down_end:
                dim_down[d] = False
                flt_recover(d, now)
            elif b.bw_change:
                svc = inflight[d]
                if svc is not None and svc.end > now:
                    flt_rerate(d, svc, now, old_f / b.factor)
            if replanner is not None and b.bw_change:
                flt_replan(now)
            if b.down_end:
                try_start(d, now)

        for bi in range(len(flt_bounds)):
            heapq.heappush(events, (flt_bounds[bi].t, next(seq), 3, bi))

    # -- admission control / load shedding (repro.fleet) ---------------------
    # Mirror of the reference engine's admission block (same call sites,
    # same event order; the controller consumes no seq/RNG).  Shed purges
    # flip ``t_inq`` (lazy heap deletion) instead of filtering queue lists.
    if adm is not None:
        adm.begin(n_groups, "indexed")
        group_shed = [False] * n_groups
        adm_started = [False] * n_groups   # first ready pop seen?
        adm_first_svc = [False] * n_groups  # first service seen?
        shed_log: list[tuple[int, float]] = []

        def adm_apply(victims, now: float) -> None:
            # Shed the victim groups, purge their queued chunks, and shed
            # dependents transitively (a gated dependent can never issue).
            work = list(victims)
            while work:
                g = work.pop()
                if group_shed[g] or (flt is not None and group_failed[g]):
                    continue
                group_shed[g] = True
                shed_log.append((g, now))
                if trc is not None:
                    trc.group_shed(g, now)
                for hh in range(group_h0[g], group_h1[g]):
                    if t_inq[hh]:
                        t_inq[hh] = False
                        qlen[t_dim[hh]] -= 1
                        if flt is not None:
                            t_ep[hh] += 1  # invalidate armed timeouts
                work.extend(dep_children[g])

    use_deps = deps is not None
    if use_deps:
        # Dependency-gated release — mirrors the reference engine exactly
        # (same release order, so the seq counter stays in lockstep).
        group_first: list[list[int]] = [[] for _ in range(n_groups)]
        for hh in first_handles:
            group_first[t_group[hh]].append(hh)
        dep_children: list[list[int]] = [[] for _ in range(n_groups)]
        n_parents = [len(preds) for preds in deps]
        for g, preds in enumerate(deps):
            for p in preds:
                dep_children[p].append(g)
        parent_fin = [0.0] * n_groups
        chains_left = [len(group_first[g]) for g in range(n_groups)]

        def complete_group(g: int, t: float) -> None:
            work = [(g, t)]
            while work:
                gg, tt = work.pop(0)
                if adm is not None:
                    adm.on_finish(gg, tt)
                for c in dep_children[gg]:
                    if trc is not None:
                        trc.dep_resolved(gg, c, tt)
                    if parent_fin[c] < tt:
                        parent_fin[c] = tt
                    n_parents[c] -= 1
                    if n_parents[c]:
                        continue
                    te = max(issue_times[c], parent_fin[c] + dep_delay[c])
                    resolved_issue[c] = te
                    if trc is not None:
                        trc.release(c, te)
                    if chains_left[c]:
                        for hh in group_first[c]:
                            push_ready(hh, te)
                    else:
                        group_finish[c] = te
                        work.append((c, te))

        for g in range(n_groups):
            if deps[g]:
                continue
            te = issue_times[g] + dep_delay[g]
            resolved_issue[g] = te
            if trc is not None:
                trc.release(g, te)
            if chains_left[g]:
                for hh in group_first[g]:
                    push_ready(hh, te)
            else:
                group_finish[g] = te
                complete_group(g, te)
    else:
        for hh in first_handles:
            push_ready(hh, issue_times[t_group[hh]])

    def enqueue(hh: int, now: float) -> None:
        dim = t_dim[hh]
        qlen[dim] += 1
        if trc_enq is not None:
            trc_enq(dim)
            trc_enq_t(now)
        if use_arbiter:
            b = buckets[dim]
            tn = t_tenant[hh]
            heap = b.get(tn)
            if heap is None:
                heap = b[tn] = []
            if arb_fair:
                heapq.heappush(heap, (t_wire[hh], t_arr[hh], hh))
            else:  # fifo / strict-priority order by arrival within a tenant
                heapq.heappush(heap, (t_arr[hh], hh))
            if on_enq is not None:
                on_enq(dim, tn, now)
        elif use_enforced:
            ready_map[dim][(t_chunk[hh], t_stage[hh])] = hh
        elif scf:
            heapq.heappush(heaps[dim],
                           (-t_prio[hh], t_wire[hh], t_arr[hh], hh))
        else:
            heapq.heappush(heaps[dim], (-t_prio[hh], t_arr[hh], hh))
        if lazyq:
            t_inq[hh] = True
        if flt is not None:
            flt_enq(hh, now)

    def select_batch(dim: int, now: float) -> list[int]:
        if not qlen[dim]:
            return []
        if use_arbiter:
            b = buckets[dim]
            if lazyq:
                # Lazy deletion: drop stale heads (purged/retried/shed
                # handles) so the head-peek below only sees alive entries.
                dead = []
                for tn, heap in b.items():
                    while heap and not q_alive(heap[0]):
                        heapq.heappop(heap)
                    if not heap:
                        dead.append(tn)
                for tn in dead:
                    del b[tn]
                if not b:
                    return []
            best_tn = None
            best_key = None
            # The reference sorts the whole queue by arbiter.order_key and
            # serves the head tenant; here the winning tenant is the min
            # over bucket heads of the same key (within a tenant the key is
            # static, so the bucket heap order equals the sorted order).
            for tn, heap in b.items():
                head = heap[0]
                if arb_fair:
                    key = (arb_vt(dim, tn), head[0], head[1])
                elif arb_policy == "strict-priority":
                    key = (-arbiter.spec(tn).priority, head[0])
                else:  # fifo
                    key = (head[0],)
                if best_key is None or key < best_key:
                    best_key, best_tn = key, tn
            heap = b[best_tn]
            batch = []
            while heap and len(batch) < arb_quantum:
                if lazyq:
                    if not q_alive(heap[0]):
                        heapq.heappop(heap)
                        continue
                batch.append(heapq.heappop(heap)[-1])
            if not heap:
                del b[best_tn]
            qlen[dim] -= len(batch)
            if lazyq:
                for hh in batch:
                    t_inq[hh] = False
            return batch
        if use_enforced:
            order = enforced_order[dim]
            pos = enforced_pos[dim]
            if pos >= len(order):
                return []
            rm = ready_map[dim]
            h0 = rm.get(order[pos])
            if h0 is None:
                return []  # idle until the mandated op arrives
            batch = [h0]
            if fusion:
                sat = t_fixed[h0] * dim_bw[dim]
                total = t_wire[h0]
                p = pos + 1
                while (total < sat and len(batch) < fusion_limit
                       and p < len(order) and order[p] in rm):
                    hh = rm[order[p]]
                    batch.append(hh)
                    total += t_wire[hh]
                    p += 1
            for hh in batch:
                del rm[(t_chunk[hh], t_stage[hh])]
            enforced_pos[dim] += len(batch)
            qlen[dim] -= len(batch)
            return batch
        heap = heaps[dim]
        if lazyq:
            while heap and not q_alive(heap[0]):
                heapq.heappop(heap)
            if not heap:
                return []
        h0 = heapq.heappop(heap)[-1]
        batch = [h0]
        if fusion:
            sat = t_fixed[h0] * dim_bw[dim]
            total = t_wire[h0]
            while heap and total < sat and len(batch) < fusion_limit:
                if lazyq:
                    if not q_alive(heap[0]):
                        heapq.heappop(heap)
                        continue
                hh = heapq.heappop(heap)[-1]
                batch.append(hh)
                total += t_wire[hh]
        qlen[dim] -= len(batch)
        if lazyq:
            for hh in batch:
                t_inq[hh] = False
        return batch

    def try_start(dim: int, now: float) -> None:
        if busy_until[dim] > now:
            return
        if flt is not None:
            if dim_down[dim]:
                return  # fully-out dim: queued work waits on RetryPolicy
        batch = select_batch(dim, now)
        if not batch:
            return
        if adm is not None:
            for hh in batch:
                if not adm_first_svc[t_group[hh]]:
                    adm_first_svc[t_group[hh]] = True
                    adm.on_serving(t_group[hh], now)
        a = 0.0
        wire = 0.0
        for hh in batch:
            if t_fixed[hh] > a:
                a = t_fixed[hh]
            wire += t_wire[hh]
        occupy = wire / dim_bw[dim]
        if jitter:
            occupy *= 1.0 + jitter * rng.random()
        if straggler[dim]:
            occupy *= rng.lognormvariate(0.0, straggler[dim])
        if flt is not None:
            f = cur_factor[dim]
            if f < 1.0:
                occupy = occupy / f  # degraded effective BW
            bs = cur_sigma[dim]
            if bs > 0.0:
                occupy *= rng.lognormvariate(0.0, bs)
        if chk and dim_services[dim]:
            check_service_start(dim, now, dim_services[dim][-1][1],
                                "indexed")
        free_at = now + occupy
        busy_until[dim] = free_at
        dim_busy[dim] += occupy
        dim_wire[dim] += wire
        ops = [(t_chunk[hh], t_stage[hh]) for hh in batch]
        svc_ops[dim].append(ops)
        svc = _Service(
            sid=next(seq), dim=dim, start=now, end=free_at,
            rate=(wire / occupy) if occupy > 0 else float("inf"),
            batch=batch, svc_idx=len(dim_services[dim]))
        groups_served = tuple(sorted({t_group[hh] for hh in batch}))
        dim_services[dim].append(ServiceInterval(now, free_at, groups_served))
        if trc is not None:
            # Share the engine's own op list — preemption replaces (never
            # mutates) the ``svc_ops`` entry, so the tracer's reference
            # stays a faithful snapshot without a per-service copy.
            trc.service_start(dim, now, free_at, ops, groups_served,
                              t_tenant[batch[0]], wire)
            if use_arbiter:
                trc.grant(dim, now, t_tenant[batch[0]], len(batch), wire)
        services[svc.sid] = svc
        inflight[dim] = svc
        if use_arbiter:
            arbiter.on_served(dim, [view(hh) for hh in batch], now)
        heapq.heappush(events, (free_at, next(seq), 1, (dim, svc.sid)))
        heapq.heappush(events, (free_at + a, next(seq), 2, (dim, svc.sid)))

    def maybe_preempt(dim: int, cand: int, now: float) -> None:
        svc = inflight[dim]
        if svc is None or len(svc.batch) <= 1:
            return
        if not arbiter.should_preempt(dim, view(svc.batch[0]), view(cand), now):
            return
        elapsed_bytes = (now - svc.start) * svc.rate
        keep = [svc.batch[0]]
        acc = t_wire[svc.batch[0]]
        for hh in svc.batch[1:]:
            if acc >= elapsed_bytes:  # this chunk has not started draining
                break
            keep.append(hh)
            acc += t_wire[hh]
        cut = svc.batch[len(keep):]
        if not cut:
            return
        new_end = svc.start + acc / svc.rate
        cut_wire = sum(t_wire[hh] for hh in cut)
        dim_busy[dim] -= svc.end - new_end
        dim_wire[dim] -= cut_wire
        busy_until[dim] = new_end
        svc_ops[dim][svc.svc_idx] = [(t_chunk[hh], t_stage[hh])
                                     for hh in keep]
        s0 = dim_services[dim][svc.svc_idx][0]
        dim_services[dim][svc.svc_idx] = ServiceInterval(
            s0, new_end, tuple(sorted({t_group[hh] for hh in keep})))
        if trc is not None:
            trc.service_preempt(dim, svc.svc_idx, now, new_end, len(keep),
                                tuple((t_chunk[hh], t_stage[hh])
                                      for hh in cut), cut_wire, penalty)
        services.pop(svc.sid)
        svc.sid = next(seq)
        svc.end = new_end
        svc.batch = keep
        services[svc.sid] = svc
        a = max(t_fixed[hh] for hh in keep)
        heapq.heappush(events, (new_end, next(seq), 1, (dim, svc.sid)))
        heapq.heappush(events, (new_end + a, next(seq), 2, (dim, svc.sid)))
        if penalty > 0:
            for hh in cut:
                push_ready(hh, now + penalty)
        else:
            for hh in cut:
                enqueue(hh, now)
        arbiter.on_preempted(dim, [view(hh) for hh in cut], now)

    makespan = max(issue_times) if issue_times else 0.0
    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == 0:  # ready
            hh = payload
            if flt is not None and group_failed[t_group[hh]]:
                continue  # abandoned work must not advance the makespan
            if adm is not None:
                g = t_group[hh]
                if group_shed[g]:
                    continue  # shed work must not advance the makespan
                if not adm_started[g]:
                    adm_started[g] = True
                    victims = adm.on_ready(g, now)
                    if victims is not None:
                        if victims:
                            adm_apply(victims, now)
                        if group_shed[g]:
                            continue  # the arrival itself was shed
                        if trc is not None:
                            trc.admit(g, now)
            if now > makespan:
                makespan = now
            if flt is not None:
                group_started[t_group[hh]] = True
            dim = t_dim[hh]
            if pending_since[dim] is None:
                pending_since[dim] = now
            enqueue(hh, now)
            if use_arbiter and arb_preempt and busy_until[dim] > now:
                maybe_preempt(dim, hh, now)
            try_start(dim, now)
            if chk and not use_enforced and (
                    flt is None or not dim_down[dim]):
                check_work_conserving(dim, now, qlen[dim], busy_until[dim],
                                      inflight[dim], "indexed")
        elif kind == 1:  # free
            dim, sid = payload
            if sid not in services:
                continue  # stale: service was preempted and rescheduled
            if now > makespan:
                makespan = now
            cur = inflight[dim]
            if cur is not None and cur.sid == sid:
                inflight[dim] = None
            if not qlen[dim] and pending_since[dim] is not None:
                activity[dim].append((pending_since[dim], now))
                pending_since[dim] = None
            try_start(dim, now)
            if chk and not use_enforced and (
                    flt is None or not dim_down[dim]):
                check_work_conserving(dim, now, qlen[dim], busy_until[dim],
                                      inflight[dim], "indexed")
        elif kind == 2:  # done — chunk's next stage becomes ready
            dim, sid = payload
            svc = services.pop(sid, None)
            if svc is None:
                continue  # stale: service was preempted and rescheduled
            if now > makespan:
                makespan = now
            for hh in svc.batch:
                if flt is not None and group_failed[t_group[hh]]:
                    continue  # failed mid-flight: chain abandoned
                if adm is not None and group_shed[t_group[hh]]:
                    continue  # shed mid-flight: chain abandoned
                if not t_last[hh]:
                    push_ready(hh + 1, now)  # stages are contiguous handles
                    continue
                g = t_group[hh]
                if group_finish[g] < now:  # chunk chain retired
                    group_finish[g] = now
                    if use_arbiter:
                        arbiter.on_group_finish(
                            g, t_tenant[hh], now - resolved_issue[g])
                if use_deps:
                    chains_left[g] -= 1
                    if not chains_left[g]:
                        complete_group(g, now)
        elif flt is not None and kind == 3:  # fault boundary
            flt_boundary(payload, now)
        else:  # timeout (only scheduled when flt is armed)
            if flt is not None:
                hh, ep = payload
                flt_timeout(hh, ep, now)

    for dim in range(num_dims):
        if pending_since[dim] is not None:  # pragma: no cover - safety
            activity[dim].append((pending_since[dim], makespan))

    if use_deps:
        for g in range(n_groups):
            if (n_parents[g] > 0 and (flt is None or not group_failed[g])
                    and (adm is None or not group_shed[g])):
                raise ValueError(
                    f"dependency cycle: group {g} never became eligible")
        if group_finish:
            # Trailing compute nodes finish after the last network event.
            makespan = max(makespan, max(group_finish))

    dim_order: list[list[OpId]] = [
        [op for ops in svc_ops[dim] for op in ops] for dim in range(num_dims)]
    if chk:
        check_final(
            engine="indexed", num_dims=num_dims,
            tasks=(((t_chunk[h], t_stage[h]), t_dim[h], t_wire[h],
                    t_tenant[h], t_group[h]) for h in range(n_tasks)),
            dim_wire=dim_wire, dim_busy=dim_busy, dim_order=dim_order,
            dim_services=dim_services, group_finish=group_finish,
            resolved_issue=resolved_issue, makespan=makespan,
            enforced=use_enforced, arbiter=arbiter, served_base=served_base,
            failed=(frozenset(g for g, _ in failed_log)
                    if flt is not None else None),
            shed=(frozenset(g for g, _ in shed_log)
                  if adm is not None else None))
    res = SimResult(makespan, dim_busy, dim_wire, activity, dim_order,
                    dim_services, resolved_issue, group_finish,
                    list(streams), list(tenants), group_wire)
    if flt is not None:
        res.failed_groups = failed_log
        res.group_retries = group_retries
    if adm is not None:
        res.shed_groups = shed_log
    if trc is not None:
        trc.finalize(res, topology)
    return res


def simulate_scheduled(
    topology: Topology,
    collective: str,
    size_bytes: float,
    *,
    policy: str = "themis",
    chunks_per_collective: int = 64,
    intra: str = "SCF",
    fusion: bool = True,
    water_filling: bool = False,
    engine: str = "indexed",
    check_invariants: bool = False,
    tracer=None,
    faults=None,
    replan: bool = False,
) -> tuple[SimResult, list[Chunk]]:
    """Schedule one collective with ``policy`` and simulate it.

    ``faults``/``replan``: fault timeline and the graceful-degradation
    re-planning hook (built for this topology/policy when ``replan``).
    ``engine`` passes through to :func:`simulate` — ``"compiled"`` runs
    the cohort-vectorized fast path (bit-identical; falls back to indexed
    with the documented signal when ``tracer``/``faults`` are armed).
    """
    from repro_torch.core.scheduler import schedule_collective

    if replan and faults is None:
        raise ValueError("replan=True requires faults")
    chunks = schedule_collective(
        topology,
        collective,
        size_bytes,
        chunks_per_collective,
        policy,
        water_filling=water_filling,
    )
    replanner = None
    if replan:
        from repro_torch.faults.replan import make_replanner

        replanner = make_replanner(topology, policy)
    res = simulate(topology, [chunks], intra=intra, fusion=fusion,
                   engine=engine, check_invariants=check_invariants,
                   tracer=tracer, faults=faults, replanner=replanner)
    return res, chunks


def simulate_requests(
    topology: Topology,
    requests: list[CollectiveRequest],
    *,
    policy: str = "themis",
    chunks_per_collective: int = 64,
    intra: str = "SCF",
    fusion: bool = True,
    water_filling: bool = False,
    arbiter=None,
    preempt_penalty_s: float | None = None,
    engine: str = "indexed",
    scheduler=None,
    check_invariants: bool = False,
    tracer=None,
    faults=None,
    replan: bool = False,
) -> tuple[SimResult, list[list[Chunk]]]:
    """Online entry point: schedule and simulate an arrival-time-aware
    request stream.

    Requests are scheduled in issue order through one ``ThemisScheduler``
    whose Dim Load Tracker runs *across* requests (``schedule_request``), so
    each collective's chunk orders account for the residual load of every
    collective still in flight.  The returned chunk groups are indexed like
    ``requests``; ``SimResult.group_issue``/``group_finish`` give each
    request's service window.  For multi-tenant streams this is the
    *shared-tracker* mode (one fabric-wide load view); see
    ``repro_torch.tenancy.simulate_fabric`` for per-tenant trackers and
    inter-tenant arbitration.

    ``scheduler`` — the scenario-reuse contract: pass a shared
    ``ThemisScheduler`` to keep its memo caches (exact; see
    ``ThemisScheduler.isolated_run``) warm across many calls.  Each call
    still schedules against a *fresh* load tracker and restores the
    caller's tracker on return, so back-to-back calls with one shared
    scheduler are bit-identical to calls with fresh schedulers and never
    leak tracker state between scenarios.  The scheduler must have been
    built for ``topology`` (scheduling with another topology's latency
    model was previously silently wrong; now it raises), and its policy
    overrides the ``policy`` argument.

    ``engine`` passes through to :func:`simulate` — ``"compiled"`` runs
    the cohort-vectorized fast path on the scheduled stream
    (bit-identical to indexed; scenarios it cannot serve, e.g. with an
    ``arbiter`` or ``tracer``, fall back with the documented signal).
    """
    from repro_torch.core.scheduler import ThemisScheduler

    if replan and faults is None:
        raise ValueError("replan=True requires faults")
    if scheduler is None:
        lm = LatencyModel.for_topology(topology)
        sched_ctx = ThemisScheduler(lm, policy).isolated_run()
    else:
        if scheduler.latency_model.topology != topology:
            raise ValueError(
                "scheduler was built for topology "
                f"{scheduler.latency_model.topology.name!r}; reusing its "
                f"memos on {topology.name!r} is unspecified — build one "
                "scheduler per topology")
        sched_ctx = scheduler.isolated_run()
    with sched_ctx as sched:
        groups = sched.schedule_stream(
            requests, chunks_per_collective, water_filling=water_filling)
    replanner = None
    if replan:
        from repro_torch.faults.replan import make_replanner

        replanner = make_replanner(
            topology, scheduler.policy if scheduler is not None else policy)
    res = simulate(
        topology,
        groups,
        issue_times=[r.issue_time for r in requests],
        priorities=[r.priority for r in requests],
        intra=intra,
        fusion=fusion,
        tenants=[r.tenant for r in requests],
        streams=[r.stream for r in requests],
        arbiter=arbiter,
        preempt_penalty_s=preempt_penalty_s,
        engine=engine,
        check_invariants=check_invariants,
        tracer=tracer,
        faults=faults,
        replanner=replanner,
    )
    return res, groups

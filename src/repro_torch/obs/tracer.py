"""Fabric flight recorder — event capture for the simulation engines.

A :class:`Tracer` is handed to ``simulate(..., tracer=...)`` and records
the time-resolved story a :class:`~repro_torch.core.simulator.SimResult`'s
scalar aggregates flatten away: every chunk-service start/finish/preempt,
arbiter grant and requeue, ready-queue arrival, dependency-edge
resolution, and group release, plus the run's final bookkeeping
(``finalize``).  Fig. 9's per-dim activity and Fig. 11's utilization are
*derived views* of this record (:class:`repro_torch.obs.timeline.BwTimeline`),
as is the Chrome ``trace_event`` export (:meth:`Tracer.to_chrome_trace`)
viewable in Perfetto / ``chrome://tracing``.

Design constraints (the engines' contract):

  * **zero overhead when absent** — every engine call site is guarded by
    an ``if trc is not None`` branch (enforced by ``tools/lint_engine.py``);
    the disabled path costs one branch per event, same pattern as
    ``check_invariants``;
  * **bit-identical results when armed** — hooks only append to Python
    lists; they never consume the tie-break counter or the jitter RNG, so
    a traced run's ``SimResult`` equals the untraced run field-for-field
    (gated by ``benchmarks/obs_study.py`` and ``tests/test_engine_equiv``);
  * **no simulator imports** — the tracer treats op ids and results as
    duck-typed data, so ``repro_torch.core`` may import ``repro_torch.obs`` without a
    cycle.

Hot hooks append plain lists/tuples; all derivation (per-dim wire sums,
Chrome JSON, timelines) happens after the run.  One ``Tracer`` records
exactly one run: ``begin`` raises on reuse.

This is the port's copy of ``repro/obs/tracer.py``, the package names in
its docstrings aside; it leaves out nothing.
"""
from __future__ import annotations

import json
from array import array
from typing import Any

# Per-service record layout (mutable list — preemption amends in place):
#   [start, end, ops, groups, tenant, wire_bytes]
SVC_START, SVC_END, SVC_OPS, SVC_GROUPS, SVC_TENANT, SVC_WIRE = range(6)


class Tracer:
    """Records one simulation run's event stream (see module docstring).

    Attributes populated during the run (all simulated-time floats):

    ``services``
        Per-dim lists of ``[start, end, ops, groups, tenant, wire]``
        records, parallel to ``SimResult.dim_services``.  ``ops`` is the
        served ``(chunk_id, stage_idx)`` tuple in service order;
        ``tenant`` is the granted (head) tenant — exact attribution under
        an arbiter, whose batches are same-tenant; a fused mixed-tenant
        batch in single-job mode is charged to its head.  Preemption
        shortens the record in place (end, ops, wire all amended), so at
        end of run the records describe what actually drained.
    ``grants``
        Arbiter grant decisions: ``(dim, t, tenant, n_chunks, wire)`` —
        one per service start while an arbiter is installed.
    ``preempts``
        Service splits: ``(dim, svc_idx, t, new_end, cut_ops, cut_wire,
        penalty)``; the cut chunks requeue (``penalty == 0``) or re-arm
        ``penalty`` seconds later.
    ``enqueues``
        Ready-queue arrivals ``(dim, t)`` — one per chunk stage entering
        a dim's queue, including preemption requeues.  Combined with
        service batch sizes this yields exact queue-depth timelines.
        (Stored as two typed arrays — ``array`` appends allocate no
        GC-tracked objects, which keeps the hottest hook off the cyclic
        collector's ledger; ``enqueues`` is a materializing property.)
    ``releases``
        Dependency-gated group releases ``(group, t)`` — the instant a
        group's predecessors resolved and it became eligible (dependency
        mode only; fixed-time issues are inputs, not events).
    ``dep_edges``
        Dependency-edge resolutions ``(parent, child, t)`` — one per
        graph edge, at the parent's full-finish instant.  These become
        Perfetto flow arrows.
    """

    __slots__ = ("engine", "num_dims", "n_groups", "services", "grants",
                 "preempts", "enq_dims", "enq_times", "releases", "dep_edges",
                 "faults", "aborts", "rerates", "retries", "group_fails",
                 "replans", "sheds", "admits",
                 "makespan", "dim_bw", "dim_wire", "dim_busy",
                 "dim_activity", "group_issue", "group_finish",
                 "group_streams", "group_tenants", "topology_name",
                 "finished", "_armed")

    def __init__(self) -> None:
        self.engine: str | None = None
        self.num_dims = 0
        self.n_groups = 0
        self.services: list[list[list]] = []
        self.grants: list[tuple] = []
        self.preempts: list[tuple] = []
        self.enq_dims = array("i")
        self.enq_times = array("d")
        self.releases: list[tuple[int, float]] = []
        self.dep_edges: list[tuple[int, int, float]] = []
        # Fault-injection events (populated only when simulate(faults=...)):
        self.faults: list[tuple[int, float, float, float]] = []
        self.aborts: list[tuple[int, int, float, int, tuple, float]] = []
        self.rerates: list[tuple[int, int, float, float, float]] = []
        self.retries: list[tuple[int, tuple, float, int, float]] = []
        self.group_fails: list[tuple[int, float]] = []
        self.replans: list[tuple[float, tuple, tuple]] = []
        # Admission events (populated only when simulate(admission=...)):
        self.sheds: list[tuple[int, float]] = []
        self.admits: list[tuple[int, float]] = []
        # finalize() snapshots:
        self.makespan = 0.0
        self.dim_bw: list[float] = []
        self.dim_wire: list[float] = []
        self.dim_busy: list[float] = []
        self.dim_activity: list[list[tuple[float, float]]] = []
        self.group_issue: list[float] = []
        self.group_finish: list[float] = []
        self.group_streams: list[str] = []
        self.group_tenants: list[str] = []
        self.topology_name = ""
        self.finished = False
        self._armed = False

    # -- engine-facing hooks (hot; every call site is branch-guarded) --------
    def begin(self, num_dims: int, n_groups: int, engine: str) -> None:
        """Arm the tracer for one run.  A Tracer records exactly one
        simulation; re-arming raises (build a fresh one per run)."""
        if self._armed:
            raise RuntimeError(
                "Tracer already used; one Tracer records one simulate() run")
        self._armed = True
        self.engine = engine
        self.num_dims = num_dims
        self.n_groups = n_groups
        self.services = [[] for _ in range(num_dims)]

    def service_start(self, dim: int, start: float, end: float, ops,
                      groups: tuple, tenant: str, wire: float) -> None:
        # ``ops`` may be the engine's own op list, shared by reference —
        # the engines never mutate a served list in place (preemption
        # *replaces* their copy; ``service_preempt`` reslices ours).
        self.services[dim].append([start, end, ops, groups, tenant, wire])

    def enqueue(self, dim: int, t: float) -> None:
        self.enq_dims.append(dim)
        self.enq_times.append(t)

    def service_preempt(self, dim: int, svc_idx: int, now: float,
                        new_end: float, n_keep: int, cut_ops: tuple,
                        cut_wire: float, penalty: float) -> None:
        rec = self.services[dim][svc_idx]
        rec[SVC_END] = new_end
        rec[SVC_OPS] = rec[SVC_OPS][:n_keep]
        rec[SVC_WIRE] = rec[SVC_WIRE] - cut_wire
        self.preempts.append(
            (dim, svc_idx, now, new_end, cut_ops, cut_wire, penalty))

    def grant(self, dim: int, now: float, tenant: str, n_chunks: int,
              wire: float) -> None:
        self.grants.append((dim, now, tenant, n_chunks, wire))

    def release(self, group: int, t: float) -> None:
        self.releases.append((group, t))

    # -- fault-injection hooks (armed only via simulate(faults=...)) ---------
    def fault(self, dim: int, t: float, factor: float, sigma: float) -> None:
        """A fault boundary took effect: ``dim`` now runs at ``factor`` x
        nominal BW with ``sigma`` extra straggler noise."""
        self.faults.append((dim, t, factor, sigma))

    def service_abort(self, dim: int, svc_idx: int, now: float,
                      n_keep: int, cut_ops: tuple, cut_wire: float) -> None:
        """An outage cut an in-flight service; like ``service_preempt`` the
        record is amended in place to what actually drained."""
        rec = self.services[dim][svc_idx]
        rec[SVC_END] = now
        rec[SVC_OPS] = rec[SVC_OPS][:n_keep]
        rec[SVC_WIRE] = rec[SVC_WIRE] - cut_wire
        self.aborts.append((dim, svc_idx, now, n_keep, cut_ops, cut_wire))

    def service_rerate(self, dim: int, svc_idx: int, now: float,
                       new_end: float, scale: float) -> None:
        """A BW change re-rated an in-flight service (drained bytes
        conserved; the remainder finishes at ``new_end``)."""
        rec = self.services[dim][svc_idx]
        rec[SVC_END] = new_end
        self.rerates.append((dim, svc_idx, now, new_end, scale))

    def retry(self, dim: int, op, now: float, attempt: int,
              resume_at: float) -> None:
        """A queued chunk on a down dim timed out.  ``resume_at > now`` is
        a backoff re-arrival; ``resume_at == now`` is the final attempt
        (the group fails)."""
        self.retries.append((dim, op, now, attempt, resume_at))

    def group_failed(self, group: int, t: float) -> None:
        self.group_fails.append((group, t))

    def replan(self, t: float, groups: tuple, factors: tuple) -> None:
        """The graceful-degradation hook rewrote ``groups``'s un-issued
        chunk schedules against per-dim BW ``factors``."""
        self.replans.append((t, groups, factors))

    # -- admission hooks (armed only via simulate(admission=...)) ------------
    def group_shed(self, group: int, t: float) -> None:
        """The admission controller shed ``group`` (demand-side loss —
        distinct from ``group_failed``, which is a fabric-side loss)."""
        self.sheds.append((group, t))

    def admit(self, group: int, t: float) -> None:
        """The admission controller admitted ``group``'s unit at its first
        ready event (recorded once per unit, on the deciding group)."""
        self.admits.append((group, t))

    def dep_resolved(self, parent: int, child: int, t: float) -> None:
        self.dep_edges.append((parent, child, t))

    def finalize(self, result: Any, topology: Any) -> None:
        """Snapshot the run's final bookkeeping (called once by the engine
        after it assembles its ``SimResult``; not a hot path)."""
        self.makespan = result.makespan
        self.dim_bw = [d.aggr_bw_bytes for d in topology.dims]
        self.dim_wire = list(result.dim_wire_bytes)
        self.dim_busy = list(result.dim_busy)
        self.dim_activity = [list(a) for a in result.dim_activity]
        self.group_issue = list(result.group_issue)
        self.group_finish = list(result.group_finish)
        self.group_streams = list(result.group_streams)
        self.group_tenants = list(result.group_tenants)
        self.topology_name = getattr(topology, "name", "")
        self.finished = True

    # -- derived views -------------------------------------------------------
    @property
    def enqueues(self) -> list[tuple[int, float]]:
        """Ready-queue arrivals as ``(dim, t)`` tuples, in event order."""
        return list(zip(self.enq_dims, self.enq_times))

    def service_wire(self) -> list[float]:
        """Per-dim wire bytes re-derived from the service records, in
        record order — must match ``SimResult.dim_wire_bytes`` to float
        precision (the obs_study gate)."""
        out = []
        for dim in range(self.num_dims):
            acc = 0.0
            for rec in self.services[dim]:
                acc += rec[SVC_WIRE]
            out.append(acc)
        return out

    def service_busy(self) -> list[float]:
        """Per-dim busy time re-derived from service records."""
        out = []
        for dim in range(self.num_dims):
            acc = 0.0
            for rec in self.services[dim]:
                acc += rec[SVC_END] - rec[SVC_START]
            out.append(acc)
        return out

    def ops_served(self, dim: int) -> list:
        """Flat served-op order on ``dim`` — equals
        ``SimResult.dim_op_order[dim]``."""
        return [op for rec in self.services[dim] for op in rec[SVC_OPS]]

    def event_counts(self) -> dict[str, int]:
        return {
            "services": sum(len(s) for s in self.services),
            "grants": len(self.grants),
            "preempts": len(self.preempts),
            "enqueues": len(self.enq_times),
            "releases": len(self.releases),
            "dep_edges": len(self.dep_edges),
            "faults": len(self.faults),
            "aborts": len(self.aborts),
            "rerates": len(self.rerates),
            "retries": len(self.retries),
            "group_fails": len(self.group_fails),
            "replans": len(self.replans),
            "sheds": len(self.sheds),
            "admits": len(self.admits),
            "groups": self.n_groups,
        }

    # -- Chrome trace_event export -------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Export as a Chrome ``trace_event`` JSON object (open in Perfetto
        or ``chrome://tracing``).

        Layout: pid 0 is the *requests* track — one lane (tid) per stream
        tag, one complete event per group spanning issue→finish; pid
        ``1+dim`` is one track per network dimension — one lane per
        tenant, one complete event per service (args: ops, wire bytes,
        groups carried), instant events for preemption splits and arbiter
        grants.  Dependency releases are flow arrows (``ph: s/f``) from
        the parent group's span to the child's.  Timestamps are simulated
        microseconds.
        """
        if not self.finished:
            raise RuntimeError(
                "trace export needs a finished run (simulate() calls "
                "finalize); arm the tracer via simulate(..., tracer=...)")
        M = 1e6  # simulated seconds -> trace microseconds
        evs: list[dict] = []

        def meta(pid: int, name: str) -> None:
            evs.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name", "args": {"name": name}})

        def lane(pid: int, lanes: dict[str, int], tag: str) -> int:
            tid = lanes.get(tag)
            if tid is None:
                tid = lanes[tag] = len(lanes) + 1
                evs.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": tag}})
            return tid

        # pid 0: request groups, one lane per stream
        meta(0, f"requests ({self.topology_name})")
        stream_lanes: dict[str, int] = {}
        streams = self.group_streams or ["default"] * self.n_groups
        tenants = self.group_tenants or ["default"] * self.n_groups
        group_tid: dict[int, int] = {}
        for g in range(self.n_groups):
            tid = lane(0, stream_lanes, streams[g])
            group_tid[g] = tid
            iss, fin = self.group_issue[g], self.group_finish[g]
            evs.append({"ph": "X", "pid": 0, "tid": tid, "ts": iss * M,
                        "dur": max(fin - iss, 0.0) * M, "name": f"g{g}",
                        "cat": "group",
                        "args": {"tenant": tenants[g], "stream": streams[g],
                                 "issue_s": iss, "finish_s": fin}})
        # flow arrows: parent group finish -> child group release
        for i, (parent, child, t) in enumerate(self.dep_edges):
            common = {"cat": "dep", "name": "dep", "id": i, "pid": 0}
            evs.append({"ph": "s", "tid": group_tid[parent], "ts": t * M,
                        **common})
            evs.append({"ph": "f", "bp": "e", "tid": group_tid[child],
                        "ts": t * M, **common})

        # pid 1+dim: one track per dimension, one lane per tenant
        for dim in range(self.num_dims):
            pid = 1 + dim
            bw = self.dim_bw[dim] if dim < len(self.dim_bw) else 0.0
            meta(pid, f"dim{dim} (BW={bw / 1e9:.1f} GB/s)")
            tenant_lanes: dict[str, int] = {}
            for rec in self.services[dim]:
                tid = lane(pid, tenant_lanes, rec[SVC_TENANT])
                evs.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "ts": rec[SVC_START] * M,
                    "dur": (rec[SVC_END] - rec[SVC_START]) * M,
                    "name": f"svc x{len(rec[SVC_OPS])}", "cat": "service",
                    "args": {"ops": len(rec[SVC_OPS]),
                             "wire_bytes": rec[SVC_WIRE],
                             "groups": list(rec[SVC_GROUPS])}})
            for (d, svc_idx, t, new_end, cut_ops, cut_wire, pen) \
                    in self.preempts:
                if d != dim:
                    continue
                tenant = self.services[dim][svc_idx][SVC_TENANT]
                tid = lane(pid, tenant_lanes, tenant)
                evs.append({"ph": "i", "pid": pid, "tid": tid, "ts": t * M,
                            "s": "t", "name": "preempt", "cat": "preempt",
                            "args": {"cut_ops": len(cut_ops),
                                     "cut_wire_bytes": cut_wire,
                                     "penalty_s": pen}})
            for (d, t, tenant, n_chunks, wire) in self.grants:
                if d != dim:
                    continue
                tid = lane(pid, tenant_lanes, tenant)
                evs.append({"ph": "i", "pid": pid, "tid": tid, "ts": t * M,
                            "s": "t", "name": "grant", "cat": "grant",
                            "args": {"chunks": n_chunks,
                                     "wire_bytes": wire}})
            # Fault-injection instants (tid 0 — they affect the whole dim).
            for (d, t, factor, sigma) in self.faults:
                if d != dim:
                    continue
                evs.append({"ph": "i", "pid": pid, "tid": 0, "ts": t * M,
                            "s": "t", "name": f"fault f={factor:g}",
                            "cat": "fault",
                            "args": {"bw_factor": factor,
                                     "extra_sigma": sigma}})
            for (d, svc_idx, t, n_keep, cut_ops, cut_wire) in self.aborts:
                if d != dim:
                    continue
                evs.append({"ph": "i", "pid": pid, "tid": 0, "ts": t * M,
                            "s": "t", "name": "abort", "cat": "abort",
                            "args": {"kept_ops": n_keep,
                                     "cut_ops": len(cut_ops),
                                     "cut_wire_bytes": cut_wire}})
            for (d, svc_idx, t, new_end, scale) in self.rerates:
                if d != dim:
                    continue
                evs.append({"ph": "i", "pid": pid, "tid": 0, "ts": t * M,
                            "s": "t", "name": "rerate", "cat": "rerate",
                            "args": {"new_end_s": new_end,
                                     "rate_scale": scale}})
            for (d, op, t, attempt, resume_at) in self.retries:
                if d != dim:
                    continue
                evs.append({"ph": "i", "pid": pid, "tid": 0, "ts": t * M,
                            "s": "t", "name": f"retry #{attempt}",
                            "cat": "retry",
                            "args": {"op": list(op), "attempt": attempt,
                                     "resume_at_s": resume_at}})
        # Global (pid 0) fault instants: group failures and re-plans.
        for (g, t) in self.group_fails:
            evs.append({"ph": "i", "pid": 0, "tid": group_tid.get(g, 0),
                        "ts": t * M, "s": "t", "name": f"g{g} failed",
                        "cat": "group_fail", "args": {"group": g}})
        for (t, groups, factors) in self.replans:
            evs.append({"ph": "i", "pid": 0, "tid": 0, "ts": t * M,
                        "s": "g", "name": f"replan x{len(groups)}",
                        "cat": "replan",
                        "args": {"groups": list(groups),
                                 "bw_factors": list(factors)}})
        # Admission instants: shed / admitted requests on their lanes.
        for (g, t) in self.sheds:
            evs.append({"ph": "i", "pid": 0, "tid": group_tid.get(g, 0),
                        "ts": t * M, "s": "t", "name": f"g{g} shed",
                        "cat": "shed", "args": {"group": g}})
        for (g, t) in self.admits:
            evs.append({"ph": "i", "pid": 0, "tid": group_tid.get(g, 0),
                        "ts": t * M, "s": "t", "name": f"g{g} admitted",
                        "cat": "admit", "args": {"group": g}})
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"engine": self.engine,
                              "topology": self.topology_name,
                              "makespan_s": self.makespan}}

    def save(self, path) -> None:
        """Write the Chrome trace JSON to ``path`` (open in Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def parse_chrome_trace(source) -> dict[str, Any]:
    """Parse an exported trace (path or dict) back into summary counts —
    the round-trip check: counts must match the recording ``SimResult``'s
    bookkeeping.

    Returns ``{"groups": n, "services_per_dim": {dim: n}, "services": n,
    "preempts": n, "grants": n, "flows": n, "dims": n, "faults": n,
    "aborts": n, "rerates": n, "retries": n, "group_fails": n,
    "replans": n, "sheds": n, "admits": n}``.
    """
    if isinstance(source, dict):
        obj = source
    else:
        with open(source) as f:
            obj = json.load(f)
    groups = 0
    per_dim: dict[int, int] = {}
    preempts = grants = flows = 0
    faults = aborts = rerates = retries = group_fails = replans = 0
    sheds = admits = 0
    for ev in obj["traceEvents"]:
        cat = ev.get("cat")
        if cat == "group":
            groups += 1
        elif cat == "service":
            dim = ev["pid"] - 1
            per_dim[dim] = per_dim.get(dim, 0) + 1
        elif cat == "preempt":
            preempts += 1
        elif cat == "grant":
            grants += 1
        elif cat == "dep" and ev.get("ph") == "s":
            flows += 1
        elif cat == "fault":
            faults += 1
        elif cat == "abort":
            aborts += 1
        elif cat == "rerate":
            rerates += 1
        elif cat == "retry":
            retries += 1
        elif cat == "group_fail":
            group_fails += 1
        elif cat == "replan":
            replans += 1
        elif cat == "shed":
            sheds += 1
        elif cat == "admit":
            admits += 1
    return {"groups": groups, "services_per_dim": per_dim,
            "services": sum(per_dim.values()), "preempts": preempts,
            "grants": grants, "flows": flows,
            "faults": faults, "aborts": aborts, "rerates": rerates,
            "retries": retries, "group_fails": group_fails,
            "replans": replans, "sheds": sheds, "admits": admits,
            "dims": (max(per_dim) + 1) if per_dim else 0}

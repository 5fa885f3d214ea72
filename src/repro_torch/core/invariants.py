"""Runtime invariant sanitizer for the simulation engines.

``simulate(..., check_invariants=True)`` arms these checks inside the
event loop of *both* engines (indexed and reference), asserting the same
conservation / ordering / work-conservation theorems the offline SMT
prover (``repro_torch.verify``) states over small instances — so the formal
model and the implementation are checked against each other, not just
against our intentions:

  * **bytes conservation** — every chunk stage is served exactly once
    (preempted chunks re-serve, never duplicate or vanish), and each dim's
    accumulated wire bytes / busy time equal the sum over its services;
  * **service ordering** — per-dim service intervals are disjoint and
    start-ordered (a service never begins before the previous one drains);
  * **work conservation** — a dim never sits idle while its ready queue is
    non-empty (checked at every event boundary; enforced-order runs are
    exempt by design — they idle on purpose waiting for the mandated op);
  * **progress / attribution** — every request finishes no earlier than
    its resolved issue time, the makespan covers every finish and service,
    and (under an arbiter) the arbiter's served-bytes ledger delta matches
    the engine's per-dim wire accounting exactly.

All checks are guarded by a single local flag in the engines, so the
default ``check_invariants=False`` path costs one predictable branch per
event (gated by ``benchmarks/verify_study.py``).  Violations raise
:class:`InvariantViolation` with enough context to reproduce.

Float tolerances: wire bytes and busy times are re-accumulated here in a
different order than the engines accumulate them (and preemption
subtracts then re-adds), so equality checks are relative to ~1e-9 —
anything beyond that is a genuine accounting bug, not float drift.

This is the port's copy of ``repro/core/invariants.py``, as it is; it
leaves out nothing.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

# (op_id, dim, wire_bytes, tenant[, group]) — one row per chunk stage.
# The trailing group element is optional (fault-aware engines pass it so
# failed groups' abandoned work can be exempted from the lost-chunk check).
TaskRow = tuple[tuple[int, int], int, float, str]

_REL = 1e-9
_ABS_T = 1e-12   # seconds
_ABS_B = 1e-3    # bytes


class InvariantViolation(AssertionError):
    """A runtime engine invariant failed (see module docstring)."""


def _close(a: float, b: float, abs_tol: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL, abs_tol=abs_tol)


def check_work_conserving(dim: int, now: float, queue_len: int,
                          busy_until: float, inflight, engine: str) -> None:
    """Event-boundary check: ``dim`` must not be idle with a backlog.

    Called by both engines after a ready/free event settles.  A dim with
    queued work is either busy past ``now`` or has a service in flight
    (zero-occupancy services keep ``busy_until == now`` but set
    ``inflight`` until their free event fires).
    """
    if queue_len > 0 and busy_until <= now and inflight is None:
        raise InvariantViolation(
            f"[{engine}] work conservation violated on dim {dim} at "
            f"t={now:.9g}: {queue_len} task(s) queued but the dim is idle "
            f"(busy_until={busy_until:.9g}, no service in flight)")


def check_service_start(dim: int, now: float,
                        prev_end: float, engine: str) -> None:
    """A new service on ``dim`` must start at or after the previous one's
    (possibly preemption-shortened) end."""
    if now < prev_end - max(_ABS_T, _REL * abs(prev_end)):
        raise InvariantViolation(
            f"[{engine}] service overlap on dim {dim}: new service starts "
            f"at t={now:.9g} before previous end {prev_end:.9g}")


def check_final(
    *,
    engine: str,
    num_dims: int,
    tasks: Iterable[TaskRow],
    dim_wire: Sequence[float],
    dim_busy: Sequence[float],
    dim_order: Sequence[Sequence[tuple[int, int]]],
    dim_services: Sequence[Sequence[tuple]],
    group_finish: Sequence[float],
    resolved_issue: Sequence[float],
    makespan: float,
    enforced: bool = False,
    arbiter=None,
    served_base: dict | None = None,
    failed: frozenset | None = None,
    shed: frozenset | None = None,
) -> None:
    """End-of-run conservation / ordering / attribution checks (both
    engines call this with their own state; see module docstring).

    ``failed`` — the set of request groups the fault machinery marked
    failed (retry exhaustion).  A failed group's unserved stages are
    abandoned by design, so they are exempt from the lost-chunk check, and
    wire conservation is restated over the ops that actually served (their
    per-row wire bytes must still sum to the engine's accounting — the
    conservation theorem holds across re-rating, aborts and retries).

    ``shed`` — the groups the admission controller shed (demand-side
    losses, ``repro_torch.fleet``).  Same exemptions as ``failed``, plus the
    progress checks: a shed group's stale ``group_finish`` entry is its
    static issue time, which can sit on either side of the makespan (a
    late-arriving request shed on arrival never advances the clock).
    """
    dead = (failed or frozenset()) | (shed or frozenset())
    # -- every chunk stage served exactly once (bytes cannot vanish or
    #    duplicate across preemption splits) ------------------------------
    expected_wire = [0.0] * num_dims
    expected_ops: dict[tuple[int, int], int] = {}
    op_wire: dict[tuple[int, int], float] = {}
    op_group: dict[tuple[int, int], int] = {}
    for row in tasks:
        op, dim, wire = row[0], row[1], row[2]
        expected_wire[dim] += wire
        expected_ops[op] = dim
        op_wire[op] = wire
        if len(row) > 4:
            op_group[op] = row[4]
    served_count: dict[tuple[int, int], int] = {}
    for dim in range(num_dims):
        for op in dim_order[dim]:
            served_count[op] = served_count.get(op, 0) + 1
            if served_count[op] > 1:
                raise InvariantViolation(
                    f"[{engine}] chunk stage {op} served "
                    f"{served_count[op]} times on dim {dim}")
            if expected_ops.get(op) != dim:
                raise InvariantViolation(
                    f"[{engine}] chunk stage {op} served on dim {dim} but "
                    f"belongs to dim {expected_ops.get(op)}")
    if not enforced:
        # Enforced-order runs may legitimately strand tasks whose mandated
        # slot never arrives, and a failed group's remaining work is
        # abandoned by design; everywhere else a missing op is a lost chunk.
        lost = [op for op in expected_ops
                if op not in served_count
                and (not dead or op_group.get(op) not in dead)]
        if lost:
            raise InvariantViolation(
                f"[{engine}] {len(lost)} chunk stage(s) never served "
                f"(lost chunks): {sorted(lost)[:8]}...")
        if dead:
            # Conservation over what actually drained: failed/shed groups'
            # unserved stages moved no bytes, so the expectation is the sum
            # of served ops' wire bytes per dim.
            expected_wire = [0.0] * num_dims
            for dim in range(num_dims):
                for op in dim_order[dim]:
                    expected_wire[dim] += op_wire[op]
        for dim in range(num_dims):
            if not _close(dim_wire[dim], expected_wire[dim], _ABS_B):
                raise InvariantViolation(
                    f"[{engine}] wire-byte conservation violated on dim "
                    f"{dim}: accounted {dim_wire[dim]!r} != sum of task "
                    f"wire bytes {expected_wire[dim]!r}")

    # -- per-dim service intervals: start-ordered, disjoint, and summing to
    #    the dim's busy time ---------------------------------------------
    for dim in range(num_dims):
        busy = 0.0
        prev_end = None
        for start, end, _groups in dim_services[dim]:
            if end < start - _ABS_T:
                raise InvariantViolation(
                    f"[{engine}] negative-length service on dim {dim}: "
                    f"[{start!r}, {end!r}]")
            if prev_end is not None and start < prev_end - max(
                    _ABS_T, _REL * abs(prev_end)):
                raise InvariantViolation(
                    f"[{engine}] overlapping services on dim {dim}: start "
                    f"{start!r} < previous end {prev_end!r}")
            prev_end = end
            busy += end - start
            if end > makespan + max(_ABS_T, _REL * abs(makespan)):
                raise InvariantViolation(
                    f"[{engine}] service on dim {dim} ends at {end!r} past "
                    f"the makespan {makespan!r}")
        if not _close(dim_busy[dim], busy, _ABS_T):
            raise InvariantViolation(
                f"[{engine}] busy-time accounting violated on dim {dim}: "
                f"{dim_busy[dim]!r} != sum of service lengths {busy!r}")

    # -- progress: finishes cover issues, makespan covers finishes ---------
    for g, (fin, iss) in enumerate(zip(group_finish, resolved_issue)):
        if dead and g in dead:
            continue  # never finished; its finish entry is a stale default
        if fin < iss - max(_ABS_T, _REL * abs(iss)):
            raise InvariantViolation(
                f"[{engine}] group {g} finished at {fin!r} before its "
                f"resolved issue time {iss!r}")
        if fin > makespan + max(_ABS_T, _REL * abs(makespan)):
            raise InvariantViolation(
                f"[{engine}] group {g} finishes at {fin!r} past the "
                f"makespan {makespan!r}")

    # -- arbiter ledger vs engine accounting ------------------------------
    if (arbiter is not None and served_base is not None
            and hasattr(arbiter, "served_snapshot") and not enforced):
        served_now = arbiter.served_snapshot()
        keys = set(served_base) | set(served_now)
        per_dim = [0.0] * num_dims
        for key in keys:
            dim = key[0]
            if dim < num_dims:
                per_dim[dim] += (served_now.get(key, 0.0)
                                 - served_base.get(key, 0.0))
        for dim in range(num_dims):
            if not _close(per_dim[dim], dim_wire[dim], _ABS_B):
                raise InvariantViolation(
                    f"[{engine}] arbiter served-bytes ledger disagrees with "
                    f"engine wire accounting on dim {dim}: ledger delta "
                    f"{per_dim[dim]!r} != dim_wire {dim_wire[dim]!r} (a "
                    f"preemption refund or double charge went missing)")

"""The theorems stated over :class:`repro_torch.verify.encode.Encoding`s.

Each :class:`Property` maps an encoding (constraint system + witness) to
one closed formula over the encoding's variables.  The harness decides
``constraints => formula``: witness evaluation when z3 is absent (the
systems are functionally determined — see :mod:`repro_torch.verify.smt`), a
real linear-arithmetic proof when it is installed.

  * **work_conservation** — no dim idles between consecutive services
    while a task it will serve later was already ready: ``S_{k+1} <=
    max(F_k, earliest ready among later-served ops)``.  Preemption re-arm
    (``preempt_penalty_s``) is not idleness: cut chunks are not ready
    until the penalty elapses, and their ready times say so.
  * **bytes_conservation** — per dim, the drained service time times the
    bandwidth equals the scheduled task bytes: ``sum_k (F_k - S_k) * bw
    == expected_wire`` — preemption splits must neither lose nor
    double-serve bytes.
  * **no_lost_chunks** — every scheduled chunk stage is served exactly
    once (its final service; cut-and-requeued chunks re-serve), and every
    request completes at or after its issue.
  * **starvation_freedom** — the designated victim tenant (lowest
    priority / weight) completes by a finite bound derived from total
    load: under strict-priority with finite high-priority load the
    victim cannot be starved forever.
  * **bounded_slowdown** — over a window where two tenants are both
    backlogged on the contended dim, their weight-normalized service
    differs by at most a few quanta:
    ``|B_T/w_T - B_U/w_U| <= slack``.  This is the property the
    weighted-fair virtual-time staleness bug breaks: with ``vt_clamp``
    off, a re-arriving tenant's stale clock lets it monopolize the dim
    (see the ``wf-rearrival-stale`` instance, whose counterexample is
    pinned as a regression test).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.verify import smt
from repro_torch.verify.encode import Encoding, FabricInstance
from repro_torch.verify.smt import Abs, And, BoolConst, Const, Max


@dataclass(frozen=True)
class Property:
    name: str
    description: str
    formula: Callable[[Encoding], smt.Expr]

    def applies(self, inst: FabricInstance) -> bool:
        if self.name == "bounded_slowdown":
            # A fairness claim about weights: meaningful for the fair
            # policies (where it must hold) and for fifo (where it is
            # expected to be refuted — fifo ignores weights).
            return inst.policy in ("weighted-fair", "slo-aware", "fifo")
        return True


def work_conservation(enc: Encoding) -> smt.Expr:
    parts = []
    for dim in range(len(enc.services)):
        svcs = enc.services[dim]
        for k, svc in enumerate(svcs):
            later_ready = [enc.op_ready[op]
                           for later in svcs[k:] for op in later.ops]
            if not later_ready:
                continue
            r_min = Const(min(later_ready))
            if k == 0:
                parts.append(svc.svar() <= r_min)
            else:
                parts.append(svc.svar() <= Max(svcs[k - 1].fvar(), r_min))
    return And(*parts) if parts else BoolConst(True)


# Conservation compares an accumulated sum of (finish - start) * bandwidth
# against the scheduled byte total: the subtraction of ~1e-3-scale times
# blown up by ~1e10-scale bandwidth leaves ulp noise, so the theorem is
# stated to byte precision (same scale as invariants._ABS_B) rather than
# as exact equality — a real lost or double-served chunk is >= one chunk.
_BYTES_TOL = 1e-3


def bytes_conservation(enc: Encoding) -> smt.Expr:
    parts = []
    for dim in range(len(enc.services)):
        drained = smt.Sum([(svc.fvar() - svc.svar()) * Const(enc.bw[dim])
                           for svc in enc.services[dim]])
        parts.append(Abs(drained - Const(enc.expected_wire[dim]))
                     <= Const(_BYTES_TOL))
    return And(*parts)


def no_lost_chunks(enc: Encoding) -> smt.Expr:
    served_once = all(
        enc.op_count.get(op, 0) == 1 for op in enc.expected_ops)
    right_dim = all(
        enc.op_service[op].dim == enc.expected_ops[op][0]
        for op in enc.op_service)
    parts: list = [BoolConst(served_once and right_dim)]
    for g, req in enumerate(enc.requests):
        if f"C_{g}" in enc.env:
            parts.append(Const(req.issue_time) <= enc.cvar(g))
    return And(*parts)


def starvation_freedom(enc: Encoding) -> smt.Expr:
    """The victim tenant completes by a finite closed-form bound.

    Bound: last issue + total serialized drain time across dims + one
    fixed latency per served op + one penalty per possible preemption.
    Any discipline that eventually serves finite load beats it; a
    starved tenant blows past it as load grows.
    """
    inst = enc.instance
    victim = min(
        inst.tenants,
        key=lambda s: (s.priority, s.weight)).name
    drain = sum(enc.expected_wire[d] / enc.bw[d]
                for d in range(len(enc.bw)))
    n_ops = len(enc.expected_ops)
    max_a = max((svc.a for per in enc.services for svc in per),
                default=0.0)
    last_issue = max((r.issue_time for r in enc.requests), default=0.0)
    bound = last_issue + drain + n_ops * (max_a + enc.penalty)
    parts = []
    for g, req in enumerate(enc.requests):
        if req.tenant == victim and f"C_{g}" in enc.env:
            parts.append(enc.cvar(g) <= Const(bound))
    return And(*parts) if parts else BoolConst(True)


def bounded_slowdown(enc: Encoding) -> smt.Expr:
    inst = enc.instance
    dim = inst.contended_dim
    names = [s.name for s in inst.tenants]
    max_chunk = max((b for per in enc.services for svc in per
                     for b in svc.op_bytes.values()), default=0.0)
    parts = []
    for i, t1 in enumerate(names):
        for t2 in names[i + 1:]:
            lo1, hi1 = enc.tenant_span(t1, dim)
            lo2, hi2 = enc.tenant_span(t2, dim)
            if inst.slowdown_window_start is not None:
                w0 = (enc.assignment[inst.slowdown_window_start]
                      if isinstance(inst.slowdown_window_start, str)
                      else float(inst.slowdown_window_start))
            else:
                w0 = max(lo1, lo2)
            w1 = min(hi1, hi2)
            if w1 <= w0 or lo1 > w0 or lo2 > w0:
                continue  # pair never jointly backlogged over the window
            w1_ = max(s.weight for s in inst.tenants if s.name == t1)
            w2_ = max(s.weight for s in inst.tenants if s.name == t2)
            slack = (inst.slowdown_slack_quanta * inst.quantum_chunks
                     * max_chunk * (1.0 / w1_ + 1.0 / w2_))
            b1 = enc.tenant_window_bytes(t1, dim, w0, w1)
            b2 = enc.tenant_window_bytes(t2, dim, w0, w1)
            parts.append(
                Abs(b1 * Const(1.0 / w1_) - b2 * Const(1.0 / w2_))
                <= Const(slack))
    return And(*parts) if parts else BoolConst(True)


ALL_PROPERTIES: tuple[Property, ...] = (
    Property("work_conservation",
             "no dim idles while a task it serves later is ready",
             work_conservation),
    Property("bytes_conservation",
             "per-dim drained bytes equal scheduled task bytes",
             bytes_conservation),
    Property("no_lost_chunks",
             "every chunk stage served exactly once, on its dim",
             no_lost_chunks),
    Property("starvation_freedom",
             "the victim tenant completes within a finite load bound",
             starvation_freedom),
    Property("bounded_slowdown",
             "jointly-backlogged tenants get weight-proportional service",
             bounded_slowdown),
)

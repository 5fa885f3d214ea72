"""Compiled cohort engine — the ``engine="compiled"`` fast path.

The indexed engine (``repro_torch.core.simulator._simulate_indexed``) is
near-linear but *loop-bound*: every stage-op costs a ready-event heap
push/pop on the global event heap, a keyed push into its dim's ready
heap, and a fused pop in ``select_batch`` — ~6 interpreted heap
operations per op.  This engine removes per-event Python from the fast
path by processing event **cohorts**:

  * **Cohort events.**  A service completion releases its whole batch's
    successor stages at one instant with *contiguous* arrival seqs (the
    indexed engine pushes them back-to-back, consuming consecutive
    ``seq`` values with nothing interleaved).  One heap entry
    ``(t, s0, READY, [handles])`` therefore represents the whole wave,
    and the global event heap shrinks from O(stage-ops) live entries to
    O(dims) — frees, dones, and pending cohorts.
  * **Struct-of-arrays precompute.**  Per-dim key uniformity, initial
    arrival cohorts, saturation caps and fused wire sums are derived
    from the :class:`~repro_torch.core.simulator.TaskArrays` columns in fused
    numpy ops before the loop starts (the ``vector-zone`` sections,
    enforced by ``tools/lint_engine.py``).
  * **O(1) list queues.**  When every op targeting a dim shares one
    ``(priority, wire, fixed)`` key, the indexed engine's per-dim heap
    order degenerates to arrival-seq order; the queue becomes two
    append-only lists with head pointers (initial-stage arrivals sort
    before all chain arrivals because their seqs were assigned at
    setup), and ``select_batch`` is a slice whose wire sum and
    saturation cap were precomputed.  Heterogeneous dims keep the exact
    indexed heap keys.

**Bit-identity contract.**  The numpy-cohort path is bit-identical to
``engine="indexed"`` (which is itself bit-identical to the reference
oracle): the tie-break counter advances through the same values in the
same order (1 per readied stage, 3 per service), the jitter/straggler
RNG is drawn at the same points, and every float accumulation (batch
wire sums, ``dim_busy``/``dim_wire``) runs in the same sequence —
``SimResult.diff_fields`` returns ``[]`` against the indexed engine on
any eligible input.  ``tests/test_engine_equiv.py`` and the
``benchmarks/sched_perf.py`` 28-scenario matrix gate this.

**Eligibility and fallback.**  The compiled engine covers the
no-preemption fast path only: intra SCF/FIFO, fusion, priorities,
issue times, tenants/streams, jitter/straggler noise, and
dependency-gated release.  Features that preempt or instrument the
event loop — ``arbiter``, ``enforced_order``, ``faults``,
``admission``, ``tracer``, ``replanner``, ``check_invariants`` — fall
back to ``engine="indexed"`` automatically and silently (the same
duck-typed fallback pattern as the indexed engine's non-indexable
arbiters).  The single documented fallback signal is
:data:`LAST_FALLBACK` / :data:`FALLBACK_COUNTS` (and the
``simulate.compiled.fallback`` counter on an installed
:class:`repro_torch.obs.metrics.MetricsRegistry`); no warning is emitted.

**The wave kernel.**  :func:`wave_done_times` runs the inner
no-preemption kernel (FIFO, fusion-off, rank-synchronous) as vectorized
torch on the card: stable sorts, a cumsum and a cummax per dim segment
(:func:`_wave_scan`).  Its results are *numeric*, not bit-exact: its
closed form reassociates the recurrence, so it agrees with the cohort
engine within rounding in float64.  :data:`JIT_RTOL` is the tolerance
against the reference's ``jax.jit`` kernel, which runs in float32.

This is the port's copy of ``repro/core/engine_compiled.py``: the same
code, imports aside, except that the reference's ``jax.jit`` wave kernel
(``_get_wave_kernel``) is replaced by :func:`_wave_scan` in torch, with
the sequential :func:`wave_done_times_plain` beside it for the tests.
"""
from __future__ import annotations

import gc
import heapq
import itertools
import math
import random

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.simulator import (
    ServiceInterval,
    SimResult,
    TaskArrays,
    build_task_arrays,
)
from repro_torch.obs.metrics import current_registry
from repro_torch.topology import Topology

# Documented numeric tolerance of the reference's jax.jit wave kernel vs
# the cohort engine (relative).  float32-safe; see module docstring.
JIT_RTOL = 1e-4

# ---------------------------------------------------------------------------
# Fallback signal — the single documented channel (no warnings).
# ---------------------------------------------------------------------------
#: Reason string of the most recent compiled->indexed fallback in this
#: process, or None if none has happened (or since reset_fallbacks()).
LAST_FALLBACK: str | None = None
#: reason -> count of compiled->indexed fallbacks in this process.
FALLBACK_COUNTS: dict[str, int] = {}

# Keyword features outside the compiled fast path, in check order.
FAST_PATH_BLOCKERS = ("arbiter", "enforced_order", "faults", "admission",
                      "tracer", "replanner", "check_invariants")


def fast_path_blocker(*, arbiter=None, enforced_order=None, faults=None,
                      admission=None, tracer=None, replanner=None,
                      check_invariants: bool = False) -> str | None:
    """First requested feature the compiled fast path cannot serve, or
    None when ``engine="compiled"`` is eligible."""
    if arbiter is not None:
        return "arbiter"
    if enforced_order is not None:
        return "enforced_order"
    if faults is not None:
        return "faults"
    if admission is not None:
        return "admission"
    if tracer is not None:
        return "tracer"
    if replanner is not None:
        return "replanner"
    if check_invariants:
        return "check_invariants"
    return None


def record_fallback(reason: str) -> None:
    """Record a compiled->indexed fallback (deterministic, warning-free).

    Inspect :data:`LAST_FALLBACK` / :data:`FALLBACK_COUNTS`, or the
    ``simulate.compiled.fallback`` counters on an installed metrics
    registry."""
    global LAST_FALLBACK
    LAST_FALLBACK = reason
    FALLBACK_COUNTS[reason] = FALLBACK_COUNTS.get(reason, 0) + 1
    reg = current_registry()
    if reg is not None:
        reg.inc("simulate.compiled.fallback")
        reg.inc(f"simulate.compiled.fallback.{reason}")


def reset_fallbacks() -> None:
    """Clear the fallback signal (test isolation)."""
    global LAST_FALLBACK
    LAST_FALLBACK = None
    FALLBACK_COUNTS.clear()


def _as_list(col) -> list:
    """TaskArrays column as a plain Python list (scalar indexing in the
    event loop is ~5x faster on lists than on numpy arrays)."""
    if type(col) is list:
        return col
    if hasattr(col, "tolist"):
        return col.tolist()
    return list(col)


# Event kinds (tuple layout (t, seq, kind, payload); seqs are unique so
# kind/payload are never compared by the heap).
_READY, _FREE, _DONE = 0, 1, 2


def _np_cols(ta: TaskArrays) -> tuple:
    """Numpy views of the TaskArrays columns the precompute zones need
    (dim, wire, fixed, prio, group, last), cached on the TaskArrays'
    ``_np_cols`` slot.  Replays of one prebuilt TaskArrays (the
    batch/benchmark pattern) skip the O(n) list->array conversions;
    the cache dies with its TaskArrays."""
    cols = getattr(ta, "_np_cols", None)
    if cols is None:
        cols = (np.asarray(ta.dim, dtype=np.int64),
                np.asarray(ta.wire, dtype=np.float64),
                np.asarray(ta.fixed, dtype=np.float64),
                np.asarray(ta.prio, dtype=np.int64),
                np.asarray(ta.group, dtype=np.int64),
                np.asarray(ta.last, dtype=bool))
        try:
            ta._np_cols = cols
        except AttributeError:  # pragma: no cover - foreign container
            pass
    return cols


def _small_unique(a: np.ndarray) -> np.ndarray:
    """Sorted distinct values of ``a``, cheap when cardinality is small.

    Collective streams have a handful of distinct wire/priority values
    per dim; probing a prefix and verifying membership with a binary
    search is O(n log k) instead of np.unique's full O(n log n) sort."""
    if len(a) > 8192:
        head = np.unique(a[:4096])
        if len(head) < 1024:
            pos = np.searchsorted(head, a)
            pos[pos == len(head)] = len(head) - 1
            if bool((head[pos] == a).all()):
                return head
    return np.unique(a)


def simulate_compiled(
    topology: Topology,
    chunk_groups,
    *,
    issue_times: list[float],
    priorities: list[int],
    intra: str,
    fusion: bool,
    fusion_limit: int,
    jitter: float,
    seed: int,
    tenants: list[str],
    streams: list[str],
    task_arrays: TaskArrays | None = None,
    deps: list[tuple[int, ...]] | None = None,
    dep_delay: list[float] | None = None,
) -> SimResult:
    """Cohort-vectorized fast-path engine (see module docstring).

    Bit-identical to ``_simulate_indexed`` on every eligible input; the
    dispatcher (``simulate(engine="compiled")``) guarantees eligibility
    before calling this.

    The run pauses the cyclic garbage collector (restored on exit): the
    engine allocates millions of cohort payloads/batch slices that are
    provably acyclic, and generational scans of the struct-of-arrays
    columns would otherwise dominate at 10M+ stage-ops.
    """
    gc_was = gc.isenabled()
    if gc_was:
        gc.disable()
    try:
        return _run_compiled(
            topology, chunk_groups, issue_times=issue_times,
            priorities=priorities, intra=intra, fusion=fusion,
            fusion_limit=fusion_limit, jitter=jitter, seed=seed,
            tenants=tenants, streams=streams, task_arrays=task_arrays,
            deps=deps, dep_delay=dep_delay)
    finally:
        if gc_was:
            gc.enable()


def _run_compiled(
    topology: Topology,
    chunk_groups,
    *,
    issue_times: list[float],
    priorities: list[int],
    intra: str,
    fusion: bool,
    fusion_limit: int,
    jitter: float,
    seed: int,
    tenants: list[str],
    streams: list[str],
    task_arrays: TaskArrays | None = None,
    deps: list[tuple[int, ...]] | None = None,
    dep_delay: list[float] | None = None,
) -> SimResult:
    rng = random.Random(seed)
    lm = LatencyModel.for_topology(topology)
    tbl = lm.stage_tables
    num_dims = topology.num_dims
    n_groups = len(chunk_groups)

    ta = task_arrays
    if ta is None:
        ta = build_task_arrays(lm, chunk_groups, priorities, tenants)
    n_tasks = ta.n_tasks
    t_chunk = _as_list(ta.chunk)
    t_stage = _as_list(ta.stage)
    t_dim = _as_list(ta.dim)
    t_wire = _as_list(ta.wire)
    t_fixed = _as_list(ta.fixed)
    t_group = _as_list(ta.group)
    t_prio = _as_list(ta.prio)
    t_last = _as_list(ta.last)
    first_handles = _as_list(ta.first_handles)
    group_wire = list(ta.group_wire)

    busy_until = [0.0] * num_dims
    dim_busy = [0.0] * num_dims
    dim_wire = [0.0] * num_dims
    svc_batches: list[list[list[int]]] = [[] for _ in range(num_dims)]
    # Shared (chunk, stage) tuples, cached on the TaskArrays: building 10M
    # tuples on the event loop's fragmented heap is 3-5x slower than on a
    # fresh one, and replays of a prebuilt TaskArrays reuse them outright.
    pairs = getattr(ta, "_pairs", None)
    if pairs is None:
        pairs = list(zip(t_chunk, t_stage))
        try:
            ta._pairs = pairs
        except AttributeError:  # pragma: no cover - foreign container
            pass
    activity: list[list[tuple[float, float]]] = [[] for _ in range(num_dims)]
    pending_since: list[float | None] = [None] * num_dims
    group_finish = [t for t in issue_times]
    resolved_issue = list(issue_times)
    straggler = [d.straggler_sigma for d in topology.dims]
    dim_bw = tbl.bw
    scf = intra == "SCF"
    use_deps = deps is not None
    n_first = len(first_handles)

    # ---- SoA precompute: uniformity + initial cohorts ----------------------
    # lint: vector-zone-begin  (fused numpy ops only; no per-event mutation)
    dim_np, wire_np, fixed_np, prio_np, group_np, last_np = _np_cols(ta)
    if n_first and not use_deps:
        first_np = np.asarray(first_handles, dtype=np.int64)
        issue_np = np.asarray(issue_times, dtype=np.float64)
        init_times = issue_np[group_np[first_np]]
        sorted_issue = bool((init_times[1:] >= init_times[:-1]).all())
        # Runs of equal emission time become one arrival cohort each; the
        # run's seqs are contiguous by construction (setup assigns seq
        # 0..n_first-1 in handle order, exactly like the indexed engine).
        brk = np.flatnonzero(init_times[1:] != init_times[:-1]) + 1
        run_starts = np.concatenate(([0], brk))
        run_ends = np.concatenate((brk, [n_first]))
        cohort_t = init_times[run_starts]
        # Processing order is heap-pop order (t, s0); a stable lexsort is
        # the identity when issue times are already non-decreasing.
        order = np.lexsort((run_starts, cohort_t))
    else:
        sorted_issue = True
        order = np.empty(0, dtype=np.int64)
        run_starts = run_ends = cohort_t = order
    # lint: vector-zone-end

    if n_first and not use_deps:
        init_t = cohort_t[order].tolist()
        init_s = run_starts[order].tolist()
        init_h = [first_handles[s:e]
                  for s, e in zip(run_starts[order].tolist(),
                                  run_ends[order].tolist())]
    else:
        init_t = []
        init_s = []
        init_h = []

    # ---- size-class list queues --------------------------------------------
    # A dim's ready heap pops by (-prio, wire, arr) under SCF / (-prio, arr)
    # under FIFO.  Grouping the dim's ops into *classes* — one per distinct
    # key prefix — turns the heap into a fixed scan over per-class FIFO
    # lists: pop order is class-key order, then arrival-seq order within a
    # class.  Arrival order splits into two append-only lists per class
    # (initial stages carry setup seqs 0..n_first-1, which sort before every
    # dynamically assigned seq), so a pop is a head-pointer bump.  This is
    # valid only when queue-pop order provably equals arrival order per
    # class: no dep-gated (future-time, out-of-seq) releases, initial
    # arrivals emitted in non-decreasing time order, uniform per-dim fixed
    # delay (the saturation threshold and the batch's max), and a bounded
    # class count (the per-service scan is O(classes)).
    list_ok = (not use_deps) and sorted_issue
    # Discovery is pure ta-column + intra-policy data, so its result is
    # cached per TaskArrays keyed by the SCF flag (replays skip ~10 full
    # column passes); everything cached is treated as immutable.
    cached = None
    if list_ok:
        cc = getattr(ta, "_cls_cache", None)
        if isinstance(cc, dict):
            cached = cc.get(scf)
    if cached is not None:
        qmode, cls_slots, cls_np, cls_w, cls_fastf, n_slots, uni_fx_l = cached
    else:
        qmode = [False] * num_dims
        cls_slots = [[] for _ in range(num_dims)]
        cls_np = np.zeros(n_tasks, dtype=np.int64)
        cls_w = []      # per-slot uniform wire (fast slots)
        cls_fastf = []  # per-slot: wire uniform within class?
        uni_fx_l = [0.0] * num_dims  # uniform per-dim fixed delay
        n_slots = 0
    if list_ok and cached is None:
        # lint: vector-zone-begin  (class discovery is fused numpy)
        for d in range(num_dims):
            idx = np.flatnonzero(dim_np == d)
            if not len(idx):
                qmode[d] = True
                continue
            fx0 = float(fixed_np[idx[0]])
            if not (fixed_np[idx] == fx0).all():
                continue
            # Rank (-prio, wire) lexicographically via two 1-D uniques
            # (np.unique(axis=0) row-sorts through a void view — far too
            # slow at 10M ops).  Composite rank = prio_rank * n_wire +
            # wire_rank preserves the heap's lexicographic class order.
            wvals = wire_np[idx]
            npr = -prio_np[idx]
            pr_uniq = _small_unique(npr)
            pr_rank = np.searchsorted(pr_uniq, npr)
            if scf:
                w_uniq = _small_unique(wvals)
                nk = len(pr_uniq) * len(w_uniq)
                if nk > 4096:
                    continue
                comp = pr_rank * len(w_uniq) + np.searchsorted(w_uniq, wvals)
            else:
                nk = len(pr_uniq)
                if nk > 4096:
                    continue
                comp = pr_rank
            # occupancy + dense renumber via bincount (no O(n log n) sort)
            present = np.flatnonzero(np.bincount(comp, minlength=nk))
            nc = len(present)
            if nc > 64:
                continue
            remap = np.zeros(nk, dtype=np.int64)
            remap[present] = np.arange(nc)
            inv = remap[comp]
            if scf:
                wu = np.zeros(nc)
                wu[inv] = wvals          # uniform within class by key
                fastmask = np.ones(nc, dtype=bool)
            else:
                wmin = np.full(nc, np.inf)
                wmax = np.full(nc, -np.inf)
                np.minimum.at(wmin, inv, wvals)
                np.maximum.at(wmax, inv, wvals)
                fastmask = wmin == wmax
                wu = wmin
            cls_np[idx] = n_slots + inv
            cls_slots[d] = list(range(n_slots, n_slots + nc))
            cls_w.extend(wu.tolist())        # lint: allow (<=64 classes/dim)
            cls_fastf.extend(bool(b) for b in fastmask)  # lint: allow (<=64)
            n_slots += nc
            qmode[d] = True
            uni_fx_l[d] = fx0
        # lint: vector-zone-end
        try:
            if not isinstance(getattr(ta, "_cls_cache", None), dict):
                ta._cls_cache = {}
            ta._cls_cache[scf] = (qmode, cls_slots, cls_np, cls_w,
                                  cls_fastf, n_slots, uni_fx_l)
        except AttributeError:  # pragma: no cover - foreign container
            pass
    # Scalar class lookups happen only on slow paths and sub-cohort-size
    # payloads; indexing the numpy array there beats materializing 10M
    # fresh int objects per run (a measurable page-fault tax at scale).
    cls_of = cls_np
    # Pre-split each initial cohort into per-class segments (class slot,
    # handle list): the bulk arrival branch then routes a whole cohort with
    # one extend per class and no per-handle scan.  Only within-class order
    # is observable (queues are per-class), and a stable argsort preserves
    # it.
    if n_first and not use_deps and all(qmode):
        # lint: vector-zone-begin  (per-cohort class splits)
        cls_first = cls_np[first_np]
        init_parts = []
        for s, e in zip(run_starts[order].tolist(),
                        run_ends[order].tolist()):
            seg = cls_first[s:e]
            c0 = seg[0]
            if bool((seg == c0).all()):
                init_parts.append(  # lint: allow (one tuple per cohort)
                    ((int(c0), first_handles[s:e]),))
            else:
                o2 = np.argsort(seg, kind="stable")
                segs = seg[o2]
                hs = first_np[s:e][o2]
                b2 = np.flatnonzero(segs[1:] != segs[:-1]) + 1
                bounds = [0, *b2.tolist(), len(segs)]
                init_parts.append(tuple(  # lint: allow (one per cohort)
                    (int(segs[bounds[j]]),
                     hs[bounds[j]:bounds[j + 1]].tolist())
                    for j in range(len(bounds) - 1)))
        # lint: vector-zone-end
    else:
        init_parts = None
    need_arr = use_deps or not all(qmode)
    t_arr = [0] * n_tasks if need_arr else None
    if need_arr and not use_deps:
        for i, hh in enumerate(first_handles):
            t_arr[hh] = i

    # Saturation threshold for list-mode dims (uniform fixed delay is
    # recorded by class discovery; zero for dims with no ops).
    sat_d = [uni_fx_l[d] * dim_bw[d] if qmode[d] else 0.0
             for d in range(num_dims)]

    # Per-slot O(1) batch tables: from a fresh batch, a wire-uniform class
    # stops growing at cls_cap[s] ops (the first k where the sequential
    # total reaches saturation or fusion_limit); cls_wsum[s][k] is the
    # k-fold sequential float sum from 0.0 — bit-for-bit the indexed
    # engine's `wire += t_wire[hh]` accumulation.
    cls_cap = [0] * n_slots
    cls_wsum: list[list[float]] = [[0.0]] * n_slots
    for d in range(num_dims):
        sat = sat_d[d]
        for s in cls_slots[d]:
            if not cls_fastf[s]:
                continue
            w = cls_w[s]
            kcap = 1
            tot = w
            if fusion:
                while tot < sat and kcap < fusion_limit:
                    tot += w
                    kcap += 1
            acc = 0.0
            ws = [0.0]
            for _ in range(kcap):
                acc += w
                ws.append(acc)
            cls_cap[s] = kcap
            cls_wsum[s] = ws

    qi_c: list[list[int]] = [[] for _ in range(n_slots)]  # initial stages
    hi_c = [0] * n_slots
    qd_c: list[list[int]] = [[] for _ in range(n_slots)]  # chain stages
    hd_c = [0] * n_slots
    # Per-service scan order: class-key order, initial before dynamic.
    # Entry: (queue list, head array, slot, fresh-batch cap (0 = scalar
    # path), fresh-batch wire sums).
    scan_d: list[list[tuple]] = [
        [entry for s in cls_slots[d]
         for entry in ((qi_c[s], hi_c, s, cls_cap[s], cls_wsum[s]),
                       (qd_c[s], hd_c, s, cls_cap[s], cls_wsum[s]))]
        for d in range(num_dims)
    ]
    all_q = all(qmode) and not use_deps
    # Count of dims whose pending-interval clock is unset.  When it is zero
    # AND every dim is busy past `now`, an arrival cohort cannot trigger
    # try_start or touch pending_since — it reduces to pure queue appends
    # (the bulk fast path).  Dims that never receive an op are excluded:
    # their clock stays None forever, and parking their busy_until at +inf
    # keeps them out of the all-busy min().
    used_dims = np.zeros(num_dims, dtype=bool)
    used_dims[dim_np] = True
    n_pend_none = int(used_dims.sum())
    for d in range(num_dims):
        if not used_dims[d]:
            busy_until[d] = float("inf")
    heaps: list[list] = [[] for _ in range(num_dims)]     # exact indexed keys
    events: list[tuple] = []
    heappush = heapq.heappush
    heappop = heapq.heappop
    sq = n_first if not use_deps else 0  # tie-break counter (int, not itertools)
    makespan = max(issue_times) if issue_times else 0.0

    svc_start: list[list[float]] = [[] for _ in range(num_dims)]
    svc_end: list[list[float]] = [[] for _ in range(num_dims)]
    rng_random = rng.random
    rng_logn = rng.lognormvariate
    cap_limit = fusion_limit if fusion else 1

    # Hot state rides in as default args (locals, not closure cells).
    def try_start(d: int, now: float, busy_until=busy_until, qmode=qmode,
                  scan_d=scan_d, sat_d=sat_d, t_wire=t_wire, t_fixed=t_fixed,
                  dim_bw=dim_bw, heaps=heaps, events=events,
                  svc_batches=svc_batches, svc_start=svc_start,
                  svc_end=svc_end, dim_busy=dim_busy, dim_wire=dim_wire,
                  straggler=straggler, uni_fx_l=uni_fx_l, jitter=jitter,
                  fusion=fusion, fusion_limit=fusion_limit,
                  cap=cap_limit, heappush=heappush, heappop=heappop,
                  rng_random=rng_random, rng_logn=rng_logn) -> None:
        nonlocal sq
        if busy_until[d] > now:
            return
        if qmode[d]:
            # Replicates the indexed fusion loop over the class scan: the
            # first op fixes the saturation threshold; further ops join
            # while the *sequential* wire total stays below it and under
            # fusion_limit (float accumulation order = batch order,
            # bit-for-bit).  A wire-uniform class feeding a fresh batch
            # takes the O(1) precomputed-table path.
            batch = None
            total = 0.0
            k = 0
            sat = sat_d[d]
            for ql, harr, slot, kc, ws in scan_d[d]:
                h = harr[slot]
                n = len(ql)
                if h >= n:
                    continue
                if kc and not k:
                    avail = n - h
                    if avail >= kc:
                        # fresh batch saturates (or hits the limit) inside
                        # this class: slice + table lookup, no per-op work
                        h += kc
                        batch = ql[h - kc:h]
                        harr[slot] = h
                        if h > 65536 and h + h > n:  # amortized-O(1) halving
                            del ql[:h]
                            harr[slot] = 0
                        k = kc
                        total = ws[kc]
                        break
                    # class drained before any stop condition: take all,
                    # keep scanning from the running total
                    batch = ql[h:]
                    harr[slot] = n
                    if n > 65536:  # fully drained: always safe to clear
                        del ql[:n]
                        harr[slot] = 0
                    k = avail
                    total = ws[avail]
                    continue
                h0 = h
                if kc:
                    # wire-uniform class joining a non-empty batch (k > 0
                    # here: a fresh batch was handled above).  Adding the
                    # cached class wire is the same float add as
                    # t_wire[ql[h]] — no per-item indexing.
                    w = ws[1]
                    lim = h + cap - k
                    if lim > n:
                        lim = n
                    while h < lim and total < sat:
                        total += w
                        h += 1
                    k += h - h0
                else:
                    if not k:
                        hh = ql[h]
                        total = t_wire[hh]
                        k = 1
                        h += 1
                    while h < n and k < cap and total < sat:
                        total += t_wire[ql[h]]
                        k += 1
                        h += 1
                if batch is None:
                    batch = ql[h0:h]
                else:
                    batch += ql[h0:h]
                harr[slot] = h
                if h > 65536 and h + h > n:  # amortized-O(1) halving
                    del ql[:h]
                    harr[slot] = 0
                if k >= cap or total >= sat:
                    break
            if batch is None:
                return
            wire = total
            a = uni_fx_l[d]
        else:
            heap = heaps[d]
            if not heap:
                return
            h0 = heappop(heap)[-1]
            batch = [h0]
            if fusion:
                sat = t_fixed[h0] * dim_bw[d]
                total = t_wire[h0]
                while heap and total < sat and len(batch) < fusion_limit:
                    hh = heappop(heap)[-1]
                    batch.append(hh)
                    total += t_wire[hh]
            a = 0.0
            wire = 0.0
            for hh in batch:
                f = t_fixed[hh]
                if f > a:
                    a = f
                wire += t_wire[hh]
        occupy = wire / dim_bw[d]
        if jitter:
            occupy *= 1.0 + jitter * rng_random()
        if straggler[d]:
            occupy *= rng_logn(0.0, straggler[d])
        free_at = now + occupy
        busy_until[d] = free_at
        dim_busy[d] += occupy
        dim_wire[d] += wire
        svc_batches[d].append(batch)
        svc_start[d].append(now)
        svc_end[d].append(free_at)
        sid = sq               # indexed seq order: sid, free seq, done seq
        sq = sid + 3
        heappush(events, (free_at, sid + 1, _FREE, d))
        heappush(events, (free_at + a, sid + 2, _DONE, batch))

    # ---- dependency machinery (heap mode only) -----------------------------
    if use_deps:
        # Emission-run buffer: consecutive push_ready calls at one time t
        # get contiguous seqs in the indexed engine; buffer them into one
        # cohort and flush when the time changes (or the handler ends).
        run_t = 0.0
        run_h: list[int] = []

        def flush_run() -> None:
            nonlocal sq, run_h
            if run_h:
                s0 = sq
                i = s0
                for hh in run_h:
                    t_arr[hh] = i
                    i += 1
                sq = i
                heappush(events, (run_t, s0, _READY, run_h))
                run_h = []

        def emit(hh: int, t: float) -> None:
            nonlocal run_t
            if run_h and run_t == t:  # same-source float; exact by design
                run_h.append(hh)
            else:
                flush_run()
                run_t = t
                run_h.append(hh)

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
                for c in dep_children[gg]:
                    if parent_fin[c] < tt:
                        parent_fin[c] = tt
                    n_parents[c] -= 1
                    if n_parents[c]:
                        continue
                    te = max(issue_times[c], parent_fin[c] + dep_delay[c])
                    resolved_issue[c] = te
                    if chains_left[c]:
                        for hh in group_first[c]:
                            emit(hh, te)
                    else:
                        group_finish[c] = te
                        work.append((c, te))

        for g in range(n_groups):
            if deps[g]:
                continue
            te = issue_times[g] + dep_delay[g]
            resolved_issue[g] = te
            if chains_left[g]:
                for hh in group_first[g]:
                    emit(hh, te)
            else:
                group_finish[g] = te
                complete_group(g, te)
        flush_run()

    # ---- the cohort event loop ---------------------------------------------
    t_dim_l = t_dim
    t_last_l = t_last
    t_group_l = t_group
    cls_get = cls_of.__getitem__
    ip = 0
    n_ip = len(init_t)
    ev = events
    while ev or ip < n_ip:
        if ip < n_ip:
            # merge pre-sorted initial cohorts against the dynamic heap
            if ev:
                e0 = ev[0]
                take_init = (init_t[ip], init_s[ip]) < (e0[0], e0[1])
            else:
                take_init = True
            if take_init:
                now = init_t[ip]
                if now > makespan:
                    makespan = now
                if all_q and not n_pend_none and now < min(busy_until):
                    # bulk fast path: every dim busy + pending — no
                    # try_start can fire, no pending clock can change.
                    # Each pre-split class segment lands as one C-level
                    # extend (within-class order is cohort order).
                    for s_c, hs in init_parts[ip]:
                        qi_c[s_c].extend(hs)
                else:
                    for hh in init_h[ip]:
                        d = t_dim_l[hh]
                        if pending_since[d] is None:
                            pending_since[d] = now
                            n_pend_none -= 1
                        if qmode[d]:
                            qi_c[cls_of[hh]].append(hh)
                        elif scf:
                            heappush(heaps[d], (-t_prio[hh], t_wire[hh],
                                                t_arr[hh], hh))
                        else:
                            heappush(heaps[d], (-t_prio[hh], t_arr[hh], hh))
                        if busy_until[d] <= now:
                            try_start(d, now)
                ip += 1
                if ip == n_ip:
                    # No further initial arrivals: splice each class's
                    # remaining initial items onto the front of its chain
                    # queue (in place — the queue objects are captured by
                    # scan entries and arrival sites) and halve the scan.
                    for s in range(n_slots):
                        qio = qi_c[s]
                        qd_c[s][:hd_c[s]] = qio[hi_c[s]:]
                        hd_c[s] = 0
                        qio.clear()
                        hi_c[s] = 0
                    for d in range(num_dims):
                        scan_d[d][:] = [
                            (qd_c[s], hd_c, s, cls_cap[s], cls_wsum[s])
                            for s in cls_slots[d]]
                continue
        e = heappop(ev)
        now = e[0]
        kind = e[2]
        if kind == _READY:
            if now > makespan:
                makespan = now
            b = e[3]
            if all_q and not n_pend_none and now < min(busy_until):
                # bulk fast path (see the initial-cohort branch)
                if type(b) is list:
                    cs = set(map(cls_get, b))
                    if len(cs) == 1:
                        qd_c[cs.pop()].extend(b)
                    else:
                        for hh in b:
                            qd_c[cls_of[hh]].append(hh)
                else:
                    # numpy cohort: route per class with masked slices.
                    # Queues are per-class, so only within-class order is
                    # observable — and a boolean mask preserves it.
                    cl = cls_np[b]
                    c0 = cl[0]
                    if (cl == c0).all():
                        qd_c[c0].extend(b.tolist())
                    else:
                        for s in dict.fromkeys(cl.tolist()):
                            qd_c[s].extend(b[cl == s].tolist())
            else:
                if type(b) is not list:
                    b = b.tolist()
                for hh in b:
                    d = t_dim_l[hh]
                    if pending_since[d] is None:
                        pending_since[d] = now
                        n_pend_none -= 1
                    if qmode[d]:
                        qd_c[cls_of[hh]].append(hh)
                    elif scf:
                        heappush(heaps[d], (-t_prio[hh], t_wire[hh],
                                            t_arr[hh], hh))
                    else:
                        heappush(heaps[d], (-t_prio[hh], t_arr[hh], hh))
                    if busy_until[d] <= now:
                        try_start(d, now)
        elif kind == _FREE:
            d = e[3]
            if now > makespan:
                makespan = now
            if pending_since[d] is not None:
                if qmode[d]:
                    empty = True
                    for ql, harr, slot, _kc, _ws in scan_d[d]:
                        if harr[slot] < len(ql):
                            empty = False
                            break
                else:
                    empty = not heaps[d]
                if empty:
                    activity[d].append((pending_since[d], now))
                    pending_since[d] = None
                    n_pend_none += 1
            try_start(d, now)
        else:  # _DONE — the batch's next stages become ready as one cohort
            if now > makespan:
                makespan = now
            if use_deps:
                for hh in e[3]:
                    if not t_last_l[hh]:
                        emit(hh + 1, now)
                        continue
                    g = t_group_l[hh]
                    if group_finish[g] < now:
                        group_finish[g] = now
                    chains_left[g] -= 1
                    if not chains_left[g]:
                        complete_group(g, now)
                flush_run()
            else:
                b = e[3]
                if all_q and len(b) >= 24:
                    # numpy successor construction: one gather on the
                    # last-stage mask replaces the per-handle listcomp.
                    # group_finish is a max-fold, so retire order within
                    # the cohort is unobservable.  all_q implies every dim
                    # is list-mode, so no t_arr bookkeeping is needed.
                    bn = np.asarray(b)
                    m = last_np[bn]
                    if m.any():
                        for hh in bn[m].tolist():
                            g = t_group_l[hh]
                            if group_finish[g] < now:
                                group_finish[g] = now
                        nxtn = bn[~m]
                        nxtn += 1
                    else:
                        nxtn = bn + 1
                    nn = len(nxtn)
                    if nn:
                        s0 = sq
                        sq = s0 + nn
                        heappush(ev, (now, s0, _READY, nxtn))
                    continue
                nxt = [hh + 1 for hh in b if not t_last_l[hh]]
                if len(nxt) != len(b):  # some chunk chains just retired
                    for hh in b:
                        if t_last_l[hh]:
                            g = t_group_l[hh]
                            if group_finish[g] < now:
                                group_finish[g] = now
                if nxt:
                    s0 = sq
                    if need_arr:
                        i = s0
                        for hh in nxt:
                            t_arr[hh] = i
                            i += 1
                    sq = s0 + len(nxt)
                    heappush(ev, (now, s0, _READY, nxt))

    for d in range(num_dims):
        if pending_since[d] is not None:  # pragma: no cover - safety
            activity[d].append((pending_since[d], makespan))

    if use_deps:
        for g in range(n_groups):
            if n_parents[g] > 0:
                raise ValueError(
                    f"dependency cycle: group {g} never became eligible")
        if group_finish:
            makespan = max(makespan, max(group_finish))

    # ---- finalize: materialize per-dim op order + service intervals --------
    # lint: vector-zone-begin  (bulk materialization; no per-event mutation)
    chain = itertools.chain.from_iterable
    pget = pairs.__getitem__
    tg_get = t_group.__getitem__
    dim_order = [list(map(pget, chain(svc_batches[d])))
                 for d in range(num_dims)]
    dim_services = [
        [ServiceInterval(s, e, tuple(sorted(set(map(tg_get, b)))))
         for s, e, b in zip(svc_start[d], svc_end[d], svc_batches[d])]
        for d in range(num_dims)
    ]
    # lint: vector-zone-end
    return SimResult(makespan, dim_busy, dim_wire, activity, dim_order,
                     dim_services, resolved_issue, group_finish,
                     list(streams), list(tenants), group_wire)


# ---------------------------------------------------------------------------
# The wave kernel: the inner no-preemption kernel in vectorized torch
# ---------------------------------------------------------------------------
#: Calls of :func:`wave_done_times` that ran on the card.
launches = 0


def jit_available() -> bool:
    """Can :func:`wave_done_times` run on the card in this environment?"""
    import torch

    return torch.cuda.is_available()


#: Elements of a segment that one row of the blocked scans holds.
_SCAN_BLOCK = 1024


def _rows_cumsum(x):
    """Inclusive cumsum along each row of 2-D ``x``, in an order that is
    the same from run to run.  torch scans a tensor whose elements all lie
    on the scanned dim with CUB's look-back scan, whose float sums vary
    between runs on a CUDA card; any other shape goes to its row kernel,
    which scans each row in a fixed order.  So a single row is scanned
    beside a row of zeros."""
    import torch

    if x.shape[0] == 1:
        return torch.cat((x, torch.zeros_like(x))).cumsum(1)[:1]
    return x.cumsum(1)


def _blocked_scan(table, kind):
    """Inclusive ``"sum"`` or ``"max"`` scan along the rows of ``table``
    (n, L), L a multiple of :data:`_SCAN_BLOCK`: each block of a row is
    scanned as a row of its own (parallel over blocks, where a long row
    would be scanned by one thread block), then each block takes the
    scan of the blocks before it as its carry."""
    import torch

    n, L = table.shape
    nb = L // _SCAN_BLOCK
    blocks = table.reshape(n * nb, _SCAN_BLOCK)
    if kind == "sum":
        part = _rows_cumsum(blocks).reshape(n, nb, _SCAN_BLOCK)
        upto = _rows_cumsum(part[:, :, -1])
        carry = torch.zeros_like(upto)
    else:
        part = blocks.cummax(1).values.reshape(n, nb, _SCAN_BLOCK)
        upto = part[:, :, -1].cummax(1).values
        carry = torch.full_like(upto, -math.inf)
    carry[:, 1:] = upto[:, :-1]
    if kind == "sum":
        return (part + carry[:, :, None]).reshape(n, L)
    return torch.maximum(part, carry[:, :, None]).reshape(n, L)


def _wave_scan(arrive, occ, fx, dims):
    """The wave kernel on tensors of one device: ``arrive`` (C,) and
    ``occ``/``fx`` (C, R) float64, ``dims`` (C, R) int64.  Returns the
    (C,) done times on the same device, the same from run to run.

    Per rank, two stable sorts (arrival, then dim) give the reference's
    ``lexsort((idx, arrive, dim))`` order, ties in chunk order.  Inside
    each dim's segment the max-plus recurrence
    ``free_i = max(a_i, free_{i-1}) + o_i`` (``free = a + o`` at a
    segment's head) has the closed form
    ``free_i = S_i + max_{j <= i} (a_j - S_j + o_j)``, ``S`` the
    segment's own inclusive cumsum of ``o``: the segments are laid out as
    rows of a (segments, longest segment) table, padded with 0 for the
    cumsum and -inf for the cummax, so no segment's sum cancels against
    another's; :func:`_blocked_scan` scans the rows.
    """
    import torch

    C, R = occ.shape
    if C == 0:
        return arrive
    dev = arrive.device
    idx = torch.arange(C, device=dev)
    for r in range(R):
        d = dims[:, r]
        by_arrival = torch.sort(arrive, stable=True).indices
        order = by_arrival[torch.sort(d[by_arrival], stable=True).indices]
        d_s = d[order]
        fresh = torch.ones(C, dtype=torch.bool, device=dev)
        fresh[1:] = d_s[1:] != d_s[:-1]
        heads = torch.nonzero(fresh).squeeze(1)
        seg = torch.cumsum(fresh, 0) - 1
        ends = torch.cat((heads[1:], heads.new_tensor([C])))
        width = -(-int((ends - heads).max()) // _SCAN_BLOCK) * _SCAN_BLOCK
        cell = seg * width + idx - heads[seg]
        o_s = occ[order, r]
        table = occ.new_zeros(len(heads) * width)
        table[cell] = o_s
        s_i = _blocked_scan(table.view(-1, width), "sum").view(-1)[cell]
        table.fill_(-math.inf)
        table[cell] = arrive[order] - s_i + o_s
        free = s_i + _blocked_scan(table.view(-1, width), "max").view(-1)[cell]
        arrive = torch.empty_like(arrive)
        arrive[order] = free + fx[order, r]
    return arrive


def wave_done_times(issue_times, occupy, fixed, dims, *, device=None):
    """Rank-synchronous wave kernel (no preemption), on the card unless
    ``device="cpu"``.

    Inputs: ``issue_times`` (C,), ``occupy``/``fixed`` (C, R) floats and
    ``dims`` (C, R) ints — chunk c's rank-r stage occupies dim
    ``dims[c, r]`` for ``occupy[c, r]`` seconds and completes
    ``fixed[c, r]`` later.  Each rank is served FIFO per dim (arrival
    time, then chunk index) — the cohort engine's semantics when fusion
    is off, priorities are flat, and rank barriers hold (wave-
    synchronous streams: uniform sizes, shared issue instant).

    Computes in float64 (:func:`_wave_scan`) and returns the (C,) final
    done times as numpy.  Numeric, not bit-exact: its closed form
    reassociates the recurrence, so agreement with
    :func:`simulate_compiled` is within rounding (about 1e-12 relative);
    :data:`JIT_RTOL` is the tolerance against the reference's float32
    kernel.  Without CUDA and without ``device="cpu"`` it raises.
    """
    global launches
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def f64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    occ = f64(occupy)
    dims_t = torch.as_tensor(np.asarray(dims, dtype=np.int64), device=dev)
    if dev.type == "cuda":
        launches += 1
    out = _wave_scan(f64(issue_times), occ, f64(fixed), dims_t)
    return out.cpu().numpy()


def wave_done_times_plain(issue_times, occupy, fixed, dims):
    """The wave kernel as the reference's ``lax.scan`` runs it: per rank a
    lexsort, then the max-plus recurrence element by element, in float64
    on the CPU.  The tests hold :func:`wave_done_times` to it."""
    occupy = np.asarray(occupy, dtype=np.float64)
    fixed = np.asarray(fixed, dtype=np.float64)
    dims = np.asarray(dims, dtype=np.int64)
    C, R = occupy.shape
    idx = np.arange(C)
    arrive = np.asarray(issue_times, dtype=np.float64)
    for r in range(R):
        d = dims[:, r]
        order = np.lexsort((idx, arrive, d))
        a_s = arrive[order].tolist()
        o_s = occupy[order, r].tolist()
        f_s = fixed[order, r].tolist()
        d_s = d[order].tolist()
        done_s = [0.0] * C
        prev_free = 0.0
        for i in range(C):
            if i == 0 or d_s[i] != d_s[i - 1]:
                start = a_s[i]
            else:
                start = max(a_s[i], prev_free)
            prev_free = start + o_s[i]
            done_s[i] = prev_free + f_s[i]
        arrive = np.empty(C)
        arrive[order] = done_s
    return arrive


def wave_arrays(topology: Topology, chunk_groups, issue_times):
    """Build :func:`wave_done_times` inputs from chunk groups.

    Requires every chunk to have the same number of stages (a wave-
    shaped stream); raises ValueError otherwise.  Occupy times are
    wire/bw per stage — the no-jitter service time of an unfused batch
    of one.
    """
    lm = LatencyModel.for_topology(topology)
    ta = build_task_arrays(lm, chunk_groups,
                           [0] * len(chunk_groups),
                           ["default"] * len(chunk_groups))
    # lint: vector-zone-begin  (pure numpy reshape of the SoA columns)
    lens = np.diff(np.asarray(
        ta.first_handles + [ta.n_tasks], dtype=np.int64))
    if len(lens) and not (lens == lens[0]).all():
        raise ValueError("wave kernel needs equal stage counts per chunk")
    R = int(lens[0]) if len(lens) else 0
    C = len(ta.first_handles)
    dims = np.asarray(ta.dim, dtype=np.int64).reshape(C, R)
    wire = np.asarray(ta.wire, dtype=np.float64).reshape(C, R)
    fixed = np.asarray(ta.fixed, dtype=np.float64).reshape(C, R)
    bw = np.asarray(LatencyModel.for_topology(topology).stage_tables.bw)
    occupy = wire / bw[dims]
    issue = np.asarray(issue_times, dtype=np.float64)[
        np.asarray(ta.group, dtype=np.int64)[
            np.asarray(ta.first_handles, dtype=np.int64)]]
    # lint: vector-zone-end
    return issue, occupy, fixed, dims

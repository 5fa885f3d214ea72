"""Bandwidth-partition / dim-order topology search (LIBRA-flavored).

LIBRA (arXiv 2109.11762) tunes how a fixed total network budget is split
across the dimensions of a multi-dimensional fabric for a target workload;
ForestColl (arXiv 2402.06787) generalizes schedule+topology co-search.
This module brings the same loop in-process over our simulator: enumerate
and locally refine **BW splits** (what fraction of the per-NPU bandwidth
budget each dimension gets) and **dim orderings** (which physical dimension
sits at which level of the hierarchy) for a fixed shape — NPU counts,
per-dim physical topology and step latencies are preserved, so every
candidate is ``make_tpu_pod_topology``/Table-2 compatible and spends
exactly the same total bandwidth.

Candidates are scored by simulating the target workload's actual request
stream (``repro_torch.core.batch.simulate_batch``; multi-seed jitter scoring
shares one scheduling pass per candidate), with **sound early pruning**: a
candidate whose per-dim busy-time lower bound
(:meth:`~repro_torch.core.latency_model.LatencyModel.dim_lower_bounds` — no
schedule can put fewer bytes on a dim) already exceeds the best simulated
makespan can never win and is skipped without simulation.  The result
carries the best candidate and the Pareto front over (makespan,
BW-utilization) of everything evaluated.

The search is fully deterministic for a fixed config: enumeration order,
refinement mutations and tie-breaks are value-based, and the only
randomness (service jitter) is seeded per scenario.

This is the port's copy of ``repro/topology/search.py``, imports aside;
it leaves out nothing (an ``arbiter_factory`` in its config reaches the
batch runner, which refuses it until the port carries ``tenancy``).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

from repro_torch.core.batch import BatchCaches, Scenario, simulate_batch
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest

from .topology import GBPS, NetworkDim, Topology


def bw_split_topology(
    base: Topology,
    fractions: tuple[float, ...],
    perm: tuple[int, ...] | None = None,
    name: str | None = None,
) -> Topology:
    """Re-split ``base``'s total per-NPU BW budget across its dimensions.

    ``fractions[pos]`` is the share of ``base.total_bw_bytes`` given to the
    dimension at hierarchy position ``pos``; ``perm[pos]`` names which base
    dimension sits there (identity by default).  NPU counts, physical
    topology kinds, per-NPU link counts and step latencies are preserved —
    only ``link_gbps`` is rescaled — so the candidate spends exactly the
    base budget and remains compatible with everything a hand-built
    topology works with.
    """
    if perm is None:
        perm = tuple(range(base.num_dims))
    if len(fractions) != base.num_dims or len(perm) != base.num_dims:
        raise ValueError("fractions/perm must have one entry per dimension")
    if sorted(perm) != list(range(base.num_dims)):
        raise ValueError(f"perm must permute dim indices, got {perm}")
    if any(f <= 0 for f in fractions):
        raise ValueError("every dimension needs a positive BW fraction")
    budget = base.total_bw_bytes
    dims = []
    for pos, bi in enumerate(perm):
        d = base.dims[bi]
        link_gbps = fractions[pos] * budget / (d.links_per_npu * GBPS)
        dims.append(NetworkDim(d.npus, d.topo, link_gbps, d.links_per_npu,
                               d.step_latency_s, d.straggler_sigma))
    if name is None:
        frac_s = "-".join(f"{f:.4g}" for f in fractions)
        name = f"{base.name}|bw[{frac_s}]|perm{''.join(map(str, perm))}"
    return Topology(name, tuple(dims))


def enumerate_bw_shares(num_dims: int, granularity: int) -> list[tuple[int, ...]]:
    """All splits of ``granularity`` budget units into positive per-dim
    shares (compositions), in lexicographic order — the deterministic
    round-0 grid of the search."""
    if granularity < num_dims:
        raise ValueError("granularity must be >= num_dims (every dim needs "
                         "a positive share)")
    out: list[tuple[int, ...]] = []

    def rec(prefix: list[int], remaining: int, dims_left: int) -> None:
        if dims_left == 1:
            out.append(tuple(prefix + [remaining]))
            return
        for s in range(1, remaining - dims_left + 2):
            rec(prefix + [s], remaining - s, dims_left - 1)

    rec([], granularity, num_dims)
    return out


def stream_lower_bound(
    topology: Topology, requests: list[CollectiveRequest]
) -> float:
    """Sound lower bound on the simulated makespan of ``requests``.

    max of (a) every dim's total busy-time bound (sum of per-request
    minimal wire bytes over the dim's BW — dims are serial resources),
    and (b) every request's ``issue_time + ideal_time`` (work conservation
    across the whole fabric).  Fusion, arbiters, preemption, jitter and
    A-delays can only add time, never remove wire bytes, so no simulated
    schedule beats this — the pruning certificate of the search.
    """
    lm = LatencyModel.for_topology(topology)
    busy = [0.0] * topology.num_dims
    per_request = 0.0
    for r in requests:
        for k, lb in enumerate(lm.dim_lower_bounds(r.collective,
                                                   r.size_bytes)):
            busy[k] += lb
        t = r.issue_time + lm.ideal_time(r.collective, r.size_bytes)
        if t > per_request:
            per_request = t
    dim_bound = max(busy) if busy else 0.0
    return max(dim_bound, per_request)


@dataclass(frozen=True)
class SearchConfig:
    """Knobs of :func:`search_topologies` (all deterministic)."""

    granularity: int = 8            # round-0 BW grid: shares of budget/g
    rounds: int = 2                 # local-refinement rounds after the grid
    top_k: int = 4                  # survivors mutated per round
    seeds: tuple[int, ...] = (0,)   # scoring seeds (jitter robustness)
    jitter: float = 0.0             # service-time jitter during scoring
    policy: str = "themis"
    chunks_per_collective: int = 16
    water_filling: bool = False
    intra: str = "SCF"
    fusion: bool = True
    search_dim_orders: bool = True  # also permute hierarchy positions
    max_candidates_per_round: int = 256
    prune: bool = True              # lower-bound pruning on/off (ablation)
    arbiter_factory: object = None  # fresh inter-tenant arbiter per scenario

    def __post_init__(self):
        if not self.seeds:
            raise ValueError("seeds must name at least one scoring seed")
        if self.rounds < 0 or self.top_k < 1:
            raise ValueError("rounds must be >= 0 and top_k >= 1")


@dataclass(frozen=True)
class CandidateScore:
    """One evaluated candidate: mean-over-seeds makespan + utilization."""

    topology: Topology
    shares: tuple[int, ...]         # integer BW shares (of ``denom`` units)
    denom: int
    perm: tuple[int, ...]
    makespan: float
    bw_utilization: float
    lower_bound: float

    @property
    def fractions(self) -> tuple[float, ...]:
        return tuple(s / self.denom for s in self.shares)


@dataclass
class SearchResult:
    default: CandidateScore         # the base topology, scored identically
    best: CandidateScore            # min mean makespan over everything run
    pareto: list[CandidateScore]    # min makespan / max utilization front
    evaluated: list[CandidateScore] = field(repr=False, default_factory=list)
    pruned: int = 0                 # candidates skipped via lower bound
    scenarios_run: int = 0          # simulations executed (candidates x seeds)

    @property
    def improvement(self) -> float:
        """default/best makespan ratio (> 1: the search won)."""
        return self.default.makespan / self.best.makespan


# Candidates scored per simulate_batch call inside a round — small enough
# that an early good makespan prunes the round's tail, large enough to keep
# the batch amortization.
_SCORE_CHUNK = 8


def _norm_key(shares: tuple[int, ...], denom: int,
              perm: tuple[int, ...]) -> tuple:
    """Dedupe key: (2,14)/16 is the same split as (1,7)/8."""
    g = math.gcd(denom, *shares)
    return (tuple(s // g for s in shares), denom // g, perm)


def _apportion(fractions: tuple[float, ...], granularity: int) -> tuple[int, ...]:
    """Integer shares summing exactly to ``granularity`` (largest-remainder,
    every dim >= 1) — mutating these always conserves the BW budget."""
    d = len(fractions)
    raw = [f * granularity for f in fractions]
    shares = [max(1, int(r)) for r in raw]
    rema = sorted(range(d), key=lambda k: (raw[k] - int(raw[k]), k),
                  reverse=True)
    i = 0
    while sum(shares) < granularity:
        shares[rema[i % d]] += 1
        i += 1
    while sum(shares) > granularity:
        k = max(range(d), key=lambda k: (shares[k], k))
        if shares[k] <= 1:  # pragma: no cover - granularity >= num_dims
            break
        shares[k] -= 1
    return tuple(shares)


def _pareto_front(scores: list[CandidateScore]) -> list[CandidateScore]:
    """Non-dominated set: minimize makespan, maximize BW utilization."""
    ordered = sorted(scores, key=lambda c: (c.makespan, -c.bw_utilization))
    front: list[CandidateScore] = []
    best_util = float("-inf")
    for c in ordered:
        if c.bw_utilization > best_util:
            front.append(c)
            best_util = c.bw_utilization
    return front


def search_topologies(
    base: Topology,
    requests: list[CollectiveRequest],
    config: SearchConfig = SearchConfig(),
    *,
    caches: BatchCaches | None = None,
) -> SearchResult:
    """Search BW splits x dim orders of ``base`` for ``requests``.

    Round 0 scores the full share grid (pruned by lower bound against the
    incumbent best makespan); each refinement round doubles the share
    resolution around the ``top_k`` survivors (move one finer-grained BW
    unit between every dim pair; swap adjacent hierarchy positions) and
    re-scores.  All candidate scoring goes through one shared
    :class:`~repro_torch.core.batch.BatchCaches`, so stage vectors and schedules
    are amortized across the entire search.
    """
    cfg = config
    reqs = tuple(requests)
    caches = caches if caches is not None else BatchCaches()
    d = base.num_dims

    def score_batch(cands: list[tuple[tuple[int, ...], int, tuple[int, ...],
                                      Topology, float]]
                    ) -> list[CandidateScore]:
        scenarios = []
        for _, _, _, topo, _ in cands:
            for seed in cfg.seeds:
                scenarios.append(Scenario(
                    topo, reqs, policy=cfg.policy,
                    chunks_per_collective=cfg.chunks_per_collective,
                    water_filling=cfg.water_filling, intra=cfg.intra,
                    fusion=cfg.fusion, jitter=cfg.jitter, seed=seed,
                    arbiter_factory=cfg.arbiter_factory))
        results = simulate_batch(scenarios, caches=caches)
        out = []
        n_seeds = len(cfg.seeds)
        for i, (shares, denom, perm, topo, lb) in enumerate(cands):
            runs = results[i * n_seeds:(i + 1) * n_seeds]
            mk = sum(r.makespan for r in runs) / n_seeds
            util = sum(r.avg_bw_utilization(topo) for r in runs) / n_seeds
            out.append(CandidateScore(topo, shares, denom, perm, mk, util,
                                      lb))
        return out

    # -- the default fabric, scored under identical conditions ---------------
    # base_shares is the apportioned *description* of the default's split
    # (refinement mutates it budget-exactly); the grid candidate with the
    # same shares is a distinct on-grid fabric and is still evaluated.
    budget = base.total_bw_bytes
    base_shares = _apportion(
        tuple(dd.aggr_bw_bytes / budget for dd in base.dims),
        cfg.granularity)
    default = score_batch(
        [(base_shares, cfg.granularity, tuple(range(d)), base,
          stream_lower_bound(base, list(reqs)))])[0]

    evaluated: list[CandidateScore] = [default]
    incumbent = default.makespan
    pruned = 0
    scenarios_run = len(cfg.seeds)
    # Candidates become "seen" only once actually processed (simulated or
    # lower-bound-pruned); a candidate cut by max_candidates_per_round may
    # legitimately reappear in a later refinement round.
    seen: set[tuple] = set()

    perms = (list(itertools.permutations(range(d)))
             if cfg.search_dim_orders else [tuple(range(d))])

    def run_round(pool: list[tuple[tuple[int, ...], int, tuple[int, ...]]]
                  ) -> None:
        nonlocal incumbent, pruned, scenarios_run
        cands = []
        for shares, denom, perm in pool:
            topo = bw_split_topology(
                base, tuple(s / denom for s in shares), perm)
            cands.append((shares, denom, perm,
                          stream_lower_bound(topo, list(reqs)), topo))
        # Evaluate cheapest-looking first so the incumbent tightens early,
        # scoring in sub-batches so a makespan found early in the round
        # prunes the round's own tail (shared ``caches`` keep successive
        # simulate_batch calls warm, so chunking costs nothing).
        cands.sort(key=lambda c: (c[3], c[0], c[2]))
        cands = cands[:cfg.max_candidates_per_round]
        i = 0
        while i < len(cands):
            batch = []
            while i < len(cands) and len(batch) < _SCORE_CHUNK:
                shares, denom, perm, lb, topo = cands[i]
                i += 1
                seen.add(_norm_key(shares, denom, perm))
                if cfg.prune and lb >= incumbent:
                    # sound to retire forever: the incumbent only improves
                    pruned += 1
                    continue
                batch.append((shares, denom, perm, topo, lb))
            for cs in score_batch(batch):
                evaluated.append(cs)
                scenarios_run += len(cfg.seeds)
                if cs.makespan < incumbent:
                    incumbent = cs.makespan

    def add_candidate(pool, pool_keys, shares, denom, perm) -> None:
        key = _norm_key(shares, denom, perm)
        if key not in seen and key not in pool_keys:
            pool_keys.add(key)
            pool.append((shares, denom, perm))

    # -- round 0: the share grid x dim orders --------------------------------
    grid: list[tuple[tuple[int, ...], int, tuple[int, ...]]] = []
    grid_keys: set[tuple] = set()
    for shares in enumerate_bw_shares(d, cfg.granularity):
        for perm in perms:
            add_candidate(grid, grid_keys, shares, cfg.granularity, perm)
    run_round(grid)

    # -- refinement rounds: double resolution around the survivors -----------
    for _ in range(cfg.rounds):
        ranked = sorted(evaluated, key=lambda c: (c.makespan, c.shares,
                                                  c.perm))
        pool: list[tuple[tuple[int, ...], int, tuple[int, ...]]] = []
        pool_keys: set[tuple] = set()
        for cs in ranked[:cfg.top_k]:
            denom = cs.denom * 2
            shares = tuple(s * 2 for s in cs.shares)
            for i in range(d):
                for j in range(d):
                    if i == j or shares[i] <= 1:
                        continue
                    moved = list(shares)
                    moved[i] -= 1
                    moved[j] += 1
                    add_candidate(pool, pool_keys, tuple(moved), denom,
                                  cs.perm)
            for i in range(d - 1):  # adjacent hierarchy swaps
                p = list(cs.perm)
                p[i], p[i + 1] = p[i + 1], p[i]
                add_candidate(pool, pool_keys, shares, denom, tuple(p))
        if not pool:
            break
        run_round(pool)

    best = min(evaluated, key=lambda c: (c.makespan, c.shares, c.perm))
    return SearchResult(
        default=default, best=best, pareto=_pareto_front(evaluated),
        evaluated=evaluated, pruned=pruned, scenarios_run=scenarios_run)

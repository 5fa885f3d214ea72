"""Dependency-aware traffic IR.

A :class:`TrafficGraph` is a DAG of :class:`TrafficNode`s — the common
representation for every request stream the scheduler and simulator
consume.  A node is either a *compute* node (``request is None``: a pure
delay that exists to gate its dependents — a pipeline stage's forward
pass, a decode step's matmuls) or a *request* node carrying one
:class:`~repro_torch.core.requests.CollectiveRequest`.  Edges say "this node
becomes eligible once those nodes have finished"; ``compute_s`` adds a
delay between the gating event and the node's own issue.

Timing semantics (implemented by ``repro_torch.core.simulator.simulate(deps=...)``
and mirrored by :meth:`TrafficGraph.estimate_times`):

  * a **root** node (no deps) issues at ``start_s + compute_s``;
  * a **dependent** node issues at
    ``max(start_s, latest-predecessor-finish + compute_s)`` — ``start_s``
    is a floor (e.g. a request's external arrival time), the predecessors
    are the data dependencies;
  * a compute node *finishes* at its issue instant (its duration is the
    ``compute_s`` already charged); a request node finishes when the
    simulator retires its collective.

Fixed-time streams are the degenerate case: every node a root with
``compute_s == 0`` (see :func:`from_requests`) — scheduling and simulation
of such a graph are bit-identical to the plain ``simulate_requests`` path,
which is what lets one engine serve training buckets, pipeline stage
streams and serving prefill/decode chains alike.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace as _dc_replace

from repro_torch.core.requests import CollectiveRequest


@dataclass(frozen=True)
class TrafficNode:
    """One vertex of a traffic graph.

    ``stream`` / ``tenant`` override the reporting tags; by default a
    request node inherits its request's tags and a compute node reports as
    stream ``"compute"`` under tenant ``"default"``.
    """

    name: str
    request: CollectiveRequest | None = None
    compute_s: float = 0.0
    deps: tuple[str, ...] = ()
    start_s: float = 0.0
    stream: str | None = None
    tenant: str | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("node name must be non-empty")
        if self.compute_s < 0:
            raise ValueError("compute_s must be >= 0")
        if self.start_s < 0:
            raise ValueError("start_s must be >= 0")
        if not isinstance(self.deps, tuple):
            object.__setattr__(self, "deps", tuple(self.deps))
        if (self.request is not None and self.request.issue_time
                and self.request.issue_time != self.start_s):
            raise ValueError(
                f"node {self.name!r}: request.issue_time "
                f"{self.request.issue_time} disagrees with start_s "
                f"{self.start_s} — the graph honors start_s only; zero the "
                "request's issue_time or use from_requests()")

    @property
    def is_compute(self) -> bool:
        return self.request is None

    @property
    def stream_tag(self) -> str:
        if self.stream is not None:
            return self.stream
        return self.request.stream if self.request is not None else "compute"

    @property
    def tenant_tag(self) -> str:
        if self.tenant is not None:
            return self.tenant
        return self.request.tenant if self.request is not None else "default"

    @property
    def priority(self) -> int:
        return self.request.priority if self.request is not None else 0


@dataclass(frozen=True)
class TrafficGraph:
    """A validated DAG of traffic nodes.

    Node order is the *group* order everywhere downstream: group ``i`` of a
    ``SimResult`` produced from this graph is ``nodes[i]``.  Construction
    validates name uniqueness, resolves dependency names to indices, and
    topologically sorts (rejecting cycles), so forward references between
    nodes are allowed.
    """

    nodes: tuple[TrafficNode, ...]

    def __post_init__(self):
        if not isinstance(self.nodes, tuple):
            object.__setattr__(self, "nodes", tuple(self.nodes))
        index: dict[str, int] = {}
        for i, n in enumerate(self.nodes):
            if n.name in index:
                raise ValueError(f"duplicate node name {n.name!r}")
            index[n.name] = i
        deps_idx = []
        for n in self.nodes:
            try:
                deps_idx.append(tuple(index[d] for d in n.deps))
            except KeyError as e:
                raise ValueError(
                    f"node {n.name!r} depends on unknown node "
                    f"{e.args[0]!r}") from None
        # Kahn's algorithm; min-heap makes the order deterministic.
        n_par = [len(d) for d in deps_idx]
        children: list[list[int]] = [[] for _ in self.nodes]
        for i, ds in enumerate(deps_idx):
            for p in ds:
                children[p].append(i)
        heap = [i for i, k in enumerate(n_par) if k == 0]
        heapq.heapify(heap)
        order: list[int] = []
        while heap:
            i = heapq.heappop(heap)
            order.append(i)
            for c in children[i]:
                n_par[c] -= 1
                if n_par[c] == 0:
                    heapq.heappush(heap, c)
        if len(order) != len(self.nodes):
            stuck = [self.nodes[i].name
                     for i, k in enumerate(n_par) if k > 0]
            raise ValueError(f"dependency cycle involving {stuck[:5]}")
        object.__setattr__(self, "_index", index)
        object.__setattr__(self, "_deps_idx", tuple(deps_idx))
        object.__setattr__(self, "_topo_order", tuple(order))

    # -- structure ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def deps_idx(self) -> tuple[tuple[int, ...], ...]:
        """Per-node predecessor indices (simulate()'s ``deps`` argument)."""
        return self._deps_idx

    @property
    def topo_order(self) -> tuple[int, ...]:
        return self._topo_order

    def index_of(self, name: str) -> int:
        return self._index[name]

    def node(self, name: str) -> TrafficNode:
        return self.nodes[self._index[name]]

    @property
    def n_requests(self) -> int:
        return sum(1 for n in self.nodes if n.request is not None)

    # -- simulate() adapters --------------------------------------------------
    def sim_kwargs(self) -> dict:
        """The per-group keyword arguments ``simulate()`` needs to run this
        graph's chunk groups dependency-gated (everything but the groups)."""
        return dict(
            issue_times=[n.start_s for n in self.nodes],
            priorities=[n.priority for n in self.nodes],
            tenants=[n.tenant_tag for n in self.nodes],
            streams=[n.stream_tag for n in self.nodes],
            deps=list(self._deps_idx),
            dep_delay_s=[n.compute_s for n in self.nodes],
        )

    def estimate_times(self, latency_model=None):
        """Deterministic contention-free (issue, finish) estimates.

        Request durations use ``latency_model.ideal_time`` (no queueing);
        compute nodes finish at their issue instant.  These estimates only
        order the *scheduling* pass (and advance the Dim Load Tracker) —
        simulated issue times come from the event loop, which resolves
        dependencies against actual finishes.
        """
        n = len(self.nodes)
        est_issue = [0.0] * n
        est_finish = [0.0] * n
        for i in self._topo_order:
            node = self.nodes[i]
            ds = self._deps_idx[i]
            if ds:
                base = max(est_finish[p] for p in ds)
                t = max(node.start_s, base + node.compute_s)
            else:
                t = node.start_s + node.compute_s
            est_issue[i] = t
            dur = 0.0
            if node.request is not None and latency_model is not None:
                dur = latency_model.ideal_time(node.request.collective,
                                               node.request.size_bytes)
            est_finish[i] = t + dur
        return est_issue, est_finish


def from_requests(
    requests, prefix: str = "req",
) -> TrafficGraph:
    """Wrap a fixed-time request stream as a dependency-free graph.

    The result schedules and simulates bit-identically to passing
    ``requests`` straight to ``simulate_requests`` (the differential suite
    pins this), so callers can migrate to the IR without perturbing
    existing results.
    """
    return TrafficGraph(tuple(
        TrafficNode(f"{prefix}{i}", request=r, start_s=r.issue_time)
        for i, r in enumerate(requests)))


def merge_graphs(*graphs: TrafficGraph) -> TrafficGraph:
    """Concatenate graphs into one (e.g. one per tenant).  Node names must
    be globally unique — namespace them with :func:`retag` first."""
    nodes: list[TrafficNode] = []
    for g in graphs:
        nodes.extend(g.nodes)
    return TrafficGraph(tuple(nodes))


def retag(
    graph: TrafficGraph,
    *,
    name_prefix: str = "",
    tenant: str | None = None,
    stream_prefix: str = "",
    priority: int | None = None,
    start_offset_s: float = 0.0,
) -> TrafficGraph:
    """A copy of ``graph`` with namespaced names and re-tagged ownership —
    how a tenant-neutral builder output is bound to one tenant's share
    contract (see ``repro_torch.tenancy.TenantJob.traffic``)."""
    if start_offset_s < 0:
        raise ValueError("start_offset_s must be >= 0")
    nodes = []
    for n in graph.nodes:
        req = n.request
        stream = n.stream
        # The node-level tag wins over the request's in tenant_tag, so the
        # override must land on both or a builder-set node tenant survives.
        tenant_tag = tenant if tenant is not None else n.tenant
        if req is not None:
            kw = {}
            if req.issue_time:
                # The graph honors start_s (shifted below); drop the stale
                # embedded time so the node-level validation stays true.
                kw["issue_time"] = 0.0
            if tenant is not None:
                kw["tenant"] = tenant
            if priority is not None:
                kw["priority"] = priority
            if stream_prefix:
                kw["stream"] = stream_prefix + (
                    stream if stream is not None else req.stream)
                stream = None
            if kw:
                req = _dc_replace(req, **kw)
        elif stream_prefix:
            stream = stream_prefix + n.stream_tag
        nodes.append(_dc_replace(
            n,
            name=name_prefix + n.name,
            deps=tuple(name_prefix + d for d in n.deps),
            request=req,
            start_s=n.start_s + start_offset_s,
            stream=stream,
            tenant=tenant_tag,
        ))
    return TrafficGraph(tuple(nodes))

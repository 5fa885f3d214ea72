"""Traffic-graph builders: training buckets, 1F1B pipelines, serving.

Three workload families expressed in the one IR:

  * :func:`training_traffic` — the dependency-gated re-expression of
    ``repro_torch.core.workloads.dp_bucket_requests``: a forward-compute node, a
    backward-compute spine whose segments gate the gradient buckets as
    back-propagation retires them, and a per-iteration optimizer barrier
    that makes multi-iteration streams *closed-loop* (contention slows the
    next iteration's start — the fixed-gap ``TenantJob.requests`` stream
    cannot express that).
  * :func:`pipeline_traffic` — 1F1B pipeline-parallel stage streams:
    per-stage compute nodes serialized in the 1F1B op order, activation /
    gradient boundary transfers gated on the producing stage's compute.
  * :func:`serving_traffic` — prefill/decode chains: prefill is a burst of
    collectives gated on the prompt's compute; decode is a long dependency
    chain of small collectives, one per generated token, each gated on the
    previous token's comm plus the per-token compute.
    :func:`serving_costs_from_arch` derives the per-token byte/compute
    numbers from the repo's model configs (``repro_torch.configs``) and the
    analytic roofline behind ``launch/serve.py``'s programs.

Builders emit tenant-neutral graphs; bind them to a tenant with
``repro_torch.traffic.retag`` or ``repro_torch.tenancy.TenantJob``.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace

from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.workloads import Workload, dp_bucket_requests
from repro_torch.traffic.ir import TrafficGraph, TrafficNode


def training_traffic(
    workload: Workload,
    *,
    n_buckets: int = 8,
    iterations: int = 1,
    start_s: float = 0.0,
    step_s: float = 0.0,
    min_period_s: float | None = None,
    name: str | None = None,
) -> TrafficGraph:
    """Dependency-gated training-iteration stream.

    Per iteration: a gate node (earliest-start floor), a forward-compute
    node, a backward spine of compute segments (one per distinct bucket
    retirement time of :func:`~repro_torch.core.workloads.dp_bucket_requests`),
    the gradient-bucket requests each gated on its spine segment, and a
    ``step`` barrier (``step_s`` of optimizer compute) depending on every
    request — the next iteration's forward starts only once all gradients
    (and ZeRO param gathers) of this one have drained.  With no contention
    the bucket issue times equal the fixed-time stream's exactly.

    ``min_period_s`` floors iteration *i*'s start at
    ``start_s + i * min_period_s`` (an input pipeline that cannot deliver
    batches faster); default: purely closed-loop.
    """
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    if step_s < 0:
        raise ValueError("step_s must be >= 0")
    nm = name or workload.name
    base = dp_bucket_requests(workload, n_buckets)
    times = sorted({r.issue_time for r in base})
    nodes: list[TrafficNode] = []
    prev_barrier: str | None = None
    for it in range(iterations):
        gate = f"{nm}/it{it}/start"
        floor = start_s + it * min_period_s if min_period_s else (
            start_s if it == 0 else 0.0)
        nodes.append(TrafficNode(
            gate, deps=(prev_barrier,) if prev_barrier else (),
            start_s=floor))
        fwd = f"{nm}/it{it}/fwd"
        nodes.append(TrafficNode(fwd, compute_s=workload.compute_fwd_s,
                                 deps=(gate,)))
        spine_of: dict[float, str] = {}
        prev_seg, t_prev = fwd, 0.0
        for k, t in enumerate(times):
            seg = f"{nm}/it{it}/bwd{k}"
            nodes.append(TrafficNode(seg, compute_s=t - t_prev,
                                     deps=(prev_seg,)))
            spine_of[t] = seg
            prev_seg, t_prev = seg, t
        req_names = []
        for j, r in enumerate(base):
            rn = f"{nm}/it{it}/{r.stream}{j}"
            nodes.append(TrafficNode(
                rn, request=_dc_replace(r, issue_time=0.0),
                deps=(spine_of[r.issue_time],)))
            req_names.append(rn)
        barrier = f"{nm}/it{it}/step"
        nodes.append(TrafficNode(barrier, compute_s=step_s,
                                 deps=tuple(req_names) + (prev_seg,)))
        prev_barrier = barrier
    return TrafficGraph(tuple(nodes))


def _1f1b_order(stages: int, microbatches: int, s: int):
    """Stage ``s``'s op sequence under the non-interleaved 1F1B schedule:
    ``min(M, S - s)`` warmup forwards, then alternating 1B1F, then the
    cooldown backwards."""
    warmup = min(microbatches, stages - s)
    ops = [("F", m) for m in range(warmup)]
    b = 0
    for f in range(warmup, microbatches):
        ops.append(("B", b))
        b += 1
        ops.append(("F", f))
    while b < microbatches:
        ops.append(("B", b))
        b += 1
    return ops


def pipeline_traffic(
    *,
    stages: int,
    microbatches: int,
    fwd_s: float,
    bwd_s: float,
    act_bytes: float,
    grad_bytes: float | None = None,
    collective: str = "AG",
    grad_ar_bytes: float = 0.0,
    n_grad_buckets: int = 1,
    start_s: float = 0.0,
    name: str = "pp",
) -> TrafficGraph:
    """1F1B pipeline-parallel stage streams.

    Per (stage, microbatch): a forward compute node (gated on the previous
    op in the stage's 1F1B order *and* the upstream activation transfer), an
    activation-boundary request after it (stream ``pp-act``), a backward
    compute node (gated on the downstream gradient transfer), and a
    gradient-boundary request (stream ``pp-grad``).  Boundary transfers are
    modeled as their bandwidth-equivalent collective on the fabric
    (``collective``, default AG) — the simulator is a collective engine, so
    a stage-boundary P2P rides the same dims with the same byte volume.
    ``grad_ar_bytes > 0`` appends each stage's data-parallel gradient
    all-reduce (``n_grad_buckets`` buckets, stream ``pp-dp``) after its last
    backward — the pipeline-over-DP mix of Megatron-style training.
    Transfers hang *off* the compute chain (async sends): a stage's next op
    never waits for its own outbound transfer, only consumers wait.
    """
    if stages < 1 or microbatches < 1:
        raise ValueError("stages and microbatches must be >= 1")
    if fwd_s < 0 or bwd_s < 0:
        raise ValueError("fwd_s/bwd_s must be >= 0")
    if grad_bytes is None:
        grad_bytes = act_bytes
    if n_grad_buckets < 1:
        raise ValueError("n_grad_buckets must be >= 1")
    S, M = stages, microbatches
    nodes: list[TrafficNode] = []
    for s in range(S):
        prev: str | None = None
        for kind, m in _1f1b_order(S, M, s):
            if kind == "F":
                node = f"{name}/s{s}/f{m}"
                deps = [prev] if prev else []
                if s > 0:
                    deps.append(f"{name}/s{s - 1}/act{m}")
                nodes.append(TrafficNode(
                    node, compute_s=fwd_s, deps=tuple(deps),
                    start_s=start_s if not deps else 0.0,
                    stream="pp-compute"))
                if s < S - 1:
                    nodes.append(TrafficNode(
                        f"{name}/s{s}/act{m}",
                        request=CollectiveRequest(collective, act_bytes,
                                                  stream="pp-act"),
                        deps=(node,)))
            else:
                node = f"{name}/s{s}/b{m}"
                gate = (f"{name}/s{s + 1}/grad{m}" if s < S - 1
                        else f"{name}/s{s}/f{m}")
                deps = [prev] if prev else []
                if gate not in deps:
                    deps.append(gate)
                nodes.append(TrafficNode(node, compute_s=bwd_s,
                                         deps=tuple(deps),
                                         stream="pp-compute"))
                if s > 0:
                    nodes.append(TrafficNode(
                        f"{name}/s{s}/grad{m}",
                        request=CollectiveRequest(collective, grad_bytes,
                                                  stream="pp-grad"),
                        deps=(node,)))
            prev = node
    if grad_ar_bytes > 0:
        for s in range(S):
            last_b = f"{name}/s{s}/b{M - 1}"
            for j in range(n_grad_buckets):
                nodes.append(TrafficNode(
                    f"{name}/s{s}/dp-ar{j}",
                    request=CollectiveRequest(
                        "AR", grad_ar_bytes / n_grad_buckets,
                        stream="pp-dp"),
                    deps=(last_b,)))
    return TrafficGraph(tuple(nodes))


def serving_traffic(
    *,
    prefill_bytes: float,
    decode_bytes: float,
    prefill_s: float,
    decode_s: float,
    gen_tokens: int,
    n_requests: int = 1,
    arrival_gap_s: float = 0.0,
    start_s: float = 0.0,
    prefill_ops: int = 4,
    collective: str = "AG",
    name: str = "serve",
    arrival_times: "list[float] | None" = None,
) -> TrafficGraph:
    """Serving prefill/decode chains.

    Per request ``r`` (arriving at ``start_s + r * arrival_gap_s``): a
    prefill compute node, then a *burst* of ``prefill_ops`` collectives
    (stream ``prefill``) splitting ``prefill_bytes`` and issued together,
    then ``gen_tokens`` decode steps — a *chain* of small collectives
    (stream ``decode``), token ``t`` gated on token ``t-1``'s comm plus
    ``decode_s`` of per-token compute.  Decode comm latency percentiles
    (``SimResult.stream_stats()['decode'].latency_p99``) are the serving
    SLO metric.

    ``arrival_times`` switches the fixed-gap arrival grid to an explicit
    per-request timestamp list (the open-loop fleet path: seeded arrival
    processes from ``repro.fleet`` hand their draws in here).  When
    given, it overrides ``n_requests``/``arrival_gap_s``/``start_s``.
    """
    if arrival_times is not None:
        arrival_times = list(arrival_times)
        if not arrival_times:
            raise ValueError("arrival_times must be non-empty")
        n_requests = len(arrival_times)
    if gen_tokens < 0 or n_requests < 1:
        raise ValueError("gen_tokens must be >= 0, n_requests >= 1")
    ops = max(1, prefill_ops)
    nodes: list[TrafficNode] = []
    for r in range(n_requests):
        base = f"{name}/r{r}"
        gate = f"{base}/prefill-compute"
        arrive = (arrival_times[r] if arrival_times is not None
                  else start_s + r * arrival_gap_s)
        nodes.append(TrafficNode(gate, compute_s=prefill_s,
                                 start_s=arrive,
                                 stream="prefill-compute"))
        burst = []
        for j in range(ops):
            nm = f"{base}/prefill{j}"
            nodes.append(TrafficNode(
                nm,
                request=CollectiveRequest(collective, prefill_bytes / ops,
                                          stream="prefill"),
                deps=(gate,)))
            burst.append(nm)
        prev = tuple(burst)
        for t in range(gen_tokens):
            nm = f"{base}/decode{t}"
            nodes.append(TrafficNode(
                nm,
                request=CollectiveRequest(collective, decode_bytes,
                                          stream="decode"),
                compute_s=decode_s,
                deps=prev))
            prev = (nm,)
    return TrafficGraph(tuple(nodes))


def serving_costs_from_arch(
    arch: str,
    *,
    batch: int = 8,
    prompt_len: int = 1024,
    tp: int = 8,
    flops_per_npu: float = 312e12,
    reduced: bool = False,
) -> dict[str, float]:
    """Per-request serving cost model from the repo's config registry.

    Collective bytes come from ``launch/roofline.analytic_collective_bytes``
    (the per-axis wire-byte model behind the ``launch/serve.py`` programs:
    2 tensor-parallel collectives per layer, one token per decode step);
    compute times from ``analytic_fwd_flops`` at ``flops_per_npu`` per NPU
    across the ``tp`` group.  Returns the kwargs
    :func:`serving_traffic` needs: ``prefill_bytes`` / ``decode_bytes`` /
    ``prefill_s`` / ``decode_s``.

    ``flops_per_npu`` (312e12) is the rate of the NPU that the simulated
    fabric connects, a parameter of the scenario as in the reference; it is
    not a reading of any card.
    """
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_arch
    from repro_torch.launch.roofline import (
        analytic_collective_bytes,
        analytic_fwd_flops,
    )

    cfg = get_arch(arch, reduced=reduced)
    par = ParallelConfig(data=1, model=tp)
    axes = {"model": tp, "data": 1}
    pre = analytic_collective_bytes(
        cfg, ShapeConfig("traffic", prompt_len, batch, "prefill"), 0, par,
        axes)
    dec = analytic_collective_bytes(
        cfg, ShapeConfig("traffic", prompt_len, batch, "decode"), 0, par,
        axes)
    agg_flops = tp * flops_per_npu
    return {
        "prefill_bytes": pre.get("model", 0.0),
        "decode_bytes": dec.get("model", 0.0),
        "prefill_s": analytic_fwd_flops(cfg, batch, prompt_len) / agg_flops,
        "decode_s": analytic_fwd_flops(cfg, batch, 1, context=prompt_len)
        / agg_flops,
    }

"""The port's dependency-aware traffic IR (``repro_torch.traffic``) against
the reference's, on the CPU.

Mirrors ``tests/test_traffic.py`` (IR validation, the timing semantics of
dependency gating, stream percentiles, the training / pipeline / serving
builders and ``serving_costs_from_arch``, ``retag`` / ``merge_graphs``,
mixed tenants, DCN stragglers) and the dependency-graph cases of
``tests/test_engine_equiv.py`` (random DAGs under every policy and arbiter,
jitter and stragglers, the batch runner, tracing). Each graph is built
twice from the same numbers, once per package; graphs are compared as
plain values, and each port engine's result is held to the **same**
reference engine's field for field. No test asserts indexed == reference:
the reference's engines differ by 1-2 ulp on traffic graphs (ROADMAP §3,
R6). The last tests hold ``chip_smoke.py``'s ``phase_traffic`` to
``benchmarks/traffic_study.py``.
"""
import math
import random

import pytest
from _sim_twins import (ARB_POLICIES, ENGINES, MB, PORT, REF, assert_same, chip_smoke,
                        plain, raises_alike, same_run, study)

POLICIES = PORT.POLICIES
TOPO2D = "2D-SW_SW"


def _graph(g, ns):
    """A traffic graph as plain values: its nodes, dependency indices, order,
    the simulator's per-group arguments and the scheduling pass's estimated
    issue and finish times (without and with a latency model of ``ns``)."""
    lm = ns.LatencyModel.for_topology(ns.TOPOS["3D-SW_SW_SW_hetero"])
    return (plain(g.nodes), g.deps_idx, g.topo_order, plain(g.sim_kwargs()), g.n_requests,
            g.estimate_times(), g.estimate_times(lm))


def _same_graph(make):
    got, want = make(PORT), make(REF)
    assert _graph(got, PORT) == _graph(want, REF)
    return got


def _pod(ns, *args, **kw):
    return ns.make_tpu_pod_topology(*args, **kw)


# ---------------------------------------------------------------------------
# IR validation
# ---------------------------------------------------------------------------
BAD_GRAPHS = {
    "duplicate": lambda ns: ns.TrafficGraph((ns.TrafficNode("a"), ns.TrafficNode("a"))),
    "unknown dep": lambda ns: ns.TrafficGraph((ns.TrafficNode("a", deps=("ghost",)),)),
    "cycle": lambda ns: ns.TrafficGraph((ns.TrafficNode("a", deps=("b",)),
                                         ns.TrafficNode("b", deps=("a",)))),
    "self cycle": lambda ns: ns.TrafficGraph((ns.TrafficNode("a", deps=("a",)),)),
    "negative compute": lambda ns: ns.TrafficNode("x", compute_s=-1.0),
    "negative start": lambda ns: ns.TrafficNode("x", start_s=-1.0),
    "empty name": lambda ns: ns.TrafficNode(""),
    "stale issue time": lambda ns: ns.TrafficNode(
        "x", request=ns.CollectiveRequest("AR", MB, issue_time=5.0)),
}


@pytest.mark.parametrize("case", list(BAD_GRAPHS))
def test_graph_and_node_validation(case):
    raises_alike(BAD_GRAPHS[case])


def test_graph_allows_forward_references():
    g = _same_graph(lambda ns: ns.TrafficGraph((ns.TrafficNode("late", deps=("early",)),
                                                ns.TrafficNode("early", compute_s=1.0))))
    assert g.topo_order == (1, 0)
    assert g.estimate_times()[0] == [1.0, 1.0]
    _same_graph(lambda ns: ns.TrafficGraph((ns.TrafficNode(
        "x", request=ns.CollectiveRequest("AR", MB, issue_time=5.0), start_s=5.0),)))


DEP_ERRORS = {
    "requires deps": lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [[]], dep_delay_s=[0.0]),
    "out of range": lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [[], []], deps=[(), (5,)]),
    "self": lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [[]], deps=[(0,)]),
    "length": lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [[], []], deps=[()]),
    "enforced order": lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [[]], deps=[()],
                                             enforced_order=[[]]),
}


@pytest.mark.parametrize("case", list(DEP_ERRORS))
def test_simulate_validates_dep_arguments(case):
    raises_alike(DEP_ERRORS[case])


# ---------------------------------------------------------------------------
# Fixed-time streams through the IR
# ---------------------------------------------------------------------------
def _fixed_reqs(ns, rng):
    return [ns.CollectiveRequest(rng.choice(("AR", "RS", "AG")), rng.uniform(1, 50) * MB,
                                 issue_time=rng.uniform(0, 2e-3), priority=rng.choice((0, 1)),
                                 stream=f"s{i % 3}", tenant=f"t{i % 2}")
            for i in range(12)]


@pytest.mark.parametrize("tname", ["2D-SW_SW", "3D-SW_SW_SW_hetero"])
def test_fixed_time_graph_equals_simulate_requests_and_reference(tname):
    def run(ns):
        reqs = _fixed_reqs(ns, random.Random(11 + len(tname)))
        return ns.simulate_traffic(ns.TOPOS[tname], ns.from_requests(reqs),
                                   chunks_per_collective=6)

    res, groups = same_run(run)
    reqs = _fixed_reqs(PORT, random.Random(11 + len(tname)))
    r0, g0 = PORT.simulate_requests(PORT.TOPOS[tname], reqs, chunks_per_collective=6)
    assert res.diff_fields(r0) == []
    assert [[c.schedule for c in g] for g in g0] == [[c.schedule for c in g] for g in groups]


# ---------------------------------------------------------------------------
# Dependency-gating semantics
# ---------------------------------------------------------------------------
def _run_graph(make, chunks=4, **kw):
    """``simulate_traffic`` of ``make(ns)`` in both packages, held equal;
    the port's result and graph."""
    res, _ = same_run(lambda ns: ns.simulate_traffic(ns.TOPOS[TOPO2D], make(ns),
                                                     chunks_per_collective=chunks, **kw))
    return res, make(PORT)


def test_dependent_group_issues_at_parent_finish_plus_delay():
    res, g = _run_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("a", request=ns.CollectiveRequest("AR", 20 * MB)),
        ns.TrafficNode("b", request=ns.CollectiveRequest("AR", 20 * MB), compute_s=3e-4,
                       deps=("a",)))))
    ia, ib = g.index_of("a"), g.index_of("b")
    assert res.group_issue[ib] == res.group_finish[ia] + 3e-4
    assert res.group_finish[ib] > res.group_issue[ib]


def test_start_floor_bounds_dependent_issue():
    res, g = _run_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("a", request=ns.CollectiveRequest("AR", 1 * MB)),
        ns.TrafficNode("b", request=ns.CollectiveRequest("AR", 1 * MB), deps=("a",),
                       start_s=1.0))), chunks=2)
    assert res.group_issue[g.index_of("b")] == 1.0
    assert res.makespan >= 1.0


def test_estimated_times_take_the_later_of_floor_and_parents_plus_compute():
    """The scheduling pass's estimates: a dependent node issues at
    max(start_s, its parents' finish + compute_s)."""
    g = _same_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("a", compute_s=0.1),
        ns.TrafficNode("b", compute_s=0.2, deps=("a",), start_s=0.5),
        ns.TrafficNode("c", request=ns.CollectiveRequest("AR", 4 * MB), compute_s=0.3,
                       deps=("a",), start_s=0.2))))
    assert g.estimate_times()[0] == [0.1, 0.5, 0.4]


def test_compute_only_chain_accumulates_delays():
    res, _ = _run_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("c0", compute_s=0.5, start_s=0.25),
        ns.TrafficNode("c1", compute_s=0.5, deps=("c0",)),
        ns.TrafficNode("c2", compute_s=0.5, deps=("c1",)))), chunks=64)
    assert res.group_finish == [0.75, 1.25, 1.75]
    assert res.makespan == 1.75


def test_multi_parent_gate_waits_for_latest():
    res, g = _run_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("fast", compute_s=0.1),
        ns.TrafficNode("slow", compute_s=0.9),
        ns.TrafficNode("join", request=ns.CollectiveRequest("AR", 4 * MB),
                       deps=("fast", "slow")))), chunks=2)
    assert res.group_issue[g.index_of("join")] == 0.9


def test_root_request_with_compute_issues_after_compute():
    res, _ = _run_graph(lambda ns: ns.TrafficGraph((
        ns.TrafficNode("r", request=ns.CollectiveRequest("AR", 4 * MB), compute_s=0.2,
                       start_s=0.1),)), chunks=2)
    assert res.group_issue[0] == pytest.approx(0.3)


# ---------------------------------------------------------------------------
# Stream percentiles
# ---------------------------------------------------------------------------
def test_stream_stats_percentiles():
    def run(ns):
        reqs = [ns.CollectiveRequest("AR", (i + 1) * 4 * MB, issue_time=i * 0.05, stream="s")
                for i in range(10)]
        return ns.simulate_requests(ns.TOPOS[TOPO2D], reqs, chunks_per_collective=4)

    res, _ = same_run(run)
    st = res.stream_stats()["s"]
    assert plain(st) == plain(run(REF)[0].stream_stats()["s"])
    lats = sorted(res.group_finish[i] - res.group_issue[i] for i in range(10))
    assert st.latency_p50 == pytest.approx(lats[4] + 0.5 * (lats[5] - lats[4]))
    assert st.latency_p99 == pytest.approx(lats[8] + 0.91 * (lats[9] - lats[8]))
    assert st.latency_p50 <= st.latency_p95 <= st.latency_p99 <= st.latency_max


def test_tenant_percentiles_exclude_compute_nodes():
    def graph(ns):
        return ns.retag(ns.training_traffic(ns.make_resnet152(), n_buckets=8, iterations=2),
                        name_prefix="train/", tenant="train")

    g = _same_graph(graph)
    res, _ = same_run(lambda ns: ns.simulate_traffic(_pod(ns, 2, 4, 4), graph(ns),
                                                     chunks_per_collective=8))
    st = res.stream_stats(by="tenant")["train"]
    req_lats = sorted(res.group_finish[i] - res.group_issue[i]
                      for i, n in enumerate(g.nodes) if n.request is not None)
    assert st.latency_p50 >= req_lats[0] > 0
    assert st.latency_mean == pytest.approx(sum(req_lats) / len(req_lats))
    assert res.stream_stats()["compute"].latency_max == 0.0


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(n_buckets=8, iterations=1),
                                dict(n_buckets=4, iterations=3, start_s=1e-3, step_s=2e-4),
                                dict(n_buckets=16, iterations=2, min_period_s=0.05,
                                     name="rn")])
def test_training_traffic_equals_reference(kw):
    _same_graph(lambda ns: ns.training_traffic(ns.make_resnet152(), **kw))
    _same_graph(lambda ns: ns.training_traffic(ns.make_gnmt(), **kw))


def test_training_traffic_matches_fixed_stream_when_uncontended():
    wl = PORT.make_resnet152()
    g = PORT.training_traffic(wl, n_buckets=8, iterations=1)
    res, _ = same_run(lambda ns: ns.simulate_traffic(
        _pod(ns, 1, 8, 8), ns.training_traffic(ns.make_resnet152(), n_buckets=8, iterations=1),
        chunks_per_collective=8))
    got = sorted(res.group_issue[i] for i, n in enumerate(g.nodes) if n.request is not None)
    want = sorted(wl.compute_fwd_s + r.issue_time for r in PORT.dp_bucket_requests(wl, 8))
    assert got == pytest.approx(want)


def test_training_traffic_multi_iteration_is_closed_loop():
    wl = PORT.make_resnet152()
    g = PORT.training_traffic(wl, n_buckets=8, iterations=3)
    res, _ = same_run(lambda ns: ns.simulate_traffic(
        _pod(ns, 2, 4, 4), ns.training_traffic(ns.make_resnet152(), n_buckets=8, iterations=3),
        chunks_per_collective=8))
    for it in range(2):
        step_fin = res.group_finish[g.index_of(f"{wl.name}/it{it}/step")]
        assert res.group_issue[g.index_of(f"{wl.name}/it{it + 1}/start")] == step_fin
        assert step_fin >= max(res.group_finish[i] for i, n in enumerate(g.nodes)
                               if n.request is not None
                               and n.name.startswith(f"{wl.name}/it{it}/"))


def _pipeline(ns, **kw):
    return ns.pipeline_traffic(stages=4, microbatches=6, fwd_s=1e-3, bwd_s=2e-3,
                               act_bytes=8 * MB, grad_ar_bytes=40 * MB, n_grad_buckets=4, **kw)


def test_pipeline_traffic_1f1b_structure():
    S, M, fwd = 4, 6, 1e-3
    g = _same_graph(_pipeline)
    _same_graph(lambda ns: ns.pipeline_traffic(stages=3, microbatches=5, fwd_s=2e-3,
                                               bwd_s=1e-3, act_bytes=MB, grad_bytes=2 * MB,
                                               collective="AR", start_s=0.5, name="p2"))
    res, _ = same_run(lambda ns: ns.simulate_traffic(ns.TOPOS["3D-SW_SW_SW_homo"],
                                                     _pipeline(ns), chunks_per_collective=4))
    for s in range(S):
        assert res.group_finish[g.index_of(f"pp/s{s}/f0")] >= (s + 1) * fwd
    assert (res.group_issue[g.index_of(f"pp/s{S - 1}/b0")]
            >= res.group_finish[g.index_of(f"pp/s{S - 1}/f0")])
    assert res.makespan >= M * (1e-3 + 2e-3)
    for s in range(S):
        assert (res.group_issue[g.index_of(f"pp/s{s}/dp-ar0")]
                >= res.group_finish[g.index_of(f"pp/s{s}/b{M - 1}")])
    assert {"pp-act", "pp-grad", "pp-dp", "pp-compute"} <= set(res.stream_stats())


def _serving(ns, **kw):
    return ns.serving_traffic(prefill_bytes=32 * MB, decode_bytes=1 * MB, prefill_s=1e-3,
                              decode_s=2e-4, gen_tokens=8, n_requests=2, arrival_gap_s=5e-3,
                              **kw)


def test_serving_traffic_decode_chain_is_sequential():
    g = _same_graph(_serving)
    _same_graph(lambda ns: _serving(ns, arrival_times=[0.0, 1e-3], prefill_ops=2,
                                    collective="AR", name="s2", start_s=0.25))
    res, _ = same_run(lambda ns: ns.simulate_traffic(_pod(ns, 1, 8, 8), _serving(ns),
                                                     chunks_per_collective=4))
    for r in range(2):
        prev_fin = None
        for t in range(8):
            i = g.index_of(f"serve/r{r}/decode{t}")
            if prev_fin is not None:
                assert res.group_issue[i] == pytest.approx(prev_fin + 2e-4)
            prev_fin = res.group_finish[i]
        burst = [res.group_issue[g.index_of(f"serve/r{r}/prefill{j}")] for j in range(4)]
        assert len(set(burst)) == 1
    assert res.stream_stats()["decode"].n == 16


@pytest.mark.parametrize("arch,kw", [
    ("llama3-8b", dict(batch=4, prompt_len=256, tp=8)),
    ("llama3-8b", dict(batch=4, prompt_len=512, tp=8)),
    ("qwen2.5-3b", dict(batch=8, prompt_len=1024, tp=4)),
    ("llama3-8b", dict(reduced=True)),
])
def test_serving_costs_from_arch_equal_reference(arch, kw):
    """The port's config and roofline give the reference's serving costs."""
    costs = PORT.serving_costs_from_arch(arch, **kw)
    assert costs == REF.serving_costs_from_arch(arch, **kw)
    assert costs["prefill_bytes"] > costs["decode_bytes"] > 0
    assert costs["prefill_s"] > costs["decode_s"] > 0
    assert costs["decode_bytes"] < 64 * MB


# ---------------------------------------------------------------------------
# retag / merge / tenancy integration
# ---------------------------------------------------------------------------
def test_retag_namespaces_and_offsets():
    def small(ns):
        return ns.serving_traffic(prefill_bytes=8 * MB, decode_bytes=MB, prefill_s=1e-3,
                                  decode_s=1e-4, gen_tokens=2)

    t = _same_graph(lambda ns: ns.retag(small(ns), name_prefix="svc/", tenant="svc",
                                        stream_prefix="svc/", priority=2, start_offset_s=0.5))
    assert all(n.name.startswith("svc/") and n.tenant_tag == "svc" for n in t.nodes)
    assert all(n.request.priority == 2 for n in t.nodes if n.request is not None)
    assert t.node("svc/serve/r0/prefill-compute").start_s == pytest.approx(0.5)
    t2 = _same_graph(lambda ns: ns.retag(ns.TrafficGraph((ns.TrafficNode(
        "a", request=ns.CollectiveRequest("AR", MB), tenant="builder-set"),)), tenant="t1"))
    assert t2.nodes[0].tenant_tag == "t1" and t2.nodes[0].request.tenant == "t1"
    t3 = _same_graph(lambda ns: ns.retag(ns.from_requests(
        [ns.CollectiveRequest("AR", MB, issue_time=0.25)]), start_offset_s=1.0))
    assert t3.nodes[0].start_s == pytest.approx(1.25)
    assert t3.nodes[0].request.issue_time == 0.0


def test_merge_graphs_rejects_collisions_and_merges():
    def one(ns, name="serve"):
        return ns.serving_traffic(prefill_bytes=MB, decode_bytes=MB, prefill_s=0.0,
                                  decode_s=0.0, gen_tokens=1, name=name)

    raises_alike(lambda ns: ns.merge_graphs(one(ns), one(ns)))
    _same_graph(lambda ns: ns.merge_graphs(one(ns), one(ns, "other"), _pipeline(ns)))


def _mixed(ns):
    train = ns.TenantJob(ns.TenantSpec("train", iterations=2, n_buckets=8),
                         ns.make_resnet152())
    serve = ns.TenantJob(ns.TenantSpec("serve", weight=2.0, slo_slowdown=1.2),
                         traffic_builder=lambda job: ns.serving_traffic(
                             prefill_bytes=48 * MB, decode_bytes=1.5 * MB, prefill_s=2e-3,
                             decode_s=2e-4, gen_tokens=10, n_requests=2, arrival_gap_s=2e-3))
    return ns.tenant_traffic([train, serve]), [train.spec, serve.spec]


@pytest.mark.parametrize("pol", ["fifo", "weighted-fair"])
def test_mixed_training_serving_tenants_under_arbiter(pol):
    _same_graph(lambda ns: _mixed(ns)[0])

    def run(ns):
        graph, specs = _mixed(ns)
        return ns.simulate_traffic(_pod(ns, 2, 8, 8), graph, chunks_per_collective=8,
                                   arbiter=ns.FabricArbiter(pol, specs))

    res, _ = same_run(run)
    assert {"train", "serve"} <= set(res.stream_stats(by="tenant"))
    st = res.stream_stats()["serve/decode"]
    assert st.n == 20 and st.latency_p99 >= st.latency_p50 > 0
    assert math.isfinite(res.finish_time())


def test_tenant_job_backward_compat_and_guards():
    def job(ns):
        return ns.TenantJob(ns.TenantSpec("t", iterations=2), ns.make_resnet152())

    assert plain(job(PORT).requests()) == plain(job(REF).requests())
    assert _graph(job(PORT).traffic(), PORT) == _graph(job(REF).traffic(), REF)
    assert job(PORT).traffic().n_requests > 0
    raises_alike(lambda ns: ns.TenantJob(ns.TenantSpec("bare")).requests())
    raises_alike(lambda ns: ns.TenantJob(ns.TenantSpec("bare")).traffic())


# ---------------------------------------------------------------------------
# DCN straggler jitter
# ---------------------------------------------------------------------------
def test_dcn_straggler_is_seeded_and_pod_scoped():
    def run(sigma, seed):
        def make(ns):
            g = ns.training_traffic(ns.make_resnet152(), n_buckets=8, iterations=1)
            topo = _pod(ns, 2, 4, 4, dcn_straggler_sigma=sigma) if sigma else _pod(ns, 2, 4, 4)
            return ns.simulate_traffic(topo, g, chunks_per_collective=8, seed=seed)
        return same_run(make)[0]

    r0, a, c = run(0.0, 7), run(0.5, 7), run(0.5, 8)
    assert a.diff_fields(run(0.5, 7)) == []
    assert a.makespan != c.makespan and a.makespan != r0.makespan
    raises_alike(lambda ns: _pod(ns, dcn_straggler_sigma=-0.1))
    raises_alike(lambda ns: _pod(ns, 1, 8, 8, dcn_straggler_sigma=0.5))


# ---------------------------------------------------------------------------
# Dependency graphs on the engines (tests/test_engine_equiv.py)
# ---------------------------------------------------------------------------
def _rand_graph(ns, rng, n_nodes, tenants=("default",)):
    """``tests/test_engine_equiv.py``'s random DAG, in package ``ns``."""
    nodes = []
    for i in range(n_nodes):
        n_deps = rng.randrange(0, min(i, 3) + 1) if i else 0
        deps = tuple(f"n{j}" for j in sorted(rng.sample(range(i), n_deps)))
        if rng.random() < 0.25:
            nodes.append(ns.TrafficNode(f"n{i}", compute_s=rng.uniform(0, 5e-4), deps=deps,
                                        start_s=rng.uniform(0, 1e-3) if not deps else 0.0,
                                        tenant=rng.choice(tenants)))
        else:
            req = ns.CollectiveRequest(rng.choice(("AR", "RS", "AG")),
                                       rng.uniform(1, 40) * MB,
                                       priority=rng.choice((0, 0, 1)), stream=f"s{i % 3}",
                                       tenant=rng.choice(tenants))
            nodes.append(ns.TrafficNode(f"n{i}", request=req,
                                        compute_s=rng.uniform(0, 2e-4), deps=deps,
                                        start_s=rng.uniform(0, 1e-3) if not deps else 0.0))
    return ns.TrafficGraph(tuple(nodes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_dependency_graphs_equal_reference(seed):
    for tenants in (("default",), ("a", "b")):
        _same_graph(lambda ns: _rand_graph(ns, random.Random(seed), 24, tenants))


@pytest.mark.parametrize("eng", ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
def test_engines_on_dependency_graphs_equal_reference(policy, eng):
    for t, tname in enumerate(("2D-SW_SW", "3D-SW_SW_SW_hetero", "4D-Ring_FC_Ring_SW")):
        for intra in ("SCF", "FIFO"):
            seed = 500 + 10 * POLICIES.index(policy) + t
            same_run(lambda ns: ns.simulate_traffic(
                ns.TOPOS[tname], _rand_graph(ns, random.Random(seed), 14), policy=policy,
                chunks_per_collective=6, intra=intra, engine=eng))


@pytest.mark.parametrize("eng", ("indexed", "reference"))
@pytest.mark.parametrize("arb_policy", ARB_POLICIES)
def test_engines_on_dependency_graphs_under_arbiters_equal_reference(arb_policy, eng):
    arbs = {}

    def run(ns):
        specs = [ns.TenantSpec("a", weight=2.0),
                 ns.TenantSpec("b", weight=1.0, priority=1, slo_slowdown=1.5)]
        arbs[ns.root] = ns.FabricArbiter(arb_policy, specs, quantum_chunks=4,
                                         isolated_latency={"b": 0.001})
        graph = _rand_graph(ns, random.Random(600 + ARB_POLICIES.index(arb_policy)), 16,
                            ("a", "b"))
        return ns.simulate_traffic(ns.TOPOS["3D-SW_SW_SW_hetero"], graph,
                                   chunks_per_collective=6, arbiter=arbs[ns.root], engine=eng)

    same_run(run)
    assert arbs["repro_torch"].discipline_state() == arbs["repro"].discipline_state()


@pytest.mark.parametrize("eng", ENGINES)
@pytest.mark.parametrize("seed", [0, 3])
def test_engines_on_dependency_graphs_with_jitter_and_straggler(seed, eng):
    same_run(lambda ns: ns.simulate_traffic(
        _pod(ns, 2, 4, 4, dcn_straggler_sigma=0.4), _rand_graph(ns, random.Random(77 + seed),
                                                                12),
        chunks_per_collective=5, jitter=0.1, seed=seed, engine=eng))


def test_simulate_batch_for_traffic_scenarios_equals_reference():
    """``Scenario(traffic=...)``, with and without an arbiter factory,
    through the port's ``simulate_batch`` (cold and warm caches) and
    ``simulate_scenario``, equal to the reference's ``simulate_scenario``."""
    def scenarios(ns):
        rng = random.Random(91)
        specs = [ns.TenantSpec("a", weight=2.0), ns.TenantSpec("b")]
        out = []
        for tname in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
            graph = _rand_graph(ns, rng, 12, ("a", "b"))
            for jitter, seed in ((0.0, 0), (0.1, 5)):
                for factory in (None, lambda: ns.FabricArbiter("weighted-fair", specs)):
                    out.append(ns.Scenario(ns.TOPOS[tname], traffic=graph,
                                           chunks_per_collective=6, jitter=jitter, seed=seed,
                                           arbiter_factory=factory))
            out.append(ns.Scenario(ns.TOPOS[tname], traffic=graph, chunks_per_collective=6,
                                   engine="compiled", water_filling=True))
        return out

    got, want = scenarios(PORT), scenarios(REF)
    caches = PORT.BatchCaches()
    cold = PORT.simulate_batch(got, caches=caches)
    warm = PORT.simulate_batch(got, caches=caches)
    for g, w, c, h in zip(got, want, cold, warm):
        ref = REF.simulate_scenario(w)
        assert_same(c, ref)
        assert_same(h, ref)
        assert_same(PORT.simulate_scenario(g), ref)
    res, _ = PORT.simulate_traffic(got[0].topology, got[0].traffic, chunks_per_collective=6)
    assert res.diff_fields(cold[0]) == []


def test_scenario_rejects_both_requests_and_traffic():
    def both(ns):
        reqs = (ns.CollectiveRequest("AR", MB),)
        return ns.Scenario(ns.TOPOS[TOPO2D], reqs, traffic=ns.from_requests(reqs))

    assert "not both" in raises_alike(both)
    assert "requests or traffic" in raises_alike(lambda ns: ns.Scenario(ns.TOPOS[TOPO2D]))


@pytest.mark.parametrize("eng", ("indexed", "reference"))
def test_tracing_on_dependency_graphs_equals_reference(eng, tmp_path):
    """Traced dependency graphs: the port's result, dependency edges and
    releases equal the reference's, and its Chrome trace parses to the
    reference's."""
    out = {}
    for ns in (REF, PORT):
        graph = _rand_graph(ns, random.Random(900), 14)
        trc = ns.Tracer()
        res, _ = ns.simulate_traffic(ns.TOPOS["3D-SW_SW_SW_hetero"], graph,
                                     chunks_per_collective=6, engine=eng, tracer=trc)
        path = tmp_path / f"{ns.root}.trace.json"
        trc.save(path)
        out[ns.root] = (res, trc, ns.parse_chrome_trace(path), graph)
    (res, trc, parsed, graph), (j_res, j_trc, j_parsed, _) = out["repro_torch"], out["repro"]
    assert_same(res, j_res)
    assert plain(trc.dep_edges) == plain(j_trc.dep_edges)
    assert plain(trc.releases) == plain(j_trc.releases)
    assert parsed == j_parsed
    assert len(trc.dep_edges) == sum(len(n.deps) for n in graph.nodes)
    assert sorted(g for g, _ in trc.releases) == list(range(len(graph.nodes)))
    assert parsed["flows"] == len(trc.dep_edges)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase_traffic against benchmarks/traffic_study.py
# ---------------------------------------------------------------------------
def _study_pairs(monkeypatch, ts, costs):
    """Run the study's ``equivalence_gate`` with its equality check replaced
    by a recorder (the reference's own indexed and reference engines differ
    by 1-2 ulp here, R6): {label: (result, result)}."""
    pairs = {}
    monkeypatch.setattr(ts, "_assert_equal",
                        lambda a, b, label: pairs.__setitem__(label, (a, b)))
    ts.equivalence_gate(costs, False)
    return pairs


def test_chip_smoke_traffic_equivalence_equals_traffic_study(monkeypatch):
    """``chip_smoke.traffic_equivalence`` runs the study's scenarios: every
    pair of results under every label equals the study's pair, value for
    value; the exact pairs are equal, and indexed lies within
    ``TRAFFIC_ENGINE_RTOL`` of reference with every non-float value equal,
    as ``phase_traffic`` gates."""
    cs, ts = chip_smoke(), study("traffic_study")
    costs = cs.traffic_costs()
    assert costs == REF.serving_costs_from_arch("llama3-8b", batch=4, prompt_len=512, tp=8)
    want = _study_pairs(monkeypatch, ts, costs)
    got = cs.traffic_equivalence(costs)
    assert sorted(want) == sorted(list(got["exact"]) + list(got["engines"]))
    for kind, rtol in (("exact", 0.0), ("engines", cs.TRAFFIC_ENGINE_RTOL)):
        for label, (a, b) in got[kind].items():
            assert_same(a, want[label][0])
            assert_same(b, want[label][1])
            gap, fields = cs.sim_gap(a, b)
            assert not fields and gap <= rtol, (label, gap, fields)
    assert max(cs.sim_gap(*p)[0] for p in got["engines"].values()) > 0.0  # R6 shows


def test_sim_gap_reads_float_and_exact_differences():
    cs = chip_smoke()
    base = PORT.simulate_requests(PORT.TOPOS[TOPO2D], [PORT.CollectiveRequest("AR", 8 * MB)],
                                  chunks_per_collective=4)[0]
    assert cs.sim_gap(base, base) == (0.0, [])
    import dataclasses

    nudged = dataclasses.replace(base, makespan=base.makespan * (1 + 1e-15),
                                 dim_op_order=base.dim_op_order[::-1],
                                 group_tenants=["x"])
    gap, fields = cs.sim_gap(nudged, base)
    assert 0.0 < gap < 1e-14 and fields == ["dim_op_order", "group_tenants"]


def test_chip_smoke_mixed_tenancy_and_dcn_jitter_equal_traffic_study():
    cs, ts = chip_smoke(), study("traffic_study")
    costs = cs.traffic_costs()
    assert cs.traffic_mixed_tenancy(costs) == ts.mixed_tenancy(costs, False)
    assert cs.traffic_dcn_jitter(costs) == ts.dcn_jitter(costs, False)


def test_chip_smoke_long_stream_equals_traffic_study_at_quick_sizes(monkeypatch):
    """``traffic_long_stream`` at the study's quick sizes: the same stage-op
    counts and makespans, compiled equal to indexed at each size. The
    study's timer is replaced by a single untimed call, so its scaling fit
    (a timing, not a correctness check) cannot fail the test."""
    cs, ts = chip_smoke(), study("traffic_study")
    assert cs.LONG_STREAM_SIZES == ((10, 150), (30, 450), (80, 1200), (160, 2400))
    monkeypatch.setattr(ts, "timed_best", lambda fn, *a, repeat=1, **kw: (fn(*a, **kw), 1.0))
    costs = cs.traffic_costs()
    want = ts.long_stream(costs, True)
    got = cs.traffic_long_stream(costs, sizes=((2, 60), (4, 120), (8, 240)))
    keys = ("iterations", "gen_tokens", "stage_ops", "makespan_s")
    assert [{k: p[k] for k in keys} for p in got["points"]] == [
        {k: p[k] for k in keys} for p in want["points"]]
    assert all(p["compiled_equal"] and p["stage_ops_match_groups"] for p in got["points"])
    assert got["largest_stage_ops"] == want["largest_stage_ops"]

"""The reference (``repro``) and the port (``repro_torch``) side by side, for
the tests of the port's ``faults``, ``traffic`` and ``tenancy`` packages.

``REF`` and ``PORT`` carry the same names, each from its own package, so a
test builds one scenario twice from the same numbers with ``make(ns)`` and
never hands an object of one package to the other. Results are compared as
plain Python values (``plain``): a dataclass or named tuple of either
package becomes its class name and its fields, so two results are equal
when every value is, whichever package made them.
"""
import dataclasses
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
MB = 1e6
ENGINES = ("indexed", "compiled", "reference")
ARB_POLICIES = ("fifo", "strict-priority", "weighted-fair", "slo-aware")

_NAMES = {
    "core.requests": ("CollectiveRequest",),
    "core.chunking": ("Chunk",),
    "core.simulator": ("simulate", "simulate_requests", "simulate_scheduled",
                       "build_task_arrays", "_arbiter_indexable"),
    "core.scheduler": ("POLICIES", "ThemisScheduler", "schedule_collective"),
    "core.latency_model": ("LatencyModel",),
    "core.batch": ("BatchCaches", "Scenario", "simulate_batch", "simulate_scenario"),
    "core.workloads": ("make_resnet152", "make_gnmt", "dp_bucket_requests"),
    "core.invariants": ("InvariantViolation",),
    "topology": ("make_table2_topologies", "make_tpu_pod_topology"),
    "obs": ("Tracer", "BwTimeline"),
    "obs.tracer": ("parse_chrome_trace",),
}


def _package(root):
    ns = SimpleNamespace(root=root)
    for mod, names in _NAMES.items():
        m = importlib.import_module(f"{root}.{mod}")
        for name in names:
            setattr(ns, name, getattr(m, name))
    for mod in ("faults", "traffic", "tenancy"):
        m = importlib.import_module(f"{root}.{mod}")
        for name in m.__all__:
            setattr(ns, name, getattr(m, name))
    ns.TOPOS = ns.make_table2_topologies()
    return ns


REF, PORT = _package("repro"), _package("repro_torch")


def plain(x):
    """``x`` as plain Python values, whichever package made it."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(plain(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    return x


def assert_same(got, want):
    """The port's ``SimResult`` equals the reference's, field for field."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    assert [n for n in names if plain(getattr(got, n)) != plain(getattr(want, n))] == []


def schedules(groups):
    """The chunk schedules of chunk groups, or of one group's chunks."""
    return [c.schedule if hasattr(c, "schedule") else [x.schedule for x in c]
            for c in groups]


def same_run(make):
    """Run ``make(ns)`` for both packages and hold the port's result to the
    reference's: a ``SimResult`` field for field, a ``(SimResult, groups)``
    pair also on its chunk schedules. Returns the port's output."""
    want, got = make(REF), make(PORT)
    if isinstance(want, tuple):
        assert_same(got[0], want[0])
        assert schedules(got[1]) == schedules(want[1])
    else:
        assert_same(got, want)
    return got


def raises_alike(make, exc=ValueError):
    """``make(ns)`` raises ``exc`` with the same message in both packages."""
    msgs = []
    for ns in (REF, PORT):
        with pytest.raises(exc) as err:
            make(ns)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def study(name):
    """``benchmarks/<name>.py``, the reference's study."""
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(str(ROOT))

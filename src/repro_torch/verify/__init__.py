"""Formal verification of fabric-arbiter scheduling (ROADMAP: SMT item).

Layout:

  * :mod:`repro_torch.verify.smt` — a small typed expression AST with two
    backends: a pure-Python evaluator (always available) and an optional
    z3 lowering (used when ``z3-solver`` is installed, e.g. in CI).
  * :mod:`repro_torch.verify.encode` — encodes a small fabric instance (2-3
    tenants, 2 dims, a few chunks, one arbiter discipline) as constraints
    over service start/finish/virtual-time variables mirroring the
    engines' semantics, with the real engine's trace as the witness.
  * :mod:`repro_torch.verify.properties` — the theorems: starvation-freedom,
    bounded slowdown, bytes-conservation, no-lost-chunks, and
    work-conservation.
  * :mod:`repro_torch.verify.harness` — proves/refutes each property per
    instance over the instance's free-variable grid, extracts
    counterexamples as concrete :class:`CollectiveRequest` streams, and
    replays them through ``simulate_requests`` on both engines.

The port's copy of ``repro/verify``, imports aside: plain Python, as the
reference is.  Its :class:`TraceRecorder` subclasses the port's
``FabricArbiter``, so the port's indexed engine takes it (an arbiter of
another package would run on the reference engine, and a counterexample
replay would compare that engine with itself).
"""
from repro_torch.verify.encode import (  # noqa: F401
    FabricInstance,
    Encoding,
    FreeVar,
    TraceRecorder,
    encode_assignment,
    validate_encoding,
)
from repro_torch.verify.harness import (  # noqa: F401
    PropertyVerdict,
    decide_property,
    default_instances,
    replay_counterexample,
    verify_suite,
)
from repro_torch.verify.properties import ALL_PROPERTIES, Property  # noqa: F401
from repro_torch.verify.smt import Expr, Var, solve_encoding, z3_available  # noqa: F401

"""Tiny SMT expression layer with a native evaluator and a z3 lowering.

The verify subsystem states engine semantics and fairness theorems as
expressions over named real variables (service starts/finishes, virtual
times, completion times).  Two decision backends share the one AST:

  * ``evaluate(expr, env)`` — ground evaluation under a witness
    environment.  The constraint systems :mod:`repro_torch.verify.encode` emits
    are *functionally determined* (every variable is pinned by an
    equality chain rooted in instance constants), so checking the witness
    is a complete decision procedure for them — provided the witness
    satisfies every constraint, which :func:`validate_encoding` asserts.
    This backend is always available; the container need not ship z3.
  * ``to_z3(expr)`` — compositional lowering to z3 reals, used when
    ``z3-solver`` is importable (CI installs it via requirements-dev).
    There the solver proves ``constraints => property`` outright instead
    of trusting functional determinism: ``solve_encoding`` asserts the
    constraint conjunction plus the property's negation and reads
    UNSAT as "proved".

Only the operations the encoder needs exist: +, -, *, /, comparisons,
And/Or/Not/Implies, Max/Min/Abs, and boolean/real constants.  Floats are
compared exactly in ``==`` expressions on purpose — the encoder only
emits equalities between values produced by the *same* float computation
(see the tolerance notes in :mod:`repro_torch.core.invariants` for why looser
comparisons would hide accounting bugs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping


class Expr:
    """Base expression node.  Operator overloads build the tree."""

    def __add__(self, other): return BinOp("+", self, wrap(other))
    def __radd__(self, other): return BinOp("+", wrap(other), self)
    def __sub__(self, other): return BinOp("-", self, wrap(other))
    def __rsub__(self, other): return BinOp("-", wrap(other), self)
    def __mul__(self, other): return BinOp("*", self, wrap(other))
    def __rmul__(self, other): return BinOp("*", wrap(other), self)
    def __truediv__(self, other): return BinOp("/", self, wrap(other))
    def __le__(self, other): return Cmp("<=", self, wrap(other))
    def __lt__(self, other): return Cmp("<", self, wrap(other))
    def __ge__(self, other): return Cmp("<=", wrap(other), self)
    def __gt__(self, other): return Cmp("<", wrap(other), self)

    def eq(self, other) -> "Expr":
        return Cmp("==", self, wrap(other))


@dataclass(frozen=True)
class Const(Expr):
    value: float

    def __repr__(self):
        return f"{self.value:g}"


@dataclass(frozen=True)
class BoolConst(Expr):
    value: bool

    def __repr__(self):
        return str(self.value)


@dataclass(frozen=True)
class Var(Expr):
    """A named real variable (e.g. ``S[0][3]``, a service start)."""

    name: str

    def __repr__(self):
        return self.name


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr

    def __repr__(self):
        return f"({self.a!r} {self.op} {self.b!r})"


@dataclass(frozen=True)
class Cmp(Expr):
    op: str
    a: Expr
    b: Expr

    def __repr__(self):
        return f"({self.a!r} {self.op} {self.b!r})"


@dataclass(frozen=True)
class NaryBool(Expr):
    op: str  # "and" | "or"
    args: tuple

    def __repr__(self):
        sep = f" {self.op} "
        return "(" + sep.join(repr(a) for a in self.args) + ")"


@dataclass(frozen=True)
class Not(Expr):
    a: Expr

    def __repr__(self):
        return f"(not {self.a!r})"


@dataclass(frozen=True)
class NaryReal(Expr):
    op: str  # "max" | "min"
    args: tuple

    def __repr__(self):
        return f"{self.op}({', '.join(repr(a) for a in self.args)})"


@dataclass(frozen=True)
class Abs(Expr):
    a: Expr

    def __repr__(self):
        return f"|{self.a!r}|"


def wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return BoolConst(v)
    return Const(float(v))


def And(*args) -> Expr:
    return NaryBool("and", tuple(wrap(a) for a in args))


def Or(*args) -> Expr:
    return NaryBool("or", tuple(wrap(a) for a in args))


def Implies(a, b) -> Expr:
    return Or(Not(wrap(a)), wrap(b))


def Max(*args) -> Expr:
    return NaryReal("max", tuple(wrap(a) for a in args))


def Min(*args) -> Expr:
    return NaryReal("min", tuple(wrap(a) for a in args))


def Sum(args) -> Expr:
    out: Expr = Const(0.0)
    for a in args:
        out = out + wrap(a)
    return out


# ---------------------------------------------------------------------------
# Backend 1: native evaluation under a witness environment.
# ---------------------------------------------------------------------------
def evaluate(expr: Expr, env: Mapping[str, float]):
    """Ground-evaluate ``expr`` with every Var bound by ``env``."""
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, BoolConst):
        return expr.value
    if isinstance(expr, Var):
        return env[expr.name]
    if isinstance(expr, BinOp):
        a, b = evaluate(expr.a, env), evaluate(expr.b, env)
        if expr.op == "+":
            return a + b
        if expr.op == "-":
            return a - b
        if expr.op == "*":
            return a * b
        return a / b
    if isinstance(expr, Cmp):
        a, b = evaluate(expr.a, env), evaluate(expr.b, env)
        if expr.op == "<=":
            return a <= b
        if expr.op == "<":
            return a < b
        return a == b  # lint: allow — exact by design, see module docstring
    if isinstance(expr, NaryBool):
        vals = (evaluate(a, env) for a in expr.args)
        return all(vals) if expr.op == "and" else any(vals)
    if isinstance(expr, Not):
        return not evaluate(expr.a, env)
    if isinstance(expr, NaryReal):
        vals = [evaluate(a, env) for a in expr.args]
        return max(vals) if expr.op == "max" else min(vals)
    if isinstance(expr, Abs):
        return abs(evaluate(expr.a, env))
    raise TypeError(f"cannot evaluate {type(expr).__name__}")


def free_vars(expr: Expr, out: set | None = None) -> set:
    """The set of Var names referenced by ``expr``."""
    if out is None:
        out = set()
    if isinstance(expr, Var):
        out.add(expr.name)
    elif isinstance(expr, (BinOp, Cmp)):
        free_vars(expr.a, out)
        free_vars(expr.b, out)
    elif isinstance(expr, (NaryBool, NaryReal)):
        for a in expr.args:
            free_vars(a, out)
    elif isinstance(expr, (Not, Abs)):
        free_vars(expr.a, out)
    return out


# ---------------------------------------------------------------------------
# Backend 2: optional z3 lowering.
# ---------------------------------------------------------------------------
def z3_available() -> bool:
    try:
        import z3  # noqa: F401
        return True
    except ImportError:
        return False


def to_z3(expr: Expr, cache: dict):
    """Lower ``expr`` to a z3 expression; ``cache`` maps Var name -> z3
    Real (shared across constraints so variables unify)."""
    import z3

    if isinstance(expr, Const):
        return z3.RealVal(expr.value)
    if isinstance(expr, BoolConst):
        return z3.BoolVal(expr.value)
    if isinstance(expr, Var):
        v = cache.get(expr.name)
        if v is None:
            v = cache[expr.name] = z3.Real(expr.name)
        return v
    if isinstance(expr, BinOp):
        a, b = to_z3(expr.a, cache), to_z3(expr.b, cache)
        if expr.op == "+":
            return a + b
        if expr.op == "-":
            return a - b
        if expr.op == "*":
            return a * b
        return a / b
    if isinstance(expr, Cmp):
        a, b = to_z3(expr.a, cache), to_z3(expr.b, cache)
        if expr.op == "<=":
            return a <= b
        if expr.op == "<":
            return a < b
        return a == b
    if isinstance(expr, NaryBool):
        args = [to_z3(a, cache) for a in expr.args]
        return z3.And(*args) if expr.op == "and" else z3.Or(*args)
    if isinstance(expr, Not):
        return z3.Not(to_z3(expr.a, cache))
    if isinstance(expr, NaryReal):
        args = [to_z3(a, cache) for a in expr.args]
        out = args[0]
        for a in args[1:]:
            out = z3.If(a > out, a, out) if expr.op == "max" \
                else z3.If(a < out, a, out)
        return out
    if isinstance(expr, Abs):
        a = to_z3(expr.a, cache)
        return z3.If(a < 0, -a, a)
    raise TypeError(f"cannot lower {type(expr).__name__}")


def solve_encoding(constraints, prop: Expr, env: Mapping[str, float],
                   backend: str = "auto",
                   tol: float = 1e-6) -> tuple[bool, str]:
    """Decide whether ``constraints => prop``.

    Returns ``(holds, backend_used)``.

    * ``"native"`` — evaluate ``prop`` under the witness ``env`` (complete
      for functionally-determined systems; the caller must have validated
      the witness against the constraints first).
    * ``"z3"`` — assert the constraint conjunction (floats become exact
      rationals) plus ``Not(prop)``; UNSAT means proved.  Because z3
      re-derives the reals exactly while the witness carries float
      rounding, equalities are slackened to ``|a - b| <= tol`` before
      lowering — the engines' own float drift must not refute a theorem.
    * ``"auto"`` — z3 when importable, else native.
    """
    if backend == "auto":
        backend = "z3" if z3_available() else "native"
    if backend == "native":
        return bool(evaluate(prop, env)), "native"
    import z3

    cache: dict = {}

    def slacken(e: Expr) -> Expr:
        if isinstance(e, Cmp) and e.op == "==":
            return Abs(e.a - e.b) <= Const(tol)
        if isinstance(e, Cmp) and e.op == "<":
            # strict comparisons on witness floats: give tol of slack too
            return Cmp("<", e.a, e.b + Const(tol))
        if isinstance(e, Cmp) and e.op == "<=":
            return Cmp("<=", e.a, e.b + Const(tol))
        if isinstance(e, NaryBool):
            return NaryBool(e.op, tuple(slacken(a) for a in e.args))
        if isinstance(e, Not):
            return Not(slacken(e.a))
        return e

    s = z3.Solver()
    s.set("timeout", 30_000)
    for c in constraints:
        s.add(to_z3(slacken(c), cache))
    # Pin any variable the constraints leave free (instance constants that
    # only the property mentions) to its witness value.
    pinned = free_vars(prop) - set().union(
        *(free_vars(c) for c in constraints)) if constraints else free_vars(prop)
    for name in sorted(pinned):
        s.add(to_z3(Var(name), cache) == z3.RealVal(env[name]))
    s.add(z3.Not(to_z3(slacken(prop), cache)))
    res = s.check()
    if res == z3.unsat:
        return True, "z3"
    if res == z3.sat:
        return False, "z3"
    # timeout/unknown: fall back to the witness decision
    return bool(evaluate(prop, env)), "native"

"""Fingerprintable column expressions for logical plans.

Table.select() takes an opaque Python lambda — fine for eager execution,
useless for a *plan*: a lambda cannot be fingerprinted (the durable
journal and the serve result cache key runs by content), compared for
CSE, or asked which columns it reads (column pruning needs the exact
read set).  This module is the lazy twin: a tiny expression tree
(``col``/``lit`` + arithmetic/comparison/logical operators) whose

- ``spec()`` is a canonical primitive tuple (feeds
  :func:`cylon_tpu_torch.durable.run_fingerprint` unchanged),
- ``columns()`` is the exact read set (drives the optimizer's pruning),
- ``evaluate(env)`` lowers onto the SAME kernels the eager compute layer
  uses (``cylon_tpu_torch.compute._col_math`` / ``_col_compare``), so a
  planned filter/derive is bit-identical to its eager counterpart.

Null semantics follow the compute layer: arithmetic propagates validity
conjunction (division additionally invalidates zero divisors), and a
filter keeps a row only when the predicate is True AND valid — the
pandas behavior (NaN comparisons are False).

The port of ``cylon_tpu/plan/expr.py`` on torch.  Scalars promote as the
compute layer promotes them (the reference's x64 weak types: a Python
int keeps an integer column's dtype, a Python float keeps a float
column's and turns an integer column into float64); a literal that must
stand as a column (``lit / col``, a bool operand of ``&``/``|``) is
int32, float32 or bool, as the reference materializes it, and then
promotes with the column as torch does (int32 with float32 gives
float32, as in the reference).
"""
from __future__ import annotations

from typing import Dict, Set, Tuple, Union

import numpy as np
import torch

from ..column import Column
from ..status import Code, CylonError

Scalar = Union[bool, int, float, str]

_CMP = ("eq", "ne", "lt", "gt", "le", "ge")
_MATH = ("add", "sub", "mul", "truediv")
_LOGICAL = ("and", "or")
_FLIP = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le",
         "eq": "eq", "ne": "ne"}


class Expr:
    """Base class: operator overloads build the tree."""

    # -- tree protocol --------------------------------------------------
    def spec(self) -> tuple:
        raise NotImplementedError

    def columns(self) -> Set[str]:
        raise NotImplementedError

    def evaluate(self, env: Dict[str, Column]) -> Column:
        raise NotImplementedError

    # -- operator surface ----------------------------------------------
    def _bin(self, op: str, other, flipped: bool = False) -> "Expr":
        other = _as_expr(other)
        left, right = (other, self) if flipped else (self, other)
        if isinstance(left, Lit) and isinstance(right, Lit):
            return _fold(op, left, right)  # constant-fold on the host
        return Bin(op, left, right)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, flipped=True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, flipped=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, flipped=True)

    def __truediv__(self, o):
        return self._bin("truediv", o)

    def __rtruediv__(self, o):
        return self._bin("truediv", o, flipped=True)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("ne", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __invert__(self):
        return Not(self)

    def __neg__(self):
        return Neg(self)

    # == builds a comparison node, so identity must carry hashing
    __hash__ = object.__hash__

    def __bool__(self):
        raise CylonError(
            Code.Invalid,
            "a plan expression has no truth value; combine predicates "
            "with & / | / ~, not `and`/`or`/`not`")

    def __repr__(self) -> str:
        return f"Expr[{render(self)}]"


class Col(Expr):
    def __init__(self, name: str):
        self.name = str(name)

    def spec(self) -> tuple:
        return ("col", self.name)

    def columns(self) -> Set[str]:
        return {self.name}

    def evaluate(self, env: Dict[str, Column]) -> Column:
        if self.name not in env:
            raise CylonError(Code.KeyError,
                             f"expression references unknown column "
                             f"{self.name!r} (have {sorted(env)})")
        return env[self.name]


class Lit(Expr):
    def __init__(self, value: Scalar):
        if not isinstance(value, (bool, int, float, str, np.generic)):
            raise CylonError(Code.Invalid,
                             f"literal must be a scalar, got {type(value)}")
        self.value = value.item() if isinstance(value, np.generic) else value

    def spec(self) -> tuple:
        return ("lit", type(self.value).__name__, self.value)

    def columns(self) -> Set[str]:
        return set()

    def evaluate(self, env: Dict[str, Column]) -> Column:
        # a bare literal never evaluates standalone: Bin special-cases
        # literal operands into the compute layer's scalar paths
        raise CylonError(Code.Invalid,
                         "a bare literal is not a column expression")


class Bin(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in _CMP + _MATH + _LOGICAL, op
        self.op = op
        self.left = left
        self.right = right

    def spec(self) -> tuple:
        return ("bin", self.op, self.left.spec(), self.right.spec())

    def columns(self) -> Set[str]:
        return self.left.columns() | self.right.columns()

    def evaluate(self, env: Dict[str, Column]) -> Column:
        from .. import compute as compute_mod

        op = self.op
        lv, rv = self.left, self.right
        if isinstance(lv, Lit) and isinstance(rv, Lit):
            raise CylonError(Code.Invalid,
                             "literal-only expression; fold it on the host")
        # scalar fast paths mirror the eager compute layer exactly
        if isinstance(rv, Lit):
            lc = lv.evaluate(env)
            if op in _CMP:
                return compute_mod._col_compare(lc, rv.value, op, None)
            if op in _MATH:
                return compute_mod._col_math(lc, rv.value, op, None)
        if isinstance(lv, Lit):
            rc = rv.evaluate(env)
            if op in _CMP:  # flip: lit < col  ==  col > lit
                return compute_mod._col_compare(rc, lv.value, _FLIP[op], None)
            if op in ("add", "mul"):
                return compute_mod._col_math(rc, lv.value, op, None)
            if op == "sub":  # lit - col == (-col) + lit
                return compute_mod._col_math(_neg_col(rc), lv.value, "add",
                                             None)
            if op == "truediv":  # lit / col: materialize the literal
                lc = _lit_column(lv.value, rc)
                return compute_mod._col_math(lc, None, op, rc)
        if op in _LOGICAL and isinstance(rv, Lit):
            # a literal bool operand (often the residue of constant
            # folding, e.g. `pred & (lit(1) < lit(2))`): materialize it
            # against the evaluated side instead of crashing
            lc = lv.evaluate(env)
            rc = _lit_column(bool(rv.value), lc)
        elif op in _LOGICAL and isinstance(lv, Lit):
            rc = rv.evaluate(env)
            lc = _lit_column(bool(lv.value), rc)
        else:
            lc = lv.evaluate(env)
            rc = rv.evaluate(env)
        if op in _CMP:
            return compute_mod._col_compare(lc, None, op, rc)
        if op in _MATH:
            return compute_mod._col_math(lc, None, op, rc)
        # logical: both sides must be boolean columns
        from .. import dtypes

        if lc.data.dtype != torch.bool or rc.data.dtype != torch.bool:
            raise CylonError(Code.Invalid,
                             f"logical `{op}` needs boolean operands")
        data = (lc.data & rc.data) if op == "and" else (lc.data | rc.data)
        validity = lc.validity & rc.validity
        return compute_mod._result_col(data, validity, dtypes.bool_)


class Not(Expr):
    def __init__(self, e: Expr):
        self.e = e

    def spec(self) -> tuple:
        return ("not", self.e.spec())

    def columns(self) -> Set[str]:
        return self.e.columns()

    def evaluate(self, env: Dict[str, Column]) -> Column:
        from .. import compute as compute_mod
        from .. import dtypes

        c = self.e.evaluate(env)
        if c.data.dtype != torch.bool:
            raise CylonError(Code.Invalid, "~ needs a boolean operand")
        return compute_mod._result_col(~c.data, c.validity, dtypes.bool_)


class Neg(Expr):
    def __init__(self, e: Expr):
        self.e = e

    def spec(self) -> tuple:
        return ("neg", self.e.spec())

    def columns(self) -> Set[str]:
        return self.e.columns()

    def evaluate(self, env: Dict[str, Column]) -> Column:
        return _neg_col(self.e.evaluate(env))


def _neg_col(c: Column) -> Column:
    """``-c`` with null rows zeroed (the masked negation of the
    reference)."""
    if c.is_string or c.data.dtype == torch.bool:
        raise CylonError(Code.Invalid, "negation needs a numeric column")
    data = torch.where(c.validity, -c.data,
                       torch.zeros((), dtype=c.data.dtype,
                                   device=c.data.device))
    return Column(data, c.validity, None, c.dtype)


def _lit_column(value: Scalar, like: Column) -> Column:
    """Materialize a scalar as a full column with ``like``'s capacity —
    only for the rare non-flippable literal-first forms."""
    from .. import dtypes

    if isinstance(value, str):
        raise CylonError(Code.Invalid, "string literals only compare")
    dt = (np.bool_ if isinstance(value, bool)
          else np.int32 if isinstance(value, int) else np.float32)
    cap = like.data.shape[0]
    dev = like.data.device
    data = torch.from_numpy(np.full((cap,), value, dt)).to(dev)
    return Column(data, torch.ones(cap, dtype=torch.bool, device=dev), None,
                  dtypes.from_numpy_dtype(np.dtype(dt)))


def _fold(op: str, left: "Lit", right: "Lit") -> "Lit":
    """Host-side constant folding of literal-only subtrees (e.g.
    ``lit(1.0) - lit(0.1)`` inside a derive): a Bin over two literals
    could never evaluate against columns, so it folds at construction."""
    import operator as _op

    fns = {"add": _op.add, "sub": _op.sub, "mul": _op.mul,
           "truediv": _op.truediv, "eq": _op.eq, "ne": _op.ne,
           "lt": _op.lt, "gt": _op.gt, "le": _op.le, "ge": _op.ge,
           "and": lambda a, b: bool(a) and bool(b),
           "or": lambda a, b: bool(a) or bool(b)}
    try:
        return Lit(fns[op](left.value, right.value))
    except Exception as e:
        raise CylonError(Code.Invalid,
                         f"cannot fold literal expression "
                         f"({left.value!r} {op} {right.value!r}): {e}")


def _as_expr(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Lit(v)


def col(name: str) -> Col:
    """Reference a column by name."""
    return Col(name)


def lit(value: Scalar) -> Lit:
    """A scalar literal operand."""
    return Lit(value)


def render(e: Expr) -> str:
    """Human-readable one-line rendering (plan.explain)."""
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Bin):
        sym = {"add": "+", "sub": "-", "mul": "*", "truediv": "/",
               "eq": "==", "ne": "!=", "lt": "<", "gt": ">", "le": "<=",
               "ge": ">=", "and": "&", "or": "|"}[e.op]
        return f"({render(e.left)} {sym} {render(e.right)})"
    if isinstance(e, Not):
        return f"~{render(e.e)}"
    if isinstance(e, Neg):
        return f"-{render(e.e)}"
    return repr(e)

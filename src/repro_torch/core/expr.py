"""Feature expression DAG — FeatInsight's declarative feature language.

The paper builds features from a visual DAG that compiles to SQL executed by
OpenMLDB.  Here the DAG *is* the IR: a small expression tree of row-level
operations and window aggregations that compiles (via :mod:`repro.core.engine`)
to the online store's query over device state.

Two strata:

* **row-level** expressions (``Col``, ``Lit``, arithmetic, comparisons,
  ``Hash``, ``Signature``) — evaluated pointwise over a batch of rows;
* **window aggregations** (``WindowAgg``) — evaluated per key over a ROWS
  or RANGE window ending at (and including) the current row, exactly the
  OpenMLDB ``window ... rows_range between ... and current row`` semantics.

Window aggregations may themselves feed further row-level expressions
(e.g. ``w_sum(amount, 1h) / w_count(amount, 1h)``), mirroring how FeatInsight
users chain SQL blocks.

Multi-table views (the paper's "large-scale, complex raw data" — e.g. the
2018 PHM dataset's 17 tables) add a third stratum, mirroring OpenMLDB's two
cross-table constructs:

* ``LastJoin`` — point-in-time LAST JOIN: for each primary row, the most
  recent secondary-table row with a matching key and ``ts <= row ts``;
  the joined row feeds a row-level sub-expression (``TableCol`` /
  ``Col`` references resolve against the secondary table);
* ``WindowAgg(..., union=("table", ...))`` — WINDOW UNION: the per-key
  RANGE window is evaluated over the primary stream merged by timestamp
  with the named secondary streams (OpenMLDB's ``WINDOW ... UNION``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Agg",
    "WindowSpec",
    "Expr",
    "Col",
    "TableCol",
    "Lit",
    "BinOp",
    "UnOp",
    "Hash",
    "Signature",
    "WindowAgg",
    "LastJoin",
    "last_join",
    "UNION_AGGS",
    "rows_window",
    "range_window",
    "w_sum",
    "w_count",
    "w_mean",
    "w_min",
    "w_max",
    "w_std",
    "w_first",
    "w_last",
    "w_distinct_approx",
    "w_topn_freq",
    "collect_window_aggs",
    "collect_last_joins",
    "collect_columns",
    "collect_tables",
]


class Agg(enum.Enum):
    """Window aggregation kinds (the paper's 'specialized ML functions')."""

    SUM = "sum"
    COUNT = "count"
    MEAN = "mean"
    MIN = "min"
    MAX = "max"
    STD = "std"
    FIRST = "first"
    LAST = "last"
    DISTINCT_APPROX = "distinct_approx"  # 32-bit linear counting
    TOPN_FREQ = "topn_freq"              # exact over the window tail


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """A per-key window ending at the current row (inclusive).

    mode="rows":  the last ``size`` rows of the same key.
    mode="range": rows of the same key with ``ts in (t_now - size, t_now]``.

    ``bucket`` is the pre-aggregation granularity used by the online store
    for RANGE windows; it does not change the
    result, only how it is computed.
    """

    mode: str
    size: int
    bucket: int = 0

    def __post_init__(self) -> None:
        if self.mode not in ("rows", "range"):
            raise ValueError(f"bad window mode {self.mode!r}")
        if self.size <= 0:
            raise ValueError("window size must be positive")


def rows_window(size: int) -> WindowSpec:
    return WindowSpec("rows", size)


def range_window(size: int, bucket: int = 0) -> WindowSpec:
    return WindowSpec("range", size, bucket)


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base class; supports operator overloading for row-level math."""

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: Any) -> "Expr":
        return BinOp("add", self, _wrap(o))

    def __radd__(self, o: Any) -> "Expr":
        return BinOp("add", _wrap(o), self)

    def __sub__(self, o: Any) -> "Expr":
        return BinOp("sub", self, _wrap(o))

    def __rsub__(self, o: Any) -> "Expr":
        return BinOp("sub", _wrap(o), self)

    def __mul__(self, o: Any) -> "Expr":
        return BinOp("mul", self, _wrap(o))

    def __rmul__(self, o: Any) -> "Expr":
        return BinOp("mul", _wrap(o), self)

    def __truediv__(self, o: Any) -> "Expr":
        return BinOp("div", self, _wrap(o))

    def __rtruediv__(self, o: Any) -> "Expr":
        return BinOp("div", _wrap(o), self)

    def __neg__(self) -> "Expr":
        return UnOp("neg", self)

    # -- comparisons (produce 0/1 f32 features) ------------------------------
    def __gt__(self, o: Any) -> "Expr":
        return BinOp("gt", self, _wrap(o))

    def __lt__(self, o: Any) -> "Expr":
        return BinOp("lt", self, _wrap(o))

    def __ge__(self, o: Any) -> "Expr":
        return BinOp("ge", self, _wrap(o))

    def __le__(self, o: Any) -> "Expr":
        return BinOp("le", self, _wrap(o))

    def eq(self, o: Any) -> "Expr":
        return BinOp("eq", self, _wrap(o))

    def log1p(self) -> "Expr":
        return UnOp("log1p", self)

    def abs(self) -> "Expr":
        return UnOp("abs", self)

    def clip(self, lo: float, hi: float) -> "Expr":
        return UnOp("clip", self, params=(float(lo), float(hi)))

    # -- structural ----------------------------------------------------------
    def children(self) -> Tuple["Expr", ...]:
        return ()

    @property
    def key(self) -> Tuple:
        """Hashable structural identity used for CSE / lineage."""
        raise NotImplementedError


def _wrap(v: Any) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Lit(float(v))


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    """Reference to a source-table column (lineage leaf).

    Resolves against whichever table the enclosing context evaluates over:
    the primary table for ordinary features, the joined table inside a
    :class:`LastJoin` argument, and *every* unioned table for a
    ``WindowAgg(..., union=...)`` argument (the name must exist in all of
    them — OpenMLDB's WINDOW UNION schema-compatibility rule).
    """

    name: str

    @property
    def key(self) -> Tuple:
        return ("col", self.name)


@dataclasses.dataclass(frozen=True, eq=False)
class TableCol(Expr):
    """Explicitly table-qualified column reference (lineage leaf).

    Only meaningful inside a :class:`LastJoin` argument, where it must name
    the joined table; it resolves to that table's column and records the
    qualified source in lineage.
    """

    table: str
    name: str

    @property
    def key(self) -> Tuple:
        return ("tcol", self.table, self.name)


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: float

    @property
    def key(self) -> Tuple:
        return ("lit", self.value)


def _float(x: torch.Tensor) -> torch.Tensor:
    """Integer operands promote to float32 where the reference's weakly
    typed float literals would promote them."""
    return x if x.is_floating_point() else x.to(torch.float32)


_BINOPS: Dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": lambda a, b: a / torch.where(b == 0, 1.0, _float(b)),
    "gt": lambda a, b: (a > b).to(torch.float32),
    "lt": lambda a, b: (a < b).to(torch.float32),
    "ge": lambda a, b: (a >= b).to(torch.float32),
    "le": lambda a, b: (a <= b).to(torch.float32),
    "eq": lambda a, b: (a == b).to(torch.float32),
}

_UNOPS: Dict[str, Callable] = {
    "neg": torch.neg,
    "log1p": lambda x: torch.log1p(torch.clamp(_float(x), min=0.0)),
    "abs": torch.abs,
}


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def children(self) -> Tuple[Expr, ...]:
        return (self.lhs, self.rhs)

    @property
    def key(self) -> Tuple:
        return ("bin", self.op, self.lhs.key, self.rhs.key)


@dataclasses.dataclass(frozen=True, eq=False)
class UnOp(Expr):
    op: str
    arg: Expr
    params: Tuple = ()

    def children(self) -> Tuple[Expr, ...]:
        return (self.arg,)

    @property
    def key(self) -> Tuple:
        return ("un", self.op, self.params, self.arg.key)


@dataclasses.dataclass(frozen=True, eq=False)
class Hash(Expr):
    """64-bit mix hash of a column (the signature primitive).

    Result is a non-negative int32 in [0, 2**bits).
    """

    arg: Expr
    bits: int = 20
    salt: int = 0

    def children(self) -> Tuple[Expr, ...]:
        return (self.arg,)

    @property
    def key(self) -> Tuple:
        return ("hash", self.bits, self.salt, self.arg.key)


@dataclasses.dataclass(frozen=True, eq=False)
class Signature(Expr):
    """FeatInsight feature signature: fold several columns into one hashed id.

    The paper uses signatures to label features in trillion-dimensional
    spaces (product × item crosses etc.); we fold the column values through
    k rounds of a 64-bit mixer so the cross never materializes.
    """

    args: Tuple[Expr, ...]
    bits: int = 20
    salt: int = 0

    def children(self) -> Tuple[Expr, ...]:
        return tuple(self.args)

    @property
    def key(self) -> Tuple:
        return ("sig", self.bits, self.salt, tuple(a.key for a in self.args))


# Aggregations whose union-window composition is implemented by both
# engines.  Since the unified aggregator algebra (repro.core.aggregates)
# every registered Agg is union-composable: FIRST carries an argmin-by-
# merge-order state and TOPN_FREQ a mergeable tail sketch, so per-stream
# partial states combine across WINDOW UNION streams.  (Kept as an explicit
# tuple so a future non-composable aggregate fails loudly at construction;
# tests cross-check it against the registry's union_composable flags.)
UNION_AGGS = (
    Agg.SUM, Agg.COUNT, Agg.MEAN, Agg.MIN, Agg.MAX, Agg.STD,
    Agg.DISTINCT_APPROX, Agg.LAST, Agg.FIRST, Agg.TOPN_FREQ,
)


def _contains_node(e: "Expr", types: tuple) -> bool:
    if isinstance(e, types):
        return True
    return any(_contains_node(c, types) for c in e.children())


@dataclasses.dataclass(frozen=True, eq=False)
class WindowAgg(Expr):
    """Per-key window aggregation of a row-level expression.

    ``union`` names secondary tables whose streams are merged (by timestamp)
    into the primary stream before windowing — OpenMLDB WINDOW UNION.  Union
    windows must be RANGE windows (a merged ROWS ranking is not offered by
    the online store) and ``agg`` must be in :data:`UNION_AGGS`.
    """

    agg: Agg
    arg: Expr
    window: WindowSpec
    n: int = 1  # for TOPN_FREQ: which rank (0-based) to return
    union: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "union", tuple(self.union))
        if self.union:
            if self.window.mode != "range":
                raise ValueError("WINDOW UNION requires a RANGE window")
            if self.agg not in UNION_AGGS:
                raise ValueError(
                    f"{self.agg.value} is not supported over WINDOW UNION"
                )
        if _contains_node(self.arg, (LastJoin,)):
            raise ValueError(
                "window-aggregation arguments may not contain LAST JOINs "
                "(join the value into the view first, window it separately)"
            )

    def children(self) -> Tuple[Expr, ...]:
        return (self.arg,)

    @property
    def key(self) -> Tuple:
        return (
            "wagg",
            self.agg.value,
            self.window.mode,
            self.window.size,
            self.n,
            self.union,
            self.arg.key,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class LastJoin(Expr):
    """Point-in-time LAST JOIN: evaluate ``arg`` on the most recent row of
    ``table`` whose key equals the primary row's ``on`` column and whose
    timestamp is <= the primary row's timestamp (OpenMLDB LAST JOIN with the
    ``ORDER BY ts`` + ``ts <= request ts`` point-in-time condition).

    ``default`` is returned when no secondary row matches.  ``arg`` is a
    row-level expression over the *secondary* table's columns.
    """

    arg: Expr
    table: str
    on: str
    default: float = 0.0

    def __post_init__(self) -> None:
        if _contains_node(self.arg, (WindowAgg, LastJoin)):
            raise ValueError(
                "LAST JOIN arguments must be row-level expressions over the "
                "joined table (no nested windows or joins)"
            )

        def check_tcols(e: Expr) -> None:
            if isinstance(e, TableCol) and e.table != self.table:
                raise ValueError(
                    f"TableCol({e.table!r}, {e.name!r}) inside a LAST JOIN of "
                    f"table {self.table!r}: join arguments evaluate over the "
                    "joined table only"
                )
            for c in e.children():
                check_tcols(c)

        check_tcols(self.arg)

    def children(self) -> Tuple[Expr, ...]:
        return (self.arg,)

    @property
    def key(self) -> Tuple:
        return ("ljoin", self.table, self.on, self.default, self.arg.key)


def last_join(arg: Expr, table: str, on: str, default: float = 0.0) -> LastJoin:
    """DSL constructor: ``last_join(Col("credit_limit"), "accounts", on="account")``."""
    return LastJoin(_wrap(arg), table, on, float(default))


# -- convenience constructors (the user-facing feature DSL) -------------------


def w_sum(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.SUM, arg, window, union=tuple(union))


def w_count(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.COUNT, arg, window, union=tuple(union))


def w_mean(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.MEAN, arg, window, union=tuple(union))


def w_min(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.MIN, arg, window, union=tuple(union))


def w_max(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.MAX, arg, window, union=tuple(union))


def w_std(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.STD, arg, window, union=tuple(union))


def w_first(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.FIRST, arg, window, union=tuple(union))


def w_last(arg: Expr, window: WindowSpec, union: Sequence[str] = ()) -> WindowAgg:
    return WindowAgg(Agg.LAST, arg, window, union=tuple(union))


def w_distinct_approx(
    arg: Expr, window: WindowSpec, union: Sequence[str] = ()
) -> WindowAgg:
    return WindowAgg(Agg.DISTINCT_APPROX, arg, window, union=tuple(union))


def w_topn_freq(
    arg: Expr, window: WindowSpec, n: int = 0, union: Sequence[str] = ()
) -> WindowAgg:
    """Approximate top-N frequency: value of the n-th most frequent item in
    the window tail (ties broken by value)."""
    return WindowAgg(Agg.TOPN_FREQ, arg, window, n=n, union=tuple(union))


# ---------------------------------------------------------------------------
# Tree walks
# ---------------------------------------------------------------------------


def collect_window_aggs(exprs: Sequence[Expr]) -> Dict[Tuple, WindowAgg]:
    """All distinct WindowAgg nodes, CSE'd by structural key."""
    out: Dict[Tuple, WindowAgg] = {}

    def walk(e: Expr) -> None:
        if isinstance(e, WindowAgg):
            out.setdefault(e.key, e)
            walk(e.arg)
            return
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return out


def collect_last_joins(exprs: Sequence[Expr]) -> Dict[Tuple, LastJoin]:
    """All distinct LastJoin nodes, CSE'd by structural key."""
    out: Dict[Tuple, LastJoin] = {}

    def walk(e: Expr) -> None:
        if isinstance(e, LastJoin):
            out.setdefault(e.key, e)
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return out


def collect_columns(exprs: Sequence[Expr]) -> Tuple[str, ...]:
    """All source columns referenced (lineage: feature -> raw columns).

    Columns inside a LastJoin argument (and explicit TableCol references)
    are reported table-qualified as ``"table.col"``.
    """
    cols: List[str] = []

    def add(name: str) -> None:
        if name not in cols:
            cols.append(name)

    def walk(e: Expr, table: Optional[str]) -> None:
        if isinstance(e, Col):
            add(f"{table}.{e.name}" if table else e.name)
        elif isinstance(e, TableCol):
            add(f"{e.table}.{e.name}")
        elif isinstance(e, LastJoin):
            walk(e.arg, e.table)
            return
        for c in e.children():
            walk(c, table)

    for e in exprs:
        walk(e, None)
    return tuple(cols)


def collect_tables(exprs: Sequence[Expr]) -> Tuple[str, ...]:
    """All *secondary* tables referenced (LAST JOIN and WINDOW UNION)."""
    tables: List[str] = []

    def add(name: str) -> None:
        if name not in tables:
            tables.append(name)

    def walk(e: Expr) -> None:
        if isinstance(e, LastJoin):
            add(e.table)
        elif isinstance(e, TableCol):
            add(e.table)
        elif isinstance(e, WindowAgg):
            for t in e.union:
                add(t)
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return tuple(tables)


# ---------------------------------------------------------------------------
# Row-level evaluation
# ---------------------------------------------------------------------------


def eval_rowlevel(
    expr: Expr,
    columns: Dict[str, torch.Tensor],
    wagg_values: Dict[Tuple, torch.Tensor],
) -> torch.Tensor:
    """Evaluate ``expr`` pointwise.

    ``columns`` maps column name -> (N,) tensor (canonical dtypes, see
    :func:`repro_torch.as_tensor`); ``wagg_values`` maps a WindowAgg *or
    LastJoin* structural key -> already-computed (N,) result.
    WindowAgg/LastJoin nodes MUST appear in ``wagg_values``.
    """
    from repro_torch.core.hashing import mix64  # local import to avoid cycle

    device = next(
        (v.device for v in list(columns.values()) + list(wagg_values.values())
         if isinstance(v, torch.Tensor)),
        None,
    )

    def ev(e: Expr) -> torch.Tensor:
        if isinstance(e, (WindowAgg, LastJoin)):
            return wagg_values[e.key]
        if isinstance(e, Col):
            if e.name not in columns:
                raise KeyError(f"unknown column {e.name!r}")
            return columns[e.name]
        if isinstance(e, TableCol):
            if e.name not in columns:
                raise KeyError(
                    f"unknown column {e.table}.{e.name} in current table"
                )
            return columns[e.name]
        if isinstance(e, Lit):
            return torch.tensor(e.value, dtype=torch.float32, device=device)
        if isinstance(e, BinOp):
            return _BINOPS[e.op](ev(e.lhs), ev(e.rhs))
        if isinstance(e, UnOp):
            if e.op == "clip":
                lo, hi = e.params
                return torch.clamp(_float(ev(e.arg)), lo, hi)
            return _UNOPS[e.op](ev(e.arg))
        if isinstance(e, Hash):
            v = ev(e.arg)
            return mix64(v, salt=e.salt, bits=e.bits).to(torch.float32)
        if isinstance(e, Signature):
            acc = None
            for i, a in enumerate(e.args):
                h = mix64(ev(a), salt=e.salt + 0x9E37 * (i + 1), bits=32)
                acc = h if acc is None else mix64(
                    acc * 31 + h, salt=e.salt, bits=32
                )
            assert acc is not None
            return (acc % (2 ** e.bits)).to(torch.float32)
        raise TypeError(f"unknown expr node {type(e)}")

    return ev(expr)

"""Feature views, lineage, versioning — FeatInsight's management layer.

Paper §2 "Feature View Management": a *feature view* groups features defined
by a single computation statement; lineage links each feature to its view,
database (here: table schema), and defining expression; earlier versions of
deployed services are cached so users can reuse prior definitions and
"incrementally add new raw data attributes".

The visual DAG of the paper is literally the :mod:`repro_torch.core.expr` tree; a
view's "SQL" rendering is produced by :func:`render_sql` for lineage display
(and to honor the demo's SQL-centric UX in a headless way).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.expr import (
    Agg,
    BinOp,
    Col,
    Expr,
    Hash,
    LastJoin,
    Lit,
    Signature,
    TableCol,
    UnOp,
    WindowAgg,
    collect_columns,
    collect_last_joins,
    collect_tables,
    collect_window_aggs,
)
from repro_torch.core.storage import Database, TableSchema

__all__ = ["FeatureView", "FeatureRegistry", "render_sql"]


def render_sql(
    name: str,
    expr: Expr,
    schema: TableSchema,
    database: Optional[Database] = None,
) -> str:
    """Render one feature's defining expression as OpenMLDB-flavoured SQL.

    Multi-table features render OpenMLDB's two cross-table clauses: LAST
    JOINs appear as a ``FROM ... LAST JOIN ... ORDER BY ... ON ...`` clause
    (with the joined expression's columns table-qualified), and union
    windows carry the ``UNION table`` prefix inside ``OVER (...)``.
    """

    def r(e: Expr, table: Optional[str] = None) -> str:
        if isinstance(e, Col):
            return f"{table}.{e.name}" if table else e.name
        if isinstance(e, TableCol):
            return f"{e.table}.{e.name}"
        if isinstance(e, Lit):
            return repr(e.value)
        if isinstance(e, BinOp):
            sym = {
                "add": "+", "sub": "-", "mul": "*", "div": "/",
                "gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "=",
            }[e.op]
            return f"({r(e.lhs, table)} {sym} {r(e.rhs, table)})"
        if isinstance(e, UnOp):
            if e.op == "clip":
                lo, hi = e.params
                return f"clip({r(e.arg, table)}, {lo}, {hi})"
            return f"{e.op}({r(e.arg, table)})"
        if isinstance(e, Hash):
            return f"hash{e.bits}({r(e.arg, table)})"
        if isinstance(e, Signature):
            args = ", ".join(r(a, table) for a in e.args)
            return f"signature{e.bits}({args})"
        if isinstance(e, LastJoin):
            return r(e.arg, e.table)
        if isinstance(e, WindowAgg):
            w = e.window
            bound = (
                f"{w.size} PRECEDING"
                if w.mode == "range"
                else f"{w.size - 1} ROWS PRECEDING"
            )
            fn = e.agg.value
            if e.agg == Agg.TOPN_FREQ:
                fn = f"top{e.n + 1}_freq"
            union = "".join(f"UNION {t} " for t in e.union)
            return (
                f"{fn}({r(e.arg, table)}) OVER ({union}PARTITION BY "
                f"{schema.key} ORDER BY {schema.ts} "
                f"RANGE BETWEEN {bound} AND CURRENT ROW)"
            )
        raise TypeError(type(e))

    sql = f"SELECT {r(expr)} AS {name}"
    joins = collect_last_joins([expr])
    if joins:
        clauses = [f"FROM {schema.name}"]
        seen = set()
        for lj in joins.values():
            if (lj.table, lj.on) in seen:
                continue
            seen.add((lj.table, lj.on))
            jkey = (
                database.table(lj.table).key if database is not None else "key"
            )
            jts = (
                database.table(lj.table).ts if database is not None else "ts"
            )
            clauses.append(
                f"LAST JOIN {lj.table} ORDER BY {lj.table}.{jts} ON "
                f"{schema.name}.{lj.on} = {lj.table}.{jkey} AND "
                f"{lj.table}.{jts} <= {schema.name}.{schema.ts}"
            )
        sql += " " + " ".join(clauses)
    return sql


def _reject_stray_tablecols(e: Expr, fname: str) -> None:
    """Raise if a TableCol appears outside a LastJoin argument."""
    if isinstance(e, TableCol):
        raise ValueError(
            f"feature {fname!r}: TableCol({e.table!r}, {e.name!r}) outside a "
            "LAST JOIN argument — qualified columns only resolve inside "
            "last_join(...)"
        )
    if isinstance(e, LastJoin):
        return  # LastJoin.__post_init__ already validated its subtree
    for c in e.children():
        _reject_stray_tablecols(c, fname)


@dataclasses.dataclass
class FeatureView:
    """A named, versioned set of features over one table schema — or, when
    ``database`` is given, over a primary table plus secondary tables
    (point-in-time LAST JOINs and WINDOW UNION streams).

    ``schema`` remains the primary table's schema in both cases; for
    single-table views a one-table :class:`Database` is synthesized so every
    consumer can treat views uniformly.
    """

    name: str
    schema: Optional[TableSchema] = None
    features: Dict[str, Expr] = dataclasses.field(default_factory=dict)
    version: int = 1
    description: str = ""
    database: Optional[Database] = None

    def __post_init__(self) -> None:
        if self.schema is None and self.database is None:
            raise ValueError("FeatureView needs a schema or a database")
        if self.database is None:
            self.database = Database(
                name=self.schema.name, primary=self.schema
            )
        if self.schema is None:
            self.schema = self.database.primary
        if self.schema != self.database.primary:
            raise ValueError(
                f"schema {self.schema.name!r} must equal the database's "
                f"primary table {self.database.primary.name!r}"
            )
        # every referenced table must be a *secondary* table of the database:
        # a LAST JOIN / WINDOW UNION naming the primary table would be
        # silently unanswerable online (primary rows never reach a secondary
        # ring), so reject it here rather than diverge at serve time
        for t in collect_tables(list(self.features.values())):
            self.database.table(t)
            if not self.database.is_secondary(t):
                raise ValueError(
                    f"LAST JOIN / WINDOW UNION over the primary table "
                    f"{t!r} is not supported; register a secondary table"
                )
        # TableCol is only resolvable inside a LAST JOIN argument (it has no
        # table context elsewhere and would silently read the primary table)
        for fname, expr in self.features.items():
            _reject_stray_tablecols(expr, fname)

    @property
    def tables(self) -> List[str]:
        """All source tables actually referenced (primary first)."""
        return [self.schema.name] + list(
            collect_tables(list(self.features.values()))
        )

    def lineage(self) -> Dict[str, Dict]:
        """feature -> {view, version, source tables/columns, windows, joins, sql}."""
        out = {}
        for fname, expr in self.features.items():
            waggs = collect_window_aggs([expr])
            joins = collect_last_joins([expr])
            out[fname] = {
                "view": self.name,
                "version": self.version,
                "table": self.schema.name,
                "tables": [self.schema.name] + list(collect_tables([expr])),
                "columns": list(collect_columns([expr])),
                "windows": [
                    {
                        "agg": w.agg.value,
                        "mode": w.window.mode,
                        "size": w.window.size,
                        "union": list(w.union),
                    }
                    for w in waggs.values()
                ],
                "joins": [
                    {"table": j.table, "on": j.on, "default": j.default}
                    for j in joins.values()
                ],
                "sql": render_sql(fname, expr, self.schema, self.database),
            }
        return out

    def describe(self, registry: Optional["FeatureRegistry"] = None) -> str:
        """Markdown catalog entry for this view — the docs layer's unit.

        Renders what a feature-store catalog page must answer: which
        source tables feed the view (and in what role), what each output
        column computes (window/agg lineage + the OpenMLDB-flavoured SQL),
        and — when a ``registry`` is passed — which services deploy it.
        Deterministic output (no wall-clock times), so the generated
        ``docs/CATALOG.md`` can be CI-gated by regenerate-and-diff.
        """
        exprs = list(self.features.values())
        joins = collect_last_joins(exprs)
        waggs = collect_window_aggs(exprs)
        join_tables = {lj.table for lj in joins.values()}
        union_tables = set()
        for wa in waggs.values():
            union_tables.update(wa.union)

        def role(t: str) -> str:
            r = []
            if t in join_tables:
                r.append("LAST JOIN target")
            if t in union_tables:
                r.append("WINDOW UNION stream")
            return " + ".join(r) or "unreferenced"

        lines = [f"### `{self.name}` (v{self.version})", ""]
        if self.description:
            lines += [self.description, ""]
        lines += [
            "**Source tables**",
            "",
            "| table | role | key | ts | columns |",
            "|---|---|---|---|---|",
        ]
        prim = self.schema
        lines.append(
            f"| `{prim.name}` | primary | `{prim.key}` | `{prim.ts}` | "
            f"{', '.join(f'`{c}`' for c in prim.columns)} |"
        )
        for t in collect_tables(exprs):
            sch = self.database.table(t)
            lines.append(
                f"| `{sch.name}` | {role(t)} | `{sch.key}` | `{sch.ts}` | "
                f"{', '.join(f'`{c}`' for c in sch.columns)} |"
            )
        lines += ["", "**Features**", ""]
        for fname, rec in self.lineage().items():
            parts = []
            for w in rec["windows"]:
                u = (
                    f" UNION {'+'.join(w['union'])}" if w["union"] else ""
                )
                parts.append(
                    f"{w['agg']} over {w['size']} "
                    f"{'rows' if w['mode'] == 'rows' else 's RANGE'}{u}"
                )
            for j in rec["joins"]:
                parts.append(
                    f"LAST JOIN `{j['table']}` on `{j['on']}` "
                    f"(default {j['default']})"
                )
            kind = "; ".join(parts) or "row-level"
            cols = ", ".join(f"`{c}`" for c in rec["columns"]) or "—"
            lines += [
                f"- **`{fname}`** — {kind}; inputs: {cols}",
                "",
                "  ```sql",
                f"  {rec['sql']}",
                "  ```",
                "",
            ]
        if registry is not None:
            deps = registry.deployments(self.name)
            if deps:
                lines += ["**Deploy history**", ""]
                for d in deps:
                    extra = (
                        f" — {d['description']}" if d.get("description") else ""
                    )
                    lines.append(
                        f"- service `{d['service']}` ← `{d['view']}` "
                        f"v{d['version']} "
                        f"({len(d['features'])} features, "
                        f"{len(d['tables'])} tables){extra}"
                    )
                lines.append("")
        return "\n".join(lines)

    def evolve(self, new_features: Dict[str, Expr], description: str = "") -> "FeatureView":
        """Incremental redefinition: prior features are kept, new/overridden
        ones merged, version bumped (the paper's cached-version reuse)."""
        merged = dict(self.features)
        merged.update(new_features)
        return FeatureView(
            name=self.name,
            schema=self.schema,
            features=merged,
            version=self.version + 1,
            description=description or self.description,
            database=self.database,
        )


class FeatureRegistry:
    """All views + version history + deployed services (the metadata plane).

    The paper persists this in the Sage-Studio control plane; here it is an
    in-process registry with JSON export so the launcher/checkpointer can
    persist it alongside model state.

    ``clock`` is injectable — an ``repro_torch.obs.Clock`` (its wall ``time()``
    is used), or a legacy bare callable returning epoch seconds — so
    deploy-history ordering and timestamps are deterministic under
    test/replay.  Real callers omit it and the registry follows the
    *plane* clock, ``repro_torch.obs.get_telemetry().clock``, resolved lazily at
    each stamp: installing one ``FakeClock`` via ``use_telemetry`` drives
    the registry, every ``BatchScheduler``, and every span together.
    """

    def __init__(self, clock=None) -> None:
        self._views: Dict[Tuple[str, int], FeatureView] = {}
        self._latest: Dict[str, int] = {}
        self._services: Dict[str, Dict] = {}
        self._events: List[Dict] = []
        self._clock_src = clock

    def _clock(self) -> float:
        """Wall-epoch stamp from whichever clock governs this registry."""
        src = self._clock_src
        if src is None:
            from repro_torch.obs import get_telemetry

            return get_telemetry().clock.time()
        if hasattr(src, "time"):
            return src.time()       # an obs.Clock (or compatible)
        return src()                # legacy bare callable

    # -- views ---------------------------------------------------------------

    def register(self, view: FeatureView) -> FeatureView:
        key = (view.name, view.version)
        if key in self._views:
            raise ValueError(f"view {key} already registered")
        self._views[key] = view
        self._latest[view.name] = max(
            self._latest.get(view.name, 0), view.version
        )
        self._log("register_view", view=view.name, version=view.version)
        return view

    def get(self, name: str, version: Optional[int] = None) -> FeatureView:
        v = version if version is not None else self._latest[name]
        return self._views[(name, v)]

    def versions(self, name: str) -> List[int]:
        return sorted(v for (n, v) in self._views if n == name)

    def lineage(self, name: str, feature: str, version: Optional[int] = None) -> Dict:
        return self.get(name, version).lineage()[feature]

    # -- services (deployments) ------------------------------------------------

    def deploy(
        self, service: str, view_name: str, version: Optional[int] = None,
        description: str = "",
    ) -> Dict:
        view = self.get(view_name, version)
        now = self._clock()
        rec = {
            "service": service,
            "view": view.name,
            "version": view.version,
            "features": list(view.features),
            "tables": view.tables,
            "description": description,
            "deployed_at": now,
        }
        self._services[service] = rec
        self._log(
            "deploy", t=now,
            **{k: rec[k] for k in ("service", "view", "version")},
        )
        return rec

    def service(self, name: str) -> Dict:
        return self._services[name]

    def deployments(self, view_name: Optional[str] = None) -> List[Dict]:
        """Deploy records (optionally for one view), in deploy order."""
        return [
            rec
            for rec in self._services.values()
            if view_name is None or rec["view"] == view_name
        ]

    # -- bookkeeping --------------------------------------------------------------

    def _log(self, kind: str, t: Optional[float] = None, **kw) -> None:
        self._events.append(
            {"kind": kind, "t": self._clock() if t is None else t, **kw}
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "views": [
                    {
                        "name": v.name,
                        "version": v.version,
                        "table": v.schema.name,
                        "tables": v.tables,
                        "features": {
                            f: render_sql(f, e, v.schema, v.database)
                            for f, e in v.features.items()
                        },
                    }
                    for v in self._views.values()
                ],
                "services": self._services,
            },
            indent=2,
            default=str,
        )

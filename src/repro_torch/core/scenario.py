"""Multi-scenario serving plane — N feature views, one store.

FeatInsight's headline claim is breadth: 100+ real-world scenarios served
from one platform, each with its own feature views but sharing storage and
compute.  :class:`ScenarioPlane` is that consolidation layer:

* **One plan.**  The plane asks the layout planner
  (:func:`~repro_torch.core.layout.plan_layout`) for a single *evolvable*
  :class:`~repro_torch.core.layout.StoreLayout` over all its views
  (``raw_lanes=True``: every raw column is a lane from day one).  The plan
  decides lane slots, per-(table, shard) rings and placement (partitioned
  vs replicated vs split dual-use tables); the store consumes it.
* **One state.**  The views are merged into one internal view whose lane
  plan is the union of every view's window arguments and whose secondary
  tables are the union of every view's LAST JOIN / WINDOW UNION references
  (shared by structural key, so two scenarios asking for
  ``w_sum(amount, 1h)`` share one lane).  The merged view backs one
  :class:`~repro_torch.core.online.OnlineFeatureStore`, or one
  :class:`~repro_torch.core.shard.ShardedOnlineStore` when ``num_shards``
  is given.  A table referenced by many views has one ring per (table,
  shard placement), not per view.
* **One ingest.**  Primary and secondary rows are ingested once and serve
  every scenario; :meth:`ingest_row_counts` exposes the accounting.
* **Per-scenario programs.**  Each view gets a
  :class:`~repro_torch.core.online.QueryProgram`: its window aggregations
  and joins as subsets of the shared plan.  Answers equal a dedicated
  single-view store fed the same stream, bit for bit — per-key state
  depends only on the key's rows and their order, and sharing lanes
  changes neither.
* **Mixed batches.**  :meth:`query_mixed` answers rows of every scenario
  in one device-routed dispatch
  (:meth:`~repro_torch.core.shard.ShardedOnlineStore.route_and_query`).
* **Live evolution.**  :meth:`ScenarioPlane.evolve` re-plans the layout
  for a new view list and migrates the running store's state to it on the
  device (:meth:`~repro_torch.core.online.OnlineFeatureStore.
  adopt_layout`): unchanged rings carry over as the same tensors, new
  lanes are synthesized from the raw-column lanes, and only the *new*
  views get query programs.  Adding scenario #N+1 neither rebuilds the
  plane nor re-ingests shared tables (``MultiScenarioService.hot_deploy``
  is the serving-layer entry).

The port of the reference package's ``repro.core.scenario``.  The serving
front end lives in :mod:`repro_torch.serve` (``FeatureService.
build_multi``, the scenario-aware ``ShardRouter``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.expr import Expr, collect_tables, eval_rowlevel
from repro_torch.core.layout import StoreLayout, plan_layout
from repro_torch.core.online import OnlineFeatureStore, QueryProgram
from repro_torch.core.storage import Database, TableSchema
from repro_torch.core.view import FeatureView
from repro_torch.obs import get_telemetry

__all__ = ["merge_views", "ScenarioPlane"]


def merge_views(
    views: List[FeatureView], name: str = "scenario_plane"
) -> FeatureView:
    """Fuse N scenario views into the plane's one internal view.

    Features are namespaced ``"<view>/<feature>"`` (view names must be
    distinct); the merged database is the primary table plus the union of
    all referenced secondary tables.  Every view must share the primary
    schema, and two views referencing the same secondary table name must
    agree on its schema — the plane stores that table once, so a schema
    conflict would silently corrupt one of them.
    """
    if not views:
        raise ValueError("merge_views needs at least one view")
    names = [v.name for v in views]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate scenario view names: {sorted(names)}")
    primary = views[0].schema
    secondaries: Dict[str, TableSchema] = {}
    features: Dict[str, Expr] = {}
    for v in views:
        if v.schema != primary:
            raise ValueError(
                f"scenario {v.name!r} has primary table {v.schema.name!r} "
                f"({v.schema}), the plane's is {primary.name!r} ({primary}): "
                "all scenarios of one plane share one primary stream"
            )
        for t in collect_tables(list(v.features.values())):
            sch = v.database.table(t)
            prev = secondaries.setdefault(t, sch)
            if prev != sch:
                raise ValueError(
                    f"secondary table {t!r} has conflicting schemas across "
                    f"scenarios ({prev} vs {sch}); shared tables are stored "
                    "once, so schemas must agree"
                )
        for fname, expr in v.features.items():
            features[f"{v.name}/{fname}"] = expr
    db = Database(
        name=name, primary=primary, secondary=tuple(secondaries.values())
    )
    return FeatureView(
        name=name,
        features=features,
        database=db,
        description=f"merged plane over scenarios: {', '.join(names)}",
    )


class ScenarioPlane:
    """N deployed scenarios sharing one (optionally sharded) online store
    on ``device`` (default ``"cuda"``).

    ``num_shards=None`` deploys on a single-device store; an integer on a
    :class:`~repro_torch.core.shard.ShardedOnlineStore` with that many
    shards.  ``store_kwargs`` (capacity, num_buckets, bucket_size,
    secondary_num_keys, hash_routing, ...) are planner knobs shared by
    every scenario: they size the one state all scenarios live in, and are
    remembered so :meth:`evolve` re-plans with the same policy.
    """

    def __init__(
        self,
        views: Iterable[FeatureView],
        *,
        num_keys: int,
        num_shards: Optional[int] = None,
        name: str = "scenario_plane",
        device_routing: bool = True,
        device="cuda",
        **store_kwargs,
    ):
        views = list(views)
        self.views: Dict[str, FeatureView] = {v.name: v for v in views}
        self._plan_kwargs = dict(
            num_keys=num_keys, num_shards=num_shards, **store_kwargs
        )
        self.layout: StoreLayout = plan_layout(
            views, raw_lanes=True, **self._plan_kwargs
        )
        self.merged = merge_views(views, name=name)
        if num_shards is not None:
            from repro_torch.core.shard import ShardedOnlineStore

            self.store = ShardedOnlineStore(
                self.merged, layout=self.layout,
                device_routing=device_routing, device=device,
            )
        else:
            self.store = OnlineFeatureStore(self.merged, layout=self.layout,
                                            device=device)
        self.programs: Dict[str, QueryProgram] = {
            v.name: self.store.compile_program(v) for v in views
        }

    # -- live evolution ----------------------------------------------------------

    def evolve(
        self,
        new_views: Iterable[FeatureView],
        backfill=None,
        **plan_overrides,
    ):
        """Hot-swap the plane to serve ``new_views`` — a state migration,
        not a rebuild.

        Re-plans the :class:`~repro_torch.core.layout.StoreLayout` for the
        new view list (same planner policy; ``plan_overrides`` may adjust
        knobs like ``capacity``), diffs it against the running plan and
        migrates the live store in place: unchanged rings carry over as
        the same tensors (no shared table is re-ingested —
        :meth:`ingest_row_counts` is unchanged for carried tables), new
        lanes are synthesized from the raw-column lanes, split or added
        rings are rebuilt from per-key rows.  Only views *not already
        deployed* get a new :class:`~repro_torch.core.online.QueryProgram`;
        the others keep theirs (structural subsets: they answer against
        the evolved layout).

        Returns the :class:`~repro_torch.core.migrate.MigrationReport`;
        within the retention horizon the migrated plane equals a cold
        rebuild + full replay bit for bit (``report.exact``).  ``backfill``
        (a :class:`repro_torch.offline.backfill.BackfillSource`) extends
        that beyond the horizon: aged-out ring rows and bucket states are
        re-derived from offline history and spliced into the migrating
        state before the new layout goes live.  A refused evolution (an
        unsupported diff, an unsynthesizable lane without a covering
        source) raises ``ValueError`` and leaves the plane as it was.
        """
        tracer = get_telemetry().tracer
        new_views = list(new_views)
        kwargs = dict(self._plan_kwargs)
        kwargs.update(plan_overrides)
        with tracer.span("hot_deploy.plan", views=len(new_views)):
            new_layout = plan_layout(new_views, raw_lanes=True, **kwargs)
            new_merged = merge_views(new_views, name=self.merged.name)
        report = self.store.adopt_layout(
            new_merged, new_layout, backfill=backfill
        )
        old_views = self.views
        self._plan_kwargs = kwargs
        self.layout = new_layout
        self.views = {v.name: v for v in new_views}
        self.merged = new_merged
        # programs only for the NEW views; identical deployed views keep
        # theirs
        self.programs = {
            n: p for n, p in self.programs.items()
            if self.views.get(n) is old_views.get(n)
        }
        with tracer.span("hot_deploy.compile"):
            for v in new_views:
                if v.name not in self.programs:
                    self.programs[v.name] = self.store.compile_program(v)
                    report.new_programs.append(v.name)
        return report

    # -- introspection ---------------------------------------------------------

    @property
    def scenarios(self) -> List[str]:
        return list(self.views)

    @property
    def num_shards(self) -> int:
        return int(getattr(self.store, "num_shards", 1))

    @property
    def tables(self) -> List[str]:
        """All source tables of the plane (primary first, each once)."""
        return self.merged.tables

    def program(self, scenario: str) -> QueryProgram:
        try:
            return self.programs[scenario]
        except KeyError:
            raise KeyError(
                f"unknown scenario {scenario!r}; plane serves "
                f"{self.scenarios}"
            ) from None

    def ingest_row_counts(self) -> Dict[str, int]:
        """Per-table stored row totals — each shared table counted once
        (x replication on a sharded store), never once per scenario."""
        return self.store.ingest_row_counts()

    # -- data plane ------------------------------------------------------------

    def ingest(self, columns) -> None:
        """Ingest primary rows once, for every scenario."""
        self.store.ingest(columns)

    def ingest_table(self, table: str, columns) -> None:
        """Ingest secondary-table rows once; every scenario referencing
        ``table`` (via LAST JOIN or WINDOW UNION) sees them."""
        self.store.ingest_table(table, columns)

    def query(
        self, scenario: str, columns, mode: str = "preagg",
        valid=None, route_info=None,
    ) -> Dict[str, torch.Tensor]:
        """One scenario's features for a request batch, through that
        scenario's program against the shared state.  Returns
        {feature_name: (Q,) tensor} in that view's naming (no plane
        prefix)."""
        return self.store.query(
            columns, mode=mode, program=self.program(scenario),
            valid=valid, route_info=route_info,
        )

    def query_mixed(
        self, columns, tags, mode: str = "preagg",
        valid=None, route_info=None,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Answer a MIXED batch — rows tagged per row with their scenario
        name (``tags``, (Q,)) — in ONE device-routed dispatch (needs a
        sharded store with ``device_routing=True``); ``valid`` masks
        scheduler padding.

        The dispatch computes the merged store's full aggregation set for
        every row (bit for bit each scenario's own program's answers: all
        scenarios share the primary schema, so a mixed batch carries every
        needed column); each scenario's features are then finished from
        that superset on its valid rows, in submission order.  Returns
        ``{scenario: {feature: rows}}``, scenarios without rows left out.
        """
        names = self.scenarios
        index = {s: i for i, s in enumerate(names)}
        tags = np.asarray(tags)
        try:
            scen = np.asarray([index[t] for t in tags], np.int32)
        except KeyError as e:
            raise KeyError(
                f"unknown scenario {e.args[0]!r}; plane serves {names}"
            ) from None
        vals, q = self.store.route_and_query(
            columns, scen, len(names), mode=mode, valid=valid,
            route_info=route_info,
        )
        if route_info is not None:
            route_info["scenario_names"] = list(names)
        vmask = (
            np.ones(q, bool) if valid is None else np.asarray(valid, bool)[:q]
        )
        store = self.store
        pre = dict(zip(list(store._wagg_order) + list(store._ljoin_order),
                       vals))
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        with get_telemetry().tracer.span("query.scatter", rows=q):
            cols = store._columns(columns)
            for s in names:
                rows = np.flatnonzero(vmask & (scen == index[s]))
                if not rows.size:
                    continue
                ix = torch.as_tensor(rows, device=store.device)
                prog = self.programs[s]
                cols_s = {c: v[ix] for c, v in cols.items()}
                pv_s = {k: pre[k][ix]
                        for k in prog.wagg_order + prog.ljoin_order}
                out[s] = {
                    fname: eval_rowlevel(fexpr, cols_s, pv_s)
                    for fname, fexpr in self.views[s].features.items()
                }
        return out

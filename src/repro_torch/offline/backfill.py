"""Offline backfill bridge — exact migrations beyond the retention horizon.

The online plane's rings retain only the last ``capacity`` rows per key,
so a hot deployment that needs older state (a capacity grow after rows
aged out, a placement change over a wrapped ring, a lane that cannot be
synthesized from stored f32 columns) either refuses or completes with
``report.exact = False``.  FeatInsight's answer is its offline half: the
full history lives in offline storage, and feature state is *re-derived*
from it with the same computation that ran online.

:class:`BackfillSource` is that bridge for the port's stores.  Given
per-table raw-column history (exactly the column batches that were
ingested online, any order), it

* re-derives **ring state**: lane values by the same elementwise
  :func:`~repro_torch.core.expr.eval_rowlevel` ingest uses (bit for bit
  row by row, hash / signature lanes included), written by the ring's own
  ingest (:func:`~repro_torch.core.storage.ring_ingest`: the row at
  absolute index ``a`` lands in slot ``a % C``) under the store's own
  shard routing;
* re-derives **bucket pre-aggregate state**: the history's rows of each
  slot's surviving bucket, in the canonical ``lexsort((ts, key))`` order,
  folded left to right from the identity by the fused ingest kernel (B1)
  into a fresh bucket store — the association the reference's unbuffered
  ``np.add.at`` folds give, over *all* history rows; the merge-order
  families (FIRST / LAST / TOPN_FREQ) from the same rows, each row's
  ``pos`` its per-key arrival index in the canonical stream;
* **splices** the re-derived state over every structured
  :class:`~repro_torch.core.migrate.Deficit` a migration recorded,
  restoring ``report.exact``.

Safety contract: the splice runs *before* the new layout goes live
(:meth:`~repro_torch.core.online.OnlineFeatureStore.adopt_layout`), writes
no live tensor, and checks the re-derived per-key row counts against the
store's cursors — a history that does not reproduce the online stream
raises and leaves the plane serving the old layout.

The port of the reference package's ``repro.offline.backfill``.  The
history stays on the host until a derivation uploads the columns it needs
to the store's device; the derived state is made there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tensor
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.expr import (
    collect_last_joins,
    collect_window_aggs,
    eval_rowlevel,
)
from repro_torch.core.layout import LayoutDiff, RingPlan
from repro_torch.core.migrate import MigrationReport, _collect_cols
from repro_torch.core.online import OnlineState
from repro_torch.kernels.ingest.ops import fused_ingest
from repro_torch.obs import get_telemetry

__all__ = ["BackfillAction", "BackfillPlan", "BackfillSource"]


@dataclasses.dataclass(frozen=True)
class BackfillAction:
    """One state re-derivation the splice will perform (or refuse).

    Mirrors the :class:`~repro_torch.core.migrate.Deficit` it repairs,
    plus the offline side: how many history rows the source holds for the
    table (``rows``; per-shard breakdown for partitioned rings) and
    whether the source covers the re-derivation (``covered`` — table
    present, every needed raw column present, keys inside the plan's
    domain).
    """

    target: str                       # 'ring' | 'bucket'
    table: str
    ring: Optional[int] = None        # new.tables index; None = primary
    lanes: Optional[Tuple] = None
    rows: int = 0
    rows_per_shard: Tuple[int, ...] = ()
    covered: bool = True
    reason: str = ""

    def describe(self) -> str:
        what = (
            "all lanes" if self.lanes is None
            else ", ".join(repr(k) for k in self.lanes)
        )
        tag = "" if self.covered else f"  UNCOVERED: {self.reason}"
        return (
            f"{self.target} {self.table} [{what}] "
            f"<- {self.rows} history rows{tag}"
        )


@dataclasses.dataclass
class BackfillPlan:
    """What a backfill splice will do for one migration's deficits."""

    actions: List[BackfillAction] = dataclasses.field(default_factory=list)

    @property
    def covered(self) -> bool:
        return all(a.covered for a in self.actions)

    @property
    def total_rows(self) -> int:
        return sum(a.rows for a in self.actions)

    def describe(self) -> str:
        if not self.actions:
            return "backfill plan: nothing to re-derive"
        lines = [
            f"backfill plan: {len(self.actions)} action(s), "
            f"{self.total_rows} history rows, "
            f"covered={'yes' if self.covered else 'NO'}"
        ]
        for a in self.actions:
            lines.append(f"  {a.describe()}")
        return "\n".join(lines)


def _features_needing(view, table: str, lanes: Optional[Tuple]) -> List[str]:
    """Which view features depend on the deficient state (for refusal
    messages that name the offender)."""
    names: List[str] = []
    for fname, expr in view.features.items():
        waggs = collect_window_aggs([expr])
        ljs = collect_last_joins([expr])
        if lanes:
            if any(wa.arg.key in lanes for wa in waggs.values()) or any(
                lj.arg.key in lanes for lj in ljs.values()
            ):
                names.append(fname)
            continue
        if any(table in wa.union for wa in waggs.values()) or any(
            lj.table == table for lj in ljs.values()
        ):
            names.append(fname)
    if not names and lanes is None:
        # primary-table deficits touch every windowed feature
        names = [
            f for f, e in view.features.items() if collect_window_aggs([e])
        ]
    return names


def _flat_keys(plan: RingPlan, S: int) -> int:
    """Rows of ``plan``'s ring in flat form."""
    return plan.ring_keys * (S if plan.partitioned else 1)


class BackfillSource:
    """Per-table raw-column history, servable into a migrating plane.

    ``tables`` maps table name -> column dict (including the schema's key
    and ts columns), holding the *complete* stream that was ingested
    online — same values, same dtypes, in ingest order (ties in ``(key,
    ts)`` keep their relative order, matching the store's stable batch
    sorts).  Feed it to ``MultiScenarioService.hot_deploy(view,
    backfill=source)`` / ``ScenarioPlane.evolve`` /
    ``OnlineFeatureStore.adopt_layout``.
    """

    def __init__(self, database, tables: Dict[str, Dict[str, np.ndarray]]):
        self.database = database
        self.tables: Dict[str, Dict[str, np.ndarray]] = {}
        for name, cols in tables.items():
            sch = database.table(name)  # raises on unknown tables
            missing = [c for c in (sch.key, sch.ts) if c not in cols]
            if missing:
                raise ValueError(
                    f"backfill history for table {name!r} lacks required "
                    f"column(s) {missing} (schema key={sch.key!r}, "
                    f"ts={sch.ts!r})"
                )
            arrs = {c: np.asarray(v) for c, v in cols.items()}
            sizes = {c: a.shape[0] for c, a in arrs.items()}
            if len(set(sizes.values())) > 1:
                raise ValueError(
                    f"backfill history for table {name!r} has ragged "
                    f"columns: {sizes}"
                )
            self.tables[name] = arrs
        self._streams: Dict[str, Tuple] = {}
        self._routes: Dict[Tuple, torch.Tensor] = {}

    # -- history access -----------------------------------------------------

    def rows(self, table: str) -> int:
        return (
            0 if table not in self.tables
            else next(iter(self.tables[table].values())).shape[0]
        )

    def stream(self, table: str):
        """Canonical history stream of ``table``: ``(key (N,) i64, ts (N,)
        i32, columns {name: (N,)})`` on the host, sorted by the store's
        canonical ``lexsort((ts, key))`` order — the order every fold
        below replays."""
        if table in self._streams:
            return self._streams[table]
        sch = self.database.table(table)
        cols = self.tables[table]
        key = np.asarray(cols[sch.key]).astype(np.int64)
        ts = np.asarray(cols[sch.ts]).astype(np.int32)
        order = np.lexsort((ts, key))
        out = (
            key[order],
            ts[order],
            {c: np.asarray(v)[order] for c, v in cols.items()},
        )
        self._streams[table] = out
        return out

    # -- coverage -----------------------------------------------------------

    def covers(self, table: str, expr) -> bool:
        """Can ``expr``'s lane be re-derived for ``table`` from this
        history?  (The migration's deferral hook: a lane is zero-filled for
        the splice only when this says yes.)"""
        if table not in self.tables:
            return False
        cols = self.tables[table]
        return all(c in cols for c in _collect_cols(expr))

    def _plan_coverage(
        self, plan: RingPlan, lanes: Optional[Tuple]
    ) -> Optional[str]:
        """None when every needed lane of ``plan`` is derivable from the
        history; otherwise why not."""
        if plan.table not in self.tables:
            return (
                f"backfill source holds no history for table "
                f"{plan.table!r} (has {sorted(self.tables)})"
            )
        cols = self.tables[plan.table]
        need = (
            plan.lanes if lanes is None
            else [s for s in plan.lanes if s.key in lanes]
        )
        for slot in need:
            missing = [c for c in _collect_cols(slot.expr) if c not in cols]
            if missing:
                return (
                    f"lane {slot.key!r} of table {plan.table!r} needs raw "
                    f"column(s) {missing} absent from the backfill history"
                )
        return None

    # -- planning -----------------------------------------------------------

    def plan(
        self, diff: LayoutDiff, report: MigrationReport, store
    ) -> BackfillPlan:
        """Resolve a migration's deficits against this history: one
        :class:`BackfillAction` per deficit, with coverage verdicts and
        per-(table, shard) history row counts.  Pure introspection — no
        state is touched (``splice`` executes covered plans)."""
        sharded = diff.new.num_shards is not None
        S = diff.new.num_shards or 1
        out = BackfillPlan()
        for d in report.deficits:
            ring_plan = (
                diff.new.primary if d.target == "bucket" or d.ring is None
                else diff.new.tables[d.ring]
            )
            # a ring deficit rebuilds the WHOLE ring (every lane needs its
            # raw columns); a per-lane bucket re-fold needs only its own
            need_lanes = d.lanes if d.target == "bucket" else None
            why = self._plan_coverage(ring_plan, need_lanes)
            rows = self.rows(ring_plan.table)
            per_shard: Tuple[int, ...] = ()
            if why is None and rows:
                key, _, _ = self.stream(ring_plan.table)
                if ring_plan.partitioned and sharded:
                    try:
                        flat = self._routed(ring_plan, key, store, sharded,
                                            store.device)
                        per_shard = tuple(torch.bincount(
                            flat // ring_plan.ring_keys, minlength=S
                        ).tolist())
                    except ValueError as e:
                        why = str(e)
                elif key.size and (
                    key.min() < 0 or key.max() >= ring_plan.num_keys
                ):
                    why = (
                        f"history keys of table {ring_plan.table!r} fall "
                        f"outside [0, {ring_plan.num_keys}) "
                        f"(seen [{key.min()}, {key.max()}])"
                    )
                else:
                    per_shard = (rows,) * S
            out.actions.append(BackfillAction(
                target=d.target,
                table=ring_plan.table,
                ring=d.ring,
                lanes=d.lanes,
                rows=rows,
                rows_per_shard=per_shard,
                covered=why is None,
                reason=why or "",
            ))
        return out

    # -- re-derivation ------------------------------------------------------

    def _lane_values(
        self,
        plan: RingPlan,
        columns: Dict,
        device,
        lane_js: Optional[List[int]] = None,
    ) -> torch.Tensor:
        """(N, max(F, 1)) f32 lane block over the history stream on
        ``device`` — the values ingest computed: ``eval_rowlevel(expr,
        raw_columns)`` elementwise over the same canonical tensors, so
        hash / signature lanes reproduce bit for bit.  ``lane_js``
        restricts evaluation to those lane indices (the others stay zero),
        so a per-lane bucket re-fold needs only *its* raw columns."""
        n = next(iter(columns.values())).shape[0] if columns else 0
        out = torch.zeros((n, max(len(plan.lanes), 1)), dtype=torch.float32,
                          device=device)
        if not plan.lanes:
            return out
        js = range(len(plan.lanes)) if lane_js is None else lane_js
        need = {c for j in js for c in _collect_cols(plan.lanes[j].expr)}
        cols = {c: as_tensor(v, device) for c, v in columns.items()
                if c in need}
        for j in js:
            out[:, j] = eval_rowlevel(plan.lanes[j].expr, cols, {}).to(
                torch.float32)
        return out

    def _routed(self, plan: RingPlan, key: np.ndarray, store,
                sharded: bool, device) -> torch.Tensor:
        """(N,) int64 flat ring row of each history key on ``device``
        under the store's own routing (``shard * K_local + local`` for a
        partitioned ring, the key for a replicated one), range-checked:
        out-of-domain history keys raise, they can never be spliced
        silently.  A partitioned ring's keys walk the store's Feistel
        permutation on the device (its mirror of the host walk the
        store's ingest routes by, bit for bit); a table's routing is
        computed once per source."""
        part = plan.partitioned and sharded
        perm = store._perm if part else None
        memo = (plan.table, part, plan.num_keys, plan.ring_keys, str(device),
                getattr(store, "num_shards", 1),
                None if perm is None else perm.upper)
        if memo in self._routes:
            return self._routes[memo]
        if part:
            store._check_range(key, plan.num_keys)
        elif key.size and (key.min() < 0 or key.max() >= plan.num_keys):
            raise ValueError(
                f"history keys of table {plan.table!r} fall outside "
                f"[0, {plan.num_keys}) (seen [{key.min()}, {key.max()}])"
            )
        flat = torch.as_tensor(key, device=device).to(torch.int64)
        if part and key.size:
            if perm is not None:
                routed, walking = perm.device_call(flat.to(torch.int32))
                if bool(walking):
                    routed = perm.finish_walk(routed)
                flat = routed.to(torch.int64)
            S = store.num_shards
            flat = (flat % S) * plan.ring_keys + flat // S
        self._routes[memo] = flat
        return flat

    @staticmethod
    def _row_order(flat: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """Indices putting rows in (flat row, ts) order, rows of equal
        (flat row, ts) in their given (canonical) order: a stable sort of
        one int64 key on the device."""
        comp = flat * (1 << 32) + (ts.to(torch.int64) + (1 << 31))
        return torch.sort(comp, stable=True).indices

    def _derive_ring(self, plan: RingPlan, store, sharded: bool, S: int,
                     device) -> st.RingStore:
        """Re-derive one ring wholesale from history, in flat form —
        byte-identical to a ring that ingested the full stream at this
        plan all along: one ring ingest of the stream, (flat row, ts)
        sorted with same-key rows in canonical order."""
        key, ts, cols = self.stream(plan.table)
        lanes = self._lane_values(plan, cols, device)
        ring = st.ring_init(_flat_keys(plan, S), plan.capacity,
                            max(len(plan.lanes), 1), device)
        if key.size:
            flat = self._routed(plan, key, store, sharded, device)
            ts_t = torch.as_tensor(ts, device=device)
            order = self._row_order(flat, ts_t)
            st.ring_ingest(ring, flat[order].to(torch.int32), ts_t[order],
                           lanes[order])
        return ring

    def _verify_cursors(self, plan: RingPlan, cur_new: torch.Tensor,
                        cur_live: torch.Tensor, sharded: bool) -> None:
        """The exactness tripwire: re-derived per-key row counts must
        equal the live (migrated) cursors — the store's rows-ever ledger.
        Anything else means the history is not the online stream."""
        diff = cur_new != cur_live
        if not bool(diff.any()):
            return
        bad = int(diff.sum())
        f = int(torch.nonzero(diff)[0, 0])
        s, k = (divmod(f, plan.ring_keys) if plan.partitioned and sharded
                else (0, f))
        raise ValueError(
            f"backfill history for table {plan.table!r} does not reproduce "
            f"the online stream: per-key row counts disagree with the live "
            f"store's cursors at {bad} ring row(s) (e.g. shard {s} "
            f"row {k}: history has {int(cur_new[f])} rows, the "
            f"store ingested {int(cur_live[f])}); the splice needs "
            f"exactly the rows that were ingested online — rebuild the "
            f"plane or fix the history"
        )

    def _derive_bucket(
        self,
        diff: LayoutDiff,
        bagg: pg.BucketAgg,
        store,
        sharded: bool,
        S: int,
        full: bool,
        lane_keys: List[Tuple],
    ) -> pg.BucketAgg:
        """Re-fold bucket pre-aggregate states from the full primary
        history (``full`` rebuilds ids and every lane after a
        ``num_buckets`` wraparound; otherwise only ``lane_keys`` re-fold
        over the migrated — exact — bucket ids).

        Each slot keeps the rows of its surviving bucket (the newest id
        written there); those rows, in canonical stream order, go as one
        (flat key, ts)-sorted batch through the fused ingest kernel into a
        fresh bucket store of the re-folded lanes: every (key, bucket)
        state is then the left fold of its rows from the identity, the
        association of the reference's ``np.add.at`` folds.

        The merge-order families, where the new plan persists them, are
        re-derived whole from the same surviving rows (the winners' rows
        are shared by every lane): a row's ``pos`` is its per-(flat) key
        count in the canonical stream, the order the online store saw.
        """
        dst_p = diff.new.primary
        NB = diff.new.bucket.num_buckets
        bsize = diff.new.bucket.bucket_size
        device = bagg.stats.device
        key, ts, cols = self.stream(dst_p.table)
        if full:
            lane_js = list(range(len(dst_p.lanes))) or [0]
        else:
            lane_js = [dst_p.lane_of(k) for k in lane_keys]
        want_ext, want_tail = diff.new.bucket.extreme, diff.new.bucket.tail
        eval_js = ((list(range(len(dst_p.lanes))) or [0])
                   if want_ext or want_tail else lane_js)
        lanes = self._lane_values(
            dst_p, cols, device, lane_js=[j for j in eval_js if dst_p.lanes]
        )
        K = _flat_keys(dst_p, S)
        live_state = store._flat_state().bagg
        stats, bitmap, bucket = bagg.stats, bagg.bitmap, bagg.bucket
        # the splice writes lanes in place: never into a live tensor
        if stats.data_ptr() == live_state.stats.data_ptr():
            stats = stats.clone()
        if bitmap.data_ptr() == live_state.bitmap.data_ptr():
            bitmap = bitmap.clone()

        flat = self._routed(dst_p, key, store, sharded, device)
        ts_t = torch.as_tensor(ts, device=device)
        b_all = torch.div(ts_t.to(torch.int64), bsize, rounding_mode="floor")
        cell = flat * NB + torch.remainder(b_all, NB)
        if full:
            # stored id per slot = the largest bucket id ever written (the
            # live ring's newest-bucket-wins retention)
            ids = torch.full((K * NB,), -1, dtype=torch.int64, device=device)
            ids.scatter_reduce_(0, cell, b_all, reduce="amax")
            bucket = ids.view(K, NB).to(torch.int32)
        # rows of each slot's *surviving* bucket (earlier buckets of the
        # same slot were reset away by the newest id)
        rows = torch.nonzero(
            bucket.reshape(-1)[cell].to(torch.int64) == b_all)[:, 0]
        rows = rows[self._row_order(flat[rows], ts_t[rows])]
        F = len(lane_js)
        fresh = pg.bucket_init(K, NB, F, bsize, device)
        if rows.numel():
            scratch = st.ring_init(K, 1, F, device)  # B1's ring, discarded
            fused_ingest(
                scratch.ts, scratch.vals, scratch.cursor,
                fresh.stats, fresh.bitmap, fresh.bucket,
                flat[rows].to(torch.int32), ts_t[rows],
                lanes[rows][:, lane_js].contiguous(),
                bucket_size=bsize,
            )
        for jj, j in enumerate(lane_js):
            stats[:, :, j] = fresh.stats[:, :, jj]
            bitmap[:, :, j] = fresh.bitmap[:, :, jj]
        fam = {}
        if want_ext or want_tail:
            # pos: each row's rank among its flat key's rows, in stream order
            n = flat.numel()
            o_g = torch.sort(flat, stable=True).indices
            go = flat[o_g]
            first_of = torch.ones(n, dtype=torch.bool, device=device)
            first_of[1:] = go[1:] != go[:-1]
            first = torch.nonzero(first_of)[:, 0]
            pos = torch.empty(n, dtype=torch.int64, device=device)
            pos[o_g] = (torch.arange(n, device=device)
                        - first[torch.cumsum(first_of, 0) - 1])
            fam["seq"] = torch.bincount(flat, minlength=K).to(torch.int32)
            fam.update(pg.families_from_rows(
                cell[rows], ts_t[rows], pos[rows], lanes[rows], K, NB,
                extreme=want_ext, tail=want_tail))
        return pg.BucketAgg(stats=stats, bitmap=bitmap, bucket=bucket,
                            size=bsize, **fam)

    # -- the splice ---------------------------------------------------------

    def splice(
        self,
        diff: LayoutDiff,
        state: OnlineState,
        report: MigrationReport,
        store,
        view,
    ) -> OnlineState:
        """Repair every deficit of a migrated (flat) state from offline
        history.

        Runs against the *untouched* store (before the new layout goes
        live); raises — refusing the whole deployment atomically — when
        any deficit is uncoverable or the history fails the cursor
        tripwire.  On success every deficit moves to
        ``report.backfilled`` and ``report.exact`` is restored (unless the
        migration was hard-inexact: a key-domain shrink dropped rows no
        history can resurrect).
        """
        tel = get_telemetry()
        tracer = tel.tracer
        rows_ctr = tel.metrics.counter(
            "backfill_rows_total",
            "offline history rows folded by backfill splices", "1",
            labels=("table",),
        )
        sharded = diff.new.num_shards is not None
        S = diff.new.num_shards or 1
        device = state.ring.ts.device

        bplan = self.plan(diff, report, store)
        for a in bplan.actions:
            if a.covered:
                continue
            feats = _features_needing(view, a.table, a.lanes)
            named = f" (feature(s) {feats})" if feats else ""
            raise ValueError(
                f"cannot backfill view {view.name!r}{named}: {a.reason}; "
                "extend the backfill source's history or rebuild the "
                "plane for this deployment"
            )

        with tracer.span(
            "backfill", kind="device", actions=len(bplan.actions),
            rows=bplan.total_rows,
        ) as sp:
            ring, bagg, sec = state.ring, state.bagg, list(state.sec)
            ring_targets = sorted(
                {d.ring for d in report.deficits if d.target == "ring"},
                key=lambda r: (-1 if r is None else r),
            )
            for rix in ring_targets:
                plan = (
                    diff.new.primary if rix is None else diff.new.tables[rix]
                )
                live = state.ring if rix is None else state.sec[rix]
                with tracer.span(
                    "backfill.ring", table=plan.table,
                    rows=self.rows(plan.table),
                ):
                    rebuilt = self._derive_ring(plan, store, sharded, S,
                                                device)
                    self._verify_cursors(plan, rebuilt.cursor, live.cursor,
                                         sharded)
                    if rix is None:
                        ring = rebuilt
                    else:
                        sec[rix] = rebuilt
                rows_ctr.inc(self.rows(plan.table), table=plan.table)

            bdefs = [d for d in report.deficits if d.target == "bucket"]
            if bdefs:
                full = any(d.lanes is None for d in bdefs)
                lane_keys = [k for d in bdefs if d.lanes for k in d.lanes]
                with tracer.span(
                    "backfill.bucket", table=diff.new.primary.table,
                    full=full, lanes=len(lane_keys),
                ):
                    bagg = self._derive_bucket(
                        diff, bagg, store, sharded, S, full, lane_keys
                    )
                rows_ctr.inc(
                    self.rows(diff.new.primary.table),
                    table=diff.new.primary.table,
                )
            sp.fence(ring.cursor, bagg.stats)

            report.backfilled.extend(d.describe() for d in report.deficits)
            report.deficits.clear()
            report.exact = not report.hard_inexact
            report.notes.append(
                f"offline backfill spliced {bplan.total_rows} history "
                f"row(s) across {len(bplan.actions)} deficit(s)"
            )
        return OnlineState(ring=ring, bagg=bagg, sec=tuple(sec))

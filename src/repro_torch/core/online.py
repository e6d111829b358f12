"""Online feature store — FeatInsight's request-mode serving path.

OpenMLDB request mode: a request row (key, ts, values) arrives; the service
computes every feature of the view *as if that row were appended* to its
key's history.  The row may then be ingested.  Offline↔online consistency
means: the online answer for row i after ingesting rows 0..i-1 equals the
offline batch answer at row i.

Every aggregate's semantics come from the one registry in
:mod:`repro_torch.core.aggregates`; a query is one generic dataflow:

    lift(request row)
      ⊕ fold(primary window rows)            [raw ring, or raw boundary
                                              rows ⊕ bucket states]
      ⊕ fold(each union table's window rows) [raw secondary rings]
    → finalize

with two ways to fold a primary RANGE window:

* ``naive``  — masked fold over the raw ring (O(C) per query);
* ``preagg`` — raw boundary rows ⊕ per-bucket partial states
  (O(C_boundary + NB)), the paper's long-window optimization.

Ingest applies a (key, ts)-sorted batch to the ring and the bucket store in
one call of the fused ingest kernel (:mod:`repro_torch.kernels.ingest`),
updating the device state in place.  A layout with FIRST / LAST /
TOPN_FREQ over a RANGE window also persists the merge-order bucket
families (:mod:`repro_torch.core.preagg`); their update runs just before
the kernel, which keeps the six core arrays.

Multi-table views keep one ring store per secondary ring of the layout
(``OnlineState.sec``): point-in-time LAST JOIN lookups (the newest row of
the join key with ``ts <= request ts``) and WINDOW UNION windows (the
primary window combined with each union table's masked ring) are
answered from them in the same query.  Secondary rows arrive through
:meth:`OnlineFeatureStore.ingest_table`, which writes every ring of the
table (a dual-use table on a sharded plane has two); secondary rings hold
no pre-aggregates, so their ingest is plain PyTorch, as in the reference.

A :class:`QueryProgram` is one scenario's slice of a store shared by
many (:mod:`repro_torch.core.scenario`): that view's window aggregations
and joins as subsets of the store's, answering requests that carry only
that view's columns.

:meth:`OnlineFeatureStore.adopt_layout` evolves a live store to a new
(view, layout) in place: the state migrates (:mod:`repro_torch.core.
migrate`) instead of being rebuilt, and query programs compiled before
keep answering.

The port of the reference package's ``repro.core.online``.  Programs run
eagerly: there is no per-shape compile, so no ``query_compile_seconds``.
State lives on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.aggregates import agg_spec
from repro_torch.core.expr import (
    Expr,
    WindowAgg,
    collect_last_joins,
    collect_window_aggs,
    eval_rowlevel,
)
from repro_torch.core.layout import StoreLayout, plan_layout
from repro_torch.kernels.ingest.ops import fused_ingest
from repro_torch.obs import get_telemetry

__all__ = ["OnlineState", "OnlineFeatureStore", "QueryProgram"]

_POS_MAX = 2147483647
_TS_MIN = -2147483648


@dataclasses.dataclass
class OnlineState:
    """All device state of one view's online store: the primary ring, its
    bucket pre-aggregates and ``sec``, one ring store per secondary ring
    plan in ``layout.tables`` order.  A sharded store keeps a leading
    shard axis on every tensor, ``(S, K_local, ...)``."""

    ring: st.RingStore
    bagg: pg.BucketAgg
    sec: Tuple[st.RingStore, ...] = ()

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """The six primary arrays, in the kernel's argument order."""
        return (self.ring.ts, self.ring.vals, self.ring.cursor,
                self.bagg.stats, self.bagg.bitmap, self.bagg.bucket)


class OnlineFeatureStore:
    """Stateful store: owns an :class:`OnlineState` on ``device``."""

    def __init__(
        self,
        view,  # repro_torch.core.view.FeatureView
        num_keys: Optional[int] = None,
        capacity: int = 256,
        num_buckets: int = 64,
        bucket_size: int = 64,
        secondary_num_keys: Optional[Dict[str, int]] = None,
        secondary_capacity: Optional[int] = None,
        ttl: Optional[int] = None,
        table_capacity: Optional[Dict[str, int]] = None,
        table_ttl: Optional[Dict[str, int]] = None,
        layout: Optional[StoreLayout] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if layout is None:
            if num_keys is None:
                raise ValueError("OnlineFeatureStore needs num_keys or layout")
            layout = plan_layout(
                [view],
                num_keys=num_keys,
                capacity=capacity,
                num_buckets=num_buckets,
                bucket_size=bucket_size,
                secondary_num_keys=secondary_num_keys,
                secondary_capacity=secondary_capacity,
                ttl=ttl,
                table_capacity=table_capacity,
                table_ttl=table_ttl,
            )
        self._apply_layout(view, layout)
        self.state = self._init_state()

    # -- layout consumption ---------------------------------------------------

    def _apply_layout(self, view, layout: StoreLayout) -> None:
        """Derive every layout-dependent attribute from the plan: lane ids,
        ring indices and placement flags live here, nowhere else.  Called
        at construction and again by :meth:`adopt_layout`."""
        self.view = view
        self.schema = view.schema
        self.layout = layout
        self.num_keys = layout.primary.ring_keys
        self.capacity = layout.primary.capacity
        self.num_buckets = layout.bucket.num_buckets
        self.bucket_size = layout.bucket.bucket_size
        self._ttl = layout.primary.ttl

        exprs = list(view.features.values())
        self.waggs: Dict[Tuple, WindowAgg] = collect_window_aggs(exprs)
        self._wagg_order: List[Tuple] = list(self.waggs.keys())
        self.ljoins = collect_last_joins(exprs)
        self._ljoin_order: List[Tuple] = list(self.ljoins.keys())

        self._lane_exprs: List[Expr] = [s.expr for s in layout.primary.lanes]
        self._lane_of: Dict[Tuple, int] = {
            s.key: i for i, s in enumerate(layout.primary.lanes)
        }
        for wa in self.waggs.values():
            if wa.arg.key not in self._lane_of:
                raise ValueError(
                    f"layout has no lane for window argument of "
                    f"{wa.agg.value}() in view {view.name!r}; the layout "
                    "must be planned from (a superset of) this view"
                )
        self.num_lanes = max(len(self._lane_exprs), 1)

        # union waggs whose *primary-stream* part can compose from bucket
        # pre-aggregates (union rows always fold from their raw rings)
        self._union_preagg: Dict[Tuple, bool] = {}
        for wk, wa in self.waggs.items():
            if wa.window.mode == "range":
                need = self._window_span(wa) // self.bucket_size + 2
                if not wa.union and need > self.num_buckets:
                    feats = [
                        f for f, e in view.features.items()
                        if wk in collect_window_aggs([e])
                    ]
                    raise ValueError(
                        f"window {wa.window.size} of {wa.agg.value}() in "
                        f"feature(s) {feats} of view {view.name!r} needs "
                        f"{need} buckets of {self.bucket_size}, store "
                        f"layout has num_buckets={self.num_buckets}"
                    )
                self._union_preagg[wk] = bool(
                    wa.union
                    and need <= self.num_buckets
                    and agg_spec(wa.agg).bucket_composable
                )

        # -- secondary-ring plane (LAST JOIN + WINDOW UNION sources) --------
        self._ring_plans = layout.tables
        self._sec_names: Tuple[str, ...] = layout.table_names
        # first ring of each table
        self._sec_index = {t: layout.rings_of(t)[0] for t in self._sec_names}
        self._sec_schemas = {
            t: view.database.table(t) for t in self._sec_names
        }
        self._ring_lane_exprs: List[List[Expr]] = [
            [s.expr for s in p.lanes] for p in layout.tables
        ]
        self._ring_lane_of: List[Dict[Tuple, int]] = [
            {s.key: i for i, s in enumerate(p.lanes)} for p in layout.tables
        ]
        self._union_tables: Tuple[str, ...] = ()
        for wa in self.waggs.values():
            for t in wa.union:
                if t not in self._union_tables:
                    self._union_tables += (t,)
        self._union_ring_ix = {
            t: layout.union_ring(t) for t in self._union_tables
        }
        self._join_ring_ix = {
            lj.table: layout.join_ring(lj.table)
            for lj in self.ljoins.values()
        }
        self.secondary_num_keys = {
            t: layout.tables[self._sec_index[t]].num_keys
            for t in self._sec_names
        }
        # request-time join-key columns (primary columns named by LAST JOINs)
        self._join_cols: Tuple[str, ...] = ()
        for lj in self.ljoins.values():
            if lj.on not in self._join_cols:
                self._join_cols += (lj.on,)
        self._join_col_index = {c: i for i, c in enumerate(self._join_cols)}

    @property
    def _flat_keys(self) -> int:
        """Rows of the flat (key-addressed) state: all keys of all shards."""
        return self.num_keys

    def _ring_flat_keys(self, index: int) -> int:
        """Rows of secondary ring ``index``'s flat state."""
        return self._ring_plans[index].ring_keys

    @property
    def _key_upper(self) -> int:
        """Size of the key domain callers address."""
        return self.num_keys

    def _check_range(self, key: np.ndarray,
                     upper: Optional[int] = None) -> np.ndarray:
        """Keys outside [0, upper) are rejected: they would address another
        key's state (or none).  ``upper`` defaults to the primary's key
        domain; a secondary table's ingest passes its own."""
        key = np.asarray(key)
        upper = self._key_upper if upper is None else upper
        if key.size and (key.min() < 0 or key.max() >= upper):
            raise ValueError(
                f"key out of range [0, {upper}): [{key.min()}, {key.max()}]"
            )
        return key

    def _init_state(self) -> OnlineState:
        lay = self.layout
        sec = tuple(
            st.ring_init(
                self._ring_flat_keys(i), p.capacity, max(len(p.lanes), 1),
                self.device,
            )
            for i, p in enumerate(lay.tables)
        )
        return self._shape_state(OnlineState(
            ring=st.ring_init(
                self._flat_keys, lay.primary.capacity, self.num_lanes,
                self.device,
            ),
            bagg=pg.bucket_init_plan(
                lay.bucket, self._flat_keys, self.num_lanes, self.device
            ),
            sec=sec,
        ))

    # -- live evolution -------------------------------------------------------

    def adopt_layout(self, view, layout: StoreLayout, backfill=None):
        """Evolve this live store to a new (view, layout) in place.

        Diffs the old plan against ``layout`` (:func:`~repro_torch.core.
        layout.diff_layouts`), migrates every state buffer on the device
        (carried verbatim where ring identity is unchanged — the same
        tensors; re-laid / lane-synthesized otherwise, see
        :mod:`repro_torch.core.migrate`), and re-derives all
        layout-dependent attributes.  :class:`QueryProgram` s compiled
        against this store keep answering: their subsets are structural
        keys, looked up in the store's attributes at each call.

        ``backfill`` (a :class:`repro_torch.offline.backfill.
        BackfillSource`) closes the retention horizon: state the migration
        could not reconstruct is re-derived from offline history and
        spliced in *before* the new layout goes live.

        Atomic: the migration and the splice run against the untouched
        store and write nothing of its state, so a refusal (an
        unsynthesizable lane, an unsupported diff, an uncovered deficit)
        leaves the plane serving exactly as before.  Returns the
        :class:`~repro_torch.core.migrate.MigrationReport`.
        """
        from repro_torch.core import migrate
        from repro_torch.core.layout import diff_layouts

        tracer = get_telemetry().tracer
        with tracer.span("migrate.diff"):
            diff = diff_layouts(self.layout, layout)
        # the routing attributes migrate_state and the splice read
        # (permutation, shard count, local key count) are invariant across
        # any diff diff_layouts accepts
        state, report = migrate.migrate_state(
            diff, self.state, self, backfill=backfill)
        if backfill is not None and report.deficits:
            state = backfill.splice(diff, state, report, self, view)
        self._apply_layout(view, layout)
        with tracer.span("migrate.place", kind="device") as sp:
            self.state = self._place_state(state)
            sp.fence(self.state.ring.cursor)
        return report

    def _place_state(self, flat: OnlineState) -> OnlineState:
        """The public state of a migrated flat state (views, no copy): the
        sharded store splits the key axis and shows a replicated ring's
        one copy as S replicas."""
        return self._shape_state(flat)

    def _shape_state(self, flat: OnlineState) -> OnlineState:
        """The public state shape of a flat state (identity here; the
        sharded store splits the key axis into (S, K_local))."""
        return flat

    def _flat_state(self, state: Optional[OnlineState] = None) -> OnlineState:
        """``state`` (default: ``self.state``) with one key axis over all
        keys: the tensors the kernels and the query address (views)."""
        return self.state if state is None else state

    # -- columns and lanes ------------------------------------------------------

    def _columns(self, columns: Dict) -> Dict[str, torch.Tensor]:
        """Request / ingest columns as canonical tensors on the device."""
        return {c: as_tensor(v, self.device) for c, v in columns.items()}

    def _lanes(self, cols: Dict[str, torch.Tensor],
               exprs: Optional[List[Expr]] = None,
               n: Optional[int] = None) -> torch.Tensor:
        """(N, L) materialized lanes from raw columns: the primary's
        window-arg lanes, or ``exprs`` (a secondary ring's) over ``n``
        rows; a ring with no lanes gets one zero lane."""
        exprs = self._lane_exprs if exprs is None else exprs
        if not exprs:
            n = cols[self.schema.key].shape[0] if n is None else n
            return torch.zeros((n, 1), dtype=torch.float32, device=self.device)
        vals = [eval_rowlevel(e, cols, {}).to(torch.float32) for e in exprs]
        return torch.stack(vals, dim=-1)

    # -- ingest -----------------------------------------------------------------

    def ingest(self, columns: Dict) -> None:
        """Ingest a batch of raw rows (must be (key, ts)-sorted).

        Each fused batch must span fewer than ``num_buckets`` pre-agg
        buckets (a slot receives at most one new bucket id per batch), so
        oversized batches are split here on bucket boundaries, each chunk
        re-sorted by (key, ts).

        The batch is timed entry-to-queryable: the freshness clock stops
        after a fence on the new state (``ingest_freshness_seconds``).
        """
        tel = get_telemetry()
        t0 = tel.clock.now()
        key_h = self._check_range(
            np.asarray(columns[self.schema.key]).astype(np.int32)
        )
        ts_h = np.asarray(columns[self.schema.ts]).astype(np.int32)
        if ts_h.size == 0:
            return
        lanes = self._lanes(self._columns(columns))
        with tel.tracer.span(
            "ingest", kind="device", table=self.schema.name,
            rows=int(ts_h.size),
        ) as sp:
            b = ts_h // self.bucket_size
            if (b.max() - b.min()) < self.num_buckets - 1:
                self._ingest_padded(key_h, ts_h, lanes)
            else:
                epoch = b // (self.num_buckets - 1)
                for e in np.unique(epoch):
                    idx = np.nonzero(epoch == e)[0]
                    order = idx[np.lexsort((ts_h[idx], key_h[idx]))]
                    self._ingest_padded(
                        key_h[order], ts_h[order],
                        lanes[torch.as_tensor(order, device=self.device)],
                    )
            sp.fence(self.state.ring.cursor)
        self._note_freshness(tel, self.schema.name, int(ts_h.size), t0)

    def _note_freshness(self, tel, table: str, n_rows: int, t0: float) -> None:
        dt = tel.clock.now() - t0
        m = tel.metrics
        m.histogram(
            "ingest_freshness_seconds",
            "ingest-call-to-queryable delay per row", "s",
            labels=("table",),
        ).observe(dt, n=n_rows, table=table)
        m.counter(
            "ingest_rows_total", "rows ingested", "1", labels=("table",),
        ).inc(n_rows, table=table)

    @staticmethod
    def _pad_batch(key, ts, lanes, sentinel: int):
        """Pad an ingest batch to a power-of-two row count (at least 64):
        a fixed set of batch shapes.  Pad rows carry the out-of-range
        ``sentinel`` key and write nothing."""
        n = int(key.shape[0])
        m = max(64, 1 << (n - 1).bit_length())
        if m != n:
            pad = m - n
            key = torch.cat(
                [key, torch.full((pad,), sentinel, dtype=torch.int32,
                                 device=key.device)]
            )
            ts = torch.cat([ts, ts[-1:].expand(pad)])
            lanes = torch.cat(
                [lanes, lanes.new_zeros((pad, lanes.shape[1]))]
            )
        return key, ts, lanes

    def _route_ingest(self, key_h: np.ndarray, ts_h: np.ndarray,
                      upper: Optional[int] = None):
        """(flat keys, ts, row order) of one (key, ts)-sorted chunk; the
        single-device store keeps the rows as they are."""
        return key_h, ts_h, None

    def _ingest_padded(self, key_h, ts_h, lanes) -> None:
        key_h, ts_h, order = self._route_ingest(key_h, ts_h)
        if order is not None:
            lanes = lanes[torch.as_tensor(order, device=self.device)]
        key, ts, lanes = self._pad_batch(
            as_tensor(key_h, self.device), as_tensor(ts_h, self.device),
            lanes, self._flat_keys,
        )
        self._apply_ingest(key, ts, lanes)

    def _apply_ingest(self, key, ts, lanes) -> None:
        """One fused-ingest call on the flat state (updated in place).  The
        merge-order families go first: their stale-slot reset reads the
        bucket ids from before the batch, which the kernel overwrites."""
        flat = self._flat_state()
        pg.bucket_families_ingest(flat.bagg, key, ts, lanes)
        fused_ingest(
            *flat.arrays(), key, ts, lanes, bucket_size=self.bucket_size,
        )

    # -- secondary-table ingest ----------------------------------------------

    def ingest_table(self, table: str, columns: Dict) -> None:
        """Ingest a (key, ts)-sorted batch of rows into every ring of a
        secondary table (no pre-aggregates: secondary state serves LAST
        JOIN lookups and union windows, both answered from raw rings).  A
        dual-use table on a sharded plane writes its partitioned union
        ring *and* its replicated join slice, each with that ring's own
        lane subset.  Keys outside the table's key domain raise."""
        if table == self.schema.name:
            return self.ingest(columns)
        if table not in self._sec_index:
            raise KeyError(
                f"view {self.view.name!r} does not reference table {table!r}"
            )
        tel = get_telemetry()
        t0 = tel.clock.now()
        sch = self._sec_schemas[table]
        key_h = self._check_range(
            np.asarray(columns[sch.key]).astype(np.int32),
            self.secondary_num_keys[table],
        )
        n = int(key_h.shape[0])
        if n == 0:
            return
        ts_h = np.asarray(columns[sch.ts]).astype(np.int32)
        cols = self._columns(columns)
        rings = self.layout.rings_of(table)
        with tel.tracer.span(
            "ingest", kind="device", table=table, rows=n
        ) as sp:
            for i in rings:
                lanes = self._lanes(cols, self._ring_lane_exprs[i], n)
                self._sec_ring_ingest_padded(i, key_h, ts_h, lanes)
            sp.fence(tuple(self.state.sec[i].cursor for i in rings))
        self._note_freshness(tel, table, n, t0)

    def _route_sec_ingest(self, index: int, key_h: np.ndarray,
                          ts_h: np.ndarray):
        """(flat keys, ts, row order) of a secondary chunk for ring
        ``index``; the single-device store keeps the rows as they are."""
        return key_h, ts_h, None

    def _sec_ring_ingest_padded(self, index: int, key_h, ts_h, lanes) -> None:
        """One ring's ingest of a (key, ts)-sorted chunk, in place."""
        key_h, ts_h, order = self._route_sec_ingest(index, key_h, ts_h)
        if order is not None:
            lanes = lanes[torch.as_tensor(order, device=self.device)]
        key, ts, lanes = self._pad_batch(
            as_tensor(key_h, self.device), as_tensor(ts_h, self.device),
            lanes, self._ring_flat_keys(index),
        )
        st.ring_ingest(self._flat_state().sec[index], key, ts, lanes)

    # -- window masks -------------------------------------------------------------

    def _window_span(self, wa: WindowAgg, ttl: Optional[int] = None) -> int:
        """Effective RANGE lookback: the window size, clamped by the TTL
        of the governing ring (``ttl``; ``None`` falls back to the
        primary's)."""
        ttl = self._ttl if ttl is None else ttl
        if ttl is not None:
            return min(wa.window.size, ttl)
        return wa.window.size

    def _window_mask(self, wa: WindowAgg, ts_buf, valid, ts_q,
                     ttl: Optional[int] = None) -> torch.Tensor:
        ttl = self._ttl if ttl is None else ttl
        not_future = ts_buf <= ts_q[:, None]
        if wa.window.mode == "range":
            lo = ts_q - self._window_span(wa, ttl) + 1
            return valid & not_future & (ts_buf >= lo[:, None])
        # rows mode: the last (size-1) eligible rows; the request row is the
        # size-th.  TTL-expired rows are not eligible.
        eligible = valid & not_future
        if ttl is not None:
            eligible &= ts_buf > (ts_q - ttl)[:, None]
        e32 = eligible.to(torch.int32)
        newer = torch.cumsum(e32.flip(1), 1, dtype=torch.int32).flip(1)
        rank_from_new = newer - e32  # 0 == newest
        return eligible & (rank_from_new < wa.window.size - 1)

    # -- secondary-state lookups ---------------------------------------------

    def _union_gathers(self, state, key, gkey, tables=None):
        """Gather each union table's ring at the request key (shared across
        every union wagg touching that table).

        ``key`` addresses the primary's flat state (shard-major on the
        sharded store), ``gkey`` is the global key: key-partitioned union
        rings are read at ``key``, replicated ones at ``gkey``, with the
        reference's gather semantics (:func:`~repro_torch.core.storage.
        gather_index`: a union table may have fewer keys than the
        primary).  On the single-device store both are the same keys.
        """
        out = {}
        for t in (self._union_tables if tables is None else tables):
            i = self._union_ring_ix[t]
            ring = state.sec[i]
            k = (key if self._ring_plans[i].partitioned
                 else st.gather_index(gkey, ring.num_keys).long())
            out[t] = st.ring_gather(ring, k)
        return out

    def _last_join_vals(
        self, state, ts_q, join_keys, ljoin_order=None, join_col_index=None
    ) -> List[torch.Tensor]:
        """Point-in-time LAST JOIN answers, one (Q,) vector per join.

        The newest secondary row with key == the request's join key and
        ``ts <= request ts``; ties on ts resolve to the latest-ingested row
        (the offline stable (key, ts) sort); no such row gives the join's
        default.  Join keys are not range-checked: they index the join
        ring with the reference's gather semantics.  Joins always read the
        table's replicated join ring (the join slice of a split dual-use
        table).
        """
        out = []
        gathers = {}
        order = self._ljoin_order if ljoin_order is None else ljoin_order
        col_ix = (
            self._join_col_index if join_col_index is None else join_col_index
        )
        for lk in order:
            lj = self.ljoins[lk]
            jk = join_keys[col_ix[lj.on]]
            ring_ix = self._join_ring_ix[lj.table]
            gk = (ring_ix, lj.on)
            if gk not in gathers:
                ring = state.sec[ring_ix]
                gathers[gk] = st.ring_gather(
                    ring, st.gather_index(jk, ring.num_keys).long()
                )
            ts_t, lanes_t, valid_t = gathers[gk]
            g = lanes_t[..., self._ring_lane_of[ring_ix][lj.arg.key]]
            m = valid_t & (ts_t <= ts_q[:, None])
            mx = torch.where(m, ts_t, _TS_MIN).amax(dim=1)
            cand = m & (ts_t == mx[:, None])
            C = ts_t.shape[1]
            pos = C - 1 - torch.argmax(cand.flip(1).to(torch.int32), dim=1)
            val = torch.gather(g, 1, pos[:, None])[:, 0]
            found = m.any(dim=1)
            out.append(torch.where(
                found, val,
                torch.tensor(lj.default, dtype=torch.float32,
                             device=val.device),
            ))
        return out

    # -- the one query path -----------------------------------------------------

    def _max_mid(self, wa: WindowAgg) -> int:
        """Static bound on middle-bucket count for a window, rounded up to
        a multiple of 4 (the extra middles lie past the request's bucket
        and are masked out): every (Q, M) row the bucket fold sums is then
        16-byte aligned, so it needs no padding
        (:func:`~repro_torch.core.aggregates.lane_masked_reduce`)."""
        m = max(
            1,
            min(
                self.num_buckets,
                self._window_span(wa) // self.bucket_size + 1,
            ),
        )
        return -(-m // 4) * 4

    def _uses_buckets(self, wk, bagg: pg.BucketAgg) -> bool:
        """Whether the pre-agg path folds wagg ``wk``'s primary window from
        bucket states: a RANGE window of a bucket-composable spec whose
        state family ``bagg`` persists (extreme / tail need their
        merge-order arrays), and for a union wagg only where its window
        fits the bucket ring."""
        wa = self.waggs[wk]
        spec = agg_spec(wa.agg)
        family_ok = (
            spec.state in ("lanes", "bitmap")
            or (spec.state == "extreme" and bagg.xts is not None)
            or (spec.state == "tail" and bagg.tts is not None)
        )
        return (
            spec.bucket_composable
            and family_ok
            and wa.window.mode == "range"
            and (not wa.union or self._union_preagg.get(wk, False))
        )

    def _preagg_parts(self, wa, state, key, ts_q, ts_buf, valid, lane):
        """Raw boundary-row mask + gathered middle-bucket states for a RANGE
        window: [raw head rows in the oldest partial bucket] + [full
        buckets strictly inside] + [raw tail rows in the request's
        bucket].  An extreme / tail spec also gets its merge-order family
        states gathered (``ext``, else ``None``)."""
        B = self.bucket_size
        nb = self.num_buckets
        bucket_buf = torch.div(ts_buf, B, rounding_mode="floor")
        T = self._window_span(wa)
        lo = ts_q - T + 1
        b_q = torch.div(ts_q, B, rounding_mode="floor")
        b_lo = torch.div(ts_q - T, B, rounding_mode="floor")
        not_future = ts_buf <= ts_q[:, None]
        in_lo = ts_buf >= lo[:, None]
        head_m = (
            valid & not_future & in_lo
            & (bucket_buf == b_lo[:, None]) & (b_lo != b_q)[:, None]
        )
        tail_m = valid & not_future & in_lo & (bucket_buf == b_q[:, None])
        raw = head_m | tail_m

        M = self._max_mid(wa)
        mids = b_lo[:, None] + 1 + torch.arange(
            M, dtype=torch.int32, device=key.device
        )[None, :]
        mvalid = mids < b_q[:, None]
        slots = (mids % nb).long()
        kk = key[:, None]
        stored = state.bagg.bucket[kk, slots]
        ok = mvalid & (stored == mids)
        bagg = state.bagg
        ms = bagg.stats[kk, slots, lane]   # (Q, M, NUM_STATS)
        mb = bagg.bitmap[kk, slots, lane]  # (Q, M)
        ext = None
        fam = agg_spec(wa.agg).state
        if fam == "extreme":
            ext = {"ts": bagg.xts[kk, slots], "pos": bagg.xpos[kk, slots],
                   "val": bagg.xval[kk, slots, lane],      # (Q, M, 2)
                   "has": bagg.xhas[kk, slots]}
        elif fam == "tail":
            ext = {"ts": bagg.tts[kk, slots], "pos": bagg.tpos[kk, slots],
                   "val": bagg.tval[kk, slots, lane],      # (Q, M, T)
                   "valid": bagg.tvalid[kk, slots]}
        return raw, ms, mb, ok, ext

    def _query_pure(self, state: OnlineState, key, ts_q, req_lanes,
                    join_keys, gkey, use_preagg: bool, wagg_order=None,
                    ljoin_order=None, req_lane_of=None, join_col_index=None,
                    groups: int = 1):
        """Generic fold-then-finalize over every window aggregation, then
        the LAST JOINs.

        For each wagg: lift the request row, combine with the primary
        window's fold (raw ring rows, or boundary rows ⊕ bucket states on
        the pre-agg path), combine with each union table's fold, finalize.
        ``state`` has one key axis; ``key`` indexes it, ``gkey`` is the
        global key (replicated union rings) and ``join_keys`` the request's
        join-key columns.  ``wagg_order`` / ``ljoin_order`` restrict the
        aggregations and joins computed, and ``req_lane_of`` /
        ``join_col_index`` map window args and join columns into
        ``req_lanes`` / ``join_keys`` (the reference's per-scenario
        program arguments); ``groups`` as in ``AggSpec.finalize``.
        """
        wagg_order = self._wagg_order if wagg_order is None else wagg_order
        req_lane_of = self._lane_of if req_lane_of is None else req_lane_of
        key = key.long()
        ts_buf, lanes_buf, valid = st.ring_gather(state.ring, key)
        union_tables = tuple(
            t for t in self._union_tables
            if any(t in self.waggs[wk].union for wk in wagg_order)
        )
        sec_gathers = self._union_gathers(
            state, key, gkey, tables=union_tables
        )
        out = []
        for wk in wagg_order:
            wa = self.waggs[wk]
            spec = agg_spec(wa.agg)
            lane = self._lane_of[wa.arg.key]
            g = lanes_buf[..., lane]
            r = req_lanes[:, req_lane_of[wa.arg.key]]
            # merge-order coordinate of the request row: the primary
            # stream (rank = len(union), after every union table), newer
            # than any stored row of the same (ts, stream)
            prim_rank = len(wa.union)
            acc = spec.lift(r, ts_q, prim_rank, _POS_MAX)
            if use_preagg and self._uses_buckets(wk, state.bagg):
                raw, ms, mb, ok, ext = self._preagg_parts(
                    wa, state, key, ts_q, ts_buf, valid, lane
                )
                acc = spec.combine(
                    acc, spec.fold_rows(g, ts_buf, raw, prim_rank)
                )
                acc = spec.combine(acc, spec.fold_buckets(
                    ms, mb, ok, ext=ext, rank=prim_rank))
            else:
                m = self._window_mask(wa, ts_buf, valid, ts_q)
                acc = spec.combine(
                    acc, spec.fold_rows(g, ts_buf, m, prim_rank)
                )
            for rank, t in enumerate(wa.union):
                ts_t, lanes_t, valid_t = sec_gathers[t]
                ring_ix = self._union_ring_ix[t]
                g_t = lanes_t[..., self._ring_lane_of[ring_ix][wa.arg.key]]
                # union rows expire on their own ring's TTL when the layout
                # sets one; else the primary's
                m_t = self._window_mask(
                    wa, ts_t, valid_t, ts_q,
                    ttl=self._ring_plans[ring_ix].ttl,
                )
                acc = spec.combine(acc, spec.fold_rows(g_t, ts_t, m_t, rank))
            out.append(spec.finalize(acc, n=wa.n, groups=groups))
        out.extend(
            self._last_join_vals(
                state, ts_q, join_keys, ljoin_order, join_col_index
            )
        )
        return tuple(out)

    # -- public query -------------------------------------------------------------

    @classmethod
    def create(
        cls,
        view,
        *,
        num_keys: Optional[int] = None,
        num_shards: Optional[int] = None,
        layout: Optional[StoreLayout] = None,
        **store_kwargs,
    ) -> "OnlineFeatureStore":
        """A single-device store, or a :class:`~repro_torch.core.shard.
        ShardedOnlineStore` when ``num_shards`` is given (or the layout
        plans shards)."""
        if layout is not None and layout.num_shards is not None:
            num_shards = layout.num_shards
        if num_shards is not None:
            from repro_torch.core.shard import ShardedOnlineStore

            return ShardedOnlineStore(
                view, num_keys=num_keys, num_shards=num_shards,
                layout=layout, **store_kwargs,
            )
        # the routing flavour exists on the sharded store only; a
        # single-device deployment accepts (and ignores) it, so build(**kw)
        # is uniform
        store_kwargs.pop("device_routing", None)
        return OnlineFeatureStore(
            view, num_keys=num_keys, layout=layout, **store_kwargs
        )

    def compile_program(self, view) -> "QueryProgram":
        """A per-scenario query program for ``view`` against this store's
        (possibly shared, multi-scenario) state."""
        return QueryProgram(self, view)

    def _validate_join_cols(
        self, columns: Dict, program: Optional["QueryProgram"] = None
    ) -> None:
        cols = self._join_cols if program is None else program.join_cols
        view = self.view if program is None else program.view
        for c in cols:
            if c not in columns:
                raise KeyError(
                    f"request rows must carry join-key column {c!r} "
                    f"(LAST JOIN on {c!r} in view {view.name!r})"
                )

    def _request_arrays(
        self, cols: Dict[str, torch.Tensor],
        program: Optional["QueryProgram"] = None,
    ):
        """(key, ts, lanes, join_keys) request tensors.  With a
        ``program``, lanes and join keys are that scenario's: requests need
        only the columns its view references."""
        if program is None:
            lane_exprs, join_cols = None, self._join_cols
        else:
            lane_exprs, join_cols = program.lane_exprs, program.join_cols
        join_keys = tuple(cols[c].to(torch.int32) for c in join_cols)
        return (cols[self.schema.key], cols[self.schema.ts],
                self._lanes(cols, lane_exprs), join_keys)

    def _query_fn(self, mode: str, program: Optional["QueryProgram"] = None):
        """``_query_pure`` in ``mode`` over the program's subset (none: the
        store's whole view)."""
        if program is not None:
            return program.fn(mode)
        return functools.partial(self._query_pure,
                                 use_preagg=(mode != "naive"))

    def _finish_query(
        self, cols, vals, program: Optional["QueryProgram"] = None
    ) -> Dict[str, torch.Tensor]:
        """Window and join answers -> named features via row-level
        post-expressions (named as in the program's view)."""
        if program is None:
            keys = self._wagg_order + self._ljoin_order
            features = self.view.features
        else:
            keys = list(program.wagg_order) + list(program.ljoin_order)
            features = program.view.features
        pre_values = dict(zip(keys, vals))
        return {
            fname: eval_rowlevel(fexpr, cols, pre_values)
            for fname, fexpr in features.items()
        }

    def query(
        self,
        columns: Dict,
        mode: str = "preagg",
        program: Optional["QueryProgram"] = None,
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Compute all view features for a batch of request rows.

        columns: raw request columns incl. key, ts and every LAST JOIN key
        column; (Q,) each.  Returns {feature_name: (Q,) tensor on the
        store's device}.  ``program`` answers with a per-scenario
        :class:`QueryProgram` (:meth:`compile_program`) instead of the
        store's whole view.  ``valid`` optionally masks scheduler padding
        rows and ``route_info`` (dict, filled in place) reports per-shard
        request counts — one shard here.
        """
        tel = get_telemetry()
        self._validate_join_cols(columns, program)
        self._check_range(np.asarray(columns[self.schema.key]))
        if route_info is not None:
            n_real = (
                int(np.asarray(valid, bool).sum())
                if valid is not None
                else len(np.asarray(columns[self.schema.key]))
            )
            route_info["shard_counts"] = np.array([n_real], np.int64)
        cols = self._columns(columns)
        key, ts_q, req_lanes, join_keys = self._request_arrays(cols, program)
        # pad the request to a power-of-two row count (a fixed set of
        # shapes), repeating the last row
        q = int(key.shape[0])
        m = max(16, 1 << (q - 1).bit_length())
        with tel.tracer.span(
            "query.compute", kind="device", mode=mode,
            program=program.view.name if program is not None else "",
            rows=q, padded=m,
        ) as sp:
            if m != q:
                pad = m - q
                key = torch.cat([key, key[-1:].expand(pad)])
                ts_q = torch.cat([ts_q, ts_q[-1:].expand(pad)])
                req_lanes = torch.cat(
                    [req_lanes, req_lanes[-1:].expand(pad, -1)]
                )
                join_keys = tuple(
                    torch.cat([j, j[-1:].expand(pad)]) for j in join_keys
                )
            vals = self._query_fn(mode, program)(
                self._flat_state(), key, ts_q, req_lanes, join_keys, key,
            )
            vals = sp.fence(tuple(v[:q] for v in vals))
        self._note_query(tel, mode, program)
        return self._finish_query(cols, vals, program)

    def _note_query(self, tel, mode: str,
                    program: Optional["QueryProgram"] = None) -> None:
        """Pre-agg hit / fallback counters, one per window aggregation of
        the query (the program's, or the store's); a union aggregation hits
        only where its primary stream composes from the buckets."""
        hits = tel.metrics.counter(
            "preagg_hits_total",
            "window aggs answered from bucket pre-aggregates", "1",
            labels=("agg",),
        )
        falls = tel.metrics.counter(
            "preagg_fallback_total",
            "window aggs falling back to the raw ring fold", "1",
            labels=("agg",),
        )
        order = self._wagg_order if program is None else program.wagg_order
        for wk in order:
            hit = mode != "naive" and self._uses_buckets(wk, self.state.bagg)
            (hits if hit else falls).inc(agg=self.waggs[wk].agg.value)

    # -- accounting ---------------------------------------------------------------

    def _rings(self, state: Optional[OnlineState] = None):
        """(ring, plan) of the primary and every secondary ring of
        ``state`` (default: the public state)."""
        state = self.state if state is None else state
        yield state.ring, self.layout.primary
        yield from zip(state.sec, self._ring_plans)

    def ingest_row_counts(self) -> Dict[str, int]:
        """Rows stored per table, summed over all state (from ring
        cursors, so counts are rows *ever ingested*, not current capacity).

        On a sharded store a key-partitioned table counts each row once
        (rows live on exactly one shard) while a replicated LAST JOIN
        target counts ``num_shards`` x, the reference's one copy per shard:
        the counts read the ``(S, K)`` view of the cursors, although the
        card holds one copy of a replicated ring.  A split dual-use table
        counts its partitioned union part once plus ``num_shards`` x its
        replicated join slice.
        """
        counts: Dict[str, int] = {}
        for ring, plan in self._rings():
            counts[plan.table] = counts.get(plan.table, 0) + int(
                ring.cursor.sum())
        return counts

    def ring_row_counts(self) -> Dict[Tuple[str, str], np.ndarray]:
        """Per-ring stored row totals, keyed ``(table, placement)``: one
        total per ring on a single-device store, a per-shard vector on a
        sharded one (a replicated ring's S entries read its one copy)."""
        return {
            (plan.table, "partitioned" if plan.partitioned else "replicated"):
                ring.cursor.sum(-1).cpu().numpy()
            for ring, plan in self._rings()
        }

    def _copies(self, plan) -> int:
        """Copies of a ring the reference holds: one on a single device."""
        return 1

    def record_gauges(self) -> None:
        """Publish pull-style state gauges into the installed telemetry:
        per-ring occupancy (stored rows / capacity), capacity-evicted row
        totals, and — where the layout sets a TTL — how many stored rows
        are already past it (logically expired, serving no window).

        The values are the reference's, whose sharded store holds a
        replicated ring once per shard: they are taken on the one copy
        (``_flat_state``) and scaled by :meth:`_copies`.  Call at scrape
        time; gauges reflect the store *now*.
        """
        m = get_telemetry().metrics
        for ring, plan in self._rings(self._flat_state()):
            table = plan.table
            placement = "partitioned" if plan.partitioned else "replicated"
            copies = self._copies(plan)
            cur = ring.cursor.long()                 # (K,)
            C = int(ring.ts.shape[-1])
            stored = copies * int(cur.clamp(max=C).sum())
            cap = copies * cur.numel() * C
            m.gauge(
                "ring_occupancy_ratio", "stored rows / ring capacity", "1",
                labels=("table", "placement"),
            ).set(float(stored) / max(cap, 1),
                  table=table, placement=placement)
            m.gauge(
                "ring_evicted_rows_total",
                "rows overwritten by ring wraparound (capacity eviction)",
                "1", labels=("table", "placement"),
            ).set(float(copies * int((cur - C).clamp(min=0).sum())),
                  table=table, placement=placement)
            if plan.ttl:
                valid = (torch.arange(C, device=cur.device)
                         < cur[:, None])             # (K, C)
                expired = 0
                if bool(valid.any()):
                    now_ts = int(ring.ts[valid].max())
                    expired = copies * int(
                        (valid & (ring.ts < now_ts - int(plan.ttl))).sum())
                m.gauge(
                    "ring_ttl_expired_rows",
                    "stored rows older than the layout TTL", "1",
                    labels=("table",),
                ).set(float(expired), table=table)


class QueryProgram:
    """One scenario's query against a shared store.

    The multi-scenario plane (:mod:`repro_torch.core.scenario`) deploys N
    feature views on ONE store whose lane plan is the union of every
    view's window arguments.  A QueryProgram is the per-view slice of that
    store: the view's window aggregations and LAST JOINs as subsets of the
    store's, so a query through it gathers and folds only the lanes its
    view references.  Requests carry only that view's columns: its lanes
    and join keys get their own request layout, while stored-state lane
    ids stay the shared layout's.

    Every (wagg, ljoin) key of the view must exist in the store; the
    store's answers through a program equal, bit for bit, a dedicated
    single-view store fed the same stream.  The port runs programs
    eagerly: :meth:`fn` is the store's ``_query_pure`` with the subset
    bound, where the reference jits it.
    """

    def __init__(self, store: OnlineFeatureStore, view):
        exprs = list(view.features.values())
        self.view = view
        waggs = collect_window_aggs(exprs)
        ljoins = collect_last_joins(exprs)
        self.wagg_order: Tuple[Tuple, ...] = tuple(waggs.keys())
        self.ljoin_order: Tuple[Tuple, ...] = tuple(ljoins.keys())
        missing = [k for k in self.wagg_order if k not in store.waggs]
        missing += [k for k in self.ljoin_order if k not in store.ljoins]
        if missing:
            raise ValueError(
                f"view {view.name!r} is not a sub-view of store view "
                f"{store.view.name!r}: {len(missing)} aggregation(s)/join(s) "
                f"missing from the shared lane plan (first: {missing[0]!r})"
            )
        self.lane_exprs: List[Expr] = []
        self.req_lane_of: Dict[Tuple, int] = {}
        for wa in waggs.values():
            if wa.arg.key not in self.req_lane_of:
                self.req_lane_of[wa.arg.key] = len(self.lane_exprs)
                self.lane_exprs.append(wa.arg)
        self.join_cols: Tuple[str, ...] = ()
        for lj in ljoins.values():
            if lj.on not in self.join_cols:
                self.join_cols += (lj.on,)
        self.join_col_index = {c: i for i, c in enumerate(self.join_cols)}
        subset = dict(
            wagg_order=self.wagg_order,
            ljoin_order=self.ljoin_order,
            req_lane_of=self.req_lane_of,
            join_col_index=self.join_col_index,
        )
        self._fns = {
            use_preagg: functools.partial(
                store._query_pure, use_preagg=use_preagg, **subset)
            for use_preagg in (False, True)
        }

    def fn(self, mode: str):
        """The store's query over this program's subset, in ``mode``."""
        return self._fns[mode != "naive"]

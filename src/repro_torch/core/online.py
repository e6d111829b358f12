"""Online feature store — FeatInsight's request-mode serving path.

OpenMLDB request mode: a request row (key, ts, values) arrives; the service
computes every feature of the view *as if that row were appended* to its
key's history.  The row may then be ingested.  Offline↔online consistency
means: the online answer for row i after ingesting rows 0..i-1 equals the
offline batch answer at row i.

Every aggregate's semantics come from the one registry in
:mod:`repro_torch.core.aggregates`; a query is one generic dataflow:

    lift(request row) ⊕ fold(window rows) → finalize

with two ways to fold a RANGE window:

* ``naive``  — masked fold over the raw ring (O(C) per query);
* ``preagg`` — raw boundary rows ⊕ per-bucket partial states
  (O(C_boundary + NB)), the paper's long-window optimization.

Ingest applies a (key, ts)-sorted batch to the ring and the bucket store in
one call of the fused ingest kernel (:mod:`repro_torch.kernels.ingest`),
updating the device state in place.

This is the single-table slice of the reference package's
``repro.core.online``: views with LAST JOIN or WINDOW UNION, and layouts
that persist the merge-order bucket families (FIRST / LAST / TOPN_FREQ
over RANGE windows), raise ``NotImplementedError`` at construction.
State lives on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["OnlineState", "OnlineFeatureStore"]

_POS_MAX = 2147483647


@dataclasses.dataclass
class OnlineState:
    """All device state of one view's online store: the primary ring and
    its bucket pre-aggregates.  A sharded store keeps a leading shard axis
    on every tensor, ``(S, K_local, ...)``."""

    ring: st.RingStore
    bagg: pg.BucketAgg

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
                ttl=ttl,
                table_capacity=table_capacity,
                table_ttl=table_ttl,
            )
        self._apply_layout(view, layout)
        self.state = self._init_state()

    # -- layout consumption ---------------------------------------------------

    def _apply_layout(self, view, layout: StoreLayout) -> None:
        """Derive every layout-dependent attribute from the plan."""
        exprs = list(view.features.values())
        if layout.tables or collect_last_joins(exprs):
            raise NotImplementedError(
                f"view {view.name!r} reads secondary tables (LAST JOIN / "
                "WINDOW UNION); multi-table views are not ported yet"
            )
        self.view = view
        self.schema = view.schema
        self.layout = layout
        self.num_keys = layout.primary.ring_keys
        self.capacity = layout.primary.capacity
        self.num_buckets = layout.bucket.num_buckets
        self.bucket_size = layout.bucket.bucket_size
        self._ttl = layout.primary.ttl

        self.waggs: Dict[Tuple, WindowAgg] = collect_window_aggs(exprs)
        self._wagg_order: List[Tuple] = list(self.waggs.keys())
        if layout.bucket.extreme or layout.bucket.tail:
            names = sorted({
                wa.agg.value for wa in self.waggs.values()
                if wa.window.mode == "range"
                and agg_spec(wa.agg).state in ("extreme", "tail")
            })
            raise NotImplementedError(
                f"view {view.name!r}: {names} over RANGE windows need the "
                "merge-order bucket families, which are not ported yet"
            )

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
        for wk, wa in self.waggs.items():
            if wa.window.mode == "range":
                need = self._window_span(wa) // self.bucket_size + 2
                if need > self.num_buckets:
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

    @property
    def _flat_keys(self) -> int:
        """Rows of the flat (key-addressed) state: all keys of all shards."""
        return self.num_keys

    @property
    def _key_upper(self) -> int:
        """Size of the key domain callers address."""
        return self.num_keys

    def _check_range(self, key: np.ndarray) -> np.ndarray:
        """Keys outside [0, K) are rejected: they would address another
        key's state (or none)."""
        key = np.asarray(key)
        upper = self._key_upper
        if key.size and (key.min() < 0 or key.max() >= upper):
            raise ValueError(
                f"key out of range [0, {upper}): [{key.min()}, {key.max()}]"
            )
        return key

    def _init_state(self) -> OnlineState:
        lay = self.layout
        return self._shape_state(OnlineState(
            ring=st.ring_init(
                self._flat_keys, lay.primary.capacity, self.num_lanes,
                self.device,
            ),
            bagg=pg.bucket_init_plan(
                lay.bucket, self._flat_keys, self.num_lanes, self.device
            ),
        ))

    def _shape_state(self, flat: OnlineState) -> OnlineState:
        """The public state shape of a flat state (identity here; the
        sharded store splits the key axis into (S, K_local))."""
        return flat

    def _flat_state(self) -> OnlineState:
        """The state with one key axis over all keys: the tensors the
        kernels and the query address (views of ``self.state``)."""
        return self.state

    # -- columns and lanes ------------------------------------------------------

    def _columns(self, columns: Dict) -> Dict[str, torch.Tensor]:
        """Request / ingest columns as canonical tensors on the device."""
        return {c: as_tensor(v, self.device) for c, v in columns.items()}

    def _lanes(self, cols: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(N, L) materialized window-arg lanes from raw columns."""
        if not self._lane_exprs:
            n = cols[self.schema.key].shape[0]
            return torch.zeros((n, 1), dtype=torch.float32, device=self.device)
        vals = [
            eval_rowlevel(e, cols, {}).to(torch.float32)
            for e in self._lane_exprs
        ]
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

    def _route_ingest(self, key_h: np.ndarray, ts_h: np.ndarray):
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
        """One fused-ingest call on the flat state (updated in place)."""
        fused_ingest(
            *self._flat_state().arrays(), key, ts, lanes,
            bucket_size=self.bucket_size,
        )

    # -- window masks -------------------------------------------------------------

    def _window_span(self, wa: WindowAgg) -> int:
        """Effective RANGE lookback: the window size, clamped by the TTL."""
        if self._ttl is not None:
            return min(wa.window.size, self._ttl)
        return wa.window.size

    def _window_mask(self, wa: WindowAgg, ts_buf, valid, ts_q) -> torch.Tensor:
        not_future = ts_buf <= ts_q[:, None]
        if wa.window.mode == "range":
            lo = ts_q - self._window_span(wa) + 1
            return valid & not_future & (ts_buf >= lo[:, None])
        # rows mode: the last (size-1) eligible rows; the request row is the
        # size-th.  TTL-expired rows are not eligible.
        eligible = valid & not_future
        if self._ttl is not None:
            eligible &= ts_buf > (ts_q - self._ttl)[:, None]
        e32 = eligible.to(torch.int32)
        newer = torch.cumsum(e32.flip(1), 1, dtype=torch.int32).flip(1)
        rank_from_new = newer - e32  # 0 == newest
        return eligible & (rank_from_new < wa.window.size - 1)

    # -- the one query path -----------------------------------------------------

    def _max_mid(self, wa: WindowAgg) -> int:
        """Static bound on middle-bucket count for a window."""
        return max(
            1,
            min(
                self.num_buckets,
                self._window_span(wa) // self.bucket_size + 1,
            ),
        )

    def _preagg_parts(self, wa, state, key, ts_q, ts_buf, valid, lane):
        """Raw boundary-row mask + gathered middle-bucket states for a RANGE
        window: [raw head rows in the oldest partial bucket] + [full
        buckets strictly inside] + [raw tail rows in the request's
        bucket]."""
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
        ms = state.bagg.stats[kk, slots, lane]   # (Q, M, NUM_STATS)
        mb = state.bagg.bitmap[kk, slots, lane]  # (Q, M)
        return raw, ms, mb, ok

    def _query_pure(self, state: OnlineState, key, ts_q, req_lanes,
                    use_preagg: bool, groups: int = 1):
        """Generic fold-then-finalize over every window aggregation of the
        view: lift the request row, combine with the window's fold (raw
        ring rows, or boundary rows ⊕ bucket states on the pre-agg path),
        finalize.  ``state`` has one key axis; ``key`` indexes it."""
        key = key.long()
        ts_buf, lanes_buf, valid = st.ring_gather(state.ring, key)
        out = []
        for wk in self._wagg_order:
            wa = self.waggs[wk]
            spec = agg_spec(wa.agg)
            lane = self._lane_of[wa.arg.key]
            g = lanes_buf[..., lane]
            r = req_lanes[:, lane]
            # merge-order coordinate of the request row: primary stream,
            # newer than any stored row of the same ts
            acc = spec.lift(r, ts_q, 0, _POS_MAX)
            use_buckets = (
                use_preagg
                and spec.bucket_composable
                and spec.state in ("lanes", "bitmap")
                and wa.window.mode == "range"
            )
            if use_buckets:
                raw, ms, mb, ok = self._preagg_parts(
                    wa, state, key, ts_q, ts_buf, valid, lane
                )
                acc = spec.combine(acc, spec.fold_rows(g, ts_buf, raw, 0))
                acc = spec.combine(acc, spec.fold_buckets(ms, mb, ok))
            else:
                m = self._window_mask(wa, ts_buf, valid, ts_q)
                acc = spec.combine(acc, spec.fold_rows(g, ts_buf, m, 0))
            out.append(spec.finalize(acc, n=wa.n, groups=groups))
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
        return OnlineFeatureStore(
            view, num_keys=num_keys, layout=layout, **store_kwargs
        )

    def _request_arrays(self, cols: Dict[str, torch.Tensor]):
        """(key, ts, lanes) request tensors."""
        return cols[self.schema.key], cols[self.schema.ts], self._lanes(cols)

    def _finish_query(self, cols, vals) -> Dict[str, torch.Tensor]:
        """Window answers -> named features via row-level post-expressions."""
        pre_values = dict(zip(self._wagg_order, vals))
        return {
            fname: eval_rowlevel(fexpr, cols, pre_values)
            for fname, fexpr in self.view.features.items()
        }

    def query(
        self,
        columns: Dict,
        mode: str = "preagg",
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Compute all view features for a batch of request rows.

        columns: raw request columns incl. key and ts; (Q,) each.  Returns
        {feature_name: (Q,) tensor on the store's device}.  ``valid``
        optionally masks scheduler padding rows and ``route_info`` (dict,
        filled in place) reports per-shard request counts — one shard
        here.
        """
        tel = get_telemetry()
        self._check_range(np.asarray(columns[self.schema.key]))
        if route_info is not None:
            n_real = (
                int(np.asarray(valid, bool).sum())
                if valid is not None
                else len(np.asarray(columns[self.schema.key]))
            )
            route_info["shard_counts"] = np.array([n_real], np.int64)
        cols = self._columns(columns)
        key, ts_q, req_lanes = self._request_arrays(cols)
        # pad the request to a power-of-two row count (a fixed set of
        # shapes), repeating the last row
        q = int(key.shape[0])
        m = max(16, 1 << (q - 1).bit_length())
        with tel.tracer.span(
            "query.compute", kind="device", mode=mode, program="",
            rows=q, padded=m,
        ) as sp:
            if m != q:
                pad = m - q
                key = torch.cat([key, key[-1:].expand(pad)])
                ts_q = torch.cat([ts_q, ts_q[-1:].expand(pad)])
                req_lanes = torch.cat(
                    [req_lanes, req_lanes[-1:].expand(pad, -1)]
                )
            vals = self._query_pure(
                self._flat_state(), key, ts_q, req_lanes,
                use_preagg=(mode != "naive"),
            )
            vals = sp.fence(tuple(v[:q] for v in vals))
        self._note_query(tel, mode)
        return self._finish_query(cols, vals)

    def _note_query(self, tel, mode: str) -> None:
        """Pre-agg hit / fallback counters, one per window aggregation."""
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
        for wa in self.waggs.values():
            spec = agg_spec(wa.agg)
            hit = (
                mode != "naive"
                and spec.bucket_composable
                and spec.state in ("lanes", "bitmap")
                and wa.window.mode == "range"
            )
            (hits if hit else falls).inc(agg=wa.agg.value)

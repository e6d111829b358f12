"""Sharded online serving plane — key-partitioned feature state.

A :class:`ShardedOnlineStore` keeps one primary ring + bucket store *per
shard*, as tensors with a leading shard axis ``(S, K_local, ...)`` on one
device (the public shape, the same as the reference package's
``repro.core.shard`` state).  Keys route through a
:class:`~repro_torch.core.hashing.KeyPermutation` (Feistel bijection):
``shard = perm(key) % S``, ``local = perm(key) // S``.

The reference vmaps one per-shard program over the shard axis.  Here the
shard axis is folded into the key axis instead: the state tensors are
contiguous, so ``state.flatten(0, 1)`` addresses key ``local`` of shard
``s`` as flat key ``s * K_local + local``.  Per-key state depends only on
that key's rows and their order, so

* **ingest** routes a (key, ts)-sorted chunk on the host (shard, local id,
  per-shard (local, ts) sort), lays the shards' rows end to end with flat
  keys — still (key, ts)-sorted — and applies them with ONE fused-ingest
  kernel launch for all shards;
* **the device-routed request path** keeps the reference's dataflow:
  Feistel shard id and rank within the shard on the device (on the card
  one launch of the route kernel, which walks every key home; on the CPU
  a fixed number of walk passes and the rank's plain version), then the
  scatter into the ``(S, B)`` per-shard grid, then the per-shard query —
  the single-store query over the ``S·B`` grid rows with flat keys — then
  the gather back to request order.  The optimistic per-shard capacity
  ``B ≈ 2·ceil(N/S)`` is checked by an on-device overflow flag;
  pathological skew re-dispatches once at the always-safe ``B = N``.  The
  overflow flag (and on the CPU the walk's "still walking" flag, which
  re-dispatches once the walk is finished) comes back in one host read
  per batch.

Answers do not depend on the shard count: per-key state depends only on
that key's rows and their order.  The host-routed oracle path, the
multi-scenario ``route_and_query`` and raw-modulo routing
(``hash_routing=False``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import KeyPermutation
from repro_torch.core.layout import StoreLayout, plan_layout
from repro_torch.core.online import OnlineFeatureStore, OnlineState
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.kernels.route.ops import route_keys, route_rank
from repro_torch.obs import get_telemetry

__all__ = ["ShardedOnlineStore"]


def _split(t: torch.Tensor, S: int) -> torch.Tensor:
    return t.view((S, t.shape[0] // S) + tuple(t.shape[1:]))


class ShardedOnlineStore(OnlineFeatureStore):
    """Drop-in :class:`OnlineFeatureStore` whose state is key-partitioned
    across ``num_shards`` shards.  ``num_keys`` is the *global* key count;
    per-shard tables hold ``ceil(K/S)`` keys."""

    def __init__(
        self,
        view,  # repro_torch.core.view.FeatureView
        num_keys: Optional[int] = None,
        num_shards: int = 1,
        capacity: int = 256,
        num_buckets: int = 64,
        bucket_size: int = 64,
        ttl: Optional[int] = None,
        table_capacity: Optional[Dict[str, int]] = None,
        table_ttl: Optional[Dict[str, int]] = None,
        layout: Optional[StoreLayout] = None,
        device="cuda",
    ):
        if layout is None:
            if num_keys is None:
                raise ValueError("ShardedOnlineStore needs num_keys or layout")
            layout = plan_layout(
                [view],
                num_keys=num_keys,
                capacity=capacity,
                num_buckets=num_buckets,
                bucket_size=bucket_size,
                num_shards=num_shards,
                ttl=ttl,
                table_capacity=table_capacity,
                table_ttl=table_ttl,
            )
        if layout.num_shards is None:
            raise ValueError(
                "ShardedOnlineStore needs a sharded layout "
                "(plan_layout(..., num_shards=S))"
            )
        super().__init__(view, layout=layout, device=device)

    # -- layout consumption ----------------------------------------------------

    def _apply_layout(self, view, layout: StoreLayout) -> None:
        if layout.num_shards < 1:
            raise ValueError(
                f"sharded store needs num_shards >= 1, got {layout.num_shards}"
            )
        if not layout.hash_routing:
            raise NotImplementedError(
                "raw modulo routing (hash_routing=False) is not ported yet"
            )
        self.num_shards = int(layout.num_shards)
        self.global_num_keys = layout.num_keys
        self._perm = KeyPermutation(layout.perm_domain)
        super()._apply_layout(view, layout)

    @property
    def _flat_keys(self) -> int:
        return self.num_shards * self.num_keys

    def _shape_state(self, flat: OnlineState) -> OnlineState:
        S = self.num_shards
        return OnlineState(
            ring=st.RingStore(*(_split(t, S) for t in (
                flat.ring.ts, flat.ring.vals, flat.ring.cursor))),
            bagg=pg.BucketAgg(
                *(_split(t, S) for t in (
                    flat.bagg.stats, flat.bagg.bitmap, flat.bagg.bucket)),
                size=flat.bagg.size,
            ),
        )

    def _flat_state(self) -> OnlineState:
        s = self.state
        return OnlineState(
            ring=st.RingStore(*(t.flatten(0, 1) for t in (
                s.ring.ts, s.ring.vals, s.ring.cursor))),
            bagg=pg.BucketAgg(
                *(t.flatten(0, 1) for t in (
                    s.bagg.stats, s.bagg.bitmap, s.bagg.bucket)),
                size=s.bagg.size,
            ),
        )

    # -- routing ---------------------------------------------------------------

    @property
    def _key_upper(self) -> int:
        return self.global_num_keys

    def _route_ids(self, key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic key -> (shard id, shard-local id), host-side."""
        routed = self._perm(self._check_range(key))
        return routed % self.num_shards, routed // self.num_shards

    def shard_of(self, key: np.ndarray) -> np.ndarray:
        """Deterministic key -> shard id (host-side; range-checked)."""
        return self._route_ids(key)[0]

    # -- ingest ----------------------------------------------------------------

    def _route_ingest(self, key_h: np.ndarray, ts_h: np.ndarray):
        """Flat keys, ts and row order of one (key, ts)-sorted chunk: the
        shards' rows end to end, each shard's in (local key, ts) order (a
        stable sort, so same-key rows keep their arrival order; the
        Feistel permutation scrambles key order, so each shard re-sorts)."""
        shard, local = self._route_ids(key_h)
        order = np.lexsort((ts_h, local, shard))
        flat = shard[order] * self.num_keys + local[order]
        return flat.astype(np.int32), ts_h[order], order

    # -- fused device-resident request path ------------------------------------

    def _route_bucket(self, m: int) -> int:
        """Optimistic per-shard grid capacity for an m-row batch: twice
        the even-split share, power-of-two, floored at 16 and capped at m
        (the always-safe bound)."""
        per = -(-m // self.num_shards)
        b = 1 << max(2 * per - 1, 0).bit_length()
        cap = 1 << max(m - 1, 0).bit_length()
        return int(min(max(16, b), max(cap, 1)))

    def _route_routed(self, routed, valid):
        """The CPU's routing of walked ids: (local, shard, rank, counts,
        valid counts).  An unfinished walk leaves ids past the domain;
        ``local`` is clamped so the state is never addressed out of bounds
        (that dispatch's answers are recomputed once the walk finishes)."""
        S = self.num_shards
        shard = routed % S
        local = torch.clamp(routed // S, max=self.num_keys - 1)
        rank, counts = route_rank(shard, num_shards=S)
        scounts = torch.zeros(S, dtype=torch.int32, device=routed.device)
        scounts.index_add_(0, shard.long(), valid.to(torch.int32))
        return local, shard, rank, counts, scounts

    def _route_query(self, route, ts_q, lanes, *, bucket: int,
                     use_preagg: bool):
        """Scatter, answer, gather — all on the device, from a routed batch
        (``route_keys`` on the card, ``_route_routed`` on the CPU).

        Returns (answers in request order, overflow flag).  Unscattered
        grid slots hold zeros — local key 0 of each shard, a read-only
        recompute that no row gathers.
        """
        S, B = self.num_shards, bucket
        local, shard, rank, counts = route[:4]
        dev = shard.device
        overflow = (counts > B).any()
        slot = torch.clamp(rank, max=B - 1)
        # grid row of each request row; rows past the capacity go to a
        # spare row past the grid (dropped)
        row = torch.where(rank < B, shard * B + rank, S * B).long()

        def to_grid(arr):
            g = arr.new_zeros((S * B + 1,) + tuple(arr.shape[1:]))
            g[row] = arr
            return g[: S * B]

        base = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(B)
        fkey = base * self.num_keys + to_grid(local)
        vals = self._query_pure(
            self._flat_state(), fkey, to_grid(ts_q), to_grid(lanes),
            use_preagg=use_preagg, groups=S,
        )
        back = (shard * B + slot).long()
        return tuple(v[back] for v in vals), overflow

    def _note_route(self, tel, n_rows: int, q: int, bucket: int) -> None:
        """Routing telemetry: rows routed plus the shard-layer padding."""
        pad_rows = self.num_shards * bucket - q
        m = tel.metrics
        m.counter(
            "route_rows_total",
            "request rows routed to shards, per routing path", "1",
            labels=("path",),
        ).inc(int(n_rows), path="device")
        m.counter(
            "padding_rows_total", "filler rows added to reach shape bucket",
            "1", labels=("layer",),
        ).inc(pad_rows, layer="shard")
        m.gauge(
            "padding_waste_ratio", "filler rows / bucket rows, last batch",
            "1", labels=("layer",),
        ).set(pad_rows / max(self.num_shards * bucket, 1), layer="shard")

    @staticmethod
    def _pad_request(key, ts_q, lanes, valid):
        """Pad request tensors to a power-of-two row count (at least 16) by
        repeating the last row; ``valid`` marks the filler False."""
        q = int(key.shape[0])
        m = max(16, 1 << max(q - 1, 0).bit_length())
        if m != q:
            pad = m - q
            key = torch.cat([key, key[-1:].expand(pad)])
            ts_q = torch.cat([ts_q, ts_q[-1:].expand(pad)])
            lanes = torch.cat([lanes, lanes[-1:].expand(pad, -1)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        return key, ts_q, lanes, valid, m

    def _route_dispatch(self, tel, mode, key, ts_q, lanes, valid, m, q):
        """One device-routed dispatch under the ``route.device`` span, plus
        the rare re-dispatches (Feistel walk not finished, per-shard
        capacity overflow) inside the same span."""
        B = self._route_bucket(m)
        use_preagg = mode != "naive"
        with tel.tracer.span(
            "route.device", kind="device", mode=mode, program="",
            rows=q, padded=m, bucket=B, shards=self.num_shards,
        ) as sp:
            if key.is_cuda:
                # one launch: every key walked home, shard, local, ranks,
                # counts (no walk flag)
                route = route_keys(key, valid, self._perm,
                                   num_shards=self.num_shards)
                walking = None
            else:
                # the fixed device walk passes and a "still walking" flag
                routed, walking = self._perm.device_call(key)
                route = self._route_routed(routed, valid)
            vals, ovf = self._route_query(
                route, ts_q, lanes, bucket=B, use_preagg=use_preagg
            )
            # the one host read of the batch: the overflow flag (and on the
            # CPU the walk's)
            flags = [ovf] if walking is None else [ovf, walking]
            ovf_h, *walking_h = torch.stack(flags).tolist()
            if any(walking_h):
                route = self._route_routed(
                    self._perm.finish_walk(routed), valid)
                vals, ovf = self._route_query(
                    route, ts_q, lanes, bucket=B, use_preagg=use_preagg,
                )
                ovf_h = bool(ovf)
            if ovf_h:
                B = 1 << max(m - 1, 0).bit_length()
                vals, _ = self._route_query(
                    route, ts_q, lanes, bucket=B, use_preagg=use_preagg,
                )
            vals, scounts = sp.fence(vals, route[4])
        scounts_h = scounts.cpu().numpy().astype(np.int64)
        self._note_route(tel, int(scounts_h.sum()), q, B)
        self._note_query(tel, mode)
        return vals, scounts_h

    def query(
        self,
        columns: Dict,
        mode: str = "preagg",
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Answer a request batch in input row order through the
        device-routed path (same contract as the base store).

        ``route_info`` (dict, filled in place) receives the batch's
        valid-masked per-shard request counts (``"shard_counts"``),
        computed on the device while routing.
        """
        tel = get_telemetry()
        key_h = self._check_range(
            np.asarray(columns[self.schema.key]).astype(np.int32, copy=False)
        )
        q = int(key_h.shape[0])
        with tel.tracer.span("query.route", mode=mode, program="", rows=q):
            cols = self._columns(columns)
            key, ts_q, lanes = self._request_arrays(cols)
            vmask = (
                np.ones(q, bool) if valid is None
                else np.asarray(valid, bool)[:q]
            )
            key_p, ts_p, lanes_p, valid_p, m = self._pad_request(
                key, ts_q, lanes, torch.as_tensor(vmask, device=self.device)
            )
        vals, scounts = self._route_dispatch(
            tel, mode, key_p, ts_p, lanes_p, valid_p, m, q
        )
        if route_info is not None:
            route_info["shard_counts"] = scounts
        with tel.tracer.span("query.scatter", rows=q):
            out = self._finish_query(cols, tuple(v[:q] for v in vals))
        return out

"""Sharded online serving plane — key-partitioned feature state.

A :class:`ShardedOnlineStore` keeps one primary ring + bucket store, and
one ring per secondary ring plan, *per shard*, as tensors with a leading
shard axis ``(S, K_local, ...)`` on one device (the public shape, the same
as the reference package's ``repro.core.shard`` state).  By default keys
route through a :class:`~repro_torch.core.hashing.KeyPermutation`
(Feistel bijection): ``shard = perm(key) % S``, ``local = perm(key) // S``;
``hash_routing=False`` routes raw keys, ``shard = key % S``,
``local = key // S``.

Placement comes from the layout plan (:mod:`repro_torch.core.layout`):

* the primary and every union-stream ring (a union-only table, the union
  half of a split dual-use table) are partitioned: a key's rows live on
  the shard that answers its requests;
* LAST JOIN rings (a join-only table, the join slice of a dual-use table)
  are replicated: join keys are arbitrary request columns.  The reference
  holds S identical replicas, one per device; on one device that costs S
  times the memory and buys nothing, so this store keeps **one** copy and
  shows the reference's ``(S, K_t, ...)`` shape as a view expanded with
  stride 0.  Each ingest writes it once.

The reference vmaps one per-shard program over the shard axis.  Here the
shard axis is folded into the key axis instead: the state tensors are
contiguous, so ``state.flatten(0, 1)`` addresses key ``local`` of shard
``s`` as flat key ``s * K_local + local`` (partitioned rings share that
flat key space; the one copy of a replicated ring is addressed by its
global key).  Per-key state depends only on that key's rows and their
order, so

* **ingest** routes a (key, ts)-sorted chunk on the host (shard, local id,
  each shard's rows in (local, ts) order), lays the shards' rows end to
  end with flat keys — still (key, ts)-sorted — and applies them with ONE
  fused-ingest kernel launch for all shards.  A partitioned secondary
  ring routes the same way, range-checked against its own table's key
  count; a replicated ring takes the rows as they are.
* **the device-routed request path** (``device_routing=True``, the
  default) keeps the reference's dataflow: shard id and rank within the
  shard on the device — on the card one launch of the route kernel, from
  keys under hash routing (it walks every key home) or from the shard ids
  ``key % S`` under modulo routing; on the CPU a fixed number of walk
  passes and the rank's plain version — then the scatter into the
  ``(S, B)`` per-shard grid (flat local keys, ts, lanes, the join keys
  that join rings read, and the global key where a replicated union ring
  reads it),
  the single-store query over the ``S·B`` grid rows, and the gather back
  to request order.  The optimistic per-shard capacity ``B ≈ 2·ceil(N/S)``
  is checked by an on-device overflow flag; pathological skew
  re-dispatches once at the always-safe ``B = N``.  The overflow flag (and
  on the CPU the walk's "still walking" flag) comes back in one host read
  per batch.
* **the host-routed request path** (``device_routing=False``, the
  correctness oracle) buckets rows by shard on the host
  (:func:`build_route`), pads every shard to one power-of-two bucket,
  answers the ``S·B`` grid rows in one query and scatters the answers back
  to request order on the host.  Only a caller picks it: nothing falls
  back to it.

Both paths serve a per-scenario :class:`~repro_torch.core.online.
QueryProgram` (``query(..., program=)``).  A MIXED multi-scenario batch
takes the device-routed path through :meth:`ShardedOnlineStore.
route_and_query`: one dispatch computes the merged view's whole
aggregation set for every row, and the rows' scenario ids give the
valid-masked per-(scenario, shard) counts, an int32 scatter-add over
``scen * S + shard`` beside the route kernel.

Answers do not depend on the shard count or the routing path: per-key
state depends only on that key's rows and their order, and each answer
only on its own row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import KeyPermutation
from repro_torch.core.layout import StoreLayout, plan_layout
from repro_torch.core.online import OnlineFeatureStore, OnlineState
from repro_torch.core import storage as st
from repro_torch.kernels.route.ops import route_keys, route_rank
from repro_torch.obs import get_telemetry

__all__ = ["RoutePlan", "build_route", "ShardedOnlineStore"]


@dataclasses.dataclass
class RoutePlan:
    """Host-side routing of one request/ingest batch across shards.

    ``idx[s]`` holds the batch row indices owned by shard ``s`` (in batch
    order, so per-key row order is preserved); ``bucket`` is the padded
    per-shard batch size (a shared power of two).
    """

    idx: List[np.ndarray]
    bucket: int

    @property
    def counts(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.idx], np.int64)


def build_route(
    shard: np.ndarray, num_shards: int, min_bucket: int = 16
) -> RoutePlan:
    """Bucket batch rows by shard id and pick the padded shape bucket."""
    shard = np.asarray(shard)
    idx = [np.nonzero(shard == s)[0] for s in range(num_shards)]
    longest = max((len(ix) for ix in idx), default=0)
    bucket = max(min_bucket, 1 << max(longest - 1, 0).bit_length())
    return RoutePlan(idx=idx, bucket=bucket)


def _split(t: torch.Tensor, S: int) -> torch.Tensor:
    return t.view((S, t.shape[0] // S) + tuple(t.shape[1:]))


class ShardedOnlineStore(OnlineFeatureStore):
    """Drop-in :class:`OnlineFeatureStore` whose state is key-partitioned
    across ``num_shards`` shards.  ``num_keys`` and
    ``secondary_num_keys`` are *global* key counts; per-shard tables hold
    ``ceil(K/S)`` keys."""

    def __init__(
        self,
        view,  # repro_torch.core.view.FeatureView
        num_keys: Optional[int] = None,
        num_shards: int = 1,
        capacity: int = 256,
        num_buckets: int = 64,
        bucket_size: int = 64,
        secondary_num_keys: Optional[Dict[str, int]] = None,
        secondary_capacity: Optional[int] = None,
        ttl: Optional[int] = None,
        table_capacity: Optional[Dict[str, int]] = None,
        table_ttl: Optional[Dict[str, int]] = None,
        hash_routing: bool = True,
        layout: Optional[StoreLayout] = None,
        device_routing: bool = True,
        device="cuda",
    ):
        self.device_routing = bool(device_routing)
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
                hash_routing=hash_routing,
                secondary_num_keys=secondary_num_keys,
                secondary_capacity=secondary_capacity,
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
        self.num_shards = int(layout.num_shards)
        self.global_num_keys = layout.num_keys
        self.hash_routing = layout.hash_routing
        self._perm: Optional[KeyPermutation] = (
            KeyPermutation(layout.perm_domain)
            if layout.perm_domain is not None else None
        )
        super()._apply_layout(view, layout)
        # only a replicated union ring reads the global key (plan_layout
        # partitions every union ring of a sharded plane)
        self._reads_gkey = any(
            not self._ring_plans[i].partitioned
            for i in self._union_ring_ix.values()
        )

    @property
    def _flat_keys(self) -> int:
        return self.num_shards * self.num_keys

    def _ring_flat_keys(self, index: int) -> int:
        p = self._ring_plans[index]
        return self.num_shards * p.ring_keys if p.partitioned else p.ring_keys

    def _copies(self, plan) -> int:
        """The reference holds a replicated ring once per shard."""
        return 1 if plan.partitioned else self.num_shards

    def _shape_ring(self, ring: st.RingStore, partitioned: bool) -> st.RingStore:
        S = self.num_shards
        if partitioned:
            return st.RingStore(*(_split(t, S) for t in (
                ring.ts, ring.vals, ring.cursor)))
        # one copy, seen as S replicas (stride 0 on the shard axis)
        return st.RingStore(*(
            t.unsqueeze(0).expand((S,) + tuple(t.shape))
            for t in (ring.ts, ring.vals, ring.cursor)
        ))

    def _flat_ring(self, ring: st.RingStore, partitioned: bool) -> st.RingStore:
        if partitioned:
            return st.RingStore(*(t.flatten(0, 1) for t in (
                ring.ts, ring.vals, ring.cursor)))
        if self.num_shards > 1 and any(
            t.stride(0) != 0 for t in (ring.ts, ring.vals, ring.cursor)
        ):
            raise ValueError(
                "a replicated ring must be one copy seen as S replicas "
                "(convert.online_state_from_numpy(..., layout=) makes it)"
            )
        return st.RingStore(ring.ts[0], ring.vals[0], ring.cursor[0])

    def _shape_state(self, flat: OnlineState) -> OnlineState:
        S = self.num_shards
        return OnlineState(
            ring=self._shape_ring(flat.ring, True),
            bagg=flat.bagg.map(lambda t: _split(t, S)),
            sec=tuple(
                self._shape_ring(r, p.partitioned)
                for r, p in zip(flat.sec, self._ring_plans)
            ),
        )

    def _flat_state(self, state: Optional[OnlineState] = None) -> OnlineState:
        s = self.state if state is None else state
        return OnlineState(
            ring=self._flat_ring(s.ring, True),
            bagg=s.bagg.map(lambda t: t.flatten(0, 1)),
            sec=tuple(
                self._flat_ring(r, p.partitioned)
                for r, p in zip(s.sec, self._ring_plans)
            ),
        )

    # -- routing ---------------------------------------------------------------

    @property
    def _key_upper(self) -> int:
        return self.global_num_keys

    def _route_ids(
        self, key: np.ndarray, upper: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic key -> (shard id, shard-local id), host-side,
        range-checked against ``upper`` (default: the primary's domain)."""
        key = self._check_range(key, upper)
        routed = self._perm(key) if self._perm is not None else key
        return routed % self.num_shards, routed // self.num_shards

    def shard_of(self, key: np.ndarray) -> np.ndarray:
        """Deterministic key -> shard id (host-side; range-checked)."""
        return self._route_ids(key)[0]

    def _route_rows(
        self,
        plan: RoutePlan,
        arr: np.ndarray,
        pad: str = "repeat",
        sentinel: int = 0,
    ) -> np.ndarray:
        """Scatter (N, ...) batch rows into a padded (S, bucket, ...) grid.

        ``pad='repeat'`` repeats the shard's last real row (query padding:
        a read-only recompute, dropped on scatter-back); ``pad='sentinel'``
        fills with ``sentinel`` (an out-of-range key writes nothing).
        """
        arr = np.asarray(arr)
        S, B = self.num_shards, plan.bucket
        out = np.zeros((S, B) + arr.shape[1:], arr.dtype)
        if pad == "sentinel":
            out[...] = sentinel
        for s, ix in enumerate(plan.idx):
            n = len(ix)
            if not n:
                continue
            out[s, :n] = arr[ix]
            if n < B and pad == "repeat":
                out[s, n:] = arr[ix[-1]]
        return out

    @staticmethod
    def _scatter_back(plan: RoutePlan, vals, q: int) -> Tuple[np.ndarray, ...]:
        """(S, bucket) per-shard answer tensors -> (Q,) host arrays in
        request order."""
        outs = []
        for v in vals:
            vh = v.cpu().numpy()
            o = np.zeros((q,), vh.dtype)
            for s, ix in enumerate(plan.idx):
                o[ix] = vh[s, : len(ix)]
            outs.append(o)
        return tuple(outs)

    # -- ingest ----------------------------------------------------------------

    def _route_ingest(self, key_h: np.ndarray, ts_h: np.ndarray,
                      upper: Optional[int] = None):
        """Flat keys, ts and row order of one (key, ts)-sorted chunk: the
        shards' rows end to end, each shard's in (local key, ts) order (a
        stable sort, so same-key rows keep their arrival order; the
        Feistel permutation scrambles key order, so each shard re-sorts).
        ``upper`` is the range the keys are checked against (default: the
        primary's domain)."""
        shard, local = self._route_ids(key_h, upper)
        order = np.lexsort((ts_h, local, shard))
        flat = shard[order] * self.num_keys + local[order]
        return flat.astype(np.int32), ts_h[order], order

    def _route_sec_ingest(self, index: int, key_h: np.ndarray,
                          ts_h: np.ndarray):
        """A partitioned ring routes as the primary does, within its own
        table's key count; a replicated ring takes the rows as they are."""
        p = self._ring_plans[index]
        if not p.partitioned:
            return key_h, ts_h, None
        return self._route_ingest(key_h, ts_h, p.num_keys)

    # -- query -----------------------------------------------------------------

    def query(
        self,
        columns: Dict,
        mode: str = "preagg",
        program=None,
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Answer a request batch in input row order (same contract as the
        base store, ``program`` included).

        ``device_routing=True`` (the default) serves the batch through the
        device-routed path (:meth:`_query_device_routed`);
        ``device_routing=False`` through the host-routed oracle
        (:meth:`_query_host_routed`).  ``route_info`` (dict, filled in
        place) receives the batch's valid-masked per-shard request counts
        (``"shard_counts"``).
        """
        if self.device_routing:
            return self._query_device_routed(columns, mode, program, valid,
                                             route_info)
        return self._query_host_routed(columns, mode, program, valid,
                                       route_info)

    def _note_route(self, tel, path: str, n_rows: int, q: int,
                    bucket: int) -> None:
        """Routing telemetry shared by both paths: rows routed per path plus
        the shard-layer padding."""
        pad_rows = self.num_shards * bucket - q
        m = tel.metrics
        m.counter(
            "route_rows_total",
            "request rows routed to shards, per routing path", "1",
            labels=("path",),
        ).inc(int(n_rows), path=path)
        m.counter(
            "padding_rows_total", "filler rows added to reach shape bucket",
            "1", labels=("layer",),
        ).inc(pad_rows, layer="shard")
        m.gauge(
            "padding_waste_ratio", "filler rows / bucket rows, last batch",
            "1", labels=("layer",),
        ).set(pad_rows / max(self.num_shards * bucket, 1), layer="shard")

    # -- host-routed request path (the oracle) ---------------------------------

    def _query_host_routed(
        self,
        columns: Dict,
        mode: str,
        program=None,
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Host-routed request path (the ``device_routing=False`` oracle).

        Three stages, each its own span: ``query.route`` (host: shard
        bucketing, padding, upload), ``query.compute`` (device, fenced),
        ``query.scatter`` (host: answers back to request order, then the
        post-expressions).
        """
        tel = get_telemetry()
        self._validate_join_cols(columns, program)
        key_h = self._check_range(
            np.asarray(columns[self.schema.key]).astype(np.int32, copy=False)
        )
        q = int(key_h.shape[0])
        S = self.num_shards
        pname = program.view.name if program is not None else ""
        with tel.tracer.span("query.route", mode=mode, program=pname, rows=q):
            cols = self._columns(columns)
            _, ts_q, lanes, jks = self._request_arrays(cols, program)
            shard, local = self._route_ids(key_h)
            plan = build_route(shard, S, min_bucket=16)
            B = plan.bucket

            def up(arr):
                g = self._route_rows(plan, arr, pad="repeat")
                return torch.as_tensor(
                    g.reshape((S * B,) + g.shape[2:]), device=self.device)

            base = np.repeat(np.arange(S, dtype=np.int64) * self.num_keys, B)
            fkey = up(local.astype(np.int64)) + torch.as_tensor(
                base, device=self.device)
            args = (
                fkey,
                up(ts_q.cpu().numpy()),
                up(lanes.cpu().numpy()),
                tuple(up(j.cpu().numpy()) for j in jks),
                up(key_h) if self._reads_gkey else None,     # global key
            )
        vmask = (
            np.ones(q, bool) if valid is None else np.asarray(valid, bool)[:q]
        )
        self._note_route(tel, "host", int(vmask.sum()), q, B)
        if route_info is not None:
            route_info["shard_counts"] = np.bincount(
                shard[vmask], minlength=S
            ).astype(np.int64)
        with tel.tracer.span(
            "query.compute", kind="device", mode=mode, program=pname,
            rows=q, padded=S * B,
        ) as sp:
            vals = self._query_fn(mode, program)(
                self._flat_state(), *args, groups=S)
            vals = sp.fence(vals)
        self._note_query(tel, mode, program)
        with tel.tracer.span("query.scatter", rows=q):
            back = self._scatter_back(
                plan, tuple(v.view(S, B) for v in vals), q)
            out = self._finish_query(
                cols, tuple(torch.as_tensor(v, device=self.device)
                            for v in back), program)
        return out

    # -- device-routed request path ----------------------------------------------

    def _route_bucket(self, m: int) -> int:
        """Optimistic per-shard grid capacity for an m-row batch: twice
        the even-split share, power-of-two, floored at 16 and capped at m
        (the always-safe bound)."""
        per = -(-m // self.num_shards)
        b = 1 << max(2 * per - 1, 0).bit_length()
        cap = 1 << max(m - 1, 0).bit_length()
        return int(min(max(16, b), max(cap, 1)))

    def _route_routed(self, routed, valid):
        """Routing of routed ids on the device: (local, shard, rank, counts,
        valid counts), the rank from the shard ids (``route_rank``; on the
        card one launch of the route kernel).  Under modulo routing the
        routed ids are the keys.  On the CPU an unfinished Feistel walk
        leaves ids past the domain; ``local`` is clamped so the state is
        never addressed out of bounds (that dispatch's answers are
        recomputed once the walk finishes)."""
        S = self.num_shards
        shard = routed % S
        local = torch.clamp(routed // S, max=self.num_keys - 1)
        rank, counts = route_rank(shard, num_shards=S)
        scounts = torch.zeros(S, dtype=torch.int32, device=routed.device)
        scounts.index_add_(0, shard.long(), valid.to(torch.int32))
        return local, shard, rank, counts, scounts

    def _route_query(self, route, ts_q, lanes, join_keys, gkey, *,
                     bucket: int, fn):
        """Scatter, answer (``fn``: a ``_query_fn``), gather — all on the
        device, from a routed batch.

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
        vals = fn(
            self._flat_state(), fkey, to_grid(ts_q), to_grid(lanes),
            tuple(to_grid(j) for j in join_keys),
            to_grid(gkey) if self._reads_gkey else None, groups=S,
        )
        back = (shard * B + slot).long()
        return tuple(v[back] for v in vals), overflow

    @staticmethod
    def _pad_request(key, ts_q, lanes, join_keys, valid, scen=None):
        """Pad request tensors to a power-of-two row count (at least 16) by
        repeating the last row; ``valid`` marks the filler False (the
        scenario ids repeat the last row's tag too)."""
        q = int(key.shape[0])
        m = max(16, 1 << max(q - 1, 0).bit_length())
        if m != q:
            pad = m - q
            key = torch.cat([key, key[-1:].expand(pad)])
            ts_q = torch.cat([ts_q, ts_q[-1:].expand(pad)])
            lanes = torch.cat([lanes, lanes[-1:].expand(pad, -1)])
            join_keys = tuple(
                torch.cat([j, j[-1:].expand(pad)]) for j in join_keys
            )
            valid = torch.cat([valid, valid.new_zeros(pad)])
            if scen is not None:
                scen = torch.cat([scen, scen[-1:].expand(pad)])
        return key, ts_q, lanes, join_keys, valid, scen, m

    def _scenario_counts(self, shard, scen, valid, num_scen: int):
        """(num_scen, S) valid-masked rows per (scenario, shard): an int32
        scatter-add over ``scen * S + shard`` (integer adds are exact in
        any order)."""
        S = self.num_shards
        out = torch.zeros(num_scen * S, dtype=torch.int32, device=shard.device)
        out.index_add_(0, (scen * S + shard).long(), valid.to(torch.int32))
        return out.view(num_scen, S)

    def _route_dispatch(self, tel, mode, program, key, ts_q, lanes,
                        join_keys, scen, valid, m, num_scen, q):
        """One device-routed dispatch under the ``route.device`` span, plus
        the rare re-dispatches (Feistel walk not finished, per-shard
        capacity overflow) inside the same span.  Returns the answers (m
        rows, request order) and the host's (num_scen, S) valid counts;
        ``scen=None`` is one scenario, counted by the routing itself."""
        B = self._route_bucket(m)
        fn = self._query_fn(mode, program)
        routed = walking = None
        with tel.tracer.span(
            "route.device", kind="device", mode=mode,
            program=program.view.name if program is not None else "",
            rows=q, padded=m, bucket=B, shards=self.num_shards,
        ) as sp:
            if self._perm is None:
                # modulo routing: shard = key % S, ranked from the shard ids
                # (one launch of the route kernel on the card)
                route = self._route_routed(key, valid)
            elif key.is_cuda:
                # one launch: every key walked home, shard, local, ranks,
                # counts (no walk flag)
                route = route_keys(key, valid, self._perm,
                                   num_shards=self.num_shards)
            else:
                # the fixed device walk passes and a "still walking" flag
                routed, walking = self._perm.device_call(key)
                route = self._route_routed(routed, valid)
            vals, ovf = self._route_query(
                route, ts_q, lanes, join_keys, key, bucket=B, fn=fn)
            # the one host read of the batch: the overflow flag (and on the
            # CPU the walk's)
            flags = [ovf] if walking is None else [ovf, walking]
            ovf_h, *walking_h = torch.stack(flags).tolist()
            if any(walking_h):
                route = self._route_routed(
                    self._perm.finish_walk(routed), valid)
                vals, ovf = self._route_query(
                    route, ts_q, lanes, join_keys, key, bucket=B, fn=fn)
                ovf_h = bool(ovf)
            if ovf_h:
                B = 1 << max(m - 1, 0).bit_length()
                vals, _ = self._route_query(
                    route, ts_q, lanes, join_keys, key, bucket=B, fn=fn)
            scounts = (route[4][None] if scen is None else
                       self._scenario_counts(route[1], scen, valid, num_scen))
            vals, scounts = sp.fence(vals, scounts)
        scounts_h = scounts.cpu().numpy().astype(np.int64)
        self._note_route(tel, "device", int(scounts_h.sum()), q, B)
        self._note_query(tel, mode, program)
        return vals, scounts_h

    def _device_request(self, tel, columns, mode, program, valid, scen=None):
        """The host part of the device-routed path (``query.route``): the
        request tensors, padded; returns them with ``cols``, ``m`` and
        ``q``."""
        key_h = self._check_range(
            np.asarray(columns[self.schema.key]).astype(np.int32, copy=False)
        )
        q = int(key_h.shape[0])
        with tel.tracer.span(
            "query.route", mode=mode,
            program=program.view.name if program is not None else "", rows=q,
        ):
            cols = self._columns(columns)
            key, ts_q, lanes, jks = self._request_arrays(cols, program)
            vmask = (
                np.ones(q, bool) if valid is None
                else np.asarray(valid, bool)[:q]
            )
            if scen is not None:
                scen = torch.as_tensor(scen, device=self.device)
            padded = self._pad_request(
                key, ts_q, lanes, jks,
                torch.as_tensor(vmask, device=self.device), scen,
            )
        return cols, padded, q

    def _query_device_routed(
        self,
        columns: Dict,
        mode: str,
        program=None,
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """The device-routed request path: host work is array conversion
        (``query.route``) and the post-expressions (``query.scatter``);
        routing, the grid, the query and the gather back are the fenced
        ``route.device`` span."""
        tel = get_telemetry()
        self._validate_join_cols(columns, program)
        cols, (key, ts_q, lanes, jks, valid_p, _, m), q = (
            self._device_request(tel, columns, mode, program, valid))
        vals, scounts = self._route_dispatch(
            tel, mode, program, key, ts_q, lanes, jks, None, valid_p, m, 1, q)
        if route_info is not None:
            route_info["shard_counts"] = scounts[0]
        with tel.tracer.span("query.scatter", rows=q):
            out = self._finish_query(cols, tuple(v[:q] for v in vals),
                                     program)
        return out

    def route_and_query(
        self,
        columns: Dict,
        scen: np.ndarray,
        num_scen: int,
        mode: str = "preagg",
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ):
        """Route and answer a MIXED multi-scenario batch in one device
        dispatch: rows tagged with ``scen`` (scenario ids in
        ``[0, num_scen)``), against the merged store's FULL aggregation
        set.

        Every scenario of a plane shares the primary schema, so a mixed
        batch carries every column the merged view needs; the full (wagg
        + ljoin) set per row equals each scenario's own program bit for
        bit (an answer depends only on its own row).  Returns
        ``(vals, q)``: the merged-order answers on the device, (m,)
        tensors to slice to ``[:q]``; the caller
        (:meth:`repro_torch.core.scenario.ScenarioPlane.query_mixed`)
        picks each scenario's features from them.  ``route_info`` gains
        the valid-masked ``"scenario_shard_counts"`` (num_scen, S) and
        their sum over scenarios, ``"shard_counts"``.
        """
        if not self.device_routing:
            raise RuntimeError(
                "route_and_query is the device-routed path; this store was "
                "built with device_routing=False (host-routed oracle)"
            )
        tel = get_telemetry()
        self._validate_join_cols(columns, None)
        scen_h = np.asarray(scen, np.int32)
        if scen_h.size and (scen_h.min() < 0 or scen_h.max() >= num_scen):
            raise ValueError(
                f"scenario ids out of range [0, {num_scen}): "
                f"[{scen_h.min()}, {scen_h.max()}]"
            )
        _, (key, ts_q, lanes, jks, valid_p, scen_p, m), q = (
            self._device_request(tel, columns, mode, None, valid, scen_h))
        # padding repeats the last row's scenario tag with valid=False, so
        # the counts never include it
        vals, scounts = self._route_dispatch(
            tel, mode, None, key, ts_q, lanes, jks, scen_p, valid_p, m,
            int(num_scen), q)
        if route_info is not None:
            route_info["scenario_shard_counts"] = scounts
            route_info["shard_counts"] = scounts.sum(axis=0)
        return vals, q

    # -- observability ---------------------------------------------------------

    def shard_row_counts(self) -> np.ndarray:
        """Total primary rows ever ingested per shard (from ring cursors)."""
        return self.state.ring.cursor.sum(dim=1).cpu().numpy()

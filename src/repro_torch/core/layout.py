"""Declarative store-layout planning — the serving plane's physical IR.

:func:`plan_layout` maps a list of feature views plus sizing knobs to a
:class:`StoreLayout` — a pure-data plan every storage layer consumes:

* ``primary``  — the primary table's :class:`RingPlan` (per-shard ring
  keys, capacity, TTL, lane slots);
* ``bucket``   — the :class:`BucketPlan` sizing the pre-aggregate store;
* ``tables``   — one :class:`RingPlan` per secondary *ring* (a dual-use
  table is split on a sharded plane into a key-partitioned union ring plus
  a replicated join slice).

A copy of the reference package's ``repro.core.layout`` planner (it is
framework-free); plans computed by either package for the same views are
equal field for field.  Layout diffing for live migration
(``diff_layouts``) belongs to the hot-deploy slice and is not here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.aggregates import agg_spec
from repro_torch.core.expr import (
    BinOp,
    Col,
    Expr,
    Lit,
    UnOp,
    collect_last_joins,
    collect_tables,
    collect_window_aggs,
)

__all__ = [
    "LaneSlot",
    "RingPlan",
    "BucketPlan",
    "StoreLayout",
    "plan_layout",
    "synthesizable",
]


def synthesizable(e: Expr) -> bool:
    """True if a lane can be *re-materialized* from stored raw-column
    lanes, bit-exactly: the expr tree is pure f32 row math (``Col`` /
    ``Lit`` / arithmetic / comparisons).  ``Hash`` / ``Signature`` nodes
    are excluded — their mixing is dtype-sensitive (ints convert, floats
    bitcast), so re-evaluating them over f32-stored columns would not
    reproduce the ingest-time value.
    """
    if isinstance(e, (Col, Lit)):
        return True
    if isinstance(e, (BinOp, UnOp)):
        return all(synthesizable(c) for c in e.children())
    return False


@dataclasses.dataclass(frozen=True)
class LaneSlot:
    """One materialized value lane of a ring (identity = the expr key)."""

    key: Tuple
    expr: Expr = dataclasses.field(compare=False, hash=False)
    source: str = "derived"  # 'raw' (a schema column) | 'derived'

    @property
    def synthesizable(self) -> bool:
        return synthesizable(self.expr)


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Physical plan of one per-key ring buffer.

    ``num_keys`` is the *global* key-domain size; ``ring_keys`` the
    per-shard ring row count (== ``num_keys`` unless the ring is
    key-partitioned on a sharded plane).  ``serves`` records which query
    constructs read this ring (``'union'`` / ``'join'``; the primary ring
    serves ``'window'``).  ``partitioned`` is the placement policy: rows
    routed to one owning shard (vs replicated on every shard).
    """

    table: str
    partitioned: bool
    serves: Tuple[str, ...]
    num_keys: int
    ring_keys: int
    capacity: int
    lanes: Tuple[LaneSlot, ...]
    ttl: Optional[int] = None

    @property
    def lane_keys(self) -> Tuple[Tuple, ...]:
        return tuple(s.key for s in self.lanes)

    def lane_of(self, key: Tuple) -> int:
        return self.lane_keys.index(key)

    def identity(self) -> Tuple:
        """Per-(table, shard) ring identity: two plans with equal identity
        describe byte-compatible buffers whose contents a migration may
        carry over verbatim."""
        return (
            self.table,
            self.partitioned,
            self.num_keys,
            self.ring_keys,
            self.capacity,
            self.lane_keys,
            self.ttl,
        )

    def describe(self) -> str:
        role = "partitioned" if self.partitioned else "replicated"
        return (
            f"{self.table}[{'+'.join(self.serves)}] {role} "
            f"keys={self.num_keys}/{self.ring_keys} cap={self.capacity} "
            f"lanes={len(self.lanes)}"
        )


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Sizing of the two-level pre-aggregation bucket store.

    ``extreme`` / ``tail`` declare which merge-order state families the
    store persists alongside the stat lanes: FIRST/LAST winners per
    direction, and the mergeable newest-rows tail TOPN composes from.
    The planner sets them from the views' RANGE-mode aggregates so
    layouts without those aggregates pay no memory for the extra arrays.
    """

    num_buckets: int
    bucket_size: int
    extreme: bool = False
    tail: bool = False


@dataclasses.dataclass(frozen=True)
class StoreLayout:
    """The full physical plan of one (optionally sharded) online store."""

    num_keys: int                 # global primary key-domain size
    num_shards: Optional[int]     # None = single-device store
    hash_routing: bool
    perm_domain: Optional[int]    # KeyPermutation domain (hash routing)
    primary: RingPlan
    bucket: BucketPlan
    tables: Tuple[RingPlan, ...]  # secondary rings, state.sec order
    raw_lanes: bool               # evolvable: raw columns materialized

    # -- lookups ------------------------------------------------------------

    @property
    def table_names(self) -> Tuple[str, ...]:
        """Distinct secondary tables, in first-ring order."""
        out: List[str] = []
        for p in self.tables:
            if p.table not in out:
                out.append(p.table)
        return tuple(out)

    def rings_of(self, table: str) -> List[int]:
        return [i for i, p in enumerate(self.tables) if p.table == table]

    def _serving(self, table: str, what: str) -> int:
        for i, p in enumerate(self.tables):
            if p.table == table and what in p.serves:
                return i
        raise KeyError(f"no ring of table {table!r} serves {what!r}")

    def union_ring(self, table: str) -> int:
        return self._serving(table, "union")

    def join_ring(self, table: str) -> int:
        return self._serving(table, "join")

    def describe(self) -> str:
        shards = self.num_shards or 1
        lines = [
            f"StoreLayout: shards={shards} "
            f"hash_routing={self.hash_routing} "
            f"buckets={self.bucket.num_buckets}x{self.bucket.bucket_size} "
            f"raw_lanes={self.raw_lanes}",
            f"  primary  {self.primary.describe()}",
        ]
        for p in self.tables:
            lines.append(f"  secondary {p.describe()}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


def _feature_names_of_wagg(views, wk: Tuple) -> List[str]:
    """Which view features reference window aggregation ``wk`` (for error
    messages that name the offender, not just the shape mismatch)."""
    names = []
    for v in views:
        for fname, expr in v.features.items():
            if wk in collect_window_aggs([expr]):
                names.append(f"{v.name}/{fname}")
    return names


def plan_layout(
    views: Sequence,  # Sequence[FeatureView]
    *,
    num_keys: int,
    capacity: int = 256,
    num_buckets: int = 64,
    bucket_size: int = 64,
    num_shards: Optional[int] = None,
    hash_routing: bool = True,
    secondary_num_keys: Optional[Dict[str, int]] = None,
    secondary_capacity: Optional[int] = None,
    ttl: Optional[int] = None,
    table_capacity: Optional[Dict[str, int]] = None,
    table_ttl: Optional[Dict[str, int]] = None,
    raw_lanes: bool = False,
) -> StoreLayout:
    """Compute the one :class:`StoreLayout` for a list of feature views.

    Deterministic and **append-stable**: planning ``views + [v_new]``
    keeps every lane slot and ring of ``plan_layout(views)`` at the same
    position and only appends — the property that lets a live plane adopt
    the new layout by carrying state over instead of rebuilding.

    ``raw_lanes=True`` makes the layout *evolvable*: every raw schema
    column is materialized as a lane from day one (primary ring, bucket
    store, and every partitioned/union secondary ring), so a future view
    whose window arguments are plain columns hot-deploys with complete
    historical state, and derived arguments can be synthesized from the
    stored columns.  Replicated LAST JOIN *slices* of dual-use tables
    stay narrow (join-argument lanes only) — that is the point of the
    split.

    ``table_capacity`` / ``table_ttl`` override ring capacity and TTL
    *per table* (keyed by table name, primary included) — the planner's
    retention knobs.  Capacity is the true retention lever: a ring
    retains its last ``capacity`` rows per key, so a short-capacity table
    ages rows out (and a migration over it needs the offline backfill
    bridge to stay exact) while a long one carries history verbatim.
    TTL is a *query-time* visibility mask (rows older than ``ttl`` are
    invisible to windows but still occupy slots); per-table TTLs let a
    fast-moving union stream expire early while the primary looks back
    further.

    Placement policy (``num_shards`` set):

    * primary — key-partitioned (`shard = perm(key) % S` under hash
      routing);
    * union-only tables — partitioned the same way (they share the
      primary key space);
    * join-only tables — replicated dimension tables;
    * dual-use tables — **split**: a partitioned union ring (all lanes)
      plus a replicated join slice (join lanes only), recovering the S×
      replication the union-stream rows previously paid.
    """
    views = list(views)
    if not views:
        raise ValueError("plan_layout needs at least one view")
    schema = views[0].schema
    db = views[0].database
    all_exprs: List[Expr] = []
    for v in views:
        all_exprs.extend(v.features.values())

    waggs = collect_window_aggs(all_exprs)
    ljoins = collect_last_joins(all_exprs)
    sec_names = collect_tables(all_exprs)
    sec_schemas = {}
    for v in views:
        for t in collect_tables(list(v.features.values())):
            sec_schemas.setdefault(t, v.database.table(t))

    # per-table retention overrides (capacity = hard retention, ttl =
    # query-time visibility); unknown table names fail loudly
    tcap = dict(table_capacity or {})
    tttl = dict(table_ttl or {})
    known = {schema.name, *sec_names}
    for d, what in ((tcap, "table_capacity"), (tttl, "table_ttl")):
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(
                f"{what} names unknown table(s) {bad}; the planned views "
                f"reference {sorted(known)}"
            )
    p_cap = int(tcap.get(schema.name, capacity))
    p_ttl = tttl.get(schema.name, ttl)
    p_ttl = None if p_ttl is None else int(p_ttl)

    # window-fit validation, naming the offending feature (pre-agg buckets
    # must cover a non-union RANGE window's span; see online._preagg_parts).
    # Matches the store's own check: a TTL retention policy clamps every
    # window's effective lookback, so it bounds the bucket need too.
    for wk, wa in waggs.items():
        if wa.window.mode == "range" and not wa.union:
            span = (
                wa.window.size if p_ttl is None
                else min(wa.window.size, p_ttl)
            )
            need = span // bucket_size + 2
            if need > num_buckets:
                feats = _feature_names_of_wagg(views, wk)
                raise ValueError(
                    f"window {span} of {wa.agg.value}() in "
                    f"feature(s) {feats} needs {need} buckets of "
                    f"{bucket_size} time units, but the store layout has "
                    f"only num_buckets={num_buckets}; raise num_buckets "
                    f"or bucket_size"
                )

    # -- lane plans ---------------------------------------------------------

    def lane_list(
        raw_cols: Tuple[str, ...], derived: List[Expr]
    ) -> Tuple[LaneSlot, ...]:
        slots: List[LaneSlot] = []
        seen = set()
        if raw_lanes:
            for c in raw_cols:
                e = Col(c)
                slots.append(LaneSlot(e.key, e, source="raw"))
                seen.add(e.key)
        for e in derived:
            if e.key not in seen:
                seen.add(e.key)
                src = "raw" if isinstance(e, Col) else "derived"
                slots.append(LaneSlot(e.key, e, source=src))
        return tuple(slots)

    primary_lanes = lane_list(
        schema.columns, [wa.arg for wa in waggs.values()]
    )

    # per-table argument lanes, in first-seen order (joins walk before
    # unions, matching the pre-layout store's ordering)
    sec_union_args: Dict[str, List[Expr]] = {t: [] for t in sec_names}
    sec_join_args: Dict[str, List[Expr]] = {t: [] for t in sec_names}

    def add(lst: List[Expr], e: Expr) -> None:
        if all(e.key != x.key for x in lst):
            lst.append(e)

    for lj in ljoins.values():
        add(sec_join_args[lj.table], lj.arg)
    for wa in waggs.values():
        for t in wa.union:
            add(sec_union_args[t], wa.arg)

    join_tables = {lj.table for lj in ljoins.values()}
    union_tables = {t for wa in waggs.values() for t in wa.union}

    # -- key-domain / routing sizing ---------------------------------------

    sec_nk = dict(secondary_num_keys or {})
    global_nk = {t: int(sec_nk.get(t, num_keys)) for t in sec_names}
    sec_cap = int(secondary_capacity or capacity)

    sharded = num_shards is not None
    S = int(num_shards) if sharded else 1
    if sharded and S < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    partitioned_sec = (
        {t for t in sec_names if t in union_tables} if sharded else set()
    )
    # a join-only table cannot partition (join keys are arbitrary request
    # columns); a dual-use table partitions its union ring only
    perm_domain: Optional[int] = None
    if sharded:
        dom = max([int(num_keys)] + [global_nk[t] for t in partitioned_sec])
        if hash_routing:
            # one permutation shared by the primary and every partitioned
            # ring (union streams share the primary key space); pad the
            # domain to a multiple of S so local = perm // S stays dense
            perm_domain = S * (-(-dom // S))
            per_shard_keys = perm_domain // S
        else:
            per_shard_keys = -(-dom // S)
    else:
        per_shard_keys = int(num_keys)

    primary = RingPlan(
        table=schema.name,
        partitioned=sharded,
        serves=("window",),
        num_keys=int(num_keys),
        ring_keys=per_shard_keys if sharded else int(num_keys),
        capacity=p_cap,
        lanes=primary_lanes,
        ttl=p_ttl,
    )
    bucket = BucketPlan(
        num_buckets=int(num_buckets),
        bucket_size=int(bucket_size),
        extreme=any(
            wa.window.mode == "range" and agg_spec(wa.agg).state == "extreme"
            for wa in waggs.values()
        ),
        tail=any(
            wa.window.mode == "range" and agg_spec(wa.agg).state == "tail"
            for wa in waggs.values()
        ),
    )

    rings: List[RingPlan] = []
    for t in sec_names:
        tsch = sec_schemas[t]
        cap_t = int(tcap.get(t, sec_cap))
        ttl_t = tttl.get(t)
        ttl_t = None if ttl_t is None else int(ttl_t)
        is_union = t in union_tables
        is_join = t in join_tables
        if sharded and is_union and is_join:
            # dual-use split: partition the union-stream part, replicate
            # only the LAST JOIN slice (narrow: join lanes, no raw lanes)
            rings.append(
                RingPlan(
                    table=t,
                    partitioned=True,
                    serves=("union",),
                    num_keys=global_nk[t],
                    ring_keys=per_shard_keys,
                    capacity=cap_t,
                    lanes=lane_list(tsch.columns, sec_union_args[t]),
                    ttl=ttl_t,
                )
            )
            rings.append(
                RingPlan(
                    table=t,
                    partitioned=False,
                    serves=("join",),
                    num_keys=global_nk[t],
                    ring_keys=global_nk[t],
                    capacity=cap_t,
                    ttl=ttl_t,
                    lanes=tuple(
                        LaneSlot(
                            e.key, e,
                            source="raw" if isinstance(e, Col) else "derived",
                        )
                        for e in sec_join_args[t]
                    ),
                )
            )
            continue
        part = sharded and is_union and not is_join
        serves = tuple(
            w for w, yes in (("union", is_union), ("join", is_join)) if yes
        )
        rings.append(
            RingPlan(
                table=t,
                partitioned=part,
                serves=serves,
                num_keys=global_nk[t],
                ring_keys=per_shard_keys if part else global_nk[t],
                capacity=cap_t,
                lanes=lane_list(
                    tsch.columns, sec_join_args[t] + sec_union_args[t]
                ),
                ttl=ttl_t,
            )
        )

    return StoreLayout(
        num_keys=int(num_keys),
        num_shards=int(num_shards) if sharded else None,
        hash_routing=bool(hash_routing) if sharded else False,
        perm_domain=perm_domain,
        primary=primary,
        bucket=bucket,
        tables=tuple(rings),
        raw_lanes=bool(raw_lanes),
    )

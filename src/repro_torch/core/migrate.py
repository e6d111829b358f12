"""Live-plane state migration — hot deployment as a state transform.

FeatInsight deploys new feature services onto a *running* platform.  This
module is that operation for the port's stores: given a
:class:`~repro_torch.core.layout.LayoutDiff` (old plan -> new plan), it
produces the new :class:`~repro_torch.core.online.OnlineState` from the old
one **without re-ingesting anything**, on the state's own device:

* rings whose :meth:`~repro_torch.core.layout.RingPlan.identity` is
  unchanged are carried over verbatim (the same tensors: no copy, the same
  ``data_ptr()``);
* rings whose lane plan grew or permuted get their lanes re-mapped, new
  lanes *synthesized* by re-evaluating the lane expression over the raw
  column lanes an evolvable layout stores (``raw_lanes=True``); their
  timestamps and cursors stay the same tensors when the capacity holds;
* rings whose capacity changed are re-laid slot by slot (a row at
  absolute index ``a`` moves from slot ``a % C_old`` to ``a % C_new``), a
  gather per new slot;
* rings whose *placement* changed (the dual-use split: a partitioned union
  ring giving a replicated join slice, or back) are rebuilt key by key:
  each key's retained rows are gathered from its source row and written
  to its row under the new routing — per-key ring state depends only on
  that key's rows and their order, which the transform keeps;
* bucket pre-aggregate states carry per lane; states of *new* lanes are
  re-folded from the ring's retained rows in the reference's order.

The port of the reference package's ``repro.core.migrate``, with the same
reports, deficits and exactness contract: the migrated state equals a cold
rebuild + full replay bit for bit whenever the information still exists in
the store (no required row has aged out of its ring; synthesized lanes
come from raw-column lanes), and a batch brings at most one row per (key,
bucket) after the first (the bucket fold's association).  Beyond the
horizon the migration succeeds with ``report.exact = False`` and a
:class:`Deficit` per site, which the offline backfill bridge
(:mod:`repro_torch.offline.backfill`) repairs from history.

The reference pulls every state array to the host; here nothing leaves the
device but per-key routing ids.  Where the reference builds a (S, K, NB,
C) mask to re-fold a bucket lane, the port folds the C ring positions one
at a time into (K, NB) accumulators (:func:`_rebuild_bucket_lane`).

State form: :func:`migrate_state` takes the store's public state and
returns the migrated state *flat*: one key axis per ring (a partitioned
ring's ``(S, K_local, ...)`` folded into ``S * K_local`` rows, shard-major;
the one copy of a replicated ring).  The store shapes it for its new
layout when it places it (:meth:`~repro_torch.core.online.
OnlineFeatureStore._place_state`); a replicated ring never becomes S
copies.

The merge-order bucket families (FIRST / LAST / TOPN_FREQ over RANGE
windows) carry with the bucket store, remapped with it on a
``num_buckets`` change; a plan that gains them, or a lane they hold,
re-derives them from the ring's retained rows
(:func:`_rebuild_bucket_order`).  ``seq`` is the ring cursor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.aggregates import LANES, NEG_INF, POS_INF, row_bitmap
from repro_torch.core.expr import Col, eval_rowlevel
from repro_torch.core.layout import LaneSlot, LayoutDiff, RingPlan
from repro_torch.core.online import OnlineState
from repro_torch.obs import get_telemetry

__all__ = ["Deficit", "MigrationReport", "migrate_state"]

_TS_MIN = -2147483648


@dataclasses.dataclass(frozen=True)
class Deficit:
    """One piece of state a migration could not reconstruct exactly.

    ``target`` is ``'ring'`` or ``'bucket'``; ``ring`` indexes the new
    layout's secondary rings (``None`` = the primary ring / the bucket
    store).  ``lanes`` names the affected lane keys, or ``None`` when the
    whole structure is deficient (aged-out rows, bucket-slot remap after
    wraparound).  Deficits are exactly what the offline backfill bridge
    (:mod:`repro_torch.offline.backfill`) re-derives from history.
    """

    target: str                       # 'ring' | 'bucket'
    table: str
    ring: Optional[int] = None        # new.tables index; None = primary
    lanes: Optional[Tuple] = None     # affected lane keys; None = all
    reason: str = ""

    def describe(self) -> str:
        what = (
            "all lanes" if self.lanes is None
            else ", ".join(repr(k) for k in self.lanes)
        )
        return f"{self.target} {self.table} [{what}]: {self.reason}"


@dataclasses.dataclass
class MigrationReport:
    """What a layout adoption actually did to the live state."""

    diff_summary: str
    carried: List[str] = dataclasses.field(default_factory=list)
    migrated: List[str] = dataclasses.field(default_factory=list)
    fresh: List[str] = dataclasses.field(default_factory=list)
    dropped: List[str] = dataclasses.field(default_factory=list)
    synthesized_lanes: List[str] = dataclasses.field(default_factory=list)
    new_programs: List[str] = dataclasses.field(default_factory=list)
    exact: bool = True
    notes: List[str] = dataclasses.field(default_factory=list)
    deficits: List[Deficit] = dataclasses.field(default_factory=list)
    backfilled: List[str] = dataclasses.field(default_factory=list)
    # inexactness NOT repairable from offline history (a key-domain shrink
    # dropping out-of-domain rows): the backfill splice never restores
    # report.exact while this is set
    hard_inexact: bool = False

    def add_deficit(self, d: Deficit) -> None:
        """Record a repairable inexactness: the migration proceeds, the
        report flips inexact, and the deficit tells the backfill bridge
        exactly what to re-derive."""
        self.deficits.append(d)
        self.exact = False
        self.notes.append(d.reason)

    def describe(self) -> str:
        lines = [
            f"migration: {self.diff_summary} "
            f"exact={'yes' if self.exact else 'NO'}"
        ]
        for tag, items in (
            ("carried", self.carried),
            ("migrated", self.migrated),
            ("fresh", self.fresh),
            ("dropped", self.dropped),
            ("synthesized", self.synthesized_lanes),
            ("backfilled", self.backfilled),
            ("new programs", self.new_programs),
        ):
            if items:
                lines.append(f"  {tag}: {', '.join(items)}")
        for d in self.deficits:
            lines.append(f"  deficit: {d.describe()}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Ring transforms
# ---------------------------------------------------------------------------


def _written_mask(cur: torch.Tensor, C: int) -> torch.Tensor:
    """(K, C) bool: ring slots that have ever been written (slot s is
    first written when the key's cursor passes s)."""
    return cur[:, None] > torch.arange(C, dtype=cur.dtype, device=cur.device)


def _collect_cols(e) -> List[str]:
    if isinstance(e, Col):
        return [e.name]
    out: List[str] = []
    for c in e.children():
        out.extend(_collect_cols(c))
    return out


def _synth_refusal(slot: LaneSlot, src_plan: RingPlan, ctx: str
                   ) -> Optional[str]:
    """Why ``slot`` cannot be synthesized from ``src_plan``'s stored
    lanes (None when it can)."""
    if not slot.synthesizable:
        return (
            f"lane {slot.key!r} of {ctx} contains hash/signature nodes "
            "whose evaluation is dtype-sensitive — it cannot be "
            "synthesized bit-exactly from stored f32 columns"
        )
    for name in _collect_cols(slot.expr):
        if ("col", name) not in src_plan.lane_keys:
            return (
                f"new lane {slot.key!r} of {ctx} needs raw column "
                f"{name!r}, which the running layout does not materialize "
                "(plan with raw_lanes=True to make the store evolvable)"
            )
    return None


def _synth_lane(
    slot: LaneSlot,
    src_plan: RingPlan,
    vals_src: torch.Tensor,     # (..., F_src) raw lane values
    report: MigrationReport,
    ctx: str,
    note: bool = True,
) -> torch.Tensor:
    """Re-materialize one lane from the source ring's raw-column lanes:
    the lane expression evaluated elementwise over the stored f32 columns,
    as ingest evaluated it (bit for bit for pure f32 row math, see
    :func:`repro_torch.core.layout.synthesizable`).  Anything else needs a
    rebuild (or a backfill source) and raises here."""
    why = _synth_refusal(slot, src_plan, ctx)
    if why is not None:
        raise ValueError(
            f"cannot hot-deploy: {why}; rebuild the plane for this "
            "deployment, or pass a backfill= source covering "
            f"table {ctx!r}"
        )
    with get_telemetry().tracer.span(
        "migrate.synthesize", table=ctx, lane=str(slot.key)
    ):
        cols = {name: vals_src[..., src_plan.lane_of(("col", name))]
                for name in _collect_cols(slot.expr)}
        v = eval_rowlevel(slot.expr, cols, {}).to(torch.float32)
        if not cols:  # a literal-only expression
            v = v.to(vals_src.device).expand(vals_src.shape[:-1]).clone()
    if note:
        report.synthesized_lanes.append(f"{ctx}:{slot.key!r}")
    return v


def _lane_actions(src_plan: RingPlan, dst_plan: RingPlan, ctx: str, defer):
    """Per destination lane: ``('carry', i)``, ``('defer', None)`` or
    ``('synth', None)`` — the reference's per-lane decision, made once."""
    out = []
    for slot in dst_plan.lanes:
        if slot.key in src_plan.lane_keys:
            out.append(("carry", src_plan.lane_of(slot.key)))
            continue
        if defer is not None:
            why = _synth_refusal(slot, src_plan, ctx)
            if why is not None and defer(slot, why):
                out.append(("defer", None))
                continue
        out.append(("synth", None))
    return out


def _map_lanes(
    src_plan: RingPlan,
    dst_plan: RingPlan,
    vals_src: torch.Tensor,        # (..., F_src)
    written: Optional[torch.Tensor],
    report: MigrationReport,
    ctx: str,
    defer=None,                    # callable(slot, why) -> bool
    actions=None,
    note: bool = True,
) -> torch.Tensor:
    """(..., F_dst) lane block: carried lanes copied by key, new lanes
    synthesized (zero on never-written slots, as in a fresh ring).

    ``defer`` is the backfill hook: a new lane that cannot be synthesized
    and that ``defer(slot, why)`` accepts is left zero and recorded as a
    deficit for the offline splice instead of refusing."""
    if actions is None:
        actions = _lane_actions(src_plan, dst_plan, ctx, defer)
    F_dst = max(len(dst_plan.lanes), 1)
    idx = [i for a, i in actions if a == "carry"]
    if len(idx) == len(actions) and idx:
        if idx == list(range(vals_src.shape[-1])):
            return vals_src  # the same lanes in the same order
        # every lane carried: one gather (a permutation or a subset)
        return vals_src[..., torch.as_tensor(idx, device=vals_src.device)]
    out = vals_src.new_zeros(tuple(vals_src.shape[:-1]) + (F_dst,))
    for j, (slot, (act, i)) in enumerate(zip(dst_plan.lanes, actions)):
        if act == "carry":
            out[..., j] = vals_src[..., i]
        elif act == "synth":
            v = _synth_lane(slot, src_plan, vals_src, report, ctx, note)
            out[..., j] = v if written is None else torch.where(
                written, v, v.new_zeros(()))
    return out


def _relay_slots(ts, vals, cur, C_new: int):
    """Re-lay (K, C_old) rings at capacity ``C_new``, reproducing the
    cursor arithmetic: new slot ``t`` holds the newest retained row whose
    absolute index ``a`` has ``a % C_new == t``, read from slot
    ``a % C_old``.  One gather per new slot; never-written slots get
    ``TS_MIN`` / 0.  Returns (ts, vals, written (K, C_new))."""
    K, C_old = ts.shape
    dev = ts.device
    cur64 = cur.to(torch.int64)
    r = torch.clamp(cur64, max=C_old)
    rr = torch.clamp(r, max=C_new)
    lo = cur64 - rr
    new_ts = torch.full((K, C_new), _TS_MIN, dtype=torch.int32, device=dev)
    new_vals = vals.new_zeros((K, C_new) + tuple(vals.shape[2:]))
    written = torch.zeros((K, C_new), dtype=torch.bool, device=dev)
    rows = torch.arange(K, device=dev)
    for t in range(C_new):
        a = cur64 - 1 - torch.remainder(cur64 - 1 - t, C_new)
        ok = a >= lo
        src = torch.remainder(torch.clamp(a, min=0), C_old)
        new_ts[:, t] = torch.where(ok, ts[rows, src], _TS_MIN)
        new_vals[:, t] = torch.where(ok.view((K,) + (1,) * (vals.dim() - 2)),
                                     vals[rows, src], 0.0)
        written[:, t] = ok
    return new_ts, new_vals, written


def _recap(ts, vals, cur, C_new: int, report: MigrationReport, ctx: str,
           ring_ix: Optional[int]):
    """Re-lay ring slots for a capacity change (a row at absolute index
    ``a`` lands in slot ``a % C``); the same tensors when it holds."""
    C_old = ts.shape[1]
    if C_new == C_old:
        return ts, vals
    with get_telemetry().tracer.span(
        "migrate.relay", table=ctx, c_old=C_old, c_new=C_new
    ):
        ts, vals, _ = _relay_slots(ts, vals, cur, C_new)
    if C_new > C_old and bool((cur > C_old).any()):
        report.add_deficit(Deficit(
            target="ring", table=ctx, ring=ring_ix, lanes=None,
            reason=(
                f"{ctx}: capacity grew {C_old}->{C_new} but rows had "
                "already aged out — a cold rebuild would retain more "
                "history"
            ),
        ))
    return ts, vals


def _relane_ring(
    src_plan: RingPlan,
    dst_plan: RingPlan,
    ring: st.RingStore,
    report: MigrationReport,
    ring_ix: Optional[int] = None,
    defer=None,
) -> st.RingStore:
    """Same key domain and placement: permute / append / synthesize lanes,
    then re-lay capacity if it changed.  The cursor stays the same
    tensor, and so do the timestamps at an unchanged capacity."""
    with get_telemetry().tracer.span("migrate.relane", table=dst_plan.table):
        ctx = dst_plan.table
        written = _written_mask(ring.cursor, src_plan.capacity)
        vals = _map_lanes(src_plan, dst_plan, ring.vals, written, report,
                          ctx, defer=defer)
        del written
        ts, vals = _recap(ring.ts, vals, ring.cursor, dst_plan.capacity,
                          report, ctx, ring_ix)
        report.migrated.append(dst_plan.describe())
        return st.RingStore(ts=ts, vals=vals, cursor=ring.cursor)


def _reroute_ring(
    src_plan: RingPlan,
    dst_plan: RingPlan,
    ring: st.RingStore,
    store,
    sharded: bool,
    report: MigrationReport,
    ring_ix: Optional[int] = None,
    defer=None,
) -> st.RingStore:
    """Placement change (partitioned <-> replicated, e.g. building a
    dual-use table's replicated join slice from its partitioned union
    ring): each key's retained rows, re-encoded under the new plan."""
    with get_telemetry().tracer.span(
        "migrate.reroute", table=dst_plan.table,
        partitioned=dst_plan.partitioned,
    ):
        return _reroute_ring_impl(src_plan, dst_plan, ring, store, sharded,
                                  report, ring_ix, defer)


def _global_keys(plan: RingPlan, rows: np.ndarray, store, S: int
                 ) -> np.ndarray:
    """Global key of each flat row of ``plan``'s ring: the inverse of the
    store's routing for a partitioned ring (``routed = local * S +
    shard``), the row itself for a replicated one."""
    if not plan.partitioned:
        return rows
    K_loc = plan.ring_keys
    routed = (rows % K_loc) * S + rows // K_loc
    perm = store._perm
    # the algebraic Feistel inverse, O(occupied keys)
    return perm.inverse(routed) if perm is not None else routed


def _reroute_ring_impl(src_plan, dst_plan, ring, store, sharded, report,
                       ring_ix=None, defer=None) -> st.RingStore:
    S = store.num_shards if sharded else 1
    dev = ring.ts.device
    ctx = f"{dst_plan.table}({'part' if dst_plan.partitioned else 'repl'})"
    F_dst = max(len(dst_plan.lanes), 1)
    C_t = dst_plan.capacity
    K_dst = dst_plan.ring_keys * (S if dst_plan.partitioned else 1)
    cur_h = ring.cursor.cpu().numpy().astype(np.int64)
    occ = np.nonzero(cur_h > 0)[0]          # flat rows, in stream order
    g = _global_keys(src_plan, occ, store, S)
    keep = g < dst_plan.num_keys
    # each new lane: synthesized, deferred to the backfill splice, or
    # refused (raises before anything else happens)
    kinds = []
    for slot in dst_plan.lanes:
        if slot.key in src_plan.lane_keys:
            kinds.append("carry")
        elif _synth_refusal(slot, src_plan, ctx) is None:
            kinds.append("synth")
        elif defer is not None and defer.accepts(slot):
            kinds.append("defer")
        else:
            kinds.append("refuse")
            if keep.any():
                _synth_lane(slot, src_plan, ring.vals, report, ctx)
    new_lanes = [(s, k) for s, k in zip(dst_plan.lanes, kinds)
                 if k != "carry"]
    r_h = np.minimum(cur_h[occ], src_plan.capacity)
    lost = np.minimum(cur_h[occ], C_t) - r_h
    first_short = next(iter(np.nonzero((lost > 0) & keep)[0]), None)
    # the report gains, key by key in stream order as in the reference,
    # each new lane's entry and the first short key's deficit
    for i in (range(len(occ)) if new_lanes or not keep.all() else
              ([] if first_short is None else [first_short])):
        if not keep[i]:
            report.notes.append(
                f"{ctx}: dropped rows of out-of-domain key {int(g[i])}")
            report.exact = False
            report.hard_inexact = True
            continue
        for slot, kind in new_lanes:
            if kind == "defer":
                defer(slot, _synth_refusal(slot, src_plan, ctx))
            else:
                report.synthesized_lanes.append(f"{ctx}:{slot.key!r}")
        if i == first_short:
            report.add_deficit(Deficit(
                target="ring", table=dst_plan.table, ring=ring_ix,
                lanes=None,
                reason=(f"{ctx}: key {int(g[i])} lost {int(lost[i])} "
                        "aged-out rows vs a cold rebuild"),
            ))
    ts_n = torch.full((K_dst, C_t), _TS_MIN, dtype=torch.int32, device=dev)
    vals_n = torch.zeros((K_dst, C_t, F_dst), dtype=torch.float32,
                         device=dev)
    cur_n = torch.zeros((K_dst,), dtype=torch.int32, device=dev)
    src = occ[keep]
    if src.size:
        gk = g[keep]
        if dst_plan.partitioned:
            s_arr, l_arr = store._route_ids(gk, dst_plan.num_keys)
            dst = s_arr.astype(np.int64) * dst_plan.ring_keys + l_arr
        else:
            dst = gk
        src_t = torch.as_tensor(src, device=dev)
        dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        cur = ring.cursor[src_t]
        # each key's retained rows re-laid at the new capacity, then its
        # lanes mapped (new lanes zero on never-written slots)
        ts_r, vals_r, written = _relay_slots(ring.ts[src_t],
                                             ring.vals[src_t], cur, C_t)
        actions = [("carry", src_plan.lane_of(s.key)) if k == "carry"
                   else (k, None) for s, k in zip(dst_plan.lanes, kinds)]
        vals_r = _map_lanes(src_plan, dst_plan, vals_r, written, report, ctx,
                            actions=actions, note=False)
        ts_n[dst_t] = ts_r
        vals_n[dst_t] = vals_r
        cur_n[dst_t] = cur
    report.migrated.append(dst_plan.describe())
    return st.RingStore(ts=ts_n, vals=vals_n, cursor=cur_n)


def _fresh_ring(plan: RingPlan, S: int, device) -> st.RingStore:
    """A fresh ring in flat form (a replicated ring's one copy)."""
    K = plan.ring_keys * (S if plan.partitioned else 1)
    return st.ring_init(K, plan.capacity, max(len(plan.lanes), 1), device)


# ---------------------------------------------------------------------------
# Bucket pre-aggregate migration
# ---------------------------------------------------------------------------


def _rebuild_bucket_lane(
    v: torch.Tensor,        # (K, C) new-lane ring values
    ts: torch.Tensor,       # (K, C)
    cur: torch.Tensor,      # (K,)
    bucket_ids: torch.Tensor,  # (K, NB)
    bsize: int,
    stats_out: torch.Tensor,   # (K, NB, NUM_STATS), written
    bitmap_out: torch.Tensor,  # (K, NB), written
) -> None:
    """Per-(key, bucket) stat-lane states and bitmap of one lane, folded
    from the ring's retained rows into ``stats_out`` / ``bitmap_out``.

    The reference masks a (S, K, NB, C) array and sums it with
    ``np.cumsum`` over the C ring slots; that array would not fit on any
    device at deployment size.  A row at slot ``j`` can only match the
    bucket slot ``(ts // bsize) % NB`` (ids live at ``id % NB``), so this
    folds the C slots in the same order (slot 0 first), one slot at a
    time, into (K, NB) accumulators: a gather, an add and a scatter of one
    cell per key, no two keys on one cell.  The sums start at -0.0 (the
    identity of IEEE addition), and where some slot of the ring did not
    match, ``+ 0.0`` at the end gives the zero sign the reference's
    ``+0.0`` addends leave, so every bit agrees.  Adds and multiplies are
    separate operations: no fused multiply-add.
    """
    K, C = v.shape
    NB = bucket_ids.shape[1]
    dev = v.device
    cells = K * NB
    base = torch.arange(K, dtype=torch.int64, device=dev) * NB
    acc_sum = torch.full((cells,), -0.0, dtype=torch.float32, device=dev)
    acc_sq = torch.full((cells,), -0.0, dtype=torch.float32, device=dev)
    acc_min = torch.full((cells,), POS_INF, dtype=torch.float32, device=dev)
    acc_max = torch.full((cells,), NEG_INF, dtype=torch.float32, device=dev)
    cnt = torch.zeros((cells,), dtype=torch.int32, device=dev)
    bm = torch.zeros((cells,), dtype=torch.int32, device=dev)
    ids = bucket_ids.reshape(-1)
    cur64 = cur.to(torch.int64)
    for j in range(C):
        rowb = torch.div(ts[:, j].to(torch.int64), bsize,
                         rounding_mode="floor")
        cell = base + torch.remainder(rowb, NB)
        stored = ids[cell]
        m = (cur64 > j) & (stored == rowb) & (stored >= 0)
        x = v[:, j]
        a = acc_sum[cell]
        acc_sum[cell] = torch.where(m, a + x, a)
        a = acc_sq[cell]
        acc_sq[cell] = torch.where(m, a + x * x, a)
        a = acc_min[cell]
        acc_min[cell] = torch.where(m, torch.minimum(a, x), a)
        a = acc_max[cell]
        acc_max[cell] = torch.where(m, torch.maximum(a, x), a)
        cnt[cell] += m.to(torch.int32)
        b = bm[cell]
        bm[cell] = torch.where(m, b | row_bitmap(x), b)
    full = cnt == C
    by_name = {"sum": acc_sum, "count": cnt, "min": acc_min, "max": acc_max,
               "sumsq": acc_sq}
    for i, name in enumerate(LANES):
        acc = by_name.pop(name)
        if name in ("sum", "sumsq"):
            acc = torch.where(full, acc, acc + 0.0)
        stats_out[:, :, i] = acc.view(K, NB)
        del acc
    bitmap_out.copy_(bm.view(K, NB))


def _remap_buckets(bagg: pg.BucketAgg, NB_n: int) -> pg.BucketAgg:
    """Move each bucket state to slot ``id % NB_n`` of a ring of ``NB_n``
    slots; where ids collide the larger (newer) id wins, as the ring keeps
    the newest bucket of a slot.  The merge-order families move with their
    cells (a slot no id lands in is empty); ``seq`` stays."""
    stats, bitmap, bucket = bagg.stats, bagg.bitmap, bagg.bucket
    K, NB_o = bucket.shape
    dev = bucket.device
    b = bucket.to(torch.int64)
    tgt = torch.where(b >= 0, torch.remainder(b, NB_n), NB_n)
    win = torch.full((K, NB_n + 1), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(1, tgt, b, reduce="amax")
    # losers (and empty slots) go to a spill slot past the ring, dropped
    tgt = torch.where((b >= 0) & (win.gather(1, tgt) == b), tgt, NB_n)
    rows = torch.arange(K, device=dev)[:, None].expand(K, NB_o)
    bucket_n = torch.full((K, NB_n + 1), -1, dtype=torch.int32, device=dev)
    bucket_n[rows, tgt] = bucket
    F, NS = stats.shape[2], stats.shape[3]
    stats_n = pg.lanes_identity_stack((K, NB_n + 1, F), dev)
    stats_n[rows, tgt] = stats
    bitmap_n = torch.zeros((K, NB_n + 1, F), dtype=torch.int32, device=dev)
    bitmap_n[rows, tgt] = bitmap

    def move(field: str, t: torch.Tensor) -> torch.Tensor:
        if field == "seq":
            return t
        out = torch.full((K, NB_n + 1) + tuple(t.shape[2:]),
                         pg.FAMILY_EMPTY[field], dtype=t.dtype, device=dev)
        out[rows, tgt] = t
        return out[:, :NB_n].contiguous()

    return pg.BucketAgg(
        stats=stats_n[:, :NB_n].contiguous(),
        bitmap=bitmap_n[:, :NB_n].contiguous(),
        bucket=bucket_n[:, :NB_n].contiguous(), size=bagg.size,
        **{f: move(f, t) for f, t in bagg.families().items()},
    )


def _rebuild_bucket_order(
    ring: st.RingStore,         # the new primary ring, flat (K, C, ...)
    bucket_ids: torch.Tensor,   # (K, NB)
    bsize: int, extreme: bool, tail: bool,
) -> dict:
    """Merge-order families re-derived from the ring's retained rows.

    The absolute arrival index of ring slot ``j`` is
    ``cur-1-((cur-1-j) % C)`` (the newest arrival mapped to that slot),
    so the rebuilt ``(ts, pos)`` coordinates equal having persisted the
    families all along, for every row the ring retains.  A written row
    belongs to the cell ``(key, (ts // bsize) % NB)`` when that slot holds
    its bucket id.  The reference masks a (S, K, NB, C) array on the host;
    here the matching rows are picked from the (K, C) ring and ranked in
    their cells by one sort on the device
    (:func:`~repro_torch.core.preagg.families_from_rows`)."""
    K, C = ring.ts.shape
    NB = bucket_ids.shape[1]
    dev = ring.ts.device
    cur = ring.cursor.to(torch.int64)[:, None]
    j = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
    rowb = torch.div(ring.ts.to(torch.int64), bsize, rounding_mode="floor")
    cell = (torch.arange(K, dtype=torch.int64, device=dev)[:, None] * NB
            + torch.remainder(rowb, NB))
    stored = bucket_ids.reshape(-1)[cell].to(torch.int64)
    match = (j < cur) & (stored == rowb) & (stored >= 0)
    hit = torch.nonzero(match.reshape(-1))[:, 0]
    del rowb, stored, match
    pos = (cur - 1 - torch.remainder(cur - 1 - j, C)).reshape(-1)[hit]
    return pg.families_from_rows(
        cell.reshape(-1)[hit], ring.ts.reshape(-1)[hit], pos,
        ring.vals.reshape(K * C, -1)[hit], K, NB,
        extreme=extreme, tail=tail,
    )


def _migrate_bucket(
    diff: LayoutDiff,
    bagg: pg.BucketAgg,
    new_ring: st.RingStore,
    report: MigrationReport,
) -> pg.BucketAgg:
    """Carry bucket states per lane; remap slots on ``num_buckets``
    changes; re-fold new lanes from the (already migrated) primary ring."""
    src_p, dst_p = diff.old.primary, diff.new.primary
    NB_o, NB_n = diff.old.bucket.num_buckets, diff.new.bucket.num_buckets
    bsize = diff.new.bucket.bucket_size
    stats, bitmap, bucket = bagg.stats, bagg.bitmap, bagg.bucket
    F_o = stats.shape[-2]
    if NB_n != NB_o:
        if bool((bucket >= NB_o).any()):
            # some slot has cycled at least once -> older buckets of the
            # finer / coarser new ring may be unrecoverable
            report.add_deficit(Deficit(
                target="bucket", table=dst_p.table, lanes=None,
                reason=(
                    f"primary: num_buckets {NB_o}->{NB_n} after "
                    "bucket-ring wraparound — a cold rebuild would retain "
                    "different buckets"
                ),
            ))
        bagg = _remap_buckets(bagg, NB_n)
        stats, bitmap, bucket = bagg.stats, bagg.bitmap, bagg.bucket

    # lane remap / rebuild
    K = bucket.shape[0]
    F_n = max(len(dst_p.lanes), 1)
    dev = bucket.device
    keys = [s.key for s in dst_p.lanes]
    if keys == list(src_p.lane_keys[:len(keys)]) and len(keys) == F_o:
        stats_out, bitmap_out = stats, bitmap
    else:
        stats_out = pg.lanes_identity_stack((K, NB_n, F_n), dev)
        bitmap_out = torch.zeros((K, NB_n, F_n), dtype=torch.int32,
                                 device=dev)
    cur = new_ring.cursor
    # the rebuild folds the (already re-capped) NEW ring, so rows beyond
    # EITHER capacity are gone — a cold rebuild's bucket store saw them
    ring_lost = bool(
        (cur > min(src_p.capacity, dst_p.capacity)).any())
    # primary-ring lanes the migration zero-filled for the backfill
    # splice: their ring values are NOT usable as a fold source
    deferred = {
        k
        for d in report.deficits
        if d.target == "ring" and d.ring is None and d.lanes
        for k in d.lanes
    }
    for j, slot in enumerate(dst_p.lanes):
        if slot.key in src_p.lane_keys:
            i = src_p.lane_of(slot.key)
            if stats_out is not stats:
                stats_out[:, :, j] = stats[:, :, i]
                bitmap_out[:, :, j] = bitmap[:, :, i]
        elif slot.key in deferred:
            # identities stay in place; the splice re-folds from history
            report.add_deficit(Deficit(
                target="bucket", table=dst_p.table, lanes=(slot.key,),
                reason=(
                    f"primary: bucket states for deferred lane "
                    f"{slot.key!r} await the backfill splice"
                ),
            ))
        else:
            _rebuild_bucket_lane(
                new_ring.vals[:, :, j], new_ring.ts, cur, bucket, bsize,
                stats_out[:, :, j], bitmap_out[:, :, j])
            if ring_lost:
                report.add_deficit(Deficit(
                    target="bucket", table=dst_p.table, lanes=(slot.key,),
                    reason=(
                        f"primary: bucket states for new lane {slot.key!r} "
                        "rebuilt from ring-retained rows only (older rows "
                        "had aged out)"
                    ),
                ))
    # merge-order families: carried (lane-gathered) when the source has
    # every family and lane the new plan needs, else re-derived from the
    # new ring
    want_ext, want_tail = diff.new.bucket.extreme, diff.new.bucket.tail
    fam = {}
    if want_ext or want_tail:
        # the per-key arrival counter is the ring cursor (both count every
        # arrival); its own tensor, since ingest advances both
        fam["seq"] = cur.clone()
        fam_src = ((not want_ext or bagg.xts is not None)
                   and (not want_tail or bagg.tts is not None))
        lanes_ok = bool(dst_p.lanes) and all(
            s.key in src_p.lane_keys for s in dst_p.lanes)
        if fam_src and lanes_ok:
            li = [src_p.lane_of(s.key) for s in dst_p.lanes]
            same = li == list(range(F_o))
            names = ((("xts", "xpos", "xval", "xhas") if want_ext else ())
                     + (("tts", "tpos", "tval", "tvalid") if want_tail
                        else ()))
            for f in names:
                t = getattr(bagg, f)
                lane_axis = f in ("xval", "tval")
                fam[f] = t[:, :, li] if lane_axis and not same else t
        else:
            fam.update(_rebuild_bucket_order(
                new_ring, bucket, bsize, want_ext, want_tail))
            if ring_lost:
                report.add_deficit(Deficit(
                    target="bucket", table=dst_p.table, lanes=None,
                    reason=(
                        "primary: merge-order bucket states (extreme/tail)"
                        " rebuilt from ring-retained rows only (older rows"
                        " had aged out)"
                    ),
                ))
    report.migrated.append(
        f"bucket[{NB_o}->{NB_n} x {bsize}, lanes {F_o}->{F_n}]"
    )
    return pg.BucketAgg(stats=stats_out, bitmap=bitmap_out, bucket=bucket,
                        size=bsize, **fam)


# ---------------------------------------------------------------------------
# The migration
# ---------------------------------------------------------------------------


class _Deferrer:
    """The per-ring lane-deferral hook: a new lane that cannot be
    synthesized is zero-filled and recorded as a deficit — but only when
    the backfill source holds the table's history columns, so a migration
    never defers into an unservable splice."""

    def __init__(self, backfill, plan: RingPlan, ring_ix, report):
        self.backfill, self.plan = backfill, plan
        self.ring_ix, self.report = ring_ix, report

    def accepts(self, slot: LaneSlot) -> bool:
        return self.backfill.covers(self.plan.table, slot.expr)

    def __call__(self, slot: LaneSlot, why: str) -> bool:
        if not self.accepts(slot):
            return False
        self.report.add_deficit(Deficit(
            target="ring", table=self.plan.table, ring=self.ring_ix,
            lanes=(slot.key,),
            reason=f"{why} — deferred to the offline backfill splice",
        ))
        return True


def _make_deferrer(backfill, plan: RingPlan, ring_ix, report):
    return None if backfill is None else _Deferrer(backfill, plan, ring_ix,
                                                   report)


def migrate_state(
    diff: LayoutDiff,
    old_state: OnlineState,
    store,  # the OnlineFeatureStore, still on diff.old
    backfill=None,  # repro_torch.offline.backfill.BackfillSource
) -> Tuple[OnlineState, MigrationReport]:
    """Transform ``old_state`` (laid out per ``diff.old``, the store's
    public shape) into a state laid out per ``diff.new``, in flat form
    (module doc); the caller places it
    (:meth:`~repro_torch.core.online.OnlineFeatureStore._place_state`).
    Nothing writes ``old_state``: a migration that raises leaves it as
    it was.

    ``backfill`` only changes *refusal* behaviour here: lanes that cannot
    be synthesized from stored columns are deferred (zero-filled and
    recorded in ``report.deficits``) when the source covers their table.
    The splice happens in the caller, against the full report.
    """
    sharded = diff.new.num_shards is not None
    S = diff.new.num_shards or 1
    old = store._flat_state(old_state)
    device = old.ring.ts.device
    report = MigrationReport(diff_summary=diff.summary())
    tracer = get_telemetry().tracer

    with tracer.span("migrate", tables=len(diff.new.tables)):
        # -- primary ring + bucket store -----------------------------------
        if diff.primary_carried:
            with tracer.span("migrate.carry", table=diff.new.primary.table):
                ring = old.ring
            report.carried.append(diff.new.primary.describe())
        else:
            ring = _relane_ring(
                diff.old.primary, diff.new.primary, old.ring, report,
                ring_ix=None,
                defer=_make_deferrer(backfill, diff.new.primary, None,
                                     report),
            )
        if diff.bucket_carried:
            with tracer.span("migrate.carry", table="bucket"):
                bagg = old.bagg
            report.carried.append(
                f"bucket[{diff.new.bucket.num_buckets} x "
                f"{diff.new.bucket.bucket_size}]"
            )
        else:
            with tracer.span("migrate.bucket", table=diff.new.primary.table):
                bagg = _migrate_bucket(diff, old.bagg, ring, report)

        # -- secondary rings ------------------------------------------------
        sec: List[st.RingStore] = []
        for i, plan in enumerate(diff.new.tables):
            src = diff.ring_sources[i]
            if src is None:
                with tracer.span("migrate.fresh", table=plan.table):
                    sec.append(_fresh_ring(plan, S, device))
                report.fresh.append(plan.describe())
                continue
            src_plan = diff.old.tables[src]
            if diff.carried[i]:
                with tracer.span("migrate.carry", table=plan.table):
                    sec.append(old.sec[src])
                report.carried.append(plan.describe())
            elif (
                src_plan.partitioned == plan.partitioned
                and src_plan.ring_keys == plan.ring_keys
            ):
                sec.append(_relane_ring(
                    src_plan, plan, old.sec[src], report, ring_ix=i,
                    defer=_make_deferrer(backfill, plan, i, report),
                ))
            else:
                sec.append(_reroute_ring(
                    src_plan, plan, old.sec[src], store, sharded, report,
                    ring_ix=i,
                    defer=_make_deferrer(backfill, plan, i, report),
                ))
        for i in diff.dropped:
            report.dropped.append(diff.old.tables[i].describe())

    return OnlineState(ring=ring, bagg=bagg, sec=tuple(sec)), report

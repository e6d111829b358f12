"""Two-level window pre-aggregation — the per-(key, bucket) state store.

OpenMLDB materializes per-bucket partial aggregates so a long RANGE window
composes O(window/bucket) bucket states plus two raw boundary scans.  This
module is that bucket store: a dense per-key ring of persisted aggregate
**states** of :mod:`repro_torch.core.aggregates` — the stat-lane vector
(sum, count, min, max, sumsq) plus the 32-bit distinct bitmap per
(key, bucket, field).

It ports the reference package's ``repro.core.preagg`` whole: beside the
lanes and bitmap, a plan with FIRST / LAST / TOPN_FREQ over a RANGE window
persists the merge-order families — each (key, bucket)'s oldest and
newest row and its newest :data:`~repro_torch.core.aggregates.TOPN_TAIL`
rows, identified by ``(ts, pos)`` with ``pos`` the row's per-key arrival
index (``seq``, which equals the ring cursor).

:func:`bucket_ingest` updates the tensors **in place**.  Its per-segment
float sums fold in batch-row order, one position at a time across all
segments — never through ``index_add_`` / ``scatter_add_``, whose
accumulation order is not fixed on CUDA — so it associates exactly as the
reference's row-order scatter does.  :func:`bucket_families_ingest`
updates the merge-order families alone: the online store runs it before
the fused ingest kernel (B1), which keeps the six core arrays, so the
families read the bucket ids from before the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.aggregates import (
    NUM_STATS,
    TOPN_TAIL,
    lanes_combine_stack,
    lanes_identity_stack,
    lanes_lift_stack,
    row_bitmap,
)

__all__ = [
    "BucketAgg",
    "FAMILY_EMPTY",
    "bucket_init",
    "bucket_init_plan",
    "bucket_ingest",
    "bucket_families_ingest",
    "families_from_rows",
    "family_init",
    "NUM_STATS",
]

_TS_EMPTY = -2147483648

# each merge-order family tensor's value in an empty (key, bucket) cell
FAMILY_EMPTY = {
    "xts": _TS_EMPTY, "xpos": 0, "xval": 0.0, "xhas": False,
    "tts": _TS_EMPTY, "tpos": 0, "tval": 0.0, "tvalid": False,
}


@dataclasses.dataclass
class BucketAgg:
    """Per-key ring of per-bucket partial aggregate states.

    stats  : (K, NB, F, NUM_STATS) f32  stat-lane states (aggregates.LANES)
    bitmap : (K, NB, F) int32   32-bit linear-counting bitmap per field
    bucket : (K, NB) int32      absolute bucket id held in each slot (-1 empty)

    Merge-order state families (``None`` unless the plan persists them —
    a view with FIRST/LAST/TOPN_FREQ over a RANGE window):

    seq    : (K,) int32         per-key arrival counter (== the ring
                                cursor); a row's ``pos`` is its arrival index
    xts/xpos/xhas : (K, NB, 2)  extreme winner per direction
                                (0 = oldest / FIRST, 1 = newest / LAST)
    xval   : (K, NB, F, 2)      the winner row's lane values
    tts/tpos/tvalid : (K, NB, T) newest-first tail of the bucket's rows by
                                (ts, pos), T = aggregates.TOPN_TAIL
    tval   : (K, NB, F, T)      the tail rows' lane values
    """

    stats: torch.Tensor
    bitmap: torch.Tensor
    bucket: torch.Tensor
    size: int  # bucket width in time units
    seq: Optional[torch.Tensor] = None
    xts: Optional[torch.Tensor] = None
    xpos: Optional[torch.Tensor] = None
    xval: Optional[torch.Tensor] = None
    xhas: Optional[torch.Tensor] = None
    tts: Optional[torch.Tensor] = None
    tpos: Optional[torch.Tensor] = None
    tval: Optional[torch.Tensor] = None
    tvalid: Optional[torch.Tensor] = None

    @property
    def num_buckets(self) -> int:
        return self.bucket.shape[1]

    def families(self) -> Dict[str, torch.Tensor]:
        """The merge-order family tensors present, by field name."""
        return {f: getattr(self, f) for f in ("seq",) + tuple(FAMILY_EMPTY)
                if getattr(self, f) is not None}

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "BucketAgg":
        """A BucketAgg of ``fn`` applied to every tensor present (each
        has the key axis first)."""
        return BucketAgg(
            stats=fn(self.stats), bitmap=fn(self.bitmap),
            bucket=fn(self.bucket), size=self.size,
            **{f: fn(t) for f, t in self.families().items()},
        )


def family_init(
    num_keys: int, num_buckets: int, width: int, device: torch.device,
    *, extreme: bool, tail: bool,
) -> Dict[str, torch.Tensor]:
    """Empty merge-order family tensors (``seq`` included) by field name:
    the extreme family, the tail family, both or none."""
    cell = (num_keys, num_buckets)
    out = {}
    if extreme or tail:
        out["seq"] = torch.zeros((num_keys,), dtype=torch.int32,
                                 device=device)
    shapes = {}
    if extreme:
        shapes.update(xts=cell + (2,), xpos=cell + (2,),
                      xval=cell + (width, 2), xhas=cell + (2,))
    if tail:
        T = TOPN_TAIL
        shapes.update(tts=cell + (T,), tpos=cell + (T,),
                      tval=cell + (width, T), tvalid=cell + (T,))
    for f, shape in shapes.items():
        fill = FAMILY_EMPTY[f]
        dtype = (torch.bool if isinstance(fill, bool) else
                 torch.float32 if isinstance(fill, float) else torch.int32)
        out[f] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


def bucket_init(
    num_keys: int, num_buckets: int, width: int, size: int,
    device: torch.device, *, extreme: bool = False, tail: bool = False,
) -> BucketAgg:
    cell = (num_keys, num_buckets)
    return BucketAgg(
        stats=lanes_identity_stack(cell + (width,), device),
        bitmap=torch.zeros(cell + (width,), dtype=torch.int32, device=device),
        bucket=torch.full(cell, -1, dtype=torch.int32, device=device),
        size=size,
        **family_init(num_keys, num_buckets, width, device,
                      extreme=extreme, tail=tail),
    )


def families_from_rows(
    cell: torch.Tensor,   # (M,) int64 flat (key, bucket slot) cell
    ts: torch.Tensor,     # (M,) int32
    pos: torch.Tensor,    # (M,) int64 per-key arrival index
    vals: torch.Tensor,   # (M, F) f32
    num_keys: int, num_buckets: int, *, extreme: bool, tail: bool,
) -> Dict[str, torch.Tensor]:
    """The merge-order families (without ``seq``) of a set of rows, each
    row already assigned to the cell whose bucket it belongs to: per cell
    the oldest and the newest row by ``(ts, pos)`` and the newest
    :data:`TOPN_TAIL` rows, newest first.  ``(ts, pos)`` is unique within
    a key, so ``ts * 2^32 + pos`` orders a cell's rows exactly; one sort
    by (cell, that key descending) ranks every row in its cell.  Hot
    deploy's rebuild from the ring and the backfill's derivation from
    history both come here."""
    F = vals.shape[1]
    out = family_init(num_keys, num_buckets, F, cell.device,
                      extreme=extreme, tail=tail)
    del out["seq"]
    if cell.numel() == 0:
        return out
    comb = ts.to(torch.int64) * (1 << 32) + pos
    o1 = torch.sort(comb, descending=True, stable=True).indices
    order = o1[torch.sort(cell[o1], stable=True).indices]
    c = cell[order]
    n = c.numel()
    first_of = torch.ones(n, dtype=torch.bool, device=c.device)
    first_of[1:] = c[1:] != c[:-1]
    gid = torch.cumsum(first_of, 0) - 1
    first = torch.nonzero(first_of)[:, 0]
    count = torch.cat([first[1:], first.new_tensor([n])]) - first
    rank = torch.arange(n, device=c.device) - first[gid]   # 0 = newest
    cells = num_keys * num_buckets
    if extreme:
        for d, sel in ((0, rank == count[gid] - 1), (1, rank == 0)):
            r, cc = order[sel], c[sel]
            out["xts"].view(cells, 2)[cc, d] = ts[r]
            out["xpos"].view(cells, 2)[cc, d] = pos[r].to(torch.int32)
            out["xval"].view(cells, F, 2)[cc, :, d] = vals[r]
            out["xhas"].view(cells, 2)[cc, d] = True
    if tail:
        T = TOPN_TAIL
        sel = rank < T
        r, cc, rk = order[sel], c[sel], rank[sel]
        out["tts"].view(cells, T)[cc, rk] = ts[r]
        out["tpos"].view(cells, T)[cc, rk] = pos[r].to(torch.int32)
        out["tval"].view(cells, F, T)[cc, :, rk] = vals[r]
        out["tvalid"].view(cells, T)[cc, rk] = True
    return out


def bucket_init_plan(plan, num_keys: int, width: int,
                     device: torch.device) -> BucketAgg:
    """Initialize a bucket store from a :class:`~repro_torch.core.layout.
    BucketPlan`, with the merge-order families it persists."""
    return bucket_init(
        num_keys, plan.num_buckets, width, plan.bucket_size, device,
        extreme=plan.extreme, tail=plan.tail,
    )


def segment_fold(
    starts: torch.Tensor,   # (G,) first row of each segment
    lengths: torch.Tensor,  # (G,) rows per segment (>= 1)
    rows: torch.Tensor,     # (N, ...) lifted row states
    ident: torch.Tensor,    # (G, ...) identity states
    combine,
) -> torch.Tensor:
    """Fold each segment's rows in row order: ``((ident ⊕ r0) ⊕ r1) …``.

    Vectorized over segments, sequential over the position within a
    segment (one step per position up to the longest segment), so the
    association is fixed whatever the device.
    """
    acc = ident
    longest = int(lengths.max()) if lengths.numel() else 0
    for p in range(longest):
        live = lengths > p
        g = torch.nonzero(live)[:, 0]
        acc[g] = combine(acc[g], rows[starts[g] + p])
    return acc


def _drop_pads(agg: BucketAgg, key, ts, vals):
    """The batch without its pad rows (key == K), which write nothing."""
    real = key < agg.bucket.shape[0]
    if not bool(real.all()):
        key, ts, vals = key[real], ts[real], vals[real]
    return key, ts, vals


def bucket_families_ingest(
    agg: BucketAgg,
    key: torch.Tensor,   # (N,) int32 sorted by (key, ts); == K marks a pad
    ts: torch.Tensor,    # (N,) int32
    vals: torch.Tensor,  # (N, F) f32
) -> BucketAgg:
    """Merge an ingest batch into the merge-order families only, in place
    (no-op for a store without them); ``stats`` / ``bitmap`` / ``bucket``
    are read, never written, so this runs before the kernel that writes
    them and sees the bucket ids from before the batch.

    The reference's family update, step for step: a row's ``pos`` is
    ``seq[key]`` plus its rank in the key's run; a slot whose stored id
    is stale starts empty; each (key, bucket) segment's first and last rows
    (``(ts, pos)`` ascends within it) challenge the stored oldest / newest
    winners; its newest ``T`` rows merge with the stored tail by an LSD
    stable descending sort (pos pass, then ts pass, on ``~pos`` / ``~ts``,
    so invalid entries sort last) and the first ``T`` are kept.
    """
    if agg.seq is None:
        return agg
    key, ts, vals = _drop_pads(agg, key, ts, vals)
    n = key.shape[0]
    if n == 0:
        return agg
    dev = key.device
    nb = agg.num_buckets
    bucket_id = torch.div(ts, agg.size, rounding_mode="floor")
    idx = torch.arange(n, device=dev)
    new_key = torch.ones(n, dtype=torch.bool, device=dev)
    new_key[1:] = key[1:] != key[:-1]
    new_seg = new_key.clone()
    new_seg[1:] |= bucket_id[1:] != bucket_id[:-1]
    run_start = torch.cummax(torch.where(new_key, idx, 0), 0).values
    kl = key.long()
    pos = agg.seq[kl] + (idx - run_start).to(torch.int32)
    starts = torch.nonzero(new_seg)[:, 0]
    ends = torch.cat([starts[1:], starts.new_tensor([n])]) - 1

    k = kl[ends]
    s = (bucket_id[ends] % nb).long()
    stored = agg.bucket[k, s]
    stale = (stored != bucket_id[ends]) & (stored != -1)

    if agg.xts is not None:
        # within a segment ts and pos both ascend: the lex-oldest row is
        # the segment's first, the lex-newest its last
        c_rows = torch.stack([starts, ends], dim=-1)           # (G, 2)
        c_ts, c_pos = ts[c_rows], pos[c_rows]
        c_val = vals[c_rows].transpose(1, 2)                   # (G, F, 2)
        st2 = stale[:, None]
        g_ts = torch.where(st2, _TS_EMPTY, agg.xts[k, s])
        g_pos = torch.where(st2, 0, agg.xpos[k, s])
        g_val = torch.where(stale[:, None, None], 0.0, agg.xval[k, s])
        g_has = agg.xhas[k, s] & ~st2
        older = (c_ts < g_ts) | ((c_ts == g_ts) & (c_pos < g_pos))
        newer = (c_ts > g_ts) | ((c_ts == g_ts) & (c_pos > g_pos))
        take = ~g_has | torch.stack([older[:, 0], newer[:, 1]], dim=-1)
        agg.xts[k, s] = torch.where(take, c_ts, g_ts)
        agg.xpos[k, s] = torch.where(take, c_pos, g_pos)
        agg.xval[k, s] = torch.where(take[:, None, :], c_val, g_val)
        agg.xhas[k, s] = True

    if agg.tts is not None:
        T = agg.tts.shape[-1]
        # newest-first candidate rows of each segment (rows ascend by
        # (ts, pos), so counting back from the segment's end is exact)
        t_rows = ends[:, None] - torch.arange(T, device=dev)[None, :]
        in_seg = t_rows >= starts[:, None]                     # (G, T)
        t_rc = t_rows.clamp(0, n - 1)
        ct_ts = torch.where(in_seg, ts[t_rc], _TS_EMPTY)
        ct_pos = torch.where(in_seg, pos[t_rc], _TS_EMPTY)
        ct_val = torch.where(in_seg[:, None, :],
                             vals[t_rc].transpose(1, 2), 0.0)  # (G, F, T)
        gt_valid = agg.tvalid[k, s] & ~stale[:, None]
        gt_val = torch.where(stale[:, None, None], 0.0, agg.tval[k, s])
        m_ts = torch.cat(
            [ct_ts, torch.where(gt_valid, agg.tts[k, s], _TS_EMPTY)], 1)
        m_pos = torch.cat(
            [ct_pos, torch.where(gt_valid, agg.tpos[k, s], _TS_EMPTY)], 1)
        m_val = torch.cat([ct_val, gt_val], 2)                 # (G, F, 2T)
        m_valid = torch.cat([in_seg, gt_valid], 1)
        # LSD stable descending sort by (ts, pos): pos pass, then ts pass
        o1 = torch.argsort(~m_pos, dim=1, stable=True)
        o2 = torch.argsort(~torch.gather(m_ts, 1, o1), dim=1, stable=True)
        perm = torch.gather(o1, 1, o2)[:, :T]
        s_valid = torch.gather(m_valid, 1, perm)
        agg.tts[k, s] = torch.gather(m_ts, 1, perm)
        agg.tpos[k, s] = torch.where(
            s_valid, torch.gather(m_pos, 1, perm), 0)
        s_val = torch.gather(
            m_val, 2, perm[:, None, :].expand(-1, m_val.shape[1], -1))
        agg.tval[k, s] = torch.where(s_valid[:, None, :], s_val, 0.0)
        agg.tvalid[k, s] = s_valid

    # one add per key run: its row count
    run_first = torch.nonzero(new_key)[:, 0]
    run_len = torch.cat([run_first[1:], run_first.new_tensor([n])]) - run_first
    agg.seq[kl[run_first]] += run_len.to(torch.int32)
    return agg


def bucket_ingest(
    agg: BucketAgg,
    key: torch.Tensor,   # (N,) int32 sorted by (key, ts); == K marks a pad
    ts: torch.Tensor,    # (N,) int32
    vals: torch.Tensor,  # (N, F) f32
) -> BucketAgg:
    """Merge an ingest batch into the bucket states, in place.

    Constraint (callers ensure it): a batch spans fewer than NB buckets, so
    each (key, slot) receives at most one new bucket id.  A slot holding a
    stale bucket id is reset to identity first (ring reuse).  Pad rows
    (key == K) write nothing.  The merge-order families, where the store
    has them, go first (:func:`bucket_families_ingest`).
    """
    # pad rows write nothing: drop them before the sequential fold, where
    # a padded batch's one pad segment would cost a step per pad row
    key, ts, vals = _drop_pads(agg, key, ts, vals)
    n = key.shape[0]
    if n == 0:
        return agg
    bucket_families_ingest(agg, key, ts, vals)
    nb = agg.num_buckets
    dev = key.device
    bucket_id = torch.div(ts, agg.size, rounding_mode="floor")
    slot = bucket_id % nb

    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = (key[1:] != key[:-1]) | (bucket_id[1:] != bucket_id[:-1])
    starts = torch.nonzero(new_seg)[:, 0]
    ends = torch.cat([starts[1:], torch.tensor([n], device=dev)]) - 1
    lengths = ends - starts + 1

    width = vals.shape[1]
    g = starts.shape[0]
    seg_stats = segment_fold(
        starts, lengths, lanes_lift_stack(vals),
        lanes_identity_stack((g, width), dev), lanes_combine_stack,
    )
    seg_bm = segment_fold(
        starts, lengths, row_bitmap(vals),
        torch.zeros((g, width), dtype=torch.int32, device=dev),
        torch.bitwise_or,
    )

    # one representative (= last) row per segment
    k = key[ends].long()
    s = slot[ends].long()
    b = bucket_id[ends]

    stored = agg.bucket[k, s]
    stale = (stored != b) & (stored != -1)
    base = torch.where(
        stale[:, None, None],
        lanes_identity_stack(seg_stats.shape[:-1], dev),
        agg.stats[k, s],
    )
    agg.stats[k, s] = lanes_combine_stack(base, seg_stats)
    agg.bitmap[k, s] = torch.where(stale[:, None], 0, agg.bitmap[k, s]) | seg_bm
    agg.bucket[k, s] = b
    return agg

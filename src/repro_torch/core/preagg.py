"""Two-level window pre-aggregation — the per-(key, bucket) state store.

OpenMLDB materializes per-bucket partial aggregates so a long RANGE window
composes O(window/bucket) bucket states plus two raw boundary scans.  This
module is that bucket store: a dense per-key ring of persisted aggregate
**states** of :mod:`repro_torch.core.aggregates` — the stat-lane vector
(sum, count, min, max, sumsq) plus the 32-bit distinct bitmap per
(key, bucket, field).

It ports the lanes and bitmap families of the reference package's
``repro.core.preagg``.  The merge-order families (FIRST / LAST / TOPN_FREQ
over RANGE windows) are not persisted yet: :func:`bucket_init` raises for a
plan that asks for them rather than serve a wrong answer.

:func:`bucket_ingest` updates the tensors **in place**.  Its per-segment
float sums fold in batch-row order, one position at a time across all
segments — never through ``index_add_`` / ``scatter_add_``, whose
accumulation order is not fixed on CUDA — so it associates exactly as the
reference's row-order scatter does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.aggregates import (
    NUM_STATS,
    lanes_combine_stack,
    lanes_identity_stack,
    lanes_lift_stack,
    row_bitmap,
)

__all__ = [
    "BucketAgg",
    "bucket_init",
    "bucket_init_plan",
    "bucket_ingest",
    "NUM_STATS",
]


@dataclasses.dataclass
class BucketAgg:
    """Per-key ring of per-bucket partial aggregate states.

    stats  : (K, NB, F, NUM_STATS) f32  stat-lane states (aggregates.LANES)
    bitmap : (K, NB, F) int32   32-bit linear-counting bitmap per field
    bucket : (K, NB) int32      absolute bucket id held in each slot (-1 empty)
    """

    stats: torch.Tensor
    bitmap: torch.Tensor
    bucket: torch.Tensor
    size: int  # bucket width in time units

    @property
    def num_buckets(self) -> int:
        return self.bucket.shape[1]


def bucket_init(
    num_keys: int, num_buckets: int, width: int, size: int,
    device: torch.device, *, extreme: bool = False, tail: bool = False,
) -> BucketAgg:
    if extreme or tail:
        fam = "extreme (FIRST/LAST)" if extreme else "tail (TOPN_FREQ)"
        raise NotImplementedError(
            f"bucket state family {fam} over RANGE windows is not ported "
            "yet; serve such views with the reference package"
        )
    return BucketAgg(
        stats=lanes_identity_stack((num_keys, num_buckets, width), device),
        bitmap=torch.zeros(
            (num_keys, num_buckets, width), dtype=torch.int32, device=device
        ),
        bucket=torch.full(
            (num_keys, num_buckets), -1, dtype=torch.int32, device=device
        ),
        size=size,
    )


def bucket_init_plan(plan, num_keys: int, width: int,
                     device: torch.device) -> BucketAgg:
    """Initialize a bucket store from a :class:`~repro_torch.core.layout.
    BucketPlan`."""
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
    (key == K) write nothing.
    """
    K, nb = agg.bucket.shape
    # pad rows write nothing: drop them before the sequential fold, where
    # a padded batch's one pad segment would cost a step per pad row
    real = key < K
    if not bool(real.all()):
        key, ts, vals = key[real], ts[real], vals[real]
    n = key.shape[0]
    if n == 0:
        return agg
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

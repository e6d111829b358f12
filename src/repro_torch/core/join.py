"""Point-in-time multi-table primitives: LAST JOIN + WINDOW UNION.

The reference package's ``repro.core.join``, over (key, ts)-sorted
tensors:

* **LAST JOIN** — for each primary row, the most recent secondary row with
  a matching key and ``ts <= primary ts``: one vectorized lexicographic
  binary search (``searchsorted(side="right")`` over (key, ts) pairs,
  int32, no int64 composite) and one gather.
* **WINDOW UNION** — the per-key window runs over the primary stream
  merged by timestamp with secondary streams: concatenate, stable-sort by
  (key, ts, stream rank) — secondary rows sort before primary rows at
  equal timestamps, so they are inside the primary row's window — and run
  the ordinary window machinery over the merged stream.

All results are integer gathers and stable sorts, so they equal the
reference's bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = [
    "pit_searchsorted",
    "last_join_gather",
    "merge_streams",
]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx)


def pit_searchsorted(
    skey: torch.Tensor,  # (M,) int32, sorted by (key, ts)
    sts: torch.Tensor,   # (M,) int32
    qkey: torch.Tensor,  # (Q,) int32 query join keys
    qts: torch.Tensor,   # (Q,) int32 query timestamps
) -> torch.Tensor:
    """Right insertion point of (qkey, qts) in the sorted (skey, sts) pairs:
    (Q,) int32 counts of rows with (skey, sts) <= (qkey, qts)
    lexicographically."""
    m = skey.shape[0]
    lo = torch.zeros(qkey.shape, dtype=torch.int32, device=qkey.device)
    hi = torch.full(qkey.shape, m, dtype=torch.int32, device=qkey.device)
    steps = max(1, int(math.ceil(math.log2(max(m, 2)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        midc = torch.clamp(mid, max=m - 1)
        k_m, t_m = _take(skey, midc), _take(sts, midc)
        le = (k_m < qkey) | ((k_m == qkey) & (t_m <= qts))
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    return lo


def last_join_gather(
    skey: torch.Tensor,   # (M,) int32, secondary sorted by (key, ts)
    sts: torch.Tensor,    # (M,) int32
    svals: torch.Tensor,  # (M,) f32 pre-evaluated join expression values
    qkey: torch.Tensor,   # (Q,) int32 primary join-key column
    qts: torch.Tensor,    # (Q,) int32 primary timestamps
    default: float = 0.0,
) -> torch.Tensor:
    """Point-in-time LAST JOIN gather: the value of the newest secondary
    row with ``skey == qkey`` and ``sts <= qts``; ``default`` when no row
    matches (including an empty secondary table)."""
    if skey.shape[0] == 0:
        return torch.full(qkey.shape, float(default), dtype=torch.float32,
                          device=qkey.device)
    j = pit_searchsorted(skey, sts, qkey, qts) - 1
    jc = torch.clamp(j, min=0)
    found = (j >= 0) & (_take(skey, jc) == qkey)
    return torch.where(found, _take(svals, jc), float(default))


def _stable_argsort_by(vals: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Compose ``perm`` with a stable argsort of ``vals[perm]``."""
    order = torch.argsort(_take(vals, perm), stable=True)
    return _take(perm, order)


def merge_streams(
    keys: Sequence[torch.Tensor],
    tss: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge several (key, ts) streams into one (key, ts, rank)-sorted stream.

    Stream order is the tie rank: at equal (key, ts), rows of an earlier
    stream sort first.  Returns (perm, key_m, ts_m, rank_m): ``perm``
    (int64) indexes the concatenated arrays (concatenation order = stream
    order); key / ts / rank are the merged sorted streams.  Two stable
    argsorts over the concatenation (already in (rank, row) order) — an
    LSD radix, so rows of one stream keep their relative order.
    """
    dev = keys[0].device
    rank = torch.cat([
        torch.full(k.shape, i, dtype=torch.int32, device=dev)
        for i, k in enumerate(keys)
    ])
    key = torch.cat(list(keys)).to(torch.int32)
    ts = torch.cat(list(tss)).to(torch.int32)
    perm = torch.arange(key.shape[0], dtype=torch.int64, device=dev)
    perm = _stable_argsort_by(ts, perm)
    perm = _stable_argsort_by(key, perm)
    return perm, _take(key, perm), _take(ts, perm), _take(rank, perm)

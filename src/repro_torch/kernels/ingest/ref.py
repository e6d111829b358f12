"""Plain PyTorch version of the fused ingest kernel — the split oracle.

The ring scatter (:func:`repro_torch.core.storage.ring_ingest`) followed by
the bucket pre-agg merge (:func:`repro_torch.core.preagg.bucket_ingest`),
over raw state arrays, updating them in place.  This is the same two-pass
sequence the reference package's ``kernels/ingest/ref.py`` runs, and the
CUDA kernel must equal it bit for bit on all six arrays.  The CPU path of
:func:`repro_torch.kernels.ingest.ops.fused_ingest` runs it; on the GPU
only the comparisons in ``chip_smoke.py`` and the CUDA tests call it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import preagg as pg
from repro_torch.core import storage as st

__all__ = ["fused_ingest_ref"]


def fused_ingest_ref(
    ring_ts: torch.Tensor,    # (K, C) int32
    ring_vals: torch.Tensor,  # (K, C, F) f32
    cursor: torch.Tensor,     # (K,) int32
    bstats: torch.Tensor,     # (K, NB, F, NUM_STATS) f32
    bbitmap: torch.Tensor,    # (K, NB, F) int32
    bbucket: torch.Tensor,    # (K, NB) int32
    key: torch.Tensor,        # (N,) int32 sorted by (key, ts); pad key == K
    ts: torch.Tensor,         # (N,) int32
    vals: torch.Tensor,       # (N, F) f32
    *,
    bucket_size: int,
) -> Tuple[torch.Tensor, ...]:
    ring = st.RingStore(ts=ring_ts, vals=ring_vals, cursor=cursor)
    bagg = pg.BucketAgg(
        stats=bstats, bitmap=bbitmap, bucket=bbucket, size=bucket_size
    )
    # the bucket merge reads no ring state, so the order of the two
    # in-place passes does not matter; ring first, as the reference
    st.ring_ingest(ring, key, ts, vals)
    pg.bucket_ingest(bagg, key, ts, vals)
    return ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket

"""Feature signatures and hash embeddings — the id side of FeatInsight's
high-dimensional toolkit.

A signature folds one or more (possibly crossed) categorical columns into
a bounded hashed id space, so a trillion-dimensional cross never
materializes.  A model reads a signature through a hash embedding: k
independent re-hashes probe a shared ``(V, D)`` table and the probed rows
combine with weights.  The gather itself is the signature-embedding kernel
(:mod:`repro_torch.kernels.signature`).

Also here: a count-min sketch (the streaming top-N support structure)
for global heavy hitters, complementary to the exact per-key window
TOPN_FREQ in the engine.

The same functions as the reference package's ``repro.core.signature``,
bit for bit on the ids and on the sketch's counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.hashing import fold_hash, mix64
from repro_torch.core.preagg import segment_fold

__all__ = [
    "signature_ids",
    "multi_hash_ids",
    "hash_embedding_lookup_ref",
    "CountMinSketch",
    "cms_init",
    "cms_update",
    "cms_query",
]


def signature_ids(
    cols: Sequence[torch.Tensor], bits: int = 20, salt: int = 0
) -> torch.Tensor:
    """Fold feature columns into one int32 signature id per row, in
    [0, 2**bits).  Int columns convert to int32 (wrapping), float32
    columns hash their bit patterns."""
    return fold_hash([torch.as_tensor(c) for c in cols], salt=salt, bits=bits)


def multi_hash_ids(
    sig: torch.Tensor, num_hashes: int, table_size: int
) -> torch.Tensor:
    """k independent re-hashes of a signature into a smaller table:
    (...,) int32 -> (..., k) int32 in [0, table_size)."""
    hs = [
        mix64(sig, salt=0x85EB * (j + 1) + 17, bits=31) % table_size
        for j in range(num_hashes)
    ]
    return torch.stack(hs, dim=-1).to(torch.int32)


def hash_embedding_lookup_ref(
    table: torch.Tensor,     # (V, D)
    sig: torch.Tensor,       # (...,) int32 signatures
    weights: torch.Tensor,   # (num_hashes,) or (..., num_hashes)
    num_hashes: int = 2,
) -> torch.Tensor:
    """The reference package's einsum oracle for the hash embedding:
    (..., D) in the table's dtype.  The weights are cast to the table's
    dtype before the contraction (for a bf16 table they round to bf16),
    where the kernel and its plain version
    (:func:`repro_torch.kernels.signature.ref.signature_embed_ref`) keep
    them in float32."""
    ids = multi_hash_ids(sig, num_hashes, table.shape[0])
    vecs = table[ids.long()]
    w = torch.broadcast_to(weights, ids.shape).to(vecs.dtype)
    return torch.einsum("...k,...kd->...d", w, vecs)


# ---------------------------------------------------------------------------
# Count-min sketch (streaming heavy hitters)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CountMinSketch:
    counts: torch.Tensor  # (depth, width) float32


def cms_init(depth: int = 4, width: int = 1024,
             device="cuda") -> CountMinSketch:
    return CountMinSketch(
        torch.zeros((depth, width), dtype=torch.float32,
                    device=resolve_device(device))
    )


def _cms_slots(items: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """(depth, N) int64 slot of each item in each row."""
    return torch.stack(
        [
            mix64(items, salt=0x1234 + 31 * d, bits=31) % width
            for d in range(depth)
        ],
        dim=0,
    ).long()


def cms_update(
    sk: CountMinSketch, items: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> CountMinSketch:
    """The sketch with ``items`` ((N,) int) added, each weighted by
    ``weights`` ((N,), default 1).

    The reference scatter-adds all (row, slot) updates at once, and XLA
    adds a cell's updates one after another in item order.  A CUDA
    scatter-add (atomics) adds them in no fixed order, which float
    weights would show; here the updates are stably sorted by cell and
    each cell folds its weights in item order
    (:func:`~repro_torch.core.preagg.segment_fold`), the same bits on
    every device.
    """
    depth, width = sk.counts.shape
    dev = sk.counts.device
    items = torch.as_tensor(items, device=dev)
    slots = _cms_slots(items, depth, width)
    w = (
        torch.ones(items.shape, dtype=torch.float32, device=dev)
        if weights is None
        else torch.as_tensor(weights, device=dev).to(torch.float32)
    )
    cell = (slots + width * torch.arange(depth, device=dev)[:, None]
            ).reshape(-1)
    cell, order = torch.sort(cell, stable=True)
    w = w.expand(depth, -1).reshape(-1)[order]
    uniq, lengths = torch.unique_consecutive(cell, return_counts=True)
    starts = torch.cumsum(lengths, 0) - lengths
    flat = sk.counts.reshape(-1).clone()
    flat[uniq] = segment_fold(
        starts, lengths, w, flat[uniq], lambda a, b: a + b
    )
    return CountMinSketch(flat.reshape(depth, width))


def cms_query(sk: CountMinSketch, items: torch.Tensor) -> torch.Tensor:
    """(N,) float32 estimate of each (N,) item's count: the least of its
    ``depth`` cells (never below the true count for non-negative
    weights)."""
    depth, width = sk.counts.shape
    dev = sk.counts.device
    items = torch.as_tensor(items, device=dev)
    slots = _cms_slots(items, depth, width)
    rows = torch.arange(depth, device=dev)[:, None]
    return sk.counts[rows, slots].min(dim=0).values

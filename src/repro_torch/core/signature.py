"""Feature signatures and hash embeddings — the id side of FeatInsight's
high-dimensional toolkit.

A signature folds one or more (possibly crossed) categorical columns into
a bounded hashed id space, so a trillion-dimensional cross never
materializes.  A model reads a signature through a hash embedding: k
independent re-hashes probe a shared ``(V, D)`` table and the probed rows
combine with weights.  The gather itself is the signature-embedding kernel
(:mod:`repro_torch.kernels.signature`).

The same functions as the reference package's ``repro.core.signature``,
bit for bit on the ids.  Its count-min sketch is not on the scoring path
and is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.hashing import fold_hash, mix64

__all__ = ["signature_ids", "multi_hash_ids", "hash_embedding_lookup_ref"]


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

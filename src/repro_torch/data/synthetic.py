"""Synthetic card-transaction data for the fraud scenario (§3.3).

:data:`FRAUD_SCHEMA` is the reference package's transactions table
(key = card id, heavy-tailed amounts, categorical MCC / device / geo).
:func:`fraud_transactions` draws a batch in bulk with numpy — no per-row
Python loop, so deployment-sized streams (millions of rows) are cheap to
make — returned (card, ts)-sorted, as ingest requires.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.storage import TableSchema

__all__ = ["FRAUD_SCHEMA", "fraud_transactions"]

FRAUD_SCHEMA = TableSchema(
    name="transactions", key="card", ts="ts",
    numeric=("amount",),
    categorical=("mcc", "device", "geo"),
)


def fraud_transactions(
    rng: np.random.Generator,
    n: int,
    num_cards: int,
    t_lo: int,
    t_hi: int,
) -> Dict[str, np.ndarray]:
    """``n`` transactions of uniformly drawn cards with timestamps in
    [t_lo, t_hi), sorted by (card, ts)."""
    card = rng.integers(0, num_cards, n).astype(np.int32)
    ts = rng.integers(t_lo, t_hi, n).astype(np.int32)
    order = np.lexsort((ts, card))
    cols = dict(
        card=card,
        ts=ts,
        amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
        mcc=rng.integers(0, 32, n).astype(np.int32),
        device=rng.integers(0, 8, n).astype(np.int32),
        geo=rng.integers(0, 16, n).astype(np.int32),
    )
    return {c: v[order] for c, v in cols.items()}

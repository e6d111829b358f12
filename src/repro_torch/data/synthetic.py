"""Schemas of the example scenarios and synthetic card-transaction data.

:data:`FRAUD_SCHEMA` (§3.3 card transactions: key = card id, heavy-tailed
amounts, categorical MCC / device / geo), :data:`RECO_SCHEMA` (§3.2
orders) and :data:`MULTITABLE_DB` (transactions + wires union stream +
accounts / merchants profile tables) are the reference package's.
:func:`fraud_transactions` draws a batch in bulk with numpy — no per-row
Python loop, so deployment-sized streams (millions of rows) are cheap to
make — returned (card, ts)-sorted, as ingest requires.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.storage import Database, TableSchema

__all__ = ["FRAUD_SCHEMA", "RECO_SCHEMA", "MULTITABLE_DB",
           "fraud_transactions"]

FRAUD_SCHEMA = TableSchema(
    name="transactions", key="card", ts="ts",
    numeric=("amount",),
    categorical=("mcc", "device", "geo"),
)

RECO_SCHEMA = TableSchema(
    name="orders", key="user", ts="ts",
    numeric=("price", "qty"),
    categorical=("product", "category"),
)

MULTITABLE_DB = Database(
    name="fraud_multitable",
    primary=TableSchema(
        name="transactions", key="account", ts="ts",
        numeric=("amount", "merchant"),
    ),
    secondary=(
        # union stream: same key space + shared "amount" column
        TableSchema(name="wires", key="account", ts="ts", numeric=("amount",)),
        # LAST JOIN targets: slowly-changing profile tables
        TableSchema(
            name="accounts", key="account", ts="ts",
            numeric=("credit_limit", "risk_score"),
        ),
        TableSchema(
            name="merchants", key="merchant", ts="ts",
            numeric=("avg_ticket", "fraud_reports"),
        ),
    ),
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

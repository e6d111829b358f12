"""Schemas of the example scenarios and synthetic card-transaction data.

:data:`FRAUD_SCHEMA` (§3.3 card transactions: key = card id, heavy-tailed
amounts, categorical MCC / device / geo), :data:`RECO_SCHEMA` (§3.2
orders) and :data:`MULTITABLE_DB` (transactions + wires union stream +
accounts / merchants profile tables) are the reference package's.
:func:`fraud_transactions` draws a batch in bulk with numpy — no per-row
Python loop, so deployment-sized streams (millions of rows) are cheap to
make — returned (card, ts)-sorted, as ingest requires.
:func:`multitable_stream` draws the :data:`MULTITABLE_DB` tables; for the
same generator state its columns are byte-identical to the reference
package's ``multitable_stream``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.storage import Database, TableSchema

__all__ = ["FRAUD_SCHEMA", "RECO_SCHEMA", "MULTITABLE_DB",
           "fraud_transactions", "multitable_stream"]

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


def multitable_stream(
    rng: np.random.Generator,
    n: int,
    num_accounts: int = 64,
    num_merchants: int = 16,
    t_max: int = 50_000,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Generate the :data:`MULTITABLE_DB` tables ({table: {col: array}}).

    * ``transactions`` — primary card stream: n rows, heavy-tailed amounts,
      per-account unique timestamps (strictly the paper's request-stream
      shape; uniqueness keeps window tie-semantics trivially well-defined).
    * ``wires``        — ~n/4 wire transfers in the same account id space,
      the WINDOW UNION stream.
    * ``accounts``     — profile updates: a t=0 baseline for every account
      plus sporadic limit/risk revisions (slowly-changing dimension).
    * ``merchants``    — merchant registry with periodic stat refreshes.
    """
    # primary: globally unique timestamps => per-key unique, ties impossible
    ts = (
        np.sort(rng.choice(t_max, size=n, replace=False))
        if n <= t_max
        else np.sort(rng.integers(0, t_max, n))
    ).astype(np.int32)
    transactions = dict(
        account=rng.integers(0, num_accounts, n).astype(np.int32),
        ts=ts,
        amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
        merchant=rng.integers(0, num_merchants, n).astype(np.int32),
    )

    nw = max(n // 4, 1)
    wires = dict(
        account=rng.integers(0, num_accounts, nw).astype(np.int32),
        ts=np.sort(rng.integers(0, t_max, nw)).astype(np.int32),
        amount=rng.gamma(2.0, 120.0, nw).astype(np.float32),
    )

    updates = max(num_accounts // 2, 1)
    accounts = dict(
        account=np.concatenate(
            [np.arange(num_accounts), rng.integers(0, num_accounts, updates)]
        ).astype(np.int32),
        ts=np.concatenate(
            [np.zeros(num_accounts), rng.integers(1, t_max, updates)]
        ).astype(np.int32),
        credit_limit=rng.uniform(500.0, 20_000.0, num_accounts + updates).astype(
            np.float32
        ),
        risk_score=rng.beta(2.0, 8.0, num_accounts + updates).astype(np.float32),
    )

    refreshes = max(num_merchants // 2, 1)
    merchants = dict(
        merchant=np.concatenate(
            [np.arange(num_merchants), rng.integers(0, num_merchants, refreshes)]
        ).astype(np.int32),
        ts=np.concatenate(
            [np.zeros(num_merchants), rng.integers(1, t_max, refreshes)]
        ).astype(np.int32),
        avg_ticket=rng.gamma(2.0, 40.0, num_merchants + refreshes).astype(
            np.float32
        ),
        fraud_reports=rng.poisson(2.0, num_merchants + refreshes).astype(
            np.float32
        ),
    )
    return {
        "transactions": transactions,
        "wires": wires,
        "accounts": accounts,
        "merchants": merchants,
    }

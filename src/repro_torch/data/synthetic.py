"""Synthetic workloads of the example scenarios and the stress suite.

* ``fraud_stream``  — §3.3: card transactions (key=card id, heavy-tailed
  amounts, bursty timestamps, categorical MCC / device / geo columns).
  Fraud labels follow a planted rule over true window aggregates so a
  model trained on FeatInsight features is actually learnable.
* ``fraud_transactions`` — the same columns drawn in bulk with numpy — no
  per-row Python loop, so deployment-sized streams (millions of rows) are
  cheap to make — returned (card, ts)-sorted, as ingest requires.
* ``reco_stream``   — §3.2: minute-level order events (user x product),
  the Vipshop-style recommendation workload.
* ``lm_stream``     — token batches for LM training: a synthetic
  integer-sequence language with local structure (Zipf unigrams + copy
  motifs) so cross-entropy visibly decreases within a few hundred steps.
* ``multitable_stream`` — §1's "complex raw data" challenge (the 2018 PHM
  dataset spans 17 tables): a PHM-flavoured multi-table database of card
  transactions (primary) + wire transfers (union stream) + account
  profiles and merchant registries (point-in-time LAST JOIN targets).
* ``stress_stream`` — matched data for :data:`STRESS_DB`, the stress
  generator's five-table plane.

Every generator except ``fraud_transactions`` is the reference package's
``repro.data.synthetic``: for the same ``np.random.Generator`` state its
columns (and ``fraud_stream``'s labels) are byte-identical, because the
rng draws happen in the same order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.storage import Database, TableSchema

__all__ = [
    "FRAUD_SCHEMA", "RECO_SCHEMA", "MULTITABLE_DB", "STRESS_DB",
    "fraud_stream", "reco_stream", "lm_stream", "multitable_stream",
    "stress_stream", "fraud_transactions",
]

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


STRESS_DB = Database(
    name="stress_plane",
    primary=TableSchema(
        name="events", key="entity", ts="ts",
        numeric=("amount", "quantity", "score", "item"),
    ),
    secondary=(
        # union streams in the primary key space; `refunds` shares two
        # numeric columns with the primary (so two-table union args can
        # reference either), `clicks` only `amount` (so three-way unions
        # exercise the schema-compatibility narrowing)
        TableSchema(
            name="refunds", key="entity", ts="ts",
            numeric=("amount", "quantity"),
        ),
        TableSchema(name="clicks", key="entity", ts="ts", numeric=("amount",)),
        # LAST JOIN targets: a profile table keyed like the primary and a
        # dimension registry keyed by the `item` column
        TableSchema(
            name="profiles", key="entity", ts="ts",
            numeric=("tier", "spend_limit"),
        ),
        TableSchema(
            name="items", key="item", ts="ts",
            numeric=("base_price", "popularity"),
        ),
    ),
)


def stress_stream(
    rng: np.random.Generator,
    n: int,
    num_entities: int = 48,
    num_items: int = 24,
    t_max: int = 40_000,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Matched synthetic data for :data:`STRESS_DB` ({table: {col: array}}).

    Built for the stress generator's verification loop: primary
    timestamps are globally unique (window tie-semantics trivially
    well-defined, so offline==online stays exact for order-sensitive
    aggregates), join targets carry a t=0 baseline row for every key plus
    sporadic revisions, and the union streams are ~n/4 and ~n/6 rows in
    the same entity id space.
    """
    ts = (
        np.sort(rng.choice(t_max, size=n, replace=False))
        if n <= t_max
        else np.sort(rng.integers(0, t_max, n))
    ).astype(np.int32)
    events = dict(
        entity=rng.integers(0, num_entities, n).astype(np.int32),
        ts=ts,
        amount=rng.gamma(1.8, 55.0, n).astype(np.float32),
        quantity=rng.integers(1, 9, n).astype(np.float32),
        score=rng.beta(2.0, 5.0, n).astype(np.float32),
        item=rng.integers(0, num_items, n).astype(np.int32),
    )

    nr = max(n // 4, 1)
    refunds = dict(
        entity=rng.integers(0, num_entities, nr).astype(np.int32),
        ts=np.sort(rng.integers(0, t_max, nr)).astype(np.int32),
        amount=rng.gamma(2.0, 80.0, nr).astype(np.float32),
        quantity=rng.integers(1, 5, nr).astype(np.float32),
    )

    nc = max(n // 6, 1)
    clicks = dict(
        entity=rng.integers(0, num_entities, nc).astype(np.int32),
        ts=np.sort(rng.integers(0, t_max, nc)).astype(np.int32),
        amount=rng.gamma(1.2, 10.0, nc).astype(np.float32),
    )

    updates = max(num_entities // 2, 1)
    profiles = dict(
        entity=np.concatenate(
            [np.arange(num_entities), rng.integers(0, num_entities, updates)]
        ).astype(np.int32),
        ts=np.concatenate(
            [np.zeros(num_entities), rng.integers(1, t_max, updates)]
        ).astype(np.int32),
        tier=rng.integers(0, 5, num_entities + updates).astype(np.float32),
        spend_limit=rng.uniform(
            200.0, 10_000.0, num_entities + updates
        ).astype(np.float32),
    )

    refreshes = max(num_items // 2, 1)
    items = dict(
        item=np.concatenate(
            [np.arange(num_items), rng.integers(0, num_items, refreshes)]
        ).astype(np.int32),
        ts=np.concatenate(
            [np.zeros(num_items), rng.integers(1, t_max, refreshes)]
        ).astype(np.int32),
        base_price=rng.gamma(2.0, 30.0, num_items + refreshes).astype(
            np.float32
        ),
        popularity=rng.beta(1.5, 4.0, num_items + refreshes).astype(
            np.float32
        ),
    )
    return {
        "events": events,
        "refunds": refunds,
        "clicks": clicks,
        "profiles": profiles,
        "items": items,
    }


def fraud_stream(
    rng: np.random.Generator, n: int, num_cards: int = 64, t_max: int = 50_000
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Transactions + planted fraud labels.

    Label rule (unknown to the model): fraud when the 1h rolling sum for
    the card exceeds a threshold AND the current amount is itself large —
    i.e. exactly the kind of decision the paper's 784-feature view feeds.
    The rule is stationary (same fraud rate early and late in the stream)
    so train/serve splits see the same distribution.
    """
    card = rng.integers(0, num_cards, n).astype(np.int32)
    ts = np.sort(rng.integers(0, t_max, n)).astype(np.int32)
    amount = rng.gamma(1.5, 60.0, n).astype(np.float32)
    mcc = rng.integers(0, 32, n).astype(np.int32)
    device = rng.integers(0, 8, n).astype(np.int32)
    geo = rng.integers(0, 16, n).astype(np.int32)

    # planted rule over true trailing-3600s sums
    label = np.zeros(n, np.float32)
    hist: Dict[int, list] = {}
    for i in range(n):
        c = int(card[i])
        h = hist.setdefault(c, [])
        h.append((int(ts[i]), float(amount[i])))
        roll = sum(a for (t, a) in h if t > ts[i] - 3600)
        label[i] = 1.0 if (roll > 500.0 and amount[i] > 100.0) else 0.0
    cols = dict(card=card, ts=ts, amount=amount, mcc=mcc, device=device, geo=geo)
    return cols, label


def reco_stream(
    rng: np.random.Generator, n: int, num_users: int = 128,
    num_products: int = 512, t_max: int = 86_400
) -> Dict[str, np.ndarray]:
    """Minute-level order events (Zipf product popularity)."""
    user = rng.integers(0, num_users, n).astype(np.int32)
    ts = np.sort(rng.integers(0, t_max, n)).astype(np.int32)
    product = (rng.zipf(1.3, n) % num_products).astype(np.int32)
    category = (product % 24).astype(np.int32)
    price = rng.gamma(2.0, 25.0, n).astype(np.float32)
    qty = rng.integers(1, 5, n).astype(np.float32)
    return dict(user=user, ts=ts, product=product, category=category,
                price=price, qty=qty)


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


def lm_stream(
    rng: np.random.Generator, batch: int, seq_len: int, vocab: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of {tokens, labels} with learnable local structure."""
    base = np.minimum(
        rng.zipf(1.5, size=(1 << 16,)) % vocab, vocab - 1
    ).astype(np.int32)
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        for b in range(batch):
            start = int(rng.integers(0, len(base) - 2 * seq_len - 2))
            row = base[start:start + seq_len + 1].copy()
            # copy motif: second half repeats a window from the first half
            w = seq_len // 4
            src = int(rng.integers(0, seq_len // 2 - w))
            dst = int(rng.integers(seq_len // 2, seq_len - w))
            row[dst:dst + w] = row[src:src + w]
            toks[b] = row
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

"""Quickstart — the FeatInsight §3.1 end-to-end loop.

  1. import data        (CSV -> typed columns)
  2. create features    (declarative DAG -> feature view + lineage)
  3. offline compute    (export a training set)
  4. online service     (ingest stream, point queries)
  5. consistency check  (offline batch == online incremental)

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device D]
"""

from __future__ import annotations

import io
from typing import Dict

import numpy as np

from repro_torch.core import (
    Col, FeatureRegistry, FeatureView, OfflineEngine, OnlineFeatureStore,
    range_window, w_count, w_mean, w_sum,
)
from repro_torch.core.consistency import verify_view
from repro_torch.core.storage import TableSchema
from repro_torch.data import load_csv
from repro_torch.examples._cli import device_arg

SCHEMA = TableSchema(name="orders", key="user", ts="ts",
                     numeric=("price",), categorical=("product",))


def csv_text() -> str:
    """The example's 200 orders as CSV text (the reference's rows)."""
    return "user,ts,price,product\n" + "\n".join(
        f"{u},{t},{round(p, 2)},{pr}"
        for u, t, p, pr in zip(
            np.random.default_rng(0).integers(0, 4, 200),
            np.sort(np.random.default_rng(1).integers(0, 5000, 200)),
            np.random.default_rng(2).gamma(2.0, 30.0, 200),
            np.random.default_rng(3).integers(0, 10, 200),
        )
    )


def quickstart_view() -> FeatureView:
    price = Col("price")
    w1k = range_window(1000, bucket=64)
    return FeatureView(
        name="user_spend", schema=SCHEMA,
        features={
            "spend_1k": w_sum(price, w1k),
            "orders_1k": w_count(price, w1k),
            "avg_1k": w_mean(price, w1k),
            "big_order": price > 100.0,
        },
        description="per-user trailing-1000s spend features",
    )


def request_rows() -> Dict[str, np.ndarray]:
    return {"user": np.arange(4, dtype=np.int32),
            "ts": np.full(4, 5001, np.int32),
            "price": np.full(4, 10.0, np.float32),
            "product": np.zeros(4, np.int32)}


def main(device="cuda") -> Dict:
    # -- 1. import data (the paper's "Data Import" button) -------------------
    table = load_csv(io.StringIO(csv_text()), SCHEMA)
    print(f"imported {len(table['user'])} rows into table {SCHEMA.name!r}")

    # -- 2. create features (visual DAG -> SQL in the paper; a DSL here) ------
    view = quickstart_view()
    registry = FeatureRegistry()
    registry.register(view)
    print("\nlineage of 'spend_1k':")
    lin = view.lineage()["spend_1k"]
    print(f"  view={lin['view']} v{lin['version']}  columns={lin['columns']}")
    print(f"  sql: {lin['sql']}")

    # -- 3. offline compute + training-set export -----------------------------
    engine = OfflineEngine(device=device)
    feats = engine.compute(view, table)
    print(f"\noffline features: {list(feats)} over {len(feats['spend_1k'])} rows")

    # -- 4. online feature service --------------------------------------------
    store = OnlineFeatureStore(view, num_keys=4, num_buckets=64, bucket_size=64,
                               device=device)
    order = np.lexsort((table["ts"], table["user"]))
    store.ingest({c: v[order] for c, v in table.items()})
    online = {f: v.cpu().numpy() for f, v in store.query(request_rows()).items()}
    print("\nonline point-query (4 users):")
    for f, v in online.items():
        print(f"  {f:10s} {v.round(2)}")

    # -- 5. consistency verification ------------------------------------------
    report = verify_view(view, table, num_keys=4, num_buckets=64,
                         bucket_size=64, device=device)
    print(f"\nconsistency: {report.summary()}")
    assert report.passed
    print("\nquickstart OK")
    return {"table": table, "online": online, "report": report,
            "offline": {f: v.cpu().numpy() for f, v in feats.items()}}


if __name__ == "__main__":
    main(device_arg(__doc__))

"""Scenario 3 — multi-table fraud features (LAST JOIN + WINDOW UNION).

The paper's first challenge is feature engineering over "large-scale,
complex raw data" (the 2018 PHM dataset spans 17 tables).  This example
runs the multi-table plane end to end on a 4-table database:

  transactions (primary card stream)
    + wires       — second spend stream, WINDOW UNIONed into the account's
                    trailing outflow window
    + accounts    — slowly-changing profile, point-in-time LAST JOIN
    + merchants   — merchant registry, LAST JOIN on the tx's merchant id

  1. design the view: joined profile features, cross-stream union windows,
     and derived row-level math mixing both;
  2. offline: one program computes every feature over all four tables
     (per-table sorts + searchsorted joins + union-by-merge);
  3. online: per-table ring stores answer the same definitions from device
     state; requests carry the join keys;
  4. verify: offline↔online consistency on the interleaved replay (both
     naive and preagg paths), then show the rendered SQL and lineage.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_table_fraud [--device D]
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import FeatureRegistry, OfflineEngine, OnlineFeatureStore
from repro_torch.core.consistency import verify_view
from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
from repro_torch.examples._cli import device_arg
from repro_torch.offline import export_training_set
from repro_torch.scenarios import multi_table_view

N_ROWS = 3_000
NUM_ACCOUNTS = 64
NUM_MERCHANTS = 16
T_MAX = 40_000


def main(device="cuda") -> Dict:
    rng = np.random.default_rng(11)
    tables = multitable_stream(
        rng, N_ROWS, num_accounts=NUM_ACCOUNTS,
        num_merchants=NUM_MERCHANTS, t_max=T_MAX,
    )
    tx = tables["transactions"]
    secondary = {t: c for t, c in tables.items() if t != "transactions"}
    print(
        "tables:",
        ", ".join(f"{t}[{len(next(iter(c.values())))}]" for t, c in tables.items()),
    )

    # ---- 1. register the view ---------------------------------------------
    view = multi_table_view()
    registry = FeatureRegistry()
    registry.register(view)
    print(f"\nview {view.name!r} reads tables: {view.tables}")

    # ---- 2. offline batch computation -------------------------------------
    engine = OfflineEngine(device=device)
    feats = engine.compute(view, tx, secondary)
    print("\noffline features (first 3 rows):")
    for f in view.features:
        print(f"  {f:18s} {feats[f][:3].cpu().numpy()}")

    # ---- 3+4. online stores + consistency verification --------------------
    reports = {}
    for mode in ("naive", "preagg"):
        rep = verify_view(
            view, tx,
            num_keys=NUM_ACCOUNTS,
            secondary=secondary,
            secondary_num_keys={"merchants": NUM_MERCHANTS},
            mode=mode,
            device=device,
        )
        print(rep.summary())
        assert rep.passed, f"consistency failed in mode={mode}"
        reports[mode] = rep

    # ---- lineage + SQL display --------------------------------------------
    lin = view.lineage()["limit_utilization"]
    print("\nlineage of limit_utilization:")
    print("  tables :", lin["tables"])
    print("  columns:", lin["columns"])
    print("  sql    :", lin["sql"])

    # a standalone online query with fresh request rows
    store = OnlineFeatureStore(
        view, num_keys=NUM_ACCOUNTS,
        secondary_num_keys={"merchants": NUM_MERCHANTS},
        device=device,
    )
    for t, cols in secondary.items():
        sch = MULTITABLE_DB.table(t)
        order = np.lexsort((cols[sch.ts], cols[sch.key]))
        store.ingest_table(t, {c: v[order] for c, v in cols.items()})
    order = np.lexsort((tx["ts"], tx["account"]))
    store.ingest({c: v[order] for c, v in tx.items()})
    req = {
        "account": np.arange(4, dtype=np.int32),
        "ts": np.full(4, T_MAX + 60, np.int32),
        "amount": np.asarray([10.0, 900.0, 50.0, 5000.0], np.float32),
        "merchant": np.arange(4, dtype=np.int32),
    }
    out = {f: v.cpu().numpy() for f, v in store.query(req).items()}
    print("\nonline answers for 4 fresh requests:")
    for f in ("credit_limit", "outflow_sum_1h", "limit_utilization"):
        print(f"  {f:18s} {out[f]}")

    # ---- the offline half: point-in-time training-set export ---------------
    # same view definitions, full history, label rows sampled across the
    # stream (including beyond any online ring's retention horizon); the
    # registry records the export as lineage next to the serving deploys
    training = export_training_set(
        view, tx, n=256, seed=7, label="amount", secondary=secondary,
        registry=registry, device=device,
    )
    print(f"\n{training.describe()}")
    dep = registry.deployments(view.name)[-1]
    print(
        f"registry records: service={dep['service']!r} "
        f"({dep['description']})"
    )
    return {"tables": tables, "reports": reports, "request": req,
            "online": out, "training": training, "registry": registry}


if __name__ == "__main__":
    main(device_arg(__doc__))

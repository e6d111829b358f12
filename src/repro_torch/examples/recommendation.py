"""Scenario 1 (§3.2) — efficient feature deployment for product reco.

Vipshop-style workload: minute-level order events, features must go from
design to production fast.  The demo walks the paper's four optimizations:

  1. declarative feature design (the DSL standing in for drag-and-drop),
  2. unified executors + mechanized offline/online consistency check,
  3. compact time-series storage (ring + pre-agg ingest of the backfill),
  4. one-click deploy (define -> compile -> verify -> serve, packaged).

It then exercises version evolution: v2 adds features without redefining
v1 (the paper's cached-version reuse), and the BatchScheduler coalesces
single-row requests into fixed shape buckets.

Run:  PYTHONPATH=src python -m repro_torch.examples.recommendation [--device D]
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from repro_torch.core import (
    Col, FeatureRegistry, OfflineEngine, OnlineFeatureStore,
    range_window, rows_window, w_count, w_sum,
)
from repro_torch.core.consistency import verify_view
from repro_torch.data.synthetic import reco_stream
from repro_torch.examples._cli import device_arg
from repro_torch.scenarios import reco_view
from repro_torch.serve.service import BatchScheduler, FeatureService

N_ROWS = 6_000
NUM_USERS = 128


def main(device="cuda") -> Dict:
    rng = np.random.default_rng(7)
    cols = reco_stream(rng, N_ROWS, num_users=NUM_USERS)
    spend = Col("price") * Col("qty")

    # ---- one-click deploy, timed step by step ------------------------------
    t_all = time.perf_counter()
    registry = FeatureRegistry()
    engine = OfflineEngine(device=device)

    t0 = time.perf_counter()
    v1 = reco_view()  # the canonical scenario view (docs/CATALOG_TORCH.md)
    registry.register(v1)
    t_design = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine.compile(v1)
    engine.compute(v1, cols)
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    rep = verify_view(v1, {c: np.asarray(v) for c, v in cols.items()},
                      num_keys=NUM_USERS, num_buckets=64, bucket_size=64,
                      engine=engine, device=device)
    assert rep.passed, rep.summary()
    t_verify = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = OnlineFeatureStore(v1, num_keys=NUM_USERS, num_buckets=64,
                               bucket_size=64, device=device)
    order = np.lexsort((cols["ts"], cols["user"]))
    store.ingest({c: v[order] for c, v in cols.items()})
    svc = FeatureService("reco_svc", v1, store, registry)
    t_deploy = time.perf_counter() - t0

    total = time.perf_counter() - t_all
    print("one-click deployment pipeline (paper: < 1 hour, 5 person-days"
          " -> here: seconds):")
    print(f"  design    {t_design * 1e3:8.1f} ms")
    print(f"  compile   {t_compile * 1e3:8.1f} ms   (DAG -> offline program, "
          "first run)")
    print(f"  verify    {t_verify * 1e3:8.1f} ms   ({rep.summary()})")
    print(f"  deploy    {t_deploy * 1e3:8.1f} ms   (backfill {N_ROWS} rows)")
    print(f"  TOTAL     {total:8.2f} s")

    # ---- request path via the batch scheduler ------------------------------
    sched = BatchScheduler(buckets=(1, 4, 16, 64))
    for i in range(23):  # 23 pending single-row requests
        sched.submit({
            "user": np.int32(rng.integers(0, NUM_USERS)),
            "ts": np.int32(90_000 + i),
            "price": np.float32(rng.gamma(2.0, 25.0)),
            "qty": np.float32(1 + i % 3),
            "product": np.int32(rng.integers(0, 512)),
            "category": np.int32(rng.integers(0, 24)),
        })
    served = 0
    batches = []
    while (batch := sched.next_batch()) is not None:
        valid = batch.pop("__valid__")
        out = svc.request(batch, ingest=False)  # padded fixed-shape query
        batches.append((dict(batch), valid,
                        {f: np.asarray(v) for f, v in out.items()}))
        vrows = {c: v[valid] for c, v in batch.items()}
        order_v = np.lexsort((vrows["ts"], vrows["user"]))
        store.ingest({c: v[order_v] for c, v in vrows.items()})
        served += int(valid.sum())
    print(f"\nbatch scheduler served {served} queued requests "
          f"(padded to shape buckets; {svc.stats.batches} executions, "
          f"mean {svc.stats.mean_latency_ms:.2f} ms/batch)")

    # ---- v2: incremental evolution (cached-version reuse) -------------------
    t0 = time.perf_counter()
    v2 = v1.evolve(
        {"spend_24h": w_sum(spend, range_window(86_400, bucket=2048)),
         "cat_cnt_50": w_count(Col("category"), rows_window(50))},
        description="v2: + daily spend, category frequency",
    )
    registry.register(v2)
    engine.compile(v2)
    engine.compute(v2, cols)
    store2 = OnlineFeatureStore(v2, num_keys=NUM_USERS, num_buckets=128,
                                bucket_size=2048, device=device)
    store2.ingest({c: v[order] for c, v in cols.items()})
    FeatureService("reco_svc", v2, store2, registry)
    t_v2 = time.perf_counter() - t0
    print(f"\nv2 evolve+redeploy: {t_v2:.2f} s "
          f"(versions of 'user_activity': {registry.versions('user_activity')})")
    svc_info = registry.service("reco_svc")
    print(f"registry: service 'reco_svc' now at "
          f"v{svc_info['version']} of view {svc_info['view']!r}")
    assert svc_info["version"] == 2
    print("recommendation OK")
    return {"columns": cols, "report": rep, "batches": batches,
            "served": served, "registry": registry}


if __name__ == "__main__":
    main(device_arg(__doc__))

"""Scenario 4 — sharded online serving.

FeatInsight serves 100+ scenarios at millisecond latency because OpenMLDB
partitions online table state across nodes.  This example runs the
sharded serving plane end to end over the 4-table fraud database; the
shard axis is a tensor axis of one device's state (8 shards):

  1. deploy the multi-table view on a ShardedOnlineStore: primary rings +
     bucket pre-aggs partitioned by a key permutation over the shards,
     the wires union stream partitioned the same way, profile tables
     (LAST JOIN targets) replicated per shard;
  2. front it with a ShardRouter: micro-batching with a max_wait_us
     deadline, shard-bucketed routing on the device, one query per batch,
     answers scattered back in submission order;
  3. prove the scaling contract: the sharded answers are bit-identical
     to a single-device store fed the same stream;
  4. show the ops surface: per-shard row occupancy, request skew
     histogram, and the service's p50/p95/p99 batch latency.

Run:  PYTHONPATH=src python -m repro_torch.examples.sharded_serving [--device D]
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import OnlineFeatureStore
from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
from repro_torch.examples._cli import device_arg
from repro_torch.scenarios import sharded_view as view
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import BatchScheduler, FeatureService

NUM_SHARDS = 8
NUM_ACCOUNTS = 64
NUM_MERCHANTS = 16
HIST_ROWS = 2_000
T_MAX = 40_000
N_REQUESTS = 200


def preload(store, tables) -> None:
    for t, cols in tables.items():
        sch = MULTITABLE_DB.table(t)
        order = np.lexsort((cols[sch.ts], cols[sch.key]))
        sorted_cols = {c: v[order] for c, v in cols.items()}
        if t == "transactions":
            store.ingest(sorted_cols)
        else:
            store.ingest_table(t, sorted_cols)


def main(device="cuda") -> Dict:
    rng = np.random.default_rng(0)
    v = view()
    tables = multitable_stream(
        rng, HIST_ROWS, num_accounts=NUM_ACCOUNTS,
        num_merchants=NUM_MERCHANTS, t_max=T_MAX,
    )

    # -- deploy: sharded service + single-device reference --------------------
    sharded = FeatureService.build(
        "fraud_sharded", v, num_keys=NUM_ACCOUNTS, sharded=True,
        num_shards=NUM_SHARDS,
        secondary_num_keys={"merchants": NUM_MERCHANTS},
        device=device,
    )
    single = FeatureService.build(
        "fraud_single", v, num_keys=NUM_ACCOUNTS,
        secondary_num_keys={"merchants": NUM_MERCHANTS},
        device=device,
    )
    assert isinstance(single.store, OnlineFeatureStore)
    store = sharded.store
    print(f"shards: {store.num_shards} on {store.device}")
    placement = {
        p.table: "sharded" if p.partitioned else "replicated"
        for p in store.layout.tables
    }
    print(f"secondary placement: {placement}")
    for svc in (sharded, single):
        preload(svc.store, tables)
    print(f"per-shard primary rows after preload: "
          f"{store.shard_row_counts().tolist()}")

    # -- serve: micro-batched request stream through the router ---------------
    router = ShardRouter(
        sharded,
        BatchScheduler(max_batch=32, max_wait_us=2_000),
        ingest=False,
    )
    reqs = [
        dict(
            account=int(rng.integers(0, NUM_ACCOUNTS)),
            ts=int(T_MAX + 1 + i),
            amount=float(rng.gamma(1.5, 60.0)),
            merchant=int(rng.integers(0, NUM_MERCHANTS)),
        )
        for i in range(N_REQUESTS)
    ]
    served = []
    now_us = 0
    for r in reqs:
        router.submit(r, now_us=now_us)
        now_us += 150  # ~6.7k QPS arrival process
        out = router.pump(now_us=now_us)
        if out is not None:
            served.append(out)
    tail = router.drain(now_us=now_us)
    if tail is not None:
        served.append(tail)
    answers = {
        k: np.concatenate([o[k] for o in served]) for k in served[0]
    }
    assert len(answers["utilization"]) == N_REQUESTS

    # -- verify: bit-identical to the single-device plane ----------------------
    batch = {k: np.asarray([r[k] for r in reqs]) for k in reqs[0]}
    ref = single.request(batch, ingest=False)
    for f in v.features:
        np.testing.assert_array_equal(answers[f], ref[f])
    print(f"\nexactness: all {len(v.features)} features bit-identical to "
          f"the single-device store over {N_REQUESTS} requests")

    # -- observe ----------------------------------------------------------------
    print(f"request skew histogram (per shard): "
          f"{router.shard_histogram().tolist()}")
    st = sharded.stats
    print(f"latency: mean {st.mean_latency_ms:.2f} ms | "
          f"p50 {st.p50_ms:.2f} | p95 {st.p95_ms:.2f} | "
          f"p99 {st.p99_ms:.2f} ms over {st.batches} batches")
    print("\nsample answers (first 3 requests):")
    for f in v.features:
        print(f"  {f:>16}: {np.round(answers[f][:3], 3).tolist()}")
    return {"requests": reqs, "answers": answers, "single": ref,
            "shard_histogram": router.shard_histogram()}


if __name__ == "__main__":
    main(device_arg(__doc__))

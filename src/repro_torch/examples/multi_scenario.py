"""Scenario 5 — multi-scenario serving: N feature views, one store.

FeatInsight's consolidation story (100+ scenarios on one platform) in
miniature: three fraud-adjacent scenarios — account risk, spending
profile, merchant watchlist — deployed together on ONE ScenarioPlane:

  1. the views are fused into one shared store (8 shards on one device):
     lane plan = union of every view's window arguments (CSE'd, so the 1h
     outflow sum shared by two views is ONE lane), secondary tables =
     union of every view's LAST JOIN / WINDOW UNION references;
  2. shared tables are ingested once: the wires union stream and the
     accounts/merchants dimension tables serve all three scenarios from
     one ring store per table, not one per view;
  3. each view queries through its own program — only its lanes are
     gathered and folded — behind one scenario-tagged ShardRouter;
  4. the third scenario is NOT part of the initial deployment: it is
     hot-deployed onto the already-warm plane (`svc.hot_deploy(view)`) —
     a StoreLayout diff + state migration, no rebuild, no re-ingest —
     and the router picks it up live;
  5. the answers (including the hot-deployed scenario's) are proven
     bit-identical to three dedicated single-view stores fed the same
     stream, and the ops surface shows per-scenario latency stats plus
     the (scenario, shard) occupancy histogram.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_scenario [--device D]
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import (
    Col, FeatureView, OnlineFeatureStore, Signature, range_window, w_count,
    w_sum,
)
from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
from repro_torch.examples._cli import device_arg
from repro_torch.obs import get_telemetry
from repro_torch.offline import BackfillSource
from repro_torch.scenarios import multi_scenario_views
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import BatchScheduler, FeatureService

NUM_SHARDS = 8
NUM_ACCOUNTS = 64
NUM_MERCHANTS = 16
HIST_ROWS = 2_000
T_MAX = 40_000
N_REQUESTS = 180

# capacity is small on purpose: ~31 rows/key age down to the newest 16,
# so the offline-bridge section below genuinely needs aged-out history
STORE_KW = dict(
    num_keys=NUM_ACCOUNTS, capacity=16, num_buckets=512, bucket_size=64,
    secondary_num_keys={"merchants": NUM_MERCHANTS},
)


def preload(store, tables) -> None:
    for t in store._sec_names:
        sch = MULTITABLE_DB.table(t)
        cols = tables[t]
        order = np.lexsort((cols[sch.ts], cols[sch.key]))
        store.ingest_table(t, {c: v[order] for c, v in cols.items()})
    tx = tables["transactions"]
    order = np.lexsort((tx["ts"], tx["account"]))
    store.ingest({c: v[order] for c, v in tx.items()})


def main(device="cuda") -> Dict:
    rng = np.random.default_rng(0)
    views = multi_scenario_views()
    tables = multitable_stream(
        rng, HIST_ROWS, num_accounts=NUM_ACCOUNTS,
        num_merchants=NUM_MERCHANTS, t_max=T_MAX,
    )

    # -- 1+2: one service, two scenarios at launch, shared ingest ------------
    svc = FeatureService.build_multi(
        "consolidated", views[:2], sharded=True, num_shards=NUM_SHARDS,
        device=device, **STORE_KW,
    )
    preload(svc.plane.store, tables)
    counts = svc.plane.ingest_row_counts()
    print(f"launch scenarios: {svc.scenarios}")
    print(f"plane tables (stored once each): {svc.plane.tables}")
    print(f"stored rows per table: {counts}")

    # -- hot deploy scenario #3 on the WARM plane -----------------------------
    # a StoreLayout diff + state migration: carried rings move over
    # verbatim, nothing is re-ingested, only the new view gets a program —
    # and the result is bit-identical to a cold rebuild + replay
    report = svc.hot_deploy(views[2])
    print(f"hot-deployed {views[2].name!r} onto the live plane:")
    print("  " + report.describe().replace("\n", "\n  "))
    assert svc.plane.ingest_row_counts() == counts, "hot deploy re-ingested!"
    print(f"scenarios now: {svc.scenarios}")

    # the dedicated-store world it replaces (for the equality proof)
    singles = {
        v.name: OnlineFeatureStore(v, device=device, **STORE_KW) for v in views
    }
    for s in singles.values():
        preload(s, tables)

    # -- 3: scenario-tagged routing through one router -----------------------
    router = ShardRouter(
        svc,
        BatchScheduler(buckets=(1, 4, 16, 64), max_batch=64,
                       max_wait_us=2_000),
        ingest=False,
    )
    names = [v.name for v in views]
    reqs, tags = [], []
    for i in range(N_REQUESTS):
        reqs.append(dict(
            account=int(rng.integers(0, NUM_ACCOUNTS)),
            ts=T_MAX + 1 + i,
            amount=float(rng.gamma(1.5, 60.0)),
            merchant=int(rng.integers(0, NUM_MERCHANTS)),
        ))
        tags.append(names[i % len(names)])
        router.submit(reqs[-1], scenario=tags[-1], now_us=i * 100)
    out = router.drain(now_us=N_REQUESTS * 100)

    # -- 5: the proof + the ops surface ---------------------------------------
    for v in views:
        idx = [i for i, t in enumerate(tags) if t == v.name]
        batch = {
            c: np.asarray([reqs[i][c] for i in idx])
            for c in ("account", "ts", "amount", "merchant")
        }
        ref = singles[v.name].query(batch)
        for f in v.features:
            np.testing.assert_array_equal(
                ref[f].cpu().numpy(), out[v.name][f]
            )
        st = svc.scenario_stats[v.name]
        print(
            f"  {v.name:15s} {st.requests:4d} req  "
            f"p50={st.p50_ms:6.2f}ms  p95={st.p95_ms:6.2f}ms  "
            f"features={list(v.features)}"
        )
    print("bit-identical to dedicated per-scenario stores: OK")
    print("(scenario, shard) occupancy:")
    for s, hist in router.scenario_shard_histogram().items():
        print(f"  {s:15s} {hist.tolist()}")
    print(f"aggregate: {svc.stats.requests} requests, "
          f"p50={svc.stats.p50_ms:.2f}ms p99={svc.stats.p99_ms:.2f}ms "
          f"(per-request p50={svc.stats.request_p50_ms:.2f}ms "
          f"p99={svc.stats.request_p99_ms:.2f}ms)")

    # -- the offline bridge: hot deploy beyond the retention horizon ----------
    # merchant_mix wants a 6h window of a *hash* lane: the rings retain
    # only the newest 16 rows/key (~5.5h of a ~31-row/key stream) and a
    # Signature lane can never be synthesized from stored f32 columns —
    # without offline history this deployment must refuse; with a
    # BackfillSource it re-derives the aged-out state and goes live
    # bit-exactly (capacity grows 16 -> 64 so the window fits)
    w6h = range_window(21_600, bucket=64)
    sig_view = FeatureView(
        name="merchant_mix",
        features={
            "sig_cnt_6h": w_count(Signature((Col("merchant"),), bits=8), w6h),
            "sig_sum_6h": w_sum(Signature((Col("merchant"),), bits=8), w6h),
        },
        database=MULTITABLE_DB,
        description="merchant-mix signature counts (offline-backfilled)",
    )
    print(f"\nhot-deploying {sig_view.name!r} (6h hash-lane window vs "
          "16-row rings):")
    try:
        svc.hot_deploy(sig_view, capacity=64)
    except ValueError as e:
        print(f"  without offline history: REFUSED — {str(e)[:110]}...")
    backfill_report = svc.hot_deploy(
        sig_view,
        backfill=BackfillSource(MULTITABLE_DB, tables),
        capacity=64,
    )
    assert backfill_report.exact, backfill_report.notes
    print("  with BackfillSource: " + backfill_report.describe().splitlines()[0])
    for b in backfill_report.backfilled:
        print(f"    backfilled: {b}")

    # -- the telemetry plane: freshness, migration spans ----------------------
    # (no query_compile_seconds: the port's programs run eagerly)
    tel = get_telemetry()
    snap = tel.snapshot()
    print("\ntelemetry (one plane, every layer reports in):")
    fresh = tel.metrics.metrics().get("ingest_freshness_seconds")
    if fresh is not None:
        for s in fresh.snapshot()["series"]:
            print(
                f"  freshness {s['labels']['table']:15s} "
                f"p50={s['p50'] * 1e3:8.2f}ms  p95={s['p95'] * 1e3:8.2f}ms  "
                f"({s['count']:.0f} rows ingest-to-queryable)"
            )
    for root in tel.tracer.roots():
        if root.name == "hot_deploy":
            print("  hot-deploy span tree (⏚ = device-fenced):")
            print("    " + root.tree().replace("\n", "\n    "))
    assert any(r.name == "hot_deploy" for r in tel.tracer.roots())
    backfill_spans = [
        s for r in tel.tracer.roots() for s in r.find("backfill")
    ]
    assert backfill_spans, "the offline-bridge deploy traced no backfill"
    bf_rows = tel.metrics.metrics().get("backfill_rows_total")
    if bf_rows is not None:
        for s in bf_rows.snapshot()["series"]:
            print(
                f"  backfill  {s['labels']['table']:15s} "
                f"{s['value']:.0f} history rows re-derived offline"
            )
    print(f"  snapshot: {len(snap['metrics'])} metrics — render with "
          "`python -m repro_torch.obs.report`")
    return {"requests": reqs, "tags": tags, "answers": out,
            "report": report, "backfill_report": backfill_report,
            "counts": counts}


if __name__ == "__main__":
    main(device_arg(__doc__))

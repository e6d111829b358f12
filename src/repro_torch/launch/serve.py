"""Online feature + scoring service launcher (FeatInsight §3.1 step 4).

Boots the serving stack: feature view -> online store (backfilled) ->
FeatureService -> ScoringService (feature vector + signature embedding
-> transformer -> score), then replays a synthetic request stream in
fixed-size batches and reports batch latency percentiles and QPS.  The
twin of the reference package's ``python -m repro.launch.serve``, with
the same flags and ``--device`` (default ``cuda``)::

    python -m repro_torch.launch.serve --requests 512 --batch 64

``main(argv)`` can be called with an argument list and returns the run's
numbers.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--history", type=int, default=8_000)
    ap.add_argument("--cards", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu to run the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs.featinsight_fraud import smoke_config
    from repro_torch.core.expr import (
        Col, range_window, rows_window, w_count, w_max, w_mean, w_std, w_sum,
    )
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.core.view import FeatureRegistry, FeatureView
    from repro_torch.data.synthetic import FRAUD_SCHEMA, fraud_transactions
    from repro_torch.models import build_model
    from repro_torch.serve.service import FeatureService, ScoringService

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    amt = Col("amount")
    w1h = range_window(3600, bucket=64)
    view = FeatureView(
        name="fraud_serving", schema=FRAUD_SCHEMA,
        features={
            "amt_sum_1h": w_sum(amt, w1h),
            "amt_mean_1h": w_mean(amt, w1h),
            "amt_std_1h": w_std(amt, w1h),
            "tx_count_1h": w_count(amt, w1h),
            "amt_max_1h": w_max(amt, w1h),
            "tx_count_20": w_count(amt, rows_window(20)),
        },
    )
    registry = FeatureRegistry()
    registry.register(view)

    print(f"[serve] backfilling {args.history} rows on {dev} ...")
    hist = fraud_transactions(rng, args.history, args.cards, 0, 100_000)
    store = OnlineFeatureStore(view, num_keys=args.cards, capacity=256,
                               num_buckets=64, bucket_size=64, device=dev)
    store.ingest(hist)
    fsvc = FeatureService("fraud_svc", view, store, registry)

    cfg = smoke_config()
    model = build_model(cfg, seed=0, device=dev)
    table = torch.as_tensor(
        rng.normal(0, 0.02, (1 << 12, cfg.d_model)).astype(np.float32),
        device=dev,
    )
    svc = ScoringService(fsvc, model, table)

    # request replay at a fixed batch shape; the first batch pays one-time
    # costs (kernel builds on a GPU) and is left out of the percentiles
    B = args.batch
    lat = []
    served = 0
    t_all = time.perf_counter()
    while served < args.requests:
        rows = {
            "card": rng.integers(0, args.cards, B).astype(np.int32),
            "ts": np.full(B, 100_001 + served, np.int32),
            "amount": rng.gamma(1.5, 60.0, B).astype(np.float32),
            "mcc": rng.integers(0, 32, B).astype(np.int32),
            "device": rng.integers(0, 8, B).astype(np.int32),
            "geo": rng.integers(0, 16, B).astype(np.int32),
        }
        t0 = time.perf_counter()
        scores = svc.handle(rows)
        lat.append(time.perf_counter() - t0)
        served += B
        if scores.shape != (B,) or not np.all((scores >= 0) & (scores <= 1)):
            raise RuntimeError(f"bad scores: shape {scores.shape}, "
                               f"range [{scores.min()}, {scores.max()}]")
    dt = time.perf_counter() - t_all
    lat_ms = np.sort(np.array(lat[1:])) * 1e3
    print(f"[serve] {served} requests in {dt:.2f}s "
          f"({served / dt:.0f} QPS incl. the first batch)")
    out = dict(requests=served, batches=len(lat), seconds=dt,
               device=str(dev))
    if len(lat_ms):
        out.update(
            p50_ms=float(np.percentile(lat_ms, 50)),
            p95_ms=float(np.percentile(lat_ms, 95)),
            max_ms=float(lat_ms.max()),
            steady_qps=float(B * len(lat_ms) / (lat_ms.sum() / 1e3)),
        )
        print(f"[serve] batch latency ms: p50={out['p50_ms']:.2f} "
              f"p95={out['p95_ms']:.2f} max={out['max_ms']:.2f} "
              f"steady QPS={out['steady_qps']:.0f}")
    dep = registry.service("fraud_svc")
    print(f"[serve] registry: {dep['view']} v{dep['version']} deployed")
    return out


if __name__ == "__main__":
    main()

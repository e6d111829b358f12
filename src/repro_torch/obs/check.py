"""Gates for the telemetry plane.

Two checks, both runnable as modules:

* ``python -m repro_torch.obs.check schema`` — runs a small but *complete*
  workload (sharded multi-scenario serving + hot deploy + gauges) and
  asserts the snapshot against the golden metric catalog: every expected
  metric present with its declared type / unit / label names, units
  present on everything, no metric exceeding its cardinality bound, and
  the Prometheus rendering well-formed.  The catalog in
  ``EXPECTED_METRICS`` is the same one documented in
  ``docs/OBSERVABILITY.md`` — a metric added or renamed without updating
  both fails here, which is the point: the snapshot schema is an
  interface other tooling parses.
* ``python -m repro_torch.obs.check overhead`` — measures instrumented vs
  disabled-telemetry ``FeatureService.request`` at smoke size and asserts
  the instrumented path stays within a small multiplicative bound (plus
  an additive floor, so micro-second jitter on a fast machine cannot
  flake the gate).

``--device`` picks where the workloads run (default ``cuda``; ``cpu``
runs the kernels' plain versions).  The reference package's
``repro.obs.check`` with the same catalog, less one metric (below), and
two guards of the GPU path the reference states in prose: on a CUDA
device ``kernel_dispatch_total`` must show the hand-written kernels
(``impl="cuda"`` for ``fused_ingest`` and ``route_rank``) and never
their plain versions (``impl="ref"``: a silent plain-version path), and
on every device each ``device`` span must have been fenced (its time
includes the device's work, not just the launches).
"""

from __future__ import annotations

import sys
import argparse
from typing import Dict, Tuple

# name -> (type, unit, label names).  The reference package's golden
# catalog (docs/OBSERVABILITY.md) less query_compile_seconds: programs run
# eagerly, so there is no first-trace compile to time (core/online.py);
# the metric's counterpart comes with CUDA graphs of the request programs.
EXPECTED_METRICS: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    "service_requests_total": ("counter", "1", ("service", "scenario")),
    "request_latency_seconds": ("histogram", "s", ("service",)),
    "queue_wait_seconds": ("histogram", "s", ("service",)),
    "batch_occupancy_ratio": ("gauge", "1", ("service",)),
    "padding_rows_total": ("counter", "1", ("layer",)),
    "padding_waste_ratio": ("gauge", "1", ("layer",)),
    "span_seconds": ("histogram", "s", ("name", "kind")),
    "shard_dispatch_rows_total": ("counter", "1", ("scenario", "shard")),
    "route_rows_total": ("counter", "1", ("path",)),
    "preagg_hits_total": ("counter", "1", ("agg",)),
    "preagg_fallback_total": ("counter", "1", ("agg",)),
    "kernel_dispatch_total": ("counter", "1", ("kernel", "impl")),
    "ingest_freshness_seconds": ("histogram", "s", ("table",)),
    "ingest_rows_total": ("counter", "1", ("table",)),
    "ring_occupancy_ratio": ("gauge", "1", ("table", "placement")),
    "ring_evicted_rows_total": ("gauge", "1", ("table", "placement")),
    "hot_deploys_total": ("counter", "1", ("service",)),
    "backfill_rows_total": ("counter", "1", ("table",)),
    "export_rows_total": ("counter", "1", ("view",)),
    "export_freshness_seconds": ("histogram", "s", ("view",)),
}

# populated only when a layout sets a TTL — optional in the golden set
OPTIONAL_METRICS: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    "ring_ttl_expired_rows": ("gauge", "1", ("table",)),
}

EXPECTED_SPAN_NAMES = {
    "request", "query.route", "query.compute", "query.scatter",
    "route.device", "ingest",
    "hot_deploy", "hot_deploy.plan", "hot_deploy.compile",
    "migrate", "migrate.diff", "migrate.carry", "migrate.place",
    "backfill", "backfill.ring", "backfill.bucket", "export",
}


def _workload(tel, device="cuda"):
    """Small sharded multi-scenario workload + hot deploy on ``device``:
    touches every instrumented layer so the snapshot carries the full
    catalog."""
    import numpy as np

    from repro_torch.core import (
        Col, FeatureView, range_window, rows_window, w_count, w_mean, w_sum,
    )
    from repro_torch.data.synthetic import FRAUD_SCHEMA
    from repro_torch.obs import use_telemetry
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler, FeatureService

    amt = Col("amount")
    w1 = range_window(600, bucket=64)
    v1 = FeatureView("fraud", FRAUD_SCHEMA, {"s": w_sum(amt, w1)})
    v2 = FeatureView(
        "risk", FRAUD_SCHEMA,
        {"m": w_mean(amt, w1), "c5": w_count(amt, rows_window(5))},
    )
    v3 = FeatureView("velocity", FRAUD_SCHEMA, {"c8": w_count(amt, rows_window(8))})

    with use_telemetry(tel):
        svc = FeatureService.build_multi(
            "plane", [v1, v2], num_keys=32, sharded=True, num_shards=4,
            capacity=64, device=device,
        )
        router = ShardRouter(
            svc, BatchScheduler(max_batch=16, max_wait_us=2_000)
        )
        rng = np.random.default_rng(0)
        now = 0
        for i in range(40):
            router.submit(
                dict(
                    card=int(rng.integers(0, 32)),
                    ts=100_000 + i,
                    amount=float(rng.gamma(1.5, 60.0)),
                    mcc=int(rng.integers(0, 32)),
                    device=int(rng.integers(0, 8)),
                    geo=int(rng.integers(0, 16)),
                ),
                now_us=now,
                scenario="fraud" if i % 2 else "risk",
            )
            now += 250
            router.pump(now_us=now)
        router.drain(now_us=now)
        svc.hot_deploy(v3)
        for i in range(4):
            router.submit(
                dict(
                    card=i, ts=101_000 + i, amount=10.0, mcc=0, device=0,
                    geo=0,
                ),
                now_us=now, scenario="velocity",
            )
            now += 250
        # a couple of requests through the retained host-routed oracle
        # flavour, so route_rows_total{path=host} and the host path's
        # query.compute span stay exercised alongside route.device
        svc.store.device_routing = False
        for i in range(4):
            router.submit(
                dict(
                    card=i, ts=102_000 + i, amount=5.0, mcc=0, device=0,
                    geo=0,
                ),
                now_us=now, scenario="fraud",
            )
            now += 250
        router.drain(now_us=now)
        svc.store.device_routing = True
        svc.store.record_gauges()

        # offline bridge: a hot deploy needing aged-out history (40
        # rows/key vs 8-row rings) spliced from offline storage, plus a
        # training-set export — the backfill + export metric families
        from repro_torch.core import ScenarioPlane, Signature
        from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
        from repro_torch.offline import BackfillSource, export_training_set
        from repro_torch.scenarios import multi_scenario_views, multi_table_view

        tabs = multitable_stream(
            np.random.default_rng(5), 160, num_accounts=4,
            num_merchants=4, t_max=20_000,
        )
        mviews = multi_scenario_views()[:2]
        sig = FeatureView(
            name="merchant_mix",
            features={
                "sig_cnt": w_count(
                    Signature((Col("merchant"),), bits=8),
                    range_window(3600, bucket=64),
                ),
            },
            database=MULTITABLE_DB,
        )
        plane = ScenarioPlane(
            mviews, num_keys=4, capacity=8, num_buckets=512,
            bucket_size=64, secondary_num_keys={"merchants": 4},
            device=device,
        )
        for t in plane.store._sec_names:
            kc = MULTITABLE_DB.table(t).key
            cols = tabs[t]
            o = np.lexsort((cols["ts"], cols[kc]))
            plane.ingest_table(t, {c: v[o] for c, v in cols.items()})
        tx = tabs["transactions"]
        o = np.lexsort((tx["ts"], tx["account"]))
        plane.ingest({c: v[o] for c, v in tx.items()})
        report = plane.evolve(
            mviews + [sig],
            backfill=BackfillSource(MULTITABLE_DB, tabs),
            capacity=32,
        )
        assert report.exact and report.backfilled, report.describe()
        export_training_set(
            multi_table_view(), tx, n=8,
            secondary={t: c for t, c in tabs.items() if t != "transactions"},
            device=device,
        )
    return tel


def _unfenced_device_spans(roots) -> list:
    """Names of the ``device`` spans (at any depth) that never fenced."""
    out, stack = [], list(roots)
    while stack:
        s = stack.pop()
        if s.kind == "device" and not s.fenced:
            out.append(s.name)
        stack.extend(s.children)
    return sorted(set(out))


def _dispatch_problems(metrics) -> list:
    """On a CUDA device: B1 and B2 dispatched to their CUDA kernels, and
    no kernel entry point to its plain version."""
    series = metrics.get("kernel_dispatch_total", {}).get("series", ())
    seen = {(s["labels"]["kernel"], s["labels"]["impl"]) for s in series
            if s["value"] > 0}
    problems = [
        f"kernel_dispatch_total: no impl=\"cuda\" series for {k!r}"
        for k in ("fused_ingest", "route_rank") if (k, "cuda") not in seen
    ]
    ref = sorted(k for k, impl in seen if impl == "ref")
    if ref:
        problems.append(
            f"kernel_dispatch_total: plain-version (impl=\"ref\") "
            f"dispatches on the GPU for {ref}"
        )
    return problems


def schema_check(verbose: bool = True, device="cuda") -> Dict:
    """Golden-catalog assertion over a full-workload snapshot on
    ``device``; returns the snapshot."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.obs import Telemetry

    dev = resolve_device(device)
    tel = Telemetry()
    _workload(tel, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    snap = tel.snapshot()

    assert snap["schema_version"] == Telemetry.SCHEMA_VERSION, snap.keys()
    metrics = snap["metrics"]
    problems = []
    for name, (typ, unit, labels) in EXPECTED_METRICS.items():
        if name not in metrics:
            problems.append(f"missing metric {name!r}")
            continue
        m = metrics[name]
        if m["type"] != typ:
            problems.append(f"{name}: type {m['type']!r} != {typ!r}")
        if m["unit"] != unit:
            problems.append(f"{name}: unit {m['unit']!r} != {unit!r}")
        if tuple(m["labels"]) != labels:
            problems.append(
                f"{name}: labels {tuple(m['labels'])} != {labels}"
            )
        if not m["series"]:
            problems.append(f"{name}: no series recorded by the workload")
    golden = set(EXPECTED_METRICS) | set(OPTIONAL_METRICS)
    for name, m in metrics.items():
        if name not in golden:
            problems.append(
                f"unexpected metric {name!r} — add it to "
                "EXPECTED_METRICS and docs/OBSERVABILITY.md"
            )
        if not m.get("unit"):
            problems.append(f"{name}: empty unit")

    # cardinality: bounded per metric (registry raises on exceed; assert
    # the workload stays well inside the caps)
    for name, metric in tel.metrics.metrics().items():
        n = metric.series_count()
        if n > metric.max_series:
            problems.append(
                f"{name}: {n} series > cap {metric.max_series}"
            )

    # span taxonomy: every expected stage traced at least once
    seen_spans = {
        s["labels"]["name"]
        for s in metrics.get("span_seconds", {}).get("series", ())
    }
    missing_spans = EXPECTED_SPAN_NAMES - seen_spans
    if missing_spans:
        problems.append(f"span names never traced: {sorted(missing_spans)}")
    unfenced = _unfenced_device_spans(tel.tracer.roots())
    if unfenced:
        problems.append(f"device spans closed without a fence: {unfenced}")
    if dev.type == "cuda":
        problems += _dispatch_problems(metrics)

    # Prometheus rendering: every metric family present, parseable shape
    prom = tel.to_prometheus()
    for name in EXPECTED_METRICS:
        if f"# TYPE {name} " not in prom:
            problems.append(f"{name}: missing from Prometheus exposition")

    # snapshot is JSON-stable
    import json

    json.loads(json.dumps(snap))

    if problems:
        raise AssertionError(
            "telemetry schema check failed:\n  " + "\n  ".join(problems)
        )
    if verbose:
        print(
            f"telemetry schema check OK on {dev}: {len(metrics)} metrics, "
            f"{len(seen_spans)} span names, Prometheus + JSON render"
        )
    return snap


def overhead_check(
    bound_ratio: float = 2.5,
    floor_s: float = 2e-3,
    iters: int = 40,
    verbose: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """Instrumented ``FeatureService.request`` must stay within
    ``bound_ratio``× the disabled-telemetry path (+``floor_s`` additive
    slack) at smoke size on ``device``, comparing medians over ``iters``
    calls; returns the two medians and the limit, in seconds."""
    import statistics
    import time

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.core import Col, FeatureView, range_window, rows_window, w_count, w_sum
    from repro_torch.data.synthetic import FRAUD_SCHEMA
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.serve.service import FeatureService

    dev = resolve_device(device)

    amt = Col("amount")
    view = FeatureView(
        "ovh", FRAUD_SCHEMA,
        {
            "s": w_sum(amt, range_window(600, bucket=64)),
            "c5": w_count(amt, rows_window(5)),
        },
    )
    rng = np.random.default_rng(0)

    def batch(i, n=16):
        return {
            "card": rng.integers(0, 32, n),
            "ts": np.arange(200_000 + i * n, 200_000 + (i + 1) * n),
            "amount": rng.gamma(1.5, 60.0, n).astype(np.float32),
            "mcc": rng.integers(0, 32, n),
            "device": rng.integers(0, 8, n),
            "geo": rng.integers(0, 16, n),
        }

    def run(enabled: bool) -> float:
        tel = Telemetry(enabled=enabled)
        with use_telemetry(tel):
            svc = FeatureService.build(
                "ovh", view, num_keys=32, sharded=True, num_shards=4,
                capacity=64, device=dev,
            )
            svc.request(batch(0))  # warm the allocator and the kernels
            times = []
            for i in range(1, iters + 1):
                t0 = time.perf_counter()
                svc.request(batch(i))
                times.append(time.perf_counter() - t0)
        return statistics.median(times)

    base = run(enabled=False)
    inst = run(enabled=True)
    limit = base * bound_ratio + floor_s
    if inst > limit:
        raise AssertionError(
            f"telemetry overhead too high: instrumented median "
            f"{inst * 1e3:.3f} ms > {bound_ratio}x disabled median "
            f"{base * 1e3:.3f} ms + {floor_s * 1e3:.1f} ms floor"
        )
    if verbose:
        print(
            f"telemetry overhead OK on {dev}: instrumented "
            f"{inst * 1e3:.3f} ms vs disabled {base * 1e3:.3f} ms "
            f"(limit {limit * 1e3:.3f} ms)"
        )
    return {"instrumented_s": inst, "disabled_s": base, "limit_s": limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="telemetry gates: schema | overhead | all",
    )
    ap.add_argument("which", nargs="?", default="all")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    which = args.which
    if which not in ("schema", "overhead", "all"):
        print(f"unknown check {which!r}; use schema | overhead | all")
        return 2
    if which in ("schema", "all"):
        schema_check(device=args.device)
    if which in ("overhead", "all"):
        overhead_check(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

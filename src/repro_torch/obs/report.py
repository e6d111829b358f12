"""Markdown dashboard over one telemetry snapshot.

``python -m repro_torch.obs.report`` renders the same
``Telemetry.snapshot()`` dict every other exporter consumes — the JSON
document is the contract, this module is just a view.  With no
``--json`` it runs a tiny demo workload on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions) so the dashboard
always renders something real of this package.

    python -m repro_torch.obs.report                   # demo workload
    python -m repro_torch.obs.report --json snap.json  # a specific snapshot
    python -m repro_torch.obs.report --prom            # Prometheus exposition

The reference package's ``repro.obs.report``: ``render_markdown`` gives
the same text for the same snapshot dict.  The reference falls back to a
snapshot its own benchmark wrote; this package never renders that file
as its own.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

__all__ = ["render_markdown", "demo_snapshot"]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 1:
        return f"{v:.3g}"
    return f"{v:.3g}"


def _ms(v: float) -> str:
    return f"{v * 1e3:.3f}"


def _label_str(labels: Dict[str, str]) -> str:
    return ", ".join(f"{k}={v}" for k, v in labels.items()) or "—"


def _span_lines(span: Dict, depth: int, out: List[str]) -> None:
    fence = " ⏚" if span.get("fenced") else ""
    attrs = span.get("attrs") or {}
    attr_s = (
        " (" + ", ".join(f"{k}={v}" for k, v in attrs.items()) + ")"
        if attrs else ""
    )
    out.append(
        f"{'  ' * depth}- `{span['name']}` [{span['kind']}]{fence} "
        f"{_ms(span['duration_s'])} ms{attr_s}"
    )
    for c in span.get("children", ()):
        _span_lines(c, depth + 1, out)


def render_markdown(snapshot: Dict, title: str = "Telemetry dashboard") -> str:
    """Render one ``Telemetry.snapshot()`` dict as a markdown dashboard."""
    lines = [
        f"# {title}",
        "",
        f"schema_version: {snapshot.get('schema_version')} · "
        f"snapshot time: {snapshot.get('time_s', 0):.3f} s",
        "",
    ]
    metrics = snapshot.get("metrics", {})
    scalars = {
        n: m for n, m in metrics.items() if m["type"] in ("counter", "gauge")
    }
    hists = {n: m for n, m in metrics.items() if m["type"] == "histogram"}

    if scalars:
        lines += [
            "## Counters & gauges",
            "",
            "| metric | type | labels | value | unit |",
            "|---|---|---|---:|---|",
        ]
        for name in sorted(scalars):
            m = scalars[name]
            for s in m["series"]:
                lines.append(
                    f"| `{name}` | {m['type']} | {_label_str(s['labels'])} "
                    f"| {_fmt(s['value'])} | {m['unit']} |"
                )
        lines.append("")

    if hists:
        lines += [
            "## Distributions",
            "",
            "| metric | labels | count | mean | p50 | p95 | p99 | max | unit |",
            "|---|---|---:|---:|---:|---:|---:|---:|---|",
        ]
        for name in sorted(hists):
            m = hists[name]
            for s in m["series"]:
                cnt = s["count"]
                mean = s["sum"] / cnt if cnt else 0.0
                if m["unit"] == "s":
                    cells = [_ms(mean), _ms(s["p50"]), _ms(s["p95"]),
                             _ms(s["p99"]), _ms(s["max"])]
                    unit = "ms"
                else:
                    cells = [_fmt(mean), _fmt(s["p50"]), _fmt(s["p95"]),
                             _fmt(s["p99"]), _fmt(s["max"])]
                    unit = m["unit"]
                lines.append(
                    f"| `{name}` | {_label_str(s['labels'])} | {_fmt(cnt)} | "
                    + " | ".join(cells)
                    + f" | {unit} |"
                )
        lines.append("")

    spans = snapshot.get("spans", [])
    if spans:
        lines += [
            "## Recent request-path spans",
            "",
            "`⏚` marks device-fenced spans (duration includes device "
            "execution, not just async dispatch).",
            "",
        ]
        for s in spans:
            _span_lines(s, 0, lines)
        lines.append("")
    return "\n".join(lines)


def demo_snapshot(tel=None, device="cuda") -> Dict:
    """Run a minimal real workload on ``device`` and return its snapshot
    (the no-args fallback so the dashboard never renders empty).  Pass
    ``tel`` to keep the live registry for other exporters (Prometheus)."""
    import numpy as np

    from repro_torch.core import Col, FeatureView, range_window, rows_window, w_count, w_sum
    from repro_torch.data.synthetic import FRAUD_SCHEMA
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler, FeatureService

    amt = Col("amount")
    view = FeatureView(
        "demo",
        FRAUD_SCHEMA,
        {
            "s": w_sum(amt, range_window(600, bucket=64)),
            "c5": w_count(amt, rows_window(5)),
        },
    )
    tel = tel if tel is not None else Telemetry()
    with use_telemetry(tel):
        svc = FeatureService.build(
            "demo", view, num_keys=32, sharded=True, num_shards=4,
            capacity=64, device=device,
        )
        router = ShardRouter(
            svc, BatchScheduler(max_batch=16, max_wait_us=2_000)
        )
        rng = np.random.default_rng(0)
        now = 0
        for i in range(48):
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
            )
            now += 250
            router.pump(now_us=now)
        router.drain(now_us=now)
        svc.store.record_gauges()
        return tel.snapshot()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry snapshot as a markdown dashboard.",
    )
    ap.add_argument(
        "--json", metavar="PATH", default=None,
        help="snapshot JSON to render (default: run the demo workload)",
    )
    ap.add_argument(
        "--prom", action="store_true",
        help="emit Prometheus text exposition instead of markdown "
        "(demo workload only; saved snapshots render as markdown)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the demo workload: cuda (default) or cpu",
    )
    args = ap.parse_args(argv)

    if args.prom:
        from repro_torch.obs import Telemetry

        # Prometheus rendering needs the live registry, not just the
        # snapshot dict, so run the demo against one we keep
        tel = Telemetry()
        demo_snapshot(tel, device=args.device)
        print(tel.to_prometheus())
        return 0

    if args.json is not None:
        with open(args.json) as f:
            snap = json.load(f)
        title = f"Telemetry dashboard — {os.path.basename(args.json)}"
    else:
        snap = demo_snapshot(device=args.device)
        title = "Telemetry dashboard — demo workload"
    print(render_markdown(snap, title=title))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

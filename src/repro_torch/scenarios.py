"""Example scenarios served by this package (the fraud view of §3.3).

``fraud_view()`` is the reference package's ``repro.scenarios.fraud_view``:
trailing spend windows over card transactions — SUM, MEAN, STD, COUNT and
MAX over 1 h and 6 h RANGE windows, one ROWS(50) count and one derived
``amount > 100`` lane — the view the repository's latency benchmarks use.
"""

from __future__ import annotations

from repro_torch.core.expr import (
    Col,
    range_window,
    rows_window,
    w_count,
    w_max,
    w_mean,
    w_std,
    w_sum,
)
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import FRAUD_SCHEMA

__all__ = ["fraud_view"]


def fraud_view() -> FeatureView:
    """§3.3 fraud detection: trailing spend windows over card transactions."""
    amt = Col("amount")
    w1h, w6h = range_window(3600, bucket=64), range_window(21600, bucket=64)
    return FeatureView(
        name="fraud_features",
        schema=FRAUD_SCHEMA,
        description="card-fraud spend windows (§3.3 latency benchmark view)",
        features={
            "amt_sum_1h": w_sum(amt, w1h),
            "amt_mean_1h": w_mean(amt, w1h),
            "amt_std_1h": w_std(amt, w1h),
            "tx_count_1h": w_count(amt, w1h),
            "amt_sum_6h": w_sum(amt, w6h),
            "amt_max_6h": w_max(amt, w6h),
            "tx_count_50": w_count(amt, rows_window(50)),
            "big_ratio_1h": w_count(amt > 100.0, w1h)
            / (1.0 + w_count(amt, w1h)),
        },
    )

"""Example scenarios of this package, copies of the reference package's
``repro.scenarios`` views of the same names.

* ``fraud_view()`` (§3.3): trailing spend windows over card transactions —
  SUM, MEAN, STD, COUNT and MAX over 1 h and 6 h RANGE windows, one
  ROWS(50) count and one derived ``amount > 100`` lane — the view the
  repository's latency benchmarks use;
* ``reco_view()`` (§3.2): hourly order activity and a user × product
  signature cross;
* ``multi_table_view()`` (§1): LAST JOINs onto profile tables and WINDOW
  UNION windows over a wires stream (:data:`MULTITABLE_DB`).  The offline
  engine computes it; the online store does not serve multi-table views
  yet.
"""

from __future__ import annotations

from repro_torch.core.expr import (
    Col,
    Signature,
    last_join,
    range_window,
    rows_window,
    w_count,
    w_max,
    w_mean,
    w_std,
    w_sum,
)
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import FRAUD_SCHEMA, MULTITABLE_DB, RECO_SCHEMA

__all__ = ["fraud_view", "reco_view", "multi_table_view"]


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


def reco_view() -> FeatureView:
    """§3.2 product recommendation: hourly activity + a user×product cross."""
    spend = Col("price") * Col("qty")
    return FeatureView(
        name="user_activity",
        schema=RECO_SCHEMA,
        description="hourly order activity + user-product signature cross",
        features={
            "spend_1h": w_sum(spend, range_window(3600, bucket=64)),
            "orders_1h": w_count(spend, range_window(3600, bucket=64)),
            "avg_price_20": w_mean(Col("price"), rows_window(20)),
            "cross_user_prod": Signature(
                (Col("user"), Col("product")), bits=20
            ),
        },
    )


def multi_table_view() -> FeatureView:
    """§1 multi-table plane: profile LAST JOINs + cross-stream union windows."""
    amt = Col("amount")
    w1h = range_window(3600, bucket=64)
    credit = last_join(
        Col("credit_limit"), "accounts", on="account", default=1000.0
    )
    return FeatureView(
        name="fraud_multitable",
        description="cross-table fraud features: profile joins + union windows",
        features={
            "credit_limit": credit,
            "acct_risk": last_join(
                Col("risk_score"), "accounts", on="account", default=0.5
            ),
            "merchant_reports": last_join(
                Col("fraud_reports"), "merchants", on="merchant"
            ),
            "outflow_sum_1h": w_sum(amt, w1h, union=("wires",)),
            "outflow_cnt_1h": w_count(amt, w1h, union=("wires",)),
            "outflow_mean_1h": w_mean(amt, w1h, union=("wires",)),
            "limit_utilization": w_sum(amt, w1h, union=("wires",)) / credit,
            "big_vs_limit": (amt / credit) > 0.5,
        },
        database=MULTITABLE_DB,
    )

"""Example scenarios of this package, copies of the reference package's
``repro.scenarios`` views of the same names.

* ``fraud_view()`` (§3.3): trailing spend windows over card transactions —
  SUM, MEAN, STD, COUNT and MAX over 1 h and 6 h RANGE windows, one
  ROWS(50) count and one derived ``amount > 100`` lane — the view the
  repository's latency benchmarks use;
* ``reco_view()`` (§3.2): hourly order activity and a user × product
  signature cross;
* ``multi_table_view()`` (§1): LAST JOINs onto profile tables and WINDOW
  UNION windows over a wires stream (:data:`MULTITABLE_DB`);
* ``sharded_view()``: two LAST JOINs, WINDOW UNION sums / counts over the
  wires stream and one single-table MEAN — the cross-table view of the
  sharded serving plane;
* ``multi_scenario_views()``: three overlapping views over
  :data:`MULTITABLE_DB` (shared union stream, shared join targets), the
  scenarios of one multi-scenario plane.

The online stores serve every one of them, and the multi-scenario plane
(:class:`~repro_torch.core.scenario.ScenarioPlane`) deploys
``multi_scenario_views()`` on one shared store.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.expr import (
    Col,
    Signature,
    last_join,
    range_window,
    rows_window,
    w_count,
    w_distinct_approx,
    w_max,
    w_mean,
    w_std,
    w_sum,
)
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import FRAUD_SCHEMA, MULTITABLE_DB, RECO_SCHEMA

__all__ = [
    "fraud_view", "reco_view", "multi_table_view", "sharded_view",
    "multi_scenario_views",
]


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


def sharded_view() -> FeatureView:
    """Sharded serving of cross-table fraud features on a device mesh."""
    amt = Col("amount")
    w1h = range_window(3600, bucket=64)
    credit = last_join(
        Col("credit_limit"), "accounts", on="account", default=1000.0
    )
    return FeatureView(
        name="fraud_sharded",
        description="sharded serving of cross-table fraud features",
        features={
            "credit_limit": credit,
            "merchant_ticket": last_join(
                Col("avg_ticket"), "merchants", on="merchant", default=50.0
            ),
            "outflow_1h": w_sum(amt, w1h, union=("wires",)),
            "outflow_cnt_1h": w_count(amt, w1h, union=("wires",)),
            "spend_mean_1h": w_mean(amt, w1h),
            "utilization": w_sum(amt, w1h, union=("wires",)) / credit,
        },
        database=MULTITABLE_DB,
    )


def multi_scenario_views() -> List[FeatureView]:
    """Three scenarios for one multi-scenario plane (the reference package's ``ScenarioPlane``).

    Deliberately overlapping so consolidation has something to share:
    ``wires`` is WINDOW UNIONed by *acct_risk* and *spend_profile* (and
    the 1h outflow sum is the same structural wagg — one shared lane),
    ``accounts`` is LAST JOINed by *acct_risk* and *merchant_watch*, and
    ``merchants`` by *spend_profile* and *merchant_watch*.
    """
    amt = Col("amount")
    w1h = range_window(3600, bucket=64)
    w6h = range_window(21600, bucket=64)
    outflow_1h = w_sum(amt, w1h, union=("wires",))
    credit = last_join(
        Col("credit_limit"), "accounts", on="account", default=1000.0
    )
    acct_risk = FeatureView(
        name="acct_risk",
        description="account risk: credit utilization over merged outflows",
        features={
            "credit_limit": credit,
            "outflow_1h": outflow_1h,
            "outflow_cnt_1h": w_count(amt, w1h, union=("wires",)),
            "utilization_1h": outflow_1h / credit,
            "overdraft_now": (amt / credit) > 0.5,
        },
        database=MULTITABLE_DB,
    )
    spend_profile = FeatureView(
        name="spend_profile",
        description="spending profile: per-account spend shape vs merchant",
        features={
            "outflow_1h": outflow_1h,  # shared lane with acct_risk
            "outflow_mean_6h": w_mean(amt, w6h, union=("wires",)),
            "spend_std_6h": w_std(amt, w6h),
            "merchant_ticket": last_join(
                Col("avg_ticket"), "merchants", on="merchant", default=50.0
            ),
            "tx_count_10": w_count(amt, rows_window(10)),
        },
        database=MULTITABLE_DB,
    )
    merchant_watch = FeatureView(
        name="merchant_watch",
        description="merchant watchlist: reports + account risk exposure",
        features={
            "acct_risk_score": last_join(
                Col("risk_score"), "accounts", on="account", default=0.5
            ),
            "merchant_reports": last_join(
                Col("fraud_reports"), "merchants", on="merchant"
            ),
            "merchants_seen_6h": w_distinct_approx(Col("merchant"), w6h),
            "spend_max_6h": w_max(amt, w6h),
        },
        database=MULTITABLE_DB,
    )
    return [acct_risk, spend_profile, merchant_watch]

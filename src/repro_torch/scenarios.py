"""Canonical example scenarios — the mirror of FeatInsight's "100+
real-world scenarios on one platform" claim, copied from the reference
package's ``repro.scenarios``.

One module owns every example feature view so the docs stay honest: the
feature catalog (``python -m repro_torch.catalog`` →
``docs/CATALOG_TORCH.md``), the examples (``repro_torch.examples``) and
the tests build their views from here.  Each :class:`Scenario` records
what a platform catalog would: the view definition(s), the workload it
models, and the command that runs it.

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
  scenarios of one multi-scenario plane
  (:class:`~repro_torch.core.scenario.ScenarioPlane`), shared tables
  ingested once, answers bit-identical to three dedicated stores.

:data:`SCENARIOS` and :data:`GENERATED` hold the same names, titles,
descriptions, deploy history and seeds as the reference's registry; their
``run`` lines name this package's commands.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

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
    "Scenario",
    "SCENARIOS",
    "GeneratedFamily",
    "GENERATED",
    "fraud_view",
    "reco_view",
    "multi_table_view",
    "sharded_view",
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


# ---------------------------------------------------------------------------
# The scenario registry (what a platform catalog page lists)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One deployed example scenario: its views, workload, and run command.

    ``hot_deployed`` names the views this scenario deploys onto the LIVE
    plane via ``MultiScenarioService.hot_deploy`` (rather than at launch)
    — the catalog's deploy history records them as hot deploys, matching
    what the example actually does.  ``exported`` names the views whose
    example also exports a point-in-time training set from the same
    definitions (``repro_torch.offline.export_training_set``) — the catalog's
    deploy history records that lineage under an ``export:`` service,
    exactly as a registry-carrying export call would.
    """

    name: str
    title: str
    description: str
    run: str
    views: Callable[[], List[FeatureView]]
    hot_deployed: tuple = ()
    exported: tuple = ()


def _one(builder: Callable[[], FeatureView]) -> Callable[[], List[FeatureView]]:
    return lambda: [builder()]


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="fraud",
            title="Online fraud detection",
            description=(
                "Card-transaction stream; trailing spend windows feed a "
                "scoring transformer (paper §3.3)."
            ),
            run="PYTHONPATH=src python -m repro_torch.examples.fraud_detection",
            views=_one(fraud_view),
        ),
        Scenario(
            name="recommendation",
            title="Product recommendation",
            description=(
                "Minute-level order events; one-click design→verify→deploy "
                "with version evolution (paper §3.2)."
            ),
            run="PYTHONPATH=src python -m repro_torch.examples.recommendation",
            views=_one(reco_view),
        ),
        Scenario(
            name="multi_table_fraud",
            title="Multi-table fraud features",
            description=(
                "4-table database: point-in-time LAST JOINs + WINDOW UNION "
                "outflows, verified offline↔online."
            ),
            run="PYTHONPATH=src python -m repro_torch.examples.multi_table_fraud",
            views=_one(multi_table_view),
            exported=("fraud_multitable",),
        ),
        Scenario(
            name="sharded_serving",
            title="Sharded online serving",
            description=(
                "The multi-table view key-partitioned across a ('shard',) "
                "device mesh behind a micro-batching router."
            ),
            run="PYTHONPATH=src python -m repro_torch.examples.sharded_serving",
            views=_one(sharded_view),
        ),
        Scenario(
            name="multi_scenario",
            title="Multi-scenario plane",
            description=(
                "Three views (acct_risk, spend_profile, merchant_watch) on "
                "ONE store/mesh; shared tables ingested once, answers "
                "bit-identical to dedicated stores; merchant_watch is "
                "hot-deployed onto the warm plane."
            ),
            run="PYTHONPATH=src python -m repro_torch.examples.multi_scenario",
            views=multi_scenario_views,
            hot_deployed=("merchant_watch",),
        ),
    )
}


# ---------------------------------------------------------------------------
# Generated scenario families (the stress suite's registry hook)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeneratedFamily:
    """A seeded family of GENERATED scenario views — the catalog entry for
    the paper's "100+ scenarios" scale claim.

    Unlike :class:`Scenario`, the views are not hand-written: they come
    from the deterministic generator in :mod:`repro_torch.stress.generate`, so
    the catalog renders a scale-aware structural census instead of 100+
    full entries.  ``(seed, n, profile)`` pins the family byte-exactly.
    """

    name: str
    title: str
    description: str
    run: str
    seed: int
    n: int
    profile: str

    def views(self) -> List[FeatureView]:
        from repro_torch.stress.generate import gen_views

        return gen_views(self.seed, self.n, self.profile)

    def summary_md(self) -> str:
        from repro_torch.stress.generate import render_summary_md

        return render_summary_md(
            self.views(), seed=self.seed, n=self.n, profile=self.profile
        )


GENERATED: Dict[str, GeneratedFamily] = {
    f.name: f
    for f in (
        GeneratedFamily(
            name="stress",
            title="Scenario explosion (generated stress suite)",
            description=(
                "128 seeded, deterministic feature views sampling the "
                "entire expr IR surface — every Agg, both window modes, "
                "WINDOW UNIONs over shared streams, multi-table LAST "
                "JOINs, Signature/Hash lanes, evolve chains — deployed "
                "onto one sharded plane and churned by the stress "
                "harness (hot-deploy waves, mixed traffic under both "
                "routing flavours, continuous sampled verification with "
                "failure shrinking)."
            ),
            run="PYTHONPATH=src python -m repro_torch.stress --smoke",
            seed=0,
            n=128,
            profile="default",
        ),
    )
}

"""The port's example twins, each ``main(device="cpu")`` at the reference
example's sizes with the reference's assertions inside it.

Quickstart's and recommendation's served features are held to the
reference package's API on the same inputs: the same CSV text through
``repro.data.load_csv`` into a ``repro.core.OnlineFeatureStore``, the same
reco stream and scheduler batches into the reference's store of
``reco_view()``.  Counts and signature ids must be equal; sums and means
within ``rtol=1e-6`` (the port's preagg sums fold buckets in another
order, ROADMAP Queue C).  Nothing runs at import, and without a GPU an
example's default device raises.
"""

import importlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
NAMES = ("quickstart", "recommendation", "multi_table_fraud",
         "sharded_serving", "multi_scenario")
RTOL = 1e-6


def _close(want, got, where):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, where
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=where)


def _main(name):
    return importlib.import_module(f"repro_torch.examples.{name}").main


def test_examples_run_nothing_at_import():
    code = "".join(f"import repro_torch.examples.{n}\n" for n in NAMES)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == ""


def test_examples_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            _main(name)()


def test_quickstart_equals_the_reference_api():
    from repro.core import (
        Col, FeatureView, OfflineEngine, OnlineFeatureStore, range_window,
        w_count, w_mean, w_sum,
    )
    from repro.core.storage import TableSchema
    from repro.data import load_csv
    from repro_torch.examples import quickstart as qs

    out = _main("quickstart")(device="cpu")
    assert out["report"].passed
    schema = TableSchema(name="orders", key="user", ts="ts",
                         numeric=("price",), categorical=("product",))
    table = load_csv(io.StringIO(qs.csv_text()), schema)
    for c in table:
        assert table[c].tobytes() == out["table"][c].tobytes()
    price, w1k = Col("price"), range_window(1000, bucket=64)
    view = FeatureView(
        name="user_spend", schema=schema,
        features={"spend_1k": w_sum(price, w1k),
                  "orders_1k": w_count(price, w1k),
                  "avg_1k": w_mean(price, w1k),
                  "big_order": price > 100.0},
    )
    store = OnlineFeatureStore(view, num_keys=4, num_buckets=64,
                               bucket_size=64)
    order = np.lexsort((table["ts"], table["user"]))
    store.ingest({c: v[order] for c, v in table.items()})
    want = store.query(qs.request_rows())
    for f in view.features:
        _close(want[f], out["online"][f], f"online {f}")
    np.testing.assert_array_equal(out["online"]["orders_1k"],
                                  np.asarray(want["orders_1k"]))
    offline = OfflineEngine().compute(view, table)
    for f in view.features:
        _close(offline[f], out["offline"][f], f"offline {f}")


def test_recommendation_served_features_equal_the_reference_api():
    from repro.core import OnlineFeatureStore
    from repro.scenarios import reco_view

    out = _main("recommendation")(device="cpu")
    assert out["report"].passed and out["served"] == 23
    assert out["registry"].versions("user_activity") == [1, 2]
    cols = out["columns"]
    store = OnlineFeatureStore(reco_view(), num_keys=128, num_buckets=64,
                               bucket_size=64)
    order = np.lexsort((cols["ts"], cols["user"]))
    store.ingest({c: v[order] for c, v in cols.items()})
    assert out["batches"]
    for batch, valid, got in out["batches"]:
        want = store.query(batch, mode="preagg")
        for f in got:
            _close(np.asarray(want[f])[valid], got[f][valid], f)
        np.testing.assert_array_equal(got["orders_1h"][valid],
                                      np.asarray(want["orders_1h"])[valid])
        np.testing.assert_array_equal(
            got["cross_user_prod"][valid],
            np.asarray(want["cross_user_prod"])[valid])
        rows = {c: v[valid] for c, v in batch.items()}
        o = np.lexsort((rows["ts"], rows["user"]))
        store.ingest({c: v[o] for c, v in rows.items()})


def test_multi_table_fraud_example():
    out = _main("multi_table_fraud")(device="cpu")
    assert all(r.passed for r in out["reports"].values())
    assert set(out["reports"]) == {"naive", "preagg"}
    assert len(out["training"].features["credit_limit"]) == 256
    dep = out["registry"].deployments("fraud_multitable")[-1]
    assert dep["service"] == "export:fraud_multitable"
    assert np.isfinite(out["online"]["limit_utilization"]).all()


def test_sharded_serving_example():
    out = _main("sharded_serving")(device="cpu")
    assert len(out["answers"]["utilization"]) == 200
    for f, v in out["answers"].items():
        np.testing.assert_array_equal(v, out["single"][f])
    assert int(out["shard_histogram"].sum()) == 200


def test_multi_scenario_example():
    out = _main("multi_scenario")(device="cpu")
    assert out["report"].exact
    assert out["backfill_report"].exact and out["backfill_report"].backfilled
    assert set(out["answers"]) == {"acct_risk", "spend_profile",
                                   "merchant_watch"}
    assert sum(len(next(iter(a.values())))
               for a in out["answers"].values()) == 180

"""The PyTorch port's offline path against the JAX package.

Sorting, window starts, the compensated prefix sums, the windowed folds,
LAST JOIN / WINDOW UNION, ``OfflineEngine`` and ``verify_view``: the same
numpy-made tables go through both packages, the port on
``device="cpu"`` (its kernels run their plain versions), the JAX side as
its own tests run it on the CPU.

Tolerances:

* bit for bit: permutations, segment and window starts, the (hi, lo)
  prefix pairs, COUNT / MIN / MAX / FIRST / LAST / TOPN_FREQ, LAST JOIN
  values, merged streams and replay rounds;
* DISTINCT_APPROX: its OR-bitmap fold bit for bit; the estimate
  ``-32 * log1p(-ones / 32)`` within ``rtol=1e-6``, because PyTorch's and
  XLA's ``log1p`` differ by up to one ulp (ROADMAP Queue C);
* SUM and MEAN: ``rtol=1e-5`` plus ``1e-5 * max|arg| * count`` absolute.
  Both packages center the argument by its mean before the prefix sums,
  and the mean reduces in a framework-chosen order; a different rounding
  of ``mu`` shifts ``s + mu * count`` by about ``eps * |mu| * count``;
* STD: ``verify_view``'s tolerance (``rtol=2e-4``, ``atol=1e-3`` times
  the 99th-percentile magnitude) plus ``2**-12 * |mean|`` per row: the
  centered sums differ by the same ``mu`` rounding, and XLA on the CPU
  contracts ``sumsq / n - m * m`` into a fused multiply-add (ROADMAP
  Queue C), which moves near-zero variances by up to that bound.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.expr as jex
import repro_torch.core.expr as tex
from repro.core import join as jjoin
from repro.core import windows as jwin
from repro.core.consistency import replay_rounds as jax_replay_rounds
from repro.core.consistency import verify_view as jax_verify_view
from repro.core.engine import OfflineEngine as JaxEngine
from repro.data.synthetic import multitable_stream, reco_stream
from repro.scenarios import fraud_view as jax_fraud_view
from repro.scenarios import multi_table_view as jax_multi_table_view
from repro.scenarios import reco_view as jax_reco_view
from repro_torch.core import join as tjoin
from repro_torch.core import windows as twin
from repro_torch.core.consistency import replay_rounds, verify_view
from repro_torch.core.engine import OfflineEngine, shard_rows
from repro_torch.data.synthetic import fraud_transactions
from repro_torch.scenarios import fraud_view, multi_table_view, reco_view

EXACT_AGGS = ("COUNT", "MIN", "MAX", "FIRST", "LAST", "TOPN_FREQ")


def _rng(tag):
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _t(a):
    return torch.as_tensor(np.array(a))


def _sorted_table(rng, n, k, tmax):
    key = np.sort(rng.integers(0, k, n)).astype(np.int32)
    ts = rng.integers(0, tmax, n).astype(np.int32)
    o = np.lexsort((ts, key))
    return key[o], ts[o]


# ---------------------------------------------------------------------------
# windows.py primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 2049])
def test_sort_segment_and_window_starts_exact(n):
    rng = _rng(f"starts-{n}")
    key = rng.integers(0, 9, n).astype(np.int32)
    ts = rng.integers(0, 3000, n).astype(np.int32)
    amt = rng.gamma(2.0, 40.0, n).astype(np.float32)
    jout = jwin.sort_by_key_ts(jnp.asarray(key), jnp.asarray(ts),
                               jnp.asarray(amt))
    tout = twin.sort_by_key_ts(_t(key), _t(ts), _t(amt))
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    skey, sts = np.asarray(jout[0]), np.asarray(jout[1])
    jseg = jwin.segment_starts(jnp.asarray(skey))
    tseg = twin.segment_starts(_t(skey))
    np.testing.assert_array_equal(np.asarray(jseg), tseg.numpy())
    for size in (1, 9, 50):
        np.testing.assert_array_equal(
            np.asarray(jwin.window_start_rows(jseg, size)),
            twin.window_start_rows(tseg, size).numpy(),
        )
    for size in (1, 500, 10_000):
        np.testing.assert_array_equal(
            np.asarray(jwin.window_start_range(
                jnp.asarray(skey), jnp.asarray(sts), jseg, size)),
            twin.window_start_range(_t(skey), _t(sts), tseg, size).numpy(),
        )


@pytest.mark.parametrize("n", [1, 2, 3, 17, 4097])
@pytest.mark.parametrize("compensated", [True, False])
def test_segment_prefix_sum_bit_exact(n, compensated):
    """The replayed associative-scan tree gives the reference's (hi, lo)
    pairs bit for bit, values of both signs and ``-0.0`` included."""
    rng = _rng(f"psum-{n}-{compensated}")
    key = np.sort(rng.integers(0, 7, n)).astype(np.int32)
    x = (rng.gamma(2.0, 50.0, n) - 100.0).astype(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    jseg = jwin.segment_starts(jnp.asarray(key))
    jhi, jlo = jax.jit(jwin._segment_prefix_sum, static_argnums=2)(
        jnp.asarray(x), jseg, compensated)
    thi, tlo = twin._segment_prefix_sum(_t(x), _t(np.asarray(jseg)),
                                        compensated)
    np.testing.assert_array_equal(_bits(jhi), _bits(thi.numpy()))
    np.testing.assert_array_equal(_bits(jlo), _bits(tlo.numpy()))


@pytest.mark.parametrize("op", ["min", "max", "or"])
@pytest.mark.parametrize("window", ["rows37", "range400"])
def test_segmented_windowed_fold_exact(op, window):
    rng = _rng(f"swf-{op}-{window}")
    key, ts = _sorted_table(rng, 1500, 6, 4000)
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, 1500).astype(np.int32)
    else:
        x = rng.normal(size=1500).astype(np.float32)
    jseg = jwin.segment_starts(jnp.asarray(key))
    if window.startswith("rows"):
        j = jwin.window_start_rows(jseg, int(window[4:]))
    else:
        j = jwin.window_start_range(jnp.asarray(key), jnp.asarray(ts), jseg,
                                    int(window[5:]))
    want = jwin.segmented_windowed_fold(jnp.asarray(x), jseg, j, op)
    got = twin.segmented_windowed_fold(_t(x), _t(np.asarray(jseg)),
                                       _t(np.asarray(j)), op)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    if op == "min":  # and both equal brute force
        jn = np.asarray(j)
        brute = np.array([x[jn[i]:i + 1].min() for i in range(len(x))])
        np.testing.assert_array_equal(got.numpy(), brute)


def _requests(mod, amt, cat, w):
    ag = mod.Agg
    return {
        name: (getattr(ag, name), cat if name in ("DISTINCT_APPROX",
                                                  "TOPN_FREQ") else amt,
               w, 1 if name == "TOPN_FREQ" else 0)
        for name in ("SUM", "COUNT", "MEAN", "MIN", "MAX", "STD",
                     "DISTINCT_APPROX", "FIRST", "LAST", "TOPN_FREQ")
    }


def _assert_sum_close(got, want, amt_max, cnt):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * amt_max * float(cnt.max()) + 1e-6)


@pytest.mark.parametrize("window", ["rows9", "range500", "range64"])
def test_windowed_aggregate_all_ten_aggregates(window):
    rng = _rng(f"wagg-{window}")
    key, ts = _sorted_table(rng, 2000, 8, 4000)
    amt = rng.gamma(2.0, 40.0, 2000).astype(np.float32)
    cat = rng.integers(0, 20, 2000).astype(np.float32)
    size = int(window[4:] if window.startswith("rows") else window[5:])
    jw = (jex.rows_window(size) if window.startswith("rows")
          else jex.range_window(size, bucket=64))
    tw = (tex.rows_window(size) if window.startswith("rows")
          else tex.range_window(size, bucket=64))
    jamt, jcat = jnp.asarray(amt), jnp.asarray(cat)
    want = jax.jit(lambda k, t, a, c: jwin.windowed_aggregate(
        k, t, _requests(jex, a, c, jw)))(
        jnp.asarray(key), jnp.asarray(ts), jamt, jcat)
    got = twin.windowed_aggregate(_t(key), _t(ts),
                                  _requests(tex, _t(amt), _t(cat), tw))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    for name in EXACT_AGGS:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)
    np.testing.assert_allclose(got["DISTINCT_APPROX"],
                               want["DISTINCT_APPROX"], rtol=1e-6)
    # the bitmap fold under the estimate: exact
    from repro.core.aggregates import row_bitmap as jax_row_bitmap
    from repro_torch.core.aggregates import row_bitmap

    jseg = jwin.segment_starts(jnp.asarray(key))
    j = (jwin.window_start_rows(jseg, size) if window.startswith("rows")
         else jwin.window_start_range(jnp.asarray(key), jnp.asarray(ts),
                                      jseg, size))
    want_bits = jwin.segmented_windowed_fold(jax_row_bitmap(jcat), jseg, j,
                                             "or")
    got_bits = twin.segmented_windowed_fold(
        row_bitmap(_t(cat)), _t(np.asarray(jseg)), _t(np.asarray(j)), "or")
    np.testing.assert_array_equal(np.asarray(want_bits), got_bits.numpy())
    cnt = want["COUNT"]
    _assert_sum_close(got["SUM"], want["SUM"], amt.max(), cnt)
    np.testing.assert_allclose(got["MEAN"], want["MEAN"], rtol=1e-5,
                               atol=1e-5 * amt.max())
    scale = float(np.percentile(np.abs(want["STD"]), 99))
    np.testing.assert_allclose(
        got["STD"], want["STD"], rtol=2e-4,
        atol=1e-3 * max(1.0, scale) + 2.0 ** -12 * float(np.abs(
            want["MEAN"]).max()))


# ---------------------------------------------------------------------------
# join.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [0, 1, 50, 333])
def test_pit_searchsorted_and_last_join_exact(m):
    rng = _rng(f"join-{m}")
    skey, sts = _sorted_table(rng, m, 10, 1000)
    svals = rng.uniform(0, 100, m).astype(np.float32)
    qkey = rng.integers(-1, 12, 400).astype(np.int32)
    qts = rng.integers(-5, 1100, 400).astype(np.int32)
    if m:
        np.testing.assert_array_equal(
            np.asarray(jjoin.pit_searchsorted(*map(jnp.asarray, (
                skey, sts, qkey, qts)))),
            tjoin.pit_searchsorted(*map(_t, (skey, sts, qkey, qts))).numpy(),
        )
    want = jjoin.last_join_gather(*map(jnp.asarray, (skey, sts, svals, qkey,
                                                      qts)), default=-7.5)
    got = tjoin.last_join_gather(*map(_t, (skey, sts, svals, qkey, qts)),
                                 default=-7.5)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_merge_streams_exact():
    rng = _rng("merge")
    streams = [_sorted_table(rng, n, 5, 300) for n in (40, 1, 77)]
    want = jjoin.merge_streams([jnp.asarray(k) for k, _ in streams],
                               [jnp.asarray(t) for _, t in streams])
    got = tjoin.merge_streams([_t(k) for k, _ in streams],
                              [_t(t) for _, t in streams])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# engine.py — whole views
# ---------------------------------------------------------------------------


def _fraud_cols(rng, n, cards, tmax):
    return dict(
        card=rng.integers(0, cards, n).astype(np.int32),
        ts=rng.integers(0, tmax, n).astype(np.int32),
        amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
        mcc=rng.integers(0, 32, n).astype(np.int32),
        device=rng.integers(0, 8, n).astype(np.int32),
        geo=rng.integers(0, 16, n).astype(np.int32),
    )


def _compare_features(got, want, exact, sums=(), means=(), stds=()):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for f in exact:
        np.testing.assert_array_equal(_bits(got[f]), _bits(want[f]),
                                      err_msg=f)
    for f, (amax, cnt) in sums.items() if sums else ():
        _assert_sum_close(got[f], want[f], amax, want[cnt])
    for f, amax in means.items() if means else ():
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                   atol=1e-5 * amax, err_msg=f)
    for f, mean in stds.items() if stds else ():
        scale = float(np.percentile(np.abs(want[f]), 99))
        np.testing.assert_allclose(
            got[f], want[f], rtol=2e-4, err_msg=f,
            atol=1e-3 * max(1.0, scale)
            + 2.0 ** -12 * float(np.abs(want[mean]).max()))


def test_engine_fraud_view_matches_jax():
    """Unsorted input, hot card, 1 h / 6 h RANGE and ROWS(50) windows."""
    rng = _rng("engine-fraud")
    cols = _fraud_cols(rng, 3000, 16, 40_000)
    cols["card"][:400] = 3
    amax = float(cols["amount"].max())
    want = JaxEngine().compute(jax_fraud_view(),
                               {k: jnp.asarray(v) for k, v in cols.items()})
    got = OfflineEngine(device="cpu").compute(fraud_view(), cols)
    _compare_features(
        got, want,
        exact=("tx_count_1h", "tx_count_50", "amt_max_6h", "big_ratio_1h"),
        sums={"amt_sum_1h": (amax, "tx_count_1h"),
              "amt_sum_6h": (amax, "tx_count_1h")},
        means={"amt_mean_1h": amax},
        stds={"amt_std_1h": "amt_mean_1h"},
    )


def test_engine_reco_view_matches_jax():
    """Derived argument (price * qty), ROWS(20) mean, Signature cross."""
    rng = _rng("engine-reco")
    cols = reco_stream(rng, 2500, num_users=16, num_products=64,
                       t_max=20_000)
    perm = rng.permutation(2500)
    cols = {k: v[perm] for k, v in cols.items()}
    smax = float((cols["price"] * cols["qty"]).max())
    want = JaxEngine().compute(jax_reco_view(),
                               {k: jnp.asarray(v) for k, v in cols.items()})
    got = OfflineEngine(device="cpu").compute(reco_view(), cols)
    _compare_features(
        got, want, exact=("orders_1h", "cross_user_prod"),
        sums={"spend_1h": (smax, "orders_1h")},
        means={"avg_price_20": float(cols["price"].max())},
    )


def test_engine_multi_table_view_matches_jax():
    """LAST JOINs onto two profile tables and WINDOW UNION over wires."""
    rng = _rng("engine-multi")
    tables = multitable_stream(rng, 2000, num_accounts=12, num_merchants=6,
                               t_max=30_000)
    prim = tables.pop("transactions")
    amax = float(max(prim["amount"].max(), tables["wires"]["amount"].max()))
    want = JaxEngine().compute(
        jax_multi_table_view(), {k: jnp.asarray(v) for k, v in prim.items()},
        secondary={t: {c: jnp.asarray(v) for c, v in cols.items()}
                   for t, cols in tables.items()})
    got = OfflineEngine(device="cpu").compute(
        multi_table_view(), prim, secondary=tables)
    _compare_features(
        got, want,
        exact=("credit_limit", "acct_risk", "merchant_reports",
               "outflow_cnt_1h", "big_vs_limit"),
        sums={"outflow_sum_1h": (amax, "outflow_cnt_1h")},
        means={"outflow_mean_1h": amax},
    )
    # utilization = union sum / joined credit limit: the sum's tolerance
    got_u = got["limit_utilization"].numpy()
    want_u = np.asarray(want["limit_utilization"])
    np.testing.assert_allclose(
        got_u, want_u, rtol=1e-5,
        atol=1e-5 * amax * float(np.asarray(want["outflow_cnt_1h"]).max())
        / float(tables["accounts"]["credit_limit"].min()))


def test_engine_cache_export_and_missing_table(tmp_path):
    rng = _rng("engine-cache")
    cols = _fraud_cols(rng, 500, 8, 10_000)
    eng = OfflineEngine(device="cpu")
    view = fraud_view()
    assert eng.compile(view) is eng.compile(view)
    assert eng.compile_count == 1
    out = eng.export_training_set(view, cols, label="amount",
                                  path=str(tmp_path / "train.npz"))
    assert set(out) == set(view.features) | {"__label__"}
    assert all(v.shape == (500,) for v in out.values())
    saved = np.load(tmp_path / "train.npz")
    np.testing.assert_array_equal(saved["tx_count_1h"], out["tx_count_1h"])
    with pytest.raises(KeyError, match="references table"):
        eng.compute(multi_table_view(), cols)


def test_shard_rows_never_splits_a_key():
    key = np.sort(_rng("shard").integers(0, 40, 1000)).astype(np.int32)
    shard = shard_rows(key, 4)
    assert shard[0] == 0 and shard[-1] == 3
    assert np.all(np.diff(shard) >= 0)
    for k in np.unique(key):
        assert len(np.unique(shard[key == k])) == 1


# ---------------------------------------------------------------------------
# consistency.py — the port's offline <-> online check
# ---------------------------------------------------------------------------


def test_replay_rounds_match_jax():
    rng = _rng("rounds")
    key = rng.integers(0, 9, 700).astype(np.int32)
    ts = rng.integers(0, 300, 700).astype(np.int32)
    want = jax_replay_rounds(key, ts)
    got = replay_rounds(key, ts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert replay_rounds(key[:0], ts[:0]) == []


def _big_view():
    """``tests/test_consistency.py``'s BIG_VIEW, built from the port."""
    from repro_torch.core.storage import TableSchema
    from repro_torch.core.view import FeatureView

    C, rw, rg = tex.Col, tex.rows_window, tex.range_window
    schema = TableSchema(name="tx", key="uid", ts="ts", numeric=("amount",),
                         categorical=("mcc",))
    return FeatureView("all_aggs", schema, {
        "sum_r": tex.w_sum(C("amount"), rg(500, bucket=64)),
        "mean_r": tex.w_mean(C("amount"), rg(500, bucket=64)),
        "min_r": tex.w_min(C("amount"), rg(500, bucket=64)),
        "max_r": tex.w_max(C("amount"), rg(500, bucket=64)),
        "std_r": tex.w_std(C("amount"), rg(500, bucket=64)),
        "cnt_rows": tex.w_count(C("amount"), rw(9)),
        "sum_rows": tex.w_sum(C("amount"), rw(9)),
        "distinct": tex.w_distinct_approx(C("mcc"), rg(500, bucket=64)),
        "top1": tex.w_topn_freq(C("mcc"), rw(16), n=0),
        "derived": tex.w_sum(C("amount") * (C("amount") > 50.0),
                             rg(500, bucket=64)),
    })


def _workload(seed, n, k, tmax):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, k, n).astype(np.int32)
    ts = np.sort(rng.integers(0, tmax, n)).astype(np.int32)
    return dict(
        uid=key, ts=ts,
        amount=rng.gamma(2.0, 40.0, n).astype(np.float32),
        mcc=rng.integers(0, 20, n).astype(np.int32),
    )


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("seed", [0, 1])
def test_verify_view_all_aggs_passes(mode, seed):
    cols = _workload(seed, n=500, k=6, tmax=3000)
    rep = verify_view(
        _big_view(), cols, num_keys=6, capacity=256, num_buckets=64,
        bucket_size=64, mode=mode, device="cpu",
    )
    assert rep.passed, rep.summary() + f" per-feature: {rep.per_feature}"
    assert rep.n_rows == 500 and rep.n_features == 10


@pytest.mark.parametrize("mode", ["naive", "preagg"])
def test_verify_view_fraud_sharded_passes(mode):
    rng = _rng(f"verify-fraud-{mode}")
    cols = _fraud_cols(rng, 1500, 24, 30_000)
    rep = verify_view(fraud_view(), cols, num_keys=24, num_buckets=512,
                      mode=mode, num_shards=4, device="cpu")
    assert rep.passed, rep.summary() + f" per-feature: {rep.per_feature}"
    assert rep.mode == f"{mode}/shards=4"


# (rows, cards, span s, ring capacity, seed) of fraud traffic
SPAN_CASES = {
    # 8 rows per card in one hour: every 1 h / 6 h window reaches back to
    # its card's first row
    "hour": (4096, 512, 3_600, 256, 4),
    # the same density over a day: some 1 h windows hold two near-equal
    # large amounts, and the online STD (``sumsq / n - m * m`` on raw
    # amounts) loses their small variance
    "day": (8192, 1024, 86_400, 256, 6),
    # 128 rows per card over a day: the ring (64 rows) wraps and every
    # bucket slot is reused (1,350 bucket ids over 512 slots), while a 6 h
    # window still fits in the ring
    "day_deep": (2048, 16, 86_400, 64, 4),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_verify_view_fraud_span(case):
    """The fraud view's offline <-> online check as the traffic's span
    grows.  "hour" and "day_deep" pass in both modes.  "day" records the
    finding of ROADMAP Queue C: the check's STD tolerance
    (``1e-3 * p99|STD|``) does not cover near-zero variances, and the JAX
    package (preagg; its per-round compiles make naive slow here) and the
    port (both modes) fail on ``amt_std_1h`` alone — every other feature is
    within 1e-3, below its own tolerance."""
    rows, cards, span, cap, seed = SPAN_CASES[case]
    cols = fraud_transactions(np.random.default_rng(seed), rows, cards, 0,
                              span)
    kw = dict(num_keys=cards, capacity=cap, num_buckets=512, bucket_size=64)
    if case == "day_deep":
        assert np.bincount(cols["card"]).max() > cap and span > 512 * 64
    reps = [verify_view(fraud_view(), cols, mode=m, device="cpu", **kw)
            for m in ("naive", "preagg")]
    if case != "day":
        for r in reps:
            assert r.passed, r.summary() + f" per-feature: {r.per_feature}"
        return
    reps.append(jax_verify_view(jax_fraud_view(), cols, mode="preagg", **kw))
    std = {f"{type(r).__module__.split('.')[0]}/{r.mode}":
           r.per_feature["amt_std_1h"] for r in reps}
    for r in reps:
        assert not r.passed, f"expected the STD finding, got {r.summary()}"
        others = {f: e for f, e in r.per_feature.items() if f != "amt_std_1h"}
        assert max(others.values()) <= 1e-3, (r.mode, others)
    # the errors as measured (port: no FMA in the variance; JAX: XLA's FMA)
    assert std == pytest.approx({"repro_torch/naive": 0.25,
                                 "repro_torch/preagg": 0.25,
                                 "repro/preagg": 0.1191}, abs=5e-4), std


"""The port's multi-table online store against the JAX package.

Secondary tables (LAST JOIN targets and WINDOW UNION streams) in the
single-device and sharded stores: the same numpy-made tables
(``multitable_stream``, made by both packages from one seed) go through
both packages' stores, the port on ``device="cpu"``, the JAX side as its
own tests run it on the CPU.  Tolerances:

* bit for bit: every state array (primary ring, buckets, each secondary
  ring — every JAX replica of a replicated ring equals the port's one
  copy), LAST JOIN answers, COUNTs and ``big_vs_limit``, and every
  answer in naive mode;
* SUM and MEAN (and the ratios over them) in preagg mode: ``rtol=1e-5``,
  as in ``tests/test_torch_slice.py`` — the bucket states fold in a
  framework-chosen order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as jsc
import repro_torch.scenarios as tsc
from repro.core import FeatureView as JaxView
from repro.core import OnlineFeatureStore as JaxStore
from repro.core import ShardedOnlineStore as JaxSharded
from repro.core import expr as jex
from repro.core import storage as jst
from repro.core.consistency import replay_rounds
from repro.data.synthetic import multitable_stream as jax_multitable_stream
from repro.obs import Telemetry as JaxTelemetry
from repro.obs import use_telemetry as jax_use_telemetry
from repro_torch.convert import online_state_from_numpy, online_state_to_numpy
from repro_torch.core import expr as tex
from repro_torch.core import storage as tst
from repro_torch.core.consistency import verify_view
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.shard import ShardedOnlineStore
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
from repro_torch.obs import Telemetry, use_telemetry

ACCOUNTS, MERCHANTS = 256, 16
T_MAX = 20_000
# transactions replayed round by round (5 rounds of unique accounts)
REPLAY_ROWS = 200
KW = dict(capacity=64, num_buckets=64, bucket_size=64,
          secondary_num_keys={"merchants": MERCHANTS})
SEC_KEY = {"wires": "account", "accounts": "account", "merchants": "merchant"}
# exact features of each view (LAST JOINs, COUNTs, comparisons); the rest
# are sums, means and ratios over them
EXACT = {
    "multi_table_view": ("credit_limit", "acct_risk", "merchant_reports",
                         "outflow_cnt_1h", "big_vs_limit"),
    "sharded_view": ("credit_limit", "merchant_ticket", "outflow_cnt_1h"),
}


def _tables(seed=0, n=600):
    return multitable_stream(np.random.default_rng(seed), n,
                             num_accounts=ACCOUNTS, num_merchants=MERCHANTS,
                             t_max=T_MAX)


def _bykey(cols, kc):
    o = np.lexsort((cols["ts"], cols[kc]))
    return {c: np.asarray(v)[o] for c, v in cols.items()}


def _stores(view_name, num_shards, **kw):
    """(JAX store, port store) of the named repo view; ``num_shards=None``
    is the single-device store."""
    kw = {**KW, **kw}
    jview, tview = getattr(jsc, view_name)(), getattr(tsc, view_name)()
    if num_shards is None:
        return (JaxStore(jview, num_keys=ACCOUNTS, **kw),
                OnlineFeatureStore(tview, num_keys=ACCOUNTS, device="cpu",
                                   **kw))
    return (JaxSharded(jview, num_keys=ACCOUNTS, num_shards=num_shards, **kw),
            ShardedOnlineStore(tview, num_keys=ACCOUNTS, num_shards=num_shards,
                               device="cpu", **kw))


def _ingest_all(stores, tables, tx_rows=None):
    for t in ("accounts", "merchants", "wires"):
        rows = _bykey(tables[t], SEC_KEY[t])
        for s in stores:
            s.ingest_table(t, dict(rows))
    tx = tables["transactions"]
    if tx_rows is not None:
        tx = {c: v[tx_rows] for c, v in tx.items()}
    rows = _bykey(tx, "account")
    for s in stores:
        s.ingest(dict(rows))


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        a = a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jax_arrays(state):
    out = {}
    for name, t in zip(("ring_ts", "ring_vals", "cursor"),
                       (state.ring.ts, state.ring.vals, state.ring.cursor)):
        out[name] = np.asarray(t)
    for name, t in zip(("bstats", "bbitmap", "bbucket"),
                       (state.bagg.stats, state.bagg.bitmap, state.bagg.bucket)):
        out[name] = np.asarray(t)
    for i, r in enumerate(state.sec):
        for f in ("ts", "vals", "cursor"):
            out[f"sec{i}_{f}"] = np.asarray(getattr(r, f))
    return out


def assert_state_equal(jax_store, store, where=""):
    want = _jax_arrays(jax_store.state)
    got = online_state_to_numpy(store.state)
    assert sorted(want) == sorted(got)
    for name in want:
        a, b = want[name], got[name]
        assert a.shape == b.shape, (where, name, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{where} {name}")


def assert_answers(want, got, exact, where="", all_exact=False):
    assert sorted(want) == sorted(got)
    for f in want:
        a = np.asarray(want[f])
        g = got[f].numpy() if isinstance(got[f], torch.Tensor) else got[f]
        assert g.shape == a.shape, (where, f)
        if all_exact or f in exact:
            np.testing.assert_array_equal(_bits(a), _bits(g),
                                          err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(g, a, rtol=1e-5, err_msg=f"{where} {f}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multitable_stream_matches_jax(seed):
    kw = dict(num_accounts=64, num_merchants=16, t_max=5_000)
    got = multitable_stream(np.random.default_rng(seed), 700 + seed, **kw)
    want = jax_multitable_stream(np.random.default_rng(seed), 700 + seed, **kw)
    assert sorted(got) == sorted(want)
    for t in want:
        assert list(got[t]) == list(want[t])
        for c in want[t]:
            assert got[t][c].dtype == want[t][c].dtype
            assert got[t][c].tobytes() == want[t][c].tobytes(), (t, c)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [None, 4])
def test_secondary_state_matches_jax(num_shards):
    """``ingest_table`` of each secondary and ``ingest`` of the primary
    leave every ring array bit-exact against JAX's; at S = 4 the join
    rings are one copy, every JAX replica equal to it."""
    jax_store, store = _stores("multi_table_view", num_shards)
    _ingest_all((jax_store, store), _tables())
    assert_state_equal(jax_store, store, f"S={num_shards}")
    if num_shards:
        for i, p in enumerate(store.layout.tables):
            ts = store.state.sec[i].ts
            assert ts.shape[0] == num_shards
            assert (ts.stride(0) == 0) == (not p.partitioned), p.table


def _dual_use_views():
    out = []
    for ex, View in ((jex, JaxView), (tex, FeatureView)):
        db_mod = jst if ex is jex else tst
        db = db_mod.Database(
            name="d",
            primary=db_mod.TableSchema("tx", key="k", ts="ts", numeric=("a",)),
            secondary=(db_mod.TableSchema("w", key="k", ts="ts",
                                          numeric=("a",)),),
        )
        out.append(View(
            "dual",
            features={
                "u": ex.w_sum(ex.Col("a"), ex.range_window(100),
                              union=("w",)),
                "j": ex.last_join(ex.Col("a"), "w", on="k"),
            },
            database=db,
        ))
    return out


def test_dual_use_table_split_matches_jax():
    """A table that is both a union stream and a join target is split on
    the sharded plane: a partitioned union ring plus a replicated join
    slice, both written by one ``ingest_table``; state bit-exact against
    JAX's and answers bit-equal to the single-device store's."""
    jview, tview = _dual_use_views()
    S = 4
    jax_store = JaxSharded(jview, num_keys=8, num_shards=S, capacity=64)
    store = ShardedOnlineStore(tview, num_keys=8, num_shards=S, capacity=64,
                               device="cpu")
    single = OnlineFeatureStore(tview, num_keys=8, capacity=64, device="cpu")
    iu, ij = store.layout.union_ring("w"), store.layout.join_ring("w")
    assert store.layout.rings_of("w") == [iu, ij]
    assert tuple(store.state.sec[iu].ts.shape[:2]) == (S, 8 // S)
    assert tuple(store.state.sec[ij].ts.shape[:2]) == (S, 8)
    assert store.state.sec[ij].ts.stride(0) == 0   # one copy
    rng = np.random.default_rng(8)
    n = 48
    rows = dict(
        k=np.repeat(np.arange(8, dtype=np.int32), n // 8),
        ts=np.tile(np.arange(n // 8, dtype=np.int32), 8),
        a=rng.gamma(2.0, 5.0, n).astype(np.float32),
    )
    prim = dict(k=np.arange(8, dtype=np.int32), ts=np.full(8, 50, np.int32),
                a=np.ones(8, np.float32))
    for s in (jax_store, store, single):
        s.ingest_table("w", dict(rows))
        s.ingest(dict(prim))
    assert_state_equal(jax_store, store, "dual")
    # the union part holds each row once, the join slice every row
    assert int(store.state.sec[iu].cursor.sum()) == n
    assert int(store.state.sec[ij].cursor[0].sum()) == n
    req = dict(k=np.arange(8, dtype=np.int32), ts=np.full(8, 100, np.int32),
               a=np.ones(8, np.float32))
    for mode in ("naive", "preagg"):
        a = single.query(dict(req), mode=mode)
        b = store.query(dict(req), mode=mode)
        j = jax_store.query(dict(req), mode=mode)
        for f in tview.features:
            np.testing.assert_array_equal(_bits(a[f]), _bits(b[f]))
            np.testing.assert_array_equal(_bits(j[f]), _bits(b[f]))


@pytest.mark.parametrize("num_shards", [None, 4])
def test_table_capacity_and_ttl_match_jax(num_shards):
    """A short ``table_capacity`` (the union ring wraps) and a
    ``table_ttl`` on the union table (its rows expire before the
    primary's): state bit-exact, answers at the stated tolerances."""
    kw = dict(table_capacity={"wires": 4}, table_ttl={"wires": 900})
    jax_store, store = _stores("sharded_view", num_shards, **kw)
    tables = _tables(seed=3, n=800)
    early = tables["transactions"]["ts"] < 15_000
    _ingest_all((jax_store, store), tables, early)
    assert_state_equal(jax_store, store, f"S={num_shards}")
    req = {c: v[~early][:64] for c, v in tables["transactions"].items()}
    for mode in ("naive", "preagg"):
        assert_answers(jax_store.query(dict(req), mode=mode),
                       store.query(dict(req), mode=mode),
                       EXACT["sharded_view"], f"{mode}",
                       all_exact=mode == "naive")


# ---------------------------------------------------------------------------
# answers, replayed round by round
# ---------------------------------------------------------------------------


def _replay(store, tables):
    """Answers of both modes for every replay round: before each round
    the secondary rows up to its last ts, after it the round's rows."""
    tx = tables["transactions"]
    events = {t: _bykey(tables[t], "ts") for t in SEC_KEY}
    pos = {t: 0 for t in SEC_KEY}
    out = []
    for idx in replay_rounds(tx["account"], tx["ts"]):
        tmax = int(tx["ts"][idx].max())
        for t, ev in events.items():
            hi = int(np.searchsorted(ev["ts"], tmax, side="right"))
            if hi > pos[t]:
                store.ingest_table(t, _bykey(
                    {c: v[pos[t]:hi] for c, v in ev.items()}, SEC_KEY[t]))
                pos[t] = hi
        batch = {c: v[idx] for c, v in tx.items()}
        out.append({m: store.query(dict(batch), mode=m)
                    for m in ("naive", "preagg")})
        store.ingest(_bykey(batch, "account"))
    return out


@functools.lru_cache(maxsize=None)
def _jax_replay(view_name, num_shards):
    jax_store, _ = _stores(view_name, num_shards)
    answers = _replay(jax_store, _tables(seed=5, n=REPLAY_ROWS))
    return [{m: {f: np.asarray(v) for f, v in r[m].items()} for m in r}
            for r in answers], _jax_arrays(jax_store.state)


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("num_shards", [None, 1, 4])
@pytest.mark.parametrize("view_name", ["multi_table_view", "sharded_view"])
def test_multitable_answers_match_jax(view_name, num_shards, mode):
    want, want_state = _jax_replay(view_name, num_shards)
    _, store = _stores(view_name, num_shards)
    got = _replay(store, _tables(seed=5, n=REPLAY_ROWS))
    assert len(got) == len(want) > 3
    for r, (w, g) in enumerate(zip(want, got)):
        assert_answers(w[mode], g[mode], EXACT[view_name],
                       f"{view_name} S={num_shards} {mode} round {r}",
                       all_exact=mode == "naive")
    got_state = online_state_to_numpy(store.state)
    for name, a in want_state.items():
        np.testing.assert_array_equal(_bits(a), _bits(got_state[name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# LAST JOIN edges
# ---------------------------------------------------------------------------


def _risk_views(default=-7.0):
    return [View("d", features={"risk": ex.last_join(
                ex.Col("fraud_reports"), "merchants", on="merchant",
                default=default)}, database=db)
            for ex, View, db in ((jex, JaxView, jsc.MULTITABLE_DB),
                                 (tex, FeatureView, MULTITABLE_DB))]


def _join_stores(num_shards):
    jview, tview = _risk_views()
    kw = dict(num_keys=8, secondary_num_keys={"merchants": MERCHANTS},
              capacity=16)
    if num_shards is None:
        return (JaxStore(jview, **kw),
                OnlineFeatureStore(tview, device="cpu", **kw))
    return (JaxSharded(jview, num_shards=num_shards, **kw),
            ShardedOnlineStore(tview, num_shards=num_shards, device="cpu",
                               **kw))


def _join_req(merchant, ts=100):
    n = len(merchant)
    return dict(account=np.zeros(n, np.int32), ts=np.full(n, ts, np.int32),
                amount=np.ones(n, np.float32), merchant=merchant.astype(np.int32))


def _merchant_rows(merchant, ts, reports):
    return dict(merchant=np.asarray(merchant, np.int32),
                ts=np.asarray(ts, np.int32),
                avg_ticket=np.zeros(len(merchant), np.float32),
                fraud_reports=np.asarray(reports, np.float32))


def test_last_join_default_when_no_match():
    """No row of the join key gives the default; a row newer than the
    request stays invisible (point in time)."""
    jax_store, store = _join_stores(None)
    req = _join_req(np.arange(3))
    steps = [None, _merchant_rows([1], [50], [0.25]),
             _merchant_rows([2], [500], [0.9])]
    for rows in steps:
        if rows is not None:
            jax_store.ingest_table("merchants", dict(rows))
            store.ingest_table("merchants", dict(rows))
        got = store.query(dict(req))["risk"].numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_store.query(dict(req))["risk"]))
    np.testing.assert_array_equal(got, np.float32([-7.0, 0.25, -7.0]))


@pytest.mark.parametrize("num_shards", [None, 4])
def test_last_join_ts_tie_takes_latest_ingested(num_shards):
    """Rows of one key with equal ts: the latest-ingested wins, within
    one batch and across batches."""
    jax_store, store = _join_stores(num_shards)
    for rows in (_merchant_rows([3, 3, 3, 5], [40, 40, 10, 40], [1, 2, 3, 4]),
                 _merchant_rows([5], [40], [6.0])):
        for s in (jax_store, store):
            s.ingest_table("merchants", dict(rows))
    req = _join_req(np.array([3, 5, 4]))
    got = store.query(dict(req))["risk"].numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_store.query(dict(req))["risk"]))
    # merchant 3: its rows sort (3, 10), (3, 40), (3, 40): the last 40 is 2
    np.testing.assert_array_equal(got, np.float32([2.0, 6.0, -7.0]))


def test_gather_index_matches_jax():
    idx = np.array([7, -1, -9, 0, 4, 5, -5, -6, 2**31 - 1, -2**31], np.int32)
    want = np.asarray(jnp.arange(5)[jnp.asarray(idx)])
    got = tst.gather_index(torch.as_tensor(idx), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_shards", [None, 4])
def test_last_join_out_of_range_keys_match_jax(num_shards):
    """Join keys are not range-checked: past the table, negative and far
    negative keys answer as the reference's gather does (wrap once, then
    clamp)."""
    jax_store, store = _join_stores(num_shards)
    rows = _merchant_rows(np.arange(MERCHANTS), np.full(MERCHANTS, 10),
                          np.arange(MERCHANTS) + 0.5)
    for s in (jax_store, store):
        s.ingest_table("merchants", dict(rows))
    req = _join_req(np.array([MERCHANTS + 3, -1, -MERCHANTS - 5, MERCHANTS - 1,
                              -3, 2**31 - 1, -2**31]))
    got = store.query(dict(req))["risk"].numpy()
    want = np.asarray(jax_store.query(dict(req))["risk"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.float32([15.5, 15.5, 0.5, 15.5, 13.5, 15.5, 0.5]))


@pytest.mark.parametrize("path", ["single", "device", "host"])
def test_missing_join_column_raises(path):
    _, tview = _risk_views()
    kw = dict(num_keys=8, secondary_num_keys={"merchants": MERCHANTS})
    store = (OnlineFeatureStore(tview, device="cpu", **kw) if path == "single"
             else ShardedOnlineStore(tview, num_shards=2, device="cpu",
                                     device_routing=path == "device", **kw))
    req = _join_req(np.arange(3))
    del req["merchant"]
    with pytest.raises(KeyError, match="join-key column 'merchant'"):
        store.query(req)


# ---------------------------------------------------------------------------
# union pre-aggregation and verify_view
# ---------------------------------------------------------------------------


def _union_views(size):
    out = []
    for ex, View, db in ((jex, JaxView, jsc.MULTITABLE_DB),
                         (tex, FeatureView, MULTITABLE_DB)):
        amt, w = ex.Col("amount"), ex.range_window(size, bucket=64)
        features = {
            "s": ex.w_sum(amt, w, union=("wires",)),
            "m": ex.w_mean(amt, w, union=("wires",)),
            "sd": ex.w_std(amt, w, union=("wires",)),
            "c": ex.w_count(amt, w, union=("wires",)),
        }
        if size == 300:
            features["p"] = ex.w_max(amt, w)
        out.append(View("upa", features=features, database=db))
    return out


@pytest.mark.parametrize("size", [300, 64 * 64 * 2])
def test_union_preagg_counters_match_jax(size):
    """Which union aggregations compose their primary stream from the
    buckets, and the hit / fallback counters of each query mode, equal
    JAX's; a union window too long for the buckets falls back instead of
    raising (a non-union one that long would raise)."""
    jview, tview = _union_views(size)
    kw = dict(num_keys=8, num_buckets=64, bucket_size=64)
    jax_store = JaxStore(jview, **kw)
    store = OnlineFeatureStore(tview, device="cpu", **kw)
    assert store._union_preagg == jax_store._union_preagg
    assert any(store._union_preagg.values()) == (size == 300)
    req = dict(account=np.arange(4, dtype=np.int32),
               ts=np.full(4, 5_000, np.int32), amount=np.ones(4, np.float32),
               merchant=np.zeros(4, np.int32))
    for mode in ("naive", "preagg"):
        jtel, ttel = JaxTelemetry(), Telemetry()
        with jax_use_telemetry(jtel):
            jax_store.query(dict(req), mode=mode)
        with use_telemetry(ttel):
            store.query(dict(req), mode=mode)
        for name in ("preagg_hits_total", "preagg_fallback_total"):
            for agg in ("sum", "mean", "std", "count", "max"):
                kw_c = dict(labels=("agg",))
                a = jtel.metrics.counter(name, **kw_c).value(agg=agg)
                b = ttel.metrics.counter(name, **kw_c).value(agg=agg)
                assert a == b, (mode, name, agg, a, b)


@pytest.mark.parametrize("routing", ["single", "device", "host"])
@pytest.mark.parametrize("mode", ["naive", "preagg"])
def test_verify_view_multi_table(mode, routing):
    """``verify_view`` passes on the repo's multi-table view, with the
    secondary tables ingested by timestamp between rounds: single-device
    and S = 4, device- and host-routed."""
    tables = _tables(seed=9, n=800)
    tx = tables.pop("transactions")
    shards = None if routing == "single" else 4
    rep = verify_view(
        tsc.multi_table_view(), tx, num_keys=ACCOUNTS, secondary=tables,
        secondary_num_keys={"merchants": MERCHANTS}, capacity=64,
        num_buckets=64, bucket_size=64, mode=mode, num_shards=shards,
        device_routing=routing != "host", device="cpu",
    )
    assert rep.passed, rep.summary()
    want = mode if shards is None else f"{mode}/shards=4"
    assert rep.mode == want + ("/host" if routing == "host" else "")


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [None, 4])
def test_convert_carries_secondary_rings(num_shards):
    """A JAX store's state, secondary rings included, seeds a port store
    that then answers and ingests like the JAX store; it reads back
    unchanged."""
    jax_store, store = _stores("sharded_view", num_shards)
    tables = _tables(seed=6)
    early = tables["transactions"]["ts"] < 15_000
    _ingest_all((jax_store,), tables, early)
    arrays = _jax_arrays(jax_store.state)
    store.state = online_state_from_numpy(arrays, "cpu", bucket_size=64,
                                          layout=store.layout)
    assert_state_equal(jax_store, store, "seeded")
    rows = {c: v[~early][:40] for c, v in tables["transactions"].items()}
    assert_answers(jax_store.query(dict(rows)), store.query(dict(rows)),
                   EXACT["sharded_view"], "seeded")
    wires = _bykey({c: v[:50] for c, v in tables["wires"].items()}, "account")
    for s in (jax_store, store):
        s.ingest_table("wires", dict(wires))
        s.ingest(_bykey(rows, "account"))
    assert_state_equal(jax_store, store, "seeded+ingest")


def test_convert_refuses_unequal_replicas_and_missing_layout():
    jax_store, store = _stores("sharded_view", 4)
    _ingest_all((jax_store,), _tables(seed=7))
    arrays = _jax_arrays(jax_store.state)
    with pytest.raises(ValueError, match="layout"):
        online_state_from_numpy(arrays, "cpu", bucket_size=64)
    ij = store.layout.join_ring("accounts")
    bad = dict(arrays)
    bad[f"sec{ij}_vals"] = arrays[f"sec{ij}_vals"].copy()
    bad[f"sec{ij}_vals"][2, 5, 0, 0] += 1.0
    with pytest.raises(ValueError, match="replica 2 differs"):
        online_state_from_numpy(bad, "cpu", bucket_size=64,
                                layout=store.layout)

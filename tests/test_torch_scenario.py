"""The port's multi-scenario plane against the JAX package.

``ScenarioPlane`` (N views, one store), its per-scenario
``QueryProgram`` s, the mixed-batch ``route_and_query``,
``FeatureService.build_multi`` / ``MultiScenarioService`` and the
scenario-aware ``ShardRouter``: the same numpy-made tables
(``multitable_stream``, byte-identical in both packages) go through both
packages, the port on ``device="cpu"``, the JAX side as its own tests run
it on the CPU.  Tolerances against JAX, as in
``tests/test_torch_multitable.py`` and ``tests/test_torch_shard.py``:

* bit for bit: every state array, the accounting (row counts and gauge
  values), LAST JOINs, COUNTs, MAX, comparisons, and every SUM / MEAN
  (and ratio over them) in naive mode;
* SUM and MEAN (and ratios over them) in preagg mode: ``rtol=1e-5`` —
  the bucket states fold in a framework-chosen order;
* DISTINCT_APPROX: ``rtol=1e-6``, PyTorch's and XLA's ``log1p`` differ
  by up to one ulp;
* STD: ``verify_view``'s tolerance (``rtol=2e-4``, ``atol=1e-3 * max(1,
  p99 |STD|)``) plus XLA's FMA residue ``2**-12 * |mean|``, with |mean|
  bounded by the largest |amount| of the stream.

Within the port everything is bit for bit: the plane against N dedicated
stores, the mixed batch against each scenario's own program, the
device-routed mixed router against the host-routed oracle.
"""

import functools

import numpy as np
import pytest
import torch

import repro.scenarios as jsc
import repro_torch.scenarios as tsc
from repro.core import ScenarioPlane as JaxPlane
from repro.core.consistency import replay_rounds
from repro.obs import Telemetry as JaxTelemetry
from repro.obs import use_telemetry as jax_use_telemetry
from repro.serve.router import ShardRouter as JaxRouter
from repro.serve.service import BatchScheduler as JaxScheduler
from repro.serve.service import FeatureService as JaxService
from repro_torch.convert import online_state_to_numpy
from repro_torch.core import expr as tex
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.scenario import ScenarioPlane, merge_views
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import (
    FRAUD_SCHEMA,
    MULTITABLE_DB,
    RECO_SCHEMA,
    multitable_stream,
)
from repro_torch.obs import Telemetry, use_telemetry
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import (
    SCENARIO_COL,
    BatchScheduler,
    FeatureService,
)

ACCOUNTS, MERCHANTS = 32, 8
T_MAX = 40_000
# 512 buckets of 64 s: the 6 h windows of the views need 340
KW = dict(num_keys=ACCOUNTS, capacity=64, num_buckets=512, bucket_size=64,
          secondary_num_keys={"merchants": MERCHANTS})
SEC_KEY = {"wires": "account", "accounts": "account", "merchants": "merchant"}

# multi_scenario_views()' features by tolerance against JAX (module doc)
EXACT = ("credit_limit", "outflow_cnt_1h", "overdraft_now",
         "merchant_ticket", "tx_count_10", "acct_risk_score",
         "merchant_reports", "spend_max_6h")
SUMS = ("outflow_1h", "utilization_1h", "outflow_mean_6h")
DISTINCT = ("merchants_seen_6h",)
STD = ("spend_std_6h",)


def _tables(seed, n=160):
    return multitable_stream(np.random.default_rng(seed), n,
                             num_accounts=ACCOUNTS, num_merchants=MERCHANTS,
                             t_max=T_MAX)


def _bykey(cols, kc):
    o = np.lexsort((cols["ts"], cols[kc]))
    return {c: np.asarray(v)[o] for c, v in cols.items()}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        a = a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_bit_equal(a, b, where=""):
    assert sorted(a) == sorted(b), where
    for f in a:
        np.testing.assert_array_equal(_bits(_np(a[f])), _bits(_np(b[f])),
                                      err_msg=f"{where} {f}")


def assert_close_to_jax(want, got, mode, amax, where=""):
    assert sorted(want) == sorted(got), where
    for f in want:
        a, g = np.asarray(want[f]), _np(got[f])
        assert a.shape == g.shape, (where, f)
        if f in EXACT or (f in SUMS and mode == "naive"):
            np.testing.assert_array_equal(_bits(a), _bits(g),
                                          err_msg=f"{where} {f}")
        elif f in SUMS:
            np.testing.assert_allclose(g, a, rtol=1e-5, err_msg=f"{where} {f}")
        elif f in DISTINCT:
            np.testing.assert_allclose(g, a, rtol=1e-6, err_msg=f"{where} {f}")
        else:
            assert f in STD, f
            scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
            atol = 1e-3 * max(1.0, scale) + 2.0 ** -12 * amax
            assert np.all(np.abs(g - a) <= atol + 2e-4 * np.abs(a)), (where, f)


def _planes(num_shards, **kw):
    """(JAX plane, port plane) of ``multi_scenario_views()``."""
    kw = {**KW, **kw}
    return (JaxPlane(jsc.multi_scenario_views(), num_shards=num_shards, **kw),
            ScenarioPlane(tsc.multi_scenario_views(), num_shards=num_shards,
                          device="cpu", **kw))


def _replay(plane, tables, mixed=None):
    """Every scenario's answers in both modes, round by round: before each
    round the secondary rows up to its last ts, after it the round's rows
    (once, for every scenario).  ``mixed`` (a list) also collects the
    round's rows answered as one mixed batch, tagged cyclically."""
    tx = tables["transactions"]
    events = {t: _bykey(tables[t], "ts") for t in SEC_KEY}
    pos = {t: 0 for t in SEC_KEY}
    names = plane.scenarios
    out = []
    for idx in replay_rounds(tx["account"], tx["ts"]):
        tmax = int(tx["ts"][idx].max())
        for t, ev in events.items():
            hi = int(np.searchsorted(ev["ts"], tmax, side="right"))
            if hi > pos[t]:
                plane.ingest_table(t, _bykey(
                    {c: v[pos[t]:hi] for c, v in ev.items()}, SEC_KEY[t]))
                pos[t] = hi
        batch = {c: v[idx] for c, v in tx.items()}
        out.append({(s, m): {f: _np(v) for f, v in
                             plane.query(s, dict(batch), mode=m).items()}
                    for s in names for m in ("naive", "preagg")})
        if mixed is not None:
            tags = np.array([names[i % len(names)] for i in range(len(idx))])
            mixed.append((batch, tags, {
                m: plane.query_mixed(dict(batch), tags, mode=m)
                for m in ("naive", "preagg")}))
        plane.ingest(_bykey(batch, "account"))
    return out


def _jax_state(state):
    out = {"ring_ts": state.ring.ts, "ring_vals": state.ring.vals,
           "cursor": state.ring.cursor, "bstats": state.bagg.stats,
           "bbitmap": state.bagg.bitmap, "bbucket": state.bagg.bucket}
    for i, r in enumerate(state.sec):
        for f in ("ts", "vals", "cursor"):
            out[f"sec{i}_{f}"] = getattr(r, f)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_replay(num_shards):
    jax_plane, _ = _planes(num_shards)
    answers = _replay(jax_plane, _tables(seed=5))
    return answers, _jax_state(jax_plane.store.state)


# ---------------------------------------------------------------------------
# the plane against JAX's, and against dedicated stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("num_shards", [None, 4])
def test_plane_matches_jax(num_shards, mode):
    """Every scenario's answers of the port's plane equal the JAX plane's
    on the same replay (secondary rows interleaved by time, the rounds'
    rows ingested once for every scenario), at the stated tolerances;
    every state array bit for bit (a replicated ring's one copy equals
    every JAX replica)."""
    want, want_state = _jax_replay(num_shards)
    _, plane = _planes(num_shards)
    tables = _tables(seed=5)
    got = _replay(plane, tables)
    amax = float(np.abs(tables["transactions"]["amount"]).max())
    assert len(got) == len(want) > 3
    for r, (w, g) in enumerate(zip(want, got)):
        for s in plane.scenarios:
            assert_close_to_jax(w[(s, mode)], g[(s, mode)], mode, amax,
                                f"S={num_shards} {s} {mode} round {r}")
    got_state = online_state_to_numpy(plane.store.state)
    assert sorted(got_state) == sorted(want_state)
    for name, a in want_state.items():
        np.testing.assert_array_equal(_bits(a), _bits(got_state[name]),
                                      err_msg=name)


@pytest.mark.parametrize("num_shards", [None, 4])
def test_plane_equals_dedicated_stores(num_shards):
    """The plane == N dedicated single-view stores fed the same stream,
    bit for bit, in both modes, round by round; on the sharded plane each
    round's rows also go in as ONE mixed batch, and every scenario's share
    equals its dedicated store's answers for those rows."""
    views = tsc.multi_scenario_views()
    plane = ScenarioPlane(views, num_shards=num_shards, device="cpu", **KW)
    tables = _tables(seed=6)
    mixed = [] if num_shards else None
    got = _replay(plane, tables, mixed)
    for v in views:
        store = OnlineFeatureStore(v, device="cpu", **KW)
        want = _replay(_Single(store, v.name), tables)
        for r, (w, g) in enumerate(zip(want, got)):
            for m in ("naive", "preagg"):
                assert_bit_equal(w[(v.name, m)], g[(v.name, m)],
                                 f"S={num_shards} {v.name} {m} round {r}")
        for r, (batch, tags, out) in enumerate(mixed or ()):
            sel = tags == v.name
            for m in ("naive", "preagg"):
                if not sel.any():
                    assert v.name not in out[m]
                    continue
                assert_bit_equal(
                    {f: a[sel] for f, a in want[r][(v.name, m)].items()},
                    out[m][v.name], f"mixed {v.name} {m} round {r}")
    # the plane's one stream: each table's rows counted once a copy (the
    # replay ingests secondary rows up to the last transaction's ts)
    last = tables["transactions"]["ts"].max()
    rows = {t: int((c["ts"] <= last).sum()) for t, c in tables.items()}
    S = num_shards or 1
    assert plane.ingest_row_counts() == {
        "transactions": rows["transactions"], "wires": rows["wires"],
        "accounts": S * rows["accounts"], "merchants": S * rows["merchants"]}


class _Single:
    """A dedicated store behind the plane's replay interface."""

    def __init__(self, store, name):
        self.store, self.scenarios = store, [name]

    def ingest(self, cols):
        self.store.ingest(cols)

    def ingest_table(self, table, cols):
        if table in self.store._sec_names:
            self.store.ingest_table(table, cols)

    def query(self, scenario, cols, mode):
        return self.store.query(cols, mode=mode)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


GAUGES = ("ring_occupancy_ratio", "ring_evicted_rows_total")


@pytest.mark.parametrize("num_shards", [None, 4])
def test_accounting_matches_jax(num_shards):
    """``ingest_row_counts``, ``ring_row_counts`` and ``record_gauges``
    give JAX's numbers: a replicated join ring counts ``num_shards`` x
    (the reference's replicas; the port stores one copy), a wrapping
    wires ring shows its evictions and its TTL its expired rows."""
    kw = dict(table_capacity={"wires": 4}, table_ttl={"wires": 900})
    jax_plane, plane = _planes(num_shards, **kw)
    tables = _tables(seed=7, n=400)
    for p in (jax_plane, plane):
        for t in ("accounts", "merchants", "wires"):
            p.ingest_table(t, _bykey(tables[t], SEC_KEY[t]))
        p.ingest(_bykey(tables["transactions"], "account"))
    counts = plane.ingest_row_counts()
    assert counts == jax_plane.ingest_row_counts()
    S = num_shards or 1
    assert counts["accounts"] == S * len(tables["accounts"]["ts"])
    assert counts["wires"] == len(tables["wires"]["ts"])
    want, got = jax_plane.store.ring_row_counts(), plane.store.ring_row_counts()
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)
    jtel, ttel = JaxTelemetry(), Telemetry()
    with jax_use_telemetry(jtel):
        jax_plane.store.record_gauges()
    with use_telemetry(ttel):
        plane.store.record_gauges()
    lab = dict(labels=("table", "placement"))
    for table, placement in want:
        for name in GAUGES:
            a = jtel.metrics.gauge(name, **lab).value(table=table,
                                                      placement=placement)
            b = ttel.metrics.gauge(name, **lab).value(table=table,
                                                      placement=placement)
            assert a == b, (name, table, placement, a, b)
    ttl = dict(labels=("table",))
    a = jtel.metrics.gauge("ring_ttl_expired_rows", **ttl).value(table="wires")
    b = ttel.metrics.gauge("ring_ttl_expired_rows", **ttl).value(table="wires")
    assert a == b > 0
    assert ttel.metrics.gauge("ring_evicted_rows_total", **lab).value(
        table="wires", placement=placement_of(plane, "wires")) > 0


def placement_of(plane, table):
    p = plane.layout.tables[plane.layout.rings_of(table)[0]]
    return "partitioned" if p.partitioned else "replicated"


# ---------------------------------------------------------------------------
# the mixed-batch path and the scenario-aware router
# ---------------------------------------------------------------------------


def _mixed_batch(rng, n, t, accounts=ACCOUNTS):
    return dict(
        account=rng.integers(0, accounts, n).astype(np.int32),
        ts=np.full(n, t, np.int32),
        amount=rng.gamma(2.0, 10.0, n).astype(np.float32),
        merchant=rng.integers(0, MERCHANTS, n).astype(np.int32),
    )


@pytest.mark.parametrize("hash_routing", [True, False])
def test_route_and_query_counts_and_answers(hash_routing):
    """``route_and_query`` (valid-masked padding, a tag repeated by the
    pad rows) gives per-(scenario, shard) counts equal to the host
    oracle's per-group counts, and ``query_mixed`` the host-routed
    per-scenario answers bit for bit, in both modes."""
    views = tsc.multi_scenario_views()
    kw = dict(KW, hash_routing=hash_routing)
    dev = ScenarioPlane(views, num_shards=4, device="cpu", **kw)
    host = ScenarioPlane(views, num_shards=4, device="cpu",
                         device_routing=False, **kw)
    tables = _tables(seed=8)
    for p in (dev, host):
        for t in ("accounts", "merchants", "wires", "transactions"):
            p.ingest_table(t, _bykey(tables[t], SEC_KEY.get(t, "account")))
    rng = np.random.default_rng(3)
    n = 37
    batch = _mixed_batch(rng, n, T_MAX + 10)
    names = dev.scenarios
    tags = np.array([names[i] for i in rng.integers(0, 3, n)])
    valid = np.ones(n, bool)
    valid[-5:] = False
    for mode in ("naive", "preagg"):
        ri = {}
        got = dev.query_mixed(dict(batch), tags, mode=mode, valid=valid,
                              route_info=ri)
        assert ri["scenario_names"] == names
        assert ri["scenario_shard_counts"].shape == (3, 4)
        assert ri["scenario_shard_counts"].sum() == valid.sum()
        np.testing.assert_array_equal(ri["shard_counts"],
                                      ri["scenario_shard_counts"].sum(0))
        for i, s in enumerate(names):
            sel = valid & (tags == s)
            ri_h = {}
            want = host.query(s, {c: v[sel] for c, v in batch.items()},
                              mode=mode, route_info=ri_h)
            assert_bit_equal(want, got[s], f"{s} {mode}")
            np.testing.assert_array_equal(ri["scenario_shard_counts"][i],
                                          ri_h["shard_counts"])


def _multi_views(tex_mod=tex, View=FeatureView, schema=FRAUD_SCHEMA):
    amt = tex_mod.Col("amount")
    w1 = tex_mod.range_window(600, bucket=64)
    return [
        View("mx_fraud", schema, {"s": tex_mod.w_sum(amt, w1),
                                  "c5": tex_mod.w_count(
                                      amt, tex_mod.rows_window(5))}),
        View("mx_risk", schema, {"m": tex_mod.w_mean(amt, w1)}),
        View("mx_velocity", schema, {"c8": tex_mod.w_count(
            amt, tex_mod.rows_window(8))}),
    ]


def _jax_multi_views():
    from repro.core import FeatureView as JaxView
    from repro.core import expr as jex
    from repro.data.synthetic import FRAUD_SCHEMA as JAX_FRAUD

    return _multi_views(jex, JaxView, JAX_FRAUD)


def _rows(rng, n, t0=100_000):
    return [
        dict(card=int(rng.integers(0, 32)), ts=int(t0 + i),
             amount=float(rng.gamma(1.5, 60.0)),
             mcc=int(rng.integers(0, 32)), device=int(rng.integers(0, 8)),
             geo=int(rng.integers(0, 16)))
        for i in range(n)
    ]


def _span_counts(roots):
    counts = {}

    def walk(s):
        counts[s.name] = counts.get(s.name, 0) + 1
        for c in s.children:
            walk(c)

    for s in roots:
        walk(s)
    return counts


def _drive_mixed(package, device_routing, n_req=26, pumps_of=9):
    """A 3-scenario sharded service of ``package`` ("port" / "jax"); an
    interleaved stream through its router in pumps of ``pumps_of``, ingest
    on.  Returns (per-pump outputs, drained output, router, span counts,
    service)."""
    names = [v.name for v in _multi_views()]
    rows = _rows(np.random.default_rng(91), n_req)
    if package == "port":
        tel, use, views = Telemetry(), use_telemetry, _multi_views()
        Svc, Router, Sched, kw = (FeatureService, ShardRouter, BatchScheduler,
                                  dict(device="cpu"))
    else:
        tel, use, views = JaxTelemetry(), jax_use_telemetry, _jax_multi_views()
        Svc, Router, Sched, kw = JaxService, JaxRouter, JaxScheduler, {}
    with use(tel):
        svc = Svc.build_multi(
            "mx", views, num_keys=32, sharded=True, num_shards=4,
            capacity=64, device_routing=device_routing, **kw)
        router = Router(svc, Sched(buckets=(1, 4, 16), max_batch=pumps_of))
        pump_outs = []
        for i, row in enumerate(rows):
            router.submit(row, scenario=names[i % 3])
            if (i + 1) % pumps_of == 0:
                got = router.pump()
                assert got is not None
                pump_outs.append(got)
        drained = router.drain()
    return pump_outs, drained, router, _span_counts(tel.tracer.roots()), svc


@functools.lru_cache(maxsize=None)
def _jax_mixed():
    pumps, drained, router, _, svc = _drive_mixed("jax", True)
    return (pumps + [drained], router.scenario_shard_histogram(),
            router.shard_histogram(),
            {s: st.requests for s, st in svc.scenario_stats.items()})


def test_mixed_router_device_equals_host_and_jax():
    """Mixed 3-scenario batches through the router: the device-routed
    service answers each pump with ONE ``route.device`` dispatch and one
    ``request`` span, the host oracle one request per scenario group and
    no ``route.device``; pump by pump the two are equal bit for bit, with
    ingest on; the (scenario, shard) histograms and per-scenario request
    counts are equal to each other and to the JAX router's on the same
    stream, and the answers to JAX's at the stated tolerances (sums and
    means ``rtol=1e-5``, counts exact)."""
    pumps_d, drain_d, router_d, spans_d, svc_d = _drive_mixed("port", True)
    pumps_h, drain_h, router_h, spans_h, svc_h = _drive_mixed("port", False)
    n_batches = 3  # 26 requests, pumps of 9 -> 9 + 9 + 8 (drain)
    assert spans_d.get("route.device") == n_batches
    assert spans_d.get("request") == n_batches
    assert "query.compute" not in spans_d
    assert "route.device" not in spans_h
    assert spans_h.get("request") == 3 * n_batches  # one per group
    jax_outs, jax_hist, jax_shard_hist, jax_requests = _jax_mixed()
    outs_d, outs_h = pumps_d + [drain_d], pumps_h + [drain_h]
    assert len(outs_d) == len(outs_h) == len(jax_outs)
    for i, (a, b, j) in enumerate(zip(outs_d, outs_h, jax_outs)):
        assert set(a) == set(b) == set(j)
        for s in a:
            assert_bit_equal(a[s], b[s], f"pump {i} {s}")
            for f in a[s]:
                if f.startswith("c"):
                    np.testing.assert_array_equal(a[s][f], np.asarray(j[s][f]))
                else:
                    np.testing.assert_allclose(a[s][f], np.asarray(j[s][f]),
                                               rtol=1e-5)
    np.testing.assert_array_equal(router_d.shard_histogram(),
                                  router_h.shard_histogram())
    np.testing.assert_array_equal(router_d.shard_histogram(), jax_shard_hist)
    hd, hh = (router_d.scenario_shard_histogram(),
              router_h.scenario_shard_histogram())
    assert set(hd) == set(hh) == set(jax_hist)
    for s in hd:
        np.testing.assert_array_equal(hd[s], hh[s], err_msg=s)
        np.testing.assert_array_equal(hd[s], jax_hist[s], err_msg=s)
        assert hd[s].sum() > 0
    for s in svc_d.scenario_stats:
        assert (svc_d.scenario_stats[s].requests
                == svc_h.scenario_stats[s].requests == jax_requests[s] > 0)
    assert svc_d.stats.batches == n_batches
    assert svc_h.stats.batches == 3 * n_batches


@pytest.mark.parametrize("device_routing", [True, False])
def test_drain_submission_order_across_pumps(device_routing):
    """drain() returns each scenario's rows in submission order when the
    queue empties over several pumps, each row equal to that row served
    alone on the frozen store."""
    views = _multi_views()
    names = [v.name for v in views]
    rng = np.random.default_rng(17)
    rows = _rows(rng, 22)
    with use_telemetry(Telemetry()):
        svc = FeatureService.build_multi(
            "ord", views, num_keys=32, sharded=True, num_shards=4,
            capacity=64, device_routing=device_routing, device="cpu")
        hist = _rows(rng, 60, t0=90_000)
        cols = {k: np.asarray([r[k] for r in hist]) for k in hist[0]}
        svc.store.ingest(_bykey(cols, "card"))
        router = ShardRouter(
            svc, BatchScheduler(buckets=(1, 4), max_batch=4), ingest=False)
        tags = [names[i % 3] for i in range(len(rows))]
        for row, tag in zip(rows, tags):
            router.submit(row, scenario=tag)
        out = router.drain()  # 22 rows, pumps of <= 4 -> >= 6 pumps
        for s in names:
            srows = [r for r, t in zip(rows, tags) if t == s]
            feats = svc.plane.views[s].features
            assert set(out[s]) == set(feats)
            assert len(out[s][list(feats)[0]]) == len(srows)
            for i, r in enumerate(srows):
                one = svc.request({k: np.asarray([v]) for k, v in r.items()},
                                  ingest=False, scenario=s)
                for f in feats:
                    np.testing.assert_array_equal(
                        _bits(out[s][f][i:i + 1]), _bits(one[f]),
                        err_msg=f"{s} row {i} feature {f}")
            fm = svc.feature_matrix(
                {k: np.asarray([v]) for k, v in srows[0].items()}, scenario=s)
            assert fm.shape == (1, len(feats))


def test_multi_service_shared_ingest_and_registry():
    """request(ingest=True) on a multi-scenario service ingests once into
    the shared store, and another scenario's window sees the row; the
    registry records one deploy a scenario."""
    from repro_torch.core.view import FeatureRegistry

    views = tsc.multi_scenario_views()
    reg = FeatureRegistry()
    for v in views:
        reg.register(v)
    svc = FeatureService.build_multi("p", views, registry=reg, device="cpu",
                                     **KW)
    assert sorted(d["service"] for d in reg.deployments()) == sorted(
        f"p:{v.name}" for v in views)
    row = dict(account=np.array([3], np.int32),
               ts=np.array([60_000], np.int32),
               amount=np.array([123.0], np.float32),
               merchant=np.array([1], np.int32))
    before = svc.plane.ingest_row_counts()["transactions"]
    svc.request(dict(row), ingest=True, scenario=views[0].name)
    assert svc.plane.ingest_row_counts()["transactions"] == before + 1
    later = dict(row, ts=np.array([60_001], np.int32))
    out = svc.request(later, ingest=False, scenario="spend_profile")
    assert float(out["outflow_1h"][0]) >= 123.0
    assert svc.scenario_stats["spend_profile"].requests == 1
    assert svc.stats.requests == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_merge_views_validation():
    views = tsc.multi_scenario_views()
    with pytest.raises(ValueError, match="duplicate"):
        merge_views([views[0], views[0]])
    other = FeatureView("other", RECO_SCHEMA, {
        "s": tex.w_sum(tex.Col("price"), tex.range_window(100))})
    with pytest.raises(ValueError, match="primary"):
        merge_views([views[0], other])
    with pytest.raises(ValueError, match="at least one"):
        merge_views([])
    merged = merge_views(views, name="p")
    assert f"{views[0].name}/outflow_1h" in merged.features
    assert set(merged.tables) == {"transactions", "wires", "accounts",
                                  "merchants"}


@pytest.mark.parametrize("num_shards", [None, 4])
def test_scenario_requests_need_only_own_columns(num_shards):
    """A scenario's request carries only its view's columns: acct_risk
    never reads ``merchant``; a scenario that joins on it still demands
    it, and the error names that scenario's view."""
    views = tsc.multi_scenario_views()
    plane = ScenarioPlane(views, num_shards=num_shards, device="cpu", **KW)
    req = dict(account=np.arange(8, dtype=np.int32),
               ts=np.full(8, 100, np.int32), amount=np.ones(8, np.float32))
    out = plane.query("acct_risk", dict(req))
    assert set(out) == set(views[0].features)
    ref = OnlineFeatureStore(views[0], device="cpu", **KW).query(dict(req))
    assert_bit_equal(ref, out, "acct_risk")
    with pytest.raises(KeyError, match="merchant_watch"):
        plane.query("merchant_watch", dict(req))


def test_program_requires_subview():
    views = tsc.multi_scenario_views()
    plane = ScenarioPlane(views[:2], device="cpu", **KW)
    foreign = FeatureView(
        "foreign", MULTITABLE_DB.primary,
        {"c": tex.w_count(tex.Col("amount"), tex.range_window(999))},
        database=MULTITABLE_DB,
    )
    with pytest.raises(ValueError, match="sub-view"):
        plane.store.compile_program(foreign)
    with pytest.raises(KeyError, match="unknown scenario"):
        plane.query("nope", {})


def test_refusals():
    views = tsc.multi_scenario_views()
    names = [v.name for v in views]
    req = _mixed_batch(np.random.default_rng(0), 4, 100)
    single = FeatureService.build("one", views[0], device="cpu", **KW)
    with pytest.raises(ValueError, match="single-scenario"):
        single.request(dict(req), scenario="acct_risk")
    with pytest.raises(ValueError, match="single-scenario"):
        ShardRouter(single).submit(req, scenario="acct_risk")
    with pytest.raises(ValueError, match="num_shards"):
        FeatureService.build_multi("m", views, sharded=True, device="cpu",
                                   **KW)
    host = FeatureService.build_multi("h", views, sharded=True, num_shards=2,
                                      device_routing=False, device="cpu",
                                      **KW)
    with pytest.raises(RuntimeError, match="device_routing=False"):
        host.store.route_and_query(dict(req), np.zeros(4, np.int32), 3)
    svc = FeatureService.build_multi("d", views, sharded=True, num_shards=2,
                                     device="cpu", **KW)
    for bad in ([0, 1, 3, 0], [0, -1, 0, 0]):
        with pytest.raises(ValueError, match="out of range"):
            svc.store.route_and_query(dict(req), np.asarray(bad, np.int32), 3)
    with pytest.raises(KeyError, match="unknown scenario"):
        svc.plane.query_mixed(dict(req), np.array(["nope"] * 4))
    with pytest.raises(ValueError, match=SCENARIO_COL):
        svc.request_mixed(dict(req))
    with pytest.raises(ValueError, match="needs scenario="):
        svc.request(dict(req))
    with pytest.raises(ValueError, match="needs scenario="):
        svc.feature_matrix(dict(req))
    router = ShardRouter(svc)
    with pytest.raises(ValueError, match="scenario"):
        router.submit({c: v[0] for c, v in req.items()})
    with pytest.raises(KeyError, match="unknown scenario"):
        router.submit({c: v[0] for c, v in req.items()}, scenario="nope")
    with pytest.raises(ValueError, match="rebuild"):
        svc.plane.evolve(views, bucket_size=32, num_buckets=1024)
    with pytest.raises(ValueError, match="already deployed"):
        svc.hot_deploy(views[0])
    assert svc.scenarios == names


def test_plane_and_build_multi_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    views = tsc.multi_scenario_views()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ScenarioPlane(views, **KW)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FeatureService.build_multi("m", views, sharded=True, num_shards=2,
                                   **KW)

"""The port's sharded store: the host-routed oracle, modulo routing and the
device == host == single-device contract.

Inside the port (``device="cpu"``) the device-routed path, the host-routed
path (``device_routing=False``) and the single-device store answer a
multi-table view bit for bit, with identical per-shard counts, at
S in {1, 2, 4, 8}, under hash and modulo routing.  Against the JAX
package: ``build_route``, ``shard_row_counts``, the per-shard counts of
strided keys and the sharded state under both routings bit for bit, the
host-routed and device-routed answers at the tolerances of
``assert_close_to_jax`` (the JAX side as its own tests run it on the
CPU).
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.expr as jex
import repro_torch.core.expr as tex
from repro.core.consistency import replay_rounds
from repro.core.shard import build_route as jax_build_route
from repro.serve.router import ShardRouter as JaxRouter
from repro.serve.service import FeatureService as JaxService
from repro_torch.convert import online_state_to_numpy
from repro_torch.core import shard as shard_mod
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.shard import ShardedOnlineStore, build_route
from repro_torch.core import storage as tst
from repro_torch.core.view import FeatureView
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import FeatureService

K, NM = 16, 4


def _db(mod):
    return mod.Database(
        name="mt",
        primary=mod.TableSchema("tx", key="acct", ts="ts",
                                numeric=("amount", "merchant")),
        secondary=(
            mod.TableSchema("wires", key="acct", ts="ts", numeric=("amount",)),
            mod.TableSchema("accounts", key="acct", ts="ts",
                            numeric=("limit",)),
            mod.TableSchema("merchants", key="merchant", ts="ts",
                            numeric=("risk",)),
        ),
    )


DB = _db(tst)


def _view(ex, View, db):
    """The reference's sharded multi-table test view (tests/test_shard.py)."""
    amt = ex.Col("amount")
    w1 = ex.range_window(300, bucket=64)
    credit = ex.last_join(ex.Col("limit"), "accounts", on="acct",
                          default=500.0)
    return View(
        "sharded_mtv",
        features={
            "limit": credit,
            "mrisk": ex.last_join(ex.Col("risk"), "merchants", on="merchant",
                                  default=0.5),
            "out_sum": ex.w_sum(amt, w1, union=("wires",)),
            "out_cnt": ex.w_count(amt, w1, union=("wires",)),
            "out_std": ex.w_std(amt, w1, union=("wires",)),
            "util": ex.w_sum(amt, w1, union=("wires",)) / credit,
            "plain": ex.w_mean(amt, w1),
            "mx": ex.w_max(amt, w1),
            "r5": ex.w_count(amt, ex.rows_window(5)),
            "uniq": ex.w_distinct_approx(ex.Col("merchant"), w1),
        },
        database=db,
    )


def view():
    return _view(tex, FeatureView, DB)


def jax_view():
    return _view(jex, jcore.FeatureView, _db(jcore))


def make_tables(rng, n=160, t_max=2_000):
    ts = np.sort(rng.choice(t_max, size=n, replace=False)).astype(np.int32)
    tx = dict(
        acct=rng.integers(0, K, n).astype(np.int32),
        ts=ts,
        amount=rng.gamma(2.0, 10.0, n).astype(np.float32),
        merchant=rng.integers(0, NM, n).astype(np.int32),
    )
    m = n // 2
    wires = dict(
        acct=rng.integers(0, K, m).astype(np.int32),
        ts=np.sort(rng.integers(0, t_max, m)).astype(np.int32),
        amount=rng.gamma(2.0, 10.0, m).astype(np.float32),
    )
    accounts = dict(
        acct=np.concatenate([np.arange(K), rng.integers(0, K, K)]).astype(
            np.int32),
        ts=np.concatenate([np.zeros(K), rng.integers(1, t_max, K)]).astype(
            np.int32),
        limit=rng.uniform(100.0, 1000.0, 2 * K).astype(np.float32),
    )
    merchants = dict(
        merchant=np.arange(NM).astype(np.int32),
        ts=np.zeros(NM, np.int32),
        risk=rng.random(NM).astype(np.float32),
    )
    return tx, {"wires": wires, "accounts": accounts, "merchants": merchants}


def _bykey(d, kc):
    o = np.lexsort((d["ts"], d[kc]))
    return {c: v[o] for c, v in d.items()}


KW = dict(num_keys=K, capacity=128, secondary_num_keys={"merchants": NM})


def _trio(num_shards, hash_routing=True, **kw):
    kw = {**KW, **kw}
    single = OnlineFeatureStore(view(), device="cpu", **kw)
    host = ShardedOnlineStore(view(), num_shards=num_shards,
                              hash_routing=hash_routing, device_routing=False,
                              device="cpu", **kw)
    dev = ShardedOnlineStore(view(), num_shards=num_shards,
                             hash_routing=hash_routing, device="cpu", **kw)
    assert not host.device_routing and dev.device_routing
    return single, host, dev


def _ingest_secondary(stores, sec):
    for t in ("wires", "accounts", "merchants"):
        kc = DB.table(t).key
        for s in stores:
            s.ingest_table(t, _bykey(sec[t], kc))


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype == np.bool_:
        a = a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bit_equal(a, b, where=""):
    assert sorted(a) == sorted(b)
    for f in a:
        np.testing.assert_array_equal(_bits(a[f]), _bits(b[f]),
                                      err_msg=f"{where} {f}")


# the view's features against the JAX package, by tolerance (the
# reference's own, as in tests/test_torch_slice.py and
# tests/test_torch_offline.py): LAST JOINs, counts and MAX bit for bit;
# sums and means rtol 1e-5; DISTINCT_APPROX's log1p rtol 1e-6; STD
# verify_view's tolerance plus XLA's FMA residue 2**-12 * |mean|
JAX_EXACT = ("limit", "mrisk", "out_cnt", "mx", "r5")
JAX_RTOL = {"out_sum": 1e-5, "util": 1e-5, "plain": 1e-5, "uniq": 1e-6}


def assert_close_to_jax(want, got, where=""):
    assert sorted(want) == sorted(got)
    for f in JAX_EXACT:
        np.testing.assert_array_equal(_bits(want[f]), _bits(got[f]),
                                      err_msg=f"{where} {f}")
    for f, rtol in JAX_RTOL.items():
        np.testing.assert_allclose(_bits(got[f]).view(np.float32),
                                   np.asarray(want[f]), rtol=rtol,
                                   err_msg=f"{where} {f}")
    a, g = np.asarray(want["out_std"]), got["out_std"].numpy()
    mean = np.abs(np.asarray(want["out_sum"])) / np.maximum(
        np.asarray(want["out_cnt"]), 1.0)
    scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
    atol = 1e-3 * max(1.0, scale) + 2.0 ** -12 * mean
    assert np.all(np.abs(g - a) <= atol + 2e-4 * np.abs(a)), where


def test_build_route_shapes_match_jax():
    shard = np.array([0, 1, 0, 2, 0, 1])
    plan = build_route(shard, 4, min_bucket=2)
    assert [list(ix) for ix in plan.idx] == [[0, 2, 4], [1, 5], [3], []]
    assert plan.bucket == 4
    assert list(plan.counts) == [3, 2, 1, 0]
    rng = np.random.default_rng(3)
    for S, n in ((1, 5), (4, 37), (8, 1000)):
        shard = rng.integers(0, S, n)
        a, b = build_route(shard, S), jax_build_route(shard, S)
        assert a.bucket == b.bucket
        for x, y in zip(a.idx, b.idx):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("hash_routing", [True, False])
@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_device_host_single_routing_parity(num_shards, hash_routing):
    """The device-routed path == the host-routed oracle == the
    single-device store, bit for bit, in both query modes, replayed with
    interleaved ingest; the per-shard counts of both paths are equal."""
    rng = np.random.default_rng(500 + num_shards)
    tx, sec = make_tables(rng)
    stores = _trio(num_shards, hash_routing)
    single, host, dev = stores
    _ingest_secondary(stores, sec)
    for idx in replay_rounds(tx["acct"], tx["ts"]):
        batch = {c: v[idx] for c, v in tx.items()}
        for mode in ("naive", "preagg"):
            ri_h, ri_d = {}, {}
            a = single.query(dict(batch), mode=mode)
            b = host.query(dict(batch), mode=mode, route_info=ri_h)
            c = dev.query(dict(batch), mode=mode, route_info=ri_d)
            where = f"S={num_shards} hash={hash_routing} {mode}"
            assert_bit_equal(a, b, "host " + where)
            assert_bit_equal(b, c, "device " + where)
            np.testing.assert_array_equal(ri_h["shard_counts"],
                                          ri_d["shard_counts"])
            assert ri_d["shard_counts"].sum() == len(idx)
        for s in stores:
            s.ingest(_bykey(batch, "acct"))
    # the three hold the same rows: the sharded states split the same keys
    np.testing.assert_array_equal(host.shard_row_counts(),
                                  dev.shard_row_counts())
    assert dev.shard_row_counts().sum() == len(tx["ts"])


def test_host_routed_matches_jax_host_routed():
    """The port's host-routed answers equal the JAX package's host-routed
    store's (``device_routing=False``), per-shard counts included."""
    rng = np.random.default_rng(41)
    tx, sec = make_tables(rng)
    jax_store = jcore.ShardedOnlineStore(jax_view(), num_shards=4,
                                         device_routing=False, **KW)
    store = ShardedOnlineStore(view(), num_shards=4, device_routing=False,
                               device="cpu", **KW)
    _ingest_secondary((jax_store, store), sec)
    half = len(tx["ts"]) // 2
    early = {c: v[:half] for c, v in tx.items()}
    for s in (jax_store, store):
        s.ingest(_bykey(early, "acct"))
    req = {c: v[half:half + 24] for c, v in tx.items()}
    for mode in ("naive", "preagg"):
        ri_j, ri_t = {}, {}
        want = jax_store.query(dict(req), mode=mode, route_info=ri_j)
        got = store.query(dict(req), mode=mode, route_info=ri_t)
        np.testing.assert_array_equal(ri_j["shard_counts"],
                                      ri_t["shard_counts"])
        assert_close_to_jax(want, got, mode)


def test_padding_mask_honored():
    """Filler rows (a real row repeated, ``valid=False``) leak into
    neither answers nor per-shard counts on either path."""
    rng = np.random.default_rng(31)
    tx, sec = make_tables(rng)
    _, host, dev = stores = _trio(4)
    _ingest_secondary(stores, sec)
    for s in (host, dev):
        s.ingest(_bykey(tx, "acct"))
    q, pad = 13, 3
    req = {c: v[:q] for c, v in tx.items()}
    padded = {c: np.concatenate([v, np.repeat(v[-1:], pad)])
              for c, v in req.items()}
    valid = np.arange(q + pad) < q
    for mode in ("naive", "preagg"):
        ri_h, ri_d = {}, {}
        bare = dev.query(dict(req), mode=mode)
        b = host.query(dict(padded), mode=mode, valid=valid, route_info=ri_h)
        c = dev.query(dict(padded), mode=mode, valid=valid, route_info=ri_d)
        for f in bare:
            np.testing.assert_array_equal(_bits(b[f])[:q], _bits(c[f])[:q])
            np.testing.assert_array_equal(_bits(bare[f]), _bits(c[f])[:q])
        np.testing.assert_array_equal(ri_h["shard_counts"],
                                      ri_d["shard_counts"])
        assert ri_d["shard_counts"].sum() == q


def _count_dispatches(store, monkeypatch):
    """Per-kernel call counts of the route entry points while ``store``
    answers (``route_keys`` from keys, ``route_rank`` from shard ids)."""
    calls = {"route_keys": 0, "route_rank": 0}
    for name in calls:
        fn = getattr(shard_mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(shard_mod, name, spy)
    return calls


@pytest.mark.parametrize("hash_routing", [True, False])
def test_overflow_redispatch_exact(hash_routing, monkeypatch):
    """Every row on one shard overflows the optimistic per-shard capacity;
    the re-dispatch at B = N stays bit-equal to the host oracle and the
    single store.  Modulo routing ranks from shard ids once a dispatch and
    never walks keys."""
    rng = np.random.default_rng(77)
    tx, sec = make_tables(rng)
    stores = _trio(8, hash_routing)
    single, host, dev = stores
    _ingest_secondary(stores, sec)
    for s in stores:
        s.ingest(_bykey(tx, "acct"))
    n = 64
    keys = np.full(n, 3, np.int32) if hash_routing else \
        rng.choice(np.arange(0, K, 8), n).astype(np.int32)  # all ≡ 0 mod 8
    req = dict(acct=keys, ts=np.full(n, 3_000, np.int32),
               amount=rng.gamma(2.0, 10.0, n).astype(np.float32),
               merchant=rng.integers(0, NM, n).astype(np.int32))
    assert len(set(dev.shard_of(keys).tolist())) == 1
    assert dev._route_bucket(n) == 16 < n
    calls = _count_dispatches(dev, monkeypatch)
    ri = {}
    c = dev.query(dict(req), mode="preagg", route_info=ri)
    # the CPU walks keys with its fixed passes and ranks from the walked
    # ids (once more if the walk was unfinished); modulo ranks once
    assert calls["route_keys"] == 0
    assert (calls["route_rank"] >= 1) if hash_routing else \
        (calls["route_rank"] == 1)
    assert ri["shard_counts"].max() == n
    assert_bit_equal(host.query(dict(req), mode="preagg"), c, "host")
    assert_bit_equal(single.query(dict(req), mode="preagg"), c, "single")


def test_route_bucket_pow2_edges():
    store = ShardedOnlineStore(view(), num_shards=8, device="cpu", **KW)
    f = store._route_bucket
    assert [f(m) for m in (1, 2, 8, 15, 16, 17)] == [1, 2, 8, 16, 16, 16]
    assert f(64) == 16 and f(65) == 32
    assert [f(m) for m in (128, 129, 256)] == [32, 64, 64]
    prev = 0
    for m in range(1, 1025):
        b = f(m)
        cap = 1 << max(m - 1, 0).bit_length()
        assert b & (b - 1) == 0 and b <= max(cap, 1) and b >= min(16, cap)
        assert b >= prev
        prev = b


@pytest.mark.parametrize("hash_routing", [False, True])
def test_hash_routing_same_answers(hash_routing):
    """Routing choice is invisible in answers: both match the
    single-device store bit for bit (and the JAX sharded store with the
    same routing: state bit-exact, answers at the stated tolerances)."""
    rng = np.random.default_rng(17)
    tx, sec = make_tables(rng, n=300)
    tx["acct"] = (tx["acct"] * 8 % K).astype(np.int32)   # strided-ish
    single, _, dev = stores = _trio(4, hash_routing)
    jax_store = jcore.ShardedOnlineStore(jax_view(), num_shards=4,
                                         hash_routing=hash_routing, **KW)
    _ingest_secondary(stores + (jax_store,), sec)
    for s in stores + (jax_store,):
        s.ingest(_bykey(tx, "acct"))
    want = {k: np.asarray(v) for k, v in zip(
        ("ring_ts", "ring_vals", "cursor"),
        (jax_store.state.ring.ts, jax_store.state.ring.vals,
         jax_store.state.ring.cursor))}
    for i, r in enumerate(jax_store.state.sec):
        want[f"sec{i}_vals"] = np.asarray(r.vals)
        want[f"sec{i}_cursor"] = np.asarray(r.cursor)
    got = online_state_to_numpy(dev.state)
    for name, a in want.items():
        np.testing.assert_array_equal(_bits(a), _bits(got[name]), err_msg=name)
    req = dict(acct=np.arange(K, dtype=np.int32),
               ts=np.full(K, 2_100, np.int32), amount=np.ones(K, np.float32),
               merchant=np.arange(K, dtype=np.int32) % NM)
    for mode in ("naive", "preagg"):
        a = single.query(dict(req), mode=mode)
        b = dev.query(dict(req), mode=mode)
        assert_bit_equal(a, b, f"{mode}")
        assert_close_to_jax(jax_store.query(dict(req), mode=mode), b, mode)


def test_strided_keys_spread_under_hash_collapse_under_modulo():
    """All keys ≡ 0 mod S: modulo routing collapses them onto shard 0,
    the Feistel routing spreads them — the routers' skew histograms equal
    the JAX routers'."""
    S, n_keys = 4, 64
    strided = np.arange(0, n_keys * S, S, dtype=np.int32)

    def skew_view(ex, View, db):
        return View("skew", db.primary,
                    {"s": ex.w_sum(ex.Col("amount"), ex.range_window(100))})

    def histogram(hash_routing, jax_side):
        if jax_side:
            v = skew_view(jex, jcore.FeatureView, _db(jcore))
            store = jcore.ShardedOnlineStore(
                v, num_keys=n_keys * S, num_shards=S, capacity=64,
                hash_routing=hash_routing)
            router = JaxRouter(JaxService("svc", v, store), ingest=False)
        else:
            v = skew_view(tex, FeatureView, DB)
            store = ShardedOnlineStore(
                v, num_keys=n_keys * S, num_shards=S, capacity=64,
                hash_routing=hash_routing, device="cpu")
            router = ShardRouter(FeatureService("svc", v, store),
                                 ingest=False)
        for k in strided:
            router.submit(dict(acct=int(k), ts=10, amount=1.0, merchant=0))
        router.drain()
        return router.shard_histogram()

    mod, hashed = histogram(False, False), histogram(True, False)
    assert mod[0] == len(strided) and (mod[1:] == 0).all()
    assert (hashed > 0).all() and hashed.max() < len(strided) // 2
    np.testing.assert_array_equal(mod, histogram(False, True))
    np.testing.assert_array_equal(hashed, histogram(True, True))


@pytest.mark.parametrize("hash_routing", [True, False])
def test_shard_row_counts_match_jax(hash_routing):
    rng = np.random.default_rng(9)
    v = FeatureView("s", DB.primary,
                    {"s": tex.w_sum(tex.Col("amount"), tex.range_window(100))})
    jv = jcore.FeatureView(
        "s", _db(jcore).primary,
        {"s": jex.w_sum(jex.Col("amount"), jex.range_window(100))})
    kw = dict(num_keys=K, num_shards=4, capacity=64, hash_routing=hash_routing)
    store = ShardedOnlineStore(v, device="cpu", **kw)
    jax_store = jcore.ShardedOnlineStore(jv, **kw)
    n = 400
    tx = _bykey(dict(acct=rng.integers(0, K, n).astype(np.int32),
                     ts=np.arange(n, dtype=np.int32),
                     amount=np.ones(n, np.float32),
                     merchant=np.zeros(n, np.int32)), "acct")
    store.ingest(dict(tx))
    jax_store.ingest(dict(tx))
    counts = store.shard_row_counts()
    np.testing.assert_array_equal(counts, jax_store.shard_row_counts())
    assert counts.sum() == n and counts.min() > 0


def test_routing_flags_and_errors():
    """``device_routing`` / ``hash_routing`` pass through
    ``FeatureService.build``; a single-device service accepts and ignores
    ``device_routing``; out-of-range keys raise on both paths."""
    svc = FeatureService.build("h", view(), sharded=True, num_shards=2,
                               device_routing=False, hash_routing=False,
                               device="cpu", **KW)
    assert not svc.store.device_routing and svc.store._perm is None
    one = FeatureService.build("o", view(), device_routing=False,
                               device="cpu", **KW)
    assert type(one.store) is OnlineFeatureStore
    req = dict(acct=np.array([K], np.int32), ts=np.array([10], np.int32),
               amount=np.ones(1, np.float32), merchant=np.zeros(1, np.int32))
    for routing in (True, False):
        svc.store.device_routing = routing
        with pytest.raises(ValueError, match="out of range"):
            svc.store.query(dict(req))
    with pytest.raises(ValueError, match="out of range"):
        svc.store.ingest_table("merchants", dict(
            merchant=np.array([NM], np.int32), ts=np.zeros(1, np.int32),
            risk=np.zeros(1, np.float32)))

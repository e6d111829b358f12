"""The merge-order bucket families of the port against the JAX package.

A view with FIRST / LAST / TOPN_FREQ over a RANGE window persists, per
(key, bucket), the oldest and newest row by ``(ts, pos)`` and the newest
``TOPN_TAIL`` rows (``repro_torch.core.preagg``).  Held here bit for bit
against the reference (run with the ``jax_families`` fixture of
``tests/torch_deploy_common.py``, which makes its families run in this
container):

* ``bucket_ingest`` over sequential batches (stale slots, pad rows, a
  wrapped bucket ring, ties on ts, a segment longer than the tail): every
  family tensor;
* the online store's ingest order (the families, then B1's plain version
  on the six core arrays) equals the split ``bucket_ingest``, with
  ``seq`` equal to the ring cursor after every batch;
* the reference's ``PRIMARY_VIEW`` (``tests/test_aggregates.py``) served in
  naive and preagg mode on 1 and 4 shards: states and answers;
* ``migrate_state`` of a family layout: a rebuild from the ring, a carry
  and a ``num_buckets`` remap — states, reports and answers;
* ``verify_view`` of the reference's primary and union views with err 0
  on every feature (FIRST / LAST / TOPN return raw row values).
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.preagg as jax_pg
from repro_torch.convert import online_state_to_numpy
from repro_torch.core import expr as tex
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.consistency import verify_view
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.scenario import ScenarioPlane
from repro_torch.core.view import FeatureView
from repro_torch.kernels.ingest.ops import fused_ingest
from torch_deploy_common import (
    FAMILY_FIELDS,
    assert_reports_equal,
    jax_families,  # noqa: F401  (a fixture)
)

pytestmark = pytest.mark.usefixtures("jax_families")

CPU = torch.device("cpu")
BUCKET_FIELDS = ("stats", "bitmap", "bucket") + FAMILY_FIELDS


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.bool_:
        return a.astype(np.int8)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bagg_equal(want, got, where=""):
    """Every bucket tensor of two ``BucketAgg`` s (JAX's or the port's)
    bit for bit."""
    for f in BUCKET_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), (where, f)
        if a is None:
            continue
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{where} {f}")


# ---------------------------------------------------------------------------
# bucket_ingest: every family tensor, batch by batch
# ---------------------------------------------------------------------------

K, NB, F, BS = 13, 8, 2, 16


def _batches(seed, n_batches=10):
    """(key, ts, vals) batches, (key, ts)-sorted with 5 pad rows (key K)
    at the end.  Each spans < NB buckets and moves 3 buckets on, so slots
    wrap and go stale; small ts ranges give ties; batch 3 piles 45 rows
    of key 0 into one bucket (a segment longer than the tail)."""
    rng = np.random.default_rng(seed)
    t0 = 0
    for b in range(n_batches):
        n = 64
        key = rng.integers(0, K, n).astype(np.int32)
        ts = (t0 + rng.integers(0, BS * (NB - 2), n)).astype(np.int32)
        if b == 3:
            key[:45] = 0
            ts[:45] = t0 + rng.integers(0, 4, 45)
        vals = rng.integers(0, 5, (n, F)).astype(np.float32)
        o = np.lexsort((ts, key))
        key, ts, vals = key[o], ts[o], vals[o]
        key = np.concatenate([key, np.full(5, K, np.int32)])
        ts = np.concatenate([ts, np.full(5, ts[-1], np.int32)])
        vals = np.concatenate([vals, np.zeros((5, F), np.float32)])
        yield key, ts, vals
        t0 += 3 * BS


@pytest.mark.parametrize("fams", ["extreme", "tail", "both"])
def test_bucket_ingest_families_match_jax(fams):
    kw = dict(extreme=fams != "tail", tail=fams != "extreme")
    want = jax_pg.bucket_init(K, NB, F, BS, **kw)
    got = pg.bucket_init(K, NB, F, BS, CPU, **kw)
    ingest = jax.jit(jax_pg.bucket_ingest)
    full_tail = False
    for i, (key, ts, vals) in enumerate(_batches(7)):
        want = ingest(want, key, ts, vals)
        pg.bucket_ingest(got, *map(torch.from_numpy, (key, ts, vals)))
        _assert_bagg_equal(want, got, f"batch {i}")
        full_tail |= kw["tail"] and bool(got.tvalid.all(-1).any())
    assert bool(got.seq.gt(0).all())
    assert full_tail or not kw["tail"], "no tail was ever full"


def test_b1_plain_then_families_equals_split():
    """The online store's ingest (``bucket_families_ingest``, then the
    fused kernel's plain version on the six core arrays) equals the split
    ring + ``bucket_ingest`` pass; ``seq`` is the ring cursor."""
    split = (st.ring_init(K, 16, F, CPU),
             pg.bucket_init(K, NB, F, BS, CPU, extreme=True, tail=True))
    fused = (st.ring_init(K, 16, F, CPU),
             pg.bucket_init(K, NB, F, BS, CPU, extreme=True, tail=True))
    for i, batch in enumerate(_batches(11)):
        key, ts, vals = map(torch.from_numpy, batch)
        st.ring_ingest(split[0], key, ts, vals)
        pg.bucket_ingest(split[1], key, ts, vals)
        ring, bagg = fused
        pg.bucket_families_ingest(bagg, key, ts, vals)
        fused_ingest(ring.ts, ring.vals, ring.cursor, bagg.stats,
                     bagg.bitmap, bagg.bucket, key, ts, vals,
                     bucket_size=BS)
        _assert_bagg_equal(split[1], bagg, f"batch {i}")
        for f in ("ts", "vals", "cursor"):
            assert torch.equal(getattr(split[0], f), getattr(ring, f))
        assert torch.equal(bagg.seq, ring.cursor), f"batch {i}"


# ---------------------------------------------------------------------------
# the store: the reference's PRIMARY_VIEW / UNION_VIEW, both modes, 1 and 4
# shards
# ---------------------------------------------------------------------------

KIT = {
    "jax": (jcore, jcore.Database, jcore.TableSchema, jcore.FeatureView),
    "torch": (tex, st.Database, st.TableSchema, FeatureView),
}


def _db(pkg):
    _, Database, TableSchema, _ = KIT[pkg]
    return Database(
        name="alg",
        primary=TableSchema("tx", key="acct", ts="ts", numeric=("amount",)),
        secondary=(
            TableSchema("wires", key="acct", ts="ts", numeric=("amount",)),
        ),
    )


def _view(pkg, which):
    """The reference's ``PRIMARY_VIEW`` / ``UNION_VIEW`` in ``pkg``."""
    x, _, _, View = KIT[pkg]
    db = _db(pkg)
    u = {"union": ("wires",)} if which == "union" else {}
    w5, w4 = x.range_window(500, bucket=64), x.range_window(400, bucket=64)
    s = "u" if u else "r"
    feats = {
        f"first_{s}": x.w_first(x.Col("amount"), w5, **u),
        f"last_{s}": x.w_last(x.Col("amount"), w5, **u),
        f"top1_{s}": x.w_topn_freq(x.Col("amount"), w4, n=0, **u),
        f"top2_{s}": x.w_topn_freq(x.Col("amount"), w4, n=1, **u),
    }
    name = "union_exact" if u else "primary_exact"
    return View(name=name, schema=db.primary, features=feats, database=db)


def _workload(seed, n=260, m=130, k=7, t_max=2_000):
    """The reference's ``_union_workload``: unique ts across both tables."""
    rng = np.random.default_rng(seed)
    all_ts = rng.choice(t_max, size=n + m, replace=False).astype(np.int32)
    tx = dict(
        acct=rng.integers(0, k, n).astype(np.int32),
        ts=np.sort(all_ts[:n]),
        amount=rng.integers(0, 6, n).astype(np.float32),
    )
    wires = dict(
        acct=rng.integers(0, k, m).astype(np.int32),
        ts=np.sort(all_ts[n:]),
        amount=rng.integers(0, 6, m).astype(np.float32),
    )
    return tx, wires, k


STORE_KW = dict(capacity=256, num_buckets=64, bucket_size=64)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bagg_of(store):
    return store.state.bagg


@pytest.fixture(scope="module")
def primary_stores():
    """PRIMARY_VIEW stores of both packages at 1 and 4 shards, fed the
    reference's workload (seed 31) in four time-ordered batches."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pg, "_TS_EMPTY", -2147483648)
        tx, _, k = _workload(31)
        chunks = np.array_split(np.arange(tx["ts"].size), 4)
        out = {}
        for shards in (None, 4):
            pair = {}
            for pkg in ("jax", "torch"):
                dev = {} if pkg == "jax" else {"device": "cpu"}
                cls = (jcore.OnlineFeatureStore if pkg == "jax"
                       else OnlineFeatureStore)
                store = cls.create(_view(pkg, "primary"), num_keys=k,
                                   num_shards=shards, **STORE_KW, **dev)
                for idx in chunks:
                    o = idx[np.lexsort((tx["ts"][idx], tx["acct"][idx]))]
                    store.ingest({c: v[o] for c, v in tx.items()})
                pair[pkg] = store
            out[shards] = pair
        yield out, tx, k


def _request(k):
    """Every key at the stream's end, mid-stream and a bucket edge."""
    ts = np.concatenate([np.full(k, 2_050), np.full(k, 1_000),
                         np.full(k, 64 * 20)]).astype(np.int32)
    amount = np.random.default_rng(5).integers(0, 6, 3 * k)
    return dict(acct=np.tile(np.arange(k, dtype=np.int32), 3), ts=ts,
                amount=amount.astype(np.float32))


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("shards", [None, 4])
def test_store_answers_match_jax(primary_stores, mode, shards):
    stores, tx, k = primary_stores
    want_s, got_s = stores[shards]["jax"], stores[shards]["torch"]
    _assert_bagg_equal(_bagg_of(want_s), _bagg_of(got_s), "state")
    req = _request(k)
    want = want_s.query(dict(req), mode=mode)
    got = got_s.query(dict(req), mode=mode)
    assert sorted(want) == sorted(got)
    for f in want:
        np.testing.assert_array_equal(_bits(_np(want[f])), _bits(_np(got[f])),
                                      err_msg=f"{mode} {f}")
    assert np.any(_np(got["top2_r"]) != 0.0)


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("which", ["primary", "union"])
def test_verify_view_exact(which, mode, shards):
    """The reference's ``test_first_topn_{primary_bucket,union}_exact`` on
    the port: offline == online row for row, err 0 on every feature."""
    tx, wires, k = _workload(31 if which == "primary" else 23)
    rep = verify_view(
        _view("torch", which), tx, num_keys=k, mode=mode, num_shards=shards,
        secondary={"wires": wires} if which == "union" else None,
        device="cpu", **STORE_KW,
    )
    assert rep.passed, rep.summary() + f" per-feature: {rep.per_feature}"
    for f, err in rep.per_feature.items():
        assert err == 0.0, f"{f}: max abs err {err} (expected exact)"


def test_preagg_counts_family_hits_not_fallbacks(primary_stores):
    """FIRST / LAST / TOPN_FREQ compose from the bucket families on the
    preagg path: hits and no fallbacks (the reference's
    ``test_first_topn_preagg_hit_not_fallback``), as JAX counts them."""
    from repro.obs import Telemetry as JaxTelemetry
    from repro.obs import use_telemetry as jax_use_telemetry
    from repro_torch.obs import Telemetry, use_telemetry

    stores, tx, k = primary_stores
    req = _request(k)
    jtel, ttel = JaxTelemetry(), Telemetry()
    with jax_use_telemetry(jtel):
        stores[4]["jax"].query(dict(req), mode="preagg")
    with use_telemetry(ttel):
        stores[4]["torch"].query(dict(req), mode="preagg")
    for agg in ("first", "last", "topn_freq"):
        got = [ttel.metrics.counter(n, labels=("agg",)).value(agg=agg)
               for n in ("preagg_hits_total", "preagg_fallback_total")]
        want = [jtel.metrics.counter(n, labels=("agg",)).value(agg=agg)
                for n in ("preagg_hits_total", "preagg_fallback_total")]
        assert got == want and got[0] > 0 and got[1] == 0, (agg, got, want)


# ---------------------------------------------------------------------------
# migrate_state of a family layout: rebuild from the ring, carry, remap
# ---------------------------------------------------------------------------


def _evo_view(pkg, with_families):
    """The reference's ``_evo_view``."""
    x, _, _, View = KIT[pkg]
    db = _db(pkg)
    w5, w4 = x.range_window(500, bucket=64), x.range_window(400, bucket=64)
    feats = {"s": x.w_sum(x.Col("amount"), w5)}
    if with_families:
        feats["first_r"] = x.w_first(x.Col("amount"), w5)
        feats["top1_r"] = x.w_topn_freq(x.Col("amount"), w4, n=0)
    return View(name="evo", schema=db.primary, features=feats, database=db)


def _state(plane):
    s = plane.store.state
    if isinstance(s.ring.ts, torch.Tensor):
        return online_state_to_numpy(s)
    out = {"ring_ts": s.ring.ts, "ring_vals": s.ring.vals,
           "cursor": s.ring.cursor, "bstats": s.bagg.stats,
           "bbitmap": s.bagg.bitmap, "bbucket": s.bagg.bucket}
    out.update({f"b{f}": getattr(s.bagg, f) for f in FAMILY_FIELDS
                if getattr(s.bagg, f) is not None})
    return {n: np.asarray(v) for n, v in out.items()}


def _assert_planes_equal(want, got, where):
    a, b = _state(want), _state(got)
    assert sorted(a) == sorted(b), where
    for n in a:
        np.testing.assert_array_equal(_bits(a[n]), _bits(b[n]),
                                      err_msg=f"{where} {n}")


@pytest.mark.parametrize("shards", [None, 4])
def test_migrate_families_match_jax(shards):
    """Families planned mid-flight (rebuilt from the ring's rows), then a
    capacity re-lay (carried), then ``num_buckets`` 64 -> 16 (remapped,
    colliding ids keep the newer): each step's state and report equal
    JAX's bit for bit, the first two equal a cold rebuild + replay with
    its answers, and the last step's answers equal JAX's."""
    tx, _, k = _workload(17)
    o = np.lexsort((tx["ts"], tx["acct"]))
    stream = {c: np.asarray(v)[o] for c, v in tx.items()}
    kw = dict(num_keys=k, num_shards=shards, **STORE_KW)
    planes = {
        "jax": jcore.ScenarioPlane([_evo_view("jax", False)], **kw),
        "torch": ScenarioPlane([_evo_view("torch", False)], device="cpu",
                               **kw),
    }
    assert planes["torch"].store.state.bagg.seq is None
    for p in planes.values():
        p.ingest(stream)
    q = {c: v[-16:] for c, v in stream.items()}
    steps = (("rebuild", {}), ("carry", {"capacity": 384}),
             ("remap", {"capacity": 384, "num_buckets": 16}))
    for step, over in steps:
        reps = {pkg: p.evolve([_evo_view(pkg, True)], **over)
                for pkg, p in planes.items()}
        assert_reports_equal(reps["jax"], reps["torch"])
        assert reps["torch"].exact, reps["torch"].summary()
        _assert_planes_equal(planes["jax"], planes["torch"], step)
        hot = planes["torch"]
        assert torch.equal(hot.store.state.bagg.seq,
                           hot.store.state.ring.cursor)
        if step == "remap":
            continue
        cold = ScenarioPlane([_evo_view("torch", True)], device="cpu",
                             **dict(kw, **over))
        cold.ingest(stream)
        _assert_planes_equal(cold, hot, f"{step} vs cold")
        for mode in ("preagg", "naive"):
            want = cold.query("evo", dict(q), mode=mode)
            got = hot.query("evo", dict(q), mode=mode)
            for f in want:
                np.testing.assert_array_equal(
                    _bits(_np(want[f])), _bits(_np(got[f])),
                    err_msg=f"{step} {mode} {f}")
    for mode in ("preagg", "naive"):
        want = planes["jax"].query("evo", dict(q), mode=mode)
        got = planes["torch"].query("evo", dict(q), mode=mode)
        for f in ("first_r", "top1_r"):
            np.testing.assert_array_equal(_np(want[f]), _np(got[f]),
                                          err_msg=f"{mode} {f}")
        np.testing.assert_allclose(_np(got["s"]), _np(want["s"]), rtol=1e-5)

"""The PyTorch port's sharded online request path against the JAX package.

The same numpy-made ingest stream and request batches go through
``FeatureService.build(fraud_view(), sharded=True, num_shards=S)`` of both
packages, and through their single-device (``sharded=False``) stores: the
port on ``device="cpu"``, where its kernels run their plain versions; the
JAX side as its own tests run it on CPU, where ingest takes the split XLA
path.  Tolerances:

* state arrays (ring ts / vals / cursor, bucket stats / bitmap / ids):
  bit-exact, f32 compared as int32 bit patterns;
* COUNT and MAX features, and ``big_ratio_1h`` (a ratio of exact counts):
  bit-exact;
* SUM and MEAN: ``rtol=1e-5`` — masked sums over the ring reduce in a
  framework-chosen order;
* STD: ``verify_view``'s tolerance, ``rtol=2e-4`` and
  ``atol=1e-3 * max(1, p99 |value|)``, plus ``2**-12 * |mean|`` per row.
  XLA on the CPU contracts ``sumsq / n - m * m`` into a fused multiply-add,
  so where the variance is ~0 (a one-row window) the reference returns
  the square root of the rounding error of ``m * m`` — at most
  ``sqrt(2**-24 * m**2) = 2**-12 * |m|`` — while the port, with no
  contraction, returns 0.
"""

import numpy as np
import pytest
import torch

from repro.scenarios import fraud_view as jax_fraud_view
from repro.serve.router import ShardRouter as JaxRouter
from repro.serve.service import BatchScheduler as JaxScheduler
from repro.serve.service import FeatureService as JaxService
from repro_torch.convert import (
    STATE_ARRAYS,
    online_state_from_numpy,
    online_state_to_numpy,
)
from repro_torch.scenarios import fraud_view
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import BatchScheduler, FeatureService

NUM_CARDS = 256
STORE_KW = dict(capacity=32, num_buckets=32, bucket_size=1024)

EXACT = ("tx_count_1h", "tx_count_50", "amt_max_6h", "big_ratio_1h")
SUMS = ("amt_sum_1h", "amt_mean_1h", "amt_sum_6h")
STD = ("amt_std_1h",)


def _stream(rng, n, lo, hi, hot=0):
    """(card, ts)-sorted fraud transactions; ``hot`` rows on card 7."""
    card = rng.integers(0, NUM_CARDS, n).astype(np.int32)
    card[:hot] = 7
    ts = rng.integers(lo, hi, n).astype(np.int32)
    o = np.lexsort((ts, card))
    return dict(
        card=card[o], ts=ts[o],
        amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
        mcc=rng.integers(0, 32, n).astype(np.int32),
        device=rng.integers(0, 8, n).astype(np.int32),
        geo=rng.integers(0, 16, n).astype(np.int32),
    )


def _requests(rng, n, t):
    cols = _stream(rng, n, t, t + 600)
    perm = rng.permutation(n)  # requests arrive unsorted
    return {c: v[perm] for c, v in cols.items()}


def _services(num_shards, mode):
    """Both packages' fraud services; ``num_shards=None`` is the
    single-device store."""
    kw = dict(num_keys=NUM_CARDS, mode=mode, sharded=num_shards is not None,
              num_shards=num_shards, **STORE_KW)
    jax_svc = JaxService.build("fraud", jax_fraud_view(), **kw)
    svc = FeatureService.build("fraud", fraud_view(), device="cpu", **kw)
    return jax_svc, svc


def _jax_state(store):
    s = store.state
    return dict(zip(
        [n for n, _ in STATE_ARRAYS],
        [np.asarray(a) for a in (s.ring.ts, s.ring.vals, s.ring.cursor,
                                 s.bagg.stats, s.bagg.bitmap, s.bagg.bucket)],
    ))


def assert_states_equal(jax_store, store, where=""):
    want = _jax_state(jax_store)
    got = online_state_to_numpy(store.state)
    for name, _ in STATE_ARRAYS:
        a, b = want[name], got[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {name}")


def assert_features_close(want, got, where=""):
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(want[f]).view(np.int32), got[f].view(np.int32),
            err_msg=f"{where} {f}",
        )
    for f in SUMS:
        np.testing.assert_allclose(
            got[f], np.asarray(want[f]), rtol=1e-5, err_msg=f"{where} {f}"
        )
    mean = np.abs(np.asarray(want["amt_mean_1h"]))
    for f in STD:
        a = np.asarray(want[f])
        scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
        atol = 1e-3 * max(1.0, scale) + 2.0 ** -12 * mean
        assert np.all(np.abs(got[f] - a) <= atol + 2e-4 * np.abs(a)), (
            f"{where} {f}: max |diff| {np.max(np.abs(got[f] - a))}"
        )


@pytest.mark.parametrize("mode", ["naive", "preagg"])
@pytest.mark.parametrize("num_shards", [None, 1, 4])
def test_fraud_service_matches_jax(num_shards, mode):
    """Same stream, same requests: state bit-exact after every step and
    features within the stated tolerances.  The first batch spans ~49
    buckets of 1024 s (> num_buckets - 1), so ingest chunks it on bucket
    epochs; card 7 gets 45 rows (> capacity 32) in one batch, so ring
    slots repeat; later batches reuse bucket slots (stale resets)."""
    rng = np.random.default_rng(100 + (num_shards or 0))
    jax_svc, svc = _services(num_shards, mode)
    warm = _stream(rng, 1500, 0, 50_000, hot=45)
    jax_svc.store.ingest(dict(warm))
    svc.store.ingest(dict(warm))
    assert_states_equal(jax_svc.store, svc.store, "warm")
    for step, t in enumerate((50_500, 52_000, 90_000)):
        req = _requests(rng, 40, t)
        want = jax_svc.request(dict(req), ingest=True)
        got = svc.request(dict(req), ingest=True)
        assert_features_close(want, got, f"S={num_shards} {mode} step {step}")
        assert_states_equal(jax_svc.store, svc.store, f"step {step}")


def test_router_order_and_skew_histogram_match_jax():
    """Requests through ``ShardRouter``: answers in submission order and
    the per-shard skew histogram equal the JAX router's, across padded
    micro-batches with ingest on."""
    rng = np.random.default_rng(7)
    jax_svc, svc = _services(4, "preagg")
    warm = _stream(rng, 600, 0, 20_000)
    jax_svc.store.ingest(dict(warm))
    svc.store.ingest(dict(warm))
    jr = JaxRouter(jax_svc, JaxScheduler(buckets=(16,), max_batch=16))
    tr = ShardRouter(svc, BatchScheduler(buckets=(16,), max_batch=16))
    req = _requests(rng, 37, 20_100)  # 16 + 16 + 5 (padded) rows
    for i in range(37):
        row = {c: v[i] for c, v in req.items()}
        jr.submit(dict(row), now_us=i)
        tr.submit(dict(row), now_us=i)
    want = jr.drain(now_us=100)
    got = tr.drain(now_us=100)
    assert_features_close(want, got, "router")
    np.testing.assert_array_equal(jr.shard_histogram(), tr.shard_histogram())
    assert tr.shard_histogram().sum() == 37
    assert_states_equal(jax_svc.store, svc.store, "router")


def test_warm_state_carried_from_jax():
    """A port store seeded with a JAX store's warm state through
    ``online_state_from_numpy`` answers and ingests like the JAX store."""
    rng = np.random.default_rng(11)
    jax_svc, svc = _services(4, "preagg")
    jax_svc.store.ingest(dict(_stream(rng, 800, 0, 30_000)))
    svc.store.state = online_state_from_numpy(
        _jax_state(jax_svc.store), device="cpu",
        bucket_size=STORE_KW["bucket_size"],
    )
    assert_states_equal(jax_svc.store, svc.store, "seeded")
    req = _requests(rng, 24, 30_100)
    assert_features_close(
        jax_svc.request(dict(req)), svc.request(dict(req)), "seeded"
    )
    assert_states_equal(jax_svc.store, svc.store, "seeded+ingest")


@pytest.mark.parametrize("case", ["overflow", "walk"])
def test_routed_redispatch_paths_match_jax(case):
    """The two re-dispatches of a routed batch: every row on one card
    (one shard overflows its optimistic capacity), and a Feistel walk left
    unfinished by the fixed device passes (forced to one pass over a
    200-key domain, where ids leave the domain).  Answers stay equal to
    the JAX service's and the histogram counts every real row."""
    cards = 200 if case == "walk" else NUM_CARDS
    kw = dict(num_keys=cards, mode="preagg", sharded=True, num_shards=8,
              **STORE_KW)
    jax_svc = JaxService.build("fraud", jax_fraud_view(), **kw)
    svc = FeatureService.build("fraud", fraud_view(), device="cpu", **kw)
    rng = np.random.default_rng(21)
    warm = _stream(rng, 600, 0, 20_000)
    warm["card"] = np.sort(warm["card"] % cards).astype(np.int32)
    jax_svc.store.ingest(dict(warm))
    svc.store.ingest(dict(warm))
    req = _requests(rng, 40, 20_100)
    req["card"] = (req["card"] % cards).astype(np.int32)
    if case == "overflow":
        req["card"][:] = 9
    else:
        svc.store._perm.device_passes = 1
        _, walking = svc.store._perm.device_call(torch.as_tensor(req["card"]))
        assert bool(walking)  # the re-dispatch branch is taken
    ri = {}
    got = svc.request(dict(req), ingest=False, route_info=ri)
    assert_features_close(jax_svc.request(dict(req), ingest=False), got, case)
    assert ri["shard_counts"].sum() == 40

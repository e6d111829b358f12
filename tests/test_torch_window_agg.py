"""The PyTorch port's window-aggregation kernels against the JAX package.

The same numpy-made inputs go through the JAX functions and the port's
(``device="cpu"``, where the dispatchers run their plain versions; the
JAX side on its XLA path, as its own tests run it on the CPU).

Tolerances:

* fold levels, ``fold_min`` / ``fold_max`` and the windowed fold: bit for
  bit (f32 compared as int32 patterns), NaN payloads and ``±0.0``
  included.  Subnormals are left out: XLA on the CPU flushes them to zero
  in min / max, the port keeps them (ROADMAP Queue C);
* window stats: count, min and max bit for bit; sum and sumsq within
  ``rtol=1e-5, atol=1e-3`` — masked sums reduce in a framework-chosen
  order (the tolerance of the reference's own kernel test).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windows import segment_starts as jax_segment_starts
from repro.kernels.window_agg.ops import fold_levels as jax_fold_levels
from repro.kernels.window_agg.ops import window_stats as jax_window_stats
from repro_torch import kernels
from repro_torch.convert import online_state_from_numpy
from repro_torch.kernels.window_agg.ops import fold_levels, window_stats
from repro_torch.kernels.window_agg.ref import (
    fold_max,
    fold_min,
    fold_num_levels,
)

# float32 bit patterns: ±0, quiet / signalling NaNs of both signs and
# payloads, ±inf, ±1, ±max, the smallest normal
SPECIAL = np.array(
    [0x0, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001,
     0xFF800005, 0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000,
     0x7F7FFFFF, 0xFF7FFFFF, 0x00800000],
    np.uint32,
).view(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rng(tag):
    return np.random.default_rng(zlib.crc32(tag.encode()))


@pytest.mark.parametrize("op", ["min", "max"])
def test_fold_min_max_match_jnp_on_special_values(op):
    a, b = (g.ravel() for g in np.meshgrid(SPECIAL, SPECIAL, indexing="ij"))
    jf = jnp.minimum if op == "min" else jnp.maximum
    tf = fold_min if op == "min" else fold_max
    want = np.asarray(jax.jit(jf)(a, b))
    got = tf(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _fold_case(tag, n, op, special=False):
    rng = _rng(tag)
    key = np.sort(rng.integers(0, 7, n)).astype(np.int32)
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    elif special:
        x = rng.choice(SPECIAL, n)
    else:
        x = rng.normal(size=n).astype(np.float32)
    return key, x


@pytest.mark.parametrize("n", [1, 5, 1024, 4097])
@pytest.mark.parametrize("op", ["min", "max", "or"])
def test_fold_levels_bit_exact_vs_jax(n, op):
    key, x = _fold_case(f"fold-{n}-{op}", n, op)
    seg = np.array(jax_segment_starts(jnp.asarray(key)))
    want = np.asarray(jax_fold_levels(jnp.asarray(x), jnp.asarray(seg),
                                      op=op, impl="xla"))
    got = fold_levels(torch.as_tensor(x), torch.as_tensor(seg), op=op)
    assert got.shape == (fold_num_levels(n), n) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("layout", ["segments", "one_segment", "all_starts"])
def test_fold_levels_nan_and_signed_zero_bit_exact(op, layout):
    """NaN payloads of both signs, ±0.0 and ±inf in every position, over
    7 segments, one segment, and every row its own segment."""
    n = 777
    key, x = _fold_case(f"special-{op}-{layout}", n, op, special=True)
    if layout == "one_segment":
        key = np.zeros(n, np.int32)
    elif layout == "all_starts":
        key = np.arange(n, dtype=np.int32)
    seg = np.array(jax_segment_starts(jnp.asarray(key)))
    want = np.asarray(jax_fold_levels(jnp.asarray(x), jnp.asarray(seg),
                                      op=op, impl="xla"))
    got = fold_levels(torch.as_tensor(x), torch.as_tensor(seg), op=op)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fold_levels_cpu_dispatch_counts_no_launch():
    """CPU tensors run the plain version: no kernel launch is counted."""
    before = dict(kernels.LAUNCHES)
    key, x = _fold_case("dispatch", 64, "min")
    seg = torch.zeros(64, dtype=torch.int32)
    fold_levels(torch.as_tensor(x), seg, op="min")
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown fold op"):
        fold_levels(torch.as_tensor(x), seg, op="sum")


# ---------------------------------------------------------------------------
# window stats, on a JAX store's state carried across
# ---------------------------------------------------------------------------


def _jax_store(rng, K, N, capacity=128, num_buckets=64, bucket=64):
    """A JAX store with one lane: the reference's ``window_stats_ref``
    stacks a (Q, 1) raw count with (Q, L) stats, so it runs only at L = 1
    (the port's broadcasts the count; multi-lane is checked against the
    port's own query below)."""
    from repro.core import (
        Col, FeatureView, TableSchema, range_window, w_mean, w_sum,
    )
    from repro.core.online import OnlineFeatureStore

    schema = TableSchema(name="tx", key="uid", ts="ts", numeric=("amount",))
    view = FeatureView("v", schema, {
        "s": w_sum(Col("amount"), range_window(600, bucket=bucket)),
        "m": w_mean(Col("amount"), range_window(600, bucket=bucket)),
    })
    store = OnlineFeatureStore(view, num_keys=K, capacity=capacity,
                               num_buckets=num_buckets, bucket_size=bucket)
    key = np.sort(rng.integers(0, K, N)).astype(np.int32)
    ts = rng.integers(0, 4000, N).astype(np.int32)
    order = np.lexsort((ts, key))
    store.ingest(dict(uid=key[order], ts=ts[order],
                      amount=rng.gamma(2.0, 50.0, N).astype(np.float32)))
    return store


def _carried_state(store):
    s = store.state
    arrays = [np.asarray(a) for a in (
        s.ring.ts, s.ring.vals, s.ring.cursor,
        s.bagg.stats, s.bagg.bitmap, s.bagg.bucket)]
    return online_state_from_numpy(arrays, "cpu", bucket_size=64)


def _assert_stats_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i in (1, 2, 3):  # count, min, max: exact
        np.testing.assert_array_equal(_bits(got[..., i]), _bits(want[..., i]))
    for i in (0, 4):     # sum, sumsq: reduction order
        np.testing.assert_allclose(got[..., i], want[..., i],
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("Q,windows", [(16, (600,)), (37, (600, 100)),
                                       (5, (64, 600, 1200))])
def test_window_stats_matches_jax_on_carried_state(Q, windows):
    rng = _rng(f"ws-{Q}-{windows}")
    store = _jax_store(rng, K=9, N=800)
    qk = rng.integers(0, 9, Q).astype(np.int32)
    qt = rng.integers(3000, 4200, Q).astype(np.int32)
    qv = rng.gamma(2.0, 50.0, Q).astype(np.float32)
    qlanes = np.asarray(store._lanes(dict(uid=qk, ts=qt, amount=qv)))
    s = store.state
    want = jax_window_stats(
        s.ring.ts, s.ring.vals, s.bagg.stats, s.bagg.bucket,
        jnp.asarray(qk), jnp.asarray(qt), jnp.asarray(qlanes),
        windows=windows, bucket_size=64, impl="xla",
    )
    st = _carried_state(store)
    got = window_stats(
        st.ring.ts, st.ring.vals, st.bagg.stats, st.bagg.bucket,
        torch.as_tensor(qk), torch.as_tensor(qt), torch.as_tensor(qlanes),
        windows=windows, bucket_size=64,
    )
    assert got.shape == (Q, len(windows), qlanes.shape[1], 5)
    _assert_stats_close(got.numpy(), want)


def test_window_stats_early_timestamps_floor_division():
    """Requests in the first buckets: b_lo = (ts - T) // B is negative and
    empty slots hold TS_EMPTY; floor division keeps them out."""
    rng = _rng("ws-early")
    store = _jax_store(rng, K=5, N=200)
    qk = rng.integers(0, 5, 24).astype(np.int32)
    qt = rng.integers(0, 300, 24).astype(np.int32)
    qlanes = rng.gamma(2.0, 50.0, (24, 1)).astype(np.float32)
    s = store.state
    want = jax_window_stats(
        s.ring.ts, s.ring.vals, s.bagg.stats, s.bagg.bucket,
        jnp.asarray(qk), jnp.asarray(qt), jnp.asarray(qlanes),
        windows=(600, 100), bucket_size=64, impl="xla",
    )
    st = _carried_state(store)
    got = window_stats(
        st.ring.ts, st.ring.vals, st.bagg.stats, st.bagg.bucket,
        torch.as_tensor(qk), torch.as_tensor(qt), torch.as_tensor(qlanes),
        windows=(600, 100), bucket_size=64,
    )
    _assert_stats_close(got.numpy(), want)


def test_window_stats_agrees_with_port_preagg_query():
    """The stats answer the port store's own preagg query, on two lanes:
    SUM within rtol 1e-5 (fold order), COUNT and MAX exactly."""
    from repro_torch.core.expr import (
        Col, range_window, w_count, w_max, w_sum,
    )
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.core.storage import TableSchema
    from repro_torch.core.view import FeatureView

    schema = TableSchema(name="tx", key="uid", ts="ts", numeric=("amount",))
    view = FeatureView("v", schema, {
        "s": w_sum(Col("amount"), range_window(600, bucket=64)),
        "c": w_count(Col("amount"), range_window(600, bucket=64)),
        "mx": w_max(Col("amount"), range_window(1200, bucket=64)),
        "big_mx": w_max(Col("amount") * 2.0, range_window(1200, bucket=64)),
    })
    store = OnlineFeatureStore(view, num_keys=9, capacity=128,
                               num_buckets=64, bucket_size=64, device="cpu")
    rng = _rng("ws-port")
    key = np.sort(rng.integers(0, 9, 800)).astype(np.int32)
    ts = rng.integers(0, 4000, 800).astype(np.int32)
    order = np.lexsort((ts, key))
    store.ingest(dict(uid=key[order], ts=ts[order],
                      amount=rng.gamma(2.0, 50.0, 800).astype(np.float32)))
    q = dict(uid=rng.integers(0, 9, 25).astype(np.int32),
             ts=rng.integers(3000, 4200, 25).astype(np.int32),
             amount=rng.gamma(2.0, 50.0, 25).astype(np.float32))
    res = store.query(q, mode="preagg")
    s = store.state
    cols = store._columns(q)
    stats = window_stats(
        s.ring.ts, s.ring.vals, s.bagg.stats, s.bagg.bucket,
        cols["uid"], cols["ts"], store._lanes(cols),
        windows=(600, 1200), bucket_size=64,
    )
    assert stats.shape == (25, 2, 2, 5)
    lane = store._lane_of[Col("amount").key]
    big = store._lane_of[(Col("amount") * 2.0).key]
    np.testing.assert_allclose(stats[:, 0, lane, 0], res["s"], rtol=1e-5)
    np.testing.assert_array_equal(stats[:, 0, lane, 1], res["c"])
    np.testing.assert_array_equal(stats[:, 0, big, 1], res["c"])
    np.testing.assert_array_equal(stats[:, 1, lane, 3], res["mx"])
    np.testing.assert_array_equal(stats[:, 1, big, 3], res["big_mx"])

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

The fold-levels CUDA kernel cannot run here, so :func:`_emulate_fold`
replays ``kernels/csrc/fold_levels.cu`` in numpy from the wrapper's own
plan (:func:`plan_fold_levels`) at tiny tiles and halos: the tile phase
in "shared memory", the saturated stores, the list of tiles with long
rows and the level-by-level passes over them.  It must write every (level,
row) exactly once and equal ``fold_levels_ref`` bit for bit.
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
from repro_torch.kernels.window_agg.ops import (
    FOLD_HALO,
    FOLD_TILE,
    fold_levels,
    plan_fold_levels,
    window_stats,
)
from repro_torch.kernels.window_agg.ref import (
    NEG_INF,
    POS_INF,
    fold_levels_ref,
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
# the fold-levels kernel's tiles, halos and long rows, replayed in numpy
# ---------------------------------------------------------------------------

_IDENT_BITS = {"min": np.float32(POS_INF).view(np.uint32),
               "max": np.float32(NEG_INF).view(np.uint32),
               "or": np.uint32(0)}


def _combine_bits(op, a, b):
    """The kernel's combine on uint32 bit patterns (min_bits / max_bits:
    order by a's sign, ordered compare, a NaN first-ordered wins)."""
    if op == "or":
        return a | b
    neg = (a >> 31) != 0
    if op == "min":
        nx, ny = np.where(neg, b, a), np.where(neg, a, b)
    else:
        nx, ny = np.where(neg, a, b), np.where(neg, b, a)
    fx, fy = nx.view(np.float32), ny.view(np.float32)
    with np.errstate(invalid="ignore"):
        better = fx < fy if op == "min" else fx > fy
    pick = np.where(better, nx, ny)
    return np.where((nx & 0x7FFFFFFF) > 0x7F800000, nx, pick)


def _in_tile(i, s, k, lo):
    """Row i's level-k window [max(i - 2^k + 1, s), i] starts at or after
    the halo's first row lo (every window does when the halo reaches 0)."""
    return np.full(np.shape(i), lo <= 0) | (np.maximum(i - 2**k + 1, s) >= lo)


def _emulate_fold(x, seg, op, plan):
    """fold_levels.cu in numpy: returns (levels as bit patterns, how often
    each (level, row) was written, the tiles listed as holding long rows)."""
    n = len(x)
    bits = x.view(np.uint32)
    ident = _IDENT_BITS[op]
    L, T, H = plan.levels, plan.tile, plan.halo
    out = np.zeros((L, n), np.uint32)
    writes = np.zeros((L, n), np.int64)

    def store(k, rows, vals, mask):
        out[k, rows[mask]] = vals[mask]
        writes[k, rows[mask]] += 1

    listed = []
    for t in range(plan.tiles):                 # 1. the tile phase
        t0 = t * T
        lo = t0 - H
        g = lo + np.arange(H + min(T, n - t0))  # the tile and its halo
        cur = np.where(g >= 0, bits[np.clip(g, 0, None)], ident)
        sseg = np.where(g >= 0, seg[np.clip(g, 0, None)], 0)
        i, s = g[H:], sseg[H:]
        store(0, i, cur[H:], np.ones(len(i), bool))
        k = 0
        while k + 1 < L:
            if not ((i - s >= 2**k) & _in_tile(i, s, k, lo)).any():
                break                           # saturated or gone
            half = 2**k
            r = np.arange(len(g))
            take = (g - half >= sseg) & (g - half >= 0) & (r >= half)
            cur = _combine_bits(
                op, cur, np.where(take, cur[np.clip(r - half, 0, None)], ident))
            k += 1
            store(k, i, cur[H:], _in_tile(i, s, k, lo))
        sat = _combine_bits(op, cur[H:], ident)
        for kk in range(k + 1, L):
            store(kk, i, sat, _in_tile(i, s, k, lo))
        if (~_in_tile(i, s, L - 1, lo)).any():
            listed.append(t)
    if plan.first_long < L:                     # 2. the long rows
        for k in range(plan.first_long, L):
            prev = out[k - 1].copy()
            for t in listed:
                i = np.arange(t * T, min((t + 1) * T, n))
                s = seg[i]
                j = i - 2**(k - 1)
                b = np.where((j >= s) & (j >= 0), prev[np.clip(j, 0, None)],
                             ident)
                store(k, i, _combine_bits(op, prev[i], b),
                      ~_in_tile(i, s, k, t * T - H))
    return out, writes, listed


def _seg_of(key):
    n = len(key)
    start = np.ones(n, bool)
    start[1:] = key[1:] != key[:-1]
    return np.maximum.accumulate(np.where(start, np.arange(n), 0)).astype(
        np.int32)


def _layout_keys(rng, n, layout):
    if layout == "short":          # segments of 1-3 rows: inside one halo
        return np.cumsum(rng.random(n) < 0.6).astype(np.int32)
    if layout == "halo_edges":     # segments of halo, halo + 1, halo + 2 rows
        return np.repeat(np.arange(n), rng.choice([4, 5, 6], n))[:n]
    if layout == "long":           # segments longer than the halo and tiles
        return np.sort(rng.integers(0, 1 + n // 20, n)).astype(np.int32)
    if layout == "one_segment":
        return np.zeros(n, np.int32)
    return np.arange(n, dtype=np.int32)  # all starts


def test_plan_fold_levels_main_path():
    plan = plan_fold_levels(1 << 24)
    assert (plan.levels, plan.tile, plan.halo) == (25, FOLD_TILE, FOLD_HALO)
    assert plan.tiles == (1 << 24) // FOLD_TILE
    # 2^8 = 256 > halo + 1 = 129: level 8 is the first a row can leave
    assert plan.first_long == 8
    assert plan_fold_levels(5, 8, 4) == (3, 8, 4, 1, 3)
    with pytest.raises(ValueError):
        plan_fold_levels(5, 0, 4)


@pytest.mark.parametrize("op,special", [("min", False), ("max", False),
                                        ("or", False), ("min", True),
                                        ("max", True)])
@pytest.mark.parametrize("layout", ["short", "halo_edges", "long",
                                    "one_segment", "all_starts"])
@pytest.mark.parametrize("n,tile,halo", [(61, 8, 4), (200, 16, 3),
                                         (7, 8, 4), (64, 4, 0)])
def test_fold_kernel_tiles_emulated_bit_exact(op, special, layout, n, tile,
                                              halo):
    """The kernel's tile / halo / saturation logic at tiny tiles (numpy
    replay) equals the plain version bit for bit, every (level, row)
    written once; long rows are listed only where a segment starts
    before a tile's halo.  Special values: NaN payloads of both signs,
    ±0.0 and ±inf, also in segments longer than the halo."""
    rng = _rng(f"emu-{op}-{special}-{layout}-{n}-{tile}-{halo}")
    key = _layout_keys(rng, n, layout)
    seg = _seg_of(key)
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    elif special:
        x = rng.choice(SPECIAL, n)
    else:
        x = rng.normal(size=n).astype(np.float32)
    plan = plan_fold_levels(n, tile, halo)
    got, writes, listed = _emulate_fold(x, seg, op, plan)
    assert (writes == 1).all()
    want = fold_levels_ref(torch.as_tensor(x), torch.as_tensor(seg), op)
    np.testing.assert_array_equal(got.view(np.int32),
                                  _bits(want.numpy()).view(np.int32))
    starts = np.arange(plan.tiles) * tile
    expect = [t for t, t0 in enumerate(starts)
              if t0 > halo and (seg[t0:t0 + tile] < t0 - halo).any()
              and plan.first_long < plan.levels]
    assert sorted(listed) == expect


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

"""Per-spec parity of the aggregator algebra against the JAX package.

For each of the ten aggregates, the same seeded numpy inputs go through
``init``, ``lift``, ``combine``, ``fold_rows``, ``fold_buckets`` (with the
merge-order ``ext`` states for extreme / tail) and ``finalize`` of both
packages' ``AggSpec``.  Every state is held bit for bit: values are
multiples of 1/4, so every float sum is exact whatever order a framework
reduces in.  The finalizes of MEAN / STD / DISTINCT_APPROX (a division,
``sqrt``, ``log1p``) are held to ``rtol = 1e-6``.

The state generator and the monoid properties (associativity, identity)
are copied from the reference's ``tests/test_aggregates.py``, which runs
them on the JAX package; here they run on the port, and each combine is
also compared with JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregates import AGG_SPECS as JAX_SPECS
from repro.core.aggregates import _sort_tail_desc as jax_sort_tail_desc
from repro_torch.core.aggregates import (
    AGG_SPECS,
    LANES,
    NUM_STATS,
    TOPN_TAIL,
    agg_spec,
)
from repro_torch.core.expr import Agg
from torch_deploy_common import jax_families  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("jax_families")

B = 5  # batch shape of generated states


def _jax_spec(agg):
    return {a.value: s for a, s in JAX_SPECS.items()}[agg.value]


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.bool_:
        return a.astype(np.int8)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _np_state(s):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in s.items()}


def _random_states(spec, rng, count):
    """``count`` random valid states of ``spec``, batch shape (B,): the
    reference's generator (integer-valued floats, so f32 adds are exact;
    merge coordinates globally distinct)."""
    if spec.state == "lanes":
        return [{l: rng.integers(-50, 50, B).astype(np.float32)
                 for l in spec.lanes} for _ in range(count)]
    if spec.state == "bitmap":
        return [{"bits": rng.integers(0, 2**31 - 1, B).astype(np.int32)}
                for _ in range(count)]
    if spec.state == "extreme":
        ts = rng.choice(10**6, size=(count, B), replace=False)
        return [{
            "ts": ts[i].astype(np.int32),
            "rank": rng.integers(0, 4, B).astype(np.int32),
            "pos": rng.integers(0, 256, B).astype(np.int32),
            "val": rng.integers(-50, 50, B).astype(np.float32),
            "has": rng.random(B) < 0.8,
        } for i in range(count)]
    # tail: canonical states (entries newest-first, valid-first); widths
    # from a fixed few (empty, short, long enough that three overflow the
    # tail) so JAX compiles each combine shape once
    widths = rng.choice([0, 3, 12], count)
    ts_pool = rng.choice(10**6, size=(int(widths.sum()), B), replace=False)
    out, used = [], 0
    for w in widths:
        w = int(w)
        s = {
            "ts": ts_pool[used:used + w].T.astype(np.int32),
            "rank": rng.integers(0, 4, (B, w)).astype(np.int32),
            "pos": rng.integers(0, 256, (B, w)).astype(np.int32),
            "val": rng.integers(-8, 8, (B, w)).astype(np.float32),
            "valid": np.ones((B, w), bool),
        }
        used += w
        out.append(_np_state(jax_sort_tail_desc(s)))
    return out


def _observed(spec, s):
    """A state's observable fields (those of absent / invalid entries are
    don't-cares), as numpy."""
    s = _np_state(s)
    if spec.state in ("lanes", "bitmap"):
        return s
    flag = "has" if spec.state == "extreme" else "valid"
    m = s[flag]
    return {flag: m, **{k: s[k][m] for k in ("ts", "rank", "pos", "val")}}


def _assert_states(want, got, where):
    want, got = _np_state(want), _np_state(got)
    assert sorted(want) == sorted(got), where
    for k in want:
        a, g = want[k], got[k]
        assert a.shape == g.shape, (where, k, a.shape, g.shape)
        np.testing.assert_array_equal(_bits(a), _bits(g),
                                      err_msg=f"{where} {k}")


def _quarters(rng, shape):
    """Floats that are multiples of 1/4: sums of a few are exact."""
    return (rng.integers(-200, 200, shape) / 4).astype(np.float32)


def _t_state(s):
    return {k: _t(v) for k, v in s.items()}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("agg", list(Agg), ids=lambda a: a.value)
def test_combine_matches_jax_and_is_a_monoid(agg, seed):
    """The reference's ``test_combine_associative`` / ``test_init_identity``
    on the port, and every combine bit for bit against JAX's."""
    spec, jspec = agg_spec(agg), _jax_spec(agg)
    sa, sb, sc = _random_states(spec, np.random.default_rng(1000 * seed + 17),
                                3)
    ta, tb, tc = map(_t_state, (sa, sb, sc))
    ab = spec.combine(ta, tb)
    _assert_states(jspec.combine(sa, sb), ab, "a+b")
    left = spec.combine(ab, tc)
    right = spec.combine(ta, spec.combine(tb, tc))
    _assert_states(jspec.combine(jspec.combine(sa, sb), sc), left, "(a+b)+c")
    _assert_states(_observed(spec, left), _observed(spec, right),
                   "associative")
    (s,) = _random_states(spec, np.random.default_rng(1000 * seed + 29), 1)
    ident = spec.init((B,), torch.device("cpu"))
    _assert_states(jspec.init((B,)), ident, "init")
    for got in (spec.combine(ident, _t_state(s)),
                spec.combine(_t_state(s), ident)):
        _assert_states(_observed(spec, s), _observed(spec, got), "identity")


@pytest.mark.parametrize("agg", list(Agg), ids=lambda a: a.value)
def test_lift_and_finalize_match_jax(agg):
    spec, jspec = agg_spec(agg), _jax_spec(agg)
    rng = np.random.default_rng(3)
    val = _quarters(rng, B)
    ts = rng.integers(0, 10**6, B).astype(np.int32)
    want = jspec.lift(val, ts, np.int32(2), np.int32(2147483647))
    got = spec.lift(_t(val), _t(ts), 2, 2147483647)
    _assert_states(want, got, "lift")
    states = [s for s in _random_states(spec, rng, 4)
              if spec.state != "tail" or s["ts"].shape[-1]]  # lift: >= 1
    for i, s in enumerate(states):
        for n in ((0, 1, 2) if agg == Agg.TOPN_FREQ else (0,)):
            a = np.asarray(jspec.finalize(s, n=n))
            g = spec.finalize(_t_state(s), n=n).numpy()
            if agg in (Agg.MEAN, Agg.STD, Agg.DISTINCT_APPROX):
                np.testing.assert_allclose(g, a, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(_bits(a), _bits(g),
                                              err_msg=f"state {i} n={n}")
    if agg == Agg.TOPN_FREQ:
        # n past the tail's width reads its last entry (JAX's clamped
        # gather), in JAX and in the port alike
        s = {"val": np.array([[1.0, 2.0], [3.0, 3.0]], np.float32),
             "valid": np.ones((2, 2), bool)}
        for n in (2, 5):
            a = np.asarray(jspec.finalize(s, n=n))
            g = spec.finalize(_t_state(s), n=n).numpy()
            np.testing.assert_array_equal(_bits(a), _bits(g), err_msg=n)


@pytest.mark.parametrize("agg", list(Agg), ids=lambda a: a.value)
def test_fold_rows_matches_jax(agg):
    """One ring buffer's masked rows (Q, C) folded into a state: ties on
    ts, rows with nothing in the window, C above and below the tail."""
    spec, jspec = agg_spec(agg), _jax_spec(agg)
    rng = np.random.default_rng(11)
    for Q, C in ((6, 48), (4, 9)):
        g = _quarters(rng, (Q, C))
        ts = np.sort(rng.integers(0, C, (Q, C)), axis=1).astype(np.int32)
        mask = rng.random((Q, C)) < 0.6
        mask[0] = False
        want = jspec.fold_rows(g, ts, mask, jnp.int32(1))
        got = spec.fold_rows(_t(g), _t(ts), _t(mask), 1)
        _assert_states(want, got, f"C={C}")


@pytest.mark.parametrize("agg", list(Agg), ids=lambda a: a.value)
def test_fold_buckets_matches_jax(agg):
    """Gathered bucket states (Q, M) folded into a state; extreme / tail
    read the persisted merge-order states (``ext``), with ties on ts
    across buckets broken by pos, invalid buckets and empty entries."""
    spec, jspec = agg_spec(agg), _jax_spec(agg)
    rng = np.random.default_rng(13)
    Q, M, T = 6, 8, TOPN_TAIL
    stats = _quarters(rng, (Q, M, NUM_STATS))
    stats[..., LANES.index("count")] = rng.integers(0, 9, (Q, M))
    bitmap = rng.integers(0, 2**31 - 1, (Q, M)).astype(np.int32)
    ok = rng.random((Q, M)) < 0.7
    ok[0] = False
    ext = None
    if spec.state == "extreme":
        has = rng.random((Q, M, 2)) < 0.8
        ext = {
            "ts": np.where(has, rng.integers(0, 40, (Q, M, 2)),
                           -2**31).astype(np.int32),
            "pos": np.where(has, rng.permutation(Q * M * 2).reshape(Q, M, 2),
                            0).astype(np.int32),
            "val": np.where(has, rng.integers(-9, 9, (Q, M, 2)),
                            0).astype(np.float32),
            "has": has,
        }
    elif spec.state == "tail":
        valid = np.sort(rng.random((Q, M, T)) < 0.5, axis=-1)[..., ::-1]
        ts = -np.sort(-rng.integers(0, 400, (Q, M, T)), axis=-1)
        ext = {
            "ts": np.where(valid, ts, -2**31).astype(np.int32),
            "pos": np.where(valid, rng.integers(0, 999, (Q, M, T)),
                            0).astype(np.int32),
            "val": np.where(valid, rng.integers(0, 6, (Q, M, T)),
                            0).astype(np.float32),
            "valid": np.ascontiguousarray(valid),
        }
    want = jspec.fold_buckets(stats, bitmap, ok, ext=ext, rank=jnp.int32(2))
    got = spec.fold_buckets(
        _t(stats), _t(bitmap), _t(ok),
        ext=None if ext is None else _t_state(ext), rank=2)
    _assert_states(want, got, "fold_buckets")
    if spec.state in ("extreme", "tail"):
        with pytest.raises(ValueError, match="extreme/tail"):
            spec.fold_buckets(_t(stats), _t(bitmap), _t(ok))


def test_registry_matches_jax():
    assert [a.value for a in AGG_SPECS] == [a.value for a in JAX_SPECS]
    for agg, spec in AGG_SPECS.items():
        j = _jax_spec(agg)
        assert (spec.state, spec.lanes, spec.newest, spec.union_composable,
                spec.bucket_composable) == (
            j.state, j.lanes, j.newest, j.union_composable,
            j.bucket_composable), agg

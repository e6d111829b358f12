"""The port's fused ingest against the JAX reference, bit for bit.

* The plain version (``fused_ingest`` on CPU tensors = ring scatter +
  bucket merge) equals JAX ``fused_ingest(..., impl="xla")`` on all six
  state arrays over sequential batches: a key with more than C rows in
  one batch, bucket-slot reuse (stale reset), trailing and leading pads,
  an all-pad batch, a hot key over several buckets.  Floats compare as
  int32 bit patterns.
* The CUDA kernel cannot run here, so :func:`_emulate_kernel` replays
  ``kernels/csrc/fused_ingest.cu`` in numpy: row by row (the kernel's
  threads of one row share its control flow), the owner of each key run
  found from the batch alone, runs shorter than ``SHORT_RUN`` applied by
  their owner and longer ones by its "warp" (the 32-way end search of
  :func:`_warp_find_end`).  It must equal the plain
  version bit for bit, write each key's cursor once per run and
  min(C, run) ring slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import preagg as jax_pg
from repro.core import storage as jax_st
from repro.kernels.ingest.ops import fused_ingest as jax_fused_ingest
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.aggregates import row_bitmap
from repro_torch.kernels.ingest.ops import SHORT_RUN, fused_ingest

K, C, F, NB, BS = 7, 16, 3, 8, 50
CPU = torch.device("cpu")

# (rows, ts lo, ts hi, pad rows, rows forced onto key 2, leading pads)
BATCHES = [
    (20, 0, 300, 12, 0, 0),
    (15, 250, 380, 1, 0, 0),
    (60, 700, 720, 4, 40, 0),     # key 2: 40 rows > C = 16
    (12, 1100, 1200, 4, 0, 0),    # slots of buckets 14..17 reused: stale
    (0, 0, 0, 16, 0, 0),          # all pads
    (10, 1200, 1300, 6, 0, 3),    # leading pads
    (80, 2000, 2300, 2, 70, 0),   # key 2: 70 rows over 6 buckets, its warp
]


def _jax_state():
    r = jax_st.ring_init(K, C, F)
    b = jax_pg.bucket_init(K, NB, F, BS)
    return (r.ts, r.vals, r.cursor, b.stats, b.bitmap, b.bucket)


def _state():
    r = st.ring_init(K, C, F, CPU)
    b = pg.bucket_init(K, NB, F, BS, CPU)
    return [r.ts, r.vals, r.cursor, b.stats, b.bitmap, b.bucket]


def _batch(rng, n, lo, hi, pad, hot, lead):
    key = np.sort(rng.integers(0, K, n)).astype(np.int32)
    key[:hot] = 2
    ts = rng.integers(lo, hi, n).astype(np.int32) if n else np.zeros(0, np.int32)
    o = np.lexsort((ts, key))
    key, ts = key[o], ts[o]
    vals = rng.normal(size=(n, F)).astype(np.float32) * 50
    t_pad = ts[-1] if n else 500
    key = np.concatenate([key, np.full(pad, K, np.int32)])
    ts = np.concatenate([ts, np.full(pad, t_pad, np.int32)])
    vals = np.concatenate([vals, np.zeros((pad, F), np.float32)])
    if lead:
        key = np.roll(key, lead)
        ts = np.roll(ts, lead)
        vals = np.roll(vals, lead, axis=0)
    return key, ts, vals


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_plain_version_matches_jax_bit_exact():
    rng = np.random.default_rng(0)
    js, ts_ = _jax_state(), _state()
    for step, spec in enumerate(BATCHES):
        k, t, v = _batch(rng, *spec)
        js = jax_fused_ingest(*js, jnp.asarray(k), jnp.asarray(t),
                              jnp.asarray(v), bucket_size=BS, impl="xla")
        fused_ingest(*ts_, torch.from_numpy(k), torch.from_numpy(t),
                     torch.from_numpy(v), bucket_size=BS)
        for i, (a, b) in enumerate(zip(js, ts_)):
            np.testing.assert_array_equal(
                _bits(a), _bits(b.numpy()), err_msg=f"step {step} array {i}"
            )


def _warp_find_end(lo, hi, pred):
    """fused_ingest.cu's warp_find_end: the first row after ``lo`` where
    ``pred`` (true at lo, then monotone) turns false, or ``hi``; a round
    is 32 lanes' probes and a ballot."""
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        probes = [lo + step * (lane + 1) for lane in range(32)]
        lo += step * sum(p < hi and pred(p) for p in probes)
        hi = min(hi, lo + step)
    return hi


def _emulate_kernel(state, key, ts, vals):
    """numpy replay of fused_ingest.cu, reading only the batch and the
    state.  Runs own disjoint state, so their order is free.  Returns the
    six arrays and, per key, the cursor writes and ring-slot writes."""
    rts, rv, cur, bst, bbm, bid = (x.numpy().copy() for x in state)
    bm_rows = row_bitmap(torch.from_numpy(vals)).numpy()
    bucket = np.floor_divide(ts, BS)
    f32 = np.float32
    n = len(key)
    cursor_writes, ring_writes = np.zeros(K, int), np.zeros(K, int)

    def apply_run(k, s, e, warp):
        cur0 = int(cur[k])
        cur[k] = np.int32(cur0 + (e - s))
        cursor_writes[k] += 1
        for j in range(max(s, e - C), e):
            slot = (cur0 + j - s) % C
            rts[k, slot], rv[k, slot] = ts[j], vals[j]
            ring_writes[k] += 1
        b0 = s
        while b0 < e:
            b = bucket[b0]
            if warp:
                b1 = _warp_find_end(b0, e, lambda j: bucket[j] == b)
            else:
                b1 = b0 + 1
                while b1 < e and bucket[b1] == b:
                    b1 += 1
            sl = b % NB
            stale = bid[k, sl] != b and bid[k, sl] != -1
            for f in range(F):
                s_, c, mn, mx, sq, bm = (f32(0), f32(0), f32(3e38),
                                         f32(-3e38), f32(0), 0)
                for j in range(b0, b1):  # row order: the float sums' order
                    x = vals[j, f]
                    s_, c = f32(s_ + x), f32(c + f32(1))
                    mn, mx = min(mn, x), max(mx, x)
                    sq = f32(sq + f32(x * x))
                    bm |= int(bm_rows[j, f])
                base = ([f32(0), f32(0), f32(3e38), f32(-3e38), f32(0)]
                        if stale else list(bst[k, sl, f]))
                bst[k, sl, f] = [f32(base[0] + s_), f32(base[1] + c),
                                 min(base[2], mn), max(base[3], mx),
                                 f32(base[4] + sq)]
                # python ints OR like int32 bit patterns (two's complement)
                bbm[k, sl, f] = np.int32((0 if stale else int(bbm[k, sl, f]))
                                         | bm)
            bid[k, sl] = b
            b0 = b1

    for i in range(n):  # row by row; the run's owner acts
        k = int(key[i])
        if not (0 <= k < K and (i == 0 or key[i - 1] != k)):
            continue
        lim, e = min(n, i + SHORT_RUN), i + 1
        while e < lim and key[e] == k:
            e += 1
        warp = e == i + SHORT_RUN and e < n and key[e] == k
        if warp:
            e = _warp_find_end(i + SHORT_RUN, n, lambda j: key[j] == k)
        apply_run(k, i, e, warp)
    arrays = [torch.from_numpy(x) for x in (rts, rv, cur, bst, bbm, bid)]
    return arrays, cursor_writes, ring_writes


def test_plan_free_kernel_logic_matches_plain_version():
    rng = np.random.default_rng(1)
    ref, emu = _state(), _state()
    for step, spec in enumerate(BATCHES):
        k, t, v = _batch(rng, *spec)
        fused_ingest(*ref, torch.from_numpy(k), torch.from_numpy(t),
                     torch.from_numpy(v), bucket_size=BS)
        emu, _, _ = _emulate_kernel(emu, k, t, v)
        for i, (a, b) in enumerate(zip(ref, emu)):
            np.testing.assert_array_equal(
                _bits(a.numpy()), _bits(b.numpy()),
                err_msg=f"step {step} array {i}",
            )


@pytest.mark.parametrize("n,hot,lead", [(40, 20, 0), (70, 45, 3),
                                        (120, 100, 0), (9, 0, 2)])
def test_kernel_run_logic_one_cursor_write_per_key_run(n, hot, lead):
    """One cursor write per key run, min(C, run) ring writes per run;
    pads write nothing."""
    rng = np.random.default_rng(2 + n)
    k, t, v = _batch(rng, n, 0, 300, 8, hot, lead)
    _, cursor_writes, ring_writes = _emulate_kernel(_state(), k, t, v)
    real = k[k < K]
    keys, runs = np.unique(real, return_counts=True)
    want_cursor, want_ring = np.zeros(K, int), np.zeros(K, int)
    want_cursor[keys] = 1
    want_ring[keys] = np.minimum(C, runs)
    np.testing.assert_array_equal(cursor_writes, want_cursor)
    np.testing.assert_array_equal(ring_writes, want_ring)


@pytest.mark.parametrize("lo,length,hi", [(0, 1, 1), (0, 1, 2), (5, 33, 40),
                                          (0, 1000, 1000), (7, 1025, 5000),
                                          (3, 64, 100_000)])
def test_warp_find_end_matches_a_scan(lo, length, hi):
    """The warp's 32-way search returns the first row where a monotone
    predicate turns false, or hi."""
    end = lo + length
    assert _warp_find_end(lo, hi, lambda j: j < end) == min(end, hi)

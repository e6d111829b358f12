"""The port's fused ingest against the JAX reference, bit for bit.

* The plain version (``fused_ingest`` on CPU tensors = ring scatter +
  bucket merge) equals JAX ``fused_ingest(..., impl="xla")`` on all six
  state arrays over sequential batches: a key with more than C rows in
  one batch, bucket-slot reuse (stale reset), trailing and leading pads,
  an all-pad batch.  Floats compare as int32 bit patterns.
* The CUDA kernel cannot run here, so :func:`_emulate_kernel` replays its
  per-(row, lane) logic from ``kernels/csrc/fused_ingest.cu`` in numpy,
  driven by the same device plan (:func:`ingest_plan`) the kernel reads,
  and must equal the plain version bit for bit — this checks the plan
  the kernel relies on (ring-write and cursor-write flags, segment
  walkers, stale flags).
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
from repro_torch.kernels.ingest.ops import PLAN_ROWS, fused_ingest, ingest_plan

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


def _emulate_kernel(state, key, ts, vals):
    """numpy replay of fused_ingest.cu: one (row, lane) 'thread' at a time,
    reading only the plan (writes never collide, so order is free)."""
    rts, rv, cur, bst, bbm, bid = (x.numpy().copy() for x in state)
    plan = ingest_plan(
        torch.from_numpy(key), torch.from_numpy(ts), state[2], state[5],
        capacity=C, bucket_size=BS,
    ).numpy()
    P = {name: plan[i] for i, name in enumerate(PLAN_ROWS)}
    bm_rows = row_bitmap(torch.from_numpy(vals)).numpy()
    f32 = np.float32
    n = len(key)
    for i in range(n):
        k = P["ckey"][i]
        for f in range(F):
            if P["ring_w"][i]:
                rv[k, P["slot_r"][i], f] = vals[i, f]
                if f == 0:
                    rts[k, P["slot_r"][i]] = ts[i]
            if f == 0 and P["kend"][i]:
                cur[k] = P["cur_new"][i]
            if not P["walk"][i]:
                continue
            s, c, mn, mx, sq, bm = f32(0), f32(0), f32(3e38), f32(-3e38), f32(0), 0
            for j in range(i, n):
                if j > i and P["sstart"][j]:
                    break
                if P["valid"][j]:
                    x = vals[j, f]
                    s, c = f32(s + x), f32(c + f32(1))
                    mn, mx = min(mn, x), max(mx, x)
                    sq = f32(sq + f32(x * x))
                    bm |= int(bm_rows[j, f])
            sl, stale = P["slot_b"][i], P["stale"][i]
            base = ([f32(0), f32(0), f32(3e38), f32(-3e38), f32(0)]
                    if stale else list(bst[k, sl, f]))
            bst[k, sl, f] = [f32(base[0] + s), f32(base[1] + c),
                             min(base[2], mn), max(base[3], mx),
                             f32(base[4] + sq)]
            # python ints OR like int32 bit patterns (two's complement)
            bbm[k, sl, f] = np.int32((0 if stale else int(bbm[k, sl, f])) | bm)
            if f == 0:
                bid[k, sl] = P["cbid"][i]
    return [torch.from_numpy(x) for x in (rts, rv, cur, bst, bbm, bid)]


def test_kernel_logic_from_plan_matches_plain_version():
    rng = np.random.default_rng(1)
    ref, emu = _state(), _state()
    for step, spec in enumerate(BATCHES):
        k, t, v = _batch(rng, *spec)
        fused_ingest(*ref, torch.from_numpy(k), torch.from_numpy(t),
                     torch.from_numpy(v), bucket_size=BS)
        emu = _emulate_kernel(emu, k, t, v)
        for i, (a, b) in enumerate(zip(ref, emu)):
            np.testing.assert_array_equal(
                _bits(a.numpy()), _bits(b.numpy()),
                err_msg=f"step {step} array {i}",
            )


def test_plan_marks_one_cursor_write_per_key_run():
    rng = np.random.default_rng(2)
    k, t, v = _batch(rng, 40, 0, 200, 8, 20, 0)
    s = _state()
    plan = ingest_plan(torch.from_numpy(k), torch.from_numpy(t), s[2], s[5],
                       capacity=C, bucket_size=BS)
    P = {name: plan[i].numpy() for i, name in enumerate(PLAN_ROWS)}
    real = k[k < K]
    assert P["kend"].sum() == len(np.unique(real))
    assert P["ring_w"].sum() == sum(min(C, (real == u).sum()) for u in np.unique(real))
    assert (P["valid"] == (k < K)).all()

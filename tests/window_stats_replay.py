"""A numpy replay of the window-stats CUDA kernel
(``src/repro_torch/kernels/csrc/window_stats.cu``), written the way the
kernel is written, so the CPU tests can hold its arithmetic to the JAX
package and the card tests can hold the kernel's sums to it bit for bit.

Per request, one warp: lane i takes the 16-byte vectors v = i, i + 32, ...
of the key's ring timestamps and of its bucket ids, vector v holding slots
4v .. 4v + 3.  A lane folds, in that slot order, the raw rows of every
window (``raw_mask``) into its raw accumulators and the bucket slots whose
id is a middle bucket of a window (``mid_mask``, over all NB slots) into
its middle accumulators: float32 adds rounded one at a time, ``g * g``
rounded before it is added.  Across the 32 lanes the sums reduce by the
butterfly ``v_i = v_i + v_(i ^ off)``, off = 16 .. 1; counts as integers;
min and max as order-preserving int32 keys (``-0.0`` below ``+0.0``), or,
with a NaN in some lane, by a butterfly of the plain version's selects
(lower lane first).  Then ``(raw + q) + middle`` per (window, lane).  A
group no lane touched holds its identity, which the butterfly keeps, so
the kernel's skipping of such groups needs no replay; nor does its
cutting of many windows or lanes into launches (every (window, lane)
accumulates on its own).
"""

import numpy as np

TS_EMPTY = -(2 ** 31)
ID_NONE = -(2 ** 31)
POS_INF = np.float32(3.0e38)
NEG_INF = np.float32(-3.0e38)
LANES = 32
f32 = np.float32


def _floordiv(a: int, b: int) -> int:
    return a // b  # Python's // floors, as the kernel's floordiv


def _wrap(x: int) -> int:
    """x as int32 (two's complement wrap)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _isnan_bits(u):
    return (u & 0x7FFFFFFF) > 0x7F800000


def fmin_ref(a, b):
    """``fmin_ref`` of the kernel (jnp.minimum's select order), elementwise
    on float32 arrays."""
    ua, ub = np.asarray(a, f32).view(np.uint32), np.asarray(b, f32).view(np.uint32)
    neg = (ua >> 31) != 0
    nx = np.where(neg, ub, ua)
    ny = np.where(neg, ua, ub)
    pick = np.where(nx.view(f32) < ny.view(f32), nx, ny)
    return np.where(_isnan_bits(nx), nx, pick).astype(np.uint32).view(f32)


def fmax_ref(a, b):
    ua, ub = np.asarray(a, f32).view(np.uint32), np.asarray(b, f32).view(np.uint32)
    neg = (ua >> 31) != 0
    nx = np.where(neg, ua, ub)
    ny = np.where(neg, ub, ua)
    pick = np.where(nx.view(f32) > ny.view(f32), nx, ny)
    return np.where(_isnan_bits(nx), nx, pick).astype(np.uint32).view(f32)


def _order_key(v):
    i = np.asarray(v, f32).view(np.int32)
    return np.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _from_key(k):
    k = np.asarray(k, np.int32)
    return np.where(k >= 0, k, k ^ 0x7FFFFFFF).astype(np.int32).view(f32)


def warp_sum(v):
    """The butterfly over axis 0 (32 lanes): every lane ends with the same
    value; lane 0's is returned."""
    v = np.asarray(v, f32).copy()
    idx = np.arange(LANES)
    off = 16
    while off:
        v = (v + v[idx ^ off]).astype(f32)
        off >>= 1
    return v[0]


def _warp_select(v, fn):
    v = np.asarray(v, f32).copy()
    idx = np.arange(LANES)
    off = 16
    while off:
        o = v[idx ^ off]
        hi = ((idx & off) != 0).reshape((LANES,) + (1,) * (v.ndim - 1))
        v = fn(np.where(hi, o, v), np.where(hi, v, o))
        off >>= 1
    return v[0]


def warp_min(v):
    v = np.asarray(v, f32)
    if _isnan_bits(v.view(np.uint32)).any():
        return _warp_select(v, fmin_ref)
    return _from_key(_order_key(v).min(axis=0))


def warp_max(v):
    v = np.asarray(v, f32)
    if _isnan_bits(v.view(np.uint32)).any():
        return _warp_select(v, fmax_ref)
    return _from_key(_order_key(v).max(axis=0))


def _slots(n: int):
    """(rounds, 32) slot index a lane reads in each step of its pass, -1
    past the end: step (k, j) is slot 4 (lane + 32 k) + j."""
    nvec = -(-n // 4)
    rounds = max(1, -(-nvec // LANES))
    lane = np.arange(LANES)
    out = []
    for k in range(rounds):
        v = lane + LANES * k
        for j in range(4):
            s = 4 * v + j
            out.append(np.where((v < nvec) & (s < n), s, -1))
    return out


def replay_window_stats(ring_ts, ring_lanes, bstats, bids, q_key, q_ts,
                        q_lanes, windows, bucket_size):
    """(Q, NW, L, 5) float32, bit for bit what the kernel writes (numpy
    inputs: (K, C) int32, (K, C, L) f32, (K, NB, L, 5) f32, (K, NB) int32,
    (Q,) int32, (Q,) int32, (Q, L) f32)."""
    ring_ts = np.asarray(ring_ts, np.int32)
    ring_lanes = np.asarray(ring_lanes, f32)
    bstats = np.asarray(bstats, f32)
    bids = np.asarray(bids, np.int32)
    q_lanes = np.asarray(q_lanes, f32)
    K, C = ring_ts.shape
    NB = bids.shape[1]
    L = ring_lanes.shape[-1]
    NW = len(windows)
    B = int(bucket_size)
    ring_slots, id_slots = _slots(C), _slots(NB)
    out = np.empty((len(q_key), NW, L, 5), f32)
    for q, (key, ts_q) in enumerate(zip(np.asarray(q_key), np.asarray(q_ts))):
        key, ts_q = int(key), int(ts_q)
        b_q = _floordiv(ts_q, B)
        d = [_wrap(ts_q - int(T)) for T in windows]
        lo = [_wrap(x + 1) for x in d]
        b_lo = [_floordiv(x, B) for x in d]
        rcnt = np.zeros((LANES, NW), np.int64)
        rsum = np.zeros((LANES, NW, L), f32)
        rsq = np.zeros((LANES, NW, L), f32)
        rmin = np.full((LANES, NW, L), POS_INF, f32)
        rmax = np.full((LANES, NW, L), NEG_INF, f32)
        msum = np.zeros((LANES, NW, L), f32)
        mcnt = np.zeros((LANES, NW, L), f32)
        msq = np.zeros((LANES, NW, L), f32)
        mmin = np.full((LANES, NW, L), POS_INF, f32)
        mmax = np.full((LANES, NW, L), NEG_INF, f32)

        for slot in ring_slots:
            ts = np.where(slot >= 0, ring_ts[key, np.maximum(slot, 0)],
                          TS_EMPTY).astype(np.int64)
            live = (ts != TS_EMPTY) & (ts <= ts_q)
            tail = ts >= b_q * B
            g = ring_lanes[key, np.maximum(slot, 0)]  # (32, L)
            for w in range(NW):
                head = (b_lo[w] != b_q) & (ts >= b_lo[w] * B) \
                    & (ts < b_lo[w] * B + B)
                m = (live & (ts >= lo[w]) & (tail | head))[:, None]
                rcnt[:, w] += m[:, 0]
                rsum[:, w] = np.where(m, rsum[:, w] + g, rsum[:, w])
                rmin[:, w] = np.where(m, fmin_ref(rmin[:, w], g), rmin[:, w])
                rmax[:, w] = np.where(m, fmax_ref(rmax[:, w], g), rmax[:, w])
                rsq[:, w] = np.where(m, rsq[:, w] + (g * g).astype(f32),
                                     rsq[:, w])
        for slot in id_slots:
            ids = np.where(slot >= 0, bids[key, np.maximum(slot, 0)],
                           ID_NONE).astype(np.int64)
            x = bstats[key, np.maximum(slot, 0)]  # (32, L, 5)
            for w in range(NW):
                m = ((ids > b_lo[w]) & (ids < b_q))[:, None]
                msum[:, w] = np.where(m, msum[:, w] + x[..., 0], msum[:, w])
                mcnt[:, w] = np.where(m, mcnt[:, w] + x[..., 1], mcnt[:, w])
                mmin[:, w] = np.where(m, fmin_ref(mmin[:, w], x[..., 2]),
                                      mmin[:, w])
                mmax[:, w] = np.where(m, fmax_ref(mmax[:, w], x[..., 3]),
                                      mmax[:, w])
                msq[:, w] = np.where(m, msq[:, w] + x[..., 4], msq[:, w])

        ql = q_lanes[q]
        for w in range(NW):
            rc = f32(rcnt[:, w].sum())
            for l in range(L):
                r0, r4 = warp_sum(rsum[:, w, l]), warp_sum(rsq[:, w, l])
                r2, r3 = warp_min(rmin[:, w, l]), warp_max(rmax[:, w, l])
                m0, m1 = warp_sum(msum[:, w, l]), warp_sum(mcnt[:, w, l])
                m4 = warp_sum(msq[:, w, l])
                m2, m3 = warp_min(mmin[:, w, l]), warp_max(mmax[:, w, l])
                out[q, w, l] = [
                    f32(f32(r0 + ql[l]) + m0),
                    f32(f32(rc + f32(1.0)) + m1),
                    fmin_ref(fmin_ref(r2, ql[l]), m2),
                    fmax_ref(fmax_ref(r3, ql[l]), m3),
                    f32(f32(r4 + f32(ql[l] * ql[l])) + m4),
                ]
    return out

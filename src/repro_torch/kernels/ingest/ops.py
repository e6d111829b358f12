"""Dispatcher for the fused ingest kernel.

``fused_ingest(...)`` applies one (key, ts)-sorted ingest batch to the six
primary-store state arrays in place — ring scatter (lane writes + cursor
advance) AND bucket pre-agg merge.  CUDA tensors launch the hand-written
kernel (``kernels/csrc/fused_ingest.cu``); CPU tensors run the split
plain version (:mod:`.ref`).  Both give the same bits.

The kernel is driven by an (11, N) int32 *plan* that :func:`ingest_plan`
computes here in plain PyTorch on the device, with no host
synchronization (no ``nonzero``, ``.item()`` or ``bool()``): run
boundaries by forward / backward fill over flagged indices (``cummax``),
within-run counts by a cumsum minus its value at the run start, and
"segment holds a valid row" by an integer ``scatter_reduce(amax)``.  The
plan is what lets the kernel run with one thread per (row, lane) and no
block-to-block ordering: each thread reads its row's ring slot, whether
it writes, and whether it walks a segment, from the plan.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.ingest.ref import fused_ingest_ref

__all__ = ["PLAN_ROWS", "ingest_plan", "fused_ingest", "launch_fused_ingest"]

# row order of the (11, N) plan; kernels/csrc/fused_ingest.cu reads the
# same order (P_CKEY .. P_STALE)
PLAN_ROWS = (
    "ckey",     # key of the row's run; pads take a neighbouring real key
    "valid",    # 1 for real rows, 0 for pads (key == K)
    "sstart",   # 1 on the first row of each (key, bucket) segment
    "walk",     # sstart and the segment holds >= 1 valid row
    "slot_r",   # ring slot (cursor0[key] + rank in run) % C
    "ring_w",   # 1 if the row writes the ring: valid, among its run's last C
    "kend",     # 1 on the last valid row of a key run (writes the cursor)
    "cur_new",  # cursor0[key] + valid rows in the run
    "cbid",     # absolute bucket id ts // bucket_size (pads filled)
    "slot_b",   # bucket slot cbid % NB
    "stale",    # the slot holds another bucket's id: reset before merging
)


def _fill_index(valid: torch.Tensor, forward: bool) -> torch.Tensor:
    """Index of the nearest valid row at or before (``forward``) / at or
    after each row, or -1 where there is none (a cummax over flagged
    indices)."""
    n = valid.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=valid.device)
    if forward:
        return torch.cummax(torch.where(valid, idx, -1), 0).values
    rev = torch.cummax(torch.where(valid.flip(0), idx, -1), 0).values.flip(0)
    return torch.where(rev >= 0, n - 1 - rev, -1)


def ingest_plan(
    key: torch.Tensor,      # (N,) int32, (key, ts)-sorted, pad key == K
    ts: torch.Tensor,       # (N,) int32
    cursor: torch.Tensor,   # (K,) int32
    bbucket: torch.Tensor,  # (K, NB) int32
    *,
    capacity: int,
    bucket_size: int,
) -> torch.Tensor:
    """The (11, N) int32 plan of one batch (rows in :data:`PLAN_ROWS`)."""
    num_keys, num_buckets = bbucket.shape
    n = key.shape[0]
    dev = key.device
    valid = key < num_keys
    bid_raw = torch.div(ts, bucket_size, rounding_mode="floor")
    kz = torch.where(valid, key, 0)
    bz = torch.where(valid, bid_raw, 0)
    # pads inherit the nearest real row's (key, bucket): forward fill, then
    # backward fill for leading pads
    fi = _fill_index(valid, forward=True)
    bi = _fill_index(valid, forward=False)
    src = torch.where(fi >= 0, fi, torch.clamp(bi, min=0)).long()
    ckey = kz[src]
    cbid = bz[src]

    first = torch.ones(1, dtype=torch.bool, device=dev)
    kchange = torch.cat([first, ckey[1:] != ckey[:-1]])
    sstart = kchange | torch.cat([first, cbid[1:] != cbid[:-1]])
    seg_id = (torch.cumsum(sstart, 0, dtype=torch.int32) - 1).long()
    vi = valid.to(torch.int32)
    seg_has_valid = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg_id, vi, reduce="amax"
    )
    walk = sstart & (seg_has_valid[seg_id] == 1)

    # valid rows counted within each key run (inclusive), and per run total
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    run_start = torch.cummax(torch.where(kchange, idx, 0), 0).values.long()
    cs = torch.cumsum(vi, 0, dtype=torch.int32)
    cnt = cs - (cs - vi)[run_start]
    run_id = (torch.cumsum(kchange, 0, dtype=torch.int32) - 1).long()
    total = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce(
        0, run_id, cnt, reduce="amax"
    )[run_id]

    ck = ckey.long()
    cur0 = cursor[ck]
    slot_r = (cur0 + cnt - 1) % capacity
    ring_w = valid & (cnt > total - capacity)
    kend = valid & (cnt == total)
    slot_b = cbid % num_buckets
    stored = bbucket[ck, slot_b.long()]
    stale = (stored != cbid) & (stored != -1)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return torch.stack([
        i32(ckey), i32(valid), i32(sstart), i32(walk), i32(slot_r),
        i32(ring_w), i32(kend), i32(cur0 + total), i32(cbid), i32(slot_b),
        i32(stale),
    ])


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"fused_ingest: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_ingest: {name} shape {tuple(t.shape)} != {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_ingest: {name} must be contiguous")


_argtypes_set = False


def launch_fused_ingest(
    ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket, ts, vals,
    plan: torch.Tensor,
) -> None:
    """Launch the CUDA kernel on prepared inputs (checked by the caller):
    one thread per (row, lane), on the current stream, allocating nothing.
    Raises if the launch reports an error."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    lib = library("fused_ingest")
    fn = lib.fused_ingest_launch
    if not _argtypes_set:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _argtypes_set = True
    K, C = ring_ts.shape
    n, F = vals.shape
    dev = ring_ts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        ring_ts.data_ptr(), ring_vals.data_ptr(), cursor.data_ptr(),
        bstats.data_ptr(), bbitmap.data_ptr(), bbucket.data_ptr(),
        ts.data_ptr(), vals.data_ptr(), plan.data_ptr(),
        n, F, C, bbucket.shape[1], K, dev.index, stream,
    )
    count_launch("fused_ingest")
    if err != 0:
        raise RuntimeError(f"fused_ingest kernel launch failed: CUDA error {err}")


def fused_ingest(
    ring_ts: torch.Tensor,    # (K, C) int32
    ring_vals: torch.Tensor,  # (K, C, F) f32
    cursor: torch.Tensor,     # (K,) int32
    bstats: torch.Tensor,     # (K, NB, F, NUM_STATS) f32
    bbitmap: torch.Tensor,    # (K, NB, F) int32
    bbucket: torch.Tensor,    # (K, NB) int32
    key: torch.Tensor,        # (N,) int32 sorted by (key, ts); pad key == K
    ts: torch.Tensor,         # (N,) int32
    vals: torch.Tensor,       # (N, F) f32
    *,
    bucket_size: int,
) -> Tuple[torch.Tensor, ...]:
    """Apply one batch to the six state arrays in place; returns them."""
    state = (ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket)
    if not use_cuda_kernel("fused_ingest", *state, key, ts, vals):
        note_dispatch("fused_ingest", "ref")
        return fused_ingest_ref(
            *state, key, ts, vals, bucket_size=bucket_size
        )
    note_dispatch("fused_ingest", "cuda")
    K, C = ring_ts.shape
    n = key.shape[0]
    F = ring_vals.shape[2]
    NB = bbucket.shape[1]
    _check("ring_ts", ring_ts, torch.int32, (K, C))
    _check("ring_vals", ring_vals, torch.float32, (K, C, F))
    _check("cursor", cursor, torch.int32, (K,))
    _check("bstats", bstats, torch.float32, (K, NB, F, 5))
    _check("bbitmap", bbitmap, torch.int32, (K, NB, F))
    _check("bbucket", bbucket, torch.int32, (K, NB))
    _check("key", key, torch.int32, (n,))
    _check("ts", ts, torch.int32, (n,))
    _check("vals", vals, torch.float32, (n, F))
    if n == 0:
        return state
    plan = ingest_plan(
        key, ts, cursor, bbucket, capacity=C, bucket_size=bucket_size
    )
    launch_fused_ingest(*state, ts, vals, plan)
    return state

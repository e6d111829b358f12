"""Dispatcher for the fused ingest kernel.

``fused_ingest(...)`` applies one (key, ts)-sorted ingest batch to the six
primary-store state arrays in place — ring scatter (lane writes + cursor
advance) AND bucket pre-agg merge.  CUDA tensors launch the hand-written
kernel (``kernels/csrc/fused_ingest.cu``); CPU tensors run the split
plain version (:mod:`.ref`).  Both give the same bits.

The kernel reads nothing but the batch and the state: the threads on each
key run's first row (one per value lane, up to a warp) find the run's
end, its ring slots and its (key, bucket) segments themselves, and a run
of :data:`SHORT_RUN` rows or more goes to their warp.  So the wrapper
checks shapes and dtypes, launches once on the current stream and
allocates nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.ingest.ref import fused_ingest_ref

__all__ = ["SHORT_RUN", "fused_ingest", "launch_fused_ingest"]

# a key run this long or longer is applied by its first row's warp
# instead of that row's threads (kernels/csrc/fused_ingest.cu SHORT_RUN)
SHORT_RUN = 32


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"fused_ingest: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_ingest: {name} shape {tuple(t.shape)} != {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_ingest: {name} must be contiguous")


_launch_fn = None  # the library's fused_ingest_launch, bound at first launch


def launch_fused_ingest(
    ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket, key, ts, vals,
    *, bucket_size: int,
) -> None:
    """Launch the CUDA kernel on checked inputs: a thread per row and
    value lane, on the current stream, allocating nothing.  Raises if the
    launch reports an error (a bucket size below 1 included)."""
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels.build import library

        fn = library("fused_ingest").fused_ingest_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    K, C = ring_ts.shape
    n, F = vals.shape
    index = ring_ts.get_device()
    # the raw stream handle: a tenth of torch.cuda.current_stream(...)'s
    # host time, which is most of a launch at this kernel's size
    err = _launch_fn(
        ring_ts.data_ptr(), ring_vals.data_ptr(), cursor.data_ptr(),
        bstats.data_ptr(), bbitmap.data_ptr(), bbucket.data_ptr(),
        key.data_ptr(), ts.data_ptr(), vals.data_ptr(),
        n, F, C, bbucket.shape[1], K, int(bucket_size), index,
        torch._C._cuda_getCurrentRawStream(index),
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
    launch_fused_ingest(*state, key, ts, vals, bucket_size=bucket_size)
    return state

"""Dispatchers for the window-aggregation kernels.

* ``fold_levels(x, seg, op=...)`` — the doubling levels of a segmented
  idempotent combine (min / max / or), the hot loop of the offline
  engine's windowed MIN / MAX / DISTINCT scan
  (:func:`repro_torch.core.windows.segmented_windowed_fold`).  CUDA
  tensors launch ``kernels/csrc/fold_levels.cu``, one cooperative launch
  a call, cut into tiles by :func:`plan_fold_levels` (pure Python, so the
  CPU tests can replay the kernel at tiny tiles); CPU tensors run
  :func:`.ref.fold_levels_ref`.  Exact combines, so both give the same bits.
* ``window_stats(...)`` — (Q, NW, L, 5) stat vectors for a batch of
  request rows against an online store's state.  CUDA tensors launch
  ``kernels/csrc/window_stats.cu``; CPU tensors run
  :func:`.ref.window_stats_ref`.  Count, min and max are exact; sum and
  sumsq reduce in the kernel's own order.  It sits beside the store's
  preagg query, which folds in another order (request ⊕ rows ⊕ buckets),
  and is not called by it — as in the reference package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.window_agg.ref import (
    fold_levels_ref,
    fold_num_levels,
    window_stats_ref,
)

__all__ = [
    "fold_levels",
    "launch_fold_levels",
    "plan_fold_levels",
    "FoldPlan",
    "FOLD_TILE",
    "FOLD_HALO",
    "window_stats",
    "launch_window_stats",
]

# op name -> the kernel's op code (kernels/csrc/fold_levels.cu)
_FOLD_CODES = {"min": 0, "max": 1, "or": 2}

_argtypes_set = set()


def _fn(kernel: str, symbol: str, argtypes):
    from repro_torch.kernels.build import library

    fn = getattr(library(kernel), symbol)
    if symbol not in _argtypes_set:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _argtypes_set.add(symbol)
    return fn


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# rows a block of the fold-levels kernel owns, and the rows before them it
# reads as well: a segment up to FOLD_HALO + 1 rows long saturates inside
# one tile (the main path's segments are Poisson(32)), and T + H rows of
# x, seg and two levels take 51 KB of shared memory, four blocks an SM
# (tiles of 2,048 and 8,192 rows timed slower on the H100)
FOLD_TILE = 4096
FOLD_HALO = 128


class FoldPlan(NamedTuple):
    """How the fold-levels kernel cuts N rows: ``tiles`` blocks' worth of
    ``tile`` rows, each with the ``halo`` rows before it; a row whose
    segment starts before its halo leaves the tile at some level
    (``first_long`` is the lowest such level: 2^k > halo + 1) and is
    finished level by level in device memory."""

    levels: int
    tile: int
    halo: int
    tiles: int
    first_long: int


def plan_fold_levels(n: int, tile: int = FOLD_TILE,
                     halo: int = FOLD_HALO) -> FoldPlan:
    """The kernel's tiling of ``n`` rows (the wrapper uses the defaults;
    the CPU tests replay the kernel with tiny ones)."""
    if tile < 1 or halo < 0:
        raise ValueError(f"fold plan: needs tile >= 1 and halo >= 0, got "
                         f"{tile} / {halo}")
    return FoldPlan(fold_num_levels(n), tile, halo, -(-n // tile),
                    (halo + 1).bit_length())


def launch_fold_levels(
    x: torch.Tensor, seg: torch.Tensor, out: torch.Tensor, op: str,
    plan: FoldPlan,
) -> None:
    """Launch the CUDA kernel: ``out`` (KL, N) is written on the current
    stream by one cooperative launch (counted); raises if it fails."""
    fn = _fn("fold_levels", "fold_levels_launch",
             [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    dev = x.device
    n = x.shape[0]
    sync = torch.zeros(3, dtype=torch.int32, device=dev)
    long_tiles = torch.empty(max(plan.tiles, 1), dtype=torch.int32,
                             device=dev)
    err = fn(
        x.data_ptr(), seg.data_ptr(), out.data_ptr(), sync.data_ptr(),
        long_tiles.data_ptr(), n, plan.levels, _FOLD_CODES[op], plan.tile,
        plan.halo, plan.first_long, dev.index, _stream(dev),
    )
    if n > 0:
        count_launch("fold_levels")
    if err != 0:
        raise RuntimeError(f"fold_levels kernel launch failed: CUDA error {err}")


def fold_levels(
    x: torch.Tensor,    # (N,) f32 (min/max) or int32 (or)
    seg: torch.Tensor,  # (N,) int32 segment-start index per row
    *,
    op: str,
) -> torch.Tensor:
    """Doubling levels of the segmented combine: (KL, N).

    Level k row i = op over rows [max(i - 2^k + 1, seg_i), i];
    KL = floor(log2(N)) + 1, enough for any in-segment range query
    through two overlapping power-of-two spans.
    """
    if op not in _FOLD_CODES:
        raise ValueError(f"unknown fold op {op!r}")
    if not use_cuda_kernel("fold_levels", x, seg):
        note_dispatch("fold_levels", "ref")
        return fold_levels_ref(x, seg, op)
    note_dispatch("fold_levels", "cuda")
    want = torch.int32 if op == "or" else torch.float32
    if x.dtype != want or seg.dtype != torch.int32:
        raise TypeError(
            f"fold_levels({op}): x must be {want} and seg int32, got "
            f"{x.dtype} / {seg.dtype}"
        )
    if x.dim() != 1 or seg.shape != x.shape:
        raise ValueError(
            f"fold_levels: x and seg must be 1-D of one length, got "
            f"{tuple(x.shape)} / {tuple(seg.shape)}"
        )
    if not (x.is_contiguous() and seg.is_contiguous()):
        raise ValueError("fold_levels: x and seg must be contiguous")
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError(f"fold_levels: {n} rows exceed int32 indexing")
    plan = plan_fold_levels(n)
    out = torch.empty((plan.levels, n), dtype=x.dtype, device=x.device)
    launch_fold_levels(x, seg, out, op, plan)
    return out


def launch_window_stats(
    ring_ts, ring_lanes, bagg_stats, bagg_bucket, q_key, q_ts, q_lanes,
    windows: torch.Tensor, out: torch.Tensor, bucket_size: int,
) -> None:
    """Launch the CUDA kernel: ``out`` (Q, NW, L, 5) is written on the
    current stream; raises if the launch fails."""
    fn = _fn("window_stats", "window_stats_launch",
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    K, C = ring_ts.shape
    NB = bagg_bucket.shape[1]
    Q, NW, L = out.shape[0], out.shape[1], out.shape[2]
    dev = ring_ts.device
    err = fn(
        ring_ts.data_ptr(), ring_lanes.data_ptr(), bagg_stats.data_ptr(),
        bagg_bucket.data_ptr(), q_key.data_ptr(), q_ts.data_ptr(),
        q_lanes.data_ptr(), windows.data_ptr(), out.data_ptr(),
        Q, C, NB, L, NW, int(bucket_size), dev.index, _stream(dev),
    )
    count_launch("window_stats")
    if err != 0:
        raise RuntimeError(
            f"window_stats kernel launch failed: CUDA error {err}"
        )


def window_stats(
    ring_ts: torch.Tensor,      # (K, C) int32
    ring_lanes: torch.Tensor,   # (K, C, L) f32
    bagg_stats: torch.Tensor,   # (K, NB, L, 5) f32
    bagg_bucket: torch.Tensor,  # (K, NB) int32
    q_key: torch.Tensor,        # (Q,) int32 in [0, K)
    q_ts: torch.Tensor,         # (Q,) int32
    q_lanes: torch.Tensor,      # (Q, L) f32
    *,
    windows: Sequence[int],
    bucket_size: int,
) -> torch.Tensor:
    """(Q, NW, L, 5) (sum, count, min, max, sumsq) per (query, RANGE
    window, lane) over the window ending at the request, request row
    included.  Finalization (mean, std, ...) is the caller's."""
    args = (ring_ts, ring_lanes, bagg_stats, bagg_bucket, q_key, q_ts,
            q_lanes)
    if not use_cuda_kernel("window_stats", *args):
        note_dispatch("window_stats", "ref")
        return window_stats_ref(*args, windows=tuple(windows),
                                bucket_size=bucket_size)
    note_dispatch("window_stats", "cuda")
    K, C = ring_ts.shape
    L = ring_lanes.shape[-1]
    NB = bagg_bucket.shape[1]
    Q = q_key.shape[0]
    shapes = {
        "ring_lanes": (ring_lanes, (K, C, L), torch.float32),
        "bagg_stats": (bagg_stats, (K, NB, L, 5), torch.float32),
        "bagg_bucket": (bagg_bucket, (K, NB), torch.int32),
        "ring_ts": (ring_ts, (K, C), torch.int32),
        "q_key": (q_key, (Q,), torch.int32),
        "q_ts": (q_ts, (Q,), torch.int32),
        "q_lanes": (q_lanes, (Q, L), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise TypeError(
                f"window_stats: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"window_stats: {name} must be contiguous")
    if bucket_size <= 0 or not windows:
        raise ValueError("window_stats: needs bucket_size > 0 and windows")
    # the kernel gathers the rows of q_key: keys outside [0, K) would read
    # past the state (one host read of the key range)
    if Q and not bool(((q_key >= 0) & (q_key < K)).all()):
        raise ValueError(f"window_stats: q_key outside [0, {K})")
    w = torch.tensor([int(t) for t in windows], dtype=torch.int32,
                     device=ring_ts.device)
    out = torch.empty((Q, len(windows), L, 5), dtype=torch.float32,
                      device=ring_ts.device)
    launch_window_stats(*args, w, out, bucket_size)
    return out

"""Dispatcher for the route-rank kernel.

``route_rank(shard, num_shards=S)`` -> (rank within shard, per-shard
counts): the routing primitive of the device-routed request path
(:meth:`repro_torch.core.shard.ShardedOnlineStore.query`).  CUDA tensors
launch the hand-written kernel (``kernels/csrc/route_rank.cu``); CPU
tensors run the plain version (:mod:`.ref`).  Integer results, identical
either way.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.route.ref import route_rank_ref

__all__ = ["route_rank", "launch_route_rank", "MAX_SHARDS"]

# shared memory holds (32 warps + 1) x S counters; 64 shards is 8.4 KB
MAX_SHARDS = 64

_argtypes_set = False


def launch_route_rank(
    shard: torch.Tensor, rank: torch.Tensor, counts: torch.Tensor
) -> None:
    """Launch the CUDA kernel: ``rank`` (N,) and zero-filled ``counts`` (S,)
    are written on the current stream; raises if the launch fails."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    fn = library("route_rank").route_rank_launch
    if not _argtypes_set:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _argtypes_set = True
    dev = shard.device
    err = fn(
        shard.data_ptr(), rank.data_ptr(), counts.data_ptr(),
        shard.shape[0], counts.shape[0], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("route_rank")
    if err != 0:
        raise RuntimeError(f"route_rank kernel launch failed: CUDA error {err}")


def route_rank(
    shard: torch.Tensor,  # (N,) int32 shard ids in [0, num_shards)
    *,
    num_shards: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank (N,) int32, counts (S,) int32): rank of each row within its
    shard in batch order, and rows per shard."""
    if not use_cuda_kernel("route_rank", shard):
        note_dispatch("route_rank", "ref")
        return route_rank_ref(shard, num_shards)
    note_dispatch("route_rank", "cuda")
    if shard.dtype != torch.int32 or shard.dim() != 1:
        raise TypeError(
            f"route_rank: shard must be 1-D int32, got {shard.dtype} "
            f"{tuple(shard.shape)}"
        )
    if not shard.is_contiguous():
        raise ValueError("route_rank: shard must be contiguous")
    if not 1 <= num_shards <= MAX_SHARDS:
        raise ValueError(
            f"route_rank: num_shards must be in [1, {MAX_SHARDS}], "
            f"got {num_shards}"
        )
    rank = torch.empty_like(shard)
    counts = torch.zeros(num_shards, dtype=torch.int32, device=shard.device)
    launch_route_rank(shard, rank, counts)
    return rank, counts

"""Plain PyTorch versions of the route kernel.

``route_rank_ref`` is the rank's whole contract: given per-row shard ids,
the rank of each row *within its shard* in batch order, plus the
per-shard row counts — a one-hot running sum, so the results are exact
integers and the CUDA kernel must equal them.

``route_keys_ref`` is the request path's routing as it was composed of
eager ops before the kernel took it over: the Feistel walk of
``perm.device_call`` finished by ``perm.finish_walk``, ``% S`` and ``// S``,
``route_rank_ref`` and the valid-masked per-shard count.  Keys outside the
permutation's domain [0, upper), whose walk need not end, are not walked:
local = shard = -1, rank 0, counted nowhere (the kernel's rule).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["route_rank_ref", "route_keys_ref"]


def route_rank_ref(
    shard: torch.Tensor, num_shards: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank_within_shard (N,) int32, counts (S,) int32) in batch order.

    Rows whose shard id falls outside [0, num_shards) get rank 0 and count
    into no shard.
    """
    s = torch.arange(num_shards, dtype=torch.int32, device=shard.device)
    oh = (shard.to(torch.int32)[:, None] == s[None, :]).to(torch.int32)
    rank = ((torch.cumsum(oh, 0, dtype=torch.int32) - oh) * oh).sum(
        1, dtype=torch.int32
    )
    return rank, oh.sum(0, dtype=torch.int32)


def route_keys_ref(
    key: torch.Tensor,    # (N,) int32
    valid: torch.Tensor,  # (N,) bool
    perm,                 # repro_torch.core.hashing.KeyPermutation
    num_shards: int,
) -> Tuple[torch.Tensor, ...]:
    """(local, shard, rank, counts, valid_counts), all int32."""
    key = key.to(torch.int32)
    inside = (key >= 0) & (key < perm.upper)
    routed, walking = perm.device_call(torch.where(inside, key, 0))
    if bool(walking):
        routed = perm.finish_walk(routed)
    shard = torch.where(inside, routed % num_shards, -1)
    local = torch.where(inside, routed // num_shards, -1)
    rank, counts = route_rank_ref(shard, num_shards)
    keep = inside & valid
    valid_counts = torch.zeros(
        num_shards, dtype=torch.int32, device=key.device
    ).index_add_(0, shard.clamp(min=0).long(), keep.to(torch.int32))
    return local, shard, rank, counts, valid_counts

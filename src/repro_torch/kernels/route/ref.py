"""Plain PyTorch version of the route-rank kernel.

``route_rank_ref`` is the whole contract: given per-row shard ids, the
rank of each row *within its shard* in batch order, plus the per-shard
row counts — a one-hot running sum, so the results are exact integers and
the CUDA kernel must equal them.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["route_rank_ref"]


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

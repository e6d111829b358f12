"""Decode-time cache of the dense decoder.

:class:`FullKV` holds every layer's keys and values, stacked on a leading
layer axis as in the reference package's ``repro.models.kvcache``.  The
reference's ring cache for sliding-window attention (``SlidingKV``) and
the recurrent states of RWKV6 / Griffin wait for their model families.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["FullKV", "full_kv_init"]


@dataclasses.dataclass
class FullKV:
    """k, v: (L, B, Smax, Hkv, hd); pos: (B,) int32 current lengths."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def full_kv_init(
    cfg: ModelConfig, batch: int, max_len: int, device: torch.device
) -> FullKV:
    """An empty cache on ``device`` in the compute dtype (zeros, every
    length 0)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return FullKV(
        k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )

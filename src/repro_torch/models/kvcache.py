"""Decode-time caches: the dense decoder's and RWKV6's recurrent state.

:class:`FullKV` holds every layer's keys and values, and
:class:`SlidingKV` the ring of the last ``W`` positions for sliding-window
attention, stacked on a leading layer axis as in the reference package's
``repro.models.kvcache``.  The reference returns updated copies; the
per-layer updates here write into the cache's tensors in place (a copy of
a 2 GB cache per layer and step otherwise) and return them.
:func:`rwkv6_state_init` is the recurrent state of ``RWKV6LM.init_state``
(``repro.models.rwkv6``): a plain dict under the reference's keys, so a
state carries across.  Griffin's state waits for its family.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig

__all__ = [
    "FullKV", "full_kv_init", "full_kv_update_layer", "SlidingKV",
    "sliding_kv_init", "sliding_kv_update_layer", "rwkv6_state_init",
    "RWKV_HEAD_DIM",
]

RWKV_HEAD_DIM = 64


@dataclasses.dataclass
class FullKV:
    """k, v: (L, B, Smax, Hkv, hd); pos: (B,) int32 current lengths."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


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


def full_kv_update_layer(
    k_layer: torch.Tensor,  # (B, Smax, Hkv, hd) one layer of the cache
    v_layer: torch.Tensor,
    k_new: torch.Tensor,    # (B, S_new, Hkv, hd)
    v_new: torch.Tensor,
    pos: torch.Tensor,      # (B,) write offsets
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``k_new`` / ``v_new`` at ``pos[0]`` for the whole batch (the
    reference's uniform-position write: serving keeps slot positions
    aligned), in place.  As ``lax.dynamic_update_slice`` does, the start
    is clamped so the write fits; the offset stays on the device."""
    n, smax = k_new.shape[1], k_layer.shape[1]
    start = torch.clamp(pos[0].long(), 0, smax - n)
    idx = start + torch.arange(n, device=pos.device)
    k_layer.index_copy_(1, idx, k_new.to(k_layer.dtype))
    v_layer.index_copy_(1, idx, v_new.to(v_layer.dtype))
    return k_layer, v_layer


@dataclasses.dataclass
class SlidingKV:
    """Ring cache: k, v: (L, B, W, Hkv, hd); k_pos: (B, W) int32 absolute
    positions (-1 = empty); pos: (B,) int32 next position."""

    k: torch.Tensor
    v: torch.Tensor
    k_pos: torch.Tensor
    pos: torch.Tensor

    @property
    def window(self) -> int:
        return self.k.shape[2]


def sliding_kv_init(
    cfg: ModelConfig, batch: int, window: int, device: torch.device
) -> SlidingKV:
    """An empty ring of ``window`` slots on ``device`` in the compute
    dtype (zeros, every slot empty, every position 0)."""
    shape = (cfg.n_layers, batch, window, cfg.n_kv_heads, cfg.hd)
    return SlidingKV(
        k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        k_pos=torch.full((batch, window), -1, dtype=torch.int32,
                         device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def sliding_kv_update_layer(
    k_layer: torch.Tensor,  # (B, W, Hkv, hd)
    v_layer: torch.Tensor,
    k_new: torch.Tensor,    # (B, 1, Hkv, hd): decode writes one token
    v_new: torch.Tensor,
    pos: torch.Tensor,      # (B,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write each row's token into its slot ``pos % W``, in place."""
    rows = torch.arange(k_layer.shape[0], device=pos.device)
    slot = (pos % k_layer.shape[1]).long()
    k_layer[rows, slot] = k_new[:, 0].to(k_layer.dtype)
    v_layer[rows, slot] = v_new[:, 0].to(v_layer.dtype)
    return k_layer, v_layer


def rwkv6_state_init(
    cfg: ModelConfig, batch: int, device: torch.device
) -> Dict[str, torch.Tensor]:
    """RWKV6's state at position 0 on ``device``: ``att_shift`` and
    ``cm_shift`` (L, B, D) in the compute dtype (the last normed input of
    each layer's time mix and channel mix), ``wkv`` (L, B, H, 64, 64)
    float32 (each head's WKV6 state) and ``pos`` (B,) int32, all zeros."""
    L, D = cfg.n_layers, cfg.d_model
    H = D // RWKV_HEAD_DIM
    return {
        "att_shift": torch.zeros((L, batch, D), dtype=cfg.cdtype, device=device),
        "cm_shift": torch.zeros((L, batch, D), dtype=cfg.cdtype, device=device),
        "wkv": torch.zeros((L, batch, H, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                           dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }

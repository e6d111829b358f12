"""Decode-time caches: the dense decoder's and RWKV6's recurrent state.

:class:`FullKV` holds every layer's keys and values, stacked on a leading
layer axis as in the reference package's ``repro.models.kvcache``.
:func:`rwkv6_state_init` is the recurrent state of ``RWKV6LM.init_state``
(``repro.models.rwkv6``): a plain dict under the reference's keys, so a
state carries across.  The reference's ring cache for sliding-window
attention (``SlidingKV``) and Griffin's state wait for their families.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["FullKV", "full_kv_init", "rwkv6_state_init", "RWKV_HEAD_DIM"]

RWKV_HEAD_DIM = 64


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

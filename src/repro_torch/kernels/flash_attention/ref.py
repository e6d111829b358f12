"""Plain PyTorch oracle for flash attention (causal / sliding window / GQA).

The reference package's ``repro.kernels.flash_attention.ref``: every query
head ``h`` reads KV head ``h // (H / Hkv)`` (KV repeated over the group),
float32 scores, masked entries set to ``-1e30`` and their weights to 0, the
softmax denominator floored at ``1e-30`` (a fully masked row comes out 0),
the weights kept in float32 for the PV product, the output in ``q``'s
dtype.  Scores and weights are updated in place: at (8, 48, 2048, 2048)
one float32 score tensor is 6.4 GB.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "MASKED"]

MASKED = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, H, S, D) in ``q``'s dtype."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    kk = k.to(f32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kk).mul_(scale)
    del kk
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    masked = ~mask
    s.masked_fill_(masked, MASKED)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_().masked_fill_(masked, 0.0)
    p.div_(torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30))
    out = torch.einsum(
        "bhqk,bhkd->bhqd", p, v.to(f32).repeat_interleave(group, dim=1)
    )
    return out.to(q.dtype)

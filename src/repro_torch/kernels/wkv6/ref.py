"""Plain PyTorch oracle for the RWKV6 (Finch) time-mix recurrence.

Per head with head dim D, per timestep t:

    y_t    = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
    S_t    = diag(w_t) S_{t-1} + k_t ⊗ v_t

with data-dependent per-channel decay w_t = exp(lw_t).  ``lw`` is clamped
to [LOG_W_MIN, 0]: the clamp bounds the chunked factorization's exponents
(``ops.py``) inside float32 range.  The reference package's
``repro.kernels.wkv6.ref`` computes the same, one timestep at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["wkv6_ref", "LOG_W_MIN"]

LOG_W_MIN = -3.5  # min per-step log-decay (w >= exp(-3.5) ~ 0.03)


def wkv6_ref(
    r: torch.Tensor,   # (B, H, T, D)
    k: torch.Tensor,   # (B, H, T, D)
    v: torch.Tensor,   # (B, H, T, D)
    lw: torch.Tensor,  # (B, H, T, D) log-decay (clamped here)
    u: torch.Tensor,   # (H, D) bonus
    state: Optional[torch.Tensor] = None,  # (B, H, D, D) initial S
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, H, T, D) in ``r``'s dtype, final state (B, H, D, D) float32),
    the recurrence run step by step in float32."""
    B, H, T, D = r.shape
    f32 = torch.float32
    w = torch.exp(torch.clamp(lw.to(f32), LOG_W_MIN, 0.0))
    S = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    uf = u.to(f32)[None, :, :, None]
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    ys = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]        # (B,H,D,D)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, :, t], S + uf * kv))
        S = w[:, :, t, :, None] * S + kv
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros((B, H, 0, D), dtype=f32, device=r.device))
    return y.to(r.dtype), S

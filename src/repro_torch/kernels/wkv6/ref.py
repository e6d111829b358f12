"""Plain PyTorch oracle for the RWKV6 (Finch) time-mix recurrence.

Per head with head dim D, per timestep t:

    y_t    = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
    S_t    = diag(w_t) S_{t-1} + k_t ⊗ v_t

with data-dependent per-channel decay w_t = exp(lw_t).  ``lw`` is clamped
to [LOG_W_MIN, 0]: the clamp bounds the chunked factorization's exponents
(``ops.py``) inside float32 range.  The reference package's
``repro.kernels.wkv6.ref`` computes the same, one timestep at a time.

:func:`wkv6_bwd_ref` is the plain version of B7's backward kernel
(``kernels/csrc/wkv6_bwd.cu``): the reverse recurrence of the gradients,
written out without autograd.  The reference package has no such
function: its model differentiates the XLA chunked scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["wkv6_ref", "wkv6_bwd_ref", "LOG_W_MIN"]

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


def wkv6_bwd_ref(
    r: torch.Tensor,   # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,  # (B, H, T, D) log-decay (clamped in the forward)
    u: torch.Tensor,   # (H, D)
    s0: Optional[torch.Tensor],      # (B, H, D, D) or None (zeros)
    dy: torch.Tensor,                # (B, H, T, D) gradient of y
    ds_fin: Optional[torch.Tensor],  # (B, H, D, D) of the final state, or None
) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dlw, du, ds0) of :func:`wkv6_ref`, each in its input's
    dtype (``ds0`` None when ``s0`` is), step by step in float32.  With
    dS_t the gradient of the state after step t (dS_{T-1} = ``ds_fin``)::

        dS_{t-1} = diag(w_t) dS_t + r_t ⊗ dy_t
        dr_t  = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
        dk_t  = dS_t v_t + u ⊙ r_t (v_t · dy_t)
        dv_t  = dS_tᵀ k_t + (Σ_i r_ti u_i k_ti) dy_t
        du    = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)
        dlw_t = w_t ⊙ Σ_j dS_t[:, j] ⊙ S_{t-1}[:, j]

    ``dlw`` follows ``torch.clamp``'s rule: kept where ``lw`` lies in
    [LOG_W_MIN, 0], both ends included, 0 elsewhere (``jnp.clip``'s
    gradient is 0.5 at the ends)."""
    B, H, T, D = r.shape
    f32 = torch.float32
    dev = r.device
    rf, kf, vf, dyf, lwf = (x.to(f32) for x in (r, k, v, dy, lw))
    w = torch.exp(torch.clamp(lwf, LOG_W_MIN, 0.0))
    uf = u.to(f32)
    S = (torch.zeros((B, H, D, D), dtype=f32, device=dev)
         if s0 is None else s0.to(f32))
    before = []  # S_{t-1} of each step
    for t in range(T):
        before.append(S)
        S = w[:, :, t, :, None] * S + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    dS = (torch.zeros((B, H, D, D), dtype=f32, device=dev)
          if ds_fin is None else ds_fin.to(f32))
    dr, dk, dv, dlw = (torch.zeros((B, H, T, D), dtype=f32, device=dev)
                       for _ in range(4))
    du = torch.zeros((H, D), dtype=f32, device=dev)
    for t in reversed(range(T)):
        rt, kt, vt, dyt, wt = (x[:, :, t] for x in (rf, kf, vf, dyf, w))
        vdy = (vt * dyt).sum(-1, keepdim=True)                     # (B, H, 1)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", before[t], dyt) + uf * kt * vdy
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + uf * rt * vdy
        dv[:, :, t] = (torch.einsum("bhij,bhi->bhj", dS, kt)
                       + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
        dlw[:, :, t] = wt * (dS * before[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        dS = wt[..., None] * dS + rt[..., None] * dyt[..., None, :]
    inside = (lwf >= LOG_W_MIN) & (lwf <= 0.0)
    dlw = torch.where(inside, dlw, torch.zeros((), dtype=f32, device=dev))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw.to(lw.dtype),
            du.to(u.dtype), None if s0 is None else dS.to(s0.dtype))

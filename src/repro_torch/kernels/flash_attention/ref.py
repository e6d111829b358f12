"""Plain PyTorch oracle for flash attention (causal / sliding window / GQA).

The reference package's ``repro.kernels.flash_attention.ref``: every query
head ``h`` reads KV head ``h // (H / Hkv)`` (KV repeated over the group),
float32 scores, masked entries set to ``-1e30`` and their weights to 0, the
softmax denominator floored at ``1e-30`` (a fully masked row comes out 0),
the weights kept in float32 for the PV product, the output in ``q``'s
dtype.  Scores and weights are updated in place: at (8, 48, 2048, 2048)
one float32 score tensor is 6.4 GB.

:func:`attention_bwd_ref` is the plain version of the backward kernel
(``kernels/csrc/flash_attention_bwd.cu``): the weights recomputed as above,
then the explicit gradient formulas in float32, Δ taken from the stored
output ``o`` (bf16 on bf16 paths, as the kernel and FlashAttention-2 take
it).  Given the forward's log-sum-exp ``lse`` it takes P = exp(scale · s −
lse) instead, as the bf16 kernel does.

:func:`attention_lse_ref` is the plain counterpart of the forward kernel
run under autograd: ``attention_ref``'s output and each row's log-sum-exp
of its visible scaled scores (+inf for a row that sees no key).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref",
           "MASKED"]

MASKED = -1e30


def _scores(q, k, *, causal, window, scale):
    """The float32 scaled scores (B, H, S, S) and the (S, S) mask of the
    pairs no query sees."""
    S = q.shape[2]
    group = q.shape[1] // k.shape[1]
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
    return s, ~mask


def _lse(s, masked) -> torch.Tensor:
    """Each row's log-sum-exp of its visible scores, float32; +inf for a
    row that sees no key (then exp(s - lse) is 0)."""
    lse = torch.logsumexp(s.masked_fill(masked, -math.inf), dim=-1)
    return lse.masked_fill_(torch.isneginf(lse), math.inf)


def _weights(q, k, *, causal, window, scale, lse=None) -> torch.Tensor:
    """The float32 attention weights P (B, H, S, S): masked scores at
    ``MASKED``, masked weights 0, the denominator floored at 1e-30; or,
    given ``lse`` (B, H, S), P = exp(s - lse) on the visible pairs."""
    s, masked = _scores(q, k, causal=causal, window=window, scale=scale)
    if lse is not None:
        return s.sub_(lse.to(torch.float32)[..., None]).exp_().masked_fill_(
            masked, 0.0)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        # out of place: autograd keeps what each step's gradient reads
        s = s.masked_fill(masked, MASKED)
        p = (s - s.amax(dim=-1, keepdim=True)).exp().masked_fill(masked, 0.0)
        return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    s.masked_fill_(masked, MASKED)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_().masked_fill_(masked, 0.0)
    return p.div_(torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30))


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
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _weights(q, k, causal=causal, window=window, scale=scale)
    out = torch.einsum(
        "bhqk,bhkd->bhqd", p,
        v.to(torch.float32).repeat_interleave(group, dim=1),
    )
    return out.to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): :func:`attention_ref`'s output, and (B, H, S) float32 each
    row's log-sum-exp of its visible scaled scores, +inf for a row that
    sees no key."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    with torch.no_grad():
        s, masked = _scores(q, k, causal=causal, window=window, scale=scale)
        return o, _lse(s, masked)


def attention_bwd_ref(
    q: torch.Tensor,   # (B, H, S, D)
    k: torch.Tensor,   # (B, Hkv, S, D)
    v: torch.Tensor,   # (B, Hkv, S, D)
    o: torch.Tensor,   # (B, H, S, D) the forward's output
    do: torch.Tensor,  # (B, H, S, D) the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    lse: Optional[torch.Tensor] = None,  # (B, H, S) the forward's
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes and shapes::

        dV = Pᵀ dO,  dP = dO Vᵀ,  Δ = rowsum(dO ∘ O),  dS = P ∘ (dP − Δ),
        dQ = scale · dS K,  dK = scale · dSᵀ Q

    in float32, dK and dV summed over each KV head's query heads; P
    recomputed by the softmax, or from ``lse`` when it is given."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    p = _weights(q, k, causal=causal, window=window, scale=scale, lse=lse)
    dof = do.to(f32)
    vv = v.to(f32).repeat_interleave(group, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    del vv
    delta = (dof * o.to(f32)).sum(-1, keepdim=True)
    ds.sub_(delta).mul_(p)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      k.to(f32).repeat_interleave(group, dim=1)).mul_(scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32)).mul_(scale)

    def group_sum(x):
        return x.reshape(B, Hkv, group, S, D).sum(2)

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))

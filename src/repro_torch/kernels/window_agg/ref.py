"""Plain PyTorch versions of the window-aggregation kernels.

* :func:`fold_levels_ref` — the offline segmented-combine scan: all
  doubling levels of a segmented idempotent fold (min / max / bitwise-or),
  the hot loop of :func:`repro_torch.core.windows.segmented_windowed_fold`.
  Level ``k`` holds the combine over ``[max(i - 2^k + 1, seg_i), i]`` for
  every row; each level is one static shift plus one elementwise combine.
* :func:`window_stats_ref` — the pre-aggregated multi-window query: given
  the online store's rings and bucket pre-aggregates and a batch of
  request rows, the five-stat vector (sum, count, min, max, sumsq) per
  (query, RANGE window, lane), the request row included.

**Min and max are written as explicit selects** (:func:`fold_min`,
:func:`fold_max`) that reproduce the reference's ``jnp.minimum`` /
``jnp.maximum`` bit for bit: a NaN operand propagates with its own bits
(when both are NaN, min keeps the one with a clear sign bit and max the
one with a set sign bit), and ``-0.0`` orders below ``+0.0``.
``torch.minimum`` differs on both (it returns a canonical NaN and the
first operand of a ``±0`` tie), and CUDA's ``fminf`` drops a NaN.  The
CUDA kernel (``kernels/csrc/fold_levels.cu``) uses the same selects.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

POS_INF = 3.0e38   # float32(3.0e38): the min fold's identity
NEG_INF = -3.0e38  # the max fold's identity
TS_EMPTY = -2147483648

__all__ = [
    "window_stats_ref",
    "fold_levels_ref",
    "fold_num_levels",
    "fold_identity",
    "fold_op",
    "fold_min",
    "fold_max",
    "POS_INF",
    "NEG_INF",
]

_SIGN = -2147483648  # 0x80000000 as int32


def _isnan_bits(bits: torch.Tensor) -> torch.Tensor:
    return (bits & 0x7FFFFFFF) > 0x7F800000


def fold_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` bit for bit: order the operands by ``a``'s sign,
    take the smaller, and let a NaN in the first-ordered operand win."""
    a, b = torch.broadcast_tensors(a, b)
    neg = (a.view(torch.int32) & _SIGN) != 0
    nx = torch.where(neg, b, a)
    ny = torch.where(neg, a, b)
    pick = torch.where(nx < ny, nx, ny)
    return torch.where(_isnan_bits(nx.view(torch.int32)), nx, pick)


def fold_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` bit for bit (the mirror image of :func:`fold_min`)."""
    a, b = torch.broadcast_tensors(a, b)
    neg = (a.view(torch.int32) & _SIGN) != 0
    nx = torch.where(neg, a, b)
    ny = torch.where(neg, b, a)
    pick = torch.where(nx > ny, nx, ny)
    return torch.where(_isnan_bits(nx.view(torch.int32)), nx, pick)


# segmented idempotent combines the fold kernel supports
_FOLD_OPS = {
    "min": fold_min,
    "max": fold_max,
    "or": torch.bitwise_or,
}


def fold_op(op: str):
    return _FOLD_OPS[op]


def fold_identity(op: str, dtype: torch.dtype):
    """The combine's identity as a Python scalar of ``dtype``'s kind."""
    if op == "min":
        return POS_INF if dtype.is_floating_point else int(POS_INF)
    if op == "max":
        return NEG_INF if dtype.is_floating_point else int(NEG_INF)
    if op == "or":
        return 0
    raise ValueError(f"unknown fold op {op!r}")


def fold_num_levels(n: int) -> int:
    """Number of doubling levels for ``n`` rows (level 0 = the rows)."""
    return max(1, int(math.floor(math.log2(max(n, 1)))) + 1)


def fold_levels_ref(
    x: torch.Tensor,    # (N,) f32 (min/max) or int32 (or)
    seg: torch.Tensor,  # (N,) int32 — each row's key-segment start index
    op: str,
) -> torch.Tensor:
    """Returns (KL, N): level k = op over [max(i - 2^k + 1, seg_i), i]."""
    n = x.shape[0]
    ident = fold_identity(op, x.dtype)
    f = _FOLD_OPS[op]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    out = torch.empty((fold_num_levels(n), n), dtype=x.dtype, device=x.device)
    out[0] = x
    for k in range(out.shape[0] - 1):
        half = 1 << k
        prev = out[k]
        shifted = torch.cat(
            [torch.full((half,), ident, dtype=x.dtype, device=x.device),
             prev[:-half]]
        )
        shifted = torch.where(idx - half >= seg, shifted, ident)
        out[k + 1] = f(prev, shifted)
    return out


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def window_stats_ref(
    ring_ts: torch.Tensor,      # (K, C) int32 (slot order arbitrary)
    ring_lanes: torch.Tensor,   # (K, C, L) f32
    bagg_stats: torch.Tensor,   # (K, NB, L, 5) f32
    bagg_bucket: torch.Tensor,  # (K, NB) int32 (-1 empty)
    q_key: torch.Tensor,        # (Q,) int32
    q_ts: torch.Tensor,         # (Q,) int32
    q_lanes: torch.Tensor,      # (Q, L) f32 request-row lane values
    windows: Sequence[int],
    bucket_size: int,
) -> torch.Tensor:
    """Returns (Q, NW, L, 5) composed stats."""
    B = int(bucket_size)
    qk = q_key.long()
    ts = ring_ts[qk]           # (Q, C)
    lanes = ring_lanes[qk]     # (Q, C, L)
    bstats = bagg_stats[qk]    # (Q, NB, L, 5)
    bids = bagg_bucket[qk]     # (Q, NB)
    valid = ts != TS_EMPTY
    bucket_row = _floordiv(ts, B)

    outs = []
    for T in windows:
        T = int(T)
        lo = q_ts - T + 1
        b_q = _floordiv(q_ts, B)
        b_lo = _floordiv(q_ts - T, B)
        not_future = ts <= q_ts[:, None]
        in_lo = ts >= lo[:, None]
        head = (
            valid & not_future & in_lo
            & (bucket_row == b_lo[:, None]) & (b_lo != b_q)[:, None]
        )
        tail = valid & not_future & in_lo & (bucket_row == b_q[:, None])
        rawf = (head | tail).to(torch.float32)[..., None]  # (Q, C, 1)
        raw = rawf > 0

        g = lanes
        # the raw count is per query; it is broadcast over the lanes (the
        # reference's jnp version keeps it (Q, 1), so it stacks only for
        # L == 1)
        s_raw = torch.stack(
            [
                (g * rawf).sum(dim=1) + q_lanes,
                (rawf.sum(dim=1) + 1.0).expand_as(q_lanes),
                fold_min(torch.where(raw, g, POS_INF).amin(dim=1), q_lanes),
                fold_max(torch.where(raw, g, NEG_INF).amax(dim=1), q_lanes),
                (g * g * rawf).sum(dim=1) + q_lanes * q_lanes,
            ],
            dim=-1,
        )  # (Q, L, 5)

        mo = ((bids > b_lo[:, None]) & (bids < b_q[:, None]))[..., None]
        s_mid = torch.stack(
            [
                torch.where(mo, bstats[..., 0], 0.0).sum(dim=1),
                torch.where(mo, bstats[..., 1], 0.0).sum(dim=1),
                torch.where(mo, bstats[..., 2], POS_INF).amin(dim=1),
                torch.where(mo, bstats[..., 3], NEG_INF).amax(dim=1),
                torch.where(mo, bstats[..., 4], 0.0).sum(dim=1),
            ],
            dim=-1,
        )  # (Q, L, 5)

        outs.append(torch.stack(
            [
                s_raw[..., 0] + s_mid[..., 0],
                s_raw[..., 1] + s_mid[..., 1],
                fold_min(s_raw[..., 2], s_mid[..., 2]),
                fold_max(s_raw[..., 3], s_mid[..., 3]),
                s_raw[..., 4] + s_mid[..., 4],
            ],
            dim=-1,
        ))
    return torch.stack(outs, dim=1)  # (Q, NW, L, 5)

"""Vectorized per-key window aggregation over (key, ts)-sorted rows.

The *offline* executor's compute core (and the oracle the online store is
verified against): for every row, aggregates over a per-key window ending
at that row, as dense data-parallel tensor ops.  Semantics come from the
aggregator algebra in :mod:`repro_torch.core.aggregates`; this module
holds the evaluation strategies, each the reference package's
(``repro.core.windows``):

* invertible lanes (sum / count / sumsq) -> segmented compensated prefix
  sums (TwoSum double-float, restarted per key) and a range difference;
* idempotent lanes (min / max) and OR-bitmaps ->
  :func:`segmented_windowed_fold`: the doubling levels of the fold-levels
  kernel (:mod:`repro_torch.kernels.window_agg`) plus a two-gather
  overlapping-span query;
* extreme states (FIRST / LAST) -> row j (FIRST) or row i (LAST) of the
  window [j, i];
* tail states (TOPN_FREQ) -> the newest ``TOPN_TAIL`` rows, gathered as
  [max(j, i - T + 1), i].

Exactness against the reference: window starts, segment starts, the sort
permutation and every min / max / or / count / first / last / topn value
are bit-identical.  The compensated prefix sums are too:
:func:`_associative_scan` replays ``jax.lax.associative_scan``'s combine
tree (odd/even pairing, recursion, interleave), and TwoSum has only adds
and subtracts, so no fused multiply-add can form.  SUM / MEAN / STD
center values by the array's mean first, and PyTorch's mean reduces in
another order than XLA's, so those features agree within a tolerance.

Everything runs eagerly (no ``torch.compile``: it could re-associate the
TwoSum arithmetic).  All functions assume rows sorted by (key, ts).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core import aggregates as ag
from repro_torch.core.aggregates import TOPN_TAIL, agg_spec
from repro_torch.core.expr import Agg, WindowSpec
from repro_torch.kernels.window_agg.ops import fold_levels
from repro_torch.kernels.window_agg.ref import fold_op

__all__ = [
    "sort_by_key_ts",
    "segment_starts",
    "window_start_rows",
    "window_start_range",
    "segmented_windowed_fold",
    "windowed_aggregate",
    "TOPN_TAIL",
]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 for int32 or int64 indices."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(x.shape[1:])
    )


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def sort_by_key_ts(
    key: torch.Tensor, ts: torch.Tensor, *cols: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Stable sort rows by (key, ts).  Returns (key, ts, *cols, perm) with
    ``perm`` int32."""
    order = torch.argsort(ts, stable=True)
    order2 = torch.argsort(_take(key, order), stable=True)
    perm = _take(order, order2)
    out = [_take(key, perm), _take(ts, perm)]
    out.extend(_take(c, perm) for c in cols)
    out.append(perm.to(torch.int32))
    return tuple(out)


def segment_starts(key: torch.Tensor) -> torch.Tensor:
    """(N,) int32: index of the first row of each row's key segment."""
    n = key.shape[0]
    idx = _arange(n, key.device)
    is_start = torch.ones(n, dtype=torch.bool, device=key.device)
    if n > 1:
        is_start[1:] = key[1:] != key[:-1]
    start_idx = torch.where(is_start, idx, 0)
    if n == 0:
        return start_idx
    return torch.cummax(start_idx, 0).values


def window_start_rows(seg_start: torch.Tensor, size: int) -> torch.Tensor:
    """First in-window row index for a ROWS window of ``size``."""
    idx = _arange(seg_start.shape[0], seg_start.device)
    return torch.maximum(seg_start, idx - (size - 1))


def window_start_range(
    key: torch.Tensor, ts: torch.Tensor, seg_start: torch.Tensor, size: int
) -> torch.Tensor:
    """First row index with ts > ts_i - size within the same key segment.

    Vectorized lexicographic binary search over the (key, ts)-sorted rows:
    for every row i the first j with (key_j, ts_j) >= (key_i, ts_i -
    size + 1), in ``ceil(log2 n) + 1`` halving steps (int32 throughout,
    as the reference's).
    """
    n = key.shape[0]
    target_ts = ts - size + 1
    lo = torch.zeros(n, dtype=torch.int32, device=key.device)
    hi = _arange(n, key.device)  # answer is <= i (window includes i)
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        k_m, t_m = _take(key, mid), _take(ts, mid)
        lt = (k_m < key) | ((k_m == key) & (t_m < target_ts))
        lo = torch.where(active & lt, mid + 1, lo)
        hi = torch.where(active & ~lt, mid, hi)
    return torch.maximum(lo, seg_start)


# ---------------------------------------------------------------------------
# Segmented prefix machinery (invertible lanes: sum / count / sumsq)
# ---------------------------------------------------------------------------


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth TwoSum: s + err == a + b exactly (err is the rounding error)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """Double-float (hi, lo) addition — associative to O(eps^2)."""
    s, err = _two_sum(a_hi, b_hi)
    lo = err + a_lo + b_lo
    hi, lo = _two_sum(s, lo)
    return hi, lo


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at even, b at odd positions, as the reference interleaves: by
    adding zero-padded copies (so a float ``-0.0`` comes out ``+0.0``;
    booleans are or-ed)."""
    out = torch.empty(
        (a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
        dtype=a.dtype, device=a.device,
    )
    if a.dtype == torch.bool:
        out[0::2] = a
        out[1::2] = b
    else:
        out[0::2] = a + 0.0
        out[1::2] = b + 0.0
    return out


def _associative_scan(
    combine: Callable[[List[torch.Tensor], List[torch.Tensor]],
                      List[torch.Tensor]],
    elems: List[torch.Tensor],
) -> List[torch.Tensor]:
    """Inclusive scan along dim 0 with the combine tree of
    ``jax.lax.associative_scan`` (jax/_src/lax/control_flow/loops.py,
    ``_scan``): pair adjacent elements, scan the pairs recursively, fill in
    the even positions, interleave.  The same tree gives the same rounding
    for a non-associative float combine such as TwoSum."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _segment_prefix_sum(
    x: torch.Tensor, seg_start: torch.Tensor, compensated: bool = True
):
    """Inclusive prefix sum restarting at each key segment, carried as an
    unevaluated compensated (hi, lo) double-float pair combined with
    TwoSum (residual error O(eps^2 * per-key prefix magnitude)).  Returns
    the (hi, lo) pair; consume with :func:`_range_sum`.

    ``compensated=False`` skips the second lane for inputs whose prefixes
    are exact in f32 anyway (COUNT: small integers), returning
    (prefix, zeros).
    """
    n = x.shape[0]
    is_start = _arange(n, x.device) == seg_start
    xf = x.to(torch.float32)

    if not compensated:
        def comb1(a, b):
            flag_a, val_a = a
            flag_b, val_b = b
            return [flag_a | flag_b, torch.where(flag_b, val_b, val_a + val_b)]

        _, out = _associative_scan(comb1, [is_start, xf])
        return out, torch.zeros_like(out)

    def comb(a, b):
        flag_a, hi_a, lo_a = a
        flag_b, hi_b, lo_b = b
        hi, lo = _df_add(hi_a, lo_a, hi_b, lo_b)
        return [
            flag_a | flag_b,
            torch.where(flag_b, hi_b, hi),
            torch.where(flag_b, lo_b, lo),
        ]

    _, hi, lo = _associative_scan(comb, [is_start, xf, torch.zeros_like(xf)])
    return hi, lo


def _range_sum(
    ps, j: torch.Tensor, i: torch.Tensor, seg_start: torch.Tensor
) -> torch.Tensor:
    """sum over rows [j, i] given segment-restarted compensated prefixes."""
    hi, lo = ps
    take = j > seg_start
    jm = torch.clamp(j - 1, min=0)
    left_hi = torch.where(take, _take(hi, jm), 0.0)
    left_lo = torch.where(take, _take(lo, jm), 0.0)
    # subtract hi parts first (they cancel), then fold in the compensations
    return (_take(hi, i) - left_hi) + (_take(lo, i) - left_lo)


# ---------------------------------------------------------------------------
# Segmented windowed fold (idempotent lanes: min / max / bitmap-or)
# ---------------------------------------------------------------------------


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2 v) of positive int32 values, exactly (the reference's
    ``31 - clz(v)``), by a binary search over the bit length."""
    k = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) > 0
        v = torch.where(big, v >> s, v)
        k = torch.where(big, k + s, k)
    return k


def segmented_windowed_fold(
    x: torch.Tensor,
    seg_start: torch.Tensor,
    j: torch.Tensor,
    op: str,
) -> torch.Tensor:
    """op over rows ``[j_i, i]`` for every row i (op in min/max/or).

    1. **level build**: the doubling levels of the segmented combine —
       the fold-levels kernel on CUDA tensors, its plain version on CPU
       tensors (:func:`repro_torch.kernels.window_agg.ops.fold_levels`);
    2. **query**: the window [j, i] is covered by the two overlapping
       power-of-two spans ending at i and starting at j (valid because
       these combines are idempotent): two gathers.
    """
    n = x.shape[0]
    levels = fold_levels(x, seg_start, op=op).reshape(-1)
    idx = _arange(n, x.device)
    length = idx - j + 1
    k = torch.clamp(_floor_log2(length), min=0)
    base = k.to(torch.int64) * n
    a = _take(levels, base + idx)
    span = torch.bitwise_left_shift(torch.ones_like(k), k)
    b = _take(levels, base + (j + span - 1))
    return fold_op(op)(a, b)


# ---------------------------------------------------------------------------
# Registry-driven aggregation
# ---------------------------------------------------------------------------


def windowed_aggregate(
    key: torch.Tensor,
    ts: torch.Tensor,
    requests: Dict[Tuple, Tuple[Agg, torch.Tensor, WindowSpec, int]],
) -> Dict[Tuple, torch.Tensor]:
    """Evaluate a batch of window aggregations over (key, ts)-sorted rows.

    ``requests`` maps a structural key -> (agg, arg_values (N,), window, n).
    Results are (N,) f32, one value per row (point-in-time correct: row
    i's window ends at and includes row i).  Shared work (segment starts,
    window starts, prefix sums and fold levels per distinct argument) is
    computed once per call.
    """
    seg = segment_starts(key)
    n_rows = key.shape[0]
    idx = _arange(n_rows, key.device)

    starts: Dict[Tuple, torch.Tensor] = {}

    def start_of(w: WindowSpec) -> torch.Tensor:
        wk = (w.mode, w.size)
        if wk not in starts:
            if w.mode == "rows":
                starts[wk] = window_start_rows(seg, w.size)
            else:
                starts[wk] = window_start_range(key, ts, seg, w.size)
        return starts[wk]

    # prefix sums per distinct argument tensor.  Values are centered by
    # their mean first: windowed sums / variances are shift-invariant
    # (modulo the mu * count term added back), and centering keeps the f32
    # prefixes at variance scale instead of mean^2 scale.
    ps_cache: Dict[int, Tuple[torch.Tensor, Tuple, Tuple]] = {}

    def psums(arr: torch.Tensor):
        k = id(arr)
        if k not in ps_cache:
            mu = torch.mean(arr)
            c = arr - mu
            ps_cache[k] = (
                mu,
                _segment_prefix_sum(c, seg),
                _segment_prefix_sum(c * c, seg),
            )
        return ps_cache[k]

    fold_cache: Dict[Tuple[int, str, int], torch.Tensor] = {}

    def fold_of(arr: torch.Tensor, op: str, j: torch.Tensor) -> torch.Tensor:
        ck = (id(arr), op, id(j))
        if ck not in fold_cache:
            x = ag.row_bitmap(arr) if op == "or" else arr
            fold_cache[ck] = segmented_windowed_fold(x, seg, j, op)
        return fold_cache[ck]

    count_ps = _segment_prefix_sum(
        torch.ones(n_rows, dtype=torch.float32, device=key.device), seg,
        compensated=False,
    )

    out: Dict[Tuple, torch.Tensor] = {}
    for rk, (agg, arr, w, nth) in requests.items():
        spec = agg_spec(agg)
        j = start_of(w)

        if spec.state == "lanes":
            # STD is shift-invariant, so its lanes are evaluated on the
            # centered values directly; SUM/MEAN are not, so their sum lane
            # is un-centered by adding mu * count back.
            state: Dict[str, torch.Tensor] = {}
            cnt = _range_sum(count_ps, j, idx, seg)
            centered = agg == Agg.STD
            for lane in spec.lanes:
                if lane == "count":
                    state["count"] = cnt
                elif lane == "sum":
                    mu, ps, _ = psums(arr)
                    s = _range_sum(ps, j, idx, seg)
                    state["sum"] = s if centered else s + mu * cnt
                elif lane == "sumsq":
                    _, _, ps2 = psums(arr)
                    state["sumsq"] = _range_sum(ps2, j, idx, seg)
                else:  # min / max: idempotent — doubling fold
                    state[lane] = fold_of(arr, lane, j)
            out[rk] = spec.finalize(state, n=nth)
        elif spec.state == "bitmap":
            out[rk] = spec.finalize({"bits": fold_of(arr, "or", j)}, n=nth)
        elif spec.state == "extreme":
            # the fold of an argmin/argmax-by-merge-order monoid over the
            # contiguous range [j, i] is row i (LAST) or row j (FIRST)
            val = arr if spec.newest else _take(arr, j)
            out[rk] = spec.finalize({"val": val}, n=nth)
        elif spec.state == "tail":
            # the fold keeps the newest TOPN_TAIL rows, i.e. rows
            # [max(j, i - T + 1), i], gathered newest-first
            offs = _arange(TOPN_TAIL, key.device)[None, :]
            pos = idx[:, None] - offs
            valid = pos >= j[:, None]
            vals = _take(arr, torch.clamp(pos, min=0))
            out[rk] = spec.finalize({"val": vals, "valid": valid}, n=nth)
        else:
            raise ValueError(f"unhandled agg {agg}")
    return out

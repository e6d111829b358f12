"""Unified aggregator algebra — one monoid spec per ``Agg``.

The same single source of truth as the reference package's
``repro.core.aggregates``: every ``Agg`` is (init, lift, combine,
finalize) over one of four state families, and every query path is a
strategy for folding that monoid.

``lanes``    a product of scalar lane monoids (sum, count, min, max,
             sumsq) — SUM/COUNT/MEAN/MIN/MAX/STD;
``bitmap``   32-bit linear-counting OR-bitmap — DISTINCT_APPROX;
``extreme``  argmin/argmax by the merge order (ts, stream-rank, slot) —
             FIRST and LAST;
``tail``     the newest ``TOPN_TAIL`` rows by merge order — TOPN_FREQ.

States are dicts of tensors.  Integer and min/max/bitmap results equal the
reference's bit for bit; float sums over a ring reduce in PyTorch's order
(the tests state the tolerance).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.expr import Agg
from repro_torch.core.hashing import mix64

__all__ = [
    "LANES",
    "NUM_STATS",
    "POS_INF",
    "NEG_INF",
    "TOPN_TAIL",
    "AggSpec",
    "AGG_SPECS",
    "agg_spec",
    "lane_masked_reduce",
    "lanes_identity_stack",
    "lanes_lift_stack",
    "lanes_combine_stack",
    "row_bitmap",
    "bitmap_estimate",
    "topn_rank",
]

POS_INF = 3.0e38   # float32(3.0e38): the min lane's identity
NEG_INF = -3.0e38
_TS_MIN = -2147483648
_TS_MAX = 2147483647

TOPN_TAIL = 32  # contract: TOPN_FREQ windows are evaluated over <=32 rows

# stat-lane order == the bucket store's trailing axis layout
LANES: Tuple[str, ...] = ("sum", "count", "min", "max", "sumsq")
NUM_STATS = len(LANES)

_LANE_IDENT = {
    "sum": 0.0,
    "count": 0.0,
    "min": POS_INF,
    "max": NEG_INF,
    "sumsq": 0.0,
}

_LANE_LIFT = {
    "sum": lambda v: v,
    "count": lambda v: torch.ones_like(v),
    "min": lambda v: v,
    "max": lambda v: v,
    "sumsq": lambda v: v * v,
}

_LANE_COMBINE = {
    "sum": torch.add,
    "count": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
    "sumsq": torch.add,
}


def _lane_reduce(lane: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    if lane == "min":
        return torch.amin(x, dim=dim)
    if lane == "max":
        return torch.amax(x, dim=dim)
    return torch.sum(x, dim=dim)


def lane_masked_reduce(
    lane: str, lifted: torch.Tensor, mask: torch.Tensor, dim: int
) -> torch.Tensor:
    """Fold lifted states over ``dim``, masked rows contributing identity."""
    ident = torch.tensor(
        _LANE_IDENT[lane], dtype=lifted.dtype, device=lifted.device
    )
    return _lane_reduce(lane, torch.where(mask, lifted, ident), dim)


def lanes_lift_stack(v: torch.Tensor) -> torch.Tensor:
    """(...,) values -> (..., NUM_STATS) full stat-vector states."""
    return torch.stack([_LANE_LIFT[l](v) for l in LANES], dim=-1)


def lanes_identity_stack(
    shape: Tuple[int, ...], device: torch.device
) -> torch.Tensor:
    """(shape, NUM_STATS) identity stat vectors."""
    ident = torch.tensor(
        [_LANE_IDENT[l] for l in LANES], dtype=torch.float32, device=device
    )
    return ident.expand(tuple(shape) + (NUM_STATS,)).clone()


def lanes_combine_stack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative combine of full stat vectors (..., NUM_STATS)."""
    return torch.stack(
        [_LANE_COMBINE[l](a[..., i], b[..., i]) for i, l in enumerate(LANES)],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Bitmap monoid — 32-bit linear counting (DISTINCT_APPROX)
# ---------------------------------------------------------------------------


def row_bitmap(vals: torch.Tensor) -> torch.Tensor:
    """Per-value 32-bit linear-counting bitmap contribution (the lift)."""
    bits = mix64(vals, salt=77, bits=5)
    return torch.bitwise_left_shift(torch.ones_like(bits), bits)


def _popcount32(bits: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane (SWAR count over the 32-bit pattern)."""
    x = bits.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bitmap_estimate(bits: torch.Tensor) -> torch.Tensor:
    """Linear-counting estimate from an OR-combined bitmap (the finalize)."""
    ones = _popcount32(bits).to(torch.float32)
    frac = torch.clamp(ones / 32.0, 0.0, 1.0 - 1e-6)
    return -32.0 * torch.log1p(-frac)


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of int32 lanes along ``dim`` (per bit: any set)."""
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bit_any = ((x.unsqueeze(-1) >> shifts) & 1).amax(dim=dim)
    return (bit_any << shifts).sum(dim=-1, dtype=torch.int64).to(torch.int32)


# ---------------------------------------------------------------------------
# Merge-order helpers (extreme / tail states)
# ---------------------------------------------------------------------------


def _lex_newer(a, b):
    """True where state-b's (ts, rank, pos) is strictly newer than a's."""
    return (
        (b["ts"] > a["ts"])
        | ((b["ts"] == a["ts"]) & (b["rank"] > a["rank"]))
        | (
            (b["ts"] == a["ts"])
            & (b["rank"] == a["rank"])
            & (b["pos"] > a["pos"])
        )
    )


def _desc_argsort(x: torch.Tensor) -> torch.Tensor:
    """Stable descending argsort of int32 keys (~x is monotone-decreasing
    and overflow-free, unlike -x at INT32_MIN)."""
    return torch.argsort(~x, dim=-1, stable=True)


def _sort_tail_desc(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Order tail entries newest-first by (ts, rank, pos); invalid last."""
    v = state["valid"]
    ts = torch.where(v, state["ts"], _TS_MIN)
    rank = torch.where(v, state["rank"], -1)
    pos = torch.where(v, state["pos"], _TS_MIN)

    def take(d, order):
        return {k: torch.gather(x, -1, order) for k, x in d.items()}

    cur = dict(state, ts=ts, rank=rank, pos=pos)
    for field in ("pos", "rank", "ts"):  # least-significant first
        cur = take(cur, _desc_argsort(cur[field]))
    return cur


def topn_rank(
    vals: torch.Tensor, valid: torch.Tensor, nth: int, groups: int = 1
) -> torch.Tensor:
    """n-th most-frequent value over newest-first tail entries.

    ``vals``/``valid``: (Q, T) with slot 0 the most recent entry.  Ranking:
    frequency desc, value asc, duplicates deduped to their most recent
    slot; 0.0 where fewer than ``nth + 1`` distinct values exist.  The
    score scale ``vmax`` is taken over each of ``groups`` equal blocks of
    rows — one per shard on the sharded plane, where the reference
    evaluates every shard's grid separately.
    """
    tail = vals.shape[-1]
    eq = (
        (vals[..., :, None] == vals[..., None, :])
        & valid[..., :, None]
        & valid[..., None, :]
    )
    freq = eq.sum(-1).to(torch.float32)
    freq = torch.where(valid, freq, -1.0)
    earlier = torch.tril(
        torch.ones((tail, tail), dtype=torch.bool, device=vals.device), -1
    )
    same_as_earlier = (eq & earlier).any(-1)
    is_first = valid & ~same_as_earlier
    score = torch.where(is_first, freq, -1.0)
    av = torch.abs(vals).reshape(groups, -1)
    if av.shape[1]:
        vmax = torch.clamp(av.amax(dim=1), min=1.0)
    else:
        vmax = torch.ones(groups, dtype=vals.dtype, device=vals.device)
    vmax = vmax.repeat_interleave(vals.shape[0] // groups)[:, None]
    composite = score * (2.0 * vmax + 1.0) - vals
    order = torch.argsort(-composite, dim=-1, stable=True)
    pick = order[..., nth]
    picked_score = torch.gather(score, -1, pick[..., None])[..., 0]
    val = torch.gather(vals, -1, pick[..., None])[..., 0]
    return torch.where(picked_score >= 0.0, val, 0.0)


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate's algebra: (init, lift, combine, finalize) + layout.

    ``lanes``:    {lane: (...,)}                     (selected stat lanes)
    ``bitmap``:   {"bits": (...,) int32}
    ``extreme``:  {"ts", "rank", "pos", "val", "has"}
    ``tail``:     {"ts", "rank", "pos", "val", "valid"}  each (..., T)
    """

    agg: Agg
    state: str                       # "lanes" | "bitmap" | "extreme" | "tail"
    lanes: Tuple[str, ...] = ()      # state == "lanes": which lanes
    newest: bool = False             # state == "extreme": LAST (vs FIRST)
    union_composable: bool = True
    bucket_composable: bool = False  # state persisted by the bucket store

    # -- init ---------------------------------------------------------------

    def init(
        self, shape: Tuple[int, ...], device: torch.device
    ) -> Dict[str, torch.Tensor]:
        """Identity state of batch ``shape``."""
        kw = dict(device=device)
        if self.state == "lanes":
            return {
                l: torch.full(shape, _LANE_IDENT[l], dtype=torch.float32, **kw)
                for l in self.lanes
            }
        if self.state == "bitmap":
            return {"bits": torch.zeros(shape, dtype=torch.int32, **kw)}
        if self.state == "extreme":
            return {
                "ts": torch.full(shape, _TS_MIN, dtype=torch.int32, **kw),
                "rank": torch.zeros(shape, dtype=torch.int32, **kw),
                "pos": torch.zeros(shape, dtype=torch.int32, **kw),
                "val": torch.zeros(shape, dtype=torch.float32, **kw),
                "has": torch.zeros(shape, dtype=torch.bool, **kw),
            }
        # tail: zero-width entry set
        z = tuple(shape) + (0,)
        return {
            "ts": torch.zeros(z, dtype=torch.int32, **kw),
            "rank": torch.zeros(z, dtype=torch.int32, **kw),
            "pos": torch.zeros(z, dtype=torch.int32, **kw),
            "val": torch.zeros(z, dtype=torch.float32, **kw),
            "valid": torch.zeros(z, dtype=torch.bool, **kw),
        }

    # -- lift ---------------------------------------------------------------

    def lift(self, val, ts, rank, pos) -> Dict[str, torch.Tensor]:
        """Single row -> state.  ``(ts, rank, pos)`` is the row's merge-order
        coordinate (ignored by lanes/bitmap states); each is a tensor of
        ``val``'s shape or an int."""
        if self.state == "lanes":
            return {l: _LANE_LIFT[l](val) for l in self.lanes}
        if self.state == "bitmap":
            return {"bits": row_bitmap(val)}

        def full(x):
            return torch.broadcast_to(
                torch.as_tensor(x, dtype=torch.int32, device=val.device),
                val.shape,
            )

        if self.state == "extreme":
            return {
                "ts": full(ts),
                "rank": full(rank),
                "pos": full(pos),
                "val": val,
                "has": torch.ones(val.shape, dtype=torch.bool,
                                  device=val.device),
            }
        return {
            "ts": full(ts)[..., None],
            "rank": full(rank)[..., None],
            "pos": full(pos)[..., None],
            "val": val[..., None],
            "valid": torch.ones(val.shape + (1,), dtype=torch.bool,
                                device=val.device),
        }

    # -- combine ------------------------------------------------------------

    def combine(self, a, b) -> Dict[str, torch.Tensor]:
        """Associative merge of two states."""
        if self.state == "lanes":
            return {l: _LANE_COMBINE[l](a[l], b[l]) for l in self.lanes}
        if self.state == "bitmap":
            return {"bits": a["bits"] | b["bits"]}
        if self.state == "extreme":
            if self.newest:
                pick_b = ~a["has"] | (b["has"] & _lex_newer(a, b))
            else:
                pick_b = ~a["has"] | (b["has"] & ~_lex_newer(a, b))
            pick_b = pick_b & b["has"]
            out = {
                k: torch.where(pick_b, b[k], a[k])
                for k in ("ts", "rank", "pos", "val")
            }
            out["has"] = a["has"] | b["has"]
            return out
        cat = {
            k: torch.cat([a[k], b[k]], dim=-1)
            for k in ("ts", "rank", "pos", "val", "valid")
        }
        merged = _sort_tail_desc(cat)
        if merged["ts"].shape[-1] > TOPN_TAIL:
            merged = {k: v[..., :TOPN_TAIL] for k, v in merged.items()}
        return merged

    # -- fold strategies -----------------------------------------------------

    def fold_rows(self, g, ts, mask, rank) -> Dict[str, torch.Tensor]:
        """Fold one ring buffer's masked rows (Q, C) into a state; the slot
        index (oldest -> newest) is the within-stream ``pos``."""
        Q, C = g.shape
        dev = g.device
        if self.state == "lanes":
            return {
                l: lane_masked_reduce(l, _LANE_LIFT[l](g), mask, 1)
                for l in self.lanes
            }
        if self.state == "bitmap":
            return {
                "bits": _or_reduce(torch.where(mask, row_bitmap(g), 0), 1)
            }
        if self.state == "extreme":
            if self.newest:
                best = torch.where(mask, ts, _TS_MIN).amax(dim=1)
                cand = mask & (ts == best[:, None])
                pos = C - 1 - torch.argmax(
                    cand.flip(1).to(torch.int32), dim=1
                )
            else:
                best = torch.where(mask, ts, _TS_MAX).amin(dim=1)
                cand = mask & (ts == best[:, None])
                pos = torch.argmax(cand.to(torch.int32), dim=1)
            val = torch.gather(g, 1, pos[:, None])[:, 0]
            return {
                "ts": best,
                "rank": torch.full((Q,), int(rank), dtype=torch.int32,
                                   device=dev),
                "pos": pos.to(torch.int32),
                "val": val,
                "has": mask.any(dim=1),
            }
        t = min(TOPN_TAIL - 1, C)
        sl = slice(C - t, C)
        pos = torch.arange(C, dtype=torch.int32, device=dev)[sl].flip(0)
        return {
            "ts": ts[:, sl].flip(1),
            "rank": torch.full((Q, t), int(rank), dtype=torch.int32,
                               device=dev),
            "pos": pos.expand(Q, t),
            "val": g[:, sl].flip(1),
            "valid": mask[:, sl].flip(1),
        }

    def fold_buckets(self, stats, bitmap, ok) -> Dict[str, torch.Tensor]:
        """Fold pre-aggregated bucket states (lanes / bitmap specs): the
        bucket store persists full stat vectors and bitmaps, i.e. lifted
        and combined states of this algebra.  The merge-order families
        (extreme / tail) are not persisted by this package's bucket store
        yet (see :mod:`repro_torch.core.preagg`)."""
        if self.state == "lanes":
            return {
                l: lane_masked_reduce(l, stats[..., LANES.index(l)], ok, 1)
                for l in self.lanes
            }
        if self.state == "bitmap":
            return {"bits": _or_reduce(torch.where(ok, bitmap, 0), 1)}
        raise NotImplementedError(
            f"{self.agg.value}: bucket states of the {self.state!r} family "
            "are not persisted by this package yet"
        )

    # -- finalize -----------------------------------------------------------

    def finalize(self, s, n: int = 0, groups: int = 1) -> torch.Tensor:
        """State -> feature value (the one definition every path shares);
        ``groups`` as in :func:`topn_rank`."""
        a = self.agg
        if a == Agg.SUM:
            return s["sum"]
        if a == Agg.COUNT:
            return s["count"]
        if a == Agg.MEAN:
            return s["sum"] / torch.clamp(s["count"], min=1.0)
        if a == Agg.MIN:
            return s["min"]
        if a == Agg.MAX:
            return s["max"]
        if a == Agg.STD:
            cnt = torch.clamp(s["count"], min=1.0)
            m = s["sum"] / cnt
            return torch.sqrt(torch.clamp(s["sumsq"] / cnt - m * m, min=0.0))
        if a == Agg.DISTINCT_APPROX:
            return bitmap_estimate(s["bits"])
        if a in (Agg.FIRST, Agg.LAST):
            return s["val"]
        if a == Agg.TOPN_FREQ:
            return topn_rank(s["val"], s["valid"], n, groups)
        raise ValueError(f"unhandled agg {a}")


# ---------------------------------------------------------------------------
# The registry — exactly one spec per Agg
# ---------------------------------------------------------------------------

AGG_SPECS: Dict[Agg, AggSpec] = {
    Agg.SUM: AggSpec(Agg.SUM, "lanes", lanes=("sum",), bucket_composable=True),
    Agg.COUNT: AggSpec(
        Agg.COUNT, "lanes", lanes=("count",), bucket_composable=True
    ),
    Agg.MEAN: AggSpec(
        Agg.MEAN, "lanes", lanes=("sum", "count"), bucket_composable=True
    ),
    Agg.MIN: AggSpec(Agg.MIN, "lanes", lanes=("min",), bucket_composable=True),
    Agg.MAX: AggSpec(Agg.MAX, "lanes", lanes=("max",), bucket_composable=True),
    Agg.STD: AggSpec(
        Agg.STD, "lanes", lanes=("sum", "count", "sumsq"),
        bucket_composable=True,
    ),
    Agg.DISTINCT_APPROX: AggSpec(
        Agg.DISTINCT_APPROX, "bitmap", bucket_composable=True
    ),
    Agg.FIRST: AggSpec(
        Agg.FIRST, "extreme", newest=False, bucket_composable=True
    ),
    Agg.LAST: AggSpec(
        Agg.LAST, "extreme", newest=True, bucket_composable=True
    ),
    Agg.TOPN_FREQ: AggSpec(Agg.TOPN_FREQ, "tail", bucket_composable=True),
}


def agg_spec(agg: Agg) -> AggSpec:
    return AGG_SPECS[agg]

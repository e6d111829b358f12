"""Seeded generator of 100+ feature views over the full expr IR surface.

``gen_views(seed, n, profile)`` deterministically samples every ``Agg``
(the round-robin lead feature guarantees all ten appear for n >= 10),
both window modes with varied sizes, WINDOW UNIONs over shared streams
(drawn from a fixed shared-lane pool so the plane's CSE / shared-ingest
accounting is genuinely stressed), multi-table LAST JOINs against shared
dimension tables (including the dual-use refunds table: union stream and
join target at once, which forces the planner's dual-use ring split),
Signature/Hash lanes, and ``FeatureView.evolve`` chains.

Determinism contract: every sampling decision
flows from ONE named ``np.random.Generator`` seeded through
``np.random.SeedSequence`` with ``zlib.crc32`` for the string inputs —
no ``hash()``, no global numpy state — so ``gen_views(seed, n)`` is
byte-identical across processes, and to the reference package's
``repro.stress.generate`` (the same draws in the same order, the same
``_TAG``: the tests hold the two fingerprints equal).

Generated views obey the store's physical contracts so the harness can
hold exact equalities rather than loose tolerances:

* range windows span <= 1800s with the canonical 64s bucket, so every
  query stays inside the default 64-bucket retention and, with
  ``T_MAX`` < num_buckets * bucket_size, the bucket ring never wraps
  (the same no-wrap discipline as the multi-table test fixtures);
* rows windows stay <= 32 < the 256-row ring capacity, and the matched
  ``stress_stream`` data keeps per-key row counts below capacity, so
  hot-deploy migrations synthesize new lanes exactly from ring history;
* union window arguments only reference columns present in every unioned
  table (``amount`` everywhere; ``quantity`` when the union is
  refunds-only), per the IR validation rule;
* ``table_ttl`` knobs are only aggressive on union-only streams — a TTL
  below ``T_MAX`` on a join target would diverge from the TTL-blind
  offline engine.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.expr import (
    Agg,
    Col,
    Expr,
    Hash,
    Signature,
    WindowAgg,
    collect_last_joins,
    collect_window_aggs,
    last_join,
    range_window,
    rows_window,
)
from repro_torch.core.view import FeatureView, render_sql
from repro_torch.data.synthetic import STRESS_DB

__all__ = [
    "NUM_ENTITIES",
    "NUM_ITEMS",
    "T_MAX",
    "PROFILES",
    "stress_rng",
    "gen_views",
    "gen_store_kwargs",
    "filter_table_knobs",
    "view_fingerprint",
    "summarize_views",
    "render_summary_md",
]

# Matched data-generation geometry (repro_torch.data.synthetic.stress_stream):
# T_MAX < num_buckets * bucket_size = 4096 keeps the bucket ring unwrapped.
NUM_ENTITIES = 48
NUM_ITEMS = 24
T_MAX = 3800

_BUCKET = 64
_RANGE_SIZES = (128, 256, 512, 900, 1800)
_ROWS_SIZES = (4, 8, 12, 20, 32)
_UNION_COMBOS = (("refunds",), ("clicks",), ("refunds", "clicks"))

# Round-robin lead-feature ring: view i's first feature aggregates with
# AGG_RING[i % 10], so any n >= 10 covers the whole Agg enum.
_AGG_RING = (
    Agg.SUM,
    Agg.COUNT,
    Agg.MEAN,
    Agg.MIN,
    Agg.MAX,
    Agg.STD,
    Agg.DISTINCT_APPROX,
    Agg.LAST,
    Agg.FIRST,
    Agg.TOPN_FREQ,
)
_INTISH_AGGS = (Agg.DISTINCT_APPROX, Agg.TOPN_FREQ)

# the reference package's tag: the seed sequence (and so every view) is
# the reference's, byte for byte
_TAG = zlib.crc32(b"repro.stress")


@dataclasses.dataclass(frozen=True)
class Profile:
    """Sampling weights for one generation profile."""

    p_rows: float      # rows_window share of non-union windows
    p_union: float     # window-union share of waggs
    p_shared: float    # draw the wagg from the shared CSE pool
    p_join: float      # feature is (or composes) a LAST JOIN
    p_sig: float       # feature is a row-level Signature/Hash lane
    p_ratio: float     # feature is a wagg/wagg or wagg/join composite
    p_evolve: float    # view grows an evolve() version bump
    p_dual: float      # join targets the dual-use refunds stream


PROFILES: Dict[str, Profile] = {
    # the balanced default — every IR construct at a realistic mix
    "default": Profile(0.30, 0.35, 0.30, 0.25, 0.12, 0.18, 0.25, 0.10),
    # window-heavy: no joins, dense agg/window variety (the shared CSE
    # pool still contributes its union lanes)
    "windows": Profile(0.45, 0.00, 0.35, 0.00, 0.10, 0.25, 0.15, 0.00),
    # relational-heavy: unions + joins dominate, incl. dual-use refunds
    "relational": Profile(0.15, 0.55, 0.30, 0.40, 0.08, 0.15, 0.25, 0.20),
}


def stress_rng(seed: int, n: int, profile: str, stage: str) -> np.random.Generator:
    """The one named generator: every stress sampling path (views, knobs,
    data, harness decisions) derives from this SeedSequence — crc32 for
    the string components, never ``hash()``."""
    return np.random.default_rng(
        np.random.SeedSequence(
            [
                _TAG,
                int(seed),
                int(n),
                zlib.crc32(profile.encode()),
                zlib.crc32(stage.encode()),
            ]
        )
    )


def _pick(rng: np.random.Generator, seq: Sequence):
    return seq[int(rng.integers(len(seq)))]


def shared_pool() -> Tuple[WindowAgg, ...]:
    """Fixed cross-view shared lanes — identical structural keys across
    many views, so the planner's CSE and the plane's shared-ingest
    accounting are exercised at scale (deliberately, per the paper's
    multi-scenario reuse claim)."""
    amt = Col("amount")
    w18 = range_window(1800, bucket=_BUCKET)
    w9 = range_window(900, bucket=_BUCKET)
    return (
        WindowAgg(Agg.SUM, amt, w18, union=("refunds",)),
        WindowAgg(Agg.COUNT, amt, w18, union=("refunds",)),
        WindowAgg(Agg.MEAN, amt, w9, union=("refunds", "clicks")),
        WindowAgg(Agg.SUM, amt, w9),
        WindowAgg(Agg.MAX, amt, w9, union=("clicks",)),
        WindowAgg(Agg.DISTINCT_APPROX, Hash(amt, bits=6, salt=1), w18),
    )


_POOL = shared_pool()


def _num_arg(rng: np.random.Generator) -> Expr:
    """Row-level numeric argument over primary columns."""
    amt, qty, sc = Col("amount"), Col("quantity"), Col("score")
    return _pick(
        rng,
        (
            amt,
            qty,
            sc,
            amt * qty,
            amt > 100.0,
            amt.log1p(),
            amt + sc * 10.0,
        ),
    )


def _int_arg(rng: np.random.Generator) -> Expr:
    """Integer-valued argument (DISTINCT_APPROX / TOPN_FREQ lanes)."""
    k = int(rng.integers(3))
    if k == 0:
        return Col("item")
    if k == 1:
        return Hash(Col("item"), bits=8, salt=int(rng.integers(16)))
    return Signature(
        (Col("entity"), Col("item")), bits=10, salt=int(rng.integers(16))
    )


def _union_arg(rng: np.random.Generator, union: Tuple[str, ...],
               intish: bool) -> Expr:
    """Union window argument — columns must exist in the primary AND every
    unioned table: ``amount`` always does; ``quantity`` only when the
    union is refunds-only (clicks carries just ``amount``)."""
    cols: List[Expr] = [Col("amount")]
    if union == ("refunds",):
        cols.append(Col("quantity"))
    base = _pick(rng, cols)
    if intish:
        return Hash(base, bits=6, salt=int(rng.integers(16)))
    return _pick(rng, (base, base > 50.0, base.log1p()))


def _window(rng: np.random.Generator, p: Profile,
            force_range: bool = False) -> "WindowSpec":
    if not force_range and rng.random() < p.p_rows:
        return rows_window(_pick(rng, _ROWS_SIZES))
    return range_window(_pick(rng, _RANGE_SIZES), bucket=_BUCKET)


def _wagg(rng: np.random.Generator, p: Profile,
          agg: Optional[Agg] = None) -> WindowAgg:
    if agg is None and rng.random() < p.p_shared:
        return _pick(rng, _POOL)
    agg = agg if agg is not None else _pick(rng, _AGG_RING)
    union: Tuple[str, ...] = ()
    if rng.random() < p.p_union:
        union = _pick(rng, _UNION_COMBOS)
    window = _window(rng, p, force_range=bool(union))
    intish = agg in _INTISH_AGGS
    if union:
        arg = _union_arg(rng, union, intish)
    elif intish:
        arg = _int_arg(rng)
    else:
        arg = _num_arg(rng)
    nn = int(rng.integers(3)) if agg is Agg.TOPN_FREQ else 1
    return WindowAgg(agg, arg, window, n=nn, union=union)


def _join(rng: np.random.Generator, p: Profile) -> Expr:
    """LAST JOIN feature: dimension tables (profiles on entity, items on
    item) plus — with ``p_dual`` — the refunds stream, making refunds a
    dual-use table (union source AND join target) that forces the
    planner's ring split."""
    if rng.random() < p.p_dual:
        arg = _pick(rng, (Col("amount"), Col("quantity")))
        return last_join(arg, "refunds", on="entity", default=0.0)
    if rng.random() < 0.5:
        arg = _pick(
            rng,
            (Col("tier"), Col("spend_limit"), Col("spend_limit") - Col("tier")),
        )
        return last_join(arg, "profiles", on="entity", default=1.0)
    arg = _pick(
        rng,
        (
            Col("base_price"),
            Col("popularity"),
            Col("base_price") * Col("popularity"),
        ),
    )
    return last_join(arg, "items", on="item", default=5.0)


def _rowlevel(rng: np.random.Generator) -> Expr:
    k = int(rng.integers(3))
    if k == 0:
        return Signature(
            (Col("entity"), Col("item"), Col("amount")),
            bits=16,
            salt=int(rng.integers(16)),
        )
    if k == 1:
        return Hash(Col("amount"), bits=12, salt=int(rng.integers(16)))
    return (Col("amount") > 150.0) * Col("quantity")


def _feature(rng: np.random.Generator, p: Profile) -> Expr:
    r = rng.random()
    if r < p.p_join:
        j = _join(rng, p)
        if rng.random() < 0.4:
            # spend-vs-limit style composite: window agg over a join floor
            return _wagg(rng, p) / (j.abs() + 1.0)
        return j
    if r < p.p_join + p.p_sig:
        return _rowlevel(rng)
    if r < p.p_join + p.p_sig + p.p_ratio:
        a, b = _wagg(rng, p), _wagg(rng, p)
        return a / (b.abs() + 1.0) if rng.random() < 0.7 else a - b
    return _wagg(rng, p)


def _gen_one(rng: np.random.Generator, i: int, p: Profile,
             profile: str) -> FeatureView:
    lead = _AGG_RING[i % len(_AGG_RING)]
    feats: Dict[str, Expr] = {
        f"f0_{lead.value.lower()}": _wagg(rng, p, agg=lead)
    }
    for j in range(1, 2 + int(rng.integers(4))):  # 2..5 features total
        feats[f"f{j}"] = _feature(rng, p)
    view = FeatureView(
        name=f"gen_v{i:03d}",
        features=feats,
        database=STRESS_DB,
        description=f"generated stress scenario #{i} (profile {profile})",
    )
    while view.version < 3 and rng.random() < p.p_evolve:
        view = view.evolve(
            {f"evo{view.version}": _wagg(rng, p)},
            description=view.description,
        )
    return view


def gen_views(seed: int, n: int, profile: str = "default") -> List[FeatureView]:
    """The generator: ``n`` deterministic views for ``(seed, profile)``.

    Byte-identical across processes — fingerprint with
    :func:`view_fingerprint` to assert it.
    """
    if profile not in PROFILES:
        raise KeyError(
            f"unknown profile {profile!r}; one of {sorted(PROFILES)}"
        )
    p = PROFILES[profile]
    rng = stress_rng(seed, n, profile, "views")
    return [_gen_one(rng, i, p, profile) for i in range(n)]


def gen_store_kwargs(seed: int, n: int, profile: str = "default") -> Dict:
    """Matched physical-plan knobs for a generated plane.

    Capacities stay above the matched data's per-key row counts (exact
    migrations, no ring eviction); the aggressive TTL lands only on the
    union-only ``clicks`` stream (a TTL below ``T_MAX`` on a join target
    would diverge from the TTL-blind offline engine), while the refunds
    TTL sits above ``T_MAX`` so the knob is exercised but inert.
    """
    rng = stress_rng(seed, n, profile, "knobs")
    return dict(
        capacity=256,
        num_buckets=64,
        bucket_size=_BUCKET,
        secondary_num_keys={"items": NUM_ITEMS},
        table_capacity={
            "refunds": int(_pick(rng, (192, 256))),
            "clicks": int(_pick(rng, (128, 256))),
            "profiles": 64,
            "items": 64,
        },
        table_ttl={
            "clicks": int(_pick(rng, (2400, 3200))),
            "refunds": int(T_MAX + 200),
        },
    )


def filter_table_knobs(kwargs: Dict, views: Sequence[FeatureView]) -> Dict:
    """Restrict per-table knobs to tables the given views reference — the
    layout planner rejects knob entries for tables outside the plan."""
    tabs = {t for v in views for t in v.tables}
    out = dict(kwargs)
    for k in ("table_capacity", "table_ttl", "secondary_num_keys"):
        if out.get(k):
            out[k] = {t: c for t, c in out[k].items() if t in tabs}
    return out


# ---------------------------------------------------------------------------
# Determinism fingerprint + scale-aware summary (catalog consumes these)
# ---------------------------------------------------------------------------


def view_fingerprint(views: Sequence[FeatureView]) -> str:
    """sha256 over names, versions, structural expr keys and rendered SQL
    — the byte-identity witness for the two-process determinism test."""
    h = hashlib.sha256()
    for v in views:
        h.update(f"{v.name}:{v.version}\n".encode())
        for fname, expr in v.features.items():
            h.update(f"{fname}={expr.key!r}\n".encode())
            h.update(render_sql(fname, expr, v.schema, v.database).encode())
            h.update(b"\n")
    return h.hexdigest()


def summarize_views(views: Sequence[FeatureView]) -> Dict:
    """Deterministic structural census of a generated view set."""
    exprs = [e for v in views for e in v.features.values()]
    waggs = collect_window_aggs(exprs)
    per_view_waggs = sum(
        len(collect_window_aggs(list(v.features.values()))) for v in views
    )
    aggs: Dict[str, int] = {a.value: 0 for a in Agg}
    rows_w = range_w = 0
    unions: Dict[str, int] = {}
    for wa in waggs.values():
        aggs[wa.agg.value] += 1
        if wa.window.mode == "rows":
            rows_w += 1
        else:
            range_w += 1
        if wa.union:
            unions["+".join(wa.union)] = unions.get("+".join(wa.union), 0) + 1
    joins: Dict[str, int] = {}
    for lj in collect_last_joins(exprs).values():
        joins[lj.table] = joins.get(lj.table, 0) + 1
    tables = sorted({t for v in views for t in v.tables})
    return {
        "n_views": len(views),
        "n_evolved": sum(1 for v in views if v.version > 1),
        "n_features": sum(len(v.features) for v in views),
        "distinct_waggs": len(waggs),
        "per_view_waggs": per_view_waggs,
        "aggs": {a: c for a, c in sorted(aggs.items())},
        "rows_windows": rows_w,
        "range_windows": range_w,
        "unions": dict(sorted(unions.items())),
        "joins": dict(sorted(joins.items())),
        "tables": tables,
    }


def render_summary_md(views: Sequence[FeatureView], *, seed: int, n: int,
                      profile: str) -> str:
    """Markdown summary for the catalog — scale-aware: a census plus a
    few sample entries instead of 100+ full pages."""
    s = summarize_views(views)
    cse = s["per_view_waggs"] - s["distinct_waggs"]
    lines = [
        f"`gen_views(seed={seed}, n={n}, profile={profile!r})` — "
        "deterministic, byte-identical across processes.",
        "",
        "| metric | value |",
        "|---|---|",
        f"| views (evolved ≥v2) | {s['n_views']} ({s['n_evolved']}) |",
        f"| features | {s['n_features']} |",
        f"| distinct window-agg lanes | {s['distinct_waggs']} "
        f"({cse} deduplicated across views) |",
        f"| windows rows / range | {s['rows_windows']} / "
        f"{s['range_windows']} |",
        "| per-Agg lanes | "
        + ", ".join(f"{a} {c}" for a, c in s["aggs"].items())
        + " |",
        "| union windows | "
        + (
            ", ".join(f"{u} {c}" for u, c in s["unions"].items())
            or "none"
        )
        + " |",
        "| LAST JOINs | "
        + (
            ", ".join(f"{t} {c}" for t, c in s["joins"].items())
            or "none"
        )
        + " |",
        f"| source tables | {', '.join(s['tables'])} |",
        "",
        "Sample entries:",
        "",
    ]
    for v in views[:3]:
        fname, expr = next(iter(v.features.items()))
        sql = render_sql(fname, expr, v.schema, v.database)
        lines.append(
            f"- `{v.name}` v{v.version}, {len(v.features)} features — "
            f"`{sql}`"
        )
    return "\n".join(lines)
